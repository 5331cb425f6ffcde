"""Synthetic continuous-audio stream generator + mel frontend.

Port of ``repro.data.audio_stream``, which is numpy only: this is a copy,
kept here so the port never imports the reference package.  The same
seed gives the same waveforms and the same mels, bit for bit.

Offline stand-in for AudioSet / EcoStream-Wild with the *structural*
properties the paper relies on (DESIGN.md §5):

- temporally coherent sources (sounds don't teleport — Affinity);
- regime mix 60.2 % background / 24.5 % speech / 15.3 % transients
  (EcoStream-Wild class distribution, §6.1.1);
- class-conditional spectral signatures so linear probes are learnable.

Waveforms are sums of class-specific harmonic stacks + filtered noise;
``mel_frontend`` gives the 128-bin log-mel features (25 ms / 10 ms hop)
that the paper computes with PyKissFFT.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

SR = 16_000
N_MELS = 128
WIN = 400     # 25 ms
HOP = 160     # 10 ms


@dataclass(frozen=True)
class StreamCfg:
    n_classes: int = 15
    p_background: float = 0.602
    p_speech: float = 0.245
    p_transient: float = 0.153
    seg_seconds: tuple = (2.0, 8.0)   # source persistence
    seed: int = 0


def _mel_filterbank(n_fft=512, n_mels=N_MELS, sr=SR):
    # HTK-style mel filterbank
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    fmax = sr / 2
    mels = np.linspace(hz_to_mel(0), hz_to_mel(fmax), n_mels + 2)
    freqs = mel_to_hz(mels)
    bins = np.floor((n_fft + 1) * freqs / sr).astype(int)
    fb = np.zeros((n_mels, n_fft // 2 + 1))
    for i in range(n_mels):
        lo, c, hi = bins[i], bins[i + 1], bins[i + 2]
        if c > lo:
            fb[i, lo:c] = (np.arange(lo, c) - lo) / (c - lo)
        if hi > c:
            fb[i, c:hi] = (hi - np.arange(c, hi)) / (hi - c)
    return fb


_FB = None


def mel_frontend(wave):
    """wave: (T,) float -> (frames, N_MELS) log-mel."""
    global _FB
    if _FB is None:
        _FB = _mel_filterbank()
    n = (len(wave) - WIN) // HOP + 1
    idx = np.arange(WIN)[None] + HOP * np.arange(n)[:, None]
    frames = wave[idx] * np.hanning(WIN)[None]
    spec = np.abs(np.fft.rfft(frames, n=512, axis=-1)) ** 2
    mel = spec @ _FB.T
    return np.log1p(mel).astype(np.float32)


class AudioStream:
    """Infinite stream of 1-s samples (paper's Sample unit) with labels.

    Classes: 0..4 background (hums/noise), 5..9 speech-like (formant
    sweeps), 10..14 transients (clicks/chirps)."""

    def __init__(self, cfg: StreamCfg = StreamCfg()):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self._new_segment()
        # per-class harmonic signatures
        r = np.random.default_rng(1234)
        self.f0 = r.uniform(60, 2000, cfg.n_classes)
        self.harm = r.uniform(0.2, 1.0, (cfg.n_classes, 6))

    def _class_group(self):
        r = self.rng.random()
        c = self.cfg
        if r < c.p_transient:
            return "transient"
        if r < c.p_transient + c.p_speech:
            return "speech"
        return "background"

    def _new_segment(self):
        self.group = getattr(self, "_forced_group", None) or self._class_group()
        base = {"background": 0, "speech": 5, "transient": 10}[self.group]
        self.label = base + int(self.rng.integers(0, 5))
        lo, hi = self.cfg.seg_seconds
        self.seg_left = float(self.rng.uniform(lo, hi))
        self.phase = self.rng.uniform(0, 2 * np.pi)

    def next_sample(self):
        """-> (wave (16000,), label, group) for one second."""
        t = np.arange(SR) / SR
        c = self.label
        f0 = self.f0[c]
        wave = np.zeros(SR)
        if self.group == "background":
            for h, a in enumerate(self.harm[c]):
                wave += a * 0.2 * np.sin(2 * np.pi * f0 * (h + 1) * t + self.phase)
            wave += 0.05 * self.rng.standard_normal(SR)
        elif self.group == "speech":
            sweep = f0 * (1 + 0.3 * np.sin(2 * np.pi * 3.0 * t))
            ph = 2 * np.pi * np.cumsum(sweep) / SR
            for h, a in enumerate(self.harm[c]):
                wave += a * 0.25 * np.sin((h + 1) * ph)
            wave *= (0.4 + 0.6 * np.abs(np.sin(2 * np.pi * 4 * t)))  # syllables
        else:  # transient
            n_events = self.rng.integers(1, 4)
            for _ in range(n_events):
                at = self.rng.integers(0, SR - 800)
                dur = self.rng.integers(200, 800)
                chirp = np.sin(2 * np.pi * f0 * np.linspace(0, 3, dur) ** 2)
                wave[at:at + dur] += chirp * np.hanning(dur) * 1.5
            wave += 0.05 * self.rng.standard_normal(SR)
        self.phase += 2 * np.pi * f0
        self.seg_left -= 1.0
        label, group = self.label, self.group
        if self.seg_left <= 0:
            self._new_segment()
        return wave.astype(np.float32), label, group

    def next_mel(self):
        wave, label, group = self.next_sample()
        return mel_frontend(wave), label, group

    def batch(self, n, *, mel=True):
        xs, ys, gs = [], [], []
        for _ in range(n):
            if mel:
                x, y, g = self.next_mel()
            else:
                x, y, g = self.next_sample()
            xs.append(x)
            ys.append(y)
            gs.append(g)
        return np.stack(xs), np.array(ys), gs


def augment_pair(rng, mel):
    """The paper's lightweight augmentations: Gaussian noise + freq mask."""
    def one(m):
        m = m + 0.05 * rng.standard_normal(m.shape).astype(np.float32)
        f0 = rng.integers(0, m.shape[1] - 16)
        m = m.copy()
        m[:, f0:f0 + rng.integers(4, 16)] = 0.0
        return m
    return one(mel), one(mel)
