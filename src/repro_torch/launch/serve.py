"""Uncertainty-routed cascade serving — the paper's offloading policy as a
datacenter pattern: requests whose pooled-embedding GMM entropy is low are
answered by the small ("edge-class") model; high-entropy (hard) requests
escalate to the large ("server-class") model.

Port of ``repro.launch.serve``.  ``CascadeServer`` runs on the card by
default (``device="cuda"``; the tests pass ``device="cpu"``): every
attention layer of both tiers goes through the flash-attention kernel and
the GMM's entropy and EM update through the GMM posterior kernel.

  python -m repro_torch.launch.serve [--demo] [--device cpu]

The demo runs with or without ``--demo``, as the reference's does.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.configs.base import get_config, smoke_config
from repro_torch.core import gmm as gmm_mod
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import lm
from repro_torch.weights import to_device


@dataclass
class CascadeStats:
    served_small: int = 0
    served_large: int = 0
    route_ms: float = 0.0   # shared: embed forward + GMM update + routing
    small_ms: float = 0.0   # easy-tier answer materialization only
    large_ms: float = 0.0   # escalated sub-batch forward
    small_batches: int = 0
    large_batches: int = 0

    @property
    def escalation_rate(self):
        n = self.served_small + self.served_large
        return self.served_large / n if n else 0.0


def _bucket(n):
    """Next power of two — pads tier sub-batches to a handful of shapes
    (the reference compiles one executable per shape)."""
    b = 1
    while b < n:
        b <<= 1
    return b


class CascadeServer:
    """Two-tier server. ``threshold`` is normalized entropy in [0, 1]
    (paper: offload when U_t > 0.7 regardless of platform, §6.5.2), or
    "auto": the ``auto_quantile`` of the first batch's entropies.  The
    params are moved to ``device``; the GMM memory is drawn there from a
    generator seeded with ``seed``."""

    def __init__(self, small_cfg, small_params, large_cfg, large_params,
                 *, threshold="auto", auto_quantile=0.75, gmm_components=64,
                 seed=0, device="cuda"):
        assert small_cfg.vocab == large_cfg.vocab, \
            "cascade tiers must share a vocab (one logits buffer)"
        self.device = resolve_device(device)
        self.small_cfg = small_cfg
        self.small_params = to_device(small_params, self.device)
        self.large_cfg = large_cfg
        self.large_params = to_device(large_params, self.device)
        self.threshold = threshold
        self.auto_quantile = auto_quantile
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.gmm = gmm_mod.init_gmm(gen, gmm_components, small_cfg.d_model)
        self.stats = CascadeStats()

    def _embed(self, tokens):
        """ONE small forward serves double duty: the pooled embedding for
        the GMM uncertainty AND the last-token logits, so easy requests are
        answered by the time routing happens."""
        h, _ = lm.forward(self.small_cfg, self.small_params, tokens=tokens)
        z = h.mean(dim=1)
        z = z / torch.linalg.vector_norm(z, dim=-1,
                                         keepdim=True).clamp_min(1e-6)
        logits = lm.logits_from_hidden(self.small_cfg, self.small_params,
                                       h[:, -1:, :])[:, -1]
        return z, logits

    def _serve_large(self, tokens, idx, out):
        """Run the large tier ONCE on its repeat-padded sub-batch (gathered
        on the device) and scatter its logits into ``out``."""
        t0 = time.perf_counter()
        sel = np.concatenate([idx, np.full(_bucket(len(idx)) - len(idx),
                                           idx[0])])
        sub = tokens[torch.from_numpy(sel).to(self.device)]
        h, _ = lm.forward(self.large_cfg, self.large_params, tokens=sub)
        logits = lm.logits_from_hidden(self.large_cfg, self.large_params,
                                       h[:, -1:, :])[:, -1]
        out[idx] = logits[:len(idx)].cpu().numpy()
        self.stats.served_large += len(idx)
        self.stats.large_ms += (time.perf_counter() - t0) * 1e3
        self.stats.large_batches += 1

    @torch.no_grad()
    def handle(self, tokens, *, update_gmm=True):
        """tokens: (B, S) integers, numpy or a CPU tensor, copied to the
        device once.  Routes the batch -> (logits (B, vocab) float32 numpy,
        hard (B,) bool numpy).

        Easy requests are answered by the small logits computed alongside
        the uncertainty embedding (zero extra forwards); hard requests are
        grouped into ONE padded large-tier sub-batch — never one forward
        per request."""
        t0 = time.perf_counter()
        tokens = torch.as_tensor(np.asarray(tokens)).to(self.device)
        z, small_logits = self._embed(tokens)
        u = gmm_mod.normalized_entropy(self.gmm, z)
        if update_gmm:
            self.gmm = gmm_mod.em_update(self.gmm, z)
        if self.threshold == "auto":
            self.threshold = float(torch.quantile(u, self.auto_quantile))
        hard = (u > self.threshold).cpu().numpy()   # sync: routing is done
        self.stats.route_ms += (time.perf_counter() - t0) * 1e3
        out = np.zeros((len(hard), self.small_cfg.vocab), np.float32)
        easy_idx = np.where(~hard)[0]
        hard_idx = np.where(hard)[0]
        if easy_idx.size:
            t1 = time.perf_counter()
            out[easy_idx] = small_logits.cpu().numpy()[easy_idx]
            self.stats.served_small += easy_idx.size
            self.stats.small_ms += (time.perf_counter() - t1) * 1e3
            self.stats.small_batches += 1
        if hard_idx.size:
            self._serve_large(tokens, hard_idx, out)
        return out, hard


def demo_configs():
    """The demo's tiers: qwen1.5-0.5b and qwen3-1.7b at smoke size, the
    large one at the small one's vocab and width and 4 layers."""
    small = smoke_config(get_config("qwen1.5-0.5b"))
    large = replace(smoke_config(get_config("qwen3-1.7b")),
                    vocab=small.vocab, d_model=small.d_model, n_layers=4)
    return small, large


def demo(n_batches=8, batch=8, seq=64, device="cuda"):
    dev = resolve_device(device)
    small, large = demo_configs()
    sp = lm.init_lm(small, torch.Generator(device=dev).manual_seed(0))
    lp = lm.init_lm(large, torch.Generator(device=dev).manual_seed(0))
    srv = CascadeServer(small, sp, large, lp, threshold="auto", device=dev)
    for i in range(n_batches):
        toks = torch.randint(0, small.vocab, (batch, seq),
                             generator=torch.Generator().manual_seed(i))
        srv.handle(toks)
    s = srv.stats
    print(f"served: small={s.served_small} large={s.served_large} "
          f"escalation={s.escalation_rate:.2f}")
    return s


def main(argv=None):
    """The reference's ``__main__``: the demo runs whatever ``--demo``
    says (the flag is kept for its command line)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--demo", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return demo(device=args.device)


if __name__ == "__main__":
    main()
