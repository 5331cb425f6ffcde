"""Weights and states across the two packages.

The reference keeps convolution weights as ``(K, Cin, Cout)`` for its
``NWC``/``WIO`` convolutions; ``F.conv1d`` wants ``(Cout, Cin, K)``.
GroupNorm ``scale``/``bias``, the head ``(Cin, d)`` and the optional
``proj`` entries carry across as they are.  The port's parity tests
convert the reference's weights with ``params_from_jax`` rather than
drawing new ones, so both packages run the same model.  Task heads
(``head_from_jax``) and GMM memory states (``gmm_from_jax``) cross the
same way, so a refine round starts from the reference's own state, and
an AdamW state (``adamw_from_jax``) likewise for the edge learner and,
with ``lm_from_jax`` as its layout, for an LM.  The
PPO actor-critic of the RL split policy (``ppo_from_jax``) carries
across as it is: ``w1 (3, H)``, ``b1 (H,)``, ``wp (H, L+1)``, ``bp``,
``wv (H, 1)``, ``bv (1,)``.  An LM's parameters (``lm_from_jax``) are
the reference's ``init_lm`` pytree as it is, layers stacked on a leading
axis, and an LM's whole train state (``train_state_from_jax``: its
parameters, the AdamW, Adafactor or SGD state and the step) with it.
An LM's decode state (``decode_state_from_jax``: ``index``, and the
``k``, ``v``, ``ssm`` and ``conv`` its family has) crosses bitwise too.
A serving session (``session_snapshot_from_jax``) crosses field by
field: neither package can unpickle the other's ``SessionSnapshot``
bytes, since a pickle names each class's module.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.gmm import GMMState
from repro_torch.core.ppo import PPO_KEYS

_CONVS = ("conv1", "conv2", "proj")


def _conv_from(w):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(w, np.float32).transpose(2, 1, 0)))


def _vec_from(v):
    return torch.from_numpy(np.array(v, np.float32))


def params_from_jax(tree) -> dict:
    """Reference pytree (leaves as numpy arrays) -> port params on the
    CPU."""
    blocks = []
    for blk in tree["blocks"]:
        out = {}
        for name, sub in blk.items():
            if name in _CONVS:
                out[name] = {"w": _conv_from(sub["w"])}
            else:                                        # gn1 / gn2
                out[name] = {"scale": _vec_from(sub["scale"]),
                             "bias": _vec_from(sub["bias"])}
        blocks.append(out)
    return {"stem": {"w": _conv_from(tree["stem"]["w"])},
            "blocks": blocks,
            "head": {"w": _vec_from(tree["head"]["w"])}}


def params_to_jax(params) -> dict:
    """Inverse of ``params_from_jax``: port params -> a pytree of numpy
    arrays in the reference's layout (the tests hand port-initialised
    weights to the reference with it)."""
    def conv(w):
        return w.detach().cpu().numpy().transpose(2, 1, 0).copy()

    def vec(v):
        return v.detach().cpu().numpy().copy()

    blocks = []
    for blk in params["blocks"]:
        out = {}
        for name, sub in blk.items():
            if name in _CONVS:
                out[name] = {"w": conv(sub["w"])}
            else:
                out[name] = {"scale": vec(sub["scale"]),
                             "bias": vec(sub["bias"])}
        blocks.append(out)
    return {"stem": {"w": conv(params["stem"]["w"])}, "blocks": blocks,
            "head": {"w": vec(params["head"]["w"])}}


def to_device(params, device) -> dict:
    """Every tensor of a params dict moved to ``device`` (a new dict)."""
    if isinstance(params, dict):
        return {k: to_device(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [to_device(v, device) for v in params]
    return params.to(device)


def head_from_jax(tree):
    """A task head's params (any nested dict/list of arrays, as the
    reference's ``head_init`` returns them) -> the same tree of float32
    CPU tensors."""
    if isinstance(tree, dict):
        return {k: head_from_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(head_from_jax(v) for v in tree)
    return _vec_from(tree)


def head_to_jax(params):
    """Inverse of ``head_from_jax``: a tree of numpy arrays."""
    if isinstance(params, dict):
        return {k: head_to_jax(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(head_to_jax(v) for v in params)
    return params.detach().cpu().numpy().copy()


def gmm_from_jax(state):
    """The reference's ``GMMState`` (or any ``(s0, s1, s2, step)``) -> the
    port's ``GMMState`` on the CPU."""
    s0, s1, s2, step = state
    return GMMState(_vec_from(s0), _vec_from(s1), _vec_from(s2),
                    torch.tensor(int(np.asarray(step)), dtype=torch.int32))


def gmm_to_jax(state):
    """The port's ``GMMState`` -> ``(s0, s1, s2, step)`` numpy arrays, the
    field order of the reference's ``GMMState``."""
    s0, s1, s2, step = (x.detach().cpu().numpy().copy() for x in state)
    return s0, s1, s2, step.astype(np.int32)


def _step_from(step):
    return torch.tensor(int(np.asarray(step)), dtype=torch.int32)


def _step_to(step):
    return np.asarray(int(step), np.int32)


def adamw_from_jax(state, params_from=params_from_jax) -> dict:
    """The reference's AdamW state ``{"m", "v", "step"}`` -> the port's, on
    the CPU, the moments converted as ``params_from`` converts parameters
    (an encoder's by default; ``lm_from_jax`` for an LM's)."""
    return {"m": params_from(state["m"]), "v": params_from(state["v"]),
            "step": _step_from(state["step"])}


def adamw_to_jax(state, params_to=params_to_jax) -> dict:
    """Inverse of ``adamw_from_jax``: numpy arrays in the reference's
    layout."""
    return {"m": params_to(state["m"]), "v": params_to(state["v"]),
            "step": _step_to(state["step"])}




def ppo_from_jax(tree) -> dict:
    """The reference's PPO actor-critic params (``core/ppo.py``'s
    ``init_policy`` layout) -> the same dict of float32 CPU tensors."""
    return {k: _vec_from(tree[k]) for k in PPO_KEYS}


def ppo_to_jax(params) -> dict:
    """Inverse of ``ppo_from_jax``: a dict of float32 numpy arrays."""
    return {k: params[k].detach().cpu().numpy().astype(np.float32)
            for k in PPO_KEYS}


# an LM's params (the reference's ``init_lm`` pytree, float32) cross as a
# task head's do: the same nested dicts, every leaf bitwise
lm_from_jax, lm_to_jax = head_from_jax, head_to_jax


_DECODE_KEYS = ("k", "v", "ssm", "conv")


def decode_state_from_jax(state) -> dict:
    """The reference's LM decode state (``lm.init_decode_state``'s dict:
    ``index`` and the caches of its family) -> the port's on the CPU,
    bitwise: ``index`` a 0-d int32 tensor, the caches in their dtype."""
    out = {"index": _step_from(state["index"])}
    out.update({k: torch.from_numpy(np.array(state[k]))
                for k in _DECODE_KEYS if k in state})
    return out


def decode_state_to_jax(state) -> dict:
    """Inverse of ``decode_state_from_jax``: numpy arrays."""
    out = {"index": _step_to(state["index"])}
    out.update({k: state[k].detach().cpu().numpy().copy()
                for k in _DECODE_KEYS if k in state})
    return out


def adafactor_from_jax(state) -> dict:
    """The reference's Adafactor state ``{"stats", "step"}`` over an LM's
    pytree -> the port's, on the CPU: the ``vr``/``vc``/``v`` statistics as
    they are (a parameter tree in the reference's layout, as an LM's is;
    an encoder's transposed convolutions would not factor the same way)."""
    return {"stats": head_from_jax(state["stats"]),
            "step": _step_from(state["step"])}


def adafactor_to_jax(state) -> dict:
    """Inverse of ``adafactor_from_jax``."""
    return {"stats": head_to_jax(state["stats"]),
            "step": _step_to(state["step"])}


def train_state_from_jax(state, optimizer="adamw") -> dict:
    """The reference's LM train state ``{"params", "opt", "step"}``
    (``runtime/trainer.py``'s ``init_train_state``) -> the port's, on the
    CPU, for ``optimizer`` in ("adamw", "adafactor", "sgd")."""
    if optimizer == "adamw":
        opt = adamw_from_jax(state["opt"], lm_from_jax)
    elif optimizer == "adafactor":
        opt = adafactor_from_jax(state["opt"])
    elif optimizer == "sgd":
        opt = tuple(lm_from_jax(m) for m in state["opt"])
    else:
        raise ValueError(f"unknown optimizer {optimizer!r}")
    return {"params": lm_from_jax(state["params"]), "opt": opt,
            "step": _step_from(state["step"])}


def train_state_to_jax(state, optimizer="adamw") -> dict:
    """Inverse of ``train_state_from_jax``: numpy arrays."""
    if optimizer == "adamw":
        opt = adamw_to_jax(state["opt"], lm_to_jax)
    elif optimizer == "adafactor":
        opt = adafactor_to_jax(state["opt"])
    elif optimizer == "sgd":
        opt = tuple(lm_to_jax(m) for m in state["opt"])
    else:
        raise ValueError(f"unknown optimizer {optimizer!r}")
    return {"params": lm_to_jax(state["params"]), "opt": opt,
            "step": _step_to(state["step"])}


# -- a serving session across the two packages --------------------------------

_SNAP_SCALARS = ("platform", "frames", "wire_bytes", "transitions", "last_k",
                 "sync_last_gmm", "sync_last_weights", "sync_total_bytes",
                 "sync_total_energy_j", "ring_newest", "version")
_SNAP_ARRAYS = ("ring_z", "ring_t", "ring_label")
_FRAME_FIELDS = ("t", "label", "u", "cpu", "bandwidth_mbps", "charging")
_QUEUED_FIELDS = ("enq_s", "deadline_s", "preemptions", "promoted", "weight")


def _fields_of(obj, names) -> dict:
    return {n: getattr(obj, n) for n in names}


def _dataclass_dict(obj) -> dict:
    return _fields_of(obj, obj.__dataclass_fields__)


def session_snapshot_from_jax(snap):
    """The reference's ``SessionSnapshot`` -> the port's.  Fields are
    read by name; numpy arrays are copied, ``QoSClass`` is mapped by
    value, and the lazy-sync config and events are rebuilt as the
    port's.  A queued frame's trace does not cross (the port's frame
    starts without a span)."""
    from repro_torch.api.types import (FrameRequest, QoSClass,
                                       QueuedFrameSnapshot,
                                       ServerSessionSnapshot,
                                       SessionSnapshot)
    from repro_torch.core.sync import SyncCfg, SyncEvent
    get = _fields_of(snap, _SNAP_SCALARS + _SNAP_ARRAYS
                     + ("qos", "sync_cfg", "sync_events", "server"))
    server = get.pop("server")
    if server is not None:
        sv = _fields_of(server, ("submitted", "served", "shed", "weight",
                                 "bucket", "queued"))
        queued = []
        for q in sv["queued"]:
            qd = _fields_of(q, ("frame",) + _QUEUED_FIELDS)
            fd = _fields_of(qd.pop("frame"), _FRAME_FIELDS + ("mel",))
            fd["mel"] = np.array(fd["mel"], np.float32)
            queued.append(QueuedFrameSnapshot(frame=FrameRequest(**fd),
                                              **qd))
        server = ServerSessionSnapshot(
            submitted=int(sv["submitted"]), served=int(sv["served"]),
            shed=int(sv["shed"]), weight=float(sv["weight"]),
            bucket=None if sv["bucket"] is None else tuple(sv["bucket"]),
            queued=tuple(queued))
    get["qos"] = QoSClass(get["qos"].value)
    get["sync_cfg"] = SyncCfg(**_dataclass_dict(get["sync_cfg"]))
    get["sync_events"] = tuple(SyncEvent(**_dataclass_dict(e))
                               for e in get["sync_events"])
    for n in _SNAP_ARRAYS:
        get[n] = np.array(get[n])
    return SessionSnapshot(server=server, **get)


def session_snapshot_to_jax(snap) -> dict:
    """The port's ``SessionSnapshot`` -> a nested dict of numpy arrays and
    Python scalars with the reference's field names (``qos`` its value
    string, the lazy-sync config and events as dicts, ``server`` a dict or
    None, each queued frame's ``frame`` a dict), from which the
    reference's dataclasses are built."""
    out = {n: getattr(snap, n) for n in _SNAP_SCALARS}
    out.update({n: np.array(getattr(snap, n)) for n in _SNAP_ARRAYS})
    out["qos"] = snap.qos.value
    out["sync_cfg"] = _dataclass_dict(snap.sync_cfg)
    out["sync_events"] = [_dataclass_dict(e) for e in snap.sync_events]
    sv = snap.server
    if sv is None:
        out["server"] = None
    else:
        out["server"] = {
            "submitted": sv.submitted, "served": sv.served, "shed": sv.shed,
            "weight": sv.weight,
            "bucket": None if sv.bucket is None else tuple(sv.bucket),
            "queued": [{"frame": {**{n: getattr(q.frame, n)
                                     for n in _FRAME_FIELDS},
                                  "mel": np.array(q.frame.mel, np.float32)},
                        **{n: getattr(q, n) for n in _QUEUED_FIELDS}}
                       for q in sv.queued]}
    return out
