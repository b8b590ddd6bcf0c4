"""Checkpoint/resume for renders and inverse-rendering optimization (port of
mitsubaer_tpu/utils/checkpoint.py).

The reference has none (SURVEY.md §5: partial-image flush on SIGHUP is the
only 'resume-ish' facility, mitsuba.cpp:93-124); the film accumulator +
pass counter + RNG seed fully determine a resumable render (counter-based
RNG makes replay exact), and optimizer state makes inverse-rendering runs
restartable.

The render state keeps the JAX package's npz layout (accum, pass_idx, seed,
cfg as JSON), so a render checkpointed by either package resumes in the
other. The train state holds the MediumParams fields and a torch.optim
optimizer's state_dict. A train state written by the JAX package holds
optax's state as flattened pytree leaves, whose layout a torch optimizer
does not share: it cannot be read back here (load_train_state raises).
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch


def save_render_state(path: str, accum, pass_idx: int, seed: int, cfg):
    """Persist a partially accumulated render (atomic write)."""
    tmp = path + ".tmp.npz"
    np.savez_compressed(
        tmp,
        accum=_numpy(accum),
        pass_idx=np.int64(pass_idx),
        seed=np.int64(seed),
        cfg=json.dumps(dataclasses.asdict(cfg)),
    )
    os.replace(tmp, path)


def load_render_state(path: str):
    """Returns (accum, pass_idx, seed, cfg_dict) or None if absent."""
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        return (
            z["accum"],
            int(z["pass_idx"]),
            int(z["seed"]),
            json.loads(str(z["cfg"])),
        )


def _numpy(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def save_train_state(path: str, params, optimizer, step: int, extra=None):
    """Persist MediumParams (a NamedTuple of tensors) and the state_dict of
    a torch.optim optimizer over them (atomic write)."""
    sd = optimizer.state_dict()
    arrays, scalars = {}, {}
    for i, st in sd["state"].items():
        for k, v in st.items():
            if isinstance(v, torch.Tensor):
                arrays[f"opt_{i}_{k}"] = _numpy(v)
            else:
                scalars[f"{i}/{k}"] = v
    tmp = path + ".tmp.npz"
    np.savez_compressed(
        tmp,
        format="torch",
        step=np.int64(step),
        extra=json.dumps(extra or {}),
        param_groups=json.dumps(sd["param_groups"]),
        opt_scalars=json.dumps(scalars),
        **{f"param_{k}": _numpy(v) for k, v in params._asdict().items()},
        **arrays,
    )
    os.replace(tmp, path)


def load_train_state(path: str, params, optimizer):
    """Restore a state save_train_state wrote into the leaf tensors
    `params` (in place) and `optimizer`; returns (step, extra), or None if
    the file is absent. Raises ValueError on a JAX (optax) train state."""
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        if "format" not in z or str(z["format"]) != "torch":
            raise ValueError(f"{path} is not a train state of this package "
                             "(an optax state cannot be read back)")
        with torch.no_grad():
            for k, t in params._asdict().items():
                t.copy_(torch.from_numpy(z[f"param_{k}"]))
        state = {}
        for name in z.files:
            if name.startswith("opt_") and name != "opt_scalars":
                i, k = name[4:].split("_", 1)
                state.setdefault(int(i), {})[k] = torch.from_numpy(z[name])
        for key, v in json.loads(str(z["opt_scalars"])).items():
            i, k = key.split("/", 1)
            state.setdefault(int(i), {})[k] = v
        optimizer.load_state_dict(dict(
            state=state, param_groups=json.loads(str(z["param_groups"]))))
        return int(z["step"]), json.loads(str(z["extra"]))
