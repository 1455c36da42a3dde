"""Train-state checkpoints, interchangeable with the JAX trainer's.

PyTorch port of ``phoonnx_tpu/train/checkpoint.py`` (save :32, restore
:56, latest_checkpoint :104). A checkpoint is ``step_N.npz``, a flat
container keyed by the JAX package's keypath names: ``.params_g['enc_p']
['emb']['weight']``, ``.params_d['msd']['convs'][0]['weight_v']``,
``.step``. So a checkpoint written by the JAX trainer restores both
networks into the port, and the function that maps those keys,
:func:`trees_from_flat`, is also the weight carry-over from JAX.

The optimizer state is saved under the port's own names
(``.opt_g.exp_avg[...]``, ``.opt_g.exp_avg_sq[...]``, ``.opt_g.count``).
Restoring a JAX checkpoint reads optax's AdamW moments instead
(``.opt_g[i][0].mu[...]`` / ``.nu[...]`` / ``.count``), which are the same
quantities, so a JAX run resumes in the port. Warm starts from ONNX or
torch checkpoints (JAX ``checkpoint.py:120-162``) are not ported yet.
"""

import json
import re
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from phoonnx_tpu_torch.train.step import (TrainConfig, TrainState,
                                          init_train_state, keyed_leaves)

_OPTAX_MOMENT = re.compile(r"^\.opt_([gd])((?:\[\d+\])+)\.(mu|nu)(\[.*)$")


def _flatten_state(state: TrainState) -> Dict[str, np.ndarray]:
    flat = {".step": np.asarray(state.step, np.int32)}
    for net, params, opt in (("g", state.params_g, state.opt_g),
                             ("d", state.params_d, state.opt_d)):
        count = 0
        for name, p in keyed_leaves(params):
            flat[f".params_{net}{name}"] = p.detach().cpu().numpy()
            slot = opt.state.get(p)
            if slot:
                flat[f".opt_{net}.exp_avg{name}"] = (
                    slot["exp_avg"].detach().cpu().numpy())
                flat[f".opt_{net}.exp_avg_sq{name}"] = (
                    slot["exp_avg_sq"].detach().cpu().numpy())
                count = int(slot["step"])
        flat[f".opt_{net}.count"] = np.asarray(count, np.int32)
    return flat


def save(ckpt_dir: str, state: TrainState, hp,
         config: Optional[dict] = None) -> str:
    """Save the train state as ``ckpt_dir/step_N.npz`` plus a
    ``step_N.json`` with the step and hyperparameters. Returns the path."""
    step = int(state.step)
    base = Path(ckpt_dir).absolute()
    base.mkdir(parents=True, exist_ok=True)
    path = base / f"step_{step}.npz"
    np.savez(path, **_flatten_state(state))
    meta = {
        "step": step,
        "hparams": {k: v for k, v in vars(hp).items()
                    if isinstance(v, (int, float, str, bool, tuple, list))},
    }
    if config:
        meta["dataset_config"] = config
    with open(base / f"step_{step}.json", "w", encoding="utf-8") as f:
        json.dump(meta, f, indent=2, default=list)
    return str(path)


def _fill(tree, flat: Dict[str, np.ndarray], prefix: str) -> None:
    """Copy ``flat[prefix + name]`` into every leaf of ``tree``, in place;
    raise on a missing leaf or a shape mismatch."""
    with torch.no_grad():
        for name, leaf in keyed_leaves(tree):
            key = prefix + name
            if key not in flat:
                raise ValueError(f"checkpoint missing leaf {key}")
            value = np.asarray(flat[key])
            if tuple(leaf.shape) != value.shape:
                raise ValueError(
                    f"shape mismatch for {key}: checkpoint {value.shape} "
                    f"vs model {tuple(leaf.shape)}")
            leaf.copy_(torch.from_numpy(value.astype(np.float32)))


def trees_from_flat(flat: Dict[str, np.ndarray], hp,
                    cfg: Optional[TrainConfig] = None) -> Tuple[dict, dict]:
    """The port's (G, D) parameter trees, on the CPU, from a flat dict of
    numpy arrays under the JAX keypath names (``.params_g...``,
    ``.params_d...``): a JAX train state flattened by its checkpoint
    module. ``cfg`` gives the discriminator's periods and channel scale."""
    state = init_train_state(hp, cfg or TrainConfig())
    _fill(state.params_g, flat, ".params_g")
    _fill(state.params_d, flat, ".params_d")
    return state.params_g, state.params_d


def _moment_keys(flat) -> Dict[Tuple[str, str, str], str]:
    """(net, port moment name, leaf name) -> key of optax's AdamW moment."""
    out = {}
    for key in flat:
        m = _OPTAX_MOMENT.match(key)
        if m:
            net, idx, moment, leaf = m.groups()
            name = "exp_avg" if moment == "mu" else "exp_avg_sq"
            out[(net, name, leaf)] = key
            out[(net, "count", "")] = f".opt_{net}{idx}.count"
    return out


def _restore_optimizer(opt: torch.optim.Optimizer, params, net: str,
                       flat: Dict[str, np.ndarray]) -> None:
    optax_keys = _moment_keys(flat)

    def lookup(name: str, leaf: str):
        own = f".opt_{net}.{name}{leaf}"
        if own in flat:
            return flat[own]
        key = optax_keys.get((net, name, leaf if name != "count" else ""))
        return None if key is None else flat[key]

    count = lookup("count", "")
    if count is None or int(count) == 0:
        return  # no update taken yet: the optimizer starts empty
    for name, p in keyed_leaves(params):
        exp_avg, exp_avg_sq = lookup("exp_avg", name), lookup("exp_avg_sq",
                                                              name)
        if exp_avg is None or exp_avg_sq is None:
            raise ValueError(f"checkpoint missing optimizer state for "
                             f"{net}{name}")
        opt.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": torch.from_numpy(
                np.asarray(exp_avg, np.float32)).to(p.device),
            "exp_avg_sq": torch.from_numpy(
                np.asarray(exp_avg_sq, np.float32)).to(p.device),
        }


def restore(path: str, state: TrainState) -> TrainState:
    """Restore a checkpoint written by :func:`save` or by the JAX trainer
    into ``state`` (in place: parameters, optimizer moments, step)."""
    with np.load(path) as stored:
        flat = {k: stored[k] for k in stored.files}
    _fill(state.params_g, flat, ".params_g")
    _fill(state.params_d, flat, ".params_d")
    _restore_optimizer(state.opt_g, state.params_g, "g", flat)
    _restore_optimizer(state.opt_d, state.params_d, "d", flat)
    state.step = int(flat[".step"])
    return state


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    base = Path(ckpt_dir)
    if not base.is_dir():
        return None
    steps = []
    for entry in base.iterdir():
        if entry.name.startswith("step_") and entry.suffix == ".npz":
            try:
                steps.append((int(entry.stem.split("_")[1]), entry))
            except ValueError:
                continue
    if not steps:
        return None
    return str(max(steps)[1])
