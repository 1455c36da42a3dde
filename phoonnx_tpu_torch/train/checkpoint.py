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
quantities, so a JAX run resumes in the port.

Generator imports (JAX ``checkpoint.py:78-162``): :func:`restore_generator`
reads the ``.params_g`` leaves of either trainer's checkpoint (the
exporter's source), and :func:`load_generator_warm_start` imports a
generator from an exported ONNX container or a torch Lightning
checkpoint into a (possibly multi-speaker) model, with the reference's
missing-key tolerance and single->multi-speaker surgery (train.py:15-26,
131-144).
"""

import json
import logging
import re
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from phoonnx_tpu_torch.train.step import (TrainConfig, TrainState,
                                          init_train_state, keyed_leaves)

LOG = logging.getLogger(__name__)

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


def restore_generator(path: str, hp):
    """Only the generator parameters of a train-state checkpoint (written
    by :func:`save` or by the JAX trainer), as a tree of CPU float32
    tensors. Robust to training-side differences (discriminator size,
    optimizer states): only ``.params_g`` leaves are read, into a fresh
    skeleton, and a missing leaf or a shape mismatch raises."""
    from phoonnx_tpu_torch.models.vits.model import random_params

    with np.load(path) as stored:
        flat = {k: stored[k] for k in stored.files
                if k.startswith(".params_g")}
    params = random_params(hp, torch.Generator().manual_seed(0))
    _fill(params, flat, ".params_g")
    return params


def _flat_from_torch_ckpt(path: str) -> Dict[str, np.ndarray]:
    """Flat generator arrays from a torch Lightning checkpoint."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state_dict = ckpt.get("state_dict", ckpt)
    flat = {}
    for key, value in state_dict.items():
        if key.startswith("model_g."):
            flat[key[len("model_g."):]] = value.numpy()
    return flat


def load_generator_flat(path: str) -> Dict[str, np.ndarray]:
    """Flat generator arrays from .onnx container or torch .ckpt."""
    if path.endswith(".onnx"):
        from phoonnx_tpu_torch.onnx.reader import read_onnx

        return read_onnx(path).initializers
    return _flat_from_torch_ckpt(path)


_SPEAKER_COND_PREFIXES = ("dec.cond.", "dp.cond.", "enc_q.enc.cond_layer.")


def _copy_into(target: Any, source: Any) -> None:
    """Copy ``source``'s tensors into ``target``'s (same tree), where a
    folded ``weight`` in ``source`` fills a weight-norm pair of
    ``target`` as v = weight, g = its norm over all dims but 0, so that
    ``nn.weight_norm(v, g)`` is the weight again."""
    if isinstance(target, dict):
        for key, value in target.items():
            if key in ("weight_v", "weight_g") and "weight_v" not in source:
                weight = source["weight"]
                if key == "weight_v":
                    value.copy_(weight)
                else:
                    dims = tuple(range(1, weight.ndim))
                    value.copy_(torch.sqrt(torch.sum(
                        weight * weight, dim=dims, keepdim=True)))
            else:
                _copy_into(value, source[key])
    elif isinstance(target, list):
        for t, s in zip(target, source):
            _copy_into(t, s)
    elif isinstance(target, torch.Tensor):
        target.copy_(source.to(target.device, target.dtype))


def _cpu_copy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _cpu_copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cpu_copy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    return tree


def load_generator_warm_start(path: str, hp, target_params):
    """Import a single-speaker generator into a (possibly multi-speaker)
    model, dropping conditioning layers absent in the source
    (reference surgery: train.py:131-144). Missing keys keep their fresh
    initialization (missing-key-tolerant load, train.py:15-26).

    ``target_params`` is that fresh initialization, a training tree whose
    leaves are written in place (the optimizer keeps its references) and
    returned. The JAX function returns a new tree whose missing leaves are
    ``random_params(PRNGKey(0))``'s and whose folded weights (an export's
    decoder) replace their weight-norm pairs, a tree its optimizer state
    does not fit; here a folded weight w fills its pair as v = w,
    g = ||w||, the parametrisation torch's weight_norm starts from.
    """
    from phoonnx_tpu_torch.models.vits import load

    flat = load_generator_flat(path)
    flat = {
        k: v for k, v in flat.items()
        if not k.startswith(_SPEAKER_COND_PREFIXES) and
        not k.startswith("emb_g.")
    }
    loaded = _cpu_copy(target_params)
    filled, _ = load.fill_from_flat(loaded, flat)
    LOG.info("warm start: %d generator tensors from %s", len(filled), path)
    with torch.no_grad():
        _copy_into(target_params, loaded)
    return target_params
