"""Checkpoints with resume (counterpart of ``nerf_tpu/train/checkpoint.py``,
its single-file layout).

The full train state (weights, Adam moments, step, seed) round-trips
through atomic writes with retention and resume, plus an export to the
reference's ``.pth`` layout.

The files are the JAX package's, so either package reads what the other
wrote: one ``checkpoint_<step>.npz`` holds the leaves of JAX's
``TrainState(step, params, opt_state, key)`` in its flatten order (leaf
``i`` under ``leaf_{i:05d}``) and their pytree-path names
(``leaf_names``, JAX's ``keystr`` strings), which restore checks:

* ``.step``: int32, shape ``()``;
* ``.params...``: the weights in the JAX layout (dict keys sorted, lists
  by index, a Linear's ``w`` as ``[in, out]``), from the port's modules
  through ``utils/pth_import.py``;
* ``.opt_state[0].count``, int32: Adam's per-parameter ``step`` (all
  equal); then ``.opt_state[0].mu...`` and ``.opt_state[0].nu...``:
  ``exp_avg`` and ``exp_avg_sq``, mapped like the weights (they share
  the parameters' torch layout).  Before the first step the moments are
  zeros and the count 0;
* ``.key``: uint32 ``[seed >> 32, seed & 0xffffffff]``, the raw data of
  JAX's ``PRNGKey(seed)``; restore takes the seed back from it.

A JAX-written checkpoint resumed here carries its weights, moments, step
and seed, but does not continue the JAX run's trajectory: the port's
per-step draws come from torch's Philox generator seeded from (seed,
step) (``state.step_generator``), JAX's from threefry.

The sharded layout is JAX's too: a ``checkpoint_<step>.npz`` manifest
(``sharded``, ``num_shard_files``, each leaf's ``shape`` and ``dtype``, or
its ``value``) beside one ``checkpoint_<step>.shards<p>.npz`` per rank,
whose ``leaf_<i>.s<j>.data`` pieces carry their global index bounds
(``.bounds``, ``[dims, 2]``, in JAX's ``[in, out]`` layout).  It is written
when a leaf is split across ranks, a tensor-parallel state over a model
axis of more than one rank (``parallel/tensor_parallel.py``): every rank
writes the blocks it owns (index 0 along each axis the leaf is not split
over, JAX's ``replica_id == 0``), then, after a barrier, rank 0 writes the
manifest, whose presence marks the checkpoint complete; the step, Adam's
count and the key are manifest values.  Restore reassembles each leaf
from its pieces (a missing shard file or an uncovered element raises), and
a tensor-parallel state takes its own block of each, so a checkpoint
restores onto another mesh shape.  Any other state is replicated: the
coordinator writes the single file alone while a process group is up, as
JAX picks the single file for replicated states.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from nerf_tpu_torch.config import MipNeRFConfig
from nerf_tpu_torch.train.state import TrainState
from nerf_tpu_torch.utils import pth_import

_CKPT_RE = re.compile(r"checkpoint_(\d+)\.npz$")
_SHARDS_RE = re.compile(r"checkpoint_(\d+)\.shards(\d+)\.npz$")
_ADAM = ".opt_state[0]"
# The trees whose leaves are the model's tensors (written to shard files
# in the sharded layout); the step, the count and the key are scalars.
_TENSOR_TREES = (".params", f"{_ADAM}.mu", f"{_ADAM}.nu")


def _flatten(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """``(keystr, leaf)`` pairs of a nested dict/list tree in JAX's
    flatten order: dict keys sorted, lists by index.  A tuple is a leaf (a
    tensor-parallel partition spec)."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _flatten(tree[key], f"{path}[{key!r}]")
    elif isinstance(tree, list):
        for i, sub in enumerate(tree):
            yield from _flatten(sub, f"{path}[{i}]")
    else:
        yield path, tree


def _refill(tree: Any, leaves: Iterator) -> Any:
    """``tree`` with its leaves replaced, in ``_flatten``'s order."""
    if isinstance(tree, dict):
        return {key: _refill(tree[key], leaves) for key in sorted(tree)}
    if isinstance(tree, list):
        return [_refill(sub, leaves) for sub in tree]
    return next(leaves)


def _to_jax_tree(model, named: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Tensors keyed like ``model.mlp``'s state_dict -> the JAX pytree."""
    if isinstance(model.cfg, MipNeRFConfig):
        return pth_import.jax_params_from_mip_state_dict(named, model.cfg)
    return pth_import.jax_params_from_classic_state_dict(named, model.cfg)


def _from_jax_tree(model, tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    if isinstance(model.cfg, MipNeRFConfig):
        return pth_import.mip_state_dict_from_jax_params(tree)
    return pth_import.classic_state_dict_from_jax_params(tree)


def adam_state(state: TrainState) -> Tuple[int, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """``(count, exp_avg, exp_avg_sq)``, the moments keyed by parameter
    name (zeros before the first step).  Raises if the parameters' Adam
    steps differ."""
    steps, mu, nu = set(), {}, {}
    for name, p in state.model.mlp.named_parameters():
        st = state.optimizer.state.get(p, {})
        steps.add(int(st["step"]) if "step" in st else 0)
        mu[name] = st["exp_avg"] if "exp_avg" in st else torch.zeros_like(p)
        nu[name] = st["exp_avg_sq"] if "exp_avg_sq" in st else torch.zeros_like(p)
    if len(steps) != 1:
        raise ValueError(f"Adam's per-parameter steps disagree: {sorted(steps)}")
    return steps.pop(), mu, nu


def _state_trees(state: TrainState) -> Dict[str, Any]:
    """The JAX ``TrainState``'s fields as numpy trees, keyed by path prefix."""
    count, mu, nu = adam_state(state)
    seed = int(state.seed)
    return {
        ".step": np.asarray(state.step, np.int32),
        ".params": _to_jax_tree(state.model, state.model.mlp.state_dict()),
        f"{_ADAM}.count": np.asarray(count, np.int32),
        f"{_ADAM}.mu": _to_jax_tree(state.model, mu),
        f"{_ADAM}.nu": _to_jax_tree(state.model, nu),
        ".key": np.asarray([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32),
    }


def _state_leaves(trees: Dict[str, Any]) -> List[Tuple[str, np.ndarray]]:
    """The checkpoint's ``(name, leaf)`` pairs of ``_state_trees``, in
    file order."""
    return [
        (prefix + path, np.asarray(leaf))
        for prefix, tree in trees.items()
        for path, leaf in _flatten(tree)
    ]


def _atomic_savez(directory: str, path: str, payload: dict) -> None:
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _blocks(state: TrainState) -> Dict[str, Tuple[Tuple[int, ...], np.ndarray, bool]]:
    """By leaf name, the tensor leaves of a tensor-parallel state: global
    shape, this rank's block (``[dims, 2]`` bounds) and whether this rank
    writes it (``TensorParallelMLP.jax_layout``); empty for any other
    state."""
    layout = getattr(state.model.mlp, "jax_layout", None) or {}
    return {prefix + path: block for prefix in _TENSOR_TREES for path, block in layout.items()}


def _is_split(blocks) -> bool:
    return any(tuple(b[:, 1] - b[:, 0]) != shape for shape, b, _ in blocks.values())


def save_checkpoint(directory: str, state: TrainState, keep: int = 3,
                    sharded: Optional[bool] = None) -> str:
    """Atomically write checkpoint ``<step>``; prune to the ``keep``
    newest.  Returns the path of ``checkpoint_<step>.npz``.

    ``sharded``: the layout (``None`` picks the sharded one when a leaf is
    split across ranks).  In the single-file layout only rank 0 writes
    while a process group is up (the state is replicated); the other ranks
    return the path without writing, and callers that read it back wait at
    a barrier.  In the sharded layout every rank must call this: each
    writes its shard file, rank 0 the manifest between two barriers."""
    path = os.path.join(directory, f"checkpoint_{int(state.step)}.npz")
    blocks = _blocks(state)
    if sharded is None:
        sharded = _is_split(blocks)
    if sharded:
        _save_sharded(directory, path, state, blocks, keep)
        return path
    if _is_split(blocks):
        raise ValueError("the state is split across ranks: save it in the sharded layout")
    if dist.is_initialized() and dist.get_rank() != 0:
        return path
    os.makedirs(directory, exist_ok=True)
    leaves = _state_leaves(_state_trees(state))
    payload = {f"leaf_{i:05d}": leaf for i, (_, leaf) in enumerate(leaves)}
    payload["leaf_names"] = np.asarray([name for name, _ in leaves])
    _atomic_savez(directory, path, payload)
    _prune(directory, keep)
    return path


def _save_sharded(directory: str, path: str, state: TrainState, blocks, keep: int) -> None:
    """The sharded layout: this rank's blocks in its shard file, then rank
    0's manifest between two barriers, then each rank's pruning."""
    from nerf_tpu_torch.parallel import distributed  # train/loop.py imports that package

    group = dist.is_initialized()
    rank, world = (dist.get_rank(), dist.get_world_size()) if group else (0, 1)
    os.makedirs(directory, exist_ok=True)
    leaves = _state_leaves(_state_trees(state))
    payload, manifest = {}, {}
    for i, (name, leaf) in enumerate(leaves):
        key = f"leaf_{i:05d}"
        if not name.startswith(_TENSOR_TREES):
            manifest[f"{key}.value"] = leaf
            continue
        full = np.stack([np.zeros(leaf.ndim, np.int64), np.asarray(leaf.shape, np.int64)], -1)
        shape, bounds, writes = blocks.get(name, (leaf.shape, full, rank == 0))
        manifest[f"{key}.shape"] = np.asarray(shape, dtype=np.int64)
        manifest[f"{key}.dtype"] = np.asarray(str(leaf.dtype))
        if writes:
            payload[f"{key}.s0.data"] = leaf
            payload[f"{key}.s0.bounds"] = bounds
    step = int(state.step)
    _atomic_savez(directory, os.path.join(directory, f"checkpoint_{step}.shards{rank}.npz"),
                  payload)
    if group:  # every shard file written before the manifest marks completion
        distributed.collective_barrier()
    if rank == 0:
        manifest.update(leaf_names=np.asarray([name for name, _ in leaves]),
                        sharded=np.asarray(True), num_shard_files=np.asarray(world))
        _atomic_savez(directory, path, manifest)
    if group:
        distributed.collective_barrier()
    _prune(directory, keep, proc=rank)


def _prune(directory: str, keep: int, proc: int = 0) -> None:
    """Remove the checkpoints older than the ``keep`` newest: rank
    ``proc``'s own shard files, and on rank 0 the manifests and single
    files.  The newest are counted over the manifests and this rank's own
    shard files, so a rank that lists the directory after rank 0 pruned
    still drops its files of the same steps."""
    names = os.listdir(directory)
    steps, own = set(), []
    for name in names:
        m = _CKPT_RE.match(name)
        if m:
            steps.add(int(m.group(1)))
        m = _SHARDS_RE.match(name)
        if m and int(m.group(2)) == proc:
            steps.add(int(m.group(1)))
            own.append((int(m.group(1)), name))
    drop = set(sorted(steps)[:-keep])
    for name in names:
        m = _CKPT_RE.match(name)
        if proc == 0 and m and int(m.group(1)) in drop:
            os.remove(os.path.join(directory, name))
    for step, name in own:
        if step in drop:
            os.remove(os.path.join(directory, name))


def all_checkpoints(directory: str) -> List[str]:
    """Checkpoint filenames sorted by step (oldest first)."""
    if not os.path.isdir(directory):
        return []
    found = []
    for name in os.listdir(directory):
        m = _CKPT_RE.match(name)
        if m:
            found.append((int(m.group(1)), name))
    return [name for _, name in sorted(found)]


def latest_checkpoint(directory: str) -> Optional[str]:
    names = all_checkpoints(directory)
    return os.path.join(directory, names[-1]) if names else None


def _validate(names: List[str], arrays: List[np.ndarray],
              want: List[Tuple[str, np.ndarray]]) -> None:
    t_names = [name for name, _ in want]
    if names != t_names:
        raise ValueError(
            f"checkpoint structure mismatch: file has {len(names)} leaves, "
            f"template has {len(t_names)}; first differing path: "
            f"{next((a for a, b in zip(names, t_names) if a != b), '<count>')}"
        )
    for name, got, (_, leaf) in zip(names, arrays, want):
        if got.shape != leaf.shape:
            raise ValueError(
                f"checkpoint leaf shape mismatch at {name}: {got.shape} vs {leaf.shape}"
            )


def _read_sharded(path: str, manifest) -> Tuple[List[str], List[np.ndarray]]:
    """The leaf names and global arrays of a sharded checkpoint (JAX's
    ``save_checkpoint(sharded=True)``): each leaf from the manifest's
    ``value`` or reassembled from the shard files' pieces by their index
    bounds."""
    directory = os.path.dirname(path) or "."
    step = int(_CKPT_RE.search(os.path.basename(path)).group(1))
    names = [str(n) for n in manifest["leaf_names"]]
    n_files = int(manifest["num_shard_files"])
    shard_paths = [os.path.join(directory, f"checkpoint_{step}.shards{p}.npz")
                   for p in range(n_files)]
    for shard_path in shard_paths:
        if not os.path.exists(shard_path):
            raise FileNotFoundError(
                f"sharded checkpoint is missing {shard_path} "
                f"(manifest expects {n_files} shard files)"
            )
    arrays: List[Optional[np.ndarray]] = [None] * len(names)
    seen: Dict[int, np.ndarray] = {}
    for i in range(len(names)):
        key = f"leaf_{i:05d}"
        if f"{key}.value" in manifest.files:
            arrays[i] = manifest[f"{key}.value"]
        else:
            shape = tuple(int(s) for s in manifest[f"{key}.shape"])
            arrays[i] = np.zeros(shape, dtype=np.dtype(str(manifest[f"{key}.dtype"])))
            seen[i] = np.zeros(shape, dtype=bool)
    for shard_path in shard_paths:
        with np.load(shard_path, allow_pickle=False) as data:
            for key in data.files:
                if not key.endswith(".data"):
                    continue
                i = int(key[len("leaf_"):len("leaf_") + 5])
                if i not in seen:
                    raise ValueError(f"{shard_path} holds {key}, which the manifest does not shard")
                bounds = data[key[:-len(".data")] + ".bounds"]
                where = tuple(slice(int(a), int(b)) for a, b in bounds)
                arrays[i][where] = data[key]
                seen[i][where] = True
    for i, covered in seen.items():
        if not covered.all():
            raise ValueError(
                f"sharded checkpoint leaf {names[i]} has uncovered elements: "
                "missing or truncated shard files"
            )
    return names, arrays


def _own_block(name: str, array: np.ndarray, block) -> np.ndarray:
    """This rank's block of a whole leaf read from a checkpoint."""
    shape, bounds, _ = block
    if array.shape != shape:
        raise ValueError(f"checkpoint leaf shape mismatch at {name}: {array.shape} vs {shape}")
    return array[tuple(slice(a, b) for a, b in bounds)]


def load_adam_state(state: TrainState, count: int, mu: Dict[str, torch.Tensor],
                    nu: Dict[str, torch.Tensor]) -> None:
    """Set Adam's ``step`` to ``count`` and its moments to ``mu`` and
    ``nu`` (keyed by parameter name) for every parameter of the model,
    cast and placed like the parameters."""
    optimizer = state.optimizer
    opt_sd = optimizer.state_dict()
    index = {
        id(p): i
        for group, saved in zip(optimizer.param_groups, opt_sd["param_groups"])
        for p, i in zip(group["params"], saved["params"])
    }
    for name, p in state.model.mlp.named_parameters():
        opt_sd["state"][index[id(p)]] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": mu[name],
            "exp_avg_sq": nu[name],
        }
    optimizer.load_state_dict(opt_sd)  # casts and places the moments like the parameters


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load a checkpoint into ``state`` (in place; returned): the weights
    (``load_state_dict``), Adam's ``exp_avg``, ``exp_avg_sq`` and ``step``
    on the parameters' device, ``state.step`` and ``state.seed``.  Reads
    the single-file layout and the sharded one; a tensor-parallel state
    takes its own block of each leaf.

    Validates the leaf names and shapes against ``state``'s model first,
    so a config or architecture mismatch raises ``ValueError`` naming the
    first path that differs instead of loading wrong weights."""
    with np.load(path, allow_pickle=False) as data:
        if "sharded" in data.files:
            names, arrays = _read_sharded(path, data)
        else:
            names = [str(n) for n in data["leaf_names"]]
            arrays = [data[f"leaf_{i:05d}"] for i in range(len(names))]
    trees = _state_trees(state)
    want = _state_leaves(trees)
    blocks = _blocks(state)
    if names == [name for name, _ in want]:  # else _validate names the mismatch
        arrays = [_own_block(name, a, blocks[name]) if name in blocks else a
                  for name, a in zip(names, arrays)]
    _validate(names, arrays, want)
    leaves = dict(zip(names, arrays))

    def tree(prefix: str) -> Dict[str, torch.Tensor]:
        filled = _refill(trees[prefix], (leaves[prefix + p] for p, _ in _flatten(trees[prefix])))
        return _from_jax_tree(state.model, filled)

    state.model.mlp.load_state_dict(tree(".params"))
    load_adam_state(state, int(leaves[f"{_ADAM}.count"]), tree(f"{_ADAM}.mu"),
                    tree(f"{_ADAM}.nu"))
    state.step = int(leaves[".step"])
    hi, lo = (int(v) for v in leaves[".key"])
    state.seed = (hi << 32) | lo
    return state


def restore_latest(directory: str, state: TrainState) -> Optional[TrainState]:
    path = latest_checkpoint(directory)
    return restore_checkpoint(path, state) if path else None


# -- reference interop -------------------------------------------------------


def export_reference_pth(path: str, model) -> None:
    """Save a ClassicNeRF's weights as a reference-loadable ``.pth``
    state_dict (CPU tensors)."""
    torch.save({k: v.detach().cpu().clone() for k, v in model.mlp.state_dict().items()}, path)
