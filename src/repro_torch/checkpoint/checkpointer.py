"""Tree checkpoints in ``.npz`` files (port of
``repro.checkpoint.checkpointer``, with its file layout).

Layout: one ``step_<N>.npz`` per checkpoint with '/'-joined tree paths as
array keys (dict keys, list indices), plus a JSON sidecar
``step_<N>.npz.json`` for metadata. The newest ``max_to_keep``
checkpoints of each kind are kept.

numpy on a machine without ``ml_dtypes`` has no bfloat16, so a bf16 leaf
is stored as its uint16 bit pattern, and the sidecar's ``"dtypes"`` maps
its key to ``"bfloat16"``; ``restore`` views the bits back. Other leaves
are stored in their own dtype.

Wire-compressed checkpoints (``save_wire`` / ``restore_wire``): the
params and the bucket-shaped error-feedback memory go through the packed
sparse codec (``core.encoding.snapshot_encode``) instead of dense
float32 dumps:

* params buckets: diff-encoded against a base checkpoint when one is
  given (exact, small under sparse training), dense fallback otherwise
  (exact, one header of overhead);
* memory buckets: a per-row top-k cap (``memory_ratio``) keeps the
  dominant mass at ~ratio of the dense bytes; error feedback corrects the
  truncated residual within a few steps of a resume.

Each record is a uint32 wire buffer (stored as numpy uint32 through its
int32 view, byte for byte the reference's); each record's layout and
exact size are in the sidecar (``meta["wire"]``), so that the two
packages read each other's wire checkpoints. Restore rebuilds the params
bit for bit and the memory exact on the kept support.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.utils.platform import resolve_device
from repro_torch.utils.tree import tree_flatten, tree_paths


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    if t.dtype == torch.uint32:
        return t.view(torch.int32).numpy().view(np.uint32)
    return t.numpy()


def _to_torch(a: np.ndarray, dtype_name: Optional[str], device
              ) -> torch.Tensor:
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = np.array(a)
    if dtype_name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    if a.dtype == np.uint32:  # a wire buffer, read through its int32 view
        return torch.from_numpy(a.view(np.int32)).to(device)
    return torch.from_numpy(a).to(device)


def _set_in(tree: dict, key: str, value):
    parts = key.split("/")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.dir = directory
        self.max_to_keep = max_to_keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}.npz")

    def save(self, step: int, tree, metadata: Optional[dict] = None) -> str:
        """Dump ``tree``'s tensors (host copies) as ``step_<N>.npz`` with
        the sidecar; returns the path."""
        leaves, _ = tree_flatten(tree)
        keys = [_key(p) for p in tree_paths(tree)]
        flat = {k: _to_numpy(x) for k, x in zip(keys, leaves)}
        dtypes = {k: "bfloat16" for k, x in zip(keys, leaves)
                  if x.dtype == torch.bfloat16}
        path = self._path(step)
        with open(path, "wb") as f:  # a file object: savez adds no suffix
            np.savez(f, **flat)
        meta = dict(metadata or {}, step=step)
        if dtypes:
            meta["dtypes"] = dtypes
        with open(path + ".json", "w") as f:
            json.dump(meta, f)
        self._gc()
        return path

    def steps(self) -> list:
        return self._steps(r"step_(\d+)\.npz$")

    def _steps(self, pattern: str) -> list:
        out = []
        for f in os.listdir(self.dir):
            m = re.match(pattern, f)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: Optional[int] = None, like: Any = None,
                device="cuda") -> tuple:
        """Returns (tree, metadata). With ``like`` the arrays come back in
        its structure (strict match), each on its leaf's device; without,
        a nested dict of tensors on ``device`` (the card unless the
        caller asks for the CPU)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = self._path(step)
        data = np.load(path)
        meta = {}
        if os.path.exists(path + ".json"):
            with open(path + ".json") as f:
                meta = json.load(f)
        dtypes = meta.get("dtypes", {})
        if like is not None:
            keys = [_key(p) for p in tree_paths(like)]
            missing = set(keys) - set(data.files)
            extra = set(data.files) - set(keys)
            if missing or extra:
                raise ValueError(
                    f"checkpoint mismatch: missing={sorted(missing)[:5]} "
                    f"extra={sorted(extra)[:5]}")
            leaves, treedef = tree_flatten(like)
            return treedef.unflatten(
                _to_torch(data[k], dtypes.get(k), x.device)
                for k, x in zip(keys, leaves)), meta
        device = resolve_device(device)
        tree: dict = {}
        for k in data.files:
            _set_in(tree, k, _to_torch(data[k], dtypes.get(k), device))
        return tree, meta

    def _gc(self):
        for steps, suffixes in (
                (self.steps(), (".npz", ".npz.json")),
                (self.wire_steps(), (".wire.npz", ".wire.npz.json"))):
            for s in steps[: -self.max_to_keep]:
                for suffix in suffixes:
                    p = os.path.join(self.dir, f"step_{s:08d}{suffix}")
                    if os.path.exists(p):
                        os.remove(p)

    # -- wire-compressed checkpoints (packed sparse codec) ------------------

    def _wire_path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}.wire.npz")

    def wire_steps(self) -> list:
        return self._steps(r"step_(\d+)\.wire\.npz$")

    def latest_wire_step(self) -> Optional[int]:
        s = self.wire_steps()
        return s[-1] if s else None

    @staticmethod
    def _record_meta(rec) -> dict:
        s = rec.spec
        return {
            "rows": s.rows, "cols": s.cols, "k": s.k,
            "value_dtype": s.value_dtype, "kind": s.kind,
            "vs_base": rec.vs_base, "exact": rec.exact,
            "nbytes": rec.nbytes, "dense_nbytes": rec.dense_nbytes,
            "dropped_frac": rec.dropped_frac,
        }

    def save_wire(self, step: int, params, memory: Optional[Sequence], plan,
                  *, base_params=None, memory_ratio: Optional[float] = 0.05,
                  metadata: Optional[dict] = None) -> str:
        """Checkpoint (params, bucket memory) through the packed codec.

        ``plan`` is the training ``BucketPlan``; ``memory`` the tuple of
        bucket-space buffers (any leading dims) or None; ``base_params``
        makes the params records exact diffs against it (pass the same
        tree to ``restore_wire``). The memory cap keeps
        k = max(1, round(memory_ratio * cols)) entries a row
        (``kernels.ops.row_topk``). Returns the .wire.npz path; the
        sidecar carries each record's exact size."""
        from repro_torch.core import buckets as bk
        from repro_torch.core import encoding as enc

        arrays: dict = {}
        recs_meta = []
        pbufs = bk.pack(plan, params)
        bbufs = bk.pack(plan, base_params) if base_params is not None else None
        for i in range(len(pbufs)):
            rec = enc.snapshot_encode(
                pbufs[i], base=None if bbufs is None else bbufs[i])
            pbufs[i] = None
            arrays[f"params/{i}"] = _to_numpy(rec.buf)
            recs_meta.append(dict(self._record_meta(rec), section="params",
                                  index=i))
        del pbufs, bbufs
        for i, m in enumerate(memory or ()):
            cols = m.shape[-1]
            k = None
            if memory_ratio is not None:
                k = max(1, round(memory_ratio * cols))
            rec = enc.snapshot_encode(m.reshape(-1, cols), k=k)
            arrays[f"memory/{i}"] = _to_numpy(rec.buf)
            recs_meta.append(dict(self._record_meta(rec), section="memory",
                                  index=i, orig_shape=list(m.shape)))
        path = self._wire_path(step)
        with open(path, "wb") as f:  # a file object: savez adds no suffix
            np.savez(f, **arrays)
        nbytes = sum(r["nbytes"] for r in recs_meta)
        dense = sum(r["dense_nbytes"] for r in recs_meta)
        meta = dict(
            metadata or {}, step=step,
            wire={
                "records": recs_meta, "nbytes": nbytes,
                "dense_nbytes": dense,
                "ratio_vs_dense": dense / max(1, nbytes),
                "has_base": base_params is not None,
                "memory_ratio": memory_ratio,
            })
        with open(path + ".json", "w") as f:
            json.dump(meta, f)
        self._gc()
        return path

    def restore_wire(self, step: Optional[int] = None, *, plan,
                     base_params=None, device="cuda") -> tuple:
        """Inverse of ``save_wire``: returns (params, memory_bufs, meta).
        ``base_params`` must be the tree given at save time for
        diff-encoded records (checked). Decodes on the base's device, else
        on ``device`` (the card unless the caller asks for the CPU)."""
        from repro_torch.core import buckets as bk
        from repro_torch.core import encoding as enc

        if step is None:
            step = self.latest_wire_step()
        if step is None:
            raise FileNotFoundError(f"no wire checkpoints in {self.dir}")
        path = self._wire_path(step)
        data = np.load(path)
        with open(path + ".json") as f:
            meta = json.load(f)
        bbufs = bk.pack(plan, base_params) if base_params is not None else None
        device = (bbufs[0].device if bbufs is not None
                  else resolve_device(device))
        pbufs: dict = {}
        mem: dict = {}
        for r in meta["wire"]["records"]:
            spec = enc.WireSpec(r["rows"], r["cols"], r["k"],
                                r["value_dtype"], kind=r["kind"])
            rec = enc.SnapshotRecord(
                spec=spec,
                buf=_to_torch(data[f"{r['section']}/{r['index']}"], None,
                              device),
                vs_base=r["vs_base"], exact=r["exact"],
                dense_nbytes=r["dense_nbytes"],
                dropped_frac=r["dropped_frac"])
            if rec.vs_base and bbufs is None:
                raise ValueError(
                    "checkpoint is diff-encoded: pass the base_params tree "
                    "it was saved against")
            if r["section"] == "params":
                base = bbufs[r["index"]] if rec.vs_base else None
                pbufs[r["index"]] = enc.snapshot_decode(rec, base=base)
            else:
                mem[r["index"]] = enc.snapshot_decode(rec).reshape(
                    r["orig_shape"])
        del bbufs
        params = bk.unpack(plan, [pbufs[i] for i in sorted(pbufs)],
                           cast=True)
        memory = tuple(mem[i] for i in sorted(mem))
        return params, memory, meta
