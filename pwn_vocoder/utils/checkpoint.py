"""Checkpoint / resume (reference: tensorpack `ModelSaver` +
`SaverRestore` over tf.train.Saver [R]; SURVEY.md §5 "Checkpoint / resume").

Layout: one directory per step, `<directory>/<step>/`, holding
`arrays.npz` (every leaf of the saved pytree, as raw bytes) and
`manifest.json` (each leaf's tree path, shape and dtype).  A save writes
`<directory>/.<step>.partial/` and renames it into place, so a step
directory that exists is complete: `latest_step` never sees a torn
write, and a killed save leaves only a hidden partial directory that the
next save of that step replaces.

Saves are synchronous.  In a multi-process run every process calls
`save`; process 0 alone writes (the saved arrays are replicated), and all
processes then meet at a barrier so none races ahead to a restore.
Restores fail fast: a missing step, or a tree, shape or dtype that
differs from the template, raises.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, List, Optional, Tuple

import jax
import numpy as np

_ARRAYS = "arrays.npz"
_MANIFEST = "manifest.json"


def _host_array(leaf: Any) -> np.ndarray:
    """A leaf as a host numpy array (replicated arrays only across
    processes)."""
    if isinstance(leaf, jax.Array) and not leaf.is_fully_addressable:
        if not leaf.is_fully_replicated:
            raise ValueError(
                "cannot checkpoint an array sharded across processes; "
                "replicate it first"
            )
        leaf = leaf.addressable_data(0)
    return np.asarray(jax.device_get(leaf))


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = directory
        self.max_to_keep = max_to_keep
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def save(self, step: int, state: Any) -> None:
        """Write `state` (any pytree of arrays) as checkpoint `step`."""
        flat, _ = jax.tree_util.tree_flatten_with_path(state)
        host = [_host_array(leaf) for _, leaf in flat]
        if jax.process_index() == 0:
            tmp = os.path.join(self.directory, f".{step}.partial")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            raw = {f"a{i}": np.ascontiguousarray(a).reshape(-1).view(np.uint8)
                   for i, a in enumerate(host)}
            np.savez(os.path.join(tmp, _ARRAYS), **raw)
            manifest = {
                "step": int(step),
                "leaves": [
                    {"path": jax.tree_util.keystr(path),
                     "shape": list(a.shape), "dtype": a.dtype.name}
                    for (path, _), a in zip(flat, host)
                ],
            }
            with open(os.path.join(tmp, _MANIFEST), "w") as f:
                json.dump(manifest, f)
            final = self._step_dir(step)
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils

            multihost_utils.sync_global_devices(f"checkpoint_save_{step}")

    def all_steps(self) -> List[int]:
        """Committed checkpoint steps, ascending (the candidate ladder
        for distillability-aware teacher selection)."""
        return sorted(
            int(name) for name in os.listdir(self.directory)
            if name.isdigit() and os.path.isfile(
                os.path.join(self.directory, name, _MANIFEST))
        )

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_template: Any,
                step: Optional[int] = None) -> Tuple[Any, int]:
        """Restore into the structure of `state_template`.

        Template leaves that carry a sharding (jax.Arrays, or
        ShapeDtypeStructs given one) come back as jax.Arrays with that
        sharding; the others (e.g. `jax.eval_shape` structs) as host
        numpy arrays."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        step_dir = self._step_dir(step)
        with open(os.path.join(step_dir, _MANIFEST)) as f:
            leaves = json.load(f)["leaves"]
        flat, treedef = jax.tree_util.tree_flatten_with_path(state_template)
        want = [jax.tree_util.keystr(path) for path, _ in flat]
        have = [leaf["path"] for leaf in leaves]
        if want != have:
            missing = sorted(set(want) - set(have))
            extra = sorted(set(have) - set(want))
            raise ValueError(
                f"checkpoint {step_dir} does not match the template tree: "
                f"missing {missing[:5]}, unexpected {extra[:5]}"
            )
        out = []
        with np.load(os.path.join(step_dir, _ARRAYS),
                     allow_pickle=False) as data:
            for i, ((_, tmpl), meta) in enumerate(zip(flat, leaves)):
                shape = tuple(meta["shape"])
                dtype = jax.numpy.dtype(meta["dtype"])
                if (shape != tuple(tmpl.shape)
                        or dtype != np.dtype(tmpl.dtype)):
                    raise ValueError(
                        f"checkpoint leaf {meta['path']} is {shape} "
                        f"{dtype}, template wants {tuple(tmpl.shape)} "
                        f"{np.dtype(tmpl.dtype)}"
                    )
                host = data[f"a{i}"].view(dtype).reshape(shape)
                sharding = getattr(tmpl, "sharding", None)
                if sharding is None:
                    out.append(host)
                else:
                    out.append(jax.make_array_from_callback(
                        shape, sharding, lambda idx, h=host: h[idx]))
        return treedef.unflatten(out), step
