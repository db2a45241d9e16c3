"""The plain-function initializers reproduce, leaf for leaf, the parameter
trees of the flax.linen modules the models were first written with: the
layout (names, shapes) and the values a seed draws.  The fingerprints in
tests/goldens/init_fingerprints.json were recorded from those modules,
with the same seeds the golden fixtures use (teacher PRNGKey(0), student
PRNGKey(1))."""

import hashlib
import json
import os

import jax
import numpy as np
import pytest

from pwn_vocoder.config import get_config, override
from pwn_vocoder.models.student import init_student
from pwn_vocoder.models.teacher import init_teacher

FINGERPRINTS = os.path.join(os.path.dirname(__file__), "goldens",
                            "init_fingerprints.json")
with open(FINGERPRINTS) as _f:
    RECORDED = json.load(_f)


def fingerprint(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    layout = "|".join(f"{jax.tree_util.keystr(k)}:{tuple(v.shape)}"
                      for k, v in flat)
    vals = [np.asarray(v, np.float64) for _, v in flat]
    return {
        "layout_sha1": hashlib.sha1(layout.encode()).hexdigest(),
        "n_leaves": len(flat),
        "n_params": int(sum(v.size for v in vals)),
        "sum": float(sum(v.sum() for v in vals)),
        "abs_sum": float(sum(np.abs(v).sum() for v in vals)),
        "weighted": float(sum((i + 1) * v.sum()
                              for i, v in enumerate(vals))),
    }


@pytest.mark.parametrize("entry", sorted(RECORDED))
def test_init_reproduces_recorded_tree(entry):
    preset, model = entry.split("/")
    if preset.endswith("+weight_norm"):
        cfg = override(get_config(preset.split("+")[0]),
                       "teacher.upsample_weight_norm", True)
    else:
        cfg = get_config(preset)
    if model == "teacher":
        variables = init_teacher(cfg, jax.random.PRNGKey(0))[1]
    else:
        variables = init_student(cfg, jax.random.PRNGKey(1))[1]
    got, want = fingerprint(variables), RECORDED[entry]
    for k in ("layout_sha1", "n_leaves", "n_params"):
        assert got[k] == want[k], k
    for k in ("sum", "abs_sum", "weighted"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
