"""The port restores a checkpoint the JAX reference wrote.

``repro.checkpoint.CheckpointManager`` saves a trainer's payload (the
(params, optimizer state) pair and the pipeline's state) with binary8
packing; ``repro_torch.checkpoint.CheckpointManager`` reads it back
through its restricted unpickler, without importing jax or the reference
(checked in a subprocess).  Tolerance: none -- the structure is the
reference's and every leaf is bitwise the saved one; the trainer's state
converted by ``repro_torch.convert`` equals the reference's in-memory
state converted the same way.  A tampered shard falls back to the older
step exactly as the port's own format does, and a pickle naming any other
global is refused.
"""
import dataclasses
import hashlib
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.configs import get_config as jget, reduced as jreduced
from repro.models import build_model as jbuild
from repro.optim.adam import QAdamState as JQAdamState
from repro.optim.sgd import QSGDState as JQSGDState
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import manager as tmgr
from repro_torch.health import inject as tinj
from repro_torch.optim.adam import QAdamState
from repro_torch.optim.sgd import QSGDState

SRC = Path(__file__).resolve().parents[1] / "src"


def _binary8(x: np.ndarray) -> np.ndarray:
    """Values snapped onto the binary8 grid (so the writer packs them)."""
    return tmgr.unpack_np(tmgr.pack_np(x.astype(np.float32), "binary8"),
                          "binary8")


def _params(seed: int):
    """Reduced tinyllama's parameter tree, values drawn by numpy on the
    binary8 grid (the reference's init folds a salted ``hash()``)."""
    jcfg = dataclasses.replace(jreduced(jget("tinyllama-1.1b")),
                               gemm_policy="binary8-paper")
    shapes = jax.eval_shape(jbuild(jcfg).init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: _binary8(rng.standard_normal(s.shape) * 0.1), shapes)


def _state(opt: str, params, seed: int):
    rng = np.random.default_rng(seed)
    n = sum(x.size for x in jax.tree_util.tree_leaves(params))
    key = np.asarray([0, 7], np.uint32)
    if opt == "adam-fused":       # flat bf16-sr moment codes
        return JQAdamState(step=np.int32(3),
                           m=rng.integers(0, 2 ** 16, n).astype(np.uint16),
                           v=rng.integers(0, 2 ** 16, n).astype(np.uint16),
                           key=key)

    def tree(scale):
        return jax.tree.map(
            lambda x: (rng.standard_normal(x.shape) * scale)
            .astype(np.float32), params)
    if opt == "adam-jnp-kahan":   # per-leaf moments and Kahan carries
        return JQAdamState(step=np.int32(5), m=tree(0.01),
                           v=jax.tree.map(np.abs, tree(1e-4)), key=key,
                           cm=tree(1e-6), cv=tree(1e-9))
    return JQSGDState(step=np.int32(2), momentum=tree(0.1), key=key)


def _payload(opt: str, seed: int):
    params = _params(seed)
    return {"state": (params, _state(opt, params, seed + 1)),
            "pipeline": {"step": 4 * seed}}


def _leaves_equal(ref, got) -> bool:
    ref, got = np.asarray(ref), np.asarray(got)
    return ref.dtype == got.dtype and ref.shape == got.shape \
        and ref.tobytes() == got.tobytes()


def _ref_dir(tmp_path, opt):
    d = str(tmp_path / "ref")
    mgr = JManager(d, fmt="binary8", shards=3)
    payloads = {}
    for step in (1, 2):
        payloads[step] = _payload(opt, step)
        mgr.save(step, payloads[step], blocking=True)
    return d, payloads


@pytest.mark.parametrize("opt", ["adam-fused", "adam-jnp-kahan", "sgd"])
def test_port_restores_reference_checkpoint(tmp_path, opt):
    d, payloads = _ref_dir(tmp_path, opt)
    meta = json.loads((Path(d) / "step_2" / "meta.json").read_text())
    assert meta["format"] == 2
    assert "binary8" in [leaf["packed"] for leaf in meta["leaves"]]
    mgr = CheckpointManager(d)
    assert mgr.verify(2) and mgr.latest_step() == 2
    step, tree, extra = mgr.restore()
    assert step == 2 and extra == {}
    want = payloads[2]
    params, state = tree["state"]
    assert isinstance(tree["state"], tuple) and list(tree) == ["pipeline",
                                                               "state"]
    assert type(state) is (QSGDState if opt == "sgd" else QAdamState)
    # the structure is the reference's, the NamedTuple class aside
    assert jax.tree_util.tree_structure(
        (params, tuple(state), tree["pipeline"])) \
        == jax.tree_util.tree_structure(
            (want["state"][0], tuple(want["state"][1]), want["pipeline"]))
    ref_leaves = jax.tree_util.tree_leaves(want)
    got_leaves = [x for x in tmgr.flatten(tree)[0] if x is not None]
    assert len(ref_leaves) == len(got_leaves)
    assert all(_leaves_equal(r, g) for r, g in zip(ref_leaves, got_leaves))
    assert int(tree["pipeline"]["step"]) == 8
    # the trainer's state through the port's converters, as from memory
    got_p = convert.master_params_from_jax(params)
    ref_p = convert.master_params_from_jax(want["state"][0])
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(tmgr.flatten(got_p)[0],
                               tmgr.flatten(ref_p)[0]))
    if opt != "sgd":
        got_s = convert.qadam_state_from_jax(state)
        ref_s = convert.qadam_state_from_jax(want["state"][1])
        assert got_s.step == ref_s.step and got_s.key == ref_s.key == (0, 7)
        for name in ("m", "v", "cm", "cv"):
            a = tmgr.flatten(getattr(got_s, name))[0]
            b = tmgr.flatten(getattr(ref_s, name))[0]
            assert len(a) == len(b)
            assert all(torch.equal(x, y) for x, y in zip(a, b)), name


@pytest.mark.parametrize("mode", ["garble", "truncate"])
def test_tampered_reference_shard_falls_back(tmp_path, mode):
    d, payloads = _ref_dir(tmp_path, "adam-fused")
    assert tinj.corrupt_checkpoint(d, mode=mode) == 2
    mgr = CheckpointManager(d)
    assert not mgr.verify(2) and mgr.verify(1)
    step, tree, _ = mgr.restore()
    assert step == 1
    assert all(_leaves_equal(r, g) for r, g in zip(
        jax.tree_util.tree_leaves(payloads[1]),
        [x for x in tmgr.flatten(tree)[0] if x is not None]))
    with pytest.raises(IOError):
        mgr.restore(step=2)


def test_reference_treedef_naming_another_global_is_refused(tmp_path):
    d = str(tmp_path / "ref")
    JManager(d).save(1, {"x": np.arange(3.0)}, blocking=True)
    step_dir = Path(d) / "step_1"
    (step_dir / "treedef.pkl").write_bytes(pickle.dumps(
        (jax.tree_util.tree_structure({"x": 0}), os.system)))
    meta = json.loads((step_dir / "meta.json").read_text())
    meta["sha256"]["treedef.pkl"] = hashlib.sha256(
        (step_dir / "treedef.pkl").read_bytes()).hexdigest()
    (step_dir / "meta.json").write_text(json.dumps(meta))
    mgr = CheckpointManager(d)
    assert mgr.verify(1)
    with pytest.raises(pickle.UnpicklingError, match="system"):
        mgr.restore()


def test_reference_checkpoint_restores_without_jax(tmp_path):
    """The port reads the directory in a process that never imports jax
    or the reference."""
    d, payloads = _ref_dir(tmp_path, "adam-jnp-kahan")
    want = payloads[2]["state"][1]
    code = (
        "import sys\n"
        "from repro_torch.checkpoint import CheckpointManager\n"
        "from repro_torch import convert\n"
        f"step, tree, _ = CheckpointManager({d!r}).restore()\n"
        "s = convert.qadam_state_from_jax(tree['state'][1])\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro')\n"
        "print(step, s.step, type(tree['state'][1]).__module__, bad)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["2", str(int(want.step)),
                                  "repro_torch.optim.adam", "[]"], out.stdout
