"""Checkpoints across the two packages: the port restores a checkpoint
the JAX reference wrote, the reference restores one the port wrote.

``repro.checkpoint.CheckpointManager`` saves a trainer's payload (the
(params, optimizer state) pair and the pipeline's state) with binary8
packing; ``repro_torch.checkpoint.CheckpointManager`` reads it back
through its restricted unpickler, without importing jax or the reference
(checked in a subprocess).  The other way, the port's trainer runs two
reduced steps (QSGD, and QAdam over packed bf16-sr moment codes) and
checkpoints them; the reference's manager verifies and restores the
directory, whose pickled treedef the port wrote without jax.  A
checkpoint that an earlier version of the port wrote, with its structure
as JSON (``tests/data/port_ckpt_treedef_json``, made by that version from
``_legacy_tree``), still restores in the port.  Tolerance: none -- the
structure is the reading package's own and every leaf is bitwise the
saved one; the trainer's state converted by ``repro_torch.convert``
equals the reference's in-memory state converted the same way.  A
tampered shard falls back to the older step exactly as the port's own
format does, a pickle naming any other global is refused, and the port
refuses to save a node the reference cannot read.
"""
import dataclasses
import hashlib
import json
import os
import pickle
import shutil
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
from repro_torch.launch import train as ttrain
from repro_torch.optim.adam import QAdamState
from repro_torch.optim.sgd import QSGDState

SRC = Path(__file__).resolve().parents[1] / "src"
LEGACY = Path(__file__).resolve().parent / "data" / "port_ckpt_treedef_json"


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


# ------------------------------------------------- the port's checkpoints --
def _numpy(tree):
    """A port tree's tensors as numpy arrays, its optimizer state as the
    reference's class holding the step and key as the reference does."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, QSGDState):
        return JQSGDState(step=np.int32(tree.step),
                          momentum=_numpy(tree.momentum),
                          key=np.asarray(tree.key, np.uint32))
    if isinstance(tree, QAdamState):
        return JQAdamState(step=np.int32(tree.step), m=_numpy(tree.m),
                           v=_numpy(tree.v),
                           key=np.asarray(tree.key, np.uint32),
                           cm=_numpy(tree.cm), cv=_numpy(tree.cv))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy(v) for v in tree)
    return tree.numpy() if torch.is_tensor(tree) else np.asarray(tree)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_reference_restores_port_checkpoint(tmp_path, opt):
    """Two reduced train steps of the port's trainer (the fused update,
    binary8-packed checkpoints), restored by the reference's manager:
    its own structure, the port's leaves bitwise."""
    from repro.launch import train as jtrain
    jparams = _params(11)
    kw = dict(reduced=True, batch=2, seq=8, gemm_policy="binary8-paper",
              rounding_kind="signed_sr_eps", fmt="binary8", eps=0.1,
              update_path="fused", ckpt_fmt="binary8", device="cpu",
              verbose=False)
    if opt == "adam":
        kw.update(optimizer="adam", moments_spec="bf16-sr", lr=4e-4)
    d = str(tmp_path / "port")
    out = ttrain.run("tinyllama-1.1b", steps=2, ckpt_dir=d,
                     params=convert.master_params_from_jax(jparams), **kw)
    assert out["final_step"] == 2 and out["opt_state"].step == 2
    meta = json.loads((Path(d) / "step_2" / "meta.json").read_text())
    assert sorted(meta["sha256"]) == sorted(
        p.name for p in (Path(d) / "step_2").iterdir()
        if p.name != "meta.json")
    assert "treedef.pkl" in meta["sha256"] and "binary8" in [
        leaf["packed"] for leaf in meta["leaves"]]
    mgr = JManager(d)
    assert mgr.verify(2)
    step, tree, _ = mgr.restore()
    assert step == 2
    # the reference's own payload for this trainer
    jopt = jtrain.build_optimizer(
        "adam" if opt == "adam" else "sgd", lr=kw.get("lr", 0.05),
        momentum=0.9,
        cfg=jtrain.rounding_config("signed_sr_eps", "binary8", 0.1),
        update_path="fused",
        moments_spec="bf16-sr" if opt == "adam" else None)
    own = {"state": (jparams, jopt.init(jparams, jax.random.PRNGKey(1))),
           "pipeline": {"step": 2}}
    assert jax.tree_util.tree_structure(tree) \
        == jax.tree_util.tree_structure(own)
    assert type(tree["state"][1]) is (JQAdamState if opt == "adam"
                                      else JQSGDState)
    want = _numpy({"state": (out["params"], out["opt_state"]),
                   "pipeline": {"step": 2}})
    ref_leaves = jax.tree_util.tree_leaves(tree)
    want_leaves = jax.tree_util.tree_leaves(want)
    assert len(ref_leaves) == len(want_leaves) \
        == len(jax.tree_util.tree_leaves(own))
    assert all(_leaves_equal(w, r) for w, r in zip(want_leaves, ref_leaves))
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(own)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
    if opt == "adam":
        assert tree["state"][1].m.dtype == np.uint16
    # and the port reads its own checkpoint back as it held it
    _, back, _ = CheckpointManager(d).restore()
    assert back["state"][1].step == 2 and back["state"][1].key == (0, 1)
    got = tmgr.flatten(back["state"])[0]
    held = tmgr.flatten((out["params"], out["opt_state"]))[0]
    assert len(got) == len(held)
    assert all(_leaves_equal(_numpy(a), _numpy(b)) for a, b in zip(got,
                                                                   held))


@pytest.mark.parametrize("case", ["mixed", "int-keys"])
def test_port_treedef_unpickles_as_jax_treedef(case):
    """The port's opcode writer gives the bytes that unpickle, in a jax
    process, to the treedef jax makes of the same tree."""
    params = {"w": torch.zeros(3), "b": [torch.zeros(2), None]}
    if case == "mixed":
        tree = {"state": (params, QSGDState(step=4, momentum=(), key=(1, 2))),
                "l": [1.5, (True, None, ())], "n": None, "e": {}}
        want = {"state": ({"w": 0, "b": [0, None]},
                          JQSGDState(step=0, momentum=(), key=0)),
                "l": [0, (0, None, ())], "n": None, "e": {}}
    else:
        tree = {3: torch.zeros(1), -1: [None], 70000: QAdamState(
            step=1, m=params, v=params, key=(5, 6), cm=(), cv=())}
        want = {3: 0, -1: [None], 70000: JQAdamState(
            step=0, m={"w": 0, "b": [0, None]}, v={"w": 0, "b": [0, None]},
            key=0, cm=(), cv=())}
    leaves, records = tmgr.ref_flatten(tree)
    td = pickle.loads(tmgr.treedef_pickle(records))
    assert td == jax.tree_util.tree_structure(want)
    assert td.num_leaves == len(leaves)


@pytest.mark.parametrize("bad", ["namedtuple", "keys"])
def test_port_refuses_what_the_reference_cannot_read(tmp_path, bad):
    """A node the reference's treedef cannot hold is refused when saving,
    naming it, and nothing is written."""
    from collections import namedtuple
    if bad == "namedtuple":
        other = namedtuple("Other", "a b")(torch.zeros(1), 2)
        tree, name = {"state": [other]}, r"tree\['state'\]\[0\].*Other"
    else:
        tree, name = {"x": {"a": 1, 2: 3}}, r"tree\['x'\].*keys"
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(TypeError, match=name):
        mgr.save(1, tree, blocking=True)
    assert mgr.all_steps() == []


def _legacy_tree():
    """The tree of ``LEGACY``, which the port wrote with ``fmt="binary8"``
    and two shards before it wrote ``treedef.pkl``."""
    rng = np.random.default_rng(23)
    codes = rng.integers(0, 2 ** 16, (2, 40)).astype(np.uint16)
    return {
        "state": (
            {"w": torch.from_numpy(_binary8(rng.standard_normal((4, 8)))),
             "b": torch.from_numpy(rng.standard_normal(8)
                                   .astype(np.float32) + 1e-5)},
            QAdamState(step=3, m=torch.from_numpy(codes[0]),
                       v=torch.from_numpy(codes[1]), key=(7, 2 ** 32 - 1))),
        "pipeline": {"step": 12},
        "extras": [torch.from_numpy(rng.standard_normal(5)
                                    .astype(np.float32)).bfloat16(),
                   None, np.arange(3, dtype=np.float32) / 4, 0.5, True],
    }


def test_port_restores_its_json_treedef_checkpoint(tmp_path):
    """A checkpoint with ``treedef.json`` (the port's earlier format)
    verifies and restores, every leaf as the port held it."""
    d = tmp_path / "legacy"
    shutil.copytree(LEGACY, d)
    assert sorted(p.name for p in (d / "step_3").iterdir()) == [
        "leaves.1.npz", "leaves.npz", "meta.json", "treedef.json"]
    mgr = CheckpointManager(str(d))
    assert mgr.verify(3)
    step, tree, extra = mgr.restore()
    assert step == 3 and extra == {"written_by": "port, JSON treedef"}
    want = _legacy_tree()
    assert type(tree["state"][1]) is QAdamState
    assert tree["state"][1].key == (7, 2 ** 32 - 1)
    assert tree["state"][1].step == 3 and tree["pipeline"] == {"step": 12}
    assert tree["extras"][1] is None and tree["extras"][3:] == [0.5, True]
    got, held = tmgr.flatten(tree)[0], tmgr.flatten(want)[0]
    assert len(got) == len(held)
    for a, b in zip(got, held):
        assert type(a) is type(b)
        if torch.is_tensor(a):
            assert a.dtype == b.dtype
            if a.dtype == torch.bfloat16:
                a, b = a.view(torch.int16), b.view(torch.int16)
            assert _leaves_equal(a.numpy(), b.numpy())
        elif isinstance(a, np.ndarray):
            assert _leaves_equal(a, b)
        else:
            assert a == b
