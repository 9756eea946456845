"""The port's TrainLoop, checkpoints, data pipeline and fault injector,
against the JAX reference where both compute the same thing (the packed
codes, the spec grammar, the fault schedule and the injector's choices,
the token batches) and on their own guarantees elsewhere (atomic, async,
verified checkpoints; restart, fallback and resume bit-exact).

Tolerances: none; every comparison is exact (codes and float32 values as
bit patterns).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jmgr
from repro.core.rounding import parse_spec as jparse
from repro.data import ShardedPipeline as JPipeline
from repro.data import make_token_pipeline as jtokens
from repro.health import inject as jinj
from repro.train import TrainLoop as JLoop, TrainLoopConfig as JConfig
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import manager as tmgr
from repro_torch.core.rounding import parse_spec
from repro_torch.data import ShardedPipeline, make_token_pipeline
from repro_torch.health import inject as tinj
from repro_torch.health.inject import FaultInjector
from repro_torch.kernels.tree_update import tree_leaves
from repro_torch.launch import train as ttrain
from repro_torch.optim.adam import QAdamState
from repro_torch.train import TrainLoop, TrainLoopConfig

GRIDS = ["bfloat16", "e4m3", "binary8", "binary16", "fxp8.4"]


def _bits(a):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _equal(a, b) -> bool:
    return np.array_equal(_bits(a), _bits(b))


# ------------------------------------------------------------ pack_np ------
@pytest.mark.parametrize("grid", GRIDS)
def test_pack_np_codes_match_reference(grid):
    """Codes and decoded values equal the reference's on grid values of
    every kind: normals, grid subnormals, float32 subnormals, ±0, ±xmax,
    ±inf and NaN."""
    rng = np.random.default_rng(3)
    vals = np.concatenate([
        rng.standard_normal(3000).astype(np.float32) * 4,
        rng.standard_normal(1000).astype(np.float32) * 1e-3,
        np.float32([0.0, -0.0, 1.0, -1.0, 1e30, -1e30, 1e-40, -1e-41]),
    ])
    on_grid = np.asarray(jparse(f"{grid}-rn")(jnp.asarray(vals)))
    on_grid = np.concatenate([on_grid, np.float32([np.inf, -np.inf,
                                                   np.nan])])
    ref = jmgr.pack_np(on_grid, grid)
    got = tmgr.pack_np(on_grid, grid)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert _equal(tmgr.unpack_np(got, grid), jmgr.unpack_np(ref, grid))
    # the torch codec the manager packs tensors with gives the same codes
    codes = tmgr.pack_checked(torch.from_numpy(on_grid[:-3].copy()), grid)
    assert np.array_equal(codes.numpy(), ref[:-3])


def test_resolve_ckpt_grid_grammar():
    for name in ("bf16-sr", "e4m3", "binary8", "fp32", "none", None,
                 "bfloat16-sr-r16", "fxp8.4"):
        assert tmgr.resolve_ckpt_grid(name) == jmgr.resolve_ckpt_grid(name)
    assert tmgr.resolve_ckpt_grid("bf16-sr") == "bfloat16"
    assert tmgr.resolve_ckpt_grid("e4m3") == "e4m3"
    assert tmgr.resolve_ckpt_grid("fp32") is None
    assert tmgr.resolve_ckpt_grid(None) is None
    with pytest.raises(Exception):
        tmgr.resolve_ckpt_grid("not-a-grid")
    with pytest.raises(ValueError):        # float32 does not fit 16 bits
        tmgr.resolve_ckpt_grid("float32")


# ---------------------------------------------------- checkpoint manager --
def _mixed_tree(grid):
    rng = np.random.default_rng(5)
    snap = parse_spec(f"{grid}-rn")
    return {
        "on_grid": snap(torch.from_numpy(
            rng.standard_normal(3000).astype(np.float32))),
        "off_grid": torch.from_numpy(                 # stays raw float32
            rng.standard_normal(100).astype(np.float32) + 1e-5),
        "codes16": torch.from_numpy(rng.integers(0, 2 ** 16, 64)
                                    .astype(np.uint16)),
        "codes8": torch.from_numpy(rng.integers(0, 2 ** 8, 64)
                                   .astype(np.uint8)),
        "host": np.asarray(snap(torch.ones(7) / 3).numpy()),
        "bf16": torch.randn(5, generator=torch.Generator().manual_seed(1))
        .bfloat16(),
        "opt": QAdamState(step=9, m=[torch.zeros(3), None], v=(),
                          key=(7, 2 ** 32 - 1)),
        "scale": 0.5,
    }


@pytest.mark.parametrize("grid", ["bfloat16", "e4m3"])
def test_packed_save_restore_bit_exact_mixed_tree(tmp_path, grid):
    tree = _mixed_tree(grid)
    mgr = CheckpointManager(str(tmp_path), fmt=f"{grid}-sr", shards=3)
    mgr.save(9, tree, blocking=True)
    assert mgr.verify(9)
    meta = json.loads((tmp_path / "step_9" / "meta.json").read_text())
    assert meta["format"] == 2
    packed = [leaf["packed"] for leaf in meta["leaves"]]
    assert packed.count(grid) == 3         # on_grid, host, opt.m[0]
    names = sorted(p.name for p in (tmp_path / "step_9").iterdir())
    assert names == ["leaves.1.npz", "leaves.2.npz", "leaves.npz",
                     "meta.json", "treedef.pkl"]
    assert set(meta["sha256"]) == set(names) - {"meta.json"}
    step, back, _ = mgr.restore()
    assert step == 9
    assert back["opt"] == QAdamState(step=9, m=[back["opt"].m[0], None],
                                     v=(), key=(7, 2 ** 32 - 1))
    assert isinstance(back["opt"], QAdamState) and back["scale"] == 0.5
    assert isinstance(back["host"], np.ndarray)
    for a, b in zip(tmgr.flatten(tree)[0], tmgr.flatten(back)[0]):
        if torch.is_tensor(a):
            assert b.dtype == a.dtype
            if a.dtype == torch.bfloat16:
                a, b = a.view(torch.int16), b.view(torch.int16)
        if a is None or isinstance(a, (int, float)):
            assert a == b
        else:
            assert _equal(a, b)


def test_async_save_snapshots_before_caller_mutates(tmp_path):
    x = torch.ones(50_000)
    h = np.ones(1000, np.float32)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": x, "h": h}, blocking=False)
    x.fill_(-1.0)
    h[:] = -1.0
    mgr.wait()
    _, back, _ = mgr.restore()
    assert torch.equal(back["x"], torch.ones(50_000))
    assert np.array_equal(back["h"], np.ones(1000, np.float32))


@pytest.mark.parametrize("blocking", [True, False])
def test_only_async_saves_snapshot(tmp_path, monkeypatch, blocking):
    """A blocking save writes the leaves as they are (a snapshot would only
    double the state on the card); an async save clones every leaf."""
    snaps = []
    real = tmgr._snap_leaf
    monkeypatch.setattr(tmgr, "_snap_leaf",
                        lambda x: snaps.append(x) or real(x))
    tree = {"x": torch.ones(100), "h": np.ones(10, np.float32), "n": 3}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree, blocking=blocking)
    mgr.wait()
    assert len(snaps) == (0 if blocking else 3)
    _, back, _ = mgr.restore()
    assert torch.equal(back["x"], tree["x"]) and back["n"] == 3


def test_gc_keeps_newest_and_no_partial_dirs(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        mgr.save(s, {"x": torch.full((8,), float(s))})
    assert mgr.latest_step() == 3 and mgr.all_steps() == [2, 3]

    def fail(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(tmgr.np, "savez", fail)
    mgr.save(4, {"x": torch.zeros(8)})
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    # a failed save leaves no visible step; restore takes the newest whole
    assert mgr.all_steps() == [2, 3]
    assert not (tmp_path / "step_4").exists()
    assert float(mgr.restore()[1]["x"][0]) == 3.0


def test_save_retries_transient_io_errors(tmp_path, monkeypatch):
    calls = {"n": 0}
    real = tmgr.np.savez

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError("transient")
        return real(*a, **k)
    monkeypatch.setattr(tmgr.np, "savez", flaky)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.arange(4.0)}, blocking=True)
    assert mgr.verify(1) and calls["n"] == 2


@pytest.mark.parametrize("mode", ["garble", "truncate"])
def test_restore_falls_back_past_corrupt_newest(tmp_path, mode):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, {"x": torch.arange(8.0)}, blocking=True)
    mgr.save(2, {"x": torch.arange(8.0) * 2}, blocking=True)
    assert tinj.corrupt_checkpoint(str(tmp_path), mode=mode) == 2
    assert not mgr.verify(2) and mgr.verify(1)
    step, back, _ = mgr.restore()
    assert step == 1 and torch.equal(back["x"], torch.arange(8.0))
    with pytest.raises(IOError):
        mgr.restore(step=2)


# ------------------------------------------------------ pipeline / data ---
def test_pipeline_matches_reference_and_checkpoints():
    ref = JPipeline(jtokens(vocab_size=500, seq_len=6, global_batch=2,
                            seed=3))
    pipe = ShardedPipeline(make_token_pipeline(500, 6, 2, seed=3),
                           device="cpu")
    for _ in range(3):
        r, g = ref.next(), pipe.next()
        assert np.array_equal(np.asarray(r["tokens"]), g["tokens"].numpy())
    assert pipe.state_dict() == {"step": 3} == ref.state_dict()
    want = pipe.peek(2)
    pipe.load_state_dict({"step": 1})
    pipe.start_prefetch()
    pipe.next_prefetched()
    got = pipe.next_prefetched()
    pipe.stop()
    assert pipe.step == 3 and torch.equal(got["tokens"], want["tokens"])


# ----------------------------------------------------------- injector -----
def test_parse_fault_schedule_matches_reference():
    for spec in ("nan@35,bitflip@20:leaf=1:bit=30,corrupt@60:mode=garble,"
                 "sigkill@50", "preempt@3,corrupt@4,preempt@5",
                 "inf@2:index=7, nan@2"):
        ref = jinj.parse_fault_schedule(spec)
        got = tinj.parse_fault_schedule(spec)
        assert [vars(e) for e in got] == [vars(e) for e in ref]
    for bad in ("meteor@3", "nan@3:planet=9", "nan3"):
        with pytest.raises(ValueError):
            tinj.parse_fault_schedule(bad)


def test_flip_bit_matches_reference():
    a = np.linspace(1.0, 2.0, 8).astype(np.float32)
    assert _equal(tinj.flip_bit(a, 3, 31), jinj.flip_bit(a, 3, 31))
    assert _equal(tinj.flip_bit(tinj.flip_bit(a, 11, 30), 11, 30), a)


def test_injector_choices_match_reference(tmp_path):
    """The same schedule and seed tamper with the same leaf, bit and
    element in both packages, on a state whose float leaves correspond one
    to one in flattening order (an int leaf in between)."""
    rng = np.random.default_rng(2)
    arrays = {"a": rng.standard_normal((5, 3)).astype(np.float32),
              "b": [rng.standard_normal(7).astype(np.float32),
                    np.arange(4, dtype=np.int32),
                    rng.standard_normal((2, 9)).astype(np.float32)]}
    sched = "bitflip@3,nan@7,inf@9,bitflip@11:leaf=1"

    class Holder:
        pass
    jl, tl = Holder(), Holder()
    jl.state = jax.tree.map(jnp.asarray, arrays)
    tl.state = jax.tree.map(lambda a: torch.from_numpy(a.copy()), arrays)
    for seed in (0, 5):
        jinjector = jinj.FaultInjector(sched, seed=seed)
        tinjector = FaultInjector(sched, seed=seed)
        jinjector.attach(jl)
        tinjector.attach(tl)
        for step in (3, 7, 9, 11):
            jinjector(step)
            tinjector(step)
        assert tinjector.log == jinjector.log
        for r, g in zip(jax.tree_util.tree_leaves(jl.state),
                        tmgr.flatten(tl.state)[0]):
            assert _equal(r, g)
    assert arrays["a"].dtype == np.float32         # inputs never written


# ---------------------------------------------------------------- loop ----
def _toy(ckpt_dir, total=20, every=5, max_restarts=3, window=None):
    pipe = ShardedPipeline(make_token_pipeline(50, 4, 2))
    w0 = torch.ones(4)

    def step_fn(state, batch):
        w, n = state
        tgt = batch["tokens"][0, :4].float() / 50.0
        g = w - tgt
        return (w - 0.1 * g, n + 1), {"loss": (g * g).sum()}
    cfg = TrainLoopConfig(total_steps=total, checkpoint_every=every,
                          checkpoint_dir=str(ckpt_dir), log_every=5,
                          max_restarts=max_restarts, restart_window=window)
    return step_fn, pipe, (w0, 0), cfg


def _clean(tmp_path, total=20):
    loop = TrainLoop(*_toy(tmp_path / "clean", total))
    out = loop.run()
    return loop.state, out


def test_loop_runs_and_checkpoints_like_reference(tmp_path):
    (w, n), out = _clean(tmp_path)
    assert n == 20 and out["final_step"] == 20 and out["restarts"] == 0
    assert [h["step"] for h in out["history"]] == [5, 10, 15, 20]
    assert [h["step"] for h in out["steps"]] == list(range(1, 21))
    assert CheckpointManager(str(tmp_path / "clean")).all_steps() == \
        [10, 15, 20]
    src = jtokens(vocab_size=50, seq_len=4, global_batch=2)

    def jstep(state, batch):
        w_, n_ = state
        g = w_ - batch["tokens"][0, :4].astype(jnp.float32) / 50.0
        return (w_ - 0.1 * g, n_ + 1), {"loss": jnp.sum(g * g)}
    jloop = JLoop(jstep, JPipeline(src), (jnp.ones(4), jnp.int32(0)),
                  JConfig(total_steps=20, checkpoint_every=5,
                          checkpoint_dir=str(tmp_path / "ref"),
                          log_every=5))
    jout = jloop.run()
    assert _equal(jloop.state[0], w)
    assert [h["loss"] for h in jout["history"]] == \
        [h["loss"] for h in out["history"]]


@pytest.mark.parametrize("sched,restarts", [
    ("nan@12", 1), ("bitflip@12:bit=30", 1), ("preempt@7", 1),
    ("corrupt@12:mode=garble,nan@13", 1), ("preempt@3,preempt@8", 2)])
def test_loop_survives_faults_bit_exact(tmp_path, sched, restarts):
    (w_clean, _), _ = _clean(tmp_path)
    inj = FaultInjector(sched, seed=0)
    loop = TrainLoop(*_toy(tmp_path / "ck"), fault_hook=inj)
    out = loop.run()
    assert out["final_step"] == 20 and out["restarts"] == restarts
    assert _equal(loop.state[0], w_clean) and loop.state[1] == 20
    assert [h["step"] for h in out["steps"]] == list(range(1, 21))
    if sched.startswith("corrupt"):
        assert inj.log[0] == {"step": 12, "kind": "corrupt",
                              "ckpt_step": 10, "mode": "garble"}


def test_checkpointless_restart_restores_initial_state(tmp_path):
    """A failure before the first checkpoint restarts from the initial
    state, which the steps did not write into."""
    step_fn, pipe, state, cfg = _toy(tmp_path / "ck")
    w0 = state[0].clone()
    poisoned = []

    def hook(step):
        if step == 3 and not poisoned:
            poisoned.append(step)
            raise RuntimeError("preempted before any checkpoint")
    loop = TrainLoop(step_fn, pipe, state, cfg, fault_hook=hook)
    assert loop._init_state[0] is state[0]
    out = loop.run()
    assert out["restarts"] == 1 and torch.equal(state[0], w0)
    (w_clean, _), _ = _clean(tmp_path)
    assert _equal(loop.state[0], w_clean)


def test_loop_gives_up_after_max_restarts(tmp_path):
    def always_fail(step):
        raise RuntimeError("permafail")
    loop = TrainLoop(*_toy(tmp_path / "ck", max_restarts=2, window=5),
                     fault_hook=always_fail)
    with pytest.raises(RuntimeError, match="restart budget exhausted"):
        loop.run()


def test_windowed_restart_budget(tmp_path):
    sched = "preempt@3,preempt@12,preempt@17"
    loop = TrainLoop(*_toy(tmp_path / "w", max_restarts=2, window=5),
                     fault_hook=FaultInjector(sched))
    assert loop.run()["restarts"] == 3
    loop = TrainLoop(*_toy(tmp_path / "l", max_restarts=2),
                     fault_hook=FaultInjector(sched))
    with pytest.raises(RuntimeError, match="within|this run"):
        loop.run()


def test_watchdog_is_not_ported():
    with pytest.raises(NotImplementedError, match="not ported yet"):
        TrainLoop(*_toy("/nonexistent/never-made"), watchdog=object())


def test_rerun_at_the_final_step_takes_no_step_and_says_so(tmp_path,
                                                          capsys):
    """A second CLI run into a directory that holds the run's last step
    resumes there, takes no step and says why."""
    args = ["--arch", "tinyllama-1.1b", "--reduced", "--steps", "1",
            "--batch", "1", "--seq", "8", "--fmt", "binary8",
            "--update-path", "fused", "--device", "cpu",
            "--ckpt-dir", str(tmp_path)]
    assert len(ttrain.main(args)["history"]) == 1
    capsys.readouterr()
    out = ttrain.main(args)
    assert out["history"] == [] and out["final_step"] == 1
    assert "already holds step 1 of this run: no step to take" in \
        capsys.readouterr().out


# ---------------------------------------------- QAdam trainer, resume ----
def test_qadam_trainer_resume_bit_exact(tmp_path):
    """``train.run`` with QAdam (packed bf16-sr moments through K5's twin)
    and binary8-packed checkpoints: 2 steps, then 4 in the same directory,
    equal 4 uninterrupted steps, parameters and moment codes bitwise."""
    kw = dict(reduced=True, batch=2, seq=8, gemm_policy="binary8-paper",
              rounding_kind="signed_sr_eps", fmt="binary8", eps=0.1,
              update_path="fused", optimizer="adam", moments_spec="bf16-sr",
              ckpt_fmt="binary8", device="cpu", verbose=False)
    full = ttrain.run("tinyllama-1.1b", steps=4,
                      ckpt_dir=str(tmp_path / "full"), **kw)
    half = ttrain.run("tinyllama-1.1b", steps=2,
                      ckpt_dir=str(tmp_path / "split"), **kw)
    rest = ttrain.run("tinyllama-1.1b", steps=4,
                      ckpt_dir=str(tmp_path / "split"), **kw)
    assert [h["step"] for h in half["history"]] == [1, 2]
    assert [h["step"] for h in rest["history"]] == [3, 4]
    assert [h["loss"] for h in half["history"] + rest["history"]] == \
        [h["loss"] for h in full["history"]]
    for a, b in zip(tree_leaves(full["params"]), tree_leaves(rest["params"])):
        assert _equal(a, b)
    for name in ("m", "v"):
        a, b = getattr(full["opt_state"], name), getattr(rest["opt_state"],
                                                         name)
        assert a.dtype == torch.uint16 and torch.equal(a, b)
    assert rest["opt_state"].step == 4
    meta = json.loads((tmp_path / "split" / "step_4" / "meta.json")
                      .read_text())
    packed = [leaf["packed"] for leaf in meta["leaves"]]
    assert "binary8" in packed                  # the rounded parameters
    # a fault drill: the second preemption falls back past the garbled
    # step-4 checkpoint to step 2, and the run still ends bit-exact
    drill = ttrain.run("tinyllama-1.1b", steps=8, checkpoint_every=2,
                       ckpt_dir=str(tmp_path / "drill"),
                       fault_schedule="preempt@3,corrupt@4,preempt@5", **kw)
    clean = ttrain.run("tinyllama-1.1b", steps=8,
                       ckpt_dir=str(tmp_path / "clean"), **kw)
    assert drill["restarts"] == 2
    assert drill["fault_log"][1] == {"step": 4, "kind": "corrupt",
                                     "ckpt_step": 4, "mode": "truncate"}
    assert [e["kind"] for e in drill["fault_log"]] == \
        ["preempt", "corrupt", "preempt"]
    assert [h["step"] for h in drill["history"]] == list(range(1, 9))
    for a, b in zip(tree_leaves(drill["params"]),
                    tree_leaves(clean["params"])):
        assert _equal(a, b)
    for name in ("m", "v"):
        assert torch.equal(getattr(drill["opt_state"], name),
                           getattr(clean["opt_state"], name))
    assert os.path.isdir(tmp_path / "drill" / "step_8")
