"""The port's checkpoint store (repro_torch.checkpoint) against the
reference's contract: crash-atomic writes, newest-first fallback past a
torn checkpoint, keep-last-K GC with crash-safe deletion order, and the
reference's npz layout — a checkpoint written by either package loads
bitwise in the other (leaves in ``jax.tree.leaves`` order: ``opt`` before
``params``, ``AdamState`` as step, mu, nu; bfloat16 as uint16 views).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.checkpoint as jax_ckpt
import repro.graph as jax_graph
import repro.models.gnn.models as jax_models
import repro.optim as jax_optim
import repro.optim.optimizers as jax_optimizers
import repro.train as jax_train
import repro_torch.graph as torch_graph
import repro_torch.models.gnn.models as torch_models
import repro_torch.optim as torch_optim
import repro_torch.train as torch_train
from repro_torch.checkpoint import (CheckpointCorrupt, latest_step,
                                    load_checkpoint, save_checkpoint,
                                    tree_leaves, valid_steps)
from repro_torch.checkpoint import store as ckstore
from repro_torch.checkpoint.store import gc_checkpoints
from repro_torch.graph.partition import community_partition, shard_features

ROOT = Path(__file__).resolve().parents[1]
SHARDS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes on a few cores: one
    intra-op thread per worker keeps PyTorch's thread pools from
    oversubscribing them (the Trainer's planner pool still runs)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((4, 3), generator=g),
            "b": torch.zeros(3)}


def _full(v):
    return {"w": torch.full((4, 4), float(v))}


# ---------------------------------------------------------------------------
# Round trip, pruning, guards (the reference's substrate cases)
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": [torch.ones(4, dtype=torch.bfloat16),
                  torch.zeros((), dtype=torch.int32)]}
    save_checkpoint(tmp_path, 7, tree, extra={"lr": 0.1})
    like = {"a": torch.zeros(2, 3),
            "b": [torch.zeros(4, dtype=torch.bfloat16),
                  torch.full((), 5, dtype=torch.int32)]}
    restored, step, extra = load_checkpoint(tmp_path, like)
    assert step == 7 and extra == {"lr": 0.1}
    for a, b in zip(tree_leaves(tree), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # tensor leaves are filled in place: the template's own tensors return
    assert restored["a"] is like["a"] and restored["b"][1] is like["b"][1]


def test_checkpoint_prunes_and_tracks_latest(tmp_path):
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(tmp_path, s, {"x": torch.zeros(2)}, keep=2)
    assert latest_step(tmp_path) == 5
    kept = sorted(p.name for p in tmp_path.glob("step-*.npz"))
    assert len(kept) == 2 and kept[-1] == "step-00000005.npz"


@pytest.mark.parametrize("template", [
    {"a": torch.zeros(2), "b": torch.zeros(3), "c": torch.zeros(2)},
    {"w": torch.zeros((4, 3))},
])
def test_checkpoint_leaf_count_guard(tmp_path, template):
    # the Trainer's bare-params fallback depends on this contract
    save_checkpoint(tmp_path, 1, _tree())
    with pytest.raises(ValueError, match="leaf count"):
        load_checkpoint(tmp_path, template)


def test_checkpoint_leaf_shape_guard_copies_nothing(tmp_path):
    save_checkpoint(tmp_path, 1, _tree())
    like = {"w": torch.zeros((3, 4)), "b": torch.full((3,), 9.0)}
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(tmp_path, like)
    assert torch.equal(like["b"], torch.full((3,), 9.0))


# ---------------------------------------------------------------------------
# Crash-atomic fallback (the reference's resilience cases)
# ---------------------------------------------------------------------------

def test_checkpoint_truncated_newest_falls_back(tmp_path):
    t = _tree()
    save_checkpoint(tmp_path, 1, t)
    save_checkpoint(tmp_path, 2, {k: v + 1 for k, v in t.items()})
    npz = tmp_path / "step-00000002.npz"
    npz.write_bytes(npz.read_bytes()[:40])             # torn write
    like = {"w": torch.zeros((4, 3)), "b": torch.zeros(3)}
    with pytest.warns(RuntimeWarning, match="corrupt"):
        tree, step, _ = load_checkpoint(tmp_path, like)
    assert step == 1
    assert torch.equal(tree["w"], t["w"])


def test_checkpoint_explicit_step_fails_loudly(tmp_path):
    t = _tree()
    save_checkpoint(tmp_path, 5, t)
    (tmp_path / "step-00000005.json").write_text("{ not json")
    with pytest.raises(CheckpointCorrupt):
        load_checkpoint(tmp_path, t, step=5)


def test_checkpoint_missing_manifest_is_incomplete(tmp_path):
    t = _tree()
    save_checkpoint(tmp_path, 1, t)
    save_checkpoint(tmp_path, 2, t)
    (tmp_path / "step-00000002.json").unlink()         # crash between files
    assert valid_steps(tmp_path) == [1]
    with pytest.warns(RuntimeWarning, match="incomplete"):
        _, step, _ = load_checkpoint(tmp_path, t)
    assert step == 1


def test_checkpoint_leaves_no_temp_files(tmp_path):
    save_checkpoint(tmp_path, 3, _tree())
    assert not list(tmp_path.glob("*.tmp"))


# ---------------------------------------------------------------------------
# Keep-last-K GC with crash-safe ordering (the reference's membership cases)
# ---------------------------------------------------------------------------

def test_gc_keeps_last_k_and_pins_latest(tmp_path):
    for s in range(1, 6):
        save_checkpoint(tmp_path, s, _full(s), keep=0)   # keep=0: no GC
    assert valid_steps(tmp_path) == [1, 2, 3, 4, 5]
    assert gc_checkpoints(tmp_path, keep=2) == [1, 2, 3]
    assert valid_steps(tmp_path) == [4, 5]
    # latest is pinned even when the keep window would drop it
    (tmp_path / "latest").write_text("4")
    save_checkpoint(tmp_path, 6, _full(6), keep=0)
    (tmp_path / "latest").write_text("4")
    deleted = gc_checkpoints(tmp_path, keep=1)
    assert 4 not in deleted
    assert latest_step(tmp_path) == 4
    assert set(valid_steps(tmp_path)) == {4, 6}


def test_gc_sweeps_npz_orphans(tmp_path):
    for s in (1, 2, 3):
        save_checkpoint(tmp_path, s, _full(s), keep=0)
    # a crash that deleted the manifest but not the npz
    (tmp_path / "step-00000001.json").unlink()
    assert valid_steps(tmp_path) == [2, 3]     # the orphan is invisible
    assert gc_checkpoints(tmp_path, keep=2) == [1]   # ...and swept
    assert not (tmp_path / "step-00000001.npz").exists()


def test_save_checkpoint_prunes_via_gc(tmp_path):
    for s in range(1, 7):
        save_checkpoint(tmp_path, s, _full(s), keep=3)
    assert valid_steps(tmp_path) == [4, 5, 6]
    assert not list(tmp_path.glob("*.tmp"))


def _run_py(code: str, expect_signal=None) -> dict:
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)],
        capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"),
        timeout=600)
    if expect_signal is not None:
        assert out.returncode == -expect_signal, out.stderr[-2000:]
        return {}
    assert out.returncode == 0, out.stderr[-3000:]
    for line in out.stdout.splitlines():
        if line.startswith("RESULT:"):
            return json.loads(line[len("RESULT:"):])
    raise AssertionError(f"no RESULT line in:\n{out.stdout}\n{out.stderr}")


def test_sigkill_during_gc_leaves_recoverable_state(tmp_path):
    """SIGKILL between a checkpoint's manifest and npz deletions: the
    newest durable checkpoint still loads, and the next sweep removes the
    stranded npz orphan."""
    ck = str(tmp_path / "ck")
    _run_py(f"""
    import os, signal
    import torch
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.checkpoint import store as ckstore
    d = {ck!r}
    for s in range(1, 5):
        save_checkpoint(d, s, {{"w": torch.full((4, 4), float(s))}},
                        keep=0)
    ckstore._GC_FAULT_HOOK = \\
        lambda step: os.kill(os.getpid(), signal.SIGKILL)
    ckstore.gc_checkpoints(d, keep=2)      # killed mid-delete of step 1
    """, expect_signal=9)
    res = _run_py(f"""
    import json
    import torch
    from repro_torch.checkpoint import load_checkpoint, valid_steps
    from repro_torch.checkpoint.store import gc_checkpoints
    d = {ck!r}
    tree, step, _ = load_checkpoint(d, {{"w": torch.zeros((4, 4))}})
    deleted = gc_checkpoints(d, keep=2)
    print("RESULT:" + json.dumps({{
        "step": step, "w": float(tree["w"][0, 0]),
        "valid": valid_steps(d), "deleted": deleted}}))
    """)
    assert res["step"] == 4 and res["w"] == 4.0
    assert res["valid"] == [3, 4]
    assert 1 in res["deleted"] or 2 in res["deleted"]   # orphan swept
    assert ckstore._GC_FAULT_HOOK is None


# ---------------------------------------------------------------------------
# Leaf order and cross-package loads
# ---------------------------------------------------------------------------

def _nested():
    rng = np.random.default_rng(4)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"z": [f(2), {"y": f(3), "a": f(1)}], "b": f(2, 2),
            "m": jax_optimizers.AdamState(step=np.int32(3), mu=[f(2), f(1)],
                                          nu=[f(2), f(1)]),
            "n": None}


def test_tree_leaves_follow_jax_order():
    tree = _nested()
    mine = tree_leaves(tree)
    want = jax.tree.leaves(tree)
    assert len(mine) == len(want) == 9
    for a, b in zip(mine, want):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture(scope="module")
def world():
    ds_j = jax_graph.make_dataset("products", scale=0.03, seed=0)
    ds_t = torch_graph.make_dataset("products", scale=0.03, seed=0)
    part = community_partition(ds_t.communities, SHARDS)
    table, owner, local_idx = shard_features(ds_t.features, part, SHARDS)
    kw = dict(model="sage", num_layers=2, hidden_dim=32,
              feature_dim=ds_t.feature_dim, num_classes=ds_t.num_classes,
              fanout=4)
    return dict(ds_j=ds_j, ds_t=ds_t, part=part, table=table, owner=owner,
                local_idx=local_idx, cfg_j=jax_models.GNNConfig(**kw),
                cfg_t=torch_models.GNNConfig(**kw),
                tree=jax_models.init_gnn(jax.random.PRNGKey(0),
                                         jax_models.GNNConfig(**kw)))


def _common(w, ds):
    return dict(graph=ds.graph, labels=ds.labels, part=w["part"],
                owner=w["owner"], local_idx=w["local_idx"],
                table=w["table"], train_vertices=ds.train_vertices(),
                merging=False)


def _jax_trainer(w, **kw):
    return jax_train.Trainer(**_common(w, w["ds_j"]), cfg=w["cfg_j"],
                             optimizer=jax_optim.adamw(3e-3,
                                                       weight_decay=1e-4),
                             params=w["tree"], resilience=False, **kw)


def _torch_trainer(w, **kw):
    return torch_train.Trainer(
        **_common(w, w["ds_t"]), cfg=w["cfg_t"],
        optimizer=torch_optim.adamw(3e-3, weight_decay=1e-4),
        params=torch_models.params_from_jax(w["tree"], device="cpu"),
        device="cpu", **kw)


def _assert_opt_equal(a, b):
    assert int(a.step) == int(b.step) and a.step.dtype == b.step.dtype
    for x, y in zip(a.mu + a.nu, b.mu + b.nu):
        assert torch.equal(x, y)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_trainer_checkpoint_loads_in_the_other_package(world, tmp_path,
                                                       writer):
    """A Trainer's {"params", "opt"} checkpoint, written by one package,
    loads bitwise in the other."""
    ck = str(tmp_path / "ck")
    if writer == "jax":
        tj = _jax_trainer(world, ckpt_dir=ck)
        tj.fit(epochs=1, iters_per_epoch=2, batch_per_model=8)
        like_t = _torch_trainer(world)       # a fresh port Trainer's state
        tree, step, extra = load_checkpoint(
            ck, {"params": like_t.params, "opt": like_t.opt_state})
        assert step == tj.global_step == 2 and extra["epoch"] == 0
        want_p = torch_models.params_from_jax(tj.params, device="cpu")
        for a, b in zip(tree["params"].leaves(), want_p.leaves()):
            assert torch.equal(a, b)
        _assert_opt_equal(tree["opt"], torch_models.opt_state_from_jax(
            tj.opt_state, device="cpu"))
    else:
        tt = _torch_trainer(world, ckpt_dir=ck)
        tt.fit(epochs=1, iters_per_epoch=2, batch_per_model=8)
        tj = _jax_trainer(world)             # a fresh JAX Trainer's state
        tree, step, extra = jax_ckpt.load_checkpoint(
            ck, {"params": tj.params, "opt": tj.opt_state})
        assert step == tt.global_step == 2 and extra["epoch"] == 0
        want = torch_models.params_to_tree(tt.params)
        for a, b in zip(jax.tree.leaves(tree["params"]),
                        jax.tree.leaves(want)):
            assert np.array_equal(np.asarray(a), b)
        assert int(tree["opt"].step) == int(tt.opt_state.step)
        assert np.asarray(tree["opt"].step).dtype == np.int32
        for a, b in zip(jax.tree.leaves((tree["opt"].mu, tree["opt"].nu)),
                        tt.opt_state.mu + tt.opt_state.nu):
            assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_bf16_leaves_cross_packages_bitwise(tmp_path, writer):
    bits = np.random.default_rng(1).integers(0, 1 << 15, (3, 5),
                                             dtype=np.uint16)
    bf_np = bits.view(ml_dtypes.bfloat16)
    bf_t = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    if writer == "jax":
        jax_ckpt.save_checkpoint(tmp_path, 1, {"w": jnp.asarray(bf_np)})
        tree, _, _ = load_checkpoint(
            tmp_path, {"w": torch.zeros((3, 5), dtype=torch.bfloat16)})
        assert tree["w"].dtype == torch.bfloat16
        assert torch.equal(tree["w"].view(torch.int16), bf_t.view(
            torch.int16))
    else:
        save_checkpoint(tmp_path, 1, {"w": bf_t})
        man = json.loads((tmp_path / "step-00000001.json").read_text())
        assert man["dtypes"] == ["bfloat16"]
        assert np.load(tmp_path / "step-00000001.npz")["leaf_0"].dtype \
            == np.uint16
        tree, _, _ = jax_ckpt.load_checkpoint(
            tmp_path, {"w": jnp.zeros((3, 5), jnp.bfloat16)})
        assert np.array_equal(np.asarray(tree["w"]).view(np.uint16), bits)


def test_bf16_roundtrip_without_ml_dtypes(tmp_path):
    """The port decodes bfloat16 with torch alone: a round trip works in
    a process where ml_dtypes cannot be imported."""
    res = _run_py(f"""
    import json, sys
    sys.modules["ml_dtypes"] = None        # any import of it now fails
    import torch
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    g = torch.Generator().manual_seed(0)
    w = torch.randn((4, 6), generator=g).to(torch.bfloat16)
    save_checkpoint({str(tmp_path)!r}, 3, {{"w": w, "s": torch.tensor(2)}})
    like = {{"w": torch.zeros((4, 6), dtype=torch.bfloat16),
             "s": torch.tensor(0)}}
    tree, step, _ = load_checkpoint({str(tmp_path)!r}, like)
    bare, _, _ = load_checkpoint({str(tmp_path)!r}, {{"w": 0, "s": 0}})
    print("RESULT:" + json.dumps({{
        "equal": bool(torch.equal(tree["w"], w)), "step": step,
        "bare_dtype": str(bare["w"].dtype),
        "bare_equal": bool(torch.equal(bare["w"], w))}}))
    """)
    assert res == {"equal": True, "step": 3, "bare_dtype": "torch.bfloat16",
                   "bare_equal": True}
