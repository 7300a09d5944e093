"""The port's sharding policy (``repro_torch.launch.sharding``) and the
model's sharding hints against the reference's.

The specs are computed on the CPU without a process group, leaf for leaf,
for all ten architectures at full size (``meta`` parameters on one side,
``jax.eval_shape`` on the other), both meshes, FSDP on and off: a port
spec is the reference's ``PartitionSpec`` with the leading ``None`` of a
leaf the reference stacks for its layer scan dropped. Then one spawn of 8
gloo ranks (``tests/_torch_sharding_ranks.py``, ``make_host_mesh(4, 2)``)
runs a sharded train step and the prefill logits of six families' smoke
models and of a variant whose 3 heads do not divide the 2 TP shards,
each held against the port's unsharded step within 1e-5 of each leaf's
largest |value| (float32 summation order only), and qwen2-moe-a2.7b's
against the reference's jitted unsharded step at rtol 1e-5.
"""
import json
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from jax.tree_util import DictKey, SequenceKey, tree_flatten_with_path

import repro.configs as jax_configs
import repro.data as jax_data
import repro.launch.sharding as jax_shd
import repro.launch.train as jax_train
import repro.models.transformer as jax_tf
import repro.optim as jax_optim
from repro_torch import configs
from repro_torch.launch import sharding as shd
from repro_torch.models.transformer import (init_decode_state, init_params,
                                            params_from_jax)
from repro_torch.models.transformer import common
from repro_torch.optim import tree_leaves

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.abspath(os.path.join(HERE, os.pardir, "src"))
TIMEOUT_S = 120
TOL = 1e-5
STACKED = ("layers", "enc_layers", "dec_layers", "groups")
MESHES = {False: ((("data", "model")), (16, 16)),
          True: ((("pod", "data", "model")), (2, 16, 16))}


def _jax_mesh(multi_pod: bool):
    """What the reference's spec functions read of a mesh: its axis names
    and sizes."""
    names, sizes = MESHES[multi_pod]
    return types.SimpleNamespace(axis_names=names,
                                 shape=dict(zip(names, sizes)))


def _mesh(multi_pod: bool):
    return shd.production_mesh_shape(multi_pod)


def _key(entry):
    if isinstance(entry, DictKey):
        return entry.key
    if isinstance(entry, SequenceKey):
        return entry.idx
    return getattr(entry, "name", str(entry))


def _ref_specs(tree) -> dict:
    """{path: spec tuple} of a reference spec tree (None where it has
    no spec)."""
    flat, _ = tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P) or x is None)
    return {tuple(_key(e) for e in path): (None if s is None else tuple(s))
            for path, s in flat}


def _port_specs(tree, path=()) -> dict:
    """{path: spec} of a port spec tree: dicts, lists and NamedTuples of
    spec tuples (or None)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_specs(v, path + (k,)))
        return out
    if hasattr(tree, "_fields"):
        out = {}
        for name, v in zip(tree._fields, tree):
            out.update(_port_specs(v, path + (name,)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_port_specs(v, path + (i,)))
        return out
    return {path: tree}


def _as_reference_path(path: tuple) -> tuple[tuple, bool]:
    """A port path in the reference's tree, and whether the reference
    stacks the leaf (the port's list index of a stacked subtree dropped;
    the hybrid's ``tail`` is a list in both)."""
    for i, k in enumerate(path[:-1]):
        if k in STACKED and isinstance(path[i + 1], int):
            return path[:i + 1] + path[i + 2:], True
    return path, False


def _expected(port: dict, ref: dict) -> dict:
    out = {}
    for path in port:
        rpath, stacked = _as_reference_path(path)
        want = ref[rpath]
        if stacked and want is not None:
            assert want[0] is None, (path, want)
            want = want[1:]
        out[path] = want
    return out


_PARAMS: dict = {}


def _params(arch: str):
    """(port meta parameters, reference abstract parameters) at full size."""
    if arch not in _PARAMS:
        cfg_j = jax_configs.get_config(arch)
        _PARAMS[arch] = (
            init_params(configs.get_config(arch), device="meta"),
            jax.eval_shape(lambda: jax_tf.init_params(jax.random.PRNGKey(0),
                                                      cfg_j)))
    return _PARAMS[arch]


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_pspecs_match_the_reference(arch, fsdp):
    port_p, ref_p = _params(arch)
    port = _port_specs(shd.param_pspecs(port_p, fsdp=fsdp))
    ref = _ref_specs(jax_shd.param_pspecs(ref_p, fsdp=fsdp))
    assert port == _expected(port, ref)
    assert len(port) == len(tree_leaves(port_p))
    if not fsdp:
        assert all("data" not in (s or ()) for s in port.values())


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_opt_pspecs_match_the_reference(arch):
    """The moments' specs, a flat list in the port's leaf order, equal
    the reference's spec of the leaf at each place; the step replicates."""
    from repro_torch.launch.train import pick_optimizer
    port_p, ref_p = _params(arch)
    cfg_t, cfg_j = configs.get_config(arch), jax_configs.get_config(arch)
    state = pick_optimizer(cfg_t).init(port_p)
    specs = shd.opt_pspecs(state, shd.param_pspecs(port_p))
    opt_j = jax_train.pick_optimizer(cfg_j)
    st_j = jax.eval_shape(opt_j.init, ref_p)
    ref = jax_shd.opt_pspecs(st_j, jax_shd.param_pspecs(ref_p))
    assert specs.step == tuple(ref.step) == ()
    leaf_paths = _leaf_paths(port_p)
    for moment, ref_moment in ((specs.mu, ref.mu), (specs.nu, ref.nu)):
        want = _expected({p: None for p in leaf_paths},
                         _ref_specs(ref_moment))
        assert moment == [want[p] for p in leaf_paths]


def _leaf_paths(tree, path=()) -> list:
    """Paths of a parameter tree's tensors in ``optim.tree_leaves``
    order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [q for k in sorted(tree) for q in _leaf_paths(tree[k],
                                                             path + (k,))]
    if isinstance(tree, list):
        return [q for i, v in enumerate(tree)
                for q in _leaf_paths(v, path + (i,))]
    return [path]


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("shape", list(jax_configs.SHAPES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_batch_pspecs_match_the_reference(arch, shape, multi_pod):
    cfg_t, cfg_j = configs.get_config(arch), jax_configs.get_config(arch)
    port = shd.batch_pspecs(cfg_t, _mesh(multi_pod),
                            configs.input_specs(cfg_t, shape))
    ref = jax_shd.batch_pspecs(cfg_j, _jax_mesh(multi_pod),
                               jax_configs.input_specs(cfg_j, shape))
    assert port == {k: tuple(v) for k, v in ref.items()}


def _decode_states(arch: str, shape: str):
    """(port meta state, reference abstract state) of the shape's batch
    and length."""
    cfg_t, cfg_j = configs.get_config(arch), jax_configs.get_config(arch)
    sh = jax_configs.SHAPES[shape]
    B, S = sh.global_batch, sh.seq_len
    if cfg_t.family == "audio":
        port_p, ref_p = _params(arch)
        De = cfg_t.encoder_d_model or cfg_t.d_model
        enc = torch.empty((B, cfg_t.encoder_seq, De),
                          dtype=cfg_t.activation_dtype, device="meta")
        with torch.no_grad():
            port = init_decode_state(cfg_t, B, S, enc=enc, params=port_p)
        enc_j = jax.ShapeDtypeStruct((B, cfg_j.encoder_seq, De),
                                     cfg_j.activation_dtype)
        ref = jax.eval_shape(
            lambda p, e: jax_tf.init_decode_state(cfg_j, B, S, enc=e,
                                                  params=p), ref_p, enc_j)
    else:
        port = init_decode_state(cfg_t, B, S, device="meta")
        ref = jax.eval_shape(lambda: jax_tf.init_decode_state(cfg_j, B, S))
    return cfg_t, cfg_j, port, ref


def _decode_cases():
    out = []
    for arch in configs.ARCH_IDS:
        for shape in ("decode_32k", "long_500k"):
            if configs.shape_applicable(configs.get_config(arch), shape)[0]:
                out.append((arch, shape))
    return out


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch,shape", _decode_cases())
def test_decode_state_pspecs_match_the_reference(arch, shape, multi_pod):
    """Every cache's spec, per layer (per period for the hybrid, whose
    tail is a list in both); ``KVCache.pos`` is a host int in the port
    and has no spec."""
    cfg_t, cfg_j, port_s, ref_s = _decode_states(arch, shape)
    port = _port_specs(shd.decode_state_pspecs(cfg_t, _mesh(multi_pod),
                                               port_s))
    ref = _ref_specs(jax_shd.decode_state_pspecs(cfg_j, _jax_mesh(multi_pod),
                                                 ref_s))
    assert port
    for path, spec in port.items():
        rpath, stacked = (path[:1] + path[2:], True) \
            if path[0] == "caches" else (path, False)
        if rpath[-1] == "pos":
            assert spec is None
            continue
        want = ref[rpath]
        if stacked and want is not None:
            want = want[1:]
        assert spec == want, path
    # every reference spec has its place in the port's
    n_ref = sum(1 for p in ref if p[-1] != "pos" and ref[p] is not None)
    assert len({(p[:1] + p[2:]) if p[0] == "caches" else p
                for p, s in port.items()
                if p[-1] != "pos" and s is not None}) == n_ref


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("batch", [1, 16, 32, 256])
def test_dp_for_batch_matches_the_reference(batch, multi_pod):
    assert shd.dp_for_batch(_mesh(multi_pod), batch) \
        == jax_shd.dp_for_batch(_jax_mesh(multi_pod), batch)
    assert shd.dp_axes(_mesh(multi_pod)) \
        == jax_shd.dp_axes(_jax_mesh(multi_pod))


def test_to_placements():
    """("pod", "data") on one dim shards it over both mesh dims, the pod
    outermost; None replicates; a rank-1 rule under a rank-0 leaf
    replicates it; axes out of the mesh's order are refused."""
    from torch.distributed.tensor import Replicate, Shard
    pod = _mesh(True)
    assert shd.to_placements(pod, (("pod", "data"), None, "model")) \
        == [Shard(0), Shard(0), Shard(2)]
    assert shd.to_placements(pod, None) == [Replicate()] * 3
    assert shd.to_placements(_mesh(False), (None, "model")) \
        == [Replicate(), Shard(1)]
    scalar = torch.empty((), device="meta")
    assert shd._spec_for(("blk", "lam"), scalar) == ()
    assert shd._spec_for(("wq", "b"), scalar) == ()
    assert shd.to_placements(pod, shd._spec_for(("blk", "lam"), scalar)) \
        == [Replicate()] * 3
    with pytest.raises(ValueError, match="mesh's order"):
        shd.to_placements(pod, (("data", "pod"),))
    with pytest.raises(ValueError, match="twice"):
        shd.to_placements(pod, ("data", "data"))


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_pspecs_cover_every_leaf(arch):
    """Every parameter leaf gets a spec of its rank, and every dim named
    on a 16-way axis is a multiple of 8 or at least 16 (the reference's
    test_param_pspecs_cover_every_leaf)."""
    params, _ = _params(arch)
    specs = shd.param_pspecs(params)
    leaves = tree_leaves(params)
    flat = [s for _, s in sorted(_port_specs(specs).items(),
                                 key=lambda kv: _leaf_paths(params)
                                 .index(kv[0]))]
    assert len(flat) == len(leaves)
    for t, spec in zip(leaves, flat):
        assert isinstance(spec, tuple) and len(spec) == t.dim(), \
            (t.shape, spec)
        for dim, ax in zip(t.shape, spec):
            if ax in ("data", "model"):
                assert dim % 8 == 0 or dim >= 16, (arch, t.shape, spec)


def test_hints_are_identities_on_plain_tensors():
    """On plain tensors ``shard`` returns its argument itself, and
    ``linear``, ``split_heads`` and ``merge_heads`` compute what they
    computed without the hints, bit for bit."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 5, 12), generator=g)
    p = {"w": torch.randn((12, 6), generator=g),
         "b": torch.randn((6,), generator=g)}
    assert common.shard(x, "dp", "tp", None) is x
    assert common.shard(x, "dp", None, None) is x
    assert common.gather_fsdp(p["w"]) is p["w"]
    assert torch.equal(common.linear(p, x), x @ p["w"] + p["b"])
    assert torch.equal(common.linear({"w": p["w"]}, x), x @ p["w"])
    y = common.split_heads(x, 3, 4)
    assert torch.equal(y, x.reshape(2, 5, 3, 4))
    assert torch.equal(common.merge_heads(y), x)


# ---------------------------------------------------------------------------
# executed: 8 gloo ranks, make_host_mesh(4, 2)
# ---------------------------------------------------------------------------

MOE = "qwen2-moe-a2.7b"


@pytest.fixture(scope="module")
def moe_reference(tmp_path_factory):
    """qwen2-moe-a2.7b's smoke parameters from the reference's init, and
    the reference's jitted unsharded step from them."""
    sys.path.insert(0, HERE)
    import _torch_sharding_ranks as ranks
    cfg_j = jax_configs.smoke_variant(jax_configs.get_config(MOE))
    cfg_t = ranks.variant_config(MOE)
    tree = jax_tf.init_params(jax.random.PRNGKey(3), cfg_j)
    params = params_from_jax(tree, cfg_t, "cpu")
    opt = jax_optim.sgd(ranks.LR)
    step = jax.jit(jax_train.make_train_step(cfg_j, opt))
    batch = jax_data.make_batch(cfg_j, ranks.BATCH, ranks.SEQ, seed=0)
    new, _, metrics = step(tree, opt.init(tree), batch)
    path = tmp_path_factory.mktemp("ref") / "params.pt"
    torch.save({MOE: params}, path)
    return dict(path=path, loss=float(metrics["loss"]),
                params=jax.tree.leaves(new), tree=new)


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory, moe_reference):
    out = tmp_path_factory.mktemp("ranks")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, HERE]),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable,
                           os.path.join(HERE, "_torch_sharding_ranks.py"),
                           str(out), str(moe_reference["path"])],
                          env=env, capture_output=True, text=True,
                          timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return out, [json.loads((out / f"rank{r}.json").read_text())
                 for r in range(8)]


def _variants():
    sys.path.insert(0, HERE)
    import _torch_sharding_ranks as ranks
    return [name for name, _, _ in ranks.VARIANTS]


@pytest.mark.parametrize("variant", _variants())
def test_sharded_step_matches_the_unsharded_step(variant, rank_results):
    """On every rank: the loss, the prefill logits and every parameter
    after the step within 1e-5 of the unsharded value's largest |value|."""
    _, res = rank_results
    for r in res:
        v = r[variant]
        assert v["loss"] <= TOL, v["loss"]
        assert v["logits"] <= TOL, v["logits"]
        assert v["params"] <= TOL, v["params"]
        assert np.isfinite(v["loss_value"])


@pytest.mark.parametrize("variant", _variants())
def test_ranks_holding_a_shard_agree_bitwise(variant, rank_results):
    """Ranks at the same coordinate of every mesh axis a leaf is sharded
    over hold bitwise equal shards of it after the step (a leaf
    replicated over an axis is equal across it)."""
    _, res = rank_results
    n_leaves = res[0][variant]["leaves"]
    for i in range(n_leaves):
        by_shard: dict = {}
        for r in res:
            key, digest = r[variant]["shards"][i]
            by_shard.setdefault(json.dumps(key), set()).add(digest)
        assert all(len(d) == 1 for d in by_shard.values()), (variant, i)


def test_moe_sharded_step_matches_the_reference(rank_results,
                                                moe_reference):
    """qwen2-moe-a2.7b's sharded step (rank 0's gathered parameters)
    against the reference's jitted unsharded step on the same converted
    parameters: loss and every parameter at rtol 1e-5 (atol 1e-5 of the
    leaf's largest |value|)."""
    out, res = rank_results
    saved = torch.load(out / res[0][MOE]["saved"])
    np.testing.assert_allclose(float(saved["loss"]), moe_reference["loss"],
                               rtol=1e-5)
    want = {}
    for path, leaf in tree_flatten_with_path(moe_reference["tree"])[0]:
        want[tuple(_key(e) for e in path)] = np.asarray(leaf)
    sys.path.insert(0, HERE)
    import _torch_sharding_ranks as ranks
    cfg_t = ranks.variant_config(MOE)
    port_p = init_params(cfg_t, device="meta")
    for path, got in zip(_leaf_paths(port_p), saved["params"]):
        rpath, stacked = _as_reference_path(path)
        w = want[rpath]
        if stacked:
            w = w[path[list(path).index(rpath[0]) + 1]]
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())
