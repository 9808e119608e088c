"""The port's sharding rules against JAX's, entry by entry.

``repro_torch.launch.sharding`` returns specs as tuples (per tensor dim an
axis name, a tuple of names or None); JAX's return ``PartitionSpec``s,
which store a one-name tuple as the bare name.  Both are normalised that
way and compared exactly: every parameter of every arch (smoke configs,
and full configs shaped without allocation: ``jax.eval_shape`` on the
JAX side, ``LM(cfg, device="meta")`` on the port's), on the production
meshes 16x16 and 2x16x16, under the policies tp, fsdp_tp and fsdp; the
batch, frontend and decode-cache specs; and the spec that JAX's
activation hook hands to ``jax.lax.with_sharding_constraint`` for each
kind and shape, recorded by patching that function (and
``NamedSharding``, which needs a real mesh) for the test.  The rules read
only axis names and sizes, so both sides run on stand-in meshes.  Also
here: the port's versions of ``tests/test_sharding_rules.py``'s five
tests, and the meta LM's shapes and dtypes against a real draw and JAX's
``eval_shape``.
"""
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

import repro.launch.sharding as jsh
from repro.models import LM as JaxLM
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_smoke_config
from repro_torch.convert import flatten_tree, param_tree
from repro_torch.launch import sharding as tsh
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import LM


class JaxMesh:
    """Duck-typed mesh exposing what JAX's rules consume."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
POLICIES = ("tp", "fsdp_tp", "fsdp")


def _meshes(name):
    shape = MESHES[name]
    return JaxMesh(shape), SimpleNamespace(mesh_dim_names=tuple(shape),
                                           shape=tuple(shape.values()))


def _norm(spec):
    """A spec as a tuple, a one-name tuple entry as the bare name."""
    if spec is None:
        return None
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in tuple(spec))


def _walk(tree, is_leaf, prefix=""):
    if is_leaf(tree):
        return {prefix: tree}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_walk(v, is_leaf, f"{prefix}/{k}"))
    return out


@functools.lru_cache(maxsize=None)
def _cfg(arch, size):
    return get_smoke_config(arch) if size == "smoke" else get_config(arch)


@functools.lru_cache(maxsize=None)
def _jax_shapes(arch, size):
    return jax.eval_shape(lambda: JaxLM(_cfg(arch, size)).init(0))


@functools.lru_cache(maxsize=None)
def _port_tree(arch, size):
    return param_tree(LM(_cfg(arch, size), device="meta"))


def _jax_param_specs(arch, size, mesh, policy):
    specs = jsh.param_sharding_rules(_jax_shapes(arch, size), mesh, policy)
    return {k: _norm(v) for k, v in _walk(specs, lambda x: isinstance(x, P)).items()}


def _port_param_specs(arch, size, mesh, policy):
    specs = tsh.param_sharding_rules(_port_tree(arch, size), mesh, policy)
    return {k: _norm(v) for k, v in _walk(specs, lambda x: isinstance(x, tuple)).items()}


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_jax(arch, size, mesh, policy):
    jmesh, tmesh = _meshes(mesh)
    want = _jax_param_specs(arch, size, jmesh, policy)
    got = _port_param_specs(arch, size, tmesh, policy)
    assert got.keys() == want.keys()
    for path in want:
        assert got[path] == want[path], (path, got[path], want[path])


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_meta_lm_shapes_equal_jax_eval_shape(arch, size):
    got = flatten_tree(_port_tree(arch, size))
    want = flatten_tree(_jax_shapes(arch, size))
    assert got.keys() == want.keys()
    for name, leaf in got.items():
        assert leaf.device.type == "meta"
        assert tuple(leaf.shape) == tuple(want[name].shape), name
        assert str(leaf.dtype).split(".")[-1] == str(want[name].dtype), name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_meta_lm_equals_a_real_draw(arch):
    cfg = get_smoke_config(arch)
    real = flatten_tree(param_tree(LM(cfg, device="cpu")))
    meta = flatten_tree(param_tree(LM(cfg, device="meta")))
    assert real.keys() == meta.keys()
    for name in real:
        assert (meta[name].shape, meta[name].dtype) == (real[name].shape, real[name].dtype)
    # the meta build draws nothing: a real draw after it is unchanged
    again = flatten_tree(param_tree(LM(cfg, device="cpu")))
    assert all(torch.equal(again[n], real[n]) for n in real)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("batch", [None, 1, 4, 16, 32, 128, 256, 512])
def test_batch_and_frontend_specs_equal_jax(monkeypatch, batch, mesh, policy):
    monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, spec: spec)
    jmesh, tmesh = _meshes(mesh)
    assert _norm(tsh.batch_sharding(tmesh, batch, policy)) == \
        _norm(jsh.batch_sharding(jmesh, batch, policy))
    assert _norm(tsh.frontend_sharding(tmesh, batch)) == \
        _norm(jsh.frontend_sharding(jmesh, batch))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", ["decode_32k", "long_500k", "small"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_jax(monkeypatch, arch, shape, mesh):
    monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, spec: spec)
    jmesh, tmesh = _meshes(mesh)
    b, s = (4, 2048) if shape == "small" else (SHAPES[shape].global_batch,
                                               SHAPES[shape].seq_len)
    cfg = get_config(arch)
    jcache = jax.eval_shape(lambda: JaxLM(cfg).init_cache(b, s, dtype=jnp.bfloat16))
    tcache = LM(cfg, device="meta").init_cache(b, s, dtype=torch.bfloat16)
    want = _walk(jsh.cache_shardings(jcache, jmesh, b), lambda x: isinstance(x, P))
    got = _walk(tsh.cache_shardings(tcache, tmesh, b), lambda x: isinstance(x, tuple))
    assert got.keys() == want.keys()
    for path in want:
        assert _norm(got[path]) == _norm(want[path]), path


_ACT_SHAPES = [(256, 4096, 4096), (8, 4096, 128256), (1, 1, 4096), (3, 5, 7),
               (256, 1, 4096), (32, 32768, 16384), (128, 1, 152064), (1, 524288, 8192),
               (256, 64, 80, 4096), (1, 8, 1, 14336), (16, 16, 4, 7), (2, 3, 5, 16),
               (256, 4096), (7,), (4, 16, 24, 64)]
_KINDS = ["residual", "attn_in", "logits", "mamba_din", "moe_tokens", "moe_hidden", "act"]


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("kind", _KINDS)
def test_activation_specs_equal_jax(monkeypatch, kind, mesh, policy):
    seen = []
    monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: seen.append(spec) or x)
    jmesh, tmesh = _meshes(mesh)
    hook = jsh.make_shard_act(jmesh, policy)
    for shape in _ACT_SHAPES:
        seen.clear()
        hook(jax.ShapeDtypeStruct(shape, jnp.float32), kind)
        want = _norm(seen[0]) if seen else None
        assert _norm(tsh.act_spec(tmesh, policy, shape, kind)) == want, shape


def test_to_placements_shards_in_mesh_order():
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"), shape=(2, 16, 16))
    assert tsh.to_placements((("pod", "data"), "model"), mesh) == (Shard(0), Shard(0), Shard(1))
    assert tsh.to_placements((None, None), mesh) == (Replicate(),) * 3
    assert tsh.to_placements((("pod", "data", "model"), None), mesh) == (Shard(0),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        tsh.to_placements((("model", "data"), None), mesh)


# ---- the port's versions of tests/test_sharding_rules.py ----------------- #
def _leaves_with_specs(arch, mesh, policy):
    tree = param_tree(LM(get_smoke_config(arch), device="meta"))
    specs = _walk(tsh.param_sharding_rules(tree, mesh, policy), lambda x: isinstance(x, tuple))
    leaves = _walk(tree, lambda x: isinstance(x, torch.Tensor))
    return [(leaves[k], specs[k]) for k in leaves]


PROD = _meshes("16x16")[1]
PROD_MP = _meshes("2x16x16")[1]


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("mesh", [PROD, PROD_MP], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("policy", POLICIES)
def test_specs_are_legal(arch, mesh, policy):
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))

    def axsize(ax):
        if ax is None:
            return 1
        if isinstance(ax, tuple):
            return int(np.prod([sizes[a] for a in ax]))
        return sizes[ax]

    for leaf, spec in _leaves_with_specs(arch, mesh, policy):
        assert len(spec) <= len(leaf.shape), (leaf.shape, spec)
        for dim, ax in zip(leaf.shape, spec):
            assert dim % axsize(ax) == 0, (arch, leaf.shape, spec)


def test_fsdp_tp_shards_more_than_tp():
    def sharded_dims(policy):
        return sum(1 for _, spec in _leaves_with_specs("llama3_8b", PROD, policy)
                   for ax in spec if ax is not None)
    assert sharded_dims("fsdp_tp") > sharded_dims("tp")


def test_norms_replicated():
    for leaf, spec in _leaves_with_specs("llama3_8b", PROD, "fsdp_tp"):
        if len(leaf.shape) == 1 and leaf.shape[0] <= 64:
            assert all(ax is None for ax in spec)


def test_fsdp_policy_shards_over_all_axes():
    for _, spec in _leaves_with_specs("qwen25_32b", PROD, "fsdp"):
        axes = [ax for ax in spec if ax is not None]
        assert len(axes) <= 1
        for ax in axes:
            assert isinstance(ax, tuple)
            assert set(ax) <= {"pod", "data", "model"}


def test_fsdp_batch_sharding_uses_model_axis():
    assert not dist.is_initialized()
    try:
        mesh = make_local_mesh(1, 1, device="cpu")   # a real mesh of one
        assert tsh.batch_sharding(mesh, 256, policy="fsdp")[0] == ("data", "model")
        assert tsh.batch_sharding(mesh, 256, policy="fsdp_tp")[0] in ("data", ("data",))
    finally:
        dist.destroy_process_group()


# ---- the activation hook's call sites ------------------------------------ #
def _recorder(calls):
    def hook(x, kind="act"):
        calls.add((kind, tuple(x.shape)))
        return x
    return hook


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_hook_sites_and_kinds_equal_jax(arch):
    """The port's LM calls ``shard_act`` with the kinds and shapes the JAX
    LM does, over a prefill forward and the training loss (JAX's layer scan
    traces its body once, so the sets are compared, not the counts)."""
    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.frontend_tokens:
        batch["frontend"] = rng.normal(
            size=(2, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    jax_calls, port_calls = set(), set()
    jm = JaxLM(cfg, param_dtype=jnp.float32, attn_chunk=4, mamba_chunk=4, rwkv_chunk=4,
               shard_act=_recorder(jax_calls))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    # traced, not run: the hook sees every site while JAX traces
    jax.eval_shape(lambda: jm.forward(jm.init(0), jb["tokens"], jb.get("frontend"),
                                      last_only=True))
    jax.eval_shape(lambda: jm.loss(jm.init(0), jb, vocab_chunk=4))
    tm = LM(cfg, param_dtype=torch.float32, attn_chunk=4, mamba_chunk=4, rwkv_chunk=4,
            shard_act=_recorder(port_calls), device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        tm.forward(tb["tokens"], tb.get("frontend"), last_only=True)
        tm.loss(tb, vocab_chunk=4)
    assert port_calls == jax_calls
    kinds = {k for k, _ in port_calls}
    assert {"attn_in", "residual", "logits"} & kinds
    if cfg.family == "hybrid":
        assert {"mamba_din", "moe_tokens", "moe_hidden"} <= kinds
    if cfg.is_moe:
        assert {"moe_tokens", "moe_hidden"} <= kinds


def test_no_hook_is_the_identity():
    cfg = get_smoke_config("jamba_15_large")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int64))
    plain = LM(cfg, param_dtype=torch.float32, mamba_chunk=4, device="cpu")
    hooked = LM(cfg, param_dtype=torch.float32, mamba_chunk=4, device="cpu",
                shard_act=lambda x, kind="act": x)
    with torch.no_grad():
        assert torch.equal(plain(toks), hooked(toks))


def test_trainer_takes_a_mesh_and_ignores_it():
    from repro_torch.configs import ShapeConfig
    from repro_torch.runtime import Trainer, TrainerConfig
    cfg = get_smoke_config("llama3_8b")
    t = Trainer(cfg, ShapeConfig("t", 8, 2, "train"), TrainerConfig(steps=1),
                mesh=object(), device="cpu")
    assert not hasattr(t, "mesh")
