"""The port's step builders on the production meshes, over a fake process
group of 256 and of 512 ranks: every (arch × shape) cell of the JAX dry
run (``src/repro/launch/dryrun.py`` ``cells()``: every arch at train_4k,
prefill_32k and decode_32k, and long_500k for the ssm and hybrid
families) builds its train, prefill or serve bundle on the meta device,
with nothing allocated, and each input spec's local shard is its global
shape over the sizes of the axes its placements name.  Also the meshes'
own contracts; and on a mesh of one, the loss and gradients of a bundle's
model under each remat policy against the plain model's.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch.configs import ARCH_IDS, SHAPES, ShapeConfig, get_config, get_smoke_config
from repro_torch.convert import flatten_tree, param_tree
from repro_torch.launch import (build_prefill_step, build_serve_step, build_train_step,
                                make_local_mesh, make_production_mesh)
from repro_torch.launch import sharding as tsh
from repro_torch.launch.mesh import data_axes
from repro_torch.launch.steps import place_like, place_state
from repro_torch.models import LM

# dryrun.py: long_500k needs sub-quadratic attention, so only these run it
_LONG_OK_FAMILIES = ("ssm", "hybrid")
_SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def _cells():
    for arch in ARCH_IDS:
        for name in _SHAPE_NAMES:
            if name == "long_500k" and get_config(arch).family not in _LONG_OK_FAMILIES:
                continue
            yield arch, name


@pytest.fixture(params=[False, True], ids=["256", "512"])
def mesh(request):
    assert not dist.is_initialized()
    world = 512 if request.param else 256
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield make_production_mesh(multi_pod=request.param, device="cpu")
    finally:
        dist.destroy_process_group()


def _build(arch, name, mesh):
    kind = SHAPES[name].kind
    fn = {"train": build_train_step, "prefill": build_prefill_step,
          "decode": build_serve_step}[kind]
    return fn(arch, name, mesh)


def _check_spec(spec, mesh):
    assert isinstance(spec, DTensor)
    local = spec.to_local()
    assert local.device.type == "meta"
    want = list(spec.shape)
    for i, p in enumerate(spec.placements):
        if isinstance(p, Shard):
            assert want[p.dim] % mesh.size(i) == 0
            want[p.dim] //= mesh.size(i)
        else:
            assert p == Replicate()
    assert list(local.shape) == want, (tuple(spec.shape), spec.placements)


@pytest.mark.parametrize("arch,name", list(_cells()))
def test_builds_every_cell_without_allocating(mesh, arch, name):
    bundle = _build(arch, name, mesh)
    shape, cfg = SHAPES[name], get_config(arch)
    assert bundle.shape is shape and bundle.mesh is mesh
    assert bundle.policy == tsh.pick_policy(cfg.total_params())
    assert all(p.device.type == "meta" for p in bundle.model.parameters())
    leaves = flatten_tree({k: v for k, v in bundle.input_specs.items()})
    assert leaves
    for spec in leaves.values():
        _check_spec(spec, mesh)
    params = flatten_tree(bundle.input_specs["params"])
    assert params.keys() == flatten_tree(param_tree(bundle.model)).keys()
    b = shape.global_batch
    if shape.kind == "train":
        assert bundle.model.remat == "full"
        opt = bundle.input_specs["opt_state"]
        assert opt["step"].placements == (Replicate(),) * mesh.ndim
        for key in ("m", "v", "master"):
            for n, s in flatten_tree(opt[key]).items():
                assert s.placements == params[n].placements and s.shape == params[n].shape
        assert flatten_tree(opt["master"])["embed"].dtype == torch.float32
        tokens = bundle.input_specs["batch"]["tokens"]
        assert tokens.shape == (b, shape.seq_len)
        assert tokens.placements == tsh.to_placements(
            tsh.batch_sharding(mesh, b, bundle.policy), mesh)
    else:
        assert bundle.model.remat == "none"
        tokens = bundle.input_specs["tokens"]
        assert tokens.shape == (b, 1 if shape.kind == "decode" else shape.seq_len)
        assert tokens.placements == tsh.to_placements(tsh.batch_sharding(mesh, b), mesh)
    if shape.kind == "decode":
        assert flatten_tree(bundle.input_specs["cache"])
    if cfg.frontend_tokens:
        key = {"train": None, "prefill": "frontend", "decode": "memory"}[shape.kind]
        spec = (bundle.input_specs["batch"]["frontend"] if key is None
                else bundle.input_specs[key])
        assert spec.shape[:2] == (b, cfg.frontend_tokens)


def test_embed_placements_follow_the_rules(mesh):
    bundle = build_train_step("llama3_8b", "train_4k", mesh)
    embed = bundle.input_specs["params"]["embed"]
    want = tsh.to_placements(tsh.param_sharding_rules({"embed": embed}, mesh,
                                                      "fsdp_tp")["embed"], mesh)
    assert embed.placements == want
    assert embed.to_local().shape == (128256 // 16, 4096 // (16 * (mesh.ndim - 1)))
    assert data_axes(mesh) == tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def test_production_mesh_refuses_another_world():
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        with pytest.raises(ValueError, match=r"256 ranks; this one has 8"):
            make_production_mesh(device="cpu")
        with pytest.raises(ValueError, match=r"512 ranks; this one has 8"):
            make_production_mesh(multi_pod=True, device="cpu")
    finally:
        dist.destroy_process_group()


def test_local_mesh_of_one_sets_up_its_own_group():
    assert not dist.is_initialized()
    try:
        mesh = make_local_mesh(device="cpu")
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
    finally:
        dist.destroy_process_group()


def test_local_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="card"):
        make_local_mesh()
    assert not dist.is_initialized()


SHAPES.setdefault("unit_steps_train", ShapeConfig("unit_steps_train", 8, 2, "train"))


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("arch", ["llama3_8b", "olmoe_1b_7b", "rwkv6_1b6", "jamba_15_large",
                                  "seamless_m4t_v2"])
def test_mesh_of_one_loss_and_grads_equal_the_plain_model(arch, remat):
    """On a mesh of one the DTensor route computes what the plain model
    does, under every remat policy (the checkpoints recompute on DTensor
    inputs): the loss and every gradient to 1e-6 of their largest value."""
    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.frontend_tokens:
        batch["frontend"] = torch.from_numpy(rng.normal(
            size=(2, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)).bfloat16()
    # a Mamba chunk of S: the default of 256 would pad 8 steps to 256
    plain = LM(cfg, param_dtype=torch.float32, max_seq=16, remat=remat, mamba_chunk=8,
               device="cpu")
    for p in plain.parameters():
        p.requires_grad_(True)
    loss = plain.loss(batch)
    loss.backward()
    assert not dist.is_initialized()
    try:
        bundle = build_train_step(arch, "unit_steps_train", make_local_mesh(device="cpu"),
                                  cfg=cfg, remat=remat)
        bundle.model.param_dtype = torch.float32
        bundle.model.mamba_chunk = 8
        place_state(bundle, device="cpu")
        got = bundle.model.loss(place_like(batch, bundle.input_specs["batch"]))
        got.backward()
        got, loss = float(got.detach().full_tensor()), float(loss.detach())
        assert abs(got - loss) <= 1e-6 * abs(loss)
        mine = dict(bundle.model.named_parameters())
        for name, p in plain.named_parameters():
            g = mine[name].grad.full_tensor()
            scale = float(p.grad.abs().max()) or 1.0
            assert float((g - p.grad).abs().max()) <= 1e-6 * scale, name
    finally:
        dist.destroy_process_group()
