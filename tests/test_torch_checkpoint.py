"""Port parity: the checkpoint wire format, against
``repro.checkpoint``.

A file written by either package loads in the other, leaf for leaf and
bit for bit: f32, bf16 (stored as uint16 bits), int32, 0-d leaves, nested
dicts and lists.  Also the port's own Checkpointer: retention, latest
step, async saves visible after ``wait``, no ``.tmp`` left behind, a
snapshot that later in-place updates do not reach, and the trainer's
tree under JAX's key paths.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JaxCheckpointer
from repro.checkpoint import load_pytree as jax_load
from repro.checkpoint import save_pytree as jax_save
from repro_torch.checkpoint import Checkpointer, checkpoint_meta, load_pytree, save_pytree
from repro_torch.configs import get_smoke_config
from repro_torch.convert import param_tree, tree_paths
from repro_torch.models import LM
from repro_torch.optim import adamw_init


def _trees(seed=0):
    """The same tree for both packages: (port tensors, JAX arrays)."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(2, 3)).astype(np.float32)
    bf = rng.normal(size=(4,)).astype(np.float32)
    ints = rng.integers(-5, 5, size=(2, 2)).astype(np.int32)
    port = {"a": torch.from_numpy(a),
            "nested": [{"b": torch.from_numpy(bf).bfloat16()},
                       {"c": torch.from_numpy(ints), "step": torch.tensor(7, dtype=torch.int32)}],
            "0d": torch.tensor(2.5)}
    jaxt = {"a": jnp.asarray(a),
            "nested": [{"b": jnp.asarray(bf).astype(jnp.bfloat16)},
                       {"c": jnp.asarray(ints), "step": jnp.asarray(7, jnp.int32)}],
            "0d": jnp.asarray(2.5, jnp.float32)}
    return port, jaxt


def _bits(x) -> np.ndarray:
    """The raw bytes of a leaf as uint8, with its dtype name."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).removeprefix("torch.")
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return name, x.numpy().tobytes()
    x = np.asarray(x)
    return x.dtype.name, x.tobytes()


def _assert_same(port_tree, jax_tree):
    pl = tree_paths(port_tree)
    jl = [(k, v) for k, v in tree_paths(jax.tree.map(np.asarray, jax_tree))]
    assert [k for k, _ in pl] == [k for k, _ in jl]
    for (key, p), (_, j) in zip(pl, jl):
        assert tuple(p.shape) == tuple(np.shape(j)), key
        assert _bits(p) == _bits(j), key


def test_port_file_loads_in_jax(tmp_path):
    port, jaxt = _trees()
    save_pytree(tmp_path / "p.msgpack", port, {"step": 3})
    loaded = jax_load(tmp_path / "p.msgpack", jaxt)
    _assert_same(port, loaded)
    assert loaded["nested"][0]["b"].dtype == jnp.bfloat16


def test_jax_file_loads_in_port(tmp_path):
    port, jaxt = _trees(1)
    jax_save(tmp_path / "j.msgpack", jaxt, {"step": 4})
    loaded = load_pytree(tmp_path / "j.msgpack", port)
    _assert_same(loaded, jaxt)
    assert loaded["nested"][0]["b"].dtype == torch.bfloat16
    assert loaded["nested"][1]["step"].dtype == torch.int32
    assert checkpoint_meta(tmp_path / "j.msgpack") == {"step": 4}


def test_headers_are_byte_identical(tmp_path):
    port, jaxt = _trees(2)
    save_pytree(tmp_path / "p.msgpack", port, {"step": 1})
    jax_save(tmp_path / "j.msgpack", jaxt, {"step": 1})
    assert (tmp_path / "p.msgpack").read_bytes() == (tmp_path / "j.msgpack").read_bytes()


def test_trainer_tree_uses_jax_key_paths(tmp_path):
    """The port's {params, opt} tree saves under the JAX trainer's keys."""
    from repro.models import LM as JaxLM
    from repro.optim import adamw_init as jax_adamw_init
    cfg = get_smoke_config("llama3_8b")
    params = param_tree(LM(cfg, param_dtype=torch.float32, device="cpu"))
    save_pytree(tmp_path / "p.msgpack", {"params": params, "opt": adamw_init(params)})
    jparams = JaxLM(cfg, param_dtype=jnp.float32).init(0)
    jax_save(tmp_path / "j.msgpack", {"params": jparams, "opt": jax_adamw_init(jparams)})

    def header(name):
        raw = (tmp_path / name).read_bytes()
        return json.loads(raw[8:8 + int.from_bytes(raw[:8], "little")])["leaves"]
    port_h, jax_h = header("p.msgpack"), header("j.msgpack")
    assert [(h["key"], h["shape"], h["dtype"]) for h in port_h] == \
        [(h["key"], h["shape"], h["dtype"]) for h in jax_h]
    assert port_h[-1]["key"] == "/params/lm_head"
    # and the JAX trainer's file restores into the port's tree
    tree = load_pytree(tmp_path / "j.msgpack", {"params": params, "opt": adamw_init(params)})
    np.testing.assert_array_equal(tree["params"]["blocks"][0]["mixer"]["wq"].numpy(),
                                  np.asarray(jparams["blocks"][0]["mixer"]["wq"]))


@pytest.mark.parametrize("async_save", [False, True])
def test_retention_and_latest(tmp_path, async_save):
    ck = Checkpointer(tmp_path, keep=2, async_save=async_save)
    for s in (1, 2, 3, 4):
        ck.save(s, {"x": torch.full((2,), float(s))})
    ck.wait()
    assert ck.steps() == [3, 4] and ck.latest_step() == 4
    tree, meta = ck.restore({"x": torch.zeros(2)})
    assert meta["step"] == 4 and float(tree["x"][0]) == 4.0
    # the JAX checkpointer reads the port's directory
    jtree, jmeta = JaxCheckpointer(tmp_path, async_save=False).restore({"x": jnp.zeros(2)})
    assert jmeta["step"] == 4 and float(jtree["x"][1]) == 4.0


def test_async_save_visible_after_wait_and_snapshot_is_a_copy(tmp_path):
    ck = Checkpointer(tmp_path, async_save=True)
    x = torch.ones(3)
    ck.save(7, {"x": x})
    x.add_(5.0)                     # an in-place update right after the save
    ck.wait()
    assert ck.latest_step() == 7 and ck._pending is None
    tree, _ = ck.restore({"x": x})
    assert torch.equal(tree["x"], torch.ones(3))


def test_no_tmp_left_behind_and_empty_restore(tmp_path):
    ck = Checkpointer(tmp_path, async_save=False)
    assert ck.restore({"x": torch.zeros(2)}) == (None, None)
    ck.save(1, {"x": torch.ones((2,), dtype=torch.bfloat16)})
    assert not list(tmp_path.glob("*.tmp"))
    assert [p.name for p in tmp_path.iterdir()] == ["ckpt_000000001.msgpack"]
