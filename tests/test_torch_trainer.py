"""Port parity: the data pipeline, fault tolerance and the Trainer, on
the CPU — ``tests/test_substrates.py``'s ``TestData``, ``TestTrainer``
and straggler cases run against ``repro_torch``, plus the port against
JAX where both draw the same numbers: the synthetic batches (bit for
bit) and a few train steps from the same weights.

Three train steps from JAX's weights, f32: the losses agree to 1e-5 and
every parameter to atol 1e-6, rtol 1e-5 (a loss summed in another order
moves AdamW's normalized update only at f32 rounding).  Every test
closes or joins the threads it starts.
"""
import dataclasses
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticTokens as JaxSyntheticTokens
from repro.launch import train as jax_train
from repro.runtime import SimulatedFault as JaxSimulatedFault
from repro.runtime import StragglerMonitor as JaxStragglerMonitor
from repro.runtime import Trainer as JaxTrainer
from repro.runtime import TrainerConfig as JaxTrainerConfig
from repro_torch.configs import ShapeConfig, get_smoke_config
from repro_torch.convert import flatten_tree, load_jax_params, to_numpy_tree
from repro_torch.data import DataConfig, Prefetcher, SyntheticTokens, host_slice
from repro_torch.launch import train
from repro_torch.runtime import (FailureInjector, SimulatedFault, StepTimer,
                                 StragglerMonitor, Trainer, TrainerConfig,
                                 run_with_restarts)

TINY = ShapeConfig("tiny_train", seq_len=16, global_batch=4, kind="train")


@pytest.fixture(autouse=True)
def no_thread_outlives_the_test():
    before = set(threading.enumerate())
    yield
    left = [t for t in threading.enumerate() if t not in before and t.is_alive()]
    assert not left, left


class TestData:
    def test_deterministic_across_restarts(self):
        cfg = DataConfig(vocab_size=100, seq_len=8, global_batch=4, seed=3)
        a = SyntheticTokens(cfg).batch_at(7)
        b = SyntheticTokens(cfg).batch_at(7)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])

    def test_labels_are_shifted_tokens(self):
        cfg = DataConfig(vocab_size=100, seq_len=8, global_batch=2)
        batch = SyntheticTokens(cfg).batch_at(0)
        np.testing.assert_array_equal(batch["tokens"][:, 1:], batch["labels"][:, :-1])

    def test_host_sharding_partitions_batch(self):
        cfg = DataConfig(vocab_size=100, seq_len=8, global_batch=8)
        parts = [SyntheticTokens(cfg, host_id=h, n_hosts=4).batch_at(5) for h in range(4)]
        assert all(p["tokens"].shape[0] == 2 for p in parts)

    def test_host_slice_validates(self):
        with pytest.raises(ValueError):
            host_slice(10, 0, 3)

    @pytest.mark.parametrize("step,host,n_hosts,frontend", [
        (0, 0, 1, 0), (7, 1, 2, 0), (123, 3, 4, 0), (2, 0, 1, 5)])
    def test_batches_equal_jax(self, step, host, n_hosts, frontend):
        kw = dict(vocab_size=512, seq_len=12, global_batch=8, seed=5,
                  frontend_tokens=frontend, frontend_dim=3 if frontend else 0)
        ours = SyntheticTokens(DataConfig(**kw), host, n_hosts).batch_at(step)
        ref = JaxSyntheticTokens(JaxDataConfig(**kw), host, n_hosts).batch_at(step)
        assert ours.keys() == ref.keys()
        for key in ours:
            assert ours[key].dtype == ref[key].dtype
            np.testing.assert_array_equal(ours[key], ref[key])

    def test_prefetcher_delivers_in_order_and_closes(self):
        pf = Prefetcher(iter(range(10)), depth=2)
        got = [pf.get() for _ in range(10)]
        assert got == list(range(10))
        pf.close()
        assert not pf._thread.is_alive()

    def test_prefetcher_close_stops_an_endless_source(self):
        cfg = DataConfig(vocab_size=100, seq_len=8, global_batch=2)
        pf = Prefetcher(iter(SyntheticTokens(cfg)), depth=2)
        pf.get()
        pf.close()
        assert not pf._thread.is_alive()

    def test_prefetcher_surfaces_errors(self):
        def bad():
            yield 1
            raise KeyError("source failed")
        pf = Prefetcher(bad())
        assert pf.get() == 1
        with pytest.raises(KeyError, match="source failed"):
            pf.get()
        pf.close()


def make_trainer(tmp_path, injector=None, steps=6, async_ckpt=False):
    cfg = get_smoke_config("llama3_8b")
    tcfg = TrainerConfig(steps=steps, ckpt_every=2, ckpt_dir=str(tmp_path),
                         async_ckpt=async_ckpt)
    return Trainer(cfg, TINY, tcfg, attn_chunk=8, injector=injector, device="cpu")


class TestTrainer:
    def test_runs_and_loss_finite(self, tmp_path):
        t = make_trainer(tmp_path)
        hist = t.run()
        assert len(hist["loss"]) == 6
        assert all(np.isfinite(x) for x in hist["loss"])
        # training on repeated synthetic data should not increase loss
        assert hist["loss"][-1] <= hist["loss"][0] * 1.2

    def test_checkpoint_restart_resumes(self, tmp_path):
        t = make_trainer(tmp_path, steps=4)
        t.run()
        t2 = make_trainer(tmp_path, steps=8)
        hist = t2.run()
        assert hist["restarted_at"] == 4
        assert hist["step"][0] == 4 and hist["step"][-1] == 7

    @pytest.mark.parametrize("async_ckpt", [False, True])
    def test_fault_injection_and_supervised_restart(self, tmp_path, async_ckpt):
        calls = {"restarts": 0}
        # one injector across restarts: the fault fires once
        inj = FailureInjector(fail_at_steps=(3,), max_failures=1)

        def on_restart(n):
            calls["restarts"] = n

        hist, restarts = run_with_restarts(
            lambda: make_trainer(tmp_path, injector=inj, steps=6, async_ckpt=async_ckpt),
            lambda trainer: trainer.run(), on_restart=on_restart)
        assert restarts == 1
        assert calls["restarts"] == 1
        # resumed from the step-2 checkpoint, finished all 6 steps
        assert hist["step"][-1] == 5
        assert hist["restarted_at"] == 2
        # and the steps after the restart equal an unfaulted run's
        ref = make_trainer(tmp_path / "ref", steps=6, async_ckpt=async_ckpt).run()
        assert hist["loss"] == ref["loss"][2:]

    def test_gives_up_after_max_restarts(self, tmp_path):
        def make_state():
            inj = FailureInjector(fail_at_steps=(0,), max_failures=99)
            return make_trainer(tmp_path / "x", injector=inj, steps=3)

        with pytest.raises(SimulatedFault):
            run_with_restarts(make_state, lambda t: t.run(), max_restarts=2)

    def test_non_finite_loss_raises(self, tmp_path):
        t = make_trainer(tmp_path, steps=3)
        loss = t.model.loss
        t.model.loss = lambda batch: loss(batch) * float("nan")
        with pytest.raises(FloatingPointError, match="diverged at 0"):
            t.run()

    def test_second_run_starts_from_the_seed_again(self, tmp_path):
        """With no checkpoint, every run starts from the seed's weights
        (JAX's ``init_or_restore`` draws them anew each time)."""
        t = make_trainer(tmp_path, steps=2)
        first = t.run()
        for f in tmp_path.glob("ckpt_*"):
            f.unlink()
        assert t.run()["loss"] == first["loss"]

    def test_config_fields_match_jax(self):
        """TrainerConfig's fields have JAX's names, order and defaults; the
        checkpoint directory's default path is the one difference (the
        port's lies under the temp directory)."""
        ours, ref = TrainerConfig(), JaxTrainerConfig()
        names = [f.name for f in dataclasses.fields(ref)]
        assert [f.name for f in dataclasses.fields(ours)] == names
        for name in names:
            if name == "ckpt_dir":
                continue
            mine, theirs = getattr(ours, name), getattr(ref, name)
            if dataclasses.is_dataclass(theirs):
                assert dataclasses.asdict(mine) == dataclasses.asdict(theirs), name
            else:
                assert type(mine) is type(theirs) and mine == theirs, name
        assert TrainerConfig(log_every=5).log_every == JaxTrainerConfig(log_every=5).log_every

    def test_three_steps_match_jax(self, tmp_path):
        cfg = get_smoke_config("llama3_8b")
        jt = JaxTrainer(cfg, JaxShapeConfig("tiny_train", 16, 4, "train"),
                        JaxTrainerConfig(steps=3, ckpt_dir=str(tmp_path / "j")), attn_chunk=8)
        jparams, jstate, _ = jt.init_or_restore()
        tree = jax.tree.map(np.asarray, jparams)
        t = make_trainer(tmp_path / "p", steps=3)
        load_jax_params(t.model, tree)
        params, state, _ = t.init_or_restore()
        assert t.model.embed.requires_grad
        for step in range(3):
            host = t.data.batch_at(step)
            jparams, jstate, jm = jt.step_fn(jparams, jstate,
                                             {k: jnp.asarray(v) for k, v in host.items()})
            params, state, m = t.step_fn(params, state, t.batch(host))
            np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), atol=1e-5)
            np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                       rtol=1e-4)
        ours = flatten_tree(to_numpy_tree(t.model))
        for name, ref in flatten_tree(jax.tree.map(np.asarray, jparams)).items():
            np.testing.assert_allclose(ours[name], ref, atol=1e-6, rtol=1e-5, err_msg=name)
        assert int(state["step"]) == int(jstate["step"]) == 3

    def test_three_moe_steps_match_jax(self, tmp_path):
        """The MoE smoke config through both trainers: its loss carries the
        load-balancing term, and its experts and router update.

        Both run at capacity factor 16, where no token is dropped.  The
        synthetic batches repeat token ids (Zipf), and the first positions
        of a run of one id get hidden states that are equal up to rounding
        (attention averages identical values), so their gates tie; at the
        default 1.25 the capacity cut can fall between them, and where it
        falls is rounding: JAX's own jitted and eager losses of step 0
        differ by 9e-4 there."""
        cfg = get_smoke_config("olmoe_1b_7b")
        jt = JaxTrainer(cfg, JaxShapeConfig("tiny_train", 16, 4, "train"),
                        JaxTrainerConfig(steps=3, ckpt_dir=str(tmp_path / "j")), attn_chunk=8)
        jt.model.capacity_factor = 16.0
        jparams, jstate, _ = jt.init_or_restore()
        t = Trainer(cfg, TINY, TrainerConfig(steps=3, ckpt_dir=str(tmp_path / "p")),
                    attn_chunk=8, device="cpu")
        t.model.capacity_factor = 16.0
        load_jax_params(t.model, jax.tree.map(np.asarray, jparams))
        params, state, _ = t.init_or_restore()
        for step in range(3):
            host = t.data.batch_at(step)
            jparams, jstate, jm = jt.step_fn(jparams, jstate,
                                             {k: jnp.asarray(v) for k, v in host.items()})
            params, state, m = t.step_fn(params, state, t.batch(host))
            np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), atol=1e-5)
        ours = flatten_tree(to_numpy_tree(t.model))
        for name, ref in flatten_tree(jax.tree.map(np.asarray, jparams)).items():
            np.testing.assert_allclose(ours[name], ref, atol=1e-6, rtol=1e-5, err_msg=name)
        assert "blocks.0.moe.router" in ours


class TestStragglers:
    def test_flags_slow_host(self):
        mon = StragglerMonitor(threshold=1.5)
        for _ in range(8):
            mon.record(0, 1.0)
            mon.record(1, 1.05)
            mon.record(2, 3.0)
        assert mon.stragglers() == [2]

    @pytest.mark.parametrize("seed", [0, 1])
    def test_factors_match_jax(self, seed):
        rng = np.random.default_rng(seed)
        ours, ref = StragglerMonitor(window=8), JaxStragglerMonitor(window=8)
        for _ in range(20):
            for host in range(5):
                t = float(rng.uniform(1, 2) * (3 if host == seed + 2 else 1))
                ours.record(host, t)
                ref.record(host, t)
        assert ours.slowdown_factors() == ref.slowdown_factors()
        assert ours.stragglers() == ref.stragglers() == [seed + 2]

    def test_step_timer_laps(self):
        timer = StepTimer()
        assert 0 <= timer.lap() < 60


class TestLauncher:
    def test_smoke_run_on_the_cpu_with_a_fault(self, tmp_path):
        """As JAX's launcher: nothing supervises the run, so the injected
        fault ends it with the raised SimulatedFault, after both wrote the
        step-1 checkpoint."""
        args = ["--arch", "llama3_8b", "--steps", "4", "--seq-len", "8", "--batch", "2",
                "--ckpt-every", "2", "--inject-fault-at", "3"]
        before = set(threading.enumerate())
        with pytest.raises(JaxSimulatedFault) as ref:
            jax_train.main([*args, "--ckpt-dir", str(tmp_path / "jax")])
        with pytest.raises(SimulatedFault) as ours:
            train.main([*args, "--device", "cpu", "--ckpt-dir", str(tmp_path / "torch")])
        # JAX's run leaves its async checkpoint writer to finish on a fault
        for t in set(threading.enumerate()) - before:
            t.join(timeout=60)
        assert type(ours.value).__name__ == type(ref.value).__name__ == "SimulatedFault"
        assert str(ours.value) == str(ref.value) == "injected fault at step 3"
        kept = [sorted(q.name for q in (tmp_path / d).iterdir()) for d in ("jax", "torch")]
        assert kept[0] == kept[1] == ["ckpt_000000001.msgpack"]

    def test_moe_smoke_run_on_the_cpu(self, tmp_path):
        assert train.main(["--arch", "olmoe_1b_7b", "--steps", "3", "--seq-len", "8",
                           "--batch", "2", "--device", "cpu",
                           "--ckpt-dir", str(tmp_path)]) == 0

    def test_production_waits_for_the_dry_run_slice(self, tmp_path, monkeypatch):
        """``--production`` is the dry run of the train step on the
        production mesh (JAX's flag), which the dry-run slice brought: the
        smoke config at a small shape here, its cell written."""
        from repro_torch.configs import SHAPES, ShapeConfig, get_smoke_config
        from repro_torch.launch import dryrun, steps
        SHAPES.setdefault("trainer_dry_train", ShapeConfig("trainer_dry_train", 16, 32, "train"))
        monkeypatch.setattr(steps, "get_config", get_smoke_config)
        monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
        assert train.main(["--arch", "llama3_8b", "--production",
                           "--shape", "trainer_dry_train"]) == 0
        cell = json.loads(dryrun.cell_path("llama3_8b", "trainer_dry_train", False).read_text())
        assert cell["status"] == "ok" and cell["n_chips"] == 256

    def test_default_device_is_cuda(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device works")
        with pytest.raises(RuntimeError, match="cuda"):
            train.main(["--arch", "llama3_8b", "--ckpt-dir", str(tmp_path)])
