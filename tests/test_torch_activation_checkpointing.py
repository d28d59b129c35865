"""Port parity for activation checkpointing
(``deepspeed_tpu_torch/runtime/activation_checkpointing.py``): the JAX
package's ``tests/unit/test_activation_checkpointing.py`` cases (11) on the
port, each also against the JAX module on the same numpy inputs, plus what
each policy keeps and recomputes.

Tolerances: a checkpointed function against the same function
uncheckpointed runs the same fp32 ops, so bit for bit; against JAX within
1e-5 relative (XLA's fusion and summation order). ``CheckpointableRNG``'s
keys are JAX's bit for bit (threefry in both)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from deepspeed_tpu.config.config import \
    ActivationCheckpointingConfig as JaxACConfig
from deepspeed_tpu.runtime import activation_checkpointing as jac
from deepspeed_tpu_torch.config.config import (ActivationCheckpointingConfig,
                                               Config)
from deepspeed_tpu_torch.runtime import activation_checkpointing as ac
from deepspeed_tpu_torch.utils import random as trandom


@pytest.fixture(autouse=True)
def _reset_ac():
    yield
    ac.reset()
    jac.reset()


def _np_params(seed=0, d=16):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal((d, d)) * 0.1).astype(np.float32)
            for k in ("w1", "w2")}


def _mlp_t(params, x):
    h = torch.tanh(x @ params["w1"])
    return torch.sum((h @ params["w2"]) ** 2)


def _mlp_j(params, x):
    h = jnp.tanh(x @ params["w1"])
    return jnp.sum((h @ params["w2"]) ** 2)


def _x(shape=(4, 16), seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _grads(fn, params, *args):
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    g = torch.autograd.grad(fn(p, *args), list(p.values()))
    return dict(zip(p, g))


def _jax_close(got, jgrads):
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jgrads[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


class TestCheckpoint:
    def test_grad_matches_uncheckpointed(self):
        params, x = _np_params(), _x()
        ref = _grads(_mlp_t, params, torch.tensor(x))
        got = _grads(lambda p, x_: ac.checkpoint(_mlp_t, p, x_), params,
                     torch.tensor(x))
        for k in ref:
            assert torch.equal(got[k], ref[k]), k
        _jax_close(got, jax.grad(_mlp_j)(params, jnp.asarray(x)))

    def test_policies_resolve(self):
        for name in ("nothing_saveable", "dots_saveable", "checkpoint_dots",
                     "dots_with_no_batch_dims_saveable",
                     "checkpoint_dots_with_no_batch_dims",
                     "everything_saveable"):
            cfg = ActivationCheckpointingConfig(policy=name)
            assert ac.resolve_policy(cfg) is not None
            jac.resolve_policy(JaxACConfig(policy=name))   # JAX knows it
        with pytest.raises(ValueError):
            ac.resolve_policy(ActivationCheckpointingConfig(policy="bogus"))
        assert ac.resolve_policy(ActivationCheckpointingConfig()) is \
            ac.nothing_saveable

    def test_cpu_checkpointing_policy(self):
        """The offloading policy: its kept products live in host memory
        between the forward and the recompute; gradients equal the
        uncheckpointed function's (the JAX twin of this case needs a
        host memory space the CPU backend lacks: ROADMAP C)."""
        cfg = ActivationCheckpointingConfig(cpu_checkpointing=True)
        pol = ac.resolve_policy(cfg)
        assert callable(pol) and pol.offload
        params, x = _np_params(), _x((2, 4, 16))
        ref = _grads(_mlp_t, params, torch.tensor(x))
        ac.configure(cpu_checkpointing=True)
        got = _grads(lambda p, x_: ac.checkpoint(_mlp_t, p, x_), params,
                     torch.tensor(x))
        for k in ref:
            assert torch.equal(got[k], ref[k]), k

    def test_configure_kwargs(self):
        cfg = ac.configure(policy="dots_saveable")
        assert cfg.policy == "dots_saveable" and ac.is_configured()
        assert ac.get_config().policy == "dots_saveable"
        with pytest.raises(ValueError):
            ac.configure(not_a_knob=True)
        # the engine's config carries the sub-tree for the user to pass on
        c = Config.load({"train_batch_size": 2, "activation_checkpointing": {
            "number_checkpoints": 2, "policy": "dots_saveable"}})
        assert ac.configure(c.activation_checkpointing).number_checkpoints \
            == 2

    def test_rng_determinism_with_dropout(self):
        """A threefry mask inside the checkpointed function: the recompute
        draws it again from the same key; the grads equal the JAX
        function's with ``jax.random.bernoulli`` under the same key."""
        def dropped_t(params, x, key):
            h = torch.tanh(x @ params["w1"])
            mask = trandom.bernoulli(key, 0.5, h.numel()).view(h.shape)
            return torch.sum(((h * mask) @ params["w2"]) ** 2)

        def dropped_j(params, x, key):
            h = jnp.tanh(x @ params["w1"])
            mask = jax.random.bernoulli(key, 0.5, h.shape)
            return jnp.sum(((h * mask) @ params["w2"]) ** 2)

        params, x = _np_params(), _x()
        key = trandom.PRNGKey(7)
        ref = _grads(dropped_t, params, torch.tensor(x), key)
        got = _grads(lambda p, x_, k: ac.checkpoint(dropped_t, p, x_, k),
                     params, torch.tensor(x), key)
        for k in ref:
            assert torch.equal(got[k], ref[k]), k
        _jax_close(got, jax.grad(dropped_j)(params, jnp.asarray(x),
                                            jax.random.PRNGKey(7)))


class TestCheckpointSequential:
    @staticmethod
    def _stack(n_layers=4, d=8):
        rng = np.random.default_rng(0)
        return (rng.standard_normal((n_layers, d, d)) * 0.1).astype(
            np.float32)

    @staticmethod
    def _block_t(p, h):
        return h + torch.tanh(h @ p["w"])

    @staticmethod
    def _block_j(p, h):
        return h + jnp.tanh(h @ p["w"])

    def _ref_apply(self, stacked, x):
        h = x
        for i in range(stacked["w"].shape[0]):
            h = self._block_t({"w": stacked["w"][i]}, h)
        return h

    @pytest.mark.parametrize("interval", [1, 2, 4])
    def test_matches_loop(self, interval):
        w, x = self._stack(), _x((4, 8))
        s = {"w": torch.tensor(w, requires_grad=True)}
        out = ac.checkpoint_sequential(self._block_t, s, torch.tensor(x),
                                       interval=interval)
        ref = self._ref_apply(s, torch.tensor(x))
        assert torch.equal(out, ref)
        g = torch.autograd.grad(out.sum(), s["w"])[0]
        g_ref = torch.autograd.grad(ref.sum(), s["w"])[0]
        assert torch.equal(g, g_ref)
        jout, jg = jax.value_and_grad(lambda s_, x_: jnp.sum(
            jac.checkpoint_sequential(self._block_j, s_, x_,
                                      interval=interval)))(
            {"w": jnp.asarray(w)}, jnp.asarray(x))
        np.testing.assert_allclose(out.sum().item(), float(jout), rtol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(jg["w"]),
                                   rtol=1e-5, atol=1e-6)

    def test_bad_interval(self):
        s = {"w": torch.tensor(self._stack(n_layers=4))}
        with pytest.raises(ValueError):
            ac.checkpoint_sequential(self._block_t, s, torch.ones(2, 8),
                                     interval=3)


class TestRNGTracker:
    def test_fork_deterministic(self):
        t1 = ac.CheckpointableRNG(seed=0)
        t2 = ac.CheckpointableRNG(seed=0)
        k1, k2 = t1.fork(), t2.fork()
        assert torch.equal(k1, k2)
        k1b = t1.fork()
        assert not torch.equal(k1b, k1)
        # JAX's tracker forks the same keys (crc32 seed, split)
        jt = jac.CheckpointableRNG(seed=0)
        for want in (k1, k1b):
            np.testing.assert_array_equal(np.asarray(jt.fork()),
                                          want.numpy())
        jt3, t3 = jac.CheckpointableRNG(seed=3), ac.CheckpointableRNG(seed=3)
        np.testing.assert_array_equal(np.asarray(jt3.fork("other")),
                                      t3.fork("other").numpy())

    def test_states_roundtrip(self):
        t = ac.CheckpointableRNG()
        t.add("extra", 3)
        states = t.get_states()
        t.fork("extra")
        t.set_states(states)
        k_after = t.fork("extra")
        t.set_states(states)
        assert torch.equal(k_after, t.fork("extra"))
        with pytest.raises(ValueError):
            t.add("extra", 4)
        assert isinstance(ac.get_cuda_rng_tracker(), ac.CheckpointableRNG)


# --------------------------------------------- what each policy recomputes


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                    torch.ops.aten.bmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name,recomputed", [
    ("nothing_saveable", 4), ("dots_saveable", 0),
    ("dots_with_no_batch_dims_saveable", 2), ("everything_saveable", 0),
    ("cpu_checkpointing", 2)])
def test_policy_keeps_what_the_jax_policy_saves(name, recomputed):
    """A function of two products without batch dims (``mm``) and two
    batched ones (``bmm``): the products its backward recomputes under
    each policy, beyond the uncheckpointed backward's own, and gradients
    equal to the uncheckpointed function's."""
    def fn(p, x):
        h = torch.tanh(x @ p["w1"])                        # mm
        a = torch.bmm(h, h.transpose(1, 2))                # bmm
        return torch.sum((torch.tanh(a) @ h @ p["w2"]) ** 2)  # bmm, mm

    params, x = _np_params(d=8), torch.tensor(_x((2, 4, 8)))
    cfg = ActivationCheckpointingConfig(
        cpu_checkpointing=True) if name == "cpu_checkpointing" else \
        ActivationCheckpointingConfig(policy=name)
    pol = ac.resolve_policy(cfg)
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    counts = []
    for run in (lambda: fn(p, x), lambda: ac.checkpoint(fn, p, x,
                                                        policy=pol)):
        loss = run()
        with _CountMM() as c:
            g = torch.autograd.grad(loss, list(p.values()))
        counts.append((c.n, g))
    (n_ref, g_ref), (n, g) = counts
    assert n - n_ref == recomputed
    for a, b in zip(g, g_ref):
        assert torch.equal(a, b)


def test_number_checkpoints_sets_the_interval():
    """``number_checkpoints`` regions over the layers: the largest
    interval dividing them with at least that many regions (4 over 14
    gives 2, as in the JAX package); the stack's result is unchanged."""
    w = torch.tensor(TestCheckpointSequential._stack(n_layers=14))
    calls = []

    def block(p, h):
        calls.append(1)
        return h + torch.tanh(h @ p)

    ac.configure(number_checkpoints=4)
    x = torch.tensor(_x((2, 8))).requires_grad_()
    out = ac.checkpoint_sequential(block, w, x)
    calls.clear()
    out.sum().backward()
    # interval 2: each of the 7 units recomputes its 2 blocks
    assert len(calls) == 14
    ac.configure(number_checkpoints=14)
    ref = ac.checkpoint_sequential(block, w, x)
    assert torch.equal(out, ref)


def test_model_parallel_reshard_on_one_rank(monkeypatch):
    x = torch.ones(2, 3)
    assert ac.model_parallel_reshard(x, None) is x
    import torch.distributed as dist
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
    with pytest.raises(NotImplementedError, match="A8"):
        ac.model_parallel_reshard(x, None)
