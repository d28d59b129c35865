"""Port parity for the prefix cache's host state and the SplitFuse
scheduler, against the JAX package on the CPU.

- Fault C5: the JAX scheduler and the port's, given the same sequences,
  cut the same ``(uid, tokens, start_pos)`` items step for step, at the
  Llama-2-7B serve example's ``chunk_size=512, max_seqs=64`` (the
  256-token ``prefill_chunk_cap`` and the 32768-token budget) and at
  ``chunk_size=8, prefill_chunk_cap=4``; the JAX ``TestPrefillChunkCap``
  cases on the port.
- The two-tier cache: the JAX ``PrefixCache`` + ``BlockedKVCache`` +
  ``StateManager`` and the port's run one seeded random sequence of
  admissions with prefix matches, chunked prefills, registrations,
  decode growth, EOS-style trims, speculative-style rounds, reserve
  pressure, demotion materializes and flushes, for both policies, with
  the cache cap and the host tier each on and off. After every operation
  the match plans, block tables, free lists, ``stats`` and the
  invariants are equal, and every live sequence's prompt rows (written as
  a function of the token chain, so a shared, copied, demoted or promoted
  block carries exactly what a fresh prefill would) read the same in both
  pools.
- The data paths alone: a demotion and promotion round trip (fp32 and
  int8 rows with scales), a promotion from a demotion not yet
  materialized, pause's offload and restore, the CoW copy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import BlockedKVCache as JaxKV
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import PrefixCache as JaxPC
from deepspeed_tpu.inference.v2 import RaggedInferenceConfig as JaxRagged
from deepspeed_tpu.inference.v2 import StateManager as JaxSM
from deepspeed_tpu.inference.v2.blocked_allocator import \
    OutOfBlocksError as JaxOOB
from deepspeed_tpu.inference.v2.scheduler import \
    SplitFuseScheduler as JaxScheduler
from deepspeed_tpu_torch.inference.v2 import (BlockedKVCache, PrefixCache,
                                              RaggedInferenceConfig,
                                              StateManager)
from deepspeed_tpu_torch.inference.v2.blocked_allocator import \
    OutOfBlocksError
from deepspeed_tpu_torch.inference.v2.scheduler import SplitFuseScheduler

BS = 4                      # block size of the host-state cases
CHUNK = 8                   # rows a test prefill writes at most


# --------------------------------------------------------------------- #
# fault C5: the scheduler's chunk and budget
# --------------------------------------------------------------------- #


def _sched_pair(**kw):
    """The JAX and the port's scheduler over their own state managers."""
    out = []
    for Cfg, KV, SM, Sched, kvkw in (
            (JaxRagged, JaxKV, JaxSM, JaxScheduler,
             dict(dtype=jnp.float32)),
            (RaggedInferenceConfig, BlockedKVCache, StateManager,
             SplitFuseScheduler, dict(dtype=torch.float32, device="cpu"))):
        cfg = Cfg(dtype="float32", **kw)
        sm = SM(cfg, KV(cfg, 1, 1, 4, **kvkw))
        out.append((cfg, sm, Sched(cfg, sm)))
    return out


def _items(sched):
    return [(it.seq.uid, list(it.tokens), it.start_pos, it.is_last_chunk)
            for it in sched]


@pytest.mark.parametrize("kw,lens", [
    (dict(max_seqs=64, chunk_size=512, block_size=64, num_blocks=1400,
          max_blocks_per_seq=16), [512] * 64 + [1000, 700, 1, 1, 300]),
    (dict(max_seqs=4, chunk_size=8, block_size=4, num_blocks=64,
          max_blocks_per_seq=16, prefill_chunk_cap=4), [21, 7, 1, 13, 2]),
])
def test_scheduler_items_equal_jax_step_for_step(kw, lens):
    """Fault C5: the port cut chunks at ``chunk_size`` with a budget of
    ``max_seqs x chunk_size``; the JAX scheduler cuts at
    ``effective_chunk`` within ``token_budget``. Same sequences, same
    items, every step until all work is consumed (decode rows of one
    token ride along; aging reorders the late prefills)."""
    (jcfg, jsm, js), (tcfg, tsm, ts) = _sched_pair(**kw)
    rng = np.random.default_rng(len(lens))
    for uid, n in enumerate(lens):
        toks = rng.integers(1, 500, n).tolist()
        jsm.put_tokens(uid, toks)
        tsm.put_tokens(uid, toks)
    steps = 0
    while True:
        want, got = _items(js.schedule()), _items(ts.schedule())
        assert got == want, f"step {steps}"
        if not want:
            break
        assert max(len(t) for _, t, _, _ in want) <= jcfg.effective_chunk
        jsm.step += 1
        tsm.step += 1
        steps += 1
    assert steps > 1
    assert [(s.seen_tokens, s.kv_blocks) for s in tsm.sequences.values()] \
        == [(s.seen_tokens, s.kv_blocks) for s in jsm.sequences.values()]
    assert (tcfg.effective_chunk, tcfg.token_budget) \
        == (jcfg.effective_chunk, jcfg.token_budget)


def test_effective_chunk_and_budget_are_jax_properties():
    for kw in (dict(), dict(chunk_size=512), dict(chunk_size=512,
                                                  prefill_chunk_cap=0),
               dict(chunk_size=8, prefill_chunk_cap=4),
               dict(max_seqs=64, chunk_size=512),
               dict(max_seqs=64, chunk_size=512, max_batch_tokens=0),
               dict(max_seqs=2, chunk_size=64, max_batch_tokens=100)):
        j, t = JaxRagged(**kw), RaggedInferenceConfig(**kw)
        assert (t.effective_chunk, t.token_budget) \
            == (j.effective_chunk, j.token_budget), kw
    with pytest.raises(ValueError, match="prefill_chunk_cap"):
        RaggedInferenceConfig(prefill_chunk_cap=-1)


def test_scheduler_respects_cap():
    """JAX ``TestPrefillChunkCap.test_scheduler_respects_cap``."""
    cfg = RaggedInferenceConfig(max_seqs=4, chunk_size=8, block_size=4,
                                num_blocks=64, max_blocks_per_seq=16,
                                dtype="float32", prefill_chunk_cap=4)
    sm = StateManager(cfg, BlockedKVCache(cfg, 2, 2, 16, torch.float32,
                                          device="cpu"))
    sm.put_tokens(1, range(20))
    items = SplitFuseScheduler(cfg, sm).schedule()
    assert max(len(it.tokens) for it in items) == 4


def test_capped_prefill_matches_uncapped_and_jax():
    """JAX ``TestPrefillChunkCap.test_capped_prefill_matches_uncapped``
    on the tiny Llama: the prefill logits with 4-token chunks equal the
    uncapped 8-token chunks' and the JAX engine's at the same cap."""
    import jax
    from deepspeed_tpu.models import llama as jllama
    from deepspeed_tpu_torch.checkpoint import llama_params_from_numpy
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models.llama import LlamaConfig
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32)
    _, init_fn, _ = jllama.make_model(jcfg)
    jparams = init_fn(jax.random.PRNGKey(0), seq_len=16)
    tree = jax.tree.map(np.asarray, jparams)
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    params = llama_params_from_numpy(tree, cfg, device="cpu",
                                     dtype=torch.float32)
    kw = dict(max_seqs=4, chunk_size=8, block_size=4, num_blocks=64,
              max_blocks_per_seq=16, dtype="float32",
              attention_impl="dense")
    rng = np.random.default_rng(31)
    prompts = {0: rng.integers(1, 512, 21).tolist(),
               1: rng.integers(1, 512, 7).tolist()}
    outs = {}
    for cap in (0, 4):
        eng = InferenceEngineV2(cfg, params, RaggedInferenceConfig(
            prefill_chunk_cap=cap, **kw), device="cpu")
        outs[cap] = eng.put(list(prompts), list(prompts.values()))
        assert sum(eng.runner.step_counts.values()) == (3 if cap == 0
                                                        else 6)
    want = JaxEngine(jcfg, jparams, JaxRagged(prefill_chunk_cap=4, **kw)) \
        .put(list(prompts), list(prompts.values()))
    for uid in prompts:
        np.testing.assert_allclose(outs[4][uid], outs[0][uid], atol=2e-4,
                                   rtol=2e-4)
        np.testing.assert_allclose(outs[4][uid], want[uid], atol=1e-4,
                                   rtol=1e-4)


# --------------------------------------------------------------------- #
# the two-tier prefix cache: the JAX host state against the port's
# --------------------------------------------------------------------- #


def _chain_value(toks, p):
    """The 'KV' a fresh prefill writes at position p: a function of the
    whole chain up to p, so reuse is right only if the chain agrees."""
    return float(hash(tuple(toks[:p + 1])) % 9973)


class _Side:
    """One package's cache stack, wired as its engine wires it, with a
    [1, 2, slots, 4] fp32 pool the test writes chain values into."""

    def __init__(self, jax_side, num_blocks, host, cap, policy):
        self.jax = jax_side
        kw = dict(max_seqs=4, chunk_size=CHUNK, block_size=BS,
                  num_blocks=num_blocks, max_blocks_per_seq=8,
                  dtype="float32", prefix_cache=True,
                  prefix_cache_max_blocks=cap, prefix_cache_policy=policy,
                  prefix_cache_host_blocks=host)
        if jax_side:
            self.cfg = JaxRagged(**kw)
            self.kv = JaxKV(self.cfg, 1, 1, 4, jnp.float32)
            self.pc = JaxPC(BS, max_blocks=cap, policy=policy,
                            host_blocks=host)
            self.kv.attach_prefix_cache(self.pc)
            self.box = {"pool": self.kv.pool}
            self.kv.attach_pool_source(lambda: self.box["pool"])
            self.sm = JaxSM(self.cfg, self.kv)
            self.oob = JaxOOB
        else:
            self.cfg = RaggedInferenceConfig(**kw)
            self.kv = BlockedKVCache(self.cfg, 1, 1, 4, torch.float32,
                                     device="cpu")
            self.pc = PrefixCache(BS, max_blocks=cap, policy=policy,
                                  host_blocks=host)
            self.kv.attach_prefix_cache(self.pc)
            self.sm = StateManager(self.cfg, self.kv)
            self.oob = OutOfBlocksError
        self.sm.prefix = self.pc
        self.trash = num_blocks * BS + BS - 1
        self.live = {}

    def dispatch(self, plan):
        """The engine's half of a match: CoW copies and promotions."""
        if self.jax:
            for buf, dst in plan.promotes:
                self.box["pool"] = self.kv.promote_block(self.box["pool"],
                                                         buf, dst)
            for src, dst in plan.copies:
                self.box["pool"] = self.kv.copy_block(self.box["pool"],
                                                      src, dst)
        else:
            for src, dst in plan.copies:
                self.kv.copy_block(src, dst)
            if plan.promotes:
                self.kv.promote_blocks(plan.promotes)

    def write(self, seq, toks, lo, hi):
        """Prefill positions lo..hi-1 of seq: chain values into its rows
        (a fixed-width scatter, padded with the trash row)."""
        idx = [seq.kv_blocks[p // BS] * BS + p % BS for p in range(lo, hi)]
        vals = [_chain_value(toks, p) for p in range(lo, hi)]
        idx += [self.trash] * (CHUNK - len(idx))
        vals += [0.0] * (CHUNK - len(vals))
        rows = np.repeat(np.asarray(vals, np.float32)[:, None], 4, 1)
        if self.jax:
            # (advanced indices separated by a slice: their dim first)
            self.box["pool"] = self.box["pool"].at[0, :, np.asarray(idx)] \
                .set(jnp.asarray(rows)[:, None])
        else:
            self.kv.data[0, :, torch.tensor(idx)] = \
                torch.from_numpy(rows)[None]

    def rows(self, seq, n):
        pool = np.asarray(self.box["pool"]) if self.jax \
            else self.kv.data.numpy()
        idx = [seq.kv_blocks[p // BS] * BS + p % BS for p in range(n)]
        return pool[0][:, idx][:, :, 0]

    def state(self):
        seqs = {u: (s.seen_tokens, list(s.kv_blocks), sorted(s.shared),
                    s.in_flight) for u, s in self.sm.sequences.items()}
        return (seqs, self.kv.allocator.free_list(), dict(self.pc.stats),
                self.pc.cached_blocks, self.pc.host_cached_blocks,
                self.pc.evictable_blocks, self.kv.free_blocks,
                dict(self.sm.prefix_stats))


def _plan_key(plan):
    return (list(plan.copies), [d for _, d in plan.promotes],
            plan.promoted_blocks)


@pytest.mark.parametrize("host", [0, 6])
@pytest.mark.parametrize("cap", [0, 10])
@pytest.mark.parametrize("policy", ["lru", "fifo"])
@pytest.mark.parametrize("seed", [0, 1])
def test_random_block_lifecycle_equals_jax(seed, policy, cap, host):
    rng = np.random.default_rng(seed * 100 + cap + host)
    num_blocks = 24
    sides = [_Side(True, num_blocks, host, cap, policy),
             _Side(False, num_blocks, host, cap, policy)]
    toks_of = {}
    next_uid = [0]
    # shared preambles (a system prompt) make chains recur: full-block
    # hits, CoW tails, and promotions of demoted chains
    pres = [rng.integers(0, 3, n).tolist() for n in (9, 12, 6)]

    def each(fn):
        outs = [fn(s) for s in sides]
        assert outs[0] == outs[1]
        return outs[0]

    def new_seq():
        uid = next_uid[0]
        next_uid[0] += 1
        if rng.random() < 0.7:
            toks = pres[int(rng.integers(0, 3))] \
                + rng.integers(0, 3, int(rng.integers(1, 9))).tolist()
        else:
            toks = rng.integers(0, 3, int(rng.integers(2, 21))).tolist()
        chunks = [int(c) for c in rng.integers(1, CHUNK + 1, 32)]
        toks_of[uid] = toks

        def run(side):
            seq = side.sm.put_tokens(uid, toks)
            plan = side.sm.match_prefix(seq)
            side.dispatch(plan)
            out = [_plan_key(plan), seq.seen_tokens]
            for c in chunks:
                if not seq.in_flight:
                    break
                c = min(c, seq.in_flight)
                try:
                    side.sm.ensure_blocks(seq, c)
                except side.oob:
                    side.sm.flush(uid)
                    return out + ["dropped"]
                side.write(seq, toks, seq.seen_tokens, seq.seen_tokens + c)
                del seq.pending_tokens[:c]
                seq.seen_tokens += c
            side.sm.register_prefix(seq)
            side.live[uid] = seq
            return out
        each(run)

    def grow(uid, n, trim_to=None):
        def run(side):
            seq = side.live[uid]
            try:
                side.sm.ensure_blocks(seq, n)
            except side.oob:
                return "oob"
            if trim_to is not None:
                seq.seen_tokens = trim_to(seq)
                return side.sm.trim_blocks(seq)
            return None
        each(run)

    def pressure(want):
        def run(side):
            try:
                held = side.kv.reserve(want)
            except side.oob:
                return "oob"
            side.kv.free(held)
            return sorted(held)
        each(run)

    def flush(uid):
        def run(side):
            side.sm.flush(uid)
            del side.live[uid]
        each(run)

    def check():
        each(lambda side: side.state())
        for side in sides:
            side.pc.check_invariants()
            side.pc.assert_exact_refs(side.live.values())
        for uid, jseq in sides[0].live.items():
            n = min(jseq.seen_tokens, len(toks_of[uid]))
            want = np.asarray([_chain_value(toks_of[uid], p)
                               for p in range(n)], np.float32)
            for side in sides:
                got = side.rows(side.live[uid], n)
                assert np.array_equal(got, np.stack([want, want])), uid

    for _ in range(160):
        op = int(rng.integers(0, 7))
        live = sorted(sides[0].live)
        if op == 0 or not live:
            new_seq()
        elif op == 1:
            uid = int(rng.choice(live))
            grow(uid, int(rng.integers(1, 9)))
            # decode growth: the positions are past the prompt
            for side in sides:
                s = side.live[uid]
                s.seen_tokens = min(len(s.kv_blocks) * BS,
                                    s.seen_tokens + 1)
        elif op == 2:
            uid = int(rng.choice(live))
            L = int(rng.integers(2, 8))
            acc = int(rng.integers(1, L + 1))
            grow(uid, L, trim_to=lambda s, a=acc: s.seen_tokens + a)
        elif op == 3:
            uid = int(rng.choice(live))
            keep = int(rng.integers(0, 5))
            grow(uid, 0, trim_to=lambda s, k=keep: max(
                s.prompt_len, s.seen_tokens - k))
        elif op == 4:
            pressure(int(rng.integers(1, num_blocks)))
        elif op == 5:
            each(lambda side: side.kv.finalize_demotions())
        else:
            flush(int(rng.choice(live)))
        check()
    for uid in sorted(sides[0].live):
        flush(uid)
    check()
    # drain: destroy the device tier; every block is back
    for side in sides:
        side.kv.allocator.free(side.pc.evict(num_blocks))
    check()
    assert sides[1].kv.allocator.free_blocks == num_blocks


# --------------------------------------------------------------------- #
# the data paths alone
# --------------------------------------------------------------------- #


def _port_stack(dtype=None, num_blocks=8, host=16):
    cfg = RaggedInferenceConfig(
        max_seqs=4, chunk_size=8, block_size=BS, num_blocks=num_blocks,
        max_blocks_per_seq=8, dtype="float32", prefix_cache=True,
        kv_cache_dtype="int8" if dtype == "int8" else "auto",
        prefix_cache_host_blocks=host)
    kv = BlockedKVCache(cfg, 2, 2, 4, torch.float32, device="cpu")
    pc = PrefixCache(BS, host_blocks=host)
    kv.attach_prefix_cache(pc)
    sm = StateManager(cfg, kv)
    sm.prefix = pc
    return cfg, kv, pc, sm


def _prefill(sm, seq):
    n = seq.in_flight
    sm.ensure_blocks(seq, n)
    del seq.pending_tokens[:n]
    seq.seen_tokens += n


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("materialize", [True, False])
def test_promotion_restores_exact_content(kv_dtype, materialize):
    """Rows (and int8 codes with their scales) written before a demotion
    come back bit-identical after the gather, host copy and promotion
    scatter, whether the promotion reads the host copy (materialized) or
    the pending device gather (JAX
    ``test_promotion_restores_exact_content`` and
    ``test_pending_device_promotion_no_materialize``)."""
    cfg, kv, pc, sm = _port_stack(kv_dtype)
    s0 = sm.put_tokens(0, [1, 2, 3, 4, 5])
    sm.match_prefix(s0)
    _prefill(sm, s0)
    blk = s0.kv_blocks[0]
    sl = slice(blk * BS, (blk + 1) * BS)
    g = torch.Generator().manual_seed(7)
    if kv.quantized:
        kv.data[:, :, sl] = torch.randint(-127, 128, kv.data[:, :, sl].shape,
                                          generator=g, dtype=torch.int8)
        kv.scales[..., sl] = torch.rand(kv.scales[..., sl].shape,
                                        generator=g)
    else:
        kv.data[:, :, sl] = torch.randn(kv.data[:, :, sl].shape,
                                        generator=g)
    want = kv.data[:, :, sl].clone()
    want_s = kv.scales[..., sl].clone() if kv.quantized else None
    sm.register_prefix(s0)
    sm.flush(0)
    held = kv.reserve(cfg.num_blocks)          # forces the demotion
    assert pc.host_cached_blocks == 1 and pc.stats["demoted"] == 1
    kv.data[:, :, sl] = 0                      # the block is reused
    if materialize:
        kv.finalize_demotions()
        assert not kv._pending_host
    else:
        assert kv._pending_host
    kv.free(held)
    s1 = sm.put_tokens(1, [1, 2, 3, 4, 5])
    plan = sm.match_prefix(s1)
    assert len(plan.promotes) == 1 and plan.promoted_blocks == 1
    buf, dst = plan.promotes[0]
    kv.promote_block(buf, dst)
    d = slice(dst * BS, (dst + 1) * BS)
    assert torch.equal(kv.data[:, :, d], want)
    if kv.quantized:
        assert torch.equal(kv.scales[..., d], want_s)
    pc.check_invariants()
    pc.assert_exact_refs([s1])


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_offload_restore_and_cow_copy_move_scales_with_rows(kv_dtype):
    cfg, kv, pc, sm = _port_stack(kv_dtype)
    g = torch.Generator().manual_seed(3)
    if kv.quantized:
        kv.data.copy_(torch.randint(-127, 128, kv.data.shape, generator=g,
                                    dtype=torch.int8))
        kv.scales.copy_(torch.rand(kv.scales.shape, generator=g))
    else:
        kv.data.copy_(torch.randn(kv.data.shape, generator=g))

    def block(t, b, axis):
        return t.narrow(axis, b * BS, BS).clone()
    blocks = [5, 2, 6]
    want = [block(kv.data, b, 2) for b in blocks]
    want_s = [block(kv.scales, b, 3) for b in blocks] if kv.quantized \
        else None
    host = kv.offload(blocks)
    assert host[0].shape == (3, 2, 2, BS, 8)
    assert (host[1] is not None) == kv.quantized
    kv.data.zero_()
    kv.restore(host, [0, 7, 3])
    for w, b in zip(want, [0, 7, 3]):
        assert torch.equal(block(kv.data, b, 2), w)
    if kv.quantized:
        for w, b in zip(want_s, [0, 7, 3]):
            assert torch.equal(block(kv.scales, b, 3), w)
    kv.copy_block(7, 1)
    assert torch.equal(block(kv.data, 1, 2), want[1])
    if kv.quantized:
        assert torch.equal(block(kv.scales, 1, 3), want_s[1])
    with pytest.raises(ValueError, match="blocks"):
        kv.restore(host, [0, 1])


def test_acquire_on_host_entry_raises():
    cfg, kv, pc, sm = _port_stack()
    s0 = sm.put_tokens(0, [1, 2, 3, 4, 5])
    sm.match_prefix(s0)
    _prefill(sm, s0)
    sm.register_prefix(s0)
    sm.flush(0)
    kv.free(kv.reserve(cfg.num_blocks))
    entry = next(iter(pc._roots.values()))
    assert entry.tier == "host"
    with pytest.raises(RuntimeError, match="promote it first"):
        pc.acquire(entry)
