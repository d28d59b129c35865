#!/usr/bin/env python3
"""chip_smoke.py — the port's quickest proof that it runs on an NVIDIA card.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the final line:

1. build   — compile the CUDA kernels from ``deepspeed_tpu_torch/ops/
             kernels/csrc`` (nvcc, sm_90a) and print ptxas's summary.
2. parity  — both paged-attention kernels against their plain PyTorch
             version at TinyLlama width (H=32, KV=4, D=64): K1 on 4 slots x
             256-token chunks (bf16: the wgmma kernel, K/V by TMA at block
             64 and by the cp.async gather at block 16, with a window and
             an idle slot), K2 on 16 slots with contexts up to 2048, in
             the multi-block (block_size 64) and linear (one block per
             sequence) layouts, and on 16 slots with contexts up to 8192
             (several context splits, each K2 case printing its
             ``decode_plan``), once with a 700-key window whose edge falls
             inside a split; bf16 within 8e-3 max-abs and 2**-8 of the
             plain output's norm, fp32 within 1e-4; every case also
             bit-identical between two calls. Only the bf16 cases
             reach the tensor-core kernels (K1's, and K2's split kernel);
             fp32 runs CUDA-core kernels of its own, so
             phase 4 does not cover the former.
3. serving — TinyLlama-1.1B shape, all 22 layers, bf16, seeded random
             weights made on the card: 16 prompts x 512 tokens through
             ``InferenceEngineV2.generate`` (chunk 256, block 64, decode
             loop 16), 64 new tokens each. Launch counters must equal
             layers x steps of each kind.
4. engine  — fp32 at full width with TF32 off: 4 prompts x 128 tokens, 16
             new tokens, paged kernels token-identical to the dense path;
             engine prefill logits against the full-sequence forward.
5. timing  — each kernel at the serving shapes (CUDA events), its plain
             version, ``F.scaled_dot_product_attention`` on the same live
             K/V as a yardstick, and the bound (bytes over 3.35 TB/s,
             FLOPs over 989 TFLOP/s, the larger), the bound's share of the
             kernel's time and, for K2, its plan (K1: its route and
             ``prefill_plan``); the kernel and SDPA also in a CUDA graph
             (``_graph_ms``: device time without the host's launch
             cost).

6. flash parity — the flash-attention forward and backward against
             their plain PyTorch versions from the same inputs and the
             same dO, each launched once a case (the backward's launches
             by its route: at head dims 64 and 128 in bf16/fp16 the wgmma
             kernel with its prep and cast passes, where dK and dV must
             also come out bit-identical from a second call; in fp32 the
             dq / dkv pair), a seeded lse cotangent in two cases: T=200 (not a
             multiple of the tiles), Tq=128 against Tk=384 (the causal
             offset), GQA 8 -> 2 heads, non-causal, Tq=300 against Tk=200
             with GQA 4 (100 rows with no live key: O = 0 and lse = -inf
             exactly), head_dim 128, the slice shape B=4, T=2048, H=32,
             D=64, and the gpt1p3b heads. bf16 within 1.6e-2 max-abs and
             2**-8 of the plain output's norm, fp16 within 4e-3 and 2**-8
             (both reach the tensor-core kernels: the forward's wgmma one
             at these head dims), fp32 (the CUDA-core parity kernels)
             within 1e-5.
7. training — GPT-2-1.3B (``GPT2Config.xl_1p3b``: 24 layers, hidden
             2048, 32 heads, vocab 50257) at full width and depth, seq
             2048, bf16 compute with fp32 master params, seeded weights
             made on the card, through ``initialize`` / ``train_batch``:
             AdamW (lr 1e-4, weight decay 0.01), WarmupLR, clipping 1.0,
             micro batch 4 x gas 2 on one seeded [8, 2049] batch; 2
             warm-up steps, then 5 timed steps (CUDA events and host
             wall). The 7 losses must be finite and fall; the launches of
             the flash forward and of each kernel of the backward's route
             must equal layers x gas x timed steps, the other route's 0.
8. training parity — 2 layers at full width, seq 512, 5 steps on one
             batch: the kernels' loss trajectory against the plain
             versions' (swapped in for this comparison only), bf16 within
             1e-4 relative, fp32 with TF32 off within 1e-6 relative
             (about ten times the first readings, 1.1e-5 and 8.4e-8).
9. flash timing — the flash forward and the whole backward (prep, main
             kernel, cast: ``flash_bwd``) at the slice shape (CUDA events,
             and in a CUDA graph; the backward's three kernels also by
             torch.profiler), their plain versions,
             ``F.scaled_dot_product_attention`` (causal) forward and
             backward (dQ, dK, dV; in a graph: forward and backward
             captured together less the forward), events and graph, on
             the same q/k/v as yardsticks, the bound (the backward's: five products a live
             pair) and the graph time's share of it; both also at the
             gpt1p3b heads (B=2, T=2048, H=16, D=128).
10. xent parity — the three fused-xent kernels against their plain
             versions from the same inputs (the backward from the plain
             forward's lse), each launched once a case: bf16 and fp32
             (the CUDA-core kernels), V =
             50304 and 50257, N = 1000 (not a multiple of the 64-token
             tile) with ignore ids (-100) and an id >= V, z-loss 1e-4 and
             label smoothing 0.1, and the slice shape N = 4096 in bf16.
             fp32, and the logit sum in bf16, within 1e-5 of the plain
             output's norm; bf16 lse and target logit within 1e-3
             absolute, dh and dE within 2**-8 of the plain output's norm
             and XENT_BF16_MAX_REL of its largest magnitude.
11. gpt1p3b — the JAX package's bench configuration (``bench.py``
             ``bench_train("gpt1p3b")``: GPT-2, 24 layers, hidden 2048, 16
             heads of 128, vocab 50304, seq 2048, bf16 params with fp32
             LayerNorms, remat ``qkv_out``, AdamW lr 3e-4 with bf16
             moments, bf16 gradient accumulation, micro batch 2, clip 1.0,
             no scheduler, its seeded batch) at full width and depth with
             ``xent_impl="fused"``: 2 warm-up and 5 timed steps (CUDA
             events); losses finite and falling; launches 1 per step for
             each xent kernel, 2 x 24 for flash_fwd (the ``qkv_out``
             recompute), 24 for each kernel of the flash backward's wgmma
             route. Then the same
             with ``xent_impl="chunked"``: its step-0 loss within 1e-5
             relative of the fused run's, both step times side by side.
12. fused training parity — 2 layers of that configuration, seq 512, 5
             steps on 5 seeded batches: the kernels' losses against the
             plain versions' (xent and flash swapped in), bf16 within 1e-4
             relative, fp32 (params, compute, moments) with TF32 off
             within 1e-6.
13. xent timing — each xent kernel at the slice shape (N = 4096, V =
             50304, C = 2048, bf16; the forward's ``fwd_plan`` printed), by
             CUDA events and in a CUDA graph, its plain version, its bound
             and the graph time's share of it, and two library calls on
             the same h, E and t: ``F.linear`` +
             ``F.cross_entropy(reduction="sum")`` forward (events and
             graph), and its backward (dh and dE together); the peak
             memory of a lone
             ``fused_lm_xent`` forward and backward, which must stay below
             one bf16 [N, V] tensor.
14. woq parity — both group-quantization kernels against their plain
             version (codes, scales and zeros identical): symmetric and
             asymmetric, 8 and 4 bits, fp32 and bf16, groups of 64 and
             128, a [300, 517] tensor (a ragged tail group, an all-zero
             group), the Llama-2-7B [4096, 11008] bf16 leaf, and the
             symmetric kernel on the [4096, 4096] and [11008, 4096] leaves;
             the fp6 GEMM at M = 1, 64, 333, 4096 on the four Llama-2-7B
             weight shapes ([4096, 4096], [4096, 11008], [11008, 4096], LM
             head [4096, 32000]) and K = 1000, N / 4 = 260 (and at M = 128
             and 129, either side of the route threshold, on [11008,
             4096]), bit-identical between two calls, and at the
             serving prefill step's M = 64 x 512 on the three projections
             (bf16), bf16 within FP6_BF16_MAX_ABS and 2**-8 of the plain
             output's norm, fp32 (the CUDA-core kernel) within 1e-5 of
             it; the paged kernels at
             Llama-2-7B's heads (H = KV = 32, D = 128), bf16 within
             PAGED7_BF16_MAX_ABS and 2**-8 of the norm, fp32 within 1e-4.
15. woq serving — Llama-2-7B (``LlamaConfig.llama2_7b``: 32 layers,
             hidden 4096, 32 heads of 128, no GQA, vocab 32000,
             intermediate 11008) at full width and depth, bf16, seeded
             weights made on the card, served as the JAX package's
             example serves it (``examples/llama7b_serve_woq.py:52-89``):
             64 prompts x 512 tokens, 128 new tokens, chunk 512 (prefill in
             two 256-query steps: the 256-token ``prefill_chunk_cap``, as
             the JAX engine cuts it), block 640, one block per sequence, 66
             blocks, decode loop 32, bf16 KV.
             Four runs, one engine alive at a time: bf16; int8 WOQ (group
             128, ``embed``/``norm``/``lm_head`` excluded); int4; fused fp6.
             Each prints its weight bytes, quantize seconds, prefill s,
             decode tok/s (beside the reading of the earlier kernels) and
             peak memory. Launches: 224 ``quantize_sym``
             at each int run's load, 224 ``fp6_matmul`` per step of the fp6
             run, 32 per step of each paged kernel.
16. woq engine — TF32 off, Llama-2-7B width with 2 layers, 4 prompts
             x 128 tokens: each WOQ engine against a dense engine given
             ``dequantize_tree`` of the same tree (the plain version of
             every packed matmul). fp32, 16 new tokens: fused fp6 and int8
             token-identical, fp6 prefill logits within 1e-4 of the norm.
             bf16 fused fp6 (the GEMM's tensor-core kernel, as phase 15
             serves it), prefill and 16 teacher-forced decode steps:
             logits within WOQ_BF16_LOGITS_REL of the norm and
             WOQ_BF16_LOGITS_MAX_ABS.
17. woq timing — ``fp6_matmul`` at M = 64, 256 and 4096 on the three
             Llama-2-7B projection shapes, each call on its own copy of
             the weight (the copies exceed the L2 cache), with its plain
             version, ``torch.matmul`` against the unpacked bf16 weight as
             a yardstick, the bound (a K split's workspace traffic
             counted), its share and the ``fp6_plan`` (route, row tiles,
             K split); the kernel and ``torch.matmul`` also in a CUDA
             graph; the kernels row reports the shape that loses most
             to ``torch.matmul`` there; ``quantize_sym`` / ``quantize_asym``
             on the [4096, 11008] bf16 leaf (no PyTorch call computes
             them), by events, torch.profiler's device time and in a CUDA
             graph, also at 4 bits and at groups of 256, each with its
             ``quant_plan``; the paged kernels at the Llama-2-7B serving
             shapes.

18-21, the ops layer's entry points, each called with its kernel's
launch count at 0 and read just after, at the width of the public model
it serves, then held against the plain version and timed beside its
bound and one library call:
18. norms  — ``fused_rms_norm`` on x [32768, 4096] bf16 (Llama-2-7B's
             hidden over phase 15's 64 x 512-token prefill step) and
             ``fused_layer_norm`` on [8192, 2048] bf16 (GPT2Config.xl_1p3b
             over phase 7's micro batch of 4 x 2048); fp32, a ragged
             [1000, 4100], and each backward (the JAX package's VJP in
             plain PyTorch) against autograd of the plain version;
             ``F.rms_norm`` / ``F.layer_norm`` as the library calls, each
             by events, torch.profiler's device time and in a CUDA graph
             beside the kernel (with its ``norm_plan``); LayerNorm also at
             the Llama / GPT widths 4096 and 8192 over 8192 rows.
19. adamw  — ``fused_adamw_update`` on one flat f32 buffer of
             GPT2Config.xl_1p3b's 1,315,723,264 parameters, 3 steps, p, m
             and v bit-identical to the plain version's after each; a
             ragged n with bf16 gradients; ``torch.optim.AdamW(fused=True)``
             on the same buffers as the library call.
20. sparse — ``sparse_attention(impl="flash")`` at BERT-large's attention
             width (16 heads of 64), B = 4, T = 4096, 128-blocks:
             BSLongformer (window 3, global block 0), BigBird (a layout per
             head) and BSLongformer with one query block cleared (zeros),
             each on the wgmma kernel (``sparse_route`` and
             ``sparse_plan``'s items logged) and bit-identical from a
             second call; BSLongformer in fp16 and at head dim 128 (bf16,
             fp16); fp32 at B = 1; times by events, torch.profiler and a
             CUDA graph beside SDPA on the token-level boolean mask (the
             library call) and the bound's share of the graph time.
21. evoformer — ``DS4Sci_EvoformerAttention`` at AlphaFold 2's
             fine-tuning sizes: MSA row attention with pair bias [1, 512,
             384, 8, 32] and triangle attention [1, 384, 384, 4, 32], -1e9
             mask biases on ~20% of the keys, f32 pair bias; the four bias
             combinations at a ragged S = 300 in bf16 and fp32 with a fully
             masked row; one backward of the MSA case against the plain
             path's gradients; SDPA on [B N, H, S, D] with mask + pair bias
             as ``attn_mask`` as the library call; the kernel in CUDA
             graphs with both biases, the mask bias only and neither (what
             the biases cost), and the pair-bias bytes through L2 that
             ``evo_plan``'s rows a block imply.

22. c1      — fault C1, the inputs the kernels refused before: K1 and K2
             at head dims 16, 32, 80 and 96 and a GQA group of 32 (bf16
             and fp32, against the plain version); a ``LlamaConfig.tiny``
             engine (head_dim 16) and a 2-layer engine at Phi-3-mini's
             widths (head_dim 96) under ``attention_impl="auto"``,
             token-identical to the dense engine (fp32, TF32 off); the
             flash forward and the dq / dkv pair at ``GPT2Config.tiny``'s
             shapes (B 2, H
             4, T 128, head_dim 16, causal) in fp16 and bf16 against their
             plain versions (bf16 FLASH_BF16_MAX_ABS, fp16
             FLASH_FP16_MAX_ABS, both 2**-8 of the norm), then that config
             trained 5 steps in each through the flash kernels against the
             same engine on dense attention (C1_TRAIN_REL);
             ``DS4Sci_EvoformerAttention``
             at head dims 16 and 48 (zero-padded to 64) against its plain
             path. Each check holds its kernel's launch count above 0.
             The dq / dkv pair's kernels-line rows (the backward at head
             dims 16 and 32) come from here: launches of the two tiny
             training runs, times at the tiny shape. Then fault C2
             (``c2_cases``): ``GPT2Config.tiny`` trained 5 steps in fp16
             with ``xent_impl="fused"`` against ``"chunked"``
             (C2_TRAIN_REL), the three xent kernels at hidden 100 (padded
             to 128) in fp32, bf16 and fp16 and at 2048 in fp16 (phase
             10's limits), ``DS4Sci_EvoformerAttention`` in fp16 with each
             bias combination, ``flash_attention`` forward and backward on
             q/k/v views one element into a wider buffer (D 64 and 128,
             bf16 and fp16), and both quantizers in fp16 (codes and scales
             identical), each launch count rising. Then fault C3
             (``c3_cases``): ``flash_attention_sparse`` in fp16 at head
             dims 64 and 128, at 16, 80 and 96 in bf16 and fp16, at 48
             (zero-padded to 64) in all three dtypes, and on q/k/v views
             one element into a wider buffer, each on the route
             ``sparse_route`` names, its launch count rising.

23. kv pool — the int8 and fp16 KV pool, ALiBi and the decode ring
             (fault C4 and the rest of B1). Each K1 route and K2 against
             the plain version, bit-identical from a second call, the
             launch counts of the route and of what the call takes
             (``ROUTE_LAUNCHES``: int8, alibi, ring, fp16) rising: fp16 on
             K1's wgmma (TMA and gather) and mma.sync routes and in K2 at
             GQA 1, 8 and 32; an int8 pool with its scales in bf16, fp16
             and fp32 compute, with and without a window; K2's ring round
             at ring counts 1, 5 and 32 over an int8 pool (and fp16); ALiBi
             at Bloom-7B1's heads (32 of 128) on every route in the three
             dtypes; D 64, 96 and 128. Limits: bf16 8e-3 (1.6e-2 above D
             64), fp16 4e-3, both 2**-8 of the norm; fp32 1e-5. Then
             engine parity at TinyLlama's width with 2 layers (TF32 off),
             4 prompts x 128 tokens, 33 new: an fp32 engine on an int8
             pool with decode loops of 0 and 16 steps (the loop's ring),
             ``paged_flash`` token-identical to ``dense``; an fp16 engine
             on an fp16 pool fed the dense engine's tokens, its prefill
             and decode logits within 2**-8 of the norm of dense's (the
             dense path rounds scores to fp16, the kernels do not, so
             free-running streams may part; their agreement is
             printed). Then Llama-2-7B as phase 15
             serves it (64 x 512-token prompts, 128 new, decode loop 32,
             bf16 weights) from an int8 pool through K1 (mma.sync) and K2
             (split, with the ring's split in each loop step): pool bytes
             (data and scales), prefill s, decode tok/s and peak memory
             beside phase 15's bf16-pool run, the idle share under
             ``--trace``. Then each new variant timed as phase 5 times
             (K2 over int8 at the 7B shape beside K2 over bf16, with its
             bound; K2 with a 16-row ring; K1 over int8 on the 7B prefill
             step; fp16 at phase 5's shapes; ALiBi at Bloom-7B1's heads on
             the 7B shapes), SDPA beside each: over an int8 pool SDPA on
             the same K/V in bf16, a reference only.
24. hf serving — a random checkpoint in HuggingFace's layout with
             Qwen/Qwen2-7B's published config.json at 14 of its 28
             layers (``reduced``: the whole script's time; hidden 3584, 28
             heads, 4 KV heads of 128, biased q/k/v, vocab 152064,
             untied; Qwen2-1.5B's when the temporary space cannot hold
             ~8.7 GB), bf16 tensors made on the card from a
             seed and written one at a time into safetensors shards of at
             most 5 GB with their index, removed at the end. Served
             through ``build_hf_engine``: the load seconds and parameter
             bytes, every loaded leaf bit-identical to the tensor written;
             16 prompts x 512 tokens, 64 new, greedy at pipeline depth 0,
             at depth 2 and through the decode loop, identical streams,
             K1 (wgmma, TMA) and K2 (split) launched 14 times a step (GQA
             7 at D 128); ``decode_pipelined`` with an EOS taken from a
             greedy stream ending there and giving back its blocks;
             sampled streams (temperature 0.8, top-k 50, top-p 0.95)
             identical on the three paths, temperature 0 identical to
             greedy, threefry keys and bits on the card equal to the
             CPU's, and a chi-squared test of the sampler's draws against
             the distribution its masks define on one logits row (p >
             1e-3); the first tokens of a dense-attention engine built
             from the same directory; ``quantization_mode="wf8"``: one
             group-quantizer launch per quantized leaf (98), a few tokens
             served, first tokens against bf16. Prefill s, decode tok/s
             at depths 0 and 2 and peak memory; then K1, K2 and the
             quantizer at this path's shapes against their plain versions
             and timed, as phase 5 times. The directory and the loaded
             parameters stay for phase 25, after which they are removed.
25. prefix serving — the KV block lifecycle on phase 24's Qwen2-7B
             parameters (14 of 28 layers; bf16, block 64, chunk 256,
             ``paged_flash``, 8
             slots, depth 2): six seeded 1000-token system preambles and 48
             requests (a preamble and a 24-200-token tail, 32 new greedy
             tokens) in 6 waves of 8, wave w on preambles 2w and 2w+1 (mod
             6), so waves 4-6 revisit the chains of waves 1-3; a wave is a
             ``put`` of one leader a preamble, a ``put`` of the other 6 (each
             takes its preamble's 15 cached blocks and a CoW copy of block
             15, and starts its prefill at position 1000), a
             ``decode_pipelined`` and a flush. Runs: (a) cache off on a pool
             that holds a wave; (b) the device tier on 96 blocks, which
             cannot hold six chains and a wave (``evicted_pressure`` > 0);
             (c) (b) with a 256-block host tier, at depth 2 (the launches
             read here) and at depth 0 (every block move held bit-exact as
             it happens: a CoW copy equals its source, a promotion's rows
             equal its buffer and hash as at the demotion gather), whose
             streams must be identical, with ``demoted``, ``promoted``,
             ``host_hit_blocks`` > 0 and ``evicted_pressure`` 0; (d) (c) over
             an int8 pool (codes and scales moved and checked together);
             (e) (c) with a journal: a pause and resume of one follower a
             wave (rows equal before and after), two requests aborted with
             steps in flight (their flush deferred), one past a 1 ms
             deadline (rejected), a ``request_drain`` in wave 4, ``drain``
             (every block back, the journal's sequences equal the
             manifest's), and a ``replay`` on a fresh engine finished to 32
             tokens. After every wave the cache's invariants and exact
             refcounts hold and, after the last flush, every block is back.
             Printed: each run's ``prefix_stats``, pauses, prefill seconds a
             wave, decode tok/s, ``promote_wait_s``, drain seconds, and the
             share of first tokens and whole streams equal to (a)'s (bf16
             at another batch size need not round alike). Then K1 and K2 at
             the steps recorded on run (c)'s hit path (K1: the followers'
             first chunks, 256 queries a slot with 24-200 live from
             position 1000, blocks shared between slots; K2: the first
             decode step), in bf16, fp16 and over an int8 pool, against
             their plain versions and timed beside SDPA and the bound (a
             shared block's bytes counted once).
26. gpt2 serving — a random checkpoint in HuggingFace's layout with
             openai-community/gpt2-xl's published config.json (gpt2: 48
             layers, n_embd 1600, 25 heads of 64 with no GQA, vocab 50257,
             1024 positions; ~3.1 GB in bf16), written and removed as in
             phase 24, served through ``build_hf_engine`` by the GPT-2
             ragged runner: every loaded leaf bit-identical to the tensor
             written; 16 prompts x 256 tokens, 32 new, greedy and sampled
             (phase 24's sampling) at pipeline depths 0 and 2, streams
             identical between the depths, K1 (wgmma, TMA) and K2 (split)
             launched 48 times a step; the card's greedy first tokens
             equal numpy's argmax over the 50257 logits ``put`` returns.
             Prefill s and decode tok/s; then K1 and K2 at 25 heads of 64
             against their plain versions and timed, as phase 5 times.
27. spec decoding — speculative decoding on Llama-2-7B
             (``LlamaConfig.llama2_7b``, seeded random weights on the card,
             bf16, ``paged_flash``, block 64, 8 slots, depth 2, prefix cache
             on): 8 prompts of a shared 128-token preamble, cached by a
             warm-up, and 128 tokens of a per-prompt 16-token pattern
             repeated; ``put``, then ``decode_pipelined`` for 47 tokens.
             Cases: (a) spec off; (b) ``ngram``, K = 4; (c) ``draft``, a
             random model at TinyLlama-1.1B's widths (rejected often: the
             rollback path); (d) ``draft``, the target's own parameters.
             (b)-(d) must give (a)'s streams token for token, (d) must
             accept every draft (acceptance exactly 1.0), the preamble
             must be matched, the prefix cache's invariants and exact
             refcounts hold, and after the flushes every block of the
             target's and of the draft's pool is back. Printed: acceptance,
             rounds, tokens a round, decode tok/s against (a), K2 launches
             a verify round and the host seconds a round (propose, verify,
             commit). Then K1 at the prefill after the preamble and K2 at
             the verify's 8-slot decode shape against their plain versions
             and timed.
28. families — the dense runners of A5.4. (a) A random checkpoint in
             HuggingFace's layout with EleutherAI/gpt-j-6b's published
             config.json at 14 of its 28 layers (n_embd 4096, 16 heads of
             256, rotary_dim 64, vocab 50400, an untied lm_head with a
             bias; ~6.5 GB in bf16), written and removed as in phase 24, served
             through ``build_hf_engine`` by the GPT-J runner: every loaded
             leaf bit-identical to the tensor written; 16 prompts x 256
             tokens, 32 new, greedy and sampled at depth 0, depth 2 and
             through the decode loop (16 steps a call), streams identical
             across the three, K1 (mma.sync: head dim 256) and K2 launched
             28 times a step. Load s, prefill s, decode tok/s, peak
             memory; then K1 and K2 at 16 heads of 256 against their plain
             versions and timed beside SDPA. (b) bigscience/bloom-7b1,
             EleutherAI/gpt-neox-20b, facebook/opt-6.7b and microsoft/
             phi-2 at their published widths with the depth cut to 4
             layers (``reduced``), through ``build_hf_engine``, and
             tiiuae/falcon-7b's (71 query heads on 1 KV head of 64) from
             seeded parameters through ``InferenceEngineV2`` (no HF name
             map): 8 prompts x 256 tokens, 16 new; in fp32 with TF32 off
             the kernels' greedy streams equal the dense path's; in bf16
             identical at depths 0 and 2; each launch counted by route
             (ALiBi on every BLOOM launch, K1 on mma.sync at NeoX's D 96
             and Phi's D 80, on wgmma by TMA at D 64 and 128); BLOOM once
             more under ``quantization_mode="wf8"`` (one quantizer launch
             a q/k/v leaf). Then each family's K1 (its 256-token prefill
             step) and K2 (mid-decode) at its own heads (BLOOM with ALiBi)
             against their plain versions and timed beside SDPA, a
             ``kernels`` row each with the depth-2 bf16 run's launches.
29. moe     — the MoE families. (a) A random checkpoint in HF's layout at
             Qwen/Qwen1.5-MoE-A2.7B's published config.json at 12 of its
             24 layers (hidden 2048, 16 heads of 128, 60 experts top-4 of
             width 1408 over the full softmax, a shared expert of 5632,
             vocab 151936; ~15 GB in bf16) through ``build_hf_engine``,
             the host's resident set sampled during the load, every
             tensor checked bit for bit; 16 prompts x 256 tokens, 32
             greedy tokens, depth 2, with the grouped GEMM's launches
             counted (three a layer a step) beside K1's and K2's. (b)
             mistralai/Mixtral-8x7B-v0.1's widths (8 experts top-2 of
             14336, 32 heads on 8 KV heads) at 8 of its 32 layers from
             seeded parameters on the card, the same traffic; a 2-layer
             Mixtral checkpoint through ``build_hf_engine`` for the
             expert stacking at full width. (c) Both families at 4 layers
             in fp32 (TF32 off): the grouped kernel's greedy streams equal
             the plain grouped route's; Qwen-MoE at 4 layers under the
             factory's wf8 lists; one ``_moe_mlp`` call at decode and one
             at prefill under ``torch.cuda.set_sync_debug_mode("error")``.
             (d) The grouped GEMM alone at both families' prefill and
             decode shapes (gate / up and down), experts left empty and
             runs no tile divides, against an fp32 reference and its plain
             twin, timed by events and in a CUDA graph beside
             ``torch._grouped_mm`` (a per-expert matmul loop where this
             torch lacks it), a ``kernels`` row each naming its route
             (prefill on the persistent wgmma kernel, decode on mma.sync;
             launches: that route's in the served run) and the host's µs
             a call; K1/K2 at both families' heads likewise.
30. fleet   — serving telemetry, step attribution and the replica fleet
             at Llama-2-7B's full width and depth (32 layers, bf16,
             seeded; two replicas share the card, each with its own copy
             of the weights and a KV pool of 200 blocks of 64). (a) One
             engine with ``DSTPU_TELEMETRY=0``, then on: 16 x 512-token
             prompts, 64 greedy tokens (31 by the depth-2 pipeline, 32 by
             the decode loop); the streams identical; the token counter
             equal to the tokens streamed, TTFT counted 16 times and TPOT
             the rest; the attribution of the prefill, the pipelined
             decode and the loop windows (plan, dispatch, device_execute,
             commit_apply, host_gap in ms a step, closing within 1%), and
             decode tok/s with telemetry on and off. (b) 32 requests in 4
             groups sharing a 256-token preamble (64-token tails, 32 new)
             through two mixed replicas behind the prefix-aware router:
             each group on one replica, prefix hits on both, the streams
             equal one engine's, the fleet histograms' counts the
             replicas' sums. (c) The same through a prefill and a decode
             specialist: every handed-off block gathered again at the
             destination equals the copy the source sent (scales too),
             the streams equal (b)'s; over an int8 pool again against an
             int8 engine; handoff blocks, bytes and exposed seconds. (d)
             A real SIGTERM (``PreemptionHandler``) on one replica between
             decode rounds: the pool drains it and replays its sequences
             on the other, the streams gapless and equal (b)'s, the
             restart ledger written; a ``during_handoff_gather`` fault
             keeps its sequence on the prefill replica, losing nothing and
             leaking no block. (e) ``DSTPU_TRACE_DIR`` over a prefill and
             a decode window: the exported Chrome trace holds the plan /
             dispatch / commit ranges with K1 and K2 launched inside the
             dispatch ranges. (f) (d)'s drain and replay once more in
             fp32 with TF32 off at 4 layers of the same width: every
             drained sequence's replayed stream equals the uninterrupted
             run. Then K1 and K2 at this phase's bf16 and
             int8 shapes against their plain versions, timed beside SDPA.
31. loadgen — the open-loop load generator on phase 30's weights and
             engine configuration with ``attention_impl="auto"`` (K1/K2),
             at most 16 live requests. The longest shape (512-token
             prompt, 128 new) alone first; the deadline is 15 s from
             arrival (twice that shape's time if it takes longer). (a)
             32 requests offered at once: the completed rate is R. (b)
             ``sweep_capacity`` at 0.5, 0.8, 1.0 and 1.3 R, 32 requests a
             rate, Poisson arrivals (seed 0), ``WorkloadMix``'s default
             shapes (prompts 128 / 256 / 512, generations 32 / 64 / 128),
             half the requests opening with one 256-token preamble, every
             one deadlined: offered, completed and goodput rps, TTFT /
             TPOT / queue-wait p50 / p90 / p99, sheds and deadline misses
             of each rate, the knee (goodput SLO 0.9), every pass's books
             balanced, and the 1.0 R pass's step attribution. (c) K1/K2
             launched in (a)-(b), then held against their plain versions
             at the largest prefill (16 x 256 queries over 512 keys) and
             decode (16 slots at 640 keys) shapes and timed. (d)
             ``telemetry.top.render`` of the engine's
             ``DSTPU_TELEMETRY_EXPORT`` snapshot names goodput and TTFT.
             (e) The serve fault drill (``faultdrill.main``, sites
             mid_commit and sigterm) with its workers on the card. (f)
             Phase 7's steps once more with ``wall_clock_breakdown``: the
             ``train_batch`` timer's mean within 5% of phase 7's step
             time, the first loss bit-identical and the rest within 1e-4
             relative of phase 7's.
32. family training — the Llama and MoE families trained through their
             ``make_model`` entry points and ``Engine.train_batch``, bf16
             compute over fp32 master params, random weights from a
             seed, 2 warm-up and 5 timed steps on one batch, every
             launch count zeroed before and read after: (a)
             TinyLlama-1.1B whole (GQA 8, micro 4 x seq 2048, fused
             xent), (b) Qwen1.5-MoE-A2.7B at published widths, 2 of 24
             layers (micro 2 x seq 1024; top-4 on the grouped GEMM and
             its backward, B18), (c) Mixtral-8x7B at published widths, 1
             of 32 layers (micro 2 x seq 1024; the capacity route with
             second-expert sampling, flash at GQA 4, D 128). Launches as
             reckoned (flash a layer, xent a step, 3 grouped products,
             3 dX and 3 dW a layer); losses finite and falling; 3 steps
             on fresh batches within 1e-4 of the plain routes (``xla``
             attention, chunked xent, the plain ``ragged_dot``). At each
             run's shapes the flash forward and backward at GQA, the
             xent kernels, the grouped forward and B18 (dX and dW, an
             empty expert, ragged groups; 2**-7 of the largest output)
             against their plain versions and timed beside SDPA /
             ``torch._grouped_mm``, B18 also at Mixtral-8x7B's expert
             product (2048 tokens top-2 over 8, one expert empty, 4096
             <-> 14336; its training takes the capacity route, so B18 is
             held and timed there alone); (b)'s grouped layer forward and
             backward under ``set_sync_debug_mode("error")``. Step ms,
             tokens/s, peak memory; with ``--trace`` a profiler window
             over one step a run.
33. resumable training — the training engine's checkpoints in the JAX
             package's format (``save_checkpoint`` / ``load_checkpoint``),
             its preemption and watchdog, and the elastic agent, in a
             directory of the checkout (its free space printed first; the
             phase fails when two tags would not fit) removed at the end.
             (a) Phase 32 (a)'s TinyLlama-1.1B run, whole (22 layers, GQA
             8, V 32000, bf16 over fp32 masters, AdamW with warm-up, micro
             4 x seq 2048, flash and the fused xent): 3 steps, a sync
             save (``global_step3``), a per-leaf digest on the card of the
             whole state (params, both moments, the counts, the loss-scale
             state, the key), steps 4-6; a second engine from weights of
             another seed loads the tag: every digest bit-equal, the
             counters and ``get_lr()`` equal, and steps 4-6 on the same
             batches within 1e-4 relative of the uninterrupted ones. Bytes
             written, the save split into device -> host, write, fsync
             and checksum, the load into validate, read and host ->
             device, the host's peak resident set. (b) The second engine
             (``checkpoint.async_save``) saves at step 6: how long
             ``save_checkpoint`` holds the caller, steps 7-8 timed over the
             writer against (a)'s, then ``commit``: the tag validates
             (deep) and ``latest`` names it. Flash and xent launches as
             reckoned over (a) and (b)'s 11 steps. (c) A worker subprocess
             (TinyLlama at 2 of 22 layers, published widths; ``reduced``:
             the whole model's saves ran in (a) and (b)) with
             ``resilience.preemption`` and ``resilience.watchdog`` under
             ``run_elastic``: it sends itself SIGTERM before step 3, saves
             ``global_step3`` at the step boundary and exits 99; the
             restarted worker resumes there and finishes step 6; the
             newest valid tag is ``global_step3``, the ledger holds a
             ``restart`` (rc 99, a membership change) then ``success``,
             and the watchdog's heartbeat file exists.

With ``--trace``, a torch.profiler window over the phase-3 engine's
prefill and one decode loop call follows phase 3 and each phase-15 run,
and one over a ``train_batch`` follows phases 7 and 11: the device's busy
time against host wall time (each phase-15 decode window prints its idle
share), and the top device ops.

``--fp6-sweep`` builds the kernels and runs only a table of the fp6 GEMM's
launch plans (64, 128 or 256 rows a block, K split into 1-8 ranges) on the
three Llama-2-7B projection shapes at M from 128 to 4096 beside
``torch.matmul``, which ``fp6_plan``'s route choices are read from.
``--norm-sweep`` likewise times the norm kernel's rows-route launches
(vectors a lane, warps a row and a block) at phase 18's shapes beside
``F.layer_norm`` / ``F.rms_norm`` in CUDA graphs, which ``norm_plan``'s
choices are read from.
``--paged-rows`` builds only the paged-attention library and times K1
and K2 at the main paths' shapes that head dims 16-128 share with every
earlier slice (phase 15's 7B int8 pool, its ring and its bf16 pool,
phase 3's GQA shapes, a Qwen2 int8 prefix-hit-sized K1, Phi-2's D 80 and
NeoX-20B's D 96 prefill): copied into another checkout, the same rows
time that checkout's kernels, so two versions compare in one call.

The last three lines are the ``kernels`` JSON, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12         # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12         # H100 SXM dense bf16 tensor core
# bf16 kernel-vs-plain limits: about twice the largest max-abs error read
# on the card (3.9e-3, one bf16 ulp at magnitude 0.5-1), and one bf16
# unit roundoff of the plain output's norm
BF16_MAX_ABS, BF16_REL_NORM = 8e-3, 2.0 ** -8
FP32_MAX_ABS = 1e-4
# phase 23's fp32 limit (the int8 pool's and ALiBi's CUDA-core kernel)
KV_FP32_MAX_ABS = 1e-5
# flash kernels: twice the largest bf16 max-abs reading (7.8e-3 at the
# slice shape, half a bf16 ulp at magnitude 2-4; outputs reach ~5); fp32
# ten times the largest reading (9.5e-7)
FLASH_BF16_MAX_ABS, FLASH_FP32_MAX_ABS = 1.6e-2, 1e-5
# fp16 flash: about one fp16 ulp at outputs of 4-8 (fp16 keeps three more
# bits than bf16), with bf16's 2**-8 of the norm
FLASH_FP16_MAX_ABS = 4e-3
# xent kernels: fp32 (and the logit sum, an fp32 sum of V logits whose
# order differs: 3.7e-3 apart at magnitude 1.9e3 in bf16) within 1e-5 of
# the plain output's norm; bf16 lse and target logit within 1e-3
# absolute; bf16 dh / dE max-abs within XENT_BF16_MAX_REL of the plain
# output's largest magnitude, twice the largest first reading (4.4e-3,
# about one bf16 ulp), and within 2**-8 of its norm
XENT_REL, XENT_BF16_ROWS_ABS, XENT_BF16_MAX_REL = 1e-5, 1e-3, 9e-3
H, KV, D = 32, 4, 64              # TinyLlama attention geometry
SOURCE = "deepspeed_tpu_torch/ops/kernels/csrc/paged_attention.cu"
FLASH_SOURCE = "deepspeed_tpu_torch/ops/kernels/csrc/flash_attention.cu"
REPLACES = {"paged_prefill": "deepspeed_tpu/ops/kernels/paged_attention.py:45",
            "paged_decode": "deepspeed_tpu/ops/kernels/paged_attention.py:205",
            "flash_fwd": "deepspeed_tpu/ops/kernels/flash_attention.py:44",
            "flash_bwd": "deepspeed_tpu/ops/kernels/flash_attention.py:311, "
                         "deepspeed_tpu/ops/kernels/flash_attention.py:359",
            "flash_bwd_dq": "deepspeed_tpu/ops/kernels/flash_attention.py:311",
            "flash_bwd_dkv":
                "deepspeed_tpu/ops/kernels/flash_attention.py:359",
            "xent_fwd": "deepspeed_tpu/ops/kernels/fused_xent.py:57",
            "xent_bwd_dh": "deepspeed_tpu/ops/kernels/fused_xent.py:165",
            "xent_bwd_de": "deepspeed_tpu/ops/kernels/fused_xent.py:192",
            "fp6_matmul": "deepspeed_tpu/ops/kernels/fp6_gemm.py:80",
            "quantize_sym": "deepspeed_tpu/ops/kernels/quantization.py:86",
            "quantize_asym": "deepspeed_tpu/ops/kernels/quantization.py:94",
            "rms_norm": "deepspeed_tpu/ops/kernels/normalization.py:34",
            "layer_norm": "deepspeed_tpu/ops/kernels/normalization.py:96",
            "adamw": "deepspeed_tpu/ops/kernels/fused_optimizer.py:27",
            "flash_sparse_fwd":
                "deepspeed_tpu/ops/kernels/flash_attention.py:117",
            "evoformer_fwd": "deepspeed_tpu/ops/kernels/evoformer.py:39"}
XENT_SOURCE = "deepspeed_tpu_torch/ops/kernels/csrc/fused_xent.cu"
FP6_SOURCE = "deepspeed_tpu_torch/ops/kernels/csrc/fp6_gemm.cu"
QUANT_SOURCE = "deepspeed_tpu_torch/ops/kernels/csrc/quantization.cu"
F32_FLOPS_PER_S = 67e12           # H100 SXM fp32 outside the tensor cores
# Llama-2-7B: attention geometry, and the [K, N] of its matmul weights
H7, KV7, D7 = 32, 32, 128
W7_SHAPES = {"q/k/v/o_proj": (4096, 4096), "gate/up_proj": (4096, 11008),
             "down_proj": (11008, 4096), "lm_head": (4096, 32000)}
# fp6 GEMM against its plain version: bf16 within FP6_BF16_MAX_ABS (twice
# the largest first reading, 3.125e-2: one bf16 ulp at outputs of 4-8)
# and 2**-8 of the plain output's norm, fp32 within FP6_FP32_REL of it
FP6_BF16_MAX_ABS, FP6_FP32_REL = 6.25e-2, 1e-5
# the paged kernels at Llama-2-7B's heads (D = 128, no GQA): bf16 within
# twice the largest first reading (7.8e-3, one ulp at outputs of 1-2, at
# phase 2's 8e-3 limit) and 2**-8 of the norm; fp32 as phase 2
PAGED7_BF16_MAX_ABS = 1.6e-2
# the WOQ serving runs: the JAX package's 7B example
# (examples/llama7b_serve_woq.py:52-89), bf16 KV pool
WOQ_SEQS, WOQ_PROMPT, WOQ_GEN = 64, 512, 128
# the prefill chunk phases 15 and 23 run: min(chunk 512, the 256-token
# prefill_chunk_cap), two 256-query chunks a prompt (fault C5)
WOQ_CHUNK = 256
WOQ_MODES = {"bf16": None, "int8": {"num_bits": 8},
             "int4": {"num_bits": 4},
             "fp6_fused": {"dtype": "fp6", "fused_gemm": True}}
WOQ_EXCLUDED = ["embed", "norm", "lm_head"]
# phase 15's decode tok/s and the fp6 prefill s as the earlier kernels
# read them (K2 on the CUDA cores without a context split, the fp6 GEMM on
# one mma.sync route without a K split; H100 80GB HBM3 at 700 W): each run
# prints its reading beside these
WOQ_EARLIER_TOK_S = {"bf16": 772.5, "int8": 462.8, "int4": 405.2,
                     "fp6_fused": 465.7}
WOQ_EARLIER_FP6_PREFILL_S = 4.68
# the bf16 fused-fp6 engine against the dense engine on its dequantized
# tree (phase 16): teacher-forced logits within these limits of the dense
# engine's, about twice the first readings (2.598e-3 of the norm, 1.446e-2
# max-abs; the same order as the 9.8e-4 that the plain versions alone
# give at hidden 64 on the CPU, where no kernel runs)
WOQ_BF16_LOGITS_REL, WOQ_BF16_LOGITS_MAX_ABS = 5e-3, 3e-2
# the ops slice (phases 18-21): sources, widths and limits
NORM_SOURCE = "deepspeed_tpu_torch/ops/kernels/csrc/normalization.cu"
ADAMW_SOURCE = "deepspeed_tpu_torch/ops/kernels/csrc/fused_optimizer.cu"
SPARSE_SOURCE = "deepspeed_tpu_torch/ops/kernels/csrc/sparse_attention.cu"
EVO_SOURCE = "deepspeed_tpu_torch/ops/kernels/csrc/evoformer.cu"
# BERT-large attention (the JAX package's BertConfig.bert_large: 16 heads
# of 64) at a long-sequence batch, 128-blocks
SPARSE_B, SPARSE_H, SPARSE_T, SPARSE_D = 4, 16, 4096, 64
# AlphaFold 2 fine-tuning (supplementary Table 4: N_res 384, N_clust 512):
# MSA row attention with pair bias (Algorithm 7: 8 heads, c = 32) and
# triangle attention (Algorithm 13: 4 heads, c = 32), as (B, N, S, H, D)
EVO_MSA, EVO_TRI = (1, 512, 384, 8, 32), (1, 384, 384, 4, 32)
# kernel-vs-plain limits of the ops slice: bf16 max-abs at about twice
# the first readings (norms 1.562e-2, one ulp at outputs of 2-4; sparse
# 3.906e-3; evoformer 7.812e-3) and 2**-8 of the plain output's norm; fp32
# max-abs 1e-5 (first readings 4.9e-7 to 1.43e-6)
NORM_BF16_MAX_ABS, SPARSE_BF16_MAX_ABS, EVO_BF16_MAX_ABS = 3.2e-2, 8e-3, \
    1.6e-2
OPS_FP32_MAX_ABS = 1e-5
# the training slice: GPT-2-1.3B, micro batch x gas, sequence
TRAIN_MB, TRAIN_GAS, TRAIN_T, TRAIN_STEPS = 4, 2, 2048, 5
# the gpt1p3b slice: micro batch, sequence; N = XENT_N tokens per step
BENCH_MB, BENCH_T = 2, 2048
XENT_N, XENT_V, XENT_C = BENCH_MB * BENCH_T, 50304, 2048


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- inputs


def paged_inputs(torch, rng, *, S, C, lens, block_size, maxb, dtype,
                 shuffle=True, heads=(H, KV, D)):
    """Random pool, per-sequence block tables (padded with 0) and q for
    ``S`` sequences whose contexts are ``lens``; queries sit at the last
    ``C`` positions of each context. ``heads``: (H, KV, D)."""
    import numpy as np
    H, KV, D = heads
    blocks = [-(-int(n) // block_size) for n in lens]
    nb = max(sum(blocks), 1)
    order = rng.permutation(nb) if shuffle else np.arange(nb)
    tables = np.zeros((S, maxb), np.int32)
    at = 0
    for s, k in enumerate(blocks):
        tables[s, :k] = order[at:at + k]
        at += k
    lens = np.asarray(lens, np.int32)
    start = np.maximum(lens - C, 0).astype(np.int32)
    slots = (nb + 1) * block_size
    dev = "cuda"
    kp = torch.randn(slots, KV * D, device=dev).to(dtype)
    vp = torch.randn(slots, KV * D, device=dev).to(dtype)
    q = torch.randn(S, C, H, D, device=dev).to(dtype)
    t = lambda a: torch.from_numpy(a).to(dev)       # noqa: E731
    return q, kp, vp, t(tables), t(start), t(lens)


def kv_extras(torch, kp, vp, KVh, Hh, *, quant=False, alibi=False):
    """What a paged call adds to the plain pool: with ``quant`` the pool's
    rows quantized to int8 (``k_pool`` / ``v_pool``) with their [KV,
    slots] scales, with ``alibi`` the slopes of ``alibi_slopes(H)``."""
    from deepspeed_tpu_torch.inference.v2.kv_quant import quantize_rows
    from deepspeed_tpu_torch.models._lm_utils import alibi_slopes
    ex = {}
    if quant:
        kq, ks = quantize_rows(kp, KVh)
        vq, vs = quantize_rows(vp, KVh)
        ex.update(k_pool=kq, v_pool=vq, k_scales=ks.contiguous(),
                  v_scales=vs.contiguous())
    if alibi:
        ex["alibi_slopes"] = alibi_slopes(Hh).cuda()
    return ex


# ---------------------------------------------------------------- phases


def phase_build():
    """Compile every kernel library and log ptxas's report (registers,
    shared memory and spills of each entry function)."""
    from deepspeed_tpu_torch.ops.kernels import _build
    t0 = time.perf_counter()
    _build.build()
    log(f"[build] {time.perf_counter() - t0:.1f} s")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if ("ptxas" in line and ("Used" in line or "spill" in line
                                     or "Compiling" in line)) \
                    or "C7515" in line or "arning" in line:
                log(f"[build] {name}: {line.strip()}")


def check_close(torch, what, got, ref, bf16_max_abs=BF16_MAX_ABS,
                fp32_max_abs=FP32_MAX_ABS, fp16_max_abs=FLASH_FP16_MAX_ABS):
    """Max-abs and norm-relative error of a kernel's output against its
    plain version; raises past the dtype's limits (the dtype is the
    output's, or the one named in ``what`` for an fp32 side output)."""
    diff = got.float() - ref.float()
    err = diff.abs().max().item()
    rel = (diff.norm() / ref.float().norm().clamp_min(1e-30)).item()
    if got.dtype == torch.bfloat16 or "bfloat16" in what:
        ok, lim = err <= bf16_max_abs and rel <= BF16_REL_NORM, \
            f"max-abs {bf16_max_abs}, rel-norm {BF16_REL_NORM:.3e}"
    elif got.dtype == torch.float16 or "float16" in what:
        ok, lim = err <= fp16_max_abs and rel <= BF16_REL_NORM, \
            f"max-abs {fp16_max_abs}, rel-norm {BF16_REL_NORM:.3e}"
    else:
        ok, lim = err <= fp32_max_abs, f"max-abs {fp32_max_abs}"
    log(f"{what} max_abs_err={err:.3e} rel_norm_err={rel:.3e} ({lim})")
    if not ok:
        raise AssertionError(f"{what} disagrees with plain: {err}, {rel}")
    return err


def phase_parity(torch):
    import numpy as np
    from deepspeed_tpu_torch.ops.kernels import paged_attention as pa
    rng = np.random.default_rng(0)
    worst = {"paged_prefill": 0.0, "paged_decode": 0.0}
    dec_lens = rng.integers(1, 2049, 16)
    dec_lens[0], dec_lens[3] = 2048, 0                 # slot 3 idle
    # up to 8192 keys: K2 splits the context (an empty split past a short
    # sequence, a sequence ending inside a split)
    long_lens = rng.integers(1, 8193, 16)
    long_lens[:6] = [8192, 1, 63, 64, 65, 0]
    cases = [
        # (kernel, S, C, lens, block_size, maxb, window)
        ("paged_prefill", 4, 256, [256, 512, 1024, 2048], 64, 32, None),
        ("paged_prefill", 4, 256, [256, 512, 1024, 2048], 64, 32, 512),
        # K1's cp.async gather route (a block size that is no multiple of
        # the 64-row TMA box), a window edge inside a tile, an idle slot
        ("paged_prefill", 4, 256, [256, 0, 1000, 2048], 16, 128, 100),
        ("paged_decode", 16, 1, dec_lens, 64, 32, None),
        ("paged_decode", 16, 1, dec_lens, 2048, 1, None),  # linear layout
        ("paged_decode", 16, 1, dec_lens, 64, 32, 512),
        ("paged_decode", 16, 1, long_lens, 64, 128, None),
        # the window's edge (pos - 699) falls inside a split
        ("paged_decode", 16, 1, long_lens, 64, 128, 700),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        for name, S, C, lens, bs, maxb, window in cases:
            q, kp, vp, tab, st, ln = paged_inputs(
                torch, rng, S=S, C=C, lens=lens, block_size=bs, maxb=maxb,
                dtype=dtype)
            kw = dict(block_size=bs, sm_scale=D ** -0.5,
                      sliding_window=window, num_kv_heads=KV)
            got = getattr(pa, name)(q, kp, vp, tab, st, ln, **kw)
            ref = pa.paged_attention_plain(q, kp, vp, tab, st, ln, **kw)
            torch.cuda.synchronize()
            idle = ln == 0
            if idle.any() and got[idle].abs().max().item() != 0.0:
                raise AssertionError(f"{name}: idle slot not zero")
            if not torch.isfinite(got.float()).all():
                raise AssertionError(f"{name}: non-finite output")
            # one block owns each output (K1's items, K2's merge in split
            # order): a second call gives the same bits
            if not torch.equal(got, getattr(pa, name)(q, kp, vp, tab, st,
                                                      ln, **kw)):
                raise AssertionError(f"{name}: two calls differ")
            plan = ""
            if name == "paged_decode":
                plan = f" plan {_k2_plan(pa, q, S, KV, H // KV, maxb, bs)}"
            else:
                plan = f" route {pa.prefill_route(C, D, dtype, bs)}"
            err = check_close(
                torch, f"[parity] {name} {str(dtype)[6:]} bs={bs} "
                f"maxb={maxb} window={window}{plan}", got, ref)
            if dtype is torch.bfloat16:
                worst[name] = max(worst[name], err)
    return worst


def phase_serving(torch):
    import numpy as np
    from deepspeed_tpu_torch.checkpoint import init_llama_params
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceConfig)
    from deepspeed_tpu_torch.models.llama import LlamaConfig
    from deepspeed_tpu_torch.ops.kernels import paged_attention as pa
    cfg = LlamaConfig.tinyllama_1b(dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = init_llama_params(cfg, seed=0, device="cuda",
                               dtype=torch.bfloat16)
    rcfg = RaggedInferenceConfig(
        max_seqs=16, chunk_size=256, block_size=64, num_blocks=256,
        max_blocks_per_seq=16, dtype="bfloat16", decode_loop_steps=16,
        attention_impl="paged_flash")
    eng = InferenceEngineV2(cfg, params, rcfg, device="cuda")
    torch.cuda.synchronize()
    log(f"[serving] weights + engine {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab_size, (16, 512)).tolist()
    # warm-up outside the measured run (cuBLAS handles, kernel loading)
    eng.generate([prompts[0][:80]], max_new_tokens=18)
    for k in eng.timing:
        eng.timing[k] = 0 if isinstance(eng.timing[k], int) else 0.0

    pa.reset_launch_counts()
    eng.runner.step_counts = {"prefill": 0, "decode": 0}
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.generate(prompts, max_new_tokens=64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(pa.LAUNCHES)
    steps = dict(eng.runner.step_counts)
    peak = torch.cuda.max_memory_allocated()

    L = cfg.num_layers
    if launches["paged_prefill"] != L * steps["prefill"] \
            or launches["paged_decode"] != L * steps["decode"]:
        raise AssertionError(f"launches {launches} != {L} x steps {steps}")
    if not (steps["prefill"] and steps["decode"]):
        raise AssertionError(f"a kernel of the path never ran: {steps}")
    if any(len(o) != 64 for o in out) \
            or not all(0 <= t < cfg.vocab_size for o in out for t in o):
        raise AssertionError("wrong output lengths or token ids")
    if eng.free_blocks != rcfg.num_blocks:
        raise AssertionError("KV blocks leaked")
    logits = eng.put([99], [prompts[0]])[99]
    eng.flush(99)
    if not np.isfinite(logits).all():
        raise AssertionError("non-finite logits")
    tm = eng.timing
    log(f"[serving] steps {steps} launches {launches} wall {wall:.3f} s")
    log(f"[serving] prefill {tm['prefill_tokens']} tokens in "
        f"{tm['prefill_s']:.4f} s; decode {tm['decode_tokens']} tokens in "
        f"{tm['decode_s']:.4f} s = {tm['decode_tokens'] / tm['decode_s']:.1f}"
        f" tok/s; peak memory {peak / 2**30:.2f} GiB")
    log(f"[serving] first tokens {[o[:4] for o in out[:2]]}")
    return {"launches": launches, "steps": steps,
            "prefill_s": tm["prefill_s"], "decode_s": tm["decode_s"],
            "decode_tokens": tm["decode_tokens"], "peak_bytes": peak
            }, eng, prompts


def phase_engine_parity(torch):
    import numpy as np
    from deepspeed_tpu_torch.checkpoint import init_llama_params
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceConfig)
    from deepspeed_tpu_torch.models.llama import Llama, LlamaConfig
    # fp32 matmuls in full fp32: a reference states and sets both
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[engine] fp32, TF32 off (matmul and cuDNN)")
    cfg = LlamaConfig.tinyllama_1b(dtype=torch.float32)
    params = init_llama_params(cfg, seed=1, device="cuda",
                               dtype=torch.float32)
    prompts = np.random.default_rng(1).integers(
        1, cfg.vocab_size, (4, 128)).tolist()
    gens = {}
    for impl in ("paged_flash", "dense"):
        rcfg = RaggedInferenceConfig(
            max_seqs=4, chunk_size=64, block_size=64, num_blocks=32,
            max_blocks_per_seq=4, dtype="float32", decode_loop_steps=8,
            attention_impl=impl)
        eng = InferenceEngineV2(cfg, params, rcfg, device="cuda")
        gens[impl] = eng.generate(prompts, max_new_tokens=16)
        if impl == "paged_flash":
            logits = eng.put([9], [prompts[0]])[9]
    if gens["paged_flash"] != gens["dense"]:
        raise AssertionError(f"kernel tokens {gens['paged_flash']} != "
                             f"dense {gens['dense']}")
    full = Llama(cfg, params)(torch.tensor([prompts[0]], device="cuda"))
    err = float(np.abs(full[0, -1].cpu().numpy() - logits).max())
    log(f"[engine] tokens identical over {len(prompts)} x 16; prefill "
        f"logits vs full forward max_abs_err={err:.3e} (tol 1e-3)")
    if not err <= 1e-3:
        raise AssertionError("engine prefill logits disagree with forward")
    del params, eng, full
    torch.cuda.empty_cache()


def sm_count(device):
    """The card's SM count (the kernels' plans read it)."""
    from deepspeed_tpu_torch.utils.device import sm_count as count
    return count(device)


def _time_ms(torch, fn, iters):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _graph_ms(torch, fns, reps=20):
    """Device time per call without the host's launch cost: one pass over
    ``fns`` captured in a CUDA graph, replayed ``reps`` times between two
    CUDA events. Back-to-back launches of a call of a few tens of
    microseconds are bound by the host (Python, ctypes, the launch), which
    ``_time_ms`` then measures instead of the device."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for f in fns:
            f()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    ms = a.elapsed_time(b) / (reps * len(fns))
    del g
    return ms


def _sdpa(q, k, v, mask):
    """One PyTorch call on contiguous live K/V: q [S, H, C, D],
    k/v [S, KV, T, D]."""
    import torch.nn.functional as F
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)


def _k2_plan(pa, q, S, KV, g, maxb, bs):
    """K2's plan for these shapes on this card, as a dict."""
    hc, splits, kps = pa.decode_plan(S, KV, g, maxb * bs,
                                     sm_count(q.device))
    return {"head_chunks": hc, "splits": splits, "keys_per_split": kps,
            "blocks": S * KV * hc * splits}


def time_paged(torch, rng, name, *, S, C, ctx, block_size, maxb,
               heads=(H, KV, D), bf16_max_abs=BF16_MAX_ABS,
               dtype=None, quant=False, alibi=False, ring=0):
    """Kernel ``name`` at one shape (every slot at context ``ctx``,
    queries at its last C positions; bf16 unless ``dtype``; with
    ``quant`` an int8 pool and its scales, ``alibi`` ALiBi slopes,
    ``ring`` that many decode-loop ring rows after the pool's ``ctx``
    keys): its time, its plain version's, ``F.scaled_dot_product_attention``
    on the same live K/V (and ring) laid out contiguously -- over an int8
    pool the same K/V in bf16, a reference only, since no PyTorch call
    computes the scaled int8 function; with ALiBi the bias as the float
    ``attn_mask`` --, the bound, and the kernel's error against its plain
    version there."""
    from deepspeed_tpu_torch.ops.kernels import paged_attention as pa
    dtype = dtype or torch.bfloat16
    Hh, KVh, Dh = heads
    q, kp, vp, tab, st, ln = paged_inputs(
        torch, rng, S=S, C=C, lens=[ctx] * S, block_size=block_size,
        maxb=maxb, dtype=dtype, heads=heads)
    ex = kv_extras(torch, kp, vp, KVh, Hh, quant=quant, alibi=alibi)
    if ring:
        carry = torch.randn(ring, 2, S, KVh * Dh, device="cuda").to(dtype)
        ex.update(ring_k=carry[:, 0], ring_v=carry[:, 1], ring_count=ring)
        st = st + ring                 # the query sits past the ring rows
    kp, vp = ex.pop("k_pool", kp), ex.pop("v_pool", vp)
    kw = dict(block_size=block_size, sm_scale=Dh ** -0.5,
              sliding_window=None, num_kv_heads=KVh, **ex)
    fn = getattr(pa, name)
    # the kernel against its plain version at these shapes too
    got = fn(q, kp, vp, tab, st, ln, **kw)
    ref = pa.paged_attention_plain(q, kp, vp, tab, st, ln, **kw)
    what = (f"{name} at S={S} C={C} ctx={ctx} H={Hh} KV={KVh} D={Dh} "
            f"{str(dtype)[6:]}" + (" int8 pool" if quant else "")
            + (" alibi" if alibi else "") + (f" ring {ring}" if ring else ""))
    err = check_close(torch, f"[timing] {what}", got, ref,
                      bf16_max_abs=bf16_max_abs,
                      fp32_max_abs=KV_FP32_MAX_ABS)
    del got, ref
    ms = _time_ms(torch, lambda: fn(q, kp, vp, tab, st, ln, **kw), 50)
    plain_ms = _time_ms(torch, lambda: pa.paged_attention_plain(
        q, kp, vp, tab, st, ln, **kw), 3)
    j = torch.arange(ctx, device="cuda")
    idx = tab.long()[:, j // block_size] * block_size + j % block_size
    lib_dt = torch.bfloat16 if quant else dtype

    def dense(pool, sc):
        x = pool[idx].float()
        if sc is not None:                    # the dequantized rows
            x = (x.reshape(S, ctx, KVh, Dh) * sc.T[idx][..., None])
        x = x.reshape(S, ctx, KVh, Dh)
        if ring:
            x = torch.cat([x, ex["ring_" + ("k" if pool is kp else "v")]
                           .float().transpose(0, 1).reshape(
                               S, ring, KVh, Dh)], dim=1)
        return x.to(lib_dt).transpose(1, 2).contiguous()
    kc = dense(kp, ex.get("k_scales"))
    vc = dense(vp, ex.get("v_scales"))
    qc = q.transpose(1, 2).contiguous().to(lib_dt)         # [S, H, C, D]
    T = ctx + ring
    pos = ctx - C + ring + torch.arange(C, device="cuda")
    jt = torch.arange(T, device="cuda")
    # pool columns sit at positions j, ring row r at ctx + r
    mask = jt[None, :] <= pos[:, None]                     # [C, T]
    if alibi:
        dist = (pos[:, None] - jt[None, :]).float()
        mask = torch.where(mask, -kw["alibi_slopes"][:, None, None] * dist,
                           float("-inf")).to(lib_dt)       # [H, C, T]
    lib_ms = _time_ms(torch, _sdpa(qc, kc, vc, mask), 50)
    graph_ms = _graph_ms(torch, [lambda: fn(q, kp, vp, tab, st, ln, **kw)])
    lib_graph_ms = _graph_ms(torch, [_sdpa(qc, kc, vc, mask)])
    # bound: each input read once, each output written once (live K/V
    # rows, their scales, the ring rows), and the FLOPs of the causal pairs
    el = q.element_size()
    pairs = S * sum(min(ctx, p + 1) for p in range(ctx - C, ctx)) \
        + S * C * ring
    flops = 4 * Hh * Dh * pairs
    nbytes = (2 * S * ctx * KVh * Dh * (1 if quant else el)
              + 2 * S * C * Hh * Dh * el + 2 * S * ring * KVh * Dh * el
              + (2 * S * ctx * KVh * 4 if quant else 0)
              + (Hh * 4 if alibi else 0)
              + tab.numel() * 4 + 2 * S * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (F32_FLOPS_PER_S if dtype == torch.float32
                     else BF16_FLOPS_PER_S) * 1e3
    out = {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": lib_ms, "max_abs_err": err,
           "shape": {"S": S, "C": C, "H": Hh, "KV": KVh, "D": Dh,
                     "context": ctx, "block_size": block_size,
                     "dtype": str(dtype)[6:], "int8_pool": quant,
                     "alibi": alibi, "ring": ring},
           "bytes": nbytes, "flops": flops, "graph_ms": graph_ms,
           "library_graph_ms": lib_graph_ms}
    if quant:
        out["library_note"] = ("SDPA over the same K/V in bf16: a "
                               "reference only (no PyTorch call computes "
                               "the scaled int8 function)")
    out["bound_share"] = out["bound_ms"] / ms
    out["graph_bound_share"] = out["bound_ms"] / graph_ms
    if C == 1:
        out["plan"] = _k2_plan(pa, q, S, KVh, Hh // KVh, maxb, block_size)
        if ring:
            out["plan"]["ring_split"] = 1
    else:
        out["kernel_route"] = pa.prefill_route(C, Dh, q.dtype, block_size,
                                               quant)
        if out["kernel_route"].startswith("wgmma"):
            plan = pa.prefill_plan(S, C, Hh, maxb * block_size,
                                   sm_count(q.device))
            out["plan"] = {"items": plan.items, "grid": plan.grid}
    log(f"[timing] {what}: {ms:.4f} ms (plain {plain_ms:.4f}, sdpa "
        f"{lib_ms:.4f}, bound {out['bound_ms']:.4f} by {out['bound_by']}, "
        f"{out['bound_share']:.1%} of it; max_abs_err {err:.3e}; in a CUDA "
        f"graph {graph_ms:.4f} ({out['graph_bound_share']:.1%} of the "
        f"bound) against sdpa {lib_graph_ms:.4f})"
        + (f"; route {out['kernel_route']}" if C > 1 else "")
        + (f"; plan {out['plan']}" if "plan" in out else ""))
    return out


def phase_timing(torch, serving, worst):
    """Each kernel at the serving shapes: K1 on the second 256-token
    prefill chunk of 16 x 512-token prompts, K2 on 16 slots at context
    544 (mid-decode), bf16, block 64."""
    import numpy as np
    rng = np.random.default_rng(2)
    rows = []
    specs = [("paged_prefill", 16, 256, 512), ("paged_decode", 16, 1, 544)]
    for name, S, C, ctx in specs:
        t = time_paged(torch, rng, name, S=S, C=C, ctx=ctx, block_size=64,
                       maxb=16)
        steps = serving["steps"]["prefill" if C > 1 else "decode"]
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": serving["launches"][name],
            "launches_per_step": serving["launches"][name] // steps,
            "steps": steps,
            **t, "max_abs_err": max(worst[name], t["max_abs_err"])})
    return rows


def _device_summary(prof, wall_s, steps, top=8):
    """Device busy time (union of the trace's device intervals) against
    the host wall time, device ops per step, and the top ops by device
    time."""
    from torch.autograd import DeviceType
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not evs:
        return {"busy_s": None, "note": "no device events in the trace"}
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs)
    busy, (cur_a, cur_b) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > cur_b:
            busy += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    busy = (busy + cur_b - cur_a) / 1e6
    by_name = {}
    for e in evs:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + (e.time_range.end - e.time_range.start))
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {"wall_s": wall_s, "busy_s": busy,
            "idle_share": 1.0 - busy / wall_s,
            "device_ops_per_step": len(evs) / steps,
            "top": [{"name": n[:70], "count": c, "ms": t / 1e3}
                    for n, (c, t) in ranked]}


def phase_trace(torch, eng, prompts):
    """``--trace`` only: torch.profiler over the phase-3 engine's prompt
    put() (prefill) and one decode_batch of ``decode_loop_steps`` steps,
    at the phase-3 shapes."""
    from torch.profiler import ProfilerActivity, profile
    uids = list(range(1000, 1000 + len(prompts)))
    n = eng.config.decode_loop_steps
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = {}
    before = eng.runner.step_counts["prefill"]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        first = eng.put(uids, prompts, _greedy=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out["prefill"] = _device_summary(
        prof, wall, eng.runner.step_counts["prefill"] - before)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        eng.decode_batch(uids, [first[u] for u in uids], n)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out["decode"] = _device_summary(prof, wall, n)
    for u in uids:
        eng.flush(u)
    for k, v in out.items():
        log(f"[trace] {k}: {json.dumps(v)}")
    return out


# ---------------------------------------------------------------- training


def flash_inputs(torch, *, B, Tq, Tk, H, Hk, D, dtype, seed):
    """q/k/v/dO as the model passes them: [B, H, T, D] views of BTHD
    buffers (strided rows), made on the card from a seed."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def mk(T, h):
        return torch.randn(B, T, h, D, generator=g, device="cuda").to(
            dtype).transpose(1, 2)
    return mk(Tq, H), mk(Tk, Hk), mk(Tk, Hk), mk(Tq, H)


def flash_all(fa, q, k, v, do, *, causal, sm_scale, plain, dlse=None):
    """Forward from q/k/v, then the backward from the plain forward's o and
    lse (and the lse cotangent ``dlse``), so the forward and the backward
    are each held against their plain version on equal inputs."""
    kw = dict(causal=causal, sm_scale=sm_scale)
    ro, rlse = fa.flash_fwd_plain(q, k, v, **kw)
    if plain:
        return [ro, rlse, *fa.flash_bwd_plain(q, k, v, do, ro, rlse, dlse,
                                              **kw)]
    o, lse = fa.flash_fwd(q, k, v, **kw)
    return [o, lse, *fa.flash_bwd(q, k, v, do, ro, rlse, dlse, **kw)]


def flash_outputs(fa, D, dtype):
    """(kernels-line row, output) of each of ``flash_all``'s outputs: the
    backward's row is its route's (``fa.bwd_launch_names``)."""
    names = fa.bwd_launch_names(D, dtype)
    dq_row, dkv_row = ("flash_bwd", "flash_bwd") if "flash_bwd" in names \
        else names
    return (("flash_fwd", "o"), ("flash_fwd", "lse"), (dq_row, "dq"),
            (dkv_row, "dk"), (dkv_row, "dv"))


def flash_want(fa, D, dtype, n_fwd, n_bwd):
    """The launch counts of ``n_fwd`` forwards and ``n_bwd`` backwards at
    head dim D in ``dtype``: every entry of ``fa.LAUNCHES``, the other
    route's at 0."""
    want = dict.fromkeys(fa.LAUNCHES, 0)
    want["flash_fwd"] = n_fwd
    for name in fa.bwd_launch_names(D, dtype):
        want[name] = n_bwd
    return want


def phase_flash_parity(torch):
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False   # plain fp32 products
    worst = {"flash_fwd": 0.0, "flash_bwd": 0.0}
    cases = [
        # (B, Tq, Tk, H, Hk, D, causal, an lse cotangent)
        (2, 200, 200, 4, 4, 64, True, False),
        (2, 128, 384, 8, 2, 64, True, False),
        (2, 200, 200, 8, 2, 64, False, True),
        (1, 300, 200, 4, 1, 64, True, False),   # 100 rows with no live key
        (1, 256, 256, 2, 2, 128, True, False),
        (1, 300, 200, 4, 1, 128, True, True),
        (2, 256, 256, 8, 2, 128, True, False),  # GQA 8 -> 2 at D = 128
        (TRAIN_MB, TRAIN_T, TRAIN_T, 32, 32, 64, True, False),  # the slice
        (BENCH_MB, BENCH_T, BENCH_T, 16, 16, 128, True, False),  # gpt1p3b
    ]
    for B, Tq, Tk, Hh, Hk, Dh, causal, with_dlse in cases:
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            if dtype is torch.float32 and Tq == TRAIN_T:
                continue          # the CUDA-core oracle is slow at 2048
            if dtype is torch.float16 and Tq == TRAIN_T and Dh == 64:
                continue          # fp16 at 2048 once, at D = 128
            q, k, v, do = flash_inputs(torch, B=B, Tq=Tq, Tk=Tk, H=Hh,
                                       Hk=Hk, D=Dh, dtype=dtype, seed=Tq)
            kw = dict(causal=causal, sm_scale=Dh ** -0.5)
            g = torch.Generator(device="cuda").manual_seed(Tk)
            kw["dlse"] = torch.randn(B, Hh, Tq, generator=g, device="cuda") \
                * 0.1 if with_dlse else None
            fa.reset_launch_counts()
            got = flash_all(fa, q, k, v, do, plain=False, **kw)
            want = flash_want(fa, Dh, dtype, 1, 1)
            if fa.LAUNCHES != want:
                raise AssertionError(f"flash parity launches {fa.LAUNCHES}"
                                     f" != {want}")
            ref = flash_all(fa, q, k, v, do, plain=True, **kw)
            if "flash_bwd" in fa.bwd_launch_names(Dh, dtype):
                # dK and dV: one block owns each key tile (no atomics)
                again = fa.flash_bwd(q, k, v, do, ref[0], ref[1],
                                     kw["dlse"], causal=causal,
                                     sm_scale=kw["sm_scale"])
                if not (torch.equal(again[1], got[3])
                        and torch.equal(again[2], got[4])):
                    raise AssertionError(f"flash_bwd B{B} Tq{Tq} D{Dh} "
                                         f"{dtype}: dK/dV differ between "
                                         f"two calls")
            torch.cuda.synchronize()
            # rows with no live key: lse = -inf in both, O = 0 exactly
            dead = ~torch.isfinite(ref[1])
            if not torch.equal(dead, ~torch.isfinite(got[1])) or (
                    dead.any() and (got[0][dead] != 0).any()):
                raise AssertionError(f"flash_fwd B{B} Tq{Tq} Tk{Tk}: rows "
                                     f"with no live key not O = 0, -inf")
            got[1] = got[1].masked_fill(dead, 0.0)
            ref[1] = ref[1].masked_fill(dead, 0.0)
            for (name, out), g_, r_ in zip(flash_outputs(fa, Dh, dtype),
                                           got, ref):
                if not torch.isfinite(g_.float()).all():
                    raise AssertionError(f"{name} {out}: non-finite output")
                err = check_close(
                    torch, f"[flash parity] {name} {out} {str(dtype)[6:]} "
                    f"B{B} Tq{Tq} Tk{Tk} H{Hh}/{Hk} D{Dh} causal={causal}"
                    f"{' dlse' if with_dlse else ''}",
                    g_, r_, bf16_max_abs=FLASH_BF16_MAX_ABS,
                    fp32_max_abs=FLASH_FP32_MAX_ABS)
                if dtype is torch.bfloat16 and name in worst:
                    worst[name] = max(worst[name], err)
    return worst


@contextlib.contextmanager
def plain_flash(fa):
    """The flash autograd Function with the plain versions swapped in for
    the kernels, for the training-parity comparison only."""
    saved = fa.flash_fwd, fa.flash_bwd
    fa.flash_fwd, fa.flash_bwd = fa.flash_fwd_plain, fa.flash_bwd_plain
    try:
        yield
    finally:
        fa.flash_fwd, fa.flash_bwd = saved


def train_config(mb, gas):
    return {"train_micro_batch_size_per_gpu": mb,
            "gradient_accumulation_steps": gas,
            "bf16": {"enabled": True},
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 1e-4, "weight_decay": 0.01}},
            "scheduler": {"type": "WarmupLR",
                          "params": {"warmup_min_lr": 0.0,
                                     "warmup_max_lr": 1e-4,
                                     "warmup_num_steps": 10}},
            "gradient_clipping": 1.0, "steps_per_print": 1000}


def model_flops_per_token(cfg, T):
    """6 x the matmul params (12 L C^2 per layer's four Dense kernels, and
    the V x C tied LM head) + 12 L T C for attention's two products
    forward and backward, counted without the causal half (the usual
    MFU formula); biases, norms and the position table are left out."""
    L, C, V = cfg.num_layers, cfg.hidden_size, cfg.vocab_size
    return 6 * (12 * L * C * C + V * C) + 12 * L * T * C


def phase_training(torch, trace):
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.checkpoint import init_gpt2_params
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, make_model
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    # bf16 compute: the only fp32 products are the LM head's, whose bf16
    # operands are exact in TF32 (chunked_lm_xent's docstring)
    torch.backends.cuda.matmul.allow_tf32 = True
    cfg = GPT2Config.xl_1p3b(dtype=torch.bfloat16)
    _, _, loss_fn = make_model(cfg)
    t0 = time.perf_counter()
    params = init_gpt2_params(cfg, seed=0, device="cuda")
    engine, *_ = initialize(loss_fn=loss_fn, params=params,
                            config=train_config(TRAIN_MB, TRAIN_GAS))
    del params
    n_params = sum(p.numel() for p in engine.state.params)
    g = torch.Generator(device="cuda").manual_seed(0)
    B = TRAIN_MB * TRAIN_GAS
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, TRAIN_T + 1),
                                     generator=g, device="cuda")}
    torch.cuda.synchronize()
    log(f"[training] GPT-2-1.3B ({n_params} params) weights + engine "
        f"{time.perf_counter() - t0:.1f} s")
    losses = [engine.train_batch(batch) for _ in range(2)]     # warm-up
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    evs = [torch.cuda.Event(enable_timing=True)
           for _ in range(TRAIN_STEPS + 1)]
    t0 = time.perf_counter()
    evs[0].record()
    for i in range(TRAIN_STEPS):
        losses.append(engine.train_batch(batch))
        evs[i + 1].record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / TRAIN_STEPS
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    step_ms = [evs[i].elapsed_time(evs[i + 1]) for i in range(TRAIN_STEPS)]
    losses = [float(x) for x in losses]
    n = cfg.num_layers * TRAIN_GAS * TRAIN_STEPS
    want = flash_want(fa, cfg.head_dim, cfg.dtype, n, n)
    if launches != want:
        raise AssertionError(f"flash launches {launches} != layers x gas x "
                             f"steps: {want}")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    step_s = sum(step_ms) / TRAIN_STEPS / 1e3
    tokens = B * TRAIN_T
    flops = model_flops_per_token(cfg, TRAIN_T) * tokens
    out = {"params": n_params, "step_ms": step_ms, "host_wall_s": wall,
           "tokens_per_s": tokens / step_s, "samples_per_s": B / step_s,
           "model_tflops": flops / step_s / 1e12,
           "mfu": flops / step_s / BF16_FLOPS_PER_S,
           "flops_per_step": flops, "peak_bytes": peak, "losses": losses,
           "launches": launches, "steps": TRAIN_STEPS,
           "shape": {"micro_batch": TRAIN_MB, "gas": TRAIN_GAS,
                     "seq": TRAIN_T, "layers": cfg.num_layers}}
    log(f"[training] step {step_s * 1e3:.1f} ms (events; host wall "
        f"{wall * 1e3:.1f} ms), {out['tokens_per_s']:.0f} tokens/s, "
        f"{out['samples_per_s']:.2f} samples/s, {out['model_tflops']:.1f} "
        f"model TFLOP/s, MFU {out['mfu']:.3f} of 989 TFLOP/s; peak memory "
        f"{peak / 2**30:.2f} GiB")
    log(f"[training] step ms {[round(x, 2) for x in step_ms]}")
    log(f"[training] losses {[round(x, 5) for x in losses]}; launches "
        f"{launches}")
    if trace:
        out["trace"] = phase_train_trace(torch, engine, batch)
    del engine, batch
    torch.cuda.empty_cache()
    return out


def phase_train_trace(torch, engine, batch):
    """``--trace`` only: torch.profiler over one ``train_batch``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.train_batch(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = _device_summary(prof, wall, 1, top=12)
    out["flash_ms"] = _kernel_ms_by_name(prof, "flash_")
    log(f"[trace] train_batch: {json.dumps(out)}")
    return out


def _kernel_ms_by_name(prof, part):
    """Device ms and count of each kernel whose name holds ``part``, keyed
    by the name's first 60 characters past the namespace."""
    from torch.autograd import DeviceType
    out = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or part not in e.name:
            continue
        key = e.name[e.name.index(part):][:60]
        n, ms = out.get(key, (0, 0.0))
        out[key] = (n + 1, ms + (e.time_range.end - e.time_range.start) / 1e3)
    return {k: {"count": n, "ms": ms} for k, (n, ms) in out.items()}


def phase_training_parity(torch):
    """2 layers at full width, seq 512, 5 steps on one batch: the kernels'
    losses against the plain versions' (bf16; fp32 with TF32 off)."""
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.checkpoint import init_gpt2_params
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, make_model
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    T, mb, gas = 512, 4, 2
    g = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for prec, dtype, tol in (("bf16", torch.bfloat16, 1e-4),
                             ("fp32", torch.float32, 1e-6)):
        cfg = dataclasses.replace(GPT2Config.xl_1p3b(dtype=dtype),
                                  num_layers=2)
        tokens = torch.randint(0, cfg.vocab_size, (mb * gas, T + 1),
                               generator=g, device="cuda")
        runs = {}
        for path in ("kernels", "plain"):
            _, _, loss_fn = make_model(cfg)
            ds = train_config(mb, gas)
            if prec == "fp32":
                del ds["bf16"]
            engine, *_ = initialize(
                loss_fn=loss_fn, config=ds,
                params=init_gpt2_params(cfg, seed=1, device="cuda"))
            with plain_flash(fa) if path == "plain" \
                    else contextlib.nullcontext():
                runs[path] = [float(engine.train_batch({"tokens": tokens}))
                              for _ in range(5)]
            del engine
        rel = max(abs(a - b) / abs(b) for a, b in zip(runs["kernels"],
                                                      runs["plain"]))
        log(f"[training parity] {prec}: kernels {runs['kernels']} plain "
            f"{runs['plain']} max rel {rel:.3e} (limit {tol})")
        if not rel <= tol:
            raise AssertionError(f"training parity {prec}: {rel} > {tol}")
        out[prec] = {"kernels": runs["kernels"], "plain": runs["plain"],
                     "max_rel": rel}
    torch.cuda.empty_cache()
    return out


def _flash_qkv(torch, B, T, Hh, Dh, seed):
    """q, k, v as strided [B, H, T, D] views of one [B, T, 3 H D] qkv
    buffer, as the model slices its projection."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(B, T, 3 * Hh * Dh, generator=g, device="cuda").to(
        torch.bfloat16)
    return [t.unflatten(-1, (Hh, Dh)).transpose(1, 2)
            for t in qkv.split(Hh * Dh, dim=-1)]


def _flash_bound(B, T, Hh, Dh, products, n_bf16, n_rows):
    """(bound ms, bound_by, bytes, flops) of a causal flash kernel doing
    ``products`` matrix products a live (query, key) pair, reading and
    writing ``n_bf16`` [B, H, T, D] bf16 tensors and ``n_rows`` fp32
    [B, H, T] rows."""
    pairs = B * Hh * T * (T + 1) // 2
    flops = 2 * Dh * products * pairs
    nbytes = n_bf16 * B * Hh * T * Dh * 2 + n_rows * B * Hh * T * 4
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", nbytes, flops)


def _sdpa_bwd_ms(torch, q, k, v, do, **sdpa_kw):
    """The library yardstick of the backward: SDPA's backward (dQ, dK and
    dV, the backend SDPA picks; ``sdpa_kw`` besides ``is_causal``, as
    ``enable_gqa``) on the same q/k/v/dO. By events, one
    ``torch.autograd.grad`` call a step on a kept graph; in a CUDA graph,
    forward and backward captured together, less the forward alone.
    Returns (events ms, graph ms)."""
    import torch.nn.functional as F

    def fwd():
        # fresh leaves a call: their autograd nodes then belong to the
        # stream the call runs on (the graph's, while it is captured)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        return F.scaled_dot_product_attention(
            *leaves, **{"is_causal": True, **sdpa_kw}), leaves

    o, leaves = fwd()
    ev = _time_ms(torch, lambda: torch.autograd.grad(
        o, leaves, do, retain_graph=True), 20)
    both = _graph_ms(torch, [lambda: torch.autograd.grad(*fwd(), do)])
    return ev, both - _graph_ms(torch, [fwd])


def _bwd_kernel_ms(torch, fn, iters=5):
    """Device ms per call of the backward's three kernels (prep, main,
    cast) under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        key = next((k for k in ("prep", "wgmma", "cast") if k in e.name),
                   "other")
        out[key] = out.get(key, 0.0) + \
            (e.time_range.end - e.time_range.start) / 1e3 / iters
    return out


def phase_flash_timing(torch, train, worst):
    """The flash forward and the whole backward (prep, main kernel, cast)
    at the slice shape (B=4, T=2048, H=32, D=64, bf16, causal) and at the
    gpt1p3b heads (B=2, H=16, D=128), q/k/v strided views of one qkv
    buffer as in the model, by CUDA events and in a CUDA graph, beside
    SDPA's forward and its flash backward op and their bounds."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    T = TRAIN_T
    out = {"flash_fwd": {}, "flash_bwd": {}}
    for B, Hh, Dh, seed in ((TRAIN_MB, 32, 64, 5), (BENCH_MB, 16, 128, 7)):
        q, k, v = _flash_qkv(torch, B, T, Hh, Dh, seed)
        g = torch.Generator(device="cuda").manual_seed(seed + 1)
        do = torch.randn(B, T, Hh, Dh, generator=g, device="cuda").to(
            torch.bfloat16).transpose(1, 2)
        kw = dict(causal=True, sm_scale=Dh ** -0.5)
        o, lse = fa.flash_fwd(q, k, v, **kw)
        calls = {
            "flash_fwd": (lambda: fa.flash_fwd(q, k, v, **kw),
                          lambda: fa.flash_fwd_plain(q, k, v, **kw),
                          lambda: F.scaled_dot_product_attention(
                              q, k, v, is_causal=True),
                          (2, 4, 1)),
            "flash_bwd": (lambda: fa.flash_bwd(q, k, v, do, o, lse, None,
                                               **kw),
                          lambda: fa.flash_bwd_plain(q, k, v, do, o, lse,
                                                     None, **kw),
                          None, (5, 8, 1)),
        }
        shape = {"B": B, "T": T, "H": Hh, "D": Dh, "dtype": "bf16",
                 "causal": True}
        for name, (kern, plain, lib, work) in calls.items():
            if Dh == 64:
                err = worst[name]
            else:   # the parity phase's bf16 cases at this shape, again
                got, ref = kern(), plain()
                err = max(check_close(
                    torch, f"[flash timing] {name} {i} B{B} T{T} H{Hh} "
                    f"D{Dh}", g_, r_, bf16_max_abs=FLASH_BF16_MAX_ABS)
                    for i, g_, r_ in zip(range(3), got, ref)
                    if g_.dtype == torch.bfloat16)
            bound, by, nbytes, flops = _flash_bound(B, T, Hh, Dh, *work)
            lib_ms, lib_graph = (_time_ms(torch, lib, 20),
                                 _graph_ms(torch, [lib])) if lib else \
                _sdpa_bwd_ms(torch, q, k, v, do)
            r = {"shape": shape, "max_abs_err": err,
                 "ms": _time_ms(torch, kern, 20),
                 "graph_ms": _graph_ms(torch, [kern]),
                 "plain_ms": _time_ms(torch, plain, 3),
                 "library_ms": lib_ms, "library_graph_ms": lib_graph,
                 "bound_ms": bound, "bound_by": by, "bytes": nbytes,
                 "flops": flops}
            r["bound_share"] = bound / r["graph_ms"]
            if name == "flash_bwd":
                r["kernel_ms"] = _bwd_kernel_ms(torch, kern)
            out[name][Dh] = r
            log(f"[flash timing] {name} B{B} T{T} H{Hh} D{Dh}: "
                f"{r['ms']:.4f} ms (graph {r['graph_ms']:.4f}, plain "
                f"{r['plain_ms']:.4f}, bound {bound:.4f} by {by}, "
                f"{r['bound_share']:.1%} of it; library {r['library_ms']:.4f}"
                f", graph {r['library_graph_ms']:.4f})"
                + (f"; kernels {r['kernel_ms']}" if "kernel_ms" in r else ""))
    rows = []
    for name, by_d in out.items():
        r = dict(by_d[64])
        r.update(name=name, route="cuda", source=FLASH_SOURCE,
                 replaces=REPLACES[name], launches=train["launches"][name],
                 launches_per_step=train["launches"][name] // TRAIN_STEPS,
                 steps=TRAIN_STEPS, d128=by_d[128])
        rows.append(r)
    return rows


# ---------------------------------------------------------------- fused xent


XENT_OUTPUTS = (("xent_fwd", "lse"), ("xent_fwd", "tgt"),
                ("xent_fwd", "lsum"), ("xent_bwd_dh", "dh"),
                ("xent_bwd_de", "dE"))


def xent_inputs(torch, *, N, V, C, dtype, seed, bad_ids=True):
    """h like ln_f's output (unit rows), E like the seeded init scaled so
    the logits have std 2, targets with ignore ids (-100) and one id >= V,
    made on the card from a seed."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    h = torch.randn(N, C, generator=g, device="cuda").to(dtype)
    e = (torch.randn(V, C, generator=g, device="cuda")
         * (2.0 / math.sqrt(C))).to(dtype)
    t = torch.randint(0, V, (N,), generator=g, device="cuda",
                      dtype=torch.int32)
    if bad_ids:
        t[::9] = -100
        t[5] = V + 3
    return h, e, t


def xent_all(fx, h, e, t, scale, *, plain, **kw):
    """The three kernels (or plain versions); both backward ones from the
    plain forward's lse, so each is held against its plain version on
    equal inputs."""
    ref = fx.fused_xent_fwd_plain(h, e, t)
    lse = ref[0]
    if plain:
        return [*ref, fx.fused_xent_dh_plain(scale, h, e, t, lse, **kw),
                fx.fused_xent_de_plain(scale, h, e, t, lse, **kw)]
    return [*fx.xent_fwd(h, e, t), fx.xent_bwd_dh(scale, h, e, t, lse, **kw),
            fx.xent_bwd_de(scale, h, e, t, lse, **kw)]


def check_xent(torch, label, dn, got, ref):
    """The five xent outputs (``XENT_OUTPUTS``) against their plain
    versions: fp32 (``dn``) and the logit sum within XENT_REL of the norm,
    16-bit lse and target logit within XENT_BF16_ROWS_ABS, 16-bit dh and
    dE within XENT_BF16_MAX_REL of the largest magnitude and 2**-8 of the
    norm (fp16 held to bf16's limits). Returns each kernel's largest
    max-abs error."""
    worst = {}
    for i, ((name, out), g_, r_) in enumerate(zip(XENT_OUTPUTS, got, ref)):
        what = f"{label} {name} {out}"
        if g_.dtype != r_.dtype or g_.shape != r_.shape:
            raise AssertionError(f"{what}: {g_.dtype} {tuple(g_.shape)} != "
                                 f"plain")
        if not torch.isfinite(g_.float()).all():
            raise AssertionError(f"{what}: non-finite output")
        diff = g_.float() - r_.float()
        err = diff.abs().max().item()
        rel = (diff.norm() / r_.float().norm().clamp_min(1e-30)).item()
        if dn == "fp32" or out == "lsum":
            ok, lim = rel <= XENT_REL, f"rel-norm {XENT_REL}"
        elif i < 3:
            ok, lim = err <= XENT_BF16_ROWS_ABS, \
                f"max-abs {XENT_BF16_ROWS_ABS}"
        else:
            top = r_.float().abs().max().item()
            ok = err <= XENT_BF16_MAX_REL * top and rel <= BF16_REL_NORM
            lim = (f"max-abs {XENT_BF16_MAX_REL} x {top:.3e}, "
                   f"rel-norm {BF16_REL_NORM:.3e}")
        log(f"{what} max_abs_err={err:.3e} rel_norm_err={rel:.3e} ({lim})")
        if not ok:
            raise AssertionError(f"{what} disagrees with plain")
        worst[name] = max(worst.get(name, 0.0), err)
    return worst


def phase_xent_parity(torch):
    from deepspeed_tpu_torch.ops.kernels import fused_xent as fx
    torch.backends.cuda.matmul.allow_tf32 = False   # plain fp32 products
    worst = {"xent_fwd": 0.0, "xent_bwd_dh": 0.0, "xent_bwd_de": 0.0}
    cases = [
        # (N, V, C, ignore, z, eps, dtypes)
        (1000, 50257, XENT_C, -100, 1e-4, 0.1, ("fp32", "bf16")),
        (1000, 50304, XENT_C, None, 0.0, 0.0, ("fp32", "bf16")),
        (XENT_N, XENT_V, XENT_C, None, 0.0, 0.0, ("bf16",)),  # the slice
        # the backward's odd cluster (3 x 256) and two slab groups
        (1000, 50257, 768, -100, 1e-4, 0.1, ("bf16",)),
        (1000, 50304, 4096, -100, 0.0, 0.0, ("bf16",)),
    ]
    dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16}
    for N, V, C, ignore, z, eps, names in cases:
        for dn in names:
            h, e, t = xent_inputs(torch, N=N, V=V, C=C,
                                  dtype=dtypes[dn], seed=N + V,
                                  bad_ids=N != XENT_N)
            scale = torch.tensor([1.0 / N], device="cuda")
            kw = dict(ignore=ignore, z=z, eps=eps)
            fx.reset_launch_counts()
            got = xent_all(fx, h, e, t, scale, plain=False, **kw)
            if any(v != 1 for v in fx.LAUNCHES.values()):
                raise AssertionError(f"xent parity launches {fx.LAUNCHES}")
            ref = xent_all(fx, h, e, t, scale, plain=True, **kw)
            torch.cuda.synchronize()
            errs = check_xent(torch, f"[xent parity] {dn} N{N} V{V} C{C} "
                              f"ignore={ignore} z={z} eps={eps}", dn, got,
                              ref)
            if dn == "bf16":
                for name, err in errs.items():
                    worst[name] = max(worst[name], err)
            del h, e, t, got, ref
    torch.cuda.empty_cache()
    return worst


def gpt1p3b_config(torch, **kw):
    """``bench.py`` ``bench_train("gpt1p3b")``'s model: 24 layers, hidden
    2048, 16 heads (head_dim 128), vocab 50304, max_seq_len 2049, bf16
    params (fp32 LayerNorms), remat ``qkv_out``, flash tiles 1024."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config
    base = dict(vocab_size=50304, max_seq_len=BENCH_T + 1, num_layers=24,
                num_heads=16, hidden_size=2048, dtype=torch.bfloat16,
                param_dtype=torch.bfloat16, remat=True,
                remat_policy="qkv_out", flash_block_q=1024,
                flash_block_k=1024, xent_impl="fused")
    base.update(kw)
    return GPT2Config(**base)


def gpt1p3b_ds(bf16=True):
    """``bench.py``'s engine config for gpt1p3b (one card: ZeRO stage 0)."""
    ds = {"train_micro_batch_size_per_gpu": BENCH_MB,
          "gradient_accumulation_steps": 1,
          "optimizer": {"type": "AdamW",
                        "params": {"lr": 3e-4, "weight_decay": 0.01,
                                   "moment_dtype": "bfloat16"}},
          "bf16": {"enabled": True},
          "data_types": {"grad_accum_dtype": "bfloat16"},
          "zero_optimization": {"stage": 0},
          "gradient_clipping": 1.0, "steps_per_print": 10_000}
    if not bf16:
        del ds["bf16"], ds["data_types"]
        del ds["optimizer"]["params"]["moment_dtype"]
    return ds


def run_gpt1p3b(torch, xent_impl, trace=False):
    """2 warm-up and 5 timed steps of the gpt1p3b configuration on the
    bench's batch; per-step CUDA events, launches of the timed steps."""
    import numpy as np
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.checkpoint import init_gpt2_params
    from deepspeed_tpu_torch.models.gpt2 import make_model
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import fused_xent as fx
    cfg = gpt1p3b_config(torch, xent_impl=xent_impl)
    _, _, loss_fn = make_model(cfg)
    t0 = time.perf_counter()
    engine, *_ = initialize(loss_fn=loss_fn, config=gpt1p3b_ds(),
                            params=init_gpt2_params(cfg, seed=0,
                                                    device="cuda"))
    n_params = sum(p.numel() for p in engine.state.params)
    tokens = np.random.RandomState(0).randint(0, 50304,
                                              size=(BENCH_MB, BENCH_T + 1))
    batch = {"tokens": torch.from_numpy(tokens).to("cuda")}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    losses = [engine.train_batch(batch) for _ in range(2)]     # warm-up
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    fx.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    evs = [torch.cuda.Event(enable_timing=True)
           for _ in range(TRAIN_STEPS + 1)]
    evs[0].record()
    for i in range(TRAIN_STEPS):
        losses.append(engine.train_batch(batch))
        evs[i + 1].record()
    torch.cuda.synchronize()
    launches = {**fa.LAUNCHES, **fx.LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    step_ms = [evs[i].elapsed_time(evs[i + 1]) for i in range(TRAIN_STEPS)]
    out = {"params": n_params, "setup_s": setup_s, "step_ms": step_ms,
           "losses": [float(x) for x in losses], "launches": launches,
           "peak_bytes": peak}
    if trace:
        out["trace"] = phase_train_trace(torch, engine, batch)
    del engine, batch
    torch.cuda.empty_cache()
    return cfg, out


def phase_gpt1p3b(torch, trace):
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    # bf16 compute: the chunked run's only fp32 products are its LM head's,
    # whose bf16 operands are exact in TF32 (chunked_lm_xent's docstring)
    torch.backends.cuda.matmul.allow_tf32 = True
    cfg, fused = run_gpt1p3b(torch, "fused", trace)
    L = cfg.num_layers
    want = {"xent_fwd": TRAIN_STEPS, "xent_bwd_dh": TRAIN_STEPS,
            "xent_bwd_de": TRAIN_STEPS,
            **flash_want(fa, cfg.head_dim, cfg.dtype, 2 * L * TRAIN_STEPS,
                         L * TRAIN_STEPS)}
    if fused["launches"] != want:
        raise AssertionError(f"launches {fused['launches']} != {want}")
    losses = fused["losses"]
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    _, chunked = run_gpt1p3b(torch, "chunked")
    if any(chunked["launches"][k] for k in ("xent_fwd", "xent_bwd_dh",
                                            "xent_bwd_de")):
        raise AssertionError("the chunked run launched an xent kernel")
    rel0 = abs(chunked["losses"][0] - losses[0]) / abs(losses[0])
    if not rel0 <= 1e-5:
        raise AssertionError(f"step-0 loss fused {losses[0]} vs chunked "
                             f"{chunked['losses'][0]}: {rel0} > 1e-5")
    tokens = BENCH_MB * BENCH_T
    flops = model_flops_per_token(cfg, BENCH_T) * tokens
    for run in (fused, chunked):
        step_s = sum(run["step_ms"]) / TRAIN_STEPS / 1e3
        run.update(tokens_per_s=tokens / step_s,
                   model_tflops=flops / step_s / 1e12,
                   mfu=flops / step_s / BF16_FLOPS_PER_S)
    log(f"[gpt1p3b] {fused['params']} params; fused: step "
        f"{sum(fused['step_ms']) / TRAIN_STEPS:.1f} ms, "
        f"{fused['tokens_per_s']:.0f} tokens/s, {fused['model_tflops']:.1f} "
        f"model TFLOP/s, MFU {fused['mfu']:.4f}; chunked: step "
        f"{sum(chunked['step_ms']) / TRAIN_STEPS:.1f} ms, "
        f"{chunked['tokens_per_s']:.0f} tokens/s, MFU "
        f"{chunked['mfu']:.4f}; peak memory fused "
        f"{fused['peak_bytes'] / 2**30:.2f} GiB, chunked "
        f"{chunked['peak_bytes'] / 2**30:.2f} GiB")
    log(f"[gpt1p3b] step ms fused {[round(x, 2) for x in fused['step_ms']]}"
        f" chunked {[round(x, 2) for x in chunked['step_ms']]}")
    log(f"[gpt1p3b] losses fused {[round(x, 5) for x in losses]}; chunked "
        f"{[round(x, 5) for x in chunked['losses']]}; step-0 rel "
        f"{rel0:.3e} (limit 1e-5); launches {fused['launches']}")
    return {"fused": fused, "chunked": chunked, "flops_per_step": flops,
            "step0_rel": rel0,
            "shape": {"micro_batch": BENCH_MB, "seq": BENCH_T,
                      "layers": cfg.num_layers, "heads": cfg.num_heads,
                      "hidden": cfg.hidden_size, "vocab": cfg.vocab_size}}


@contextlib.contextmanager
def plain_xent(fx):
    """The fused-xent autograd Function with the plain versions swapped in
    for the kernels, for the training-parity comparison only."""
    saved = fx.xent_fwd, fx.xent_bwd_dh, fx.xent_bwd_de
    fx.xent_fwd, fx.xent_bwd_dh, fx.xent_bwd_de = (
        fx.fused_xent_fwd_plain, fx.fused_xent_dh_plain,
        fx.fused_xent_de_plain)
    try:
        yield
    finally:
        fx.xent_fwd, fx.xent_bwd_dh, fx.xent_bwd_de = saved


def phase_fused_training_parity(torch):
    """2 layers of the gpt1p3b configuration, seq 512, 5 steps on 5
    seeded batches: the kernels' losses against the plain versions' (bf16;
    fp32 params, compute and moments with TF32 off)."""
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.checkpoint import init_gpt2_params
    from deepspeed_tpu_torch.models.gpt2 import make_model
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import fused_xent as fx
    torch.backends.cuda.matmul.allow_tf32 = False
    T = 512
    g = torch.Generator(device="cuda").manual_seed(2)
    out = {}
    for prec, dtype, tol in (("bf16", torch.bfloat16, 1e-4),
                             ("fp32", torch.float32, 1e-6)):
        cfg = gpt1p3b_config(torch, num_layers=2, dtype=dtype,
                             param_dtype=dtype)
        # a fresh batch each step: on one repeated batch lr 3e-4 drives
        # the loss from 11.3 to 0.5 in 5 steps, and bf16 rounding of the
        # params amplifies the plain/kernel differences along the way
        batches = [torch.randint(0, cfg.vocab_size, (BENCH_MB, T + 1),
                                 generator=g, device="cuda")
                   for _ in range(5)]
        runs = {}
        for path in ("kernels", "plain"):
            _, _, loss_fn = make_model(cfg)
            engine, *_ = initialize(
                loss_fn=loss_fn, config=gpt1p3b_ds(prec == "bf16"),
                params=init_gpt2_params(cfg, seed=1, device="cuda"))
            fx.reset_launch_counts()
            with contextlib.ExitStack() as stack:
                if path == "plain":
                    stack.enter_context(plain_flash(fa))
                    stack.enter_context(plain_xent(fx))
                runs[path] = [float(engine.train_batch({"tokens": b}))
                              for b in batches]
            n = list(fx.LAUNCHES.values())
            if (path == "kernels" and not all(n)) or \
                    (path == "plain" and any(n)):
                raise AssertionError(f"{path}: xent launches {fx.LAUNCHES}")
            del engine
        rel = max(abs(a - b) / abs(b) for a, b in zip(runs["kernels"],
                                                      runs["plain"]))
        log(f"[fused training parity] {prec}: kernels {runs['kernels']} "
            f"plain {runs['plain']} max rel {rel:.3e} (limit {tol})")
        if not rel <= tol:
            raise AssertionError(f"fused training parity {prec}: {rel} > "
                                 f"{tol}")
        out[prec] = {"kernels": runs["kernels"], "plain": runs["plain"],
                     "max_rel": rel}
    torch.cuda.empty_cache()
    return out


def phase_xent_timing(torch, bench, worst):
    """Each xent kernel at the slice shape (N = 4096 tokens of one step,
    V = 50304, C = 2048, bf16), its plain version, the library pair and
    the bound and its share; the peak memory of a lone fused_lm_xent. The
    backward rows also carry their cluster plan."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.kernels import fused_xent as fx
    N, V, C = XENT_N, XENT_V, XENT_C
    h, e, t = xent_inputs(torch, N=N, V=V, C=C, dtype=torch.bfloat16,
                          seed=7, bad_ids=False)
    scale = torch.tensor([1.0 / N], device="cuda")
    kw = dict(ignore=None, z=0.0, eps=0.0)
    lse = fx.xent_fwd(h, e, t)[0]
    calls = {
        "xent_fwd": (lambda: fx.xent_fwd(h, e, t),
                     lambda: fx.fused_xent_fwd_plain(h, e, t)),
        "xent_bwd_dh": (lambda: fx.xent_bwd_dh(scale, h, e, t, lse, **kw),
                        lambda: fx.fused_xent_dh_plain(scale, h, e, t, lse,
                                                       **kw)),
        "xent_bwd_de": (lambda: fx.xent_bwd_de(scale, h, e, t, lse, **kw),
                        lambda: fx.fused_xent_de_plain(scale, h, e, t, lse,
                                                       **kw)),
    }
    # the library pair on the same h, E, t: bf16 logits, then the loss
    hs, es = (x.detach().requires_grad_() for x in (h, e))
    tl = t.long()
    lib = lambda: F.cross_entropy(F.linear(h, e), tl,  # noqa: E731
                                  reduction="sum")
    lib_fwd = _time_ms(torch, lib, 20)
    lib_fwd_graph = _graph_ms(torch, [lib], reps=10)
    loss = F.cross_entropy(F.linear(hs, es), tl, reduction="sum")
    lib_bwd = _time_ms(torch, lambda: torch.autograd.grad(
        loss, (hs, es), retain_graph=True), 20)
    del loss, hs, es
    torch.cuda.empty_cache()
    # a lone forward and backward of the loss: no [N, V] tensor
    hl, el = (x.detach().requires_grad_() for x in (h, e))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fx.fused_lm_xent(hl, el, t).backward()
    torch.cuda.synchronize()
    lone_peak = torch.cuda.max_memory_allocated() - base
    if not lone_peak < N * V * 2:
        raise AssertionError(f"fused_lm_xent peaked {lone_peak} bytes over "
                             f"its inputs: an [N, V] tensor was made")
    log(f"[xent timing] lone fused_lm_xent forward+backward: peak "
        f"{lone_peak / 2**20:.1f} MiB over its inputs (one bf16 [N, V] "
        f"tensor is {N * V * 2 / 2**20:.1f} MiB)")
    del hl, el
    mm = 2 * N * V * C
    in_bytes = (N * C + V * C) * 2 + N * 4
    work = {  # (logits products, bytes in/out)
        "xent_fwd": (1, in_bytes + 3 * N * 4),
        "xent_bwd_dh": (2, in_bytes + N * 4 + N * C * 2),
        "xent_bwd_de": (2, in_bytes + N * 4 + V * C * 2)}
    splits = fx.fwd_plan(N, V, C, sm_count(h.device))
    log(f"[xent timing] xent_fwd plan: {splits} vocabulary splits of "
        f"256-row tiles, {-(-N // fx.FWD_TOKENS) * splits} blocks")
    rows = []
    for name, (kern, plain) in calls.items():
        ms = _time_ms(torch, kern, 20)
        graph = _graph_ms(torch, [kern], reps=10)
        plain_ms = _time_ms(torch, plain, 3)
        n_mm, nbytes = work[name]
        flops = n_mm * mm
        t_ops = flops / BF16_FLOPS_PER_S * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        launches = bench["fused"]["launches"][name]
        rows.append({
            "name": name, "route": "cuda", "source": XENT_SOURCE,
            "replaces": REPLACES[name], "launches": launches,
            "launches_per_step": launches // TRAIN_STEPS,
            "steps": TRAIN_STEPS, "max_abs_err": worst[name],
            "ms": ms, "graph_ms": graph, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": {"xent_fwd": lib_fwd,
                           "xent_bwd_dh": lib_bwd}.get(name),
            "library_calls": "F.linear + F.cross_entropy(sum), bf16; "
                             "forward, and backward (dh and dE together)",
            "library_fwd_ms": lib_fwd, "library_bwd_ms": lib_bwd,
            "lone_call_peak_bytes": lone_peak,
            "shape": {"N": N, "V": V, "C": C, "dtype": "bf16"},
            "bytes": nbytes, "flops": flops})
        rows[-1]["bound_share"] = rows[-1]["bound_ms"] / graph
        if name == "xent_fwd":
            rows[-1]["plan"] = {"splits": splits}
            rows[-1]["library_graph_ms"] = lib_fwd_graph
        else:
            CL, W, G = fx.bwd_plan(C)
            rows[-1]["plan"] = {"cluster": CL, "slab_width": W,
                                "slab_groups": G}
            log(f"[xent timing] {name}: cluster {CL} x slab {W} x {G} "
                f"group(s)")
        log(f"[xent timing] {name}: {ms:.4f} ms (graph {graph:.4f}, plain "
            f"{plain_ms:.4f}, bound {max(t_ops, t_bytes):.4f} by "
            f"{rows[-1]['bound_by']}, {rows[-1]['bound_share']:.1%} of it; "
            f"library forward {lib_fwd:.4f} (graph {lib_fwd_graph:.4f}), "
            f"backward {lib_bwd:.4f})")
    del h, e, t
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------- WOQ serving


def _quant_case(torch, qz, x, *, bits, gs, sym, what):
    """One quantize_blockwise launch against its plain version on the
    same tensor: codes, scales (and zeros) must be identical. Returns
    the largest difference (0.0)."""
    got = qz.quantize_blockwise(x, bits=bits, group_size=gs, symmetric=sym)
    ref = qz.quantize_blockwise_plain(x, bits=bits, group_size=gs,
                                      symmetric=sym)
    torch.cuda.synchronize()
    pairs = [(got.values, ref.values), (got.scale, ref.scale)]
    if not sym:
        pairs.append((got.zero, ref.zero))
    err = max((a.float() - b.float()).abs().max().item() for a, b in pairs)
    same = all(a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)
               for a, b in pairs)
    log(f"[woq parity] {'quantize_sym' if sym else 'quantize_asym'} {what} "
        f"bits={bits} group={gs}: codes and scales "
        f"{'identical' if same else 'DIFFER'} (max diff {err:.3e})")
    if not same:
        raise AssertionError(f"quantize {what} differs from plain")
    return err


def _check_fp6(torch, what, got, ref):
    diff = got.float() - ref.float()
    err = diff.abs().max().item()
    rel = (diff.norm() / ref.float().norm().clamp_min(1e-30)).item()
    if got.dtype == torch.bfloat16:
        ok = err <= FP6_BF16_MAX_ABS and rel <= BF16_REL_NORM
        lim = f"max-abs {FP6_BF16_MAX_ABS}, rel-norm {BF16_REL_NORM:.3e}"
    else:
        ok, lim = rel <= FP6_FP32_REL, f"rel-norm {FP6_FP32_REL}"
    log(f"{what} max_abs_err={err:.3e} rel_norm_err={rel:.3e} ({lim})")
    if not ok or not torch.isfinite(got.float()).all():
        raise AssertionError(f"{what} disagrees with plain: {err}, {rel}")
    return err


def phase_woq_parity(torch):
    """B6 both kernels, B5, and the paged kernels at Llama-2-7B's heads
    (H = KV = 32, D = 128), each against its plain version."""
    import numpy as np
    from deepspeed_tpu_torch.ops.kernels import fp6_gemm as f6
    from deepspeed_tpu_torch.ops.kernels import paged_attention as pa
    from deepspeed_tpu_torch.ops.kernels import quantization as qz
    torch.backends.cuda.matmul.allow_tf32 = False   # plain fp32 products
    g = torch.Generator(device="cuda").manual_seed(14)
    worst = {k: 0.0 for k in ("quantize_sym", "quantize_asym", "fp6_matmul",
                              "paged_prefill", "paged_decode")}
    # B6: 300 x 517 is no multiple of 64 or 128 (a ragged tail group);
    # the first group is all zeros, two spans are 40x and 1e-3x
    x = torch.randn(300, 517, generator=g, device="cuda")
    x.view(-1)[:128] = 0.0
    x.view(-1)[1000:3000] *= 40.0
    x.view(-1)[5000:7000] *= 1e-3
    for dt in (torch.float32, torch.bfloat16):
        for sym in (True, False):
            for bits in (8, 4):
                for gs in (64, 128):
                    err = _quant_case(torch, qz, x.to(dt), bits=bits, gs=gs,
                                      sym=sym, what=f"[300, 517] "
                                      f"{str(dt)[6:]}")
                    k = "quantize_sym" if sym else "quantize_asym"
                    worst[k] = max(worst[k], err)
    del x
    # the Llama-2-7B leaves the int runs quantize at load: all of 8/4 bits
    # x sym/asym on gate_proj, the symmetric kernel on the other two
    for (K, N), sym_only in (((4096, 11008), False), ((4096, 4096), True),
                             ((11008, 4096), True)):
        leaf = (torch.randn(K, N, generator=g, device="cuda")
                / 64.0).to(torch.bfloat16)
        for bits in (8, 4):
            for sym in (True,) if sym_only else (True, False):
                k = "quantize_sym" if sym else "quantize_asym"
                worst[k] = max(worst[k], _quant_case(
                    torch, qz, leaf, bits=bits, gs=128, sym=sym,
                    what=f"Llama-2-7B leaf [{K}, {N}] bfloat16"))
        del leaf
    # B5: the four Llama-2-7B weight shapes, and K = 1000, N / 4 = 260
    # (ragged depth and column tiles, no 16-byte chunks); the projections
    # also at the serving prefill step's M = 64 x 512 rows, bf16
    shapes = list(W7_SHAPES.items()) + [("ragged", (1000, 1040))]
    for wname, (K, N) in shapes:
        w = torch.randn(K, N, generator=g, device="cuda") / math.sqrt(K)
        fw = f6.fp6_gemm_pack(w)
        del w
        ms = [1, 64, 333, 4096]
        if wname == "down_proj":
            ms += [128, 129]          # either side of the route threshold
        if wname in list(W7_SHAPES)[:3]:
            ms.append(WOQ_SEQS * WOQ_PROMPT)
        for M in ms:
            xm = torch.randn(M, K, generator=g, device="cuda")
            for dt in (torch.bfloat16, torch.float32)[:1 if M > 4096 else 2]:
                got = f6.fp6_matmul(xm.to(dt), fw)
                if not torch.equal(got, f6.fp6_matmul(xm.to(dt), fw)):
                    raise AssertionError(f"fp6_matmul {wname} M={M} "
                                         f"{dt}: two calls differ")
                ref = f6.fp6_matmul_plain(xm.to(dt), fw)
                plan = f6.fp6_plan(M, K, N // 4, sm_count(xm.device))
                err = _check_fp6(torch, f"[woq parity] fp6_matmul {wname} "
                                 f"M={M} K={K} N={N} {str(dt)[6:]} "
                                 f"{plan.route} ks={plan.ks}", got, ref)
                if dt is torch.bfloat16:
                    worst["fp6_matmul"] = max(worst["fp6_matmul"], err)
                del got, ref
        del fw
    torch.cuda.empty_cache()
    # the paged kernels at D = 128, H = KV = 32, with the existing limits
    rng = np.random.default_rng(14)
    dec = rng.integers(1, 641, 64)
    dec[5] = 0                                        # an idle slot
    cases = [("paged_prefill", 4, 512, [512, 560, 600, 640], 640, 1),
             ("paged_prefill", 4, 256, [256, 512, 640, 300], 64, 10),
             ("paged_decode", 64, 1, dec, 640, 1),
             ("paged_decode", 16, 1, dec[:16], 64, 10)]
    for dtype in (torch.float32, torch.bfloat16):
        for name, S, C, lens, bs, maxb in cases:
            q, kp, vp, tab, st, ln = paged_inputs(
                torch, rng, S=S, C=C, lens=lens, block_size=bs, maxb=maxb,
                dtype=dtype, heads=(H7, KV7, D7))
            kw = dict(block_size=bs, sm_scale=D7 ** -0.5,
                      sliding_window=None, num_kv_heads=KV7)
            got = getattr(pa, name)(q, kp, vp, tab, st, ln, **kw)
            ref = pa.paged_attention_plain(q, kp, vp, tab, st, ln, **kw)
            torch.cuda.synchronize()
            idle = ln == 0
            if idle.any() and got[idle].abs().max().item() != 0.0:
                raise AssertionError(f"{name}: idle slot not zero")
            if not torch.isfinite(got.float()).all():
                raise AssertionError(f"{name}: non-finite output")
            err = check_close(
                torch, f"[woq parity] {name} {str(dtype)[6:]} H=KV=32 "
                f"D=128 bs={bs} maxb={maxb}", got, ref,
                bf16_max_abs=PAGED7_BF16_MAX_ABS)
            if dtype is torch.bfloat16:
                worst[name] = max(worst[name], err)
    torch.cuda.empty_cache()
    return worst


def _woq_config(mode, group_size=128):
    return {"quantized_weights": {**WOQ_MODES[mode],
                                  "group_size": group_size,
                                  "excluded_modules": WOQ_EXCLUDED}}


def phase_woq_serving(torch, trace=False):
    """Llama-2-7B at full width and depth, bf16, seeded weights made on
    the card, served through ``InferenceEngineV2.generate`` as the JAX
    package's 7B example serves it, dense and in three WOQ modes; one
    engine alive at a time. With ``trace``, a profiler window over each
    engine's prefill and one decode loop call follows its run."""
    import numpy as np
    from deepspeed_tpu_torch.checkpoint import init_llama_params
    from deepspeed_tpu_torch.inference.quantization import (
        quantize_model_params, woq_memory_bytes)
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceConfig)
    from deepspeed_tpu_torch.models.llama import LlamaConfig
    from deepspeed_tpu_torch.ops.kernels import fp6_gemm as f6
    from deepspeed_tpu_torch.ops.kernels import paged_attention as pa
    from deepspeed_tpu_torch.ops.kernels import quantization as qz
    cfg = LlamaConfig.llama2_7b(max_seq_len=2048, dtype=torch.bfloat16)
    rcfg = RaggedInferenceConfig(
        max_seqs=WOQ_SEQS, chunk_size=WOQ_PROMPT,
        block_size=WOQ_PROMPT + WOQ_GEN, num_blocks=WOQ_SEQS + 2,
        max_blocks_per_seq=1, dtype="bfloat16", decode_loop_steps=32,
        attention_impl="paged_flash")
    prompts = np.random.RandomState(0).randint(
        1, cfg.vocab_size, size=(WOQ_SEQS, WOQ_PROMPT)).tolist()
    L = cfg.num_layers
    mm_per_step = 7 * L               # q, k, v, o, gate, up, down
    runs, first = {}, None
    for mode in WOQ_MODES:
        t0 = time.perf_counter()
        params = init_llama_params(cfg, seed=0, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        dense_bytes = woq_memory_bytes(params)
        qz.reset_launch_counts()
        f6.reset_launch_counts()
        t0 = time.perf_counter()
        if WOQ_MODES[mode] is not None:
            params = quantize_model_params(params, _woq_config(mode))
        torch.cuda.synchronize()
        quant_s = time.perf_counter() - t0
        load_launches = {**qz.LAUNCHES, **f6.LAUNCHES}
        weight_bytes = woq_memory_bytes(params)
        eng = InferenceEngineV2(cfg, params, rcfg, device="cuda")
        if rcfg.effective_chunk != WOQ_CHUNK:
            raise AssertionError(f"[woq serving] prefill chunk "
                                 f"{rcfg.effective_chunk}")
        del params
        torch.cuda.empty_cache()
        # warm-up outside the measured run: a prefill, one decode loop
        # call and a put() tail
        eng.generate([prompts[0][:80]], max_new_tokens=40)
        for k in eng.timing:
            eng.timing[k] = 0 if isinstance(eng.timing[k], int) else 0.0

        pa.reset_launch_counts()
        f6.reset_launch_counts()
        qz.reset_launch_counts()
        eng.runner.step_counts = {"prefill": 0, "decode": 0}
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.generate(prompts, max_new_tokens=WOQ_GEN)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {**pa.LAUNCHES, **f6.LAUNCHES, **qz.LAUNCHES}
        steps = dict(eng.runner.step_counts)
        peak = torch.cuda.max_memory_allocated()

        fused = mode == "fp6_fused"
        want = {"paged_prefill": L * steps["prefill"],
                "paged_decode": L * steps["decode"],
                "fp6_matmul": mm_per_step * sum(steps.values()) if fused
                else 0, "quantize_sym": 0, "quantize_asym": 0}
        if launches != want:
            raise AssertionError(f"[woq serving] {mode}: launches "
                                 f"{launches} != {want}")
        want_load = mm_per_step if mode in ("int8", "int4") else 0
        if load_launches != {"quantize_sym": want_load, "quantize_asym": 0,
                             "fp6_matmul": 0}:
            raise AssertionError(f"[woq serving] {mode}: load launches "
                                 f"{load_launches}, want {want_load} "
                                 f"quantize_sym")
        if not (steps["prefill"] and steps["decode"]):
            raise AssertionError(f"a kernel of the path never ran: {steps}")
        if any(len(o) != WOQ_GEN for o in out) \
                or not all(0 <= t < cfg.vocab_size for o in out for t in o):
            raise AssertionError("wrong output lengths or token ids")
        if eng.free_blocks != rcfg.num_blocks:
            raise AssertionError("KV blocks leaked")
        logits = eng.put([999], [prompts[0]])[999]
        eng.flush(999)
        if not np.isfinite(logits).all():
            raise AssertionError("non-finite logits")
        tm = eng.timing
        first = first or [o[0] for o in out]
        agree = sum(o[0] == f for o, f in zip(out, first)) / len(out)
        runs[mode] = {
            "weight_bytes": weight_bytes, "dense_bytes": dense_bytes,
            "init_s": init_s, "quantize_s": quant_s,
            "load_launches": load_launches, "launches": launches,
            "steps": steps, "wall_s": wall, "prefill_s": tm["prefill_s"],
            "prefill_tokens": tm["prefill_tokens"],
            "decode_s": tm["decode_s"], "decode_tokens": tm["decode_tokens"],
            "decode_tok_s": tm["decode_tokens"] / tm["decode_s"],
            "peak_bytes": peak, "first_token_agreement_with_bf16": agree,
            "pool_bytes": eng.kv_cache.memory_bytes(),
            "first_tokens": [o[0] for o in out]}
        log(f"[woq serving] {mode}: weights {weight_bytes / 1e9:.3f} GB "
            f"(dense {dense_bytes / 1e9:.3f}), quantize {quant_s:.3f} s "
            f"({load_launches['quantize_sym']} quantize_sym launches), "
            f"steps {steps}, prefill {tm['prefill_tokens']} tokens in "
            f"{tm['prefill_s']:.4f} s, decode {tm['decode_tokens']} tokens "
            f"in {tm['decode_s']:.4f} s = {runs[mode]['decode_tok_s']:.1f} "
            f"tok/s (earlier kernels {WOQ_EARLIER_TOK_S[mode]}"
            + (f"; prefill {WOQ_EARLIER_FP6_PREFILL_S} s" if fused else "")
            + f"), wall {wall:.3f} s, peak memory {peak / 2**30:.2f} GiB, "
            f"first tokens agree with bf16 {agree:.3f}; launches {launches}")
        if trace:
            log(f"[trace] Llama-2-7B {mode}:")
            runs[mode]["trace"] = phase_trace(torch, eng, prompts)
            log(f"[trace] Llama-2-7B {mode} decode window: device idle "
                f"share {runs[mode]['trace']['decode'].get('idle_share')}")
        del eng
        torch.cuda.empty_cache()
    return runs


def phase_woq_engine_parity(torch):
    """Llama-2-7B width with 2 layers, TF32 off: each WOQ engine against a
    dense engine given ``dequantize_tree`` of the same tree, whose matmuls
    are the plain version of the packed ones. fp32: fused fp6 and int8,
    token-identical, fp6 prefill logits within 1e-4 of the norm. bf16
    (the fp6 GEMM's tensor-core kernel, as phase 15 serves it): fused fp6,
    prefill and 16 teacher-forced decode steps, logits within
    WOQ_BF16_LOGITS_REL of the norm and WOQ_BF16_LOGITS_MAX_ABS."""
    import numpy as np
    from deepspeed_tpu_torch.checkpoint import init_llama_params
    from deepspeed_tpu_torch.inference.quantization import (
        dequantize_tree, quantize_model_params)
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceConfig)
    from deepspeed_tpu_torch.models.llama import LlamaConfig
    from deepspeed_tpu_torch.ops.kernels import fp6_gemm as f6
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = LlamaConfig.llama2_7b(num_layers=2, max_seq_len=2048,
                                dtype=torch.float32)
    rng = np.random.default_rng(3)
    prompts = rng.integers(1, cfg.vocab_size, (4, 128)).tolist()
    forced = rng.integers(1, cfg.vocab_size, (4, 16)).tolist()
    uids = list(range(len(prompts)))

    def engine(cfg, tree):
        rcfg = RaggedInferenceConfig(
            max_seqs=4, chunk_size=64, block_size=64, num_blocks=32,
            max_blocks_per_seq=4, dtype=str(cfg.dtype)[6:],
            decode_loop_steps=8, attention_impl="paged_flash")
        return InferenceEngineV2(cfg, tree, rcfg, device="cuda")

    def serve(cfg, tree):
        eng = engine(cfg, tree)
        return (eng.generate(prompts, max_new_tokens=16),
                eng.put([9], [prompts[0]])[9])

    def teacher_forced(cfg, tree):
        """[17, 4, V] logits: after the prompts, then after each forced
        token (the same tokens for both engines)."""
        eng = engine(cfg, tree)
        out = [eng.put(uids, prompts)]
        for t in range(len(forced[0])):
            out.append(eng.put(uids, [[f[t]] for f in forced]))
        return np.stack([np.stack([o[u] for u in uids]) for o in out])

    def rel_norm(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    res = {}
    params = init_llama_params(cfg, seed=3, device="cuda",
                               dtype=torch.float32)
    for mode in ("fp6_fused", "int8"):
        tree = quantize_model_params(params, _woq_config(mode))
        f6.reset_launch_counts()
        gen_q, log_q = serve(cfg, tree)
        n_kernel = f6.LAUNCHES["fp6_matmul"]
        gen_d, log_d = serve(cfg, dequantize_tree(tree))
        rel = rel_norm(log_q, log_d)
        log(f"[woq engine] fp32 {mode} against the dense engine on its "
            f"dequantized tree: tokens "
            f"{'identical' if gen_q == gen_d else 'DIFFER'} over 4 x 16; "
            f"prefill logits rel-norm {rel:.3e} (limit 1e-4); fp6_matmul "
            f"launches {n_kernel}")
        if (mode == "fp6_fused") != (n_kernel > 0) \
                or f6.LAUNCHES["fp6_matmul"] != n_kernel:
            raise AssertionError(f"{mode}: fp6_matmul launches {n_kernel}, "
                                 f"then {f6.LAUNCHES['fp6_matmul']}")
        if gen_q != gen_d or not rel <= 1e-4:
            raise AssertionError(f"fp32 {mode} engine and the dense engine "
                                 f"disagree")
        res[f"fp32_{mode}_logits_rel"] = rel
        res[f"fp32_{mode}_launches"] = n_kernel
        del tree
    del params
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    tree = quantize_model_params(
        init_llama_params(cfg, seed=3, device="cuda", dtype=torch.bfloat16),
        _woq_config("fp6_fused"))
    f6.reset_launch_counts()
    log_q = teacher_forced(cfg, tree)
    n_kernel = f6.LAUNCHES["fp6_matmul"]
    log_d = teacher_forced(cfg, dequantize_tree(tree))
    rel = rel_norm(log_q, log_d)
    rel0 = rel_norm(log_q[0], log_d[0])
    err = float(np.abs(log_q - log_d).max())
    agree = float((log_q.argmax(-1) == log_d.argmax(-1)).mean())
    log(f"[woq engine] bf16 fp6_fused against the dense engine on its "
        f"dequantized tree, prefill + 16 teacher-forced decode steps: "
        f"logits rel-norm {rel:.3e} (prefill alone {rel0:.3e}; limit "
        f"{WOQ_BF16_LOGITS_REL}), max-abs {err:.3e} (limit "
        f"{WOQ_BF16_LOGITS_MAX_ABS}), argmax agreement {agree:.4f}; "
        f"fp6_matmul launches {n_kernel}")
    if not n_kernel or f6.LAUNCHES["fp6_matmul"] != n_kernel:
        raise AssertionError(f"bf16 fp6: launches {n_kernel}, then "
                             f"{f6.LAUNCHES['fp6_matmul']}")
    if not (np.isfinite(log_q).all() and rel <= WOQ_BF16_LOGITS_REL
            and err <= WOQ_BF16_LOGITS_MAX_ABS):
        raise AssertionError("bf16 fp6 engine and the dense engine disagree")
    res.update(bf16_fp6_fused_logits_rel=rel,
               bf16_fp6_fused_prefill_logits_rel=rel0,
               bf16_fp6_fused_max_abs=err,
               bf16_fp6_fused_argmax_agreement=agree,
               bf16_fp6_fused_launches=n_kernel)
    del tree
    torch.cuda.empty_cache()
    return res


def _time_ring_ms(torch, fns, iters):
    """Mean ms of ``iters`` calls cycling through ``fns`` (each on its own
    copy of the operands, so that the ring exceeds the 50 MB L2 cache and
    every call reads its weight from device memory, as in decode)."""
    ring = itertools.cycle(fns)
    return _time_ms(torch, lambda: next(ring)(), iters)


FP6_SWEEP_MS = (128, 129, 192, 256, 384, 512, 768, 1024, 1536, 2048, 4096)


def fp6_plan_sweep(torch):
    """``--fp6-sweep`` only: fp6_matmul on the three Llama-2-7B projection
    shapes at M from 128 to 4096 under every launch plan the wgmma kernel
    takes there (64, 128 or 256 rows a block; K split into 1-8 ranges that
    one wave of blocks holds), in a CUDA graph, each call on its own
    weight copy (the copies exceed the L2 cache), beside torch.matmul on
    the unpacked bf16 weight; every plan's output held against the plain
    version. ``fp6_plan``'s choices are read from this table."""
    from deepspeed_tpu_torch.ops.kernels import fp6_gemm as f6
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(23)
    sms = sm_count(torch.device("cuda"))
    table = []
    for wname, (K, N) in list(W7_SHAPES.items())[:3]:
        J = N // 4
        w = torch.randn(K, N, generator=g, device="cuda") / math.sqrt(K)
        fw = f6.fp6_gemm_pack(w)
        del w
        wbytes = 3 * K * J + 4 * J * 4
        fws = [f6.Fp6GemmWeight(fw.bytes3.clone(), fw.scale.clone(),
                                fw.shape)
               for _ in range(max(2, math.ceil(150e6 / wbytes)))]
        wb = f6.fp6_gemm_unpack(fw).to(torch.bfloat16)
        wbs = [wb.clone() for _ in range(max(2, math.ceil(150e6 /
                                                          (K * N * 2))))]
        slabs = -(-K // f6.SK_BK)
        for M in FP6_SWEEP_MS:
            x = torch.randn(M, K, generator=g, device="cuda").to(
                torch.bfloat16)
            ref = f6.fp6_matmul_plain(x, fw)
            chosen = f6.fp6_plan(M, K, J, sms)
            lib = _graph_ms(torch, [lambda b=b: torch.matmul(x, b)
                                    for b in wbs])
            row = {"weight": wname, "M": M, "library_graph_ms": lib,
                   "chosen": chosen._asdict(), "plans": []}
            out = torch.empty(M, N, dtype=torch.bfloat16, device="cuda")
            seen = set()
            for mt in (1, 2, 4):
                tiles = -(-J // f6.SK_JT) * -(-M // (f6.SK_BM * mt))
                if mt == 1 and M > 256:
                    continue
                for want in range(1, f6.SK_MAX_CLUSTER + 1):
                    kps = -(-slabs // want) * f6.SK_BK
                    ks = -(-K // kps)
                    if (mt, ks) in seen or (
                            ks > 1 and ks * tiles > (2 if mt == 1 else 1)
                            * sms):
                        continue
                    seen.add((mt, ks))
                    plan = f6.Fp6Plan(
                        "decode" if mt < 4 else "prefill", mt, ks, kps,
                        (ks, -(-J // f6.SK_JT), -(-M // (f6.SK_BM * mt))),
                        256 if mt == 1 else 512)
                    f6._launch(x, fws[0], out, plan)
                    check_close(torch, f"[fp6 sweep] {wname} M={M} mt={mt} "
                                f"ks={ks}", out, ref,
                                bf16_max_abs=FP6_BF16_MAX_ABS)
                    ms = _graph_ms(torch, [
                        lambda f=f: f6._launch(x, f, out, plan)
                        for f in fws])
                    row["plans"].append({"mt": mt, "ks": ks, "ms": ms})
            best = min(row["plans"], key=lambda r: r["ms"])
            mine = next(r for r in row["plans"] if (r["mt"], r["ks"]) ==
                        (chosen.mt, chosen.ks))
            row.update(best=best, chosen_ms=mine["ms"])
            log(f"[fp6 sweep] {wname} M={M}: torch.matmul {lib:.4f} ms; "
                f"fp6_plan mt={chosen.mt} ks={chosen.ks} {mine['ms']:.4f} "
                f"({mine['ms'] / lib:.2f}x); best mt={best['mt']} "
                f"ks={best['ks']} {best['ms']:.4f}; all " + ", ".join(
                    f"{r['mt']}/{r['ks']} {r['ms']:.4f}"
                    for r in row["plans"]))
            table.append(row)
        del fws, wbs, fw, wb
        torch.cuda.empty_cache()
    return table


def phase_woq_timing(torch, woq, worst, rows):
    """fp6_matmul at M = 64 and 4096 for each Llama-2-7B projection, with
    its plain version, ``torch.matmul`` against the unpacked bf16 weight
    and the bound; quantize_sym / quantize_asym on the [4096, 11008] bf16
    leaf; the paged kernels at Llama-2-7B's serving shapes (D = 128)."""
    import numpy as np
    from deepspeed_tpu_torch.ops.kernels import fp6_gemm as f6
    from deepspeed_tpu_torch.ops.kernels import paged_attention as pa
    from deepspeed_tpu_torch.ops.kernels import quantization as qz
    g = torch.Generator(device="cuda").manual_seed(17)
    shapes = []
    for wname, (K, N) in list(W7_SHAPES.items())[:3]:
        J = N // 4
        w = torch.randn(K, N, generator=g, device="cuda") / math.sqrt(K)
        fw = f6.fp6_gemm_pack(w)
        del w
        wbytes = 3 * K * J + 4 * J * 4
        n = max(2, math.ceil(150e6 / wbytes))
        fws = [f6.Fp6GemmWeight(fw.bytes3.clone(), fw.scale.clone(),
                                fw.shape) for _ in range(n)]
        wb = f6.fp6_gemm_unpack(fw).to(torch.bfloat16)
        wbs = [wb.clone() for _ in range(max(2, math.ceil(150e6 /
                                                          (K * N * 2))))]
        for M in (64, 256, 4096):
            x = torch.randn(M, K, generator=g, device="cuda").to(
                torch.bfloat16)
            plan = f6.fp6_plan(M, K, J, sm_count(x.device))
            ms = _time_ring_ms(torch, [lambda f=f: f6.fp6_matmul(x, f)
                                       for f in fws], 50)
            plain_ms = _time_ring_ms(
                torch, [lambda f=f: f6.fp6_matmul_plain(x, f)
                        for f in fws], 3)
            lib_ms = _time_ring_ms(torch, [lambda b=b: torch.matmul(x, b)
                                           for b in wbs], 50)
            # without the host's launch cost, each call on its own copy
            graph_ms = _graph_ms(torch, [lambda f=f: f6.fp6_matmul(x, f)
                                         for f in fws])
            lib_graph_ms = _graph_ms(torch, [lambda b=b: torch.matmul(x, b)
                                             for b in wbs])
            # a K split's fp32 partials are written once and read once
            ws_bytes = 2 * plan.ks * M * N * 4 if plan.ks > 1 else 0
            nbytes = M * K * 2 + wbytes + M * N * 2 + ws_bytes
            flops = 2 * M * K * N
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / BF16_FLOPS_PER_S * 1e3
            shapes.append({
                "weight": wname, "M": M, "K": K, "N": N, "ms": ms,
                "plain_ms": plain_ms, "library_ms": lib_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bound_share": max(t_bytes, t_ops) / ms,
                "vs_library": ms / lib_ms, "graph_ms": graph_ms,
                "library_graph_ms": lib_graph_ms,
                "graph_vs_library": graph_ms / lib_graph_ms,
                "graph_bound_share": max(t_bytes, t_ops) / graph_ms,
                "plan": {"route": plan.route, "row_tiles": plan.mt,
                         "k_splits": plan.ks, "k_per_split": plan.kps,
                         "grid": plan.grid, "threads": plan.block},
                "bytes": nbytes, "workspace_bytes": ws_bytes,
                "flops": flops, "weight_copies": len(fws)})
            log(f"[woq timing] fp6_matmul {wname} M={M} K={K} N={N}: "
                f"{ms:.4f} ms (plain {plain_ms:.4f}, torch.matmul bf16 "
                f"{lib_ms:.4f}: {ms / lib_ms:.2f}x; in a CUDA graph "
                f"{graph_ms:.4f} against {lib_graph_ms:.4f}: "
                f"{graph_ms / lib_graph_ms:.2f}x; bound "
                f"{max(t_bytes, t_ops):.4f} by {shapes[-1]['bound_by']} "
                f"(workspace {ws_bytes} B), {shapes[-1]['bound_share']:.1%}"
                f" of it, {shapes[-1]['graph_bound_share']:.1%} in the "
                f"graph; plan {shapes[-1]['plan']})")
        del fws, wbs, fw, wb
        torch.cuda.empty_cache()
    fp6_run = woq["fp6_fused"]
    fp6_steps = sum(fp6_run["steps"].values())
    # the row reports the shape that loses most to torch.matmul on the
    # device (in a CUDA graph: back-to-back calls at M = 64 measure the
    # host's launch cost, which the events' ratio then ranks instead)
    main = max(shapes, key=lambda r: r["graph_vs_library"])
    out = [{"name": "fp6_matmul", "route": "cuda", "source": FP6_SOURCE,
            "replaces": REPLACES["fp6_matmul"],
            "launches": fp6_run["launches"]["fp6_matmul"],
            "launches_per_step": fp6_run["launches"]["fp6_matmul"]
            // fp6_steps, "steps": fp6_steps,
            "max_abs_err": worst["fp6_matmul"],
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "bytes", "flops",
                                    "bound_share", "plan", "graph_ms",
                                    "library_graph_ms", "workspace_bytes")},
            "worst_vs_library": main["vs_library"],
            "worst_graph_vs_library": main["graph_vs_library"],
            "library_call": "torch.matmul(x, W) with W the unpacked weight "
                            "in bf16",
            "shape": {k: main[k] for k in ("weight", "M", "K", "N")},
            "shapes": shapes}]
    # B6 on the Llama-2-7B gate_proj leaf, bf16, 8 bits, group 128
    leaf = (torch.randn(4096, 11008, generator=g, device="cuda")
            / 64.0).to(torch.bfloat16)
    n = leaf.numel()
    ng = -(-n // 128)
    int8_run = woq["int8"]
    for name, sym in (("quantize_sym", True), ("quantize_asym", False)):
        kw = dict(bits=8, group_size=128, symmetric=sym)
        ms = _time_ms(torch, lambda: qz.quantize_blockwise(leaf, **kw), 50)
        plain_ms = _time_ms(torch, lambda: qz.quantize_blockwise_plain(
            leaf, **kw), 5)
        nbytes = n * 2 + n + ng * 4 * (1 if sym else 2)
        flops = 3 * n                 # a max, a division, a rounding
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOPS_PER_S * 1e3
        launches = int8_run["load_launches"][name]
        # device and CUDA-graph times, also at 4 bits and at the JAX
        # default's groups of 256 (quantize_blockwise, quantization.py:105)
        times = {}
        for bits, gs in ((8, 128), (4, 128), (8, 256)):
            kv = dict(bits=bits, group_size=gs, symmetric=sym)
            fn = lambda kv=kv: qz.quantize_blockwise(leaf, **kv)  # noqa
            ngv = -(-n // gs)
            b_v = n * 2 + n * bits // 8 + ngv * 4 * (1 if sym else 2)
            times[f"{bits}bit_g{gs}"] = {
                "device_ms": _device_ms(torch, fn, 20),
                "graph_ms": _graph_ms(torch, [fn]),
                "bound_ms": max(b_v / HBM_BYTES_PER_S, flops /
                                F32_FLOPS_PER_S) * 1e3,
                "plan": qz.quant_plan(gs, leaf.dtype)._asdict()}
        log(f"[woq timing] {name} [4096, 11008] bf16 device / graph ms: "
            + "; ".join(f"{k} {v['device_ms']} / {v['graph_ms']:.4f} "
                        f"(bound {v['bound_ms']:.4f})"
                        for k, v in times.items()))
        out.append({
            "name": name, "route": "cuda", "source": QUANT_SOURCE,
            "replaces": REPLACES[name], "launches": launches,
            "on_main_path": sym,
            "launches_note": "at load, one per quantized weight of the "
                             "int8 run" if sym else
                             "no caller passes symmetric=False; held in "
                             "the parity phase only",
            "max_abs_err": worst[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "library_call": "none: no single PyTorch call computes it",
            "shape": {"leaf": [4096, 11008], "dtype": "bf16", "bits": 8,
                      "group_size": 128},
            "device_ms": times["8bit_g128"]["device_ms"],
            "graph_ms": times["8bit_g128"]["graph_ms"], "variants": times,
            "bytes": nbytes, "flops": flops})
        log(f"[woq timing] {name} [4096, 11008] bf16: {ms:.4f} ms (plain "
            f"{plain_ms:.4f}, bound {max(t_bytes, t_ops):.4f} by "
            f"{out[-1]['bound_by']})")
    del leaf
    torch.cuda.empty_cache()
    # the paged kernels at the 7B serving shapes: the second prefill step
    # (64 slots x 256 queries over 512 keys) and mid-decode (64 slots at
    # context 576)
    rng = np.random.default_rng(17)
    bf16_run = woq["bf16"]
    for row in rows:
        if row["name"] not in ("paged_prefill", "paged_decode"):
            continue
        C = WOQ_CHUNK if row["name"] == "paged_prefill" else 1
        ctx = WOQ_PROMPT if C > 1 else WOQ_PROMPT + WOQ_GEN // 2
        t = time_paged(torch, rng, row["name"], S=WOQ_SEQS, C=C, ctx=ctx,
                       block_size=WOQ_PROMPT + WOQ_GEN, maxb=1,
                       heads=(H7, KV7, D7),
                       bf16_max_abs=PAGED7_BF16_MAX_ABS)
        t["launches"] = bf16_run["launches"][row["name"]]
        t["max_abs_err"] = max(t["max_abs_err"], worst[row["name"]])
        row["llama2_7b"] = t
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- ops slice


def _bound(nbytes, flops, flops_per_s):
    """The least time for the work: bytes over the memory rate or
    operations over the compute rate, the larger (ms), and which."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _device_ms(torch, fn, iters):
    """Device time per call: the summed durations of the device events
    (kernels, copies) of ``iters`` calls under torch.profiler, over
    ``iters``; None when the trace holds no device event. Unlike CUDA
    events around back-to-back calls it leaves out the host's time
    between launches, which a call of a few tens of microseconds can
    exceed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not evs:
        return None
    return sum(e.time_range.end - e.time_range.start for e in evs) / iters \
        / 1e3


def _op_row(name, source, launches, err, ms, plain_ms, lib_ms, nbytes, flops,
            flops_per_s, **extra):
    bound_ms, by = _bound(nbytes, flops, flops_per_s)
    dev = extra.get("device_ms")
    lib_dev = extra.get("library_device_ms")
    log(f"[ops timing] {name}: {ms:.4f} ms (plain {plain_ms:.4f}, library "
        f"{'none' if lib_ms is None else f'{lib_ms:.4f}'}, bound "
        f"{bound_ms:.4f} by {by}; launches {launches}, max_abs_err "
        f"{err:.3e}); device time {dev}, library device time {lib_dev}")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": lib_ms,
            "bytes": nbytes, "flops": flops, **extra}


def phase_norm_ops(torch):
    """Phase 18: ``fused_rms_norm`` at Llama-2-7B's hidden over phase 15's
    prefill step (x [32768, 4096] bf16, bf16 weight, eps 1e-5) and
    ``fused_layer_norm`` at GPT2Config.xl_1p3b over phase 7's micro batch
    (x [8192, 2048] bf16, fp32 weight and bias, eps 1e-5), launched from
    the entry points with the counts at 0, each against its plain version;
    then fp32, a ragged [1000, 4100], a backward through each Function
    against autograd of the plain version (fp32), and the timings with
    ``F.rms_norm`` / ``F.layer_norm`` as the library calls."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.kernels import normalization as nm
    g = torch.Generator(device="cuda").manual_seed(18)
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa
    x = rnd(32768, 4096).to(torch.bfloat16)
    w = (1 + 0.1 * rnd(4096)).to(torch.bfloat16)
    xl = rnd(8192, 2048).to(torch.bfloat16)
    wl, bl = 1 + 0.1 * rnd(2048), 0.1 * rnd(2048)
    torch.cuda.synchronize()
    nm.reset_launch_counts()
    y = nm.fused_rms_norm(x, w, eps=1e-5)
    yl = nm.fused_layer_norm(xl, wl, bl, eps=1e-5)
    torch.cuda.synchronize()
    launches = dict(nm.LAUNCHES)
    if not all(launches.values()):
        raise AssertionError(f"norm entry points launched {launches}")
    worst = {
        "rms_norm": check_close(
            torch, "[ops] rms_norm [32768, 4096] bf16", y,
            nm.rms_norm_plain(x, w, 1e-5), bf16_max_abs=NORM_BF16_MAX_ABS),
        "layer_norm": check_close(
            torch, "[ops] layer_norm [8192, 2048] bf16", yl,
            nm.layer_norm_plain(xl, wl, bl, 1e-5),
            bf16_max_abs=NORM_BF16_MAX_ABS)}
    del y, yl
    xr = rnd(1000, 4100)
    wr, br = 1 + 0.1 * rnd(4100), 0.1 * rnd(4100)
    for dt in (torch.float32, torch.bfloat16):
        for what, xx in (("[32768, 4096]", x), ("[1000, 4100]", xr)):
            xx = xx.to(dt)
            ww = wr if xx.shape[1] == 4100 else w.float()
            worst["rms_norm"] = max(worst["rms_norm"], check_close(
                torch, f"[ops] rms_norm {what} {str(dt)[6:]}",
                nm.fused_rms_norm(xx, ww),
                nm.rms_norm_plain(xx, ww, 1e-6),
                bf16_max_abs=NORM_BF16_MAX_ABS,
                fp32_max_abs=OPS_FP32_MAX_ABS))
        for what, xx, ww, bb in (("[8192, 2048]", xl, wl, bl),
                                 ("[1000, 4100]", xr, wr, br)):
            xx = xx.to(dt)
            worst["layer_norm"] = max(worst["layer_norm"], check_close(
                torch, f"[ops] layer_norm {what} {str(dt)[6:]}",
                nm.fused_layer_norm(xx, ww, bb),
                nm.layer_norm_plain(xx, ww, bb, 1e-5),
                bf16_max_abs=NORM_BF16_MAX_ABS,
                fp32_max_abs=OPS_FP32_MAX_ABS))
    # the hand-written backward against autograd of the plain version
    xf = xl.float().requires_grad_(True)
    wf, bf = wl.clone().requires_grad_(True), bl.clone().requires_grad_(True)
    cot = rnd(8192, 2048)
    for name in ("rms_norm", "layer_norm"):
        ins = (xf, wf) if name == "rms_norm" else (xf, wf, bf)
        fused = (nm.fused_rms_norm(xf, wf) if name == "rms_norm"
                 else nm.fused_layer_norm(xf, wf, bf))
        plain = (nm.rms_norm_plain(xf, wf, 1e-6) if name == "rms_norm"
                 else nm.layer_norm_plain(xf, wf, bf, 1e-5))
        got = torch.autograd.grad(fused, ins, cot)
        ref = torch.autograd.grad(plain, ins, cot)
        for arg, a, r in zip("xwb", got, ref):
            rel = ((a - r).norm() / r.norm()).item()
            log(f"[ops] {name} backward d{arg} fp32: rel_norm_err {rel:.3e} "
                f"(1e-5)")
            if not rel <= 1e-5:
                raise AssertionError(f"{name} backward d{arg}: {rel}")
    del xf, wf, bf, cot, xr
    rows = []
    wl16, bl16 = wl.to(xl.dtype), bl.to(xl.dtype)   # cast outside the timing
    for name, xx, args, lib in (
            ("rms_norm", x, (w, 1e-5),
             lambda: F.rms_norm(x, (4096,), w, 1e-5)),
            ("layer_norm", xl, (wl, bl, 1e-5),
             lambda: F.layer_norm(xl, (2048,), wl16, bl16, 1e-5))):
        t = _norm_times(torch, nm, name, xx, args, lib)
        rows.append(_op_row(
            name, NORM_SOURCE, launches[name], worst[name], t["ms"],
            t["plain_ms"], t["library_ms"], t["bytes"], t["flops"],
            F32_FLOPS_PER_S, device_ms=t["device_ms"],
            library_device_ms=t["library_device_ms"],
            graph_ms=t["graph_ms"], library_graph_ms=t["library_graph_ms"],
            plan=t["plan"], launches_note="one call of the entry point",
            library_call=f"F.{name}, weights in bf16",
            shape={"x": list(xx.shape), "dtype": "bf16"}))
    del x, xl
    torch.cuda.empty_cache()
    # LayerNorm at the Llama / GPT widths 4096 and 8192 over 8192 rows
    widths = {}
    for C in (4096, 8192):
        xw = rnd(8192, C).to(torch.bfloat16)
        ww, bw = 1 + 0.1 * rnd(C), 0.1 * rnd(C)
        ww16, bw16 = ww.to(xw.dtype), bw.to(xw.dtype)
        nm.reset_launch_counts()
        err = check_close(torch, f"[ops] layer_norm [8192, {C}] bf16",
                          nm.fused_layer_norm(xw, ww, bw),
                          nm.layer_norm_plain(xw, ww, bw, 1e-5),
                          bf16_max_abs=NORM_BF16_MAX_ABS)
        if nm.LAUNCHES["layer_norm"] != 1:
            raise AssertionError(f"layer_norm width {C}: {nm.LAUNCHES}")
        t = _norm_times(torch, nm, "layer_norm", xw, (ww, bw, 1e-5),
                        lambda: F.layer_norm(xw, (C,), ww16, bw16, 1e-5))
        t["bound_ms"], t["bound_by"] = _bound(t["bytes"], t["flops"],
                                              F32_FLOPS_PER_S)
        t["max_abs_err"] = err
        log(f"[ops timing] layer_norm [8192, {C}] bf16: device "
            f"{t['device_ms']}, graph {t['graph_ms']:.4f} ms (library "
            f"device {t['library_device_ms']}, graph "
            f"{t['library_graph_ms']:.4f}; bound {t['bound_ms']:.4f}); plan "
            f"{t['plan']}")
        widths[str(C)] = t
        del xw
    rows[-1]["widths"] = widths
    torch.cuda.empty_cache()
    return rows


def _norm_times(torch, nm, name, xx, args, lib):
    """One norm entry point on x ``xx`` (args: weights and eps) timed by
    CUDA events, by torch.profiler's device time and in a CUDA graph,
    beside its plain version and the library call ``lib`` (events,
    device, graph); the bytes (x in and out, the weights once), the
    operations and the kernel's ``norm_plan``."""
    kern = getattr(nm, f"fused_{name}")
    plain = getattr(nm, f"{name}_plain")
    fn = lambda: kern(xx, *args[:-1], eps=args[-1])        # noqa: E731
    n = xx.numel()
    return {
        "ms": _time_ms(torch, fn, 50), "device_ms": _device_ms(torch, fn, 20),
        "graph_ms": _graph_ms(torch, [fn]),
        "plain_ms": _time_ms(torch, lambda: plain(xx, *args), 10),
        "library_ms": _time_ms(torch, lib, 50),
        "library_device_ms": _device_ms(torch, lib, 20),
        "library_graph_ms": _graph_ms(torch, [lib]),
        "bytes": 2 * n * xx.element_size() + sum(
            a.numel() * a.element_size() for a in args[:-1]),
        "flops": 4 * n,
        "plan": nm.norm_plan(xx.shape[0], xx.shape[1], xx.dtype,
                             name == "layer_norm")._asdict()}


def norm_plan_sweep(torch):
    """``--norm-sweep``: every rows-route launch of the norm kernel that
    its instances allow (4, 8 or 16 vectors a lane, the fewest warps a
    row for each, 16, 8 or 4 warps a block) at phase 18's shapes and
    LayerNorm's widths 4096 and 8192 (bf16), each in a CUDA graph beside
    the library call; ``norm_plan``'s choices are read from this table."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.kernels import normalization as nm
    g = torch.Generator(device="cuda").manual_seed(18)
    table = []
    plan_fn = nm.norm_plan
    try:
        for name, R, C in (("layer_norm", 8192, 2048),
                           ("rms_norm", 32768, 4096),
                           ("layer_norm", 8192, 4096),
                           ("layer_norm", 8192, 8192)):
            x = torch.randn(R, C, generator=g, device="cuda").bfloat16()
            w = 1 + 0.1 * torch.randn(C, generator=g, device="cuda")
            b = 0.1 * torch.randn(C, generator=g, device="cuda")
            ln = name == "layer_norm"
            kern = (lambda: nm.fused_layer_norm(x, w, b)) if ln else \
                (lambda: nm.fused_rms_norm(x, w))
            w16, b16 = w.bfloat16(), b.bfloat16()
            lib = (lambda: F.layer_norm(x, (C,), w16, b16, 1e-5)) if ln \
                else (lambda: F.rms_norm(x, (C,), w16, 1e-6))
            ref = nm.layer_norm_plain(x, w, b, 1e-5) if ln else \
                nm.rms_norm_plain(x, w, 1e-6)
            chosen = plan_fn(R, C, x.dtype, ln)
            nv = C // 8
            row = {"name": name, "x": [R, C], "chosen": chosen._asdict(),
                   "library_graph_ms": _graph_ms(torch, [lib]), "plans": []}
            for vpl in (4, 8, 16):
                wpr = -(-nv // (32 * vpl))
                if wpr > nm.NORM_MAX_TEAM_WARPS:
                    continue
                for warps in (16, 8, 4):
                    teams = max(1, warps // wpr)
                    p = nm.NormPlan("rows", wpr, vpl, teams,
                                    32 * wpr * teams, chosen.smem_bytes)
                    if any(q["plan"] == p._asdict() for q in row["plans"]):
                        continue
                    nm.norm_plan = lambda *a, p=p: p
                    err = (kern().float() - ref.float()).abs().max().item()
                    if not err <= NORM_BF16_MAX_ABS:
                        raise AssertionError(f"norm sweep {name} {p}: "
                                             f"max-abs {err} from plain")
                    row["plans"].append({"plan": p._asdict(),
                                         "graph_ms": _graph_ms(torch,
                                                               [kern])})
                    nm.norm_plan = plan_fn
            log(f"[norm sweep] {name} [{R}, {C}] bf16: library graph "
                f"{row['library_graph_ms']:.4f} ms; chosen "
                f"{tuple(chosen)[1:4]}; " + "; ".join(
                    f"(wpr {q['plan']['wpr']}, vpl {q['plan']['vpl']}, "
                    f"teams {q['plan']['teams']}) {q['graph_ms']:.4f}"
                    for q in row["plans"]))
            table.append(row)
            del x
    finally:
        nm.norm_plan = plan_fn
    return table


def phase_adamw_op(torch):
    """Phase 19: ``fused_adamw_update`` on one flat f32 buffer of
    GPT2Config.xl_1p3b's parameter count (counted from the port's tree),
    f32 gradients, 3 steps from the entry point with the count at 0, each
    step's p, m and v held bit-identical to the plain version's on copies
    of the full buffers (the plain version in chunks of 2**27, elementwise,
    so the chunking changes no bit); a ragged n with bf16 gradients; then
    the timing, with one ``torch.optim.AdamW(fused=True)`` step on the
    same buffers as the library call."""
    from deepspeed_tpu_torch.checkpoint.jax_params import gpt2_param_shapes
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config
    from deepspeed_tpu_torch.ops.kernels import fused_optimizer as fo
    from deepspeed_tpu_torch.utils.tree import flatten
    n = sum(math.prod(s) for s in flatten(
        gpt2_param_shapes(GPT2Config.xl_1p3b())).values())
    kw = dict(lr=1e-4, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
    g = torch.Generator(device="cuda").manual_seed(19)
    chunk = 1 << 27

    def plain_chunks(p, gg, m, v, step):
        for a in range(0, p.numel(), chunk):
            s = slice(a, a + chunk)
            fo.fused_adamw_update_plain(p[s], gg[s], m[s], v[s], step, **kw)

    def same(a, b):
        return torch.equal(a, b)

    # a ragged n with bf16 gradients first (small)
    nr = 10_000_003
    pr = torch.randn(nr, generator=g, device="cuda")
    mr, vr = torch.zeros_like(pr), torch.zeros_like(pr)
    cr = [t.clone() for t in (pr, mr, vr)]
    for step in (1, 2, 3):
        gr = (1e-3 * torch.randn(nr, generator=g, device="cuda")).to(
            torch.bfloat16)
        fo.fused_adamw_update(pr, gr, mr, vr, step, **kw)
        fo.fused_adamw_update_plain(*cr[:1], gr, *cr[1:], step, **kw)
    if not all(same(a, b) for a, b in zip((pr, mr, vr), cr)):
        raise AssertionError("adamw bf16-g ragged n: not bit-identical")
    log(f"[ops] adamw n={nr} bf16 g, 3 steps: p, m, v bit-identical")
    del pr, mr, vr, cr, gr
    # the main path: one flat buffer of GPT-2-1.3B's parameters
    p = torch.randn(n, generator=g, device="cuda").mul_(0.02)
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    grad = torch.empty_like(p)
    copies = [t.clone() for t in (p, m, v)]
    torch.cuda.synchronize()
    fo.reset_launch_counts()
    for step in (1, 2, 3):
        grad.normal_(generator=g).mul_(1e-3)
        out = fo.fused_adamw_update(p, grad, m, v, step, **kw)
        if not (out[0] is p and out[1] is m and out[2] is v):
            raise AssertionError("adamw did not update in place")
        launches = fo.LAUNCHES["adamw"]
        plain_chunks(*copies[:1], grad, *copies[1:], step)
    torch.cuda.synchronize()
    if launches != 3:
        raise AssertionError(f"adamw launches {launches} != 3")
    diff = max((a - b).abs().max().item() for a, b in zip((p, m, v), copies))
    if not all(same(a, b) for a, b in zip((p, m, v), copies)):
        raise AssertionError(f"adamw n={n}: not bit-identical ({diff})")
    log(f"[ops] adamw n={n} f32 g, 3 steps: p, m, v bit-identical to the "
        f"plain version")
    del copies
    torch.cuda.empty_cache()
    ms = _time_ms(torch, lambda: fo.fused_adamw_update(p, grad, m, v, 4,
                                                       **kw), 10)
    dev_ms = _device_ms(torch, lambda: fo.fused_adamw_update(
        p, grad, m, v, 4, **kw), 5)
    plain_ms = _time_ms(torch, lambda: fo.fused_adamw_update_plain(
        p, grad, m, v, 4, **kw), 2)
    param = torch.nn.Parameter(p)
    param.grad = grad
    opt = torch.optim.AdamW([param], lr=kw["lr"], betas=(kw["b1"], kw["b2"]),
                            eps=kw["eps"], weight_decay=kw["weight_decay"],
                            fused=True)
    lib_ms = _time_ms(torch, opt.step, 5)
    lib_dev_ms = _device_ms(torch, opt.step, 3)
    del opt, param, p, m, v, grad
    torch.cuda.empty_cache()
    return [_op_row("adamw", ADAMW_SOURCE, launches, diff, ms, plain_ms,
                    lib_ms, 28 * n, 15 * n, F32_FLOPS_PER_S,
                    device_ms=dev_ms, library_device_ms=lib_dev_ms,
                    launches_note="3 steps of the entry point",
                    library_call="torch.optim.AdamW(fused=True).step() on "
                                 "the same buffers",
                    shape={"n": n, "g": "fp32", "dtype": "fp32"})]


def phase_sparse_op(torch):
    """Phase 20: block-sparse attention at BERT-large's attention width
    (16 heads of 64) over B = 4 sequences of 4096 tokens (block 128, the
    kernel's granularity, so ``coarsening_is_exact`` holds), from the
    entry points with the count at 0: ``SparseSelfAttention(cfg,
    impl="flash")`` with BSLongformer (window 3, global block 0) and
    BigBird (1 random, window 3, 1 global, a layout per head), and
    ``sparse_attention(impl="flash")`` on BSLongformer with one query
    block of head 0 cleared (its rows must be zeros); each through the
    wgmma kernel (``sparse_route``, its ``sparse_plan`` logged) against
    the plain version (the layouts are the configs' own: BigBird's random
    blocks come from its seed), a second call bit-identical. Then the same
    BSLongformer shape in fp16 and at head dim 128 (bf16, fp16), and fp32
    on the CUDA-core kernel. Timing per layout and case by CUDA events,
    torch.profiler's device time and a CUDA graph, with
    ``F.scaled_dot_product_attention`` on the token-level boolean mask as
    the library call, and the bound's share of the graph time."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    B, Hh, T, Dh = SPARSE_B, SPARSE_H, SPARSE_T, SPARSE_D
    g = torch.Generator(device="cuda").manual_seed(20)
    q, k, v = (torch.randn(B, Hh, T, Dh, generator=g, device="cuda").to(
        torch.bfloat16) for _ in range(3))
    cfgs = {
        "bslongformer": sa.BSLongformerSparsityConfig(
            Hh, block=128, num_sliding_window_blocks=3,
            global_block_indices=[0]),
        "bigbird": sa.BigBirdSparsityConfig(
            Hh, block=128, num_random_blocks=1, num_sliding_window_blocks=3,
            num_global_blocks=1, different_layout_per_head=True)}
    layouts = {name: c.make_layout(T) for name, c in cfgs.items()}
    empty = layouts["bslongformer"].copy()
    empty[0, 5] = False
    layouts["bslongformer_empty_row"] = empty
    cfgs["bslongformer_empty_row"] = cfgs["bslongformer"]
    route = fa.sparse_route(torch.bfloat16, Dh, 128, 128)
    plans = {}
    for name, lay in layouts.items():
        p = fa.sparse_plan(lay, 128, 128, T, T, B, sm_count(q.device))
        load = [sum(t + fa.SPARSE_ITEM_COST for *_, t in b)
                for b in p.blocks]
        plans[name] = {"items": p.items, "grid": p.grid,
                       "max_load": max(load),
                       "mean_load": sum(load) / len(load)}
        log(f"[ops] flash_sparse_fwd {name}: route {route}, plan "
            f"{plans[name]}")
    if route != "wgmma":
        raise AssertionError(f"phase 20's shape routes to {route}")
    mods = {name: sa.SparseSelfAttention(cfgs[name], impl="flash")
            for name in ("bslongformer", "bigbird")}
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    outs = {name: mod(q, k, v) for name, mod in mods.items()}
    outs["bslongformer_empty_row"] = sa.sparse_attention(
        q, k, v, cfgs["bslongformer"], impl="flash", layout=empty)
    torch.cuda.synchronize()
    launches = fa.SPARSE_LAUNCHES["flash_sparse_fwd"]
    routes = dict(fa.SPARSE_ROUTES)
    if launches != len(layouts) or routes["wgmma"] != len(layouts):
        raise AssertionError(f"flash_sparse_fwd launches {launches}, "
                             f"routes {routes}")
    scale = Dh ** -0.5
    worst = 0.0
    for name, o in outs.items():
        if not torch.isfinite(o.float()).all():
            raise AssertionError(f"sparse {name}: non-finite output")
        if not torch.equal(o, sa.sparse_attention(
                q, k, v, cfgs[name], impl="flash", layout=layouts[name])):
            raise AssertionError(f"sparse {name}: two calls differ")
        ref = fa.flash_attention_sparse_plain(q, k, v, layouts[name],
                                              sm_scale=scale)
        worst = max(worst, check_close(
            torch, f"[ops] flash_sparse_fwd {name} bf16 "
            f"({int(layouts[name].sum())} of {layouts[name].size} blocks)",
            o, ref, bf16_max_abs=SPARSE_BF16_MAX_ABS))
        del ref
    if outs["bslongformer_empty_row"][0, 0, 5 * 128:6 * 128].any():
        raise AssertionError("a query block with no allowed block: not 0")
    del outs
    torch.cuda.empty_cache()
    qf, kf, vf = (t[:1].float() for t in (q, k, v))
    check_close(torch, "[ops] flash_sparse_fwd bigbird fp32 (B = 1)",
                fa.flash_attention_sparse(qf, kf, vf, layouts["bigbird"],
                                          layout="BHTD"),
                fa.flash_attention_sparse_plain(qf, kf, vf,
                                                layouts["bigbird"],
                                                sm_scale=scale),
                fp32_max_abs=OPS_FP32_MAX_ABS)
    del qf, kf, vf

    def times(qq, kk, vv, lay, sdpa):
        call = lambda: fa.flash_attention_sparse(      # noqa: E731
            qq, kk, vv, lay, layout="BHTD")
        r = {"ms": _time_ms(torch, call, 20),
             "device_ms": _device_ms(torch, call, 10),
             "graph_ms": _graph_ms(torch, [call])}
        if sdpa:
            mask = sa.token_mask(lay, 128, "cuda")[None]  # [1, H, T, T]
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qq, kk, vv, attn_mask=mask)
            r.update(library_ms=_time_ms(torch, lib, 10),
                     library_device_ms=_device_ms(torch, lib, 5),
                     library_graph_ms=_graph_ms(torch, [lib], reps=5))
            del mask
        d = qq.shape[-1]
        r["flops"] = 4 * B * int(lay.sum()) * 128 * 128 * d
        r["bytes"] = 4 * B * Hh * T * d * qq.element_size()
        r["bound_ms"], r["bound_by"] = _bound(r["bytes"], r["flops"],
                                              BF16_FLOPS_PER_S)
        r["bound_share_of_graph"] = r["bound_ms"] / r["graph_ms"]
        return r

    per = {}
    for name in ("bslongformer", "bigbird"):
        lay = layouts[name]
        r = times(q, k, v, lay, True)
        r["plain_ms"] = _time_ms(
            torch, lambda: fa.flash_attention_sparse_plain(
                q, k, v, lay, sm_scale=scale), 2)
        r["allowed_blocks"] = int(lay.sum())
        per[name] = r
        log(f"[ops timing] flash_sparse_fwd {name} bf16 D{Dh} "
            f"({r['allowed_blocks']} of {lay.size} blocks): {r['ms']:.4f} ms "
            f"(device {r['device_ms']}, graph {r['graph_ms']:.4f}; plain "
            f"{r['plain_ms']:.4f}; sdpa {r['library_ms']:.4f}, device "
            f"{r['library_device_ms']}, graph {r['library_graph_ms']:.4f}; "
            f"bound {r['bound_ms']:.4f} by {r['bound_by']}, "
            f"{100 * r['bound_share_of_graph']:.1f}% of the graph time)")
        torch.cuda.empty_cache()
    # the same BSLongformer shape in fp16 and at head dim 128
    lay = layouts["bslongformer"]
    cases = {}
    for d, dt in ((Dh, torch.float16), (128, torch.bfloat16),
                  (128, torch.float16)):
        label = f"bslongformer {str(dt)[6:]} D{d}"
        qq, kk, vv = (torch.randn(B, Hh, T, d, generator=g,
                                  device="cuda").to(dt) for _ in range(3))
        if fa.sparse_route(dt, d, 128, 128) != "wgmma":
            raise AssertionError(f"{label}: not the wgmma route")
        fa.reset_launch_counts()
        o = fa.flash_attention_sparse(qq, kk, vv, lay, layout="BHTD")
        torch.cuda.synchronize()
        if fa.SPARSE_ROUTES["wgmma"] != 1:
            raise AssertionError(f"{label}: {fa.SPARSE_ROUTES}")
        err = check_close(torch, f"[ops] flash_sparse_fwd {label}", o,
                          fa.flash_attention_sparse_plain(
                              qq, kk, vv, lay, sm_scale=d ** -0.5),
                          bf16_max_abs=SPARSE_BF16_MAX_ABS)
        del o
        r = times(qq, kk, vv, lay, dt == torch.bfloat16)
        r["max_abs_err"] = err
        cases[label] = r
        log(f"[ops timing] flash_sparse_fwd {label}: {r['ms']:.4f} ms "
            f"(device {r['device_ms']}, graph {r['graph_ms']:.4f}; bound "
            f"{r['bound_ms']:.4f}, {100 * r['bound_share_of_graph']:.1f}% "
            f"of the graph time; sdpa graph {r.get('library_graph_ms')})")
        del qq, kk, vv
        torch.cuda.empty_cache()
    r = per["bslongformer"]
    del q, k, v
    torch.cuda.empty_cache()
    return [_op_row(
        "flash_sparse_fwd", SPARSE_SOURCE, launches, worst, r["ms"],
        r["plain_ms"], r["library_ms"], r["bytes"], r["flops"],
        BF16_FLOPS_PER_S, device_ms=r["device_ms"], graph_ms=r["graph_ms"],
        library_device_ms=r["library_device_ms"],
        library_graph_ms=r["library_graph_ms"],
        bound_share_of_graph=r["bound_share_of_graph"],
        sparse_route=route, routes=routes, plans=plans,
        launches_note="one entry-point call per layout (3), each on the "
                      "wgmma route",
        library_call="F.scaled_dot_product_attention with the token-level "
                     "boolean mask",
        shape={"B": B, "H": Hh, "T": T, "D": Dh, "layout": "bslongformer",
               "allowed_blocks": r["allowed_blocks"], "dtype": "bf16"},
        layouts=per, cases=cases)]


def _evo_inputs(torch, g, shape, dtype=None):
    """q/k/v [B, N, S, H, D] (bf16 unless ``dtype``), the mask bias [B, N,
    1, 1, S] (-1e9 on ~20% of the keys) and the pair bias [B, 1, H, S, S]
    (f32)."""
    dtype = dtype or torch.bfloat16
    B, N, S, Hh, Dh = shape
    q, k, v = (torch.randn(*shape, generator=g, device="cuda").to(dtype)
               for _ in range(3))
    drop = torch.rand(B, N, 1, 1, S, generator=g, device="cuda") < 0.2
    mask = torch.where(drop, -1e9, 0.0)
    pair = torch.randn(B, 1, Hh, S, S, generator=g, device="cuda")
    return q, k, v, mask, pair


def phase_evoformer_op(torch):
    """Phase 21: ``DS4Sci_EvoformerAttention`` at AlphaFold 2's
    fine-tuning sizes, bf16 with f32 biases: MSA row attention with pair
    bias ([1, 512, 384, 8, 32]) and triangle attention ([1, 384, 384, 4,
    32]), from the entry point with the count at 0, each against the
    plain version; a ragged S = 300, the four bias combinations and fp32
    on smaller MSA stacks; one backward of the MSA case against the plain
    path's gradients; timing with ``F.scaled_dot_product_attention`` on
    [B N, H, S, D] with mask + pair bias as its ``attn_mask`` (built
    outside the timed window) as the library call."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.evoformer_attn import \
        DS4Sci_EvoformerAttention as evo
    from deepspeed_tpu_torch.ops.kernels import evoformer as ek
    g = torch.Generator(device="cuda").manual_seed(21)
    cases = {"msa": _evo_inputs(torch, g, EVO_MSA),
             "triangle": _evo_inputs(torch, g, EVO_TRI)}
    torch.cuda.synchronize()
    ek.reset_launch_counts()
    outs = {name: evo(q, k, v, [mask, pair])
            for name, (q, k, v, mask, pair) in cases.items()}
    torch.cuda.synchronize()
    launches = ek.LAUNCHES["evoformer_fwd"]
    if launches != len(cases):
        raise AssertionError(f"evoformer_fwd launches {launches}")
    worst = 0.0
    for name, (q, k, v, mask, pair) in cases.items():
        ref = ek.evoformer_flash_plain(q, k, v, mask[:, :, 0, 0],
                                       pair[:, 0])
        worst = max(worst, check_close(
            torch, f"[ops] evoformer_fwd {name} {list(q.shape)} bf16",
            outs[name], ref, bf16_max_abs=EVO_BF16_MAX_ABS))
        del ref
    del outs
    # the four bias combinations, ragged S, fp32, and a fully masked row
    for dt in (torch.bfloat16, torch.float32):
        q, k, v, mask, pair = _evo_inputs(torch, g, (1, 64, 300, 8, 32), dt)
        mask[0, 3] = float("-inf")
        for mb, pb in ((None, None), (mask, None), (None, pair),
                       (mask, pair)):
            mb2 = None if mb is None else mb[:, :, 0, 0]
            pb2 = None if pb is None else pb[:, 0]
            got = ek.evoformer_flash(q, k, v, mb2, pb2)
            err = check_close(
                torch, f"[ops] evoformer_fwd [1, 64, 300, 8, 32] "
                f"{str(dt)[6:]} mask={mb is not None} pair={pb is not None}",
                got, ek.evoformer_flash_plain(q, k, v, mb2, pb2),
                bf16_max_abs=EVO_BF16_MAX_ABS, fp32_max_abs=OPS_FP32_MAX_ABS)
            if mb is not None and got[0, 3].any():
                raise AssertionError("evoformer: a fully masked row not 0")
            if dt is torch.bfloat16:
                worst = max(worst, err)
    # one backward of the MSA case against the plain path's gradients
    q, k, v, mask, pair = (t.detach().requires_grad_(True)
                           for t in cases["msa"])
    cot = torch.randn(EVO_MSA, generator=g, device="cuda").to(torch.bfloat16)
    ins = (q, k, v, mask, pair)
    got = torch.autograd.grad(evo(q, k, v, [mask, pair]), ins, cot)
    ref = torch.autograd.grad(evo(q, k, v, [mask, pair], use_kernel=False),
                              ins, cot)
    for arg, a, r in zip(("q", "k", "v", "mask", "pair"), got, ref):
        rel = ((a.float() - r.float()).norm()
               / r.float().norm().clamp_min(1e-30)).item()
        log(f"[ops] evoformer backward d{arg}: rel_norm_err {rel:.3e} (1e-5)")
        if not rel <= 1e-5:
            raise AssertionError(f"evoformer backward d{arg}: {rel}")
    del q, k, v, mask, pair, cot, got, ref, ins
    torch.cuda.empty_cache()
    per = {}
    for name, (q, k, v, mask, pair) in cases.items():
        B, N, S, Hh, Dh = q.shape
        mb2, pb2 = mask[:, :, 0, 0], pair[:, 0]
        ms = _time_ms(torch, lambda: ek.evoformer_flash(q, k, v, mb2, pb2),
                      20)
        dev_ms = _device_ms(torch, lambda: ek.evoformer_flash(
            q, k, v, mb2, pb2), 10)
        plain_ms = _time_ms(torch, lambda: ek.evoformer_flash_plain(
            q, k, v, mb2, pb2), 2)
        qs, ks, vs = (t.reshape(B * N, S, Hh, Dh).transpose(1, 2)
                      .contiguous() for t in (q, k, v))
        am = (mask + pair).reshape(B * N, Hh, S, S).to(q.dtype)
        lib_ms = _time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=am), 10)
        lib_dev_ms = _device_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=am), 5)
        # in CUDA graphs: the kernel with both biases, the mask bias only
        # and neither (what the biases cost), SDPA beside them
        graph = {lab: _graph_ms(torch, [
            lambda a=a, b=b: ek.evoformer_flash(q, k, v, a, b)])
            for lab, a, b in (("both", mb2, pb2), ("mask", mb2, None),
                              ("none", None, None))}
        graph["sdpa"] = _graph_ms(torch, [
            lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                   attn_mask=am)])
        del qs, ks, vs, am
        nbytes = 4 * q.numel() * 2 + mb2.numel() * 4 + pb2.numel() * 4
        flops = 4 * B * N * Hh * S * S * Dh
        plan = ek.evo_plan(ek.kernel_head_dim(Dh), B, N, Hh, S, S)
        per[name] = (ms, plain_ms, lib_ms, nbytes, flops, dev_ms, lib_dev_ms,
                     graph, plan.rows, plan.pair_bias_bytes)
        bound_ms, by = _bound(nbytes, flops, BF16_FLOPS_PER_S)
        log(f"[ops timing] evoformer_fwd {name} {list(q.shape)}: {ms:.4f} "
            f"ms (plain {plain_ms:.4f}, sdpa {lib_ms:.4f}, bound "
            f"{bound_ms:.4f} by {by}); device time {dev_ms}, sdpa device "
            f"time {lib_dev_ms}; in CUDA graphs {graph}; {plan.rows} MSA "
            f"rows a block: the pair bias ({pb2.numel() * 4 / 1e6:.2f} MB) "
            f"crosses L2 {plan.groups} times, "
            f"{plan.pair_bias_bytes / 1e9:.3f} GB a call "
            f"({pb2.numel() * 4 * N / 1e9:.3f} GB at one row a block)")
        torch.cuda.empty_cache()
    del cases
    torch.cuda.empty_cache()
    ms, plain_ms, lib_ms, nbytes, flops, dev_ms, lib_dev_ms, graph, rows, \
        pb_bytes = per["msa"]
    return [_op_row(
        "evoformer_fwd", EVO_SOURCE, launches, worst, ms, plain_ms, lib_ms,
        nbytes, flops, BF16_FLOPS_PER_S, device_ms=dev_ms,
        library_device_ms=lib_dev_ms,
        launches_note="one entry-point call per case (MSA, triangle)",
        library_call="F.scaled_dot_product_attention on [B N, H, S, D] "
                     "with mask + pair bias as attn_mask (bf16, built "
                     "outside the timed window)",
        shape={"q": list(EVO_MSA), "case": "msa", "dtype": "bf16"},
        graph_ms=graph["both"], library_graph_ms=graph["sdpa"],
        msa_rows_a_block=rows, pair_bias_l2_bytes=pb_bytes,
        cases={n: dict(zip(("ms", "plain_ms", "library_ms", "bytes",
                            "flops", "device_ms", "library_device_ms",
                            "graph_ms", "msa_rows_a_block",
                            "pair_bias_l2_bytes"), r))
               for n, r in per.items()})]


# ---------------------------------------------------------------- fault C1

# GPT2Config.tiny's losses through the flash kernels against the same
# engine on dense attention, over 5 steps: about twice the largest
# reading on an H100 (1.638e-5 fp16, 1.475e-4 bf16). At init attention
# moves the loss little, so the three kernels are also held one by one
# at this config's shapes against their plain versions.
C1_TRAIN_REL = {"fp16": 4e-5, "bf16": 3e-4}


def phi3_width(**kw):
    """Phi-3-mini's widths (hidden 3072, 32 heads of 96, no GQA,
    intermediate 8192, vocab 32064), which the JAX registry serves through
    its Llama runner (``deepspeed_tpu/models/registry.py:343``)."""
    from deepspeed_tpu_torch.models.llama import LlamaConfig
    base = dict(vocab_size=32064, hidden_size=3072, num_heads=32,
                num_kv_heads=32, intermediate_size=8192, num_layers=32)
    base.update(kw)
    return LlamaConfig(**base)


def phase_c1_shapes(torch):
    """Phase 22 (fault C1): inputs that the JAX package computes and the
    port's kernels refused before, each through its kernel on the card,
    the launch count rising, against its plain or dense twin."""
    import numpy as np
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.checkpoint import (init_gpt2_params,
                                                init_llama_params)
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceConfig)
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, make_model
    from deepspeed_tpu_torch.models.llama import LlamaConfig
    from deepspeed_tpu_torch.ops.evoformer_attn import \
        DS4Sci_EvoformerAttention as evo
    from deepspeed_tpu_torch.ops.kernels import evoformer as ek
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import paged_attention as pa
    rng = np.random.default_rng(22)
    out = {}
    # K1 and K2 at the new head dims and a GQA group of 32
    for heads in ((4, 2, 16), (8, 2, 32), (32, 32, 80), (32, 32, 96),
                  (32, 1, 64)):
        Hh, KVh, Dh = heads
        for dtype in (torch.float32, torch.bfloat16):
            for name, S, C, lens in (
                    ("paged_prefill", 4, 100, [100, 300, 700, 1000]),
                    ("paged_decode", 16, 1, rng.integers(1, 1500, 16))):
                q, kp, vp, tab, st, ln = paged_inputs(
                    torch, rng, S=S, C=C, lens=lens, block_size=64, maxb=24,
                    dtype=dtype, heads=heads)
                kw = dict(block_size=64, sm_scale=Dh ** -0.5,
                          sliding_window=None, num_kv_heads=KVh)
                pa.reset_launch_counts()
                got = getattr(pa, name)(q, kp, vp, tab, st, ln, **kw)
                torch.cuda.synchronize()
                if pa.LAUNCHES[name] != 1:
                    raise AssertionError(f"{name} {heads}: {pa.LAUNCHES}")
                check_close(
                    torch, f"[c1] {name} H={Hh} KV={KVh} D={Dh} "
                    f"{str(dtype)[6:]}", got,
                    pa.paged_attention_plain(q, kp, vp, tab, st, ln, **kw),
                    bf16_max_abs=BF16_MAX_ABS if Dh <= 64
                    else PAGED7_BF16_MAX_ABS)
    # engines under "auto" against dense, fp32 with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for label, cfg, P, bs, nb, mb in (
            ("LlamaConfig.tiny", LlamaConfig.tiny(dtype=torch.float32), 32,
             16, 32, 8),
            ("phi3 width, 2 layers",
             phi3_width(num_layers=2, dtype=torch.float32), 128, 64, 16,
             4)):
        params = init_llama_params(cfg, seed=22, device="cuda",
                                   dtype=torch.float32)
        prompts = rng.integers(1, cfg.vocab_size, (4, P)).tolist()
        gens, launches = {}, {}
        for impl in ("auto", "dense"):
            rcfg = RaggedInferenceConfig(
                max_seqs=4, chunk_size=P // 2, block_size=bs, num_blocks=nb,
                max_blocks_per_seq=mb, dtype="float32", decode_loop_steps=8,
                attention_impl=impl)
            eng = InferenceEngineV2(cfg, params, rcfg, device="cuda")
            pa.reset_launch_counts()
            gens[impl] = eng.generate(prompts, max_new_tokens=16)
            launches[impl] = dict(pa.LAUNCHES)
            del eng
        if not all(launches["auto"].values()) or any(
                launches["dense"].values()):
            raise AssertionError(f"{label}: launches {launches}")
        if gens["auto"] != gens["dense"]:
            raise AssertionError(f"{label}: kernel tokens {gens['auto']} "
                                 f"!= dense {gens['dense']}")
        log(f"[c1] {label} (head_dim {cfg.head_dim}, fp32): tokens "
            f"identical to dense over 4 x 16; launches {launches['auto']}")
        out[label] = launches["auto"]
        del params
    torch.cuda.empty_cache()
    # GPT2Config.tiny (head_dim 16): the flash forward and the dq / dkv
    # pair at its shapes (B 2, H 4, T 128), then training, in fp16 and bf16
    tiny = GPT2Config.tiny()
    Dh = tiny.head_dim
    pair_err = {"flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for dtype in (torch.float16, torch.bfloat16):
        q, k, v, do = flash_inputs(torch, B=2, Tq=tiny.max_seq_len,
                                   Tk=tiny.max_seq_len, H=tiny.num_heads,
                                   Hk=tiny.num_heads, D=Dh, dtype=dtype,
                                   seed=22)
        kw = dict(causal=True, sm_scale=Dh ** -0.5)
        fa.reset_launch_counts()
        got = flash_all(fa, q, k, v, do, plain=False, **kw)
        torch.cuda.synchronize()
        if fa.LAUNCHES != flash_want(fa, Dh, dtype, 1, 1):
            raise AssertionError(f"flash {dtype} D={Dh}: {fa.LAUNCHES}")
        ref = flash_all(fa, q, k, v, do, plain=True, **kw)
        for (name, o), g_, r_ in zip(flash_outputs(fa, Dh, dtype), got,
                                     ref):
            if g_.dtype != r_.dtype or not torch.isfinite(g_.float()).all():
                raise AssertionError(f"{name} {o} {dtype}: {g_.dtype}, "
                                     f"non-finite or not {r_.dtype}")
            err = check_close(torch, f"[c1] {name} {o} {str(dtype)[6:]} B2 "
                              f"T{tiny.max_seq_len} H{tiny.num_heads} "
                              f"D{Dh} causal", g_, r_,
                              bf16_max_abs=FLASH_BF16_MAX_ABS)
            if dtype is torch.bfloat16 and name in pair_err:
                pair_err[name] = max(pair_err[name], err)
    g = torch.Generator(device="cuda").manual_seed(22)
    batches = [torch.randint(0, 512, (2, 129), generator=g, device="cuda")
               for _ in range(5)]
    pair_launches = dict.fromkeys(pair_err, 0)
    for prec, dtype in (("fp16", torch.float16), ("bf16", torch.bfloat16)):
        ds = {"train_micro_batch_size_per_gpu": 2,
              "gradient_accumulation_steps": 1,
              "optimizer": {"type": "AdamW",
                            "params": {"lr": 1e-3, "weight_decay": 0.01}},
              "gradient_clipping": 1.0, "steps_per_print": 10_000,
              prec: {"enabled": True}}
        losses, launches = {}, {}
        for impl in ("auto", "xla"):
            cfg = GPT2Config.tiny(dtype=dtype, attention_impl=impl)
            _, _, loss_fn = make_model(cfg)
            engine, *_ = initialize(loss_fn=loss_fn, config=ds,
                                    params=init_gpt2_params(
                                        cfg, seed=22, device="cuda"))
            fa.reset_launch_counts()
            losses[impl] = [float(engine.train_batch({"tokens": b}))
                            for b in batches]
            launches[impl] = dict(fa.LAUNCHES)
            del engine
        route = ("flash_fwd",) + fa.bwd_launch_names(Dh, dtype)
        if not all(n > 0 if k in route else n == 0
                   for k, n in launches["auto"].items()) or any(
                launches["xla"].values()):
            raise AssertionError(f"GPT-2 {prec}: launches {launches}")
        for k in pair_launches:
            pair_launches[k] += launches["auto"][k]
        if not all(math.isfinite(x) for x in losses["auto"]):
            raise AssertionError(f"GPT-2 {prec}: losses {losses['auto']}")
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses["auto"],
                                                      losses["xla"]))
        log(f"[c1] GPT2Config.tiny (head_dim 16) {prec}: flash "
            f"{losses['auto']} dense {losses['xla']} max rel {rel:.3e} "
            f"(limit {C1_TRAIN_REL[prec]}); launches {launches['auto']}")
        if not rel <= C1_TRAIN_REL[prec]:
            raise AssertionError(f"GPT-2 {prec}: {rel}")
        out[f"gpt2_tiny_{prec}"] = {"max_rel": rel,
                                    "launches": launches["auto"]}
    # DS4Sci_EvoformerAttention at head dims 16 (native) and 48 (padded)
    for Dh in (16, 48):
        q, k, v, mask, pair = _evo_inputs(torch, g, (1, 16, 130, 4, Dh))
        ek.reset_launch_counts()
        got = evo(q, k, v, [mask, pair])
        torch.cuda.synchronize()
        if ek.LAUNCHES["evoformer_fwd"] != 1:
            raise AssertionError(f"evoformer D={Dh}: {ek.LAUNCHES}")
        check_close(torch, f"[c1] DS4Sci_EvoformerAttention [1, 16, 130, 4, "
                    f"{Dh}] bf16", got,
                    evo(q, k, v, [mask, pair], use_kernel=False),
                    bf16_max_abs=EVO_BF16_MAX_ABS)
    out["c2"] = c2_cases(torch)
    out["c3"] = c3_cases(torch)
    return out, pair_rows(torch, fa, tiny, pair_launches, pair_err)


# GPT2Config.tiny trained 5 steps in fp16 with the fused loss against the
# same engine with the chunked loss: the fused backward casts P' to fp16
# before its product where autograd of the chunked loss keeps fp32, so
# the trajectories part by about fp16's unit roundoff (2**-11); the limit
# is twice that
C2_TRAIN_REL = 1e-3


def c2_cases(torch):
    """Fault C2 (phase 22): inputs the kernels refused on the card and the
    JAX package computes, each through its kernel, the launch count
    rising, against its plain or chunked twin: ``GPT2Config.tiny`` trained
    in fp16 with ``xent_impl="fused"`` against ``"chunked"``
    (C2_TRAIN_REL); the three xent kernels at hidden 100 (padded to 128 in
    the wrapper) in fp32, bf16 and fp16; ``DS4Sci_EvoformerAttention`` in
    fp16; ``flash_attention`` on q/k/v views whose base address and
    strides TMA cannot take; ``quantize_blockwise`` in fp16 (codes and
    scales identical)."""
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.checkpoint import init_gpt2_params
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, make_model
    from deepspeed_tpu_torch.ops.evoformer_attn import \
        DS4Sci_EvoformerAttention as evo
    from deepspeed_tpu_torch.ops.kernels import evoformer as ek
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import fused_xent as fx
    from deepspeed_tpu_torch.ops.kernels import quantization as qz
    out = {}
    g = torch.Generator(device="cuda").manual_seed(220)
    batches = [torch.randint(0, 512, (2, 129), generator=g, device="cuda")
               for _ in range(5)]
    ds = {"train_micro_batch_size_per_gpu": 2,
          "gradient_accumulation_steps": 1,
          "optimizer": {"type": "AdamW",
                        "params": {"lr": 1e-3, "weight_decay": 0.01}},
          "gradient_clipping": 1.0, "steps_per_print": 10_000,
          "fp16": {"enabled": True}}
    losses, launches = {}, {}
    for impl in ("fused", "chunked"):
        cfg = GPT2Config.tiny(dtype=torch.float16, xent_impl=impl)
        _, _, loss_fn = make_model(cfg)
        engine, *_ = initialize(loss_fn=loss_fn, config=ds,
                                params=init_gpt2_params(cfg, seed=22,
                                                        device="cuda"))
        fx.reset_launch_counts()
        losses[impl] = [float(engine.train_batch({"tokens": b}))
                        for b in batches]
        launches[impl] = dict(fx.LAUNCHES)
        del engine
    if launches["fused"] != dict.fromkeys(fx.LAUNCHES, len(batches)) or \
            any(launches["chunked"].values()):
        raise AssertionError(f"GPT-2 fp16 fused xent: launches {launches}")
    if not all(math.isfinite(x) for x in losses["fused"]):
        raise AssertionError(f"GPT-2 fp16 fused xent: {losses['fused']}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["fused"],
                                                  losses["chunked"]))
    log(f"[c2] GPT2Config.tiny fp16 xent_impl=fused: {losses['fused']} "
        f"chunked {losses['chunked']} max rel {rel:.3e} (limit "
        f"{C2_TRAIN_REL}); launches {launches['fused']}")
    if not rel <= C2_TRAIN_REL:
        raise AssertionError(f"GPT-2 fp16 fused xent: {rel}")
    out["gpt2_tiny_fp16_fused_xent"] = {"max_rel": rel,
                                        "launches": launches["fused"]}
    # the three xent kernels at hidden 100 in each dtype, fp16 at C 2048
    dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16,
              "fp16": torch.float16}
    for C, names in ((100, ("fp32", "bf16", "fp16")), (XENT_C, ("fp16",))):
        for dn in names:
            h, e, t = xent_inputs(torch, N=1000, V=50257, C=C,
                                  dtype=dtypes[dn], seed=C)
            scale = torch.tensor([1e-3], device="cuda")
            kw = dict(ignore=-100, z=1e-4, eps=0.1)
            fx.reset_launch_counts()
            got = xent_all(fx, h, e, t, scale, plain=False, **kw)
            if any(v != 1 for v in fx.LAUNCHES.values()):
                raise AssertionError(f"xent C={C} {dn}: {fx.LAUNCHES}")
            ref = xent_all(fx, h, e, t, scale, plain=True, **kw)
            torch.cuda.synchronize()
            check_xent(torch, f"[c2] {dn} N1000 V50257 C{C}", dn, got, ref)
            del h, e, t, got, ref
    out["xent_c100"] = "fp32, bf16, fp16"
    # Evoformer in fp16, the four bias combinations at a ragged S
    for biases in ((), ("mask",), ("pair",), ("mask", "pair")):
        q, k, v, mask, pair = _evo_inputs(torch, g, (1, 16, 130, 4, 32),
                                          dtype=torch.float16)
        bl = [b for nm, b in (("mask", mask), ("pair", pair))
              if nm in biases]
        ek.reset_launch_counts()
        got = evo(q, k, v, bl)
        torch.cuda.synchronize()
        if ek.LAUNCHES["evoformer_fwd"] != 1:
            raise AssertionError(f"evoformer fp16: {ek.LAUNCHES}")
        check_close(torch, f"[c2] DS4Sci_EvoformerAttention [1, 16, 130, 4, "
                    f"32] float16 biases {biases}", got,
                    evo(q, k, v, bl, use_kernel=False))
    out["evoformer_fp16"] = 4
    # flash_attention on views one element into a wider buffer
    for dtype in (torch.bfloat16, torch.float16):
        for Dh in (64, 128):
            B, T, Hh = 2, 256, 4
            buf = torch.randn(B, T, 3 * Hh * Dh + 1, generator=g,
                              device="cuda").to(dtype)
            q, k, v = (buf[..., 1 + i * Hh * Dh:1 + (i + 1) * Hh * Dh]
                       .unflatten(-1, (Hh, Dh)) for i in range(3))
            do = torch.randn(B, T, Hh, Dh, generator=g, device="cuda").to(
                dtype)
            qq, kk, vv = (x.detach().requires_grad_(True) for x in (q, k, v))
            fa.reset_launch_counts()
            o = fa.flash_attention(qq, kk, vv, causal=True)
            o.backward(do)
            torch.cuda.synchronize()
            if fa.LAUNCHES["flash_fwd"] != 1 or fa.LAUNCHES["flash_bwd"] != 1:
                raise AssertionError(f"flash misaligned view: {fa.LAUNCHES}")
            qc, kc, vc, dc = (x.transpose(1, 2).contiguous()
                              for x in (q, k, v, do))
            kw = dict(causal=True, sm_scale=Dh ** -0.5)
            ro, lse = fa.flash_fwd_plain(qc, kc, vc, **kw)
            ref = (ro, *fa.flash_bwd_plain(qc, kc, vc, dc, ro, lse, **kw))
            for name, a, r in zip(("o", "dq", "dk", "dv"),
                                  (o, qq.grad, kk.grad, vv.grad), ref):
                check_close(torch, f"[c2] flash_attention {name} on a "
                            f"misaligned view D{Dh} {str(dtype)[6:]}", a,
                            r.transpose(1, 2),
                            bf16_max_abs=FLASH_BF16_MAX_ABS)
    out["flash_misaligned_view"] = 4
    # the group quantizer in fp16 (both routes: groups of 128 and 100)
    x = torch.randn(300, 517, generator=g, device="cuda").half()
    for sym in (True, False):
        for bits in (8, 4):
            for gs in (128, 100):
                qz.reset_launch_counts()
                _quant_case(torch, qz, x, bits=bits, gs=gs, sym=sym,
                            what="[c2] [300, 517] float16")
                if sum(qz.LAUNCHES.values()) != 1:
                    raise AssertionError(f"quantize fp16: {qz.LAUNCHES}")
    out["quantize_fp16"] = 8
    torch.cuda.empty_cache()
    return out


def c3_cases(torch):
    """Fault C3 (phase 22): inputs the block-sparse kernels refused on the
    card and the JAX package computes, each through the kernel
    ``sparse_route`` names (its launch count rising), against the plain
    version: fp16 at head dims 64 and 128 (the wgmma kernel), head dims
    16, 80 and 96 in bf16 and fp16 (mma.sync), head dim 48 zero-padded to
    64 in fp32, bf16 and fp16, at a ragged T with GQA 4 -> 2 and a query
    block with no allowed key block (zeros); then q/k/v views one element
    into a wider buffer (a dense copy for the kernel) at head dims 64 and
    80."""
    import numpy as np
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False   # plain fp32 products
    g = torch.Generator(device="cuda").manual_seed(221)
    rng = np.random.default_rng(221)
    B, Hh, Hk, T = 2, 4, 2, 300
    nb = -(-T // 128)
    bm = rng.random((Hh, nb, nb)) < 0.5
    bm[:, :, 0] = True
    bm[1, nb - 1] = False
    f16, b16, f32 = torch.float16, torch.bfloat16, torch.float32
    cases = [(f16, 64), (f16, 128), (b16, 16), (f16, 16), (b16, 80),
             (f16, 80), (b16, 96), (f16, 96), (f32, 48), (b16, 48),
             (f16, 48)]
    out = {}

    def run(label, q, k, v):
        route = fa.sparse_route(q.dtype, q.shape[-1], 128, 128)
        fa.reset_launch_counts()
        got = fa.flash_attention_sparse(q, k, v, bm)
        torch.cuda.synchronize()
        if fa.SPARSE_ROUTES[route] != 1 or \
                fa.SPARSE_LAUNCHES["flash_sparse_fwd"] != 1:
            raise AssertionError(f"{label}: {fa.SPARSE_ROUTES}")
        if got[:, (nb - 1) * 128:, 1].any():
            raise AssertionError(f"{label}: an empty query block not 0")
        ref = fa.flash_attention_sparse_plain(
            *(t.transpose(1, 2) for t in (q, k, v)), bm,
            sm_scale=q.shape[-1] ** -0.5).transpose(1, 2)
        check_close(torch, f"[c3] {label} route {route}", got, ref,
                    bf16_max_abs=SPARSE_BF16_MAX_ABS,
                    fp32_max_abs=OPS_FP32_MAX_ABS)
        out[label] = route

    for dt, d in cases:
        q, k, v = (torch.randn(B, T, h, d, generator=g, device="cuda").to(dt)
                   for h in (Hh, Hk, Hk))
        run(f"flash_attention_sparse {str(dt)[6:]} D{d}", q, k, v)
    for dt in (b16, f16):
        for d in (64, 80):
            buf = torch.randn(B, T, 3 * Hh * d + 1, generator=g,
                              device="cuda").to(dt)
            q, k, v = (buf[..., 1 + i * Hh * d:1 + (i + 1) * Hh * d]
                       .unflatten(-1, (Hh, d)) for i in range(3))
            run(f"flash_attention_sparse on a misaligned view "
                f"{str(dt)[6:]} D{d}", q, k, v)
    torch.cuda.empty_cache()
    return out


def pair_rows(torch, fa, tiny, launches, err):
    """The kernels-line rows of the dq / dkv pair, the backward at head
    dims 16 and 32: launches of phase 22's two GPT2Config.tiny training
    runs, times at its shape (B 2, H 4, T 128, D 16, bf16, causal) by
    events and in a CUDA graph, beside SDPA's backward."""
    B, T, Hh, Dh = 2, tiny.max_seq_len, tiny.num_heads, tiny.head_dim
    q, k, v, do = flash_inputs(torch, B=B, Tq=T, Tk=T, H=Hh, Hk=Hh, D=Dh,
                               dtype=torch.bfloat16, seed=23)
    kw = dict(causal=True, sm_scale=Dh ** -0.5)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    delta = fa.flash_bwd_delta_plain(o, do)
    lib_ms, lib_graph = _sdpa_bwd_ms(torch, q, k, v, do)
    rows = []
    for name, kern, plain, work in (
            ("flash_bwd_dq",
             lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
             lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, **kw),
             (3, 5, 2)),
            ("flash_bwd_dkv",
             lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw),
             lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, **kw),
             (4, 6, 2))):
        bound, by, nbytes, flops = _flash_bound(B, T, Hh, Dh, *work)
        r = {"name": name, "route": "cuda", "source": FLASH_SOURCE,
             "replaces": REPLACES[name], "launches": launches[name],
             "max_abs_err": err[name], "ms": _time_ms(torch, kern, 20),
             "graph_ms": _graph_ms(torch, [kern]),
             "plain_ms": _time_ms(torch, plain, 3), "bound_ms": bound,
             "bound_by": by, "library_ms": lib_ms,
             "library_graph_ms": lib_graph, "bytes": nbytes, "flops": flops,
             "shape": {"B": B, "T": T, "H": Hh, "D": Dh, "dtype": "bf16",
                       "causal": True},
             "path": "phase 22, GPT2Config.tiny training"}
        log(f"[c1] {name} (the pair, head dims 16 and 32): {r['ms']:.4f} "
            f"ms (graph {r['graph_ms']:.4f}, plain {r['plain_ms']:.4f}, "
            f"bound {bound:.4f} by {by}; library dQ+dK+dV {lib_ms:.4f}, "
            f"graph {lib_graph:.4f}); launches {launches[name]}")
        rows.append(r)
    return rows


# ----------------------------------------------- phase 23: the KV pool

# phase 23's engines: TinyLlama's width (hidden 2048, 32 heads, 4 KV heads
# of 64) with 2 layers, 4 prompts x 128 tokens, 33 new tokens (the first,
# then two 16-step decode loops)
KV_ENGINE_LAYERS, KV_ENGINE_SEQS, KV_ENGINE_PROMPT, KV_ENGINE_GEN = \
    2, 4, 128, 33
# Bloom-7B1's attention (bigscience/bloom-7b1: 32 heads of 128, ALiBi)
BLOOM_HEADS = (32, 32, 128)


def _kv_case(torch, rng, pa, name, *, heads, S, C, lens, bs, maxb, dtype,
             quant=False, alibi=False, window=None, ring=0, route=None):
    """One phase-23 kernel case: the wrapper on the card against its plain
    version (phase 2's limits: bf16 8e-3, 1.6e-2 at D 128; fp16 4e-3; both
    2**-8 of the norm; fp32 1e-5), bit-identical from a second call, the
    launch counts of its route and of each thing it takes rising."""
    Hh, KVh, Dh = heads
    q, kp, vp, tab, st, ln = paged_inputs(
        torch, rng, S=S, C=C, lens=lens, block_size=bs, maxb=maxb,
        dtype=dtype, heads=heads)
    ex = kv_extras(torch, kp, vp, KVh, Hh, quant=quant, alibi=alibi)
    kp, vp = ex.pop("k_pool", kp), ex.pop("v_pool", vp)
    if ring:
        carry = torch.randn(32, 3, 2, S, KVh * Dh, device="cuda").to(dtype)
        ex.update(ring_k=carry[:, 1, 0], ring_v=carry[:, 1, 1],
                  ring_count=ring)
        st = (ln + ring - 1).to(torch.int32)
    kw = dict(block_size=bs, sm_scale=Dh ** -0.5, sliding_window=window,
              num_kv_heads=KVh, **ex)
    fn = getattr(pa, name)
    keys = [route or ("decode_split" if dtype != torch.float32 else
                      "decode_f32")]
    keys += [k for k, on in (("int8", quant), ("alibi", alibi),
                             ("ring", ring), ("fp16",
                                              dtype == torch.float16)) if on]
    before = {k: pa.ROUTE_LAUNCHES[k] for k in keys}
    got = fn(q, kp, vp, tab, st, ln, **kw)
    again = fn(q, kp, vp, tab, st, ln, **kw)
    torch.cuda.synchronize()
    for k in keys:
        if pa.ROUTE_LAUNCHES[k] != before[k] + 2:
            raise AssertionError(f"[kv pool] {name}: {k} launches "
                                 f"{before[k]} -> {pa.ROUTE_LAUNCHES[k]}")
    if not torch.equal(got, again):
        raise AssertionError(f"[kv pool] {name}: two calls differ")
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"[kv pool] {name}: non-finite output")
    idle = ln == 0
    if idle.any() and got[idle].abs().max().item() != 0.0:
        raise AssertionError(f"[kv pool] {name}: idle slot not zero")
    ref = pa.paged_attention_plain(q, kp, vp, tab, st, ln, **kw)
    return check_close(
        torch, f"[kv pool] {name} {keys[0]} {str(dtype)[6:]} H={Hh} KV={KVh}"
        f" D={Dh} C={C} bs={bs} window={window}"
        + (" int8" if quant else "") + (" alibi" if alibi else "")
        + (f" ring {ring}" if ring else ""), got, ref,
        bf16_max_abs=BF16_MAX_ABS if Dh <= 64 else PAGED7_BF16_MAX_ABS,
        fp32_max_abs=KV_FP32_MAX_ABS)


def _kv_engine(torch, cfg, params, prompts, **kw):
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceConfig)
    rcfg = RaggedInferenceConfig(
        max_seqs=KV_ENGINE_SEQS, chunk_size=64, block_size=64,
        num_blocks=32, max_blocks_per_seq=4, **kw)
    eng = InferenceEngineV2(cfg, params, rcfg, device="cuda")
    return eng, eng.generate(prompts, max_new_tokens=KV_ENGINE_GEN)


def phase_kv_pool(torch, woq, trace=False):
    """Phase 23: the int8 and fp16 KV pool, ALiBi and the decode ring.
    Each K1 route and K2 against the plain version (fp16: fault C4; an
    int8 pool with its scales in bf16, fp16 and fp32 compute; ALiBi at
    Bloom-7B1's heads; an int8 pool under a window; K2's ring round at
    ring counts 1, 5 and 32); engine parity at TinyLlama's width; then
    Llama-2-7B served from an int8 pool as phase 15 serves it, beside
    phase 15's bf16-pool run; then each new variant timed. Returns
    (result, kernels-line rows)."""
    import numpy as np
    from deepspeed_tpu_torch.checkpoint import init_llama_params
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceConfig)
    from deepspeed_tpu_torch.models.llama import LlamaConfig
    from deepspeed_tpu_torch.ops.kernels import paged_attention as pa
    rng = np.random.default_rng(23)
    out = {}
    worst = {}

    def case(key, *a, **kw):
        err = _kv_case(torch, rng, pa, *a, **kw)
        worst[key] = max(worst.get(key, 0.0), err)

    pa.reset_launch_counts()
    # 1. the kernels against their plain versions
    bf, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    pre_lens = [256, 512, 1024, 0]
    for heads in ((32, 4, 64), (32, 32, 96), (32, 32, 128)):
        Dh = heads[2]
        for bs, maxb in ((64, 32), (16, 128)):
            # fp16 on every K1 route these shapes reach (C4)
            route = "prefill_" + pa.prefill_route(256, Dh, f16, bs)
            case("paged_prefill_fp16", "paged_prefill", heads=heads, S=4,
                 C=256, lens=pre_lens, bs=bs, maxb=maxb, dtype=f16,
                 route=route)
        case("paged_prefill_fp16", "paged_prefill", heads=heads, S=4, C=40,
             lens=[40, 300, 0, 1000], bs=16, maxb=128, dtype=f16,
             route="prefill_mma")
        for dt in (bf, f16, f32):
            route = "prefill_" + pa.prefill_route(256, Dh, dt, 64, True)
            for window in (None, 300):
                case("paged_prefill_int8", "paged_prefill", heads=heads,
                     S=4, C=256, lens=pre_lens, bs=64, maxb=32, dtype=dt,
                     quant=True, window=window, route=route)
    # K2: GQA 1, 8 and 32 at D 64, 96 and 128
    for Dh in (64, 96, 128):
        for g in (1, 8, 32):
            heads = (32, 32 // g, Dh)
            dec_lens = rng.integers(1, 2049, 16)
            dec_lens[3] = 0                              # an idle slot
            case("paged_decode_fp16", "paged_decode", heads=heads, S=16,
                 C=1, lens=dec_lens, bs=64, maxb=32, dtype=f16)
            for dt in (bf, f16, f32):
                for window in (None, 700):
                    case("paged_decode_int8", "paged_decode", heads=heads,
                         S=16, C=1, lens=dec_lens, bs=64, maxb=32, dtype=dt,
                         quant=True, window=window)
            for rc in (1, 5, 32):
                case("paged_decode_ring", "paged_decode", heads=heads,
                     S=16, C=1, lens=dec_lens, bs=64, maxb=32, dtype=bf,
                     quant=True, ring=rc, window=700 if rc == 5 else None)
            case("paged_decode_ring", "paged_decode", heads=heads, S=16,
                 C=1, lens=dec_lens, bs=64, maxb=32, dtype=f16, ring=5)
    # ALiBi at Bloom-7B1's heads on every route, in the three dtypes
    for dt in (bf, f16, f32):
        for bs, maxb, C in ((64, 32, 256), (16, 128, 256), (16, 128, 40)):
            case("paged_prefill_alibi", "paged_prefill", heads=BLOOM_HEADS,
                 S=4, C=C, lens=[C, 700, 0, 1500], bs=bs, maxb=maxb,
                 dtype=dt, alibi=True,
                 route="prefill_" + pa.prefill_route(C, 128, dt, bs))
        case("paged_decode_alibi", "paged_decode", heads=BLOOM_HEADS, S=16,
             C=1, lens=rng.integers(1, 2049, 16), bs=64, maxb=32, dtype=dt,
             alibi=True, window=500 if dt == bf else None)
    parity_launches = dict(pa.ROUTE_LAUNCHES)
    log(f"[kv pool] kernel cases: launches {parity_launches}")
    out["parity_launches"] = parity_launches

    # 2. engine parity: the kernels against the dense path, TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prompts = np.random.default_rng(23).integers(
        1, 32000, (KV_ENGINE_SEQS, KV_ENGINE_PROMPT)).tolist()
    eng_out = {}
    cfg = LlamaConfig.tinyllama_1b(num_layers=KV_ENGINE_LAYERS,
                                   dtype=torch.float32)
    params = init_llama_params(cfg, seed=23, device="cuda",
                               dtype=torch.float32)
    for loop in (0, 16):
        gens = {}
        for impl in ("paged_flash", "dense"):
            pa.reset_launch_counts()
            eng, gens[impl] = _kv_engine(
                torch, cfg, params, prompts, dtype="float32",
                kv_cache_dtype="int8", decode_loop_steps=loop,
                attention_impl=impl)
            if impl == "paged_flash":
                launches = dict(pa.ROUTE_LAUNCHES)
                want = ["int8", "prefill_f32", "decode_f32"] \
                    + (["ring"] if loop else [])
                if not all(launches[k] for k in want) \
                        or eng.kv_cache.data.dtype != torch.int8:
                    raise AssertionError(f"[kv pool] engine int8 loop "
                                         f"{loop}: {launches}")
            del eng
        key = f"float32_int8_loop{loop}"
        if gens["paged_flash"] != gens["dense"]:
            raise AssertionError(f"[kv pool] engine {key}: kernel tokens "
                                 f"differ from dense")
        eng_out[key] = {"tokens_identical": True, "launches": launches}
        log(f"[kv pool] engine {key}: paged_flash tokens identical to "
            f"dense over {KV_ENGINE_SEQS} x {KV_ENGINE_GEN}; launches "
            f"{launches}")
    del params
    torch.cuda.empty_cache()
    # fp16 on an fp16 pool: the dense path rounds the scores to fp16
    # before its softmax and the kernels keep them fp32 (as the JAX
    # package's dense path and kernels do), so free-running greedy
    # streams may part where two logits tie within fp16's rounding. So
    # the two engines are fed the same tokens (the dense engine's argmax,
    # one put() a step): prefill and each decode step's logits within
    # 2**-8 of the norm; the free-running streams' agreement is reported
    cfg = LlamaConfig.tinyllama_1b(num_layers=KV_ENGINE_LAYERS,
                                   dtype=torch.float16)
    params = init_llama_params(cfg, seed=23, device="cuda",
                               dtype=torch.float16)
    uids = list(range(KV_ENGINE_SEQS))
    engs, gens = {}, {}
    for impl in ("paged_flash", "dense"):
        engs[impl], gens[impl] = _kv_engine(
            torch, cfg, params, prompts, dtype="float16",
            decode_loop_steps=16, attention_impl=impl)
        if engs[impl].kv_cache.data.dtype != torch.float16:
            raise AssertionError("wrong pool dtype")
    pa.reset_launch_counts()
    feed, worst_rel, worst_abs = prompts, 0.0, 0.0
    for step in range(KV_ENGINE_GEN):
        got = {impl: np.stack([v for _, v in sorted(
            engs[impl].put(uids, feed).items())]) for impl in engs}
        diff = got["paged_flash"] - got["dense"]
        worst_rel = max(worst_rel, float(np.linalg.norm(diff)
                                         / np.linalg.norm(got["dense"])))
        worst_abs = max(worst_abs, float(np.abs(diff).max()))
        feed = [[int(t)] for t in got["dense"].argmax(axis=-1)]
    launches = dict(pa.ROUTE_LAUNCHES)
    agree = float(np.mean([a == b for a, b in zip(
        sum(gens["paged_flash"], []), sum(gens["dense"], []))]))
    del engs, params
    torch.cuda.empty_cache()
    if not (launches["fp16"] and launches["decode_split"]
            and launches["fp16"] > launches["decode_split"]):
        raise AssertionError(f"[kv pool] engine fp16: {launches}")
    log(f"[kv pool] engine float16_fp16_pool: {KV_ENGINE_GEN} teacher-"
        f"forced steps, logits rel-norm {worst_rel:.3e} max-abs "
        f"{worst_abs:.3e} from dense (limit rel-norm {BF16_REL_NORM:.3e}); "
        f"free-running greedy tokens agree {agree:.3f}; launches "
        f"{launches}")
    if not worst_rel <= BF16_REL_NORM:
        raise AssertionError("[kv pool] engine fp16: kernel logits differ "
                             "from dense")
    eng_out["float16_fp16_pool"] = {
        "logits_rel_norm": worst_rel, "logits_max_abs": worst_abs,
        "free_running_token_agreement": agree, "launches": launches}
    out["engine"] = eng_out

    # 3. Llama-2-7B served from an int8 pool, as phase 15 serves bf16
    cfg = LlamaConfig.llama2_7b(max_seq_len=2048, dtype=torch.bfloat16)
    rcfg = RaggedInferenceConfig(
        max_seqs=WOQ_SEQS, chunk_size=WOQ_PROMPT,
        block_size=WOQ_PROMPT + WOQ_GEN, num_blocks=WOQ_SEQS + 2,
        max_blocks_per_seq=1, dtype="bfloat16", kv_cache_dtype="int8",
        decode_loop_steps=32, attention_impl="paged_flash")
    prompts = np.random.RandomState(0).randint(
        1, cfg.vocab_size, size=(WOQ_SEQS, WOQ_PROMPT)).tolist()
    params = init_llama_params(cfg, seed=0, device="cuda")
    eng = InferenceEngineV2(cfg, params, rcfg, device="cuda")
    del params
    torch.cuda.empty_cache()
    eng.generate([prompts[0][:80]], max_new_tokens=40)       # warm-up
    for k in eng.timing:
        eng.timing[k] = 0 if isinstance(eng.timing[k], int) else 0.0
    pa.reset_launch_counts()
    eng.runner.step_counts = {"prefill": 0, "decode": 0}
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen = eng.generate(prompts, max_new_tokens=WOQ_GEN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**pa.LAUNCHES, **pa.ROUTE_LAUNCHES}
    steps = dict(eng.runner.step_counts)
    peak = torch.cuda.max_memory_allocated()
    L = cfg.num_layers
    want = {"paged_prefill": L * steps["prefill"],
            "paged_decode": L * steps["decode"],
            "prefill_mma": L * steps["prefill"],
            "decode_split": L * steps["decode"],
            "int8": L * (steps["prefill"] + steps["decode"])}
    bad = {k: (launches[k], v) for k, v in want.items() if launches[k] != v}
    if bad or not (steps["prefill"] and steps["decode"]) \
            or not launches["ring"]:
        raise AssertionError(f"[kv pool] 7B int8: launches {launches}, "
                             f"steps {steps} ({bad})")
    if any(len(o) != WOQ_GEN for o in gen) \
            or not all(0 <= t < cfg.vocab_size for o in gen for t in o):
        raise AssertionError("wrong output lengths or token ids")
    if eng.free_blocks != rcfg.num_blocks:
        raise AssertionError("KV blocks leaked")
    logits = eng.put([999], [prompts[0]])[999]
    eng.flush(999)
    if not np.isfinite(logits).all():
        raise AssertionError("non-finite logits")
    kvc = eng.kv_cache
    data_b = kvc.data.numel() * kvc.data.element_size()
    scale_b = kvc.scales.numel() * kvc.scales.element_size()
    tm = eng.timing
    bf16_run = woq["bf16"]
    first = [o[0] for o in gen]
    serve = {
        "pool_data_bytes": data_b, "pool_scale_bytes": scale_b,
        "pool_bytes": kvc.memory_bytes(),
        "bf16_pool_bytes": bf16_run["pool_bytes"], "steps": steps,
        "launches": launches, "wall_s": wall, "prefill_s": tm["prefill_s"],
        "prefill_tokens": tm["prefill_tokens"], "decode_s": tm["decode_s"],
        "decode_tokens": tm["decode_tokens"],
        "decode_tok_s": tm["decode_tokens"] / tm["decode_s"],
        "peak_bytes": peak,
        "first_token_agreement_with_bf16_pool": float(np.mean(
            [a == b for a, b in zip(first, bf16_run["first_tokens"])])),
        "bf16_pool": {k: bf16_run[k] for k in (
            "prefill_s", "decode_tok_s", "peak_bytes", "wall_s")}}
    log(f"[kv pool] Llama-2-7B int8 pool: data {data_b / 1e9:.3f} GB + "
        f"scales {scale_b / 1e9:.3f} GB = {serve['pool_bytes'] / 1e9:.3f} "
        f"GB (bf16 pool {bf16_run['pool_bytes'] / 1e9:.3f} GB); steps "
        f"{steps}, prefill {tm['prefill_tokens']} tokens in "
        f"{tm['prefill_s']:.4f} s (bf16 pool {bf16_run['prefill_s']:.4f}), "
        f"decode {tm['decode_tokens']} tokens in {tm['decode_s']:.4f} s = "
        f"{serve['decode_tok_s']:.1f} tok/s (bf16 pool "
        f"{bf16_run['decode_tok_s']:.1f}), wall {wall:.3f} s, peak memory "
        f"{peak / 2**30:.2f} GiB (bf16 pool "
        f"{bf16_run['peak_bytes'] / 2**30:.2f}), first tokens agree with "
        f"the bf16 pool's {serve['first_token_agreement_with_bf16_pool']:.3f}"
        f"; launches {launches}")
    if trace:
        log("[trace] Llama-2-7B int8 pool:")
        serve["trace"] = phase_trace(torch, eng, prompts)
        log(f"[trace] Llama-2-7B int8 pool decode window: device idle share "
            f"{serve['trace']['decode'].get('idle_share')} (bf16 pool "
            f"{bf16_run.get('trace', {}).get('decode', {}).get('idle_share')})")
    out["llama2_7b_int8"] = serve
    del eng
    torch.cuda.empty_cache()

    # 4. each variant timed: at the 7B shapes (K2 at 64 x 576, one split;
    # K1 on the 64 x 512 prefill step) and, for fp16, phase 5's TinyLlama
    # shapes; ALiBi at Bloom-7B1's heads on the 7B shapes
    rows = []
    lin = dict(block_size=WOQ_PROMPT + WOQ_GEN, maxb=1)
    dec7 = dict(S=WOQ_SEQS, C=1, ctx=WOQ_PROMPT + WOQ_GEN // 2, **lin)
    pre7 = dict(S=WOQ_SEQS, C=WOQ_CHUNK, ctx=WOQ_PROMPT, **lin)
    h7 = (H7, KV7, D7)
    specs = [
        ("paged_decode_int8", "paged_decode", dict(**dec7, heads=h7,
                                                   quant=True),
         launches["paged_decode"], "llama2_7b int8 serving"),
        ("paged_decode_ring", "paged_decode", dict(**dec7, heads=h7,
                                                   quant=True, ring=16),
         launches["ring"], "llama2_7b int8 serving"),
        ("paged_prefill_int8", "paged_prefill", dict(**pre7, heads=h7,
                                                     quant=True),
         launches["paged_prefill"], "llama2_7b int8 serving"),
        ("paged_decode_fp16", "paged_decode",
         dict(S=16, C=1, ctx=544, block_size=64, maxb=16,
              dtype=torch.float16),
         eng_out["float16_fp16_pool"]["launches"]["decode_split"],
         "TinyLlama-width fp16 engine"),
        ("paged_prefill_fp16", "paged_prefill",
         dict(S=16, C=256, ctx=512, block_size=64, maxb=16,
              dtype=torch.float16),
         eng_out["float16_fp16_pool"]["launches"]["fp16"]
         - eng_out["float16_fp16_pool"]["launches"]["decode_split"],
         "TinyLlama-width fp16 engine"),
        ("paged_decode_alibi", "paged_decode", dict(**dec7,
                                                    heads=BLOOM_HEADS,
                                                    alibi=True),
         parity_launches["alibi"], "phase 23's kernel cases (BLOOM's "
         "served ALiBi rows are phase 28's)"),
        ("paged_prefill_alibi", "paged_prefill", dict(**pre7,
                                                      heads=BLOOM_HEADS,
                                                      alibi=True),
         parity_launches["alibi"], "phase 23's kernel cases (BLOOM's "
         "served ALiBi rows are phase 28's)"),
    ]
    trng = np.random.default_rng(230)
    timing = {}
    for row_name, fn_name, kw, n_launch, launches_from in specs:
        t = time_paged(torch, trng, fn_name,
                       bf16_max_abs=PAGED7_BF16_MAX_ABS, **kw)
        timing[row_name] = t
        rows.append({"name": row_name, "route": "cuda", "source": SOURCE,
                     "replaces": REPLACES[fn_name], "launches": n_launch,
                     "launches_from": launches_from,
                     **t, "max_abs_err": max(worst.get(row_name, 0.0),
                                             t["max_abs_err"])})
        torch.cuda.empty_cache()
    # the bf16 pool's K2 at the same 7B shape, in this call, for the ratio
    t = time_paged(torch, trng, "paged_decode", **dec7, heads=h7,
                   bf16_max_abs=PAGED7_BF16_MAX_ABS)
    timing["paged_decode_bf16_7b"] = t
    log(f"[kv pool] K2 at the 7B shape: int8 pool "
        f"{timing['paged_decode_int8']['ms']:.4f} ms (graph "
        f"{timing['paged_decode_int8']['graph_ms']:.4f}, bound "
        f"{timing['paged_decode_int8']['bound_ms']:.4f}) against bf16 "
        f"{t['ms']:.4f} (graph {t['graph_ms']:.4f}, bound "
        f"{t['bound_ms']:.4f})")
    out["timing"] = timing
    return out, rows


# ---------------------------------------------------------------- HF serving

# phase 24: the published config.json of Qwen/Qwen2-7B (model_type qwen2:
# biased q/k/v, GQA 7 at head dim 128, untied head), and of Qwen2-1.5B
# for a card machine whose temporary space cannot hold the 7B shards
QWEN2_7B = {"architectures": ["Qwen2ForCausalLM"], "model_type": "qwen2",
            "hidden_size": 3584, "intermediate_size": 18944,
            "num_hidden_layers": 28, "num_attention_heads": 28,
            "num_key_value_heads": 4, "vocab_size": 152064,
            "max_position_embeddings": 131072, "rope_theta": 1000000.0,
            "rms_norm_eps": 1e-06, "tie_word_embeddings": False,
            "hidden_act": "silu", "sliding_window": 131072,
            "use_sliding_window": False, "max_window_layers": 28,
            "bos_token_id": 151643, "eos_token_id": 151643,
            "torch_dtype": "bfloat16"}
#: phases 24-25 serve Qwen2-7B at HF_LAYERS of its 28 layers (published
#: widths; the whole script's time, cut when phase 33 came)
HF_LAYERS = 14
QWEN2_1P5B = {**QWEN2_7B, "hidden_size": 1536, "intermediate_size": 8960,
              "num_attention_heads": 12, "num_key_value_heads": 2,
              "vocab_size": 151936, "max_window_layers": 21,
              "tie_word_embeddings": True}
#: HF's default max_shard_size ("5GB")
HF_SHARD_BYTES = 5_000_000_000
HF_SEQS, HF_PROMPT, HF_GEN = 16, 512, 64
HF_SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.95)
#: the sampler's chi-squared test: draws, and the least p-value passed
CHI2_DRAWS, CHI2_MIN_P = 1 << 16, 1e-3


def _qwen2_specs(hf):
    """Every tensor of the checkpoint in writing order: (HF name, HF
    shape, kind, tree path, transposed in the tree)."""
    M, I, V = hf["hidden_size"], hf["intermediate_size"], hf["vocab_size"]
    kvd = hf["num_key_value_heads"] * M // hf["num_attention_heads"]
    specs = [("model.embed_tokens.weight", (V, M), "embed",
              "embed/embedding", False)]
    for i in range(hf["num_hidden_layers"]):
        p, t = f"model.layers.{i}", f"layer_{i}"
        specs.append((f"{p}.input_layernorm.weight", (M,), "norm",
                       f"{t}/input_norm/scale", False))
        for x, n in (("q", M), ("k", kvd), ("v", kvd)):
            specs += [(f"{p}.self_attn.{x}_proj.weight", (n, M), "linear",
                       f"{t}/attn/{x}_proj/kernel", True),
                      (f"{p}.self_attn.{x}_proj.bias", (n,), "bias",
                       f"{t}/attn/{x}_proj/bias", False)]
        specs.append((f"{p}.self_attn.o_proj.weight", (M, M), "linear",
                      f"{t}/attn/o_proj/kernel", True))
        specs.append((f"{p}.post_attention_layernorm.weight", (M,), "norm",
                      f"{t}/post_attn_norm/scale", False))
        for x, shape in (("gate", (I, M)), ("up", (I, M)), ("down", (M, I))):
            specs.append((f"{p}.mlp.{x}_proj.weight", shape, "linear",
                          f"{t}/mlp/{x}_proj/kernel", True))
    specs.append(("model.norm.weight", (M,), "norm", "final_norm/scale",
                  False))
    if not hf["tie_word_embeddings"]:
        specs.append(("lm_head.weight", (V, M), "linear", "lm_head/kernel",
                      True))
    return specs


def _qwen2_tensor(torch, gen, kind, shape):
    """One bf16 tensor on the card, at ``init_llama_params``'s scales
    (embedding std 1, a [out, in] weight std 1/sqrt(in), norm scales
    ones); the q/k/v biases normal with std 0.02, so that the bias path
    shows. GPT-2's kinds: a Conv1D weight ([in, out]) std 1/sqrt(in), an
    embedding std 1/sqrt(width) (``init_gpt2_params``'s scales)."""
    if kind == "norm":
        return torch.ones(shape, dtype=torch.bfloat16, device="cuda")
    t = torch.randn(shape, generator=gen, device="cuda")
    std = {"embed": 1.0, "bias": 0.02, "conv1d": shape[0] ** -0.5,
           "gpt2_embed": shape[-1] ** -0.5}.get(kind)
    return (t * (std if std is not None else shape[1] ** -0.5)).to(
        torch.bfloat16)


def write_hf_checkpoint(torch, path, hf, seed, specs=None):
    """A random checkpoint in HF's layout: ``config.json``, safetensors
    shards of at most HF_SHARD_BYTES and ``model.safetensors.index.json``,
    each tensor made on the card and written as it is made, so that one
    tensor at a time sits in host memory. ``specs``: the tensors
    (default ``_qwen2_specs(hf)``). Returns the bytes written."""
    import numpy as np
    specs = specs or _qwen2_specs(hf)
    shards, size = [[]], 0
    for s in specs:
        n = 2 * math.prod(s[1])
        if size and size + n > HF_SHARD_BYTES:
            shards.append([])
            size = 0
        shards[-1].append(s)
        size += n
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    weight_map, total = {}, 0
    for k, shard in enumerate(shards):
        fname = f"model-{k + 1:05d}-of-{len(shards):05d}.safetensors"
        header, off = {"__metadata__": {"format": "pt"}}, 0
        for name, shape, *_ in shard:
            n = 2 * math.prod(shape)
            header[name] = {"dtype": "BF16", "shape": list(shape),
                            "data_offsets": [off, off + n]}
            off += n
            weight_map[name] = fname
        hb = json.dumps(header, separators=(",", ":")).encode()
        hb += b" " * (-len(hb) % 8)
        with open(path / fname, "wb") as f:
            f.write(len(hb).to_bytes(8, "little"))
            f.write(hb)
            for name, shape, kind, *_ in shard:
                t = _qwen2_tensor(torch, gen, kind, shape)
                f.write(np.ascontiguousarray(
                    t.view(torch.int16).cpu().numpy()).data)
        total += off
    (path / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map},
        indent=2))
    (path / "config.json").write_text(json.dumps(hf, indent=2))
    return total, len(shards)


def _check_written(torch, params, hf, seed, specs=None):
    """Every loaded leaf equals, bit for bit, the tensor written (made
    again from the same seed, in the same order)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    n = 0
    for name, shape, kind, path, transposed in specs or _qwen2_specs(hf):
        t = _qwen2_tensor(torch, gen, kind, shape)
        leaf = params
        for k in path.split("/"):
            leaf = leaf[k]
        want = t.t() if transposed else t
        if leaf.dtype != torch.bfloat16 or leaf.shape != want.shape \
                or not torch.equal(leaf.view(torch.int16),
                                   want.view(torch.int16)):
            raise AssertionError(f"[hf] loaded {path} differs from the "
                                 f"written {name}")
        n += 1
    return n


def _chi2_sampler(torch, logits_row):
    """The sampler's draws (temperature 0.8, top-k 50, top-p 0.95, keys
    from CHI2_DRAWS (seed, position) pairs) against the distribution its
    masks define on one logits row: the softmax of row / T over the top
    50, cut where the mass before a rank reaches 0.95 (computed in fp32
    on the CPU as the sampler computes it), renormalized. Returns (chi2,
    degrees of freedom, p)."""
    import numpy as np
    from scipy.stats import chi2
    from deepspeed_tpu_torch.inference.v2 import model_runner as mr
    T, K, P = (HF_SAMPLING[k] for k in ("temperature", "top_k", "top_p"))
    row = torch.as_tensor(logits_row, dtype=torch.float32)
    vals, idxs = mr._topk_by_index(row[None], 256)
    x = (vals[0] / T)[:K]
    p = torch.softmax(x, dim=-1)
    keep = (torch.cumsum(p, dim=-1) - p) < P
    probs = np.exp(x[keep].double().numpy() - float(x[keep].max()))
    probs /= probs.sum()
    allowed = idxs[0, :K][keep].numpy()
    B = 2048
    counts = np.zeros(len(allowed), np.int64)
    lr = row.cuda()[None].expand(B, -1)
    cfg = {k: torch.full((B,), v, device="cuda", dtype=dt)
           for k, v, dt in (("temps", T, torch.float32),
                            ("top_ks", K, torch.int32),
                            ("top_ps", P, torch.float32))}
    where = {int(t): i for i, t in enumerate(allowed)}
    for b in range(CHI2_DRAWS // B):
        seeds = torch.arange(b * B, (b + 1) * B, device="cuda")
        keys = mr._sample_keys(seeds, seeds * 7 + 3)
        tok = mr._select_tokens(lr, keys, cfg["temps"], cfg["top_ks"],
                                cfg["top_ps"], cand=256).cpu().numpy()
        for t in tok:
            if int(t) not in where:
                raise AssertionError(f"[hf] sampler drew {t}, outside "
                                     f"its top-k / top-p set")
            counts[where[int(t)]] += 1
    expected = probs * CHI2_DRAWS
    # bins with fewer than 5 expected draws merge into one
    small = expected < 5
    obs = np.append(counts[~small], counts[small].sum())
    exp = np.append(expected[~small], expected[small].sum())
    if exp[-1] == 0:
        obs, exp = obs[:-1], exp[:-1]
    stat = float(((obs - exp) ** 2 / exp).sum())
    dof = len(exp) - 1
    return stat, dof, float(chi2.sf(stat, dof)), len(allowed)


def phase_hf_serving(torch):
    """Phase 24: a random Qwen2-7B checkpoint written in HF's layout,
    served through ``build_hf_engine`` (module docstring). Returns (out,
    rows, keep): ``keep`` holds the checkpoint directory, its model config
    and its loaded bf16 parameters for phase 25, whose caller removes the
    directory (``keep["dir"]``); on a failure here it is removed now."""
    import shutil
    import tempfile

    import numpy as np
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceConfig,
                                                  SamplingParams,
                                                  build_hf_engine)
    from deepspeed_tpu_torch.inference.quantization import woq_memory_bytes
    from deepspeed_tpu_torch.inference.v2 import model_runner as mr
    from deepspeed_tpu_torch.ops.kernels import paged_attention as pa
    from deepspeed_tpu_torch.ops.kernels import quantization as qz
    from deepspeed_tpu_torch.utils import random as trandom
    out, rows = {}, []
    tmp = Path(tempfile.mkdtemp(prefix="qwen2_"))
    kept = False
    try:
        free = shutil.disk_usage(tmp).free
        qwen7 = {**QWEN2_7B, "num_hidden_layers": HF_LAYERS}
        need = 2 * sum(math.prod(s[1]) for s in _qwen2_specs(qwen7))
        hf, model = (qwen7, "Qwen/Qwen2-7B") if free > need * 1.05 \
            else (QWEN2_1P5B, "Qwen/Qwen2-1.5B")
        log(f"[hf] {tmp}: {free / 1e9:.1f} GB free, the 7B shards need "
            f"{need / 1e9:.2f} GB: writing {model}'s shape")
        out["model"], out["free_bytes"] = model, free
        if hf is qwen7:
            out["reduced"] = (f"depth cut to {HF_LAYERS} of 28 layers "
                              f"(published widths kept; the whole "
                              f"script's time)")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nbytes, nshards = write_hf_checkpoint(torch, tmp, hf, seed=24)
        out["write_s"] = time.perf_counter() - t0
        out["checkpoint_bytes"], out["shards"] = nbytes, nshards
        log(f"[hf] wrote {nbytes / 1e9:.3f} GB in {nshards} shards in "
            f"{out['write_s']:.1f} s")
        L = hf["num_hidden_layers"]
        maxb = -(-(HF_PROMPT + HF_GEN) // 64)

        def rcfg(**kw):
            return RaggedInferenceConfig(
                max_seqs=HF_SEQS, chunk_size=256, block_size=64,
                num_blocks=HF_SEQS * maxb + 8, max_blocks_per_seq=maxb,
                dtype="bfloat16", **{"attention_impl": "paged_flash",
                                     "decode_loop_steps": 0, **kw})

        # ---- load
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng0 = build_hf_engine(str(tmp), engine_config=rcfg(
            serve_pipeline_depth=0), dtype="bfloat16")
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        out["param_bytes"] = woq_memory_bytes(eng0.params)
        out["leaves_bit_identical"] = _check_written(torch, eng0.params, hf,
                                                     seed=24)
        log(f"[hf] build_hf_engine: {out['load_s']:.1f} s, parameters "
            f"{out['param_bytes'] / 1e9:.3f} GB; "
            f"{out['leaves_bit_identical']} leaves bit-identical to the "
            f"written tensors")
        cfg, params = eng0.model_cfg, eng0.params
        if (cfg.num_heads // cfg.num_kv_heads, cfg.head_dim, cfg.qkv_bias) \
                != (hf["num_attention_heads"] // hf["num_key_value_heads"],
                    128, True):
            raise AssertionError(f"[hf] config {cfg}")
        engs = {"depth0": eng0,
                "depth2": InferenceEngineV2(cfg, params, rcfg(
                    serve_pipeline_depth=2), device="cuda"),
                "loop16": InferenceEngineV2(cfg, params, rcfg(
                    serve_pipeline_depth=2, decode_loop_steps=16),
                    device="cuda")}
        rng = np.random.default_rng(24)
        prompts = rng.integers(1, cfg.vocab_size,
                               (HF_SEQS, HF_PROMPT)).tolist()
        for e in engs.values():            # warm-up: handles, staging
            e.generate([prompts[0][:80]], max_new_tokens=20)

        # ---- greedy at depth 0, depth 2 and through the decode loop
        gens, runs = {}, {}
        for name, e in engs.items():
            for k in e.timing:
                e.timing[k] = 0 if isinstance(e.timing[k], int) else 0.0
            e.runner.step_counts = {"prefill": 0, "decode": 0}
            for k in e.pipeline_stats:
                e.pipeline_stats[k] *= 0
            pa.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gens[name] = e.generate(prompts, max_new_tokens=HF_GEN)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            steps = dict(e.runner.step_counts)
            launches = {**pa.LAUNCHES, **pa.ROUTE_LAUNCHES}
            want = {"paged_prefill": L * steps["prefill"],
                    "prefill_wgmma_tma": L * steps["prefill"],
                    "paged_decode": L * steps["decode"],
                    "decode_split": L * steps["decode"]}
            bad = {k: (launches[k], v) for k, v in want.items()
                   if launches[k] != v}
            if bad or not (steps["prefill"] and steps["decode"]):
                raise AssertionError(f"[hf] {name}: launches {launches}, "
                                     f"steps {steps} ({bad})")
            if any(len(o) != HF_GEN for o in gens[name]) or \
                    e.free_blocks != e.config.num_blocks:
                raise AssertionError(f"[hf] {name}: lengths or blocks")
            tm = e.timing
            runs[name] = {
                "steps": steps, "launches": {k: launches[k] for k in want},
                "launches_per_step": {k: v // max(1, steps[
                    "prefill" if "prefill" in k else "decode"])
                    for k, v in want.items()},
                "pipeline_stats": dict(e.pipeline_stats),
                "prefill_s": tm["prefill_s"], "decode_s": tm["decode_s"],
                "decode_tokens": tm["decode_tokens"],
                "decode_tok_s": tm["decode_tokens"] / tm["decode_s"],
                "wall_s": wall}
            log(f"[hf] greedy {name}: prefill {tm['prefill_tokens']} tokens "
                f"in {tm['prefill_s']:.4f} s, decode {tm['decode_tokens']} "
                f"in {tm['decode_s']:.4f} s = "
                f"{runs[name]['decode_tok_s']:.1f} tok/s, wall {wall:.3f} "
                f"s; steps {steps}; launches {runs[name]['launches']}; "
                f"pipeline {e.pipeline_stats}")
        st2 = runs["depth2"]["pipeline_stats"]
        if not (st2["fed_steps"] and st2["readbacks"] == st2["steps"]):
            raise AssertionError(f"[hf] depth 2 pipeline {st2}")
        if not gens["depth0"] == gens["depth2"] == gens["loop16"]:
            raise AssertionError("[hf] greedy streams differ between "
                                 "depth 0, depth 2 and the decode loop")
        greedy = gens["depth0"]
        log("[hf] greedy streams identical at depth 0, depth 2 and "
            "through the decode loop")
        out["greedy"] = runs

        # ---- EOS on the delayed readback (depth 2)
        e2 = engs["depth2"]
        eos = greedy[1][9]
        free0 = e2.free_blocks
        uids = list(range(100, 100 + HF_SEQS))
        first = e2.put(uids, prompts, _greedy=True)
        res = e2.decode_pipelined(uids, [first[u] for u in uids],
                                  HF_GEN - 1, eos_token_id=eos)
        for i, u in enumerate(uids):
            g = greedy[i][1:]
            want = g[:g.index(eos) + 1] if eos in g else g
            if res[u] != want:
                raise AssertionError(f"[hf] EOS stream {i} differs")
            s = e2.state.get(u)
            if len(s.kv_blocks) != -(-s.seen_tokens // 64) or \
                    s.seen_tokens != HF_PROMPT + len(want):
                raise AssertionError(f"[hf] EOS rollback of {i}: "
                                     f"{s.seen_tokens}, {len(s.kv_blocks)}")
        for u in uids:
            e2.flush(u)
        if e2.free_blocks != free0:
            raise AssertionError("[hf] EOS rollback leaked blocks")
        ended = sum(1 for i in range(HF_SEQS) if eos in greedy[i][1:])
        out["eos"] = {"eos": eos, "streams_ended": ended,
                      "free_blocks": e2.free_blocks}
        log(f"[hf] decode_pipelined with eos {eos}: {ended} streams end at "
            f"it, as the greedy streams; free blocks back to {free0}")

        # ---- sampling
        sp = SamplingParams(**HF_SAMPLING)
        samp = {n: e.generate(prompts, max_new_tokens=HF_GEN, sampling=sp,
                              seed=24) for n, e in engs.items()}
        if not samp["depth0"] == samp["depth2"] == samp["loop16"]:
            raise AssertionError("[hf] sampled streams differ by path")
        if samp["depth0"] == greedy:
            raise AssertionError("[hf] sampling at temperature 0.8 gave "
                                 "the greedy streams")
        t0p = {u: SamplingParams(temperature=0.0, logprobs=True)
               for u in uids}
        first = e2.put(uids, prompts, _greedy=True, sampling=t0p)
        res = e2.decode_pipelined(uids, [first[u] for u in uids],
                                  HF_GEN - 1)
        if [[first[u]] + res[u] for u in uids] != greedy:
            raise AssertionError("[hf] temperature 0 differs from greedy")
        lps = [e2.logprobs_of(u) for u in uids]
        for u in uids:
            e2.flush(u)
        if not all(len(x) == HF_GEN and all(v <= 0 for v in x)
                   for x in lps):
            raise AssertionError("[hf] logprobs")
        n = 4096
        seeds = torch.randint(0, 2 ** 31 - 1, (n,), generator=None)
        pos = torch.randint(0, 1 << 20, (n,))
        kc = mr._sample_keys(seeds.cuda(), pos.cuda())
        kh = mr._sample_keys(seeds, pos)
        if not (torch.equal(kc.cpu(), kh)
                and torch.equal(trandom.random_bits(kc, 256).cpu(),
                                trandom.random_bits(kh, 256))
                and torch.equal(trandom.uniform(kc, 256).cpu(),
                                trandom.uniform(kh, 256))):
            raise AssertionError("[hf] threefry on the card differs from "
                                 "the CPU's")
        logits = eng0.put([999], [prompts[0]])[999]
        eng0.flush(999)
        stat, dof, pval, support = _chi2_sampler(torch, logits)
        out["sampling"] = {"params": HF_SAMPLING, "streams_identical": True,
                           "temperature0_is_greedy": True,
                           "keys_bits_uniform_equal_cpu": n,
                           "chi2": stat, "dof": dof, "p": pval,
                           "support": support, "draws": CHI2_DRAWS}
        log(f"[hf] sampled streams identical at depth 0, depth 2 and "
            f"through the decode loop; temperature 0 = greedy; threefry "
            f"keys, bits and uniforms of {n} (seed, position) pairs equal "
            f"the CPU's; chi2 {stat:.2f} on {dof} dof over {support} "
            f"tokens, p = {pval:.4f} (limit {CHI2_MIN_P})")
        if not pval > CHI2_MIN_P:
            raise AssertionError("[hf] the sampler's draws fail chi2")
        # phase 25 serves these very parameters
        keep = {"dir": tmp, "model": model, "cfg": cfg, "params": params}
        del engs, e, e2, eng0, params
        torch.cuda.empty_cache()

        # ---- dense attention on the same directory: first tokens
        engd = build_hf_engine(str(tmp), engine_config=rcfg(
            attention_impl="dense"), dtype="bfloat16")
        fd = engd.put(list(range(HF_SEQS)), prompts, _greedy=True)
        agree = float(np.mean([fd[i] == greedy[i][0]
                               for i in range(HF_SEQS)]))
        out["dense_first_token_agreement"] = agree
        log(f"[hf] first tokens: paged kernels against dense attention "
            f"agree on {agree:.3f}")
        del engd
        torch.cuda.empty_cache()

        # ---- wf8 at load: the group quantizer once per quantized leaf
        qz.reset_launch_counts()
        t0 = time.perf_counter()
        engq = build_hf_engine(str(tmp), engine_config=rcfg(),
                               dtype="bfloat16", quantization_mode="wf8")
        torch.cuda.synchronize()
        qload = time.perf_counter() - t0
        qlaunch = qz.LAUNCHES["quantize_sym"]
        if qlaunch != 7 * L or qz.LAUNCHES["quantize_asym"]:
            raise AssertionError(f"[hf] wf8 launches {qz.LAUNCHES}")
        pa.reset_launch_counts()
        gq = engq.generate(prompts, max_new_tokens=4)
        if not (pa.LAUNCHES["paged_prefill"] and pa.LAUNCHES["paged_decode"]):
            raise AssertionError(f"[hf] wf8 serving {pa.LAUNCHES}")
        qagree = float(np.mean([a[0] == b[0] for a, b in zip(gq, greedy)]))
        qbytes = woq_memory_bytes(engq.params)
        out["wf8"] = {"load_s": qload, "quantize_launches": qlaunch,
                      "param_bytes": qbytes,
                      "first_token_agreement_with_bf16": qagree}
        log(f"[hf] wf8: build {qload:.1f} s, {qlaunch} quantize_sym "
            f"launches ({7 * L} leaves), parameters {qbytes / 1e9:.3f} GB; "
            f"first tokens agree with bf16 on {qagree:.3f}")
        del engq
        torch.cuda.empty_cache()
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        log(f"[hf] peak memory {out['peak_bytes'] / 2**30:.2f} GiB")
        kept = True
    finally:
        if not kept:
            shutil.rmtree(tmp, ignore_errors=True)

    # ---- the path's kernels at its shapes: K1 on the second 256-token
    # chunk of the 16 x 512 prompts, K2 mid-decode, the quantizer on the
    # gate_proj leaf
    trng = np.random.default_rng(240)
    heads = (hf["num_attention_heads"], hf["num_key_value_heads"], 128)
    main = out["greedy"]["depth2"]
    for name, C, ctx in (("paged_prefill", 256, HF_PROMPT),
                         ("paged_decode", 1, HF_PROMPT + HF_GEN // 2)):
        t = time_paged(torch, trng, name, S=HF_SEQS, C=C, ctx=ctx,
                       block_size=64, maxb=maxb, heads=heads,
                       bf16_max_abs=PAGED7_BF16_MAX_ABS)
        rows.append({"name": f"{name}_qwen2", "route": "cuda",
                     "source": SOURCE, "replaces": REPLACES[name],
                     "launches": main["launches"][name],
                     "launches_from": f"phase 24, {model} greedy at "
                                      f"depth 2", **t})
        torch.cuda.empty_cache()
    g = torch.Generator(device="cuda")
    g.manual_seed(241)
    M, I = hf["hidden_size"], hf["intermediate_size"]
    leaf = (torch.randn(M, I, generator=g, device="cuda") * M ** -0.5).to(
        torch.bfloat16)
    err = _quant_case(torch, qz, leaf, bits=8, gs=128, sym=True,
                      what=f"[{M}, {I}] bf16 {model} gate_proj")
    kw = dict(bits=8, group_size=128, symmetric=True)
    n_el = leaf.numel()
    ms = _time_ms(torch, lambda: qz.quantize_blockwise(leaf, **kw), 50)
    plain_ms = _time_ms(torch, lambda: qz.quantize_blockwise_plain(
        leaf, **kw), 5)
    rows.append(_op_row(
        "quantize_sym", QUANT_SOURCE, out["wf8"]["quantize_launches"], err,
        ms, plain_ms, None, n_el * 2 + n_el + -(-n_el // 128) * 4, 3 * n_el,
        F32_FLOPS_PER_S, launches_from=f"phase 24, {model} wf8 at load",
        library_call="none: no single PyTorch call computes it",
        shape={"leaf": [M, I], "dtype": "bf16", "bits": 8,
               "group_size": 128},
        graph_ms=_graph_ms(torch, [lambda: qz.quantize_blockwise(
            leaf, **kw)])))
    rows[-1]["name"] = "quantize_sym_qwen2"
    del leaf
    torch.cuda.empty_cache()
    return out, rows, keep


# ---------------------------------------------------------------- prefix

# phase 25: the shared-prefix workload on phase 24's Qwen2-7B. Six
# 1000-token system preambles, 48 requests (a preamble and a 24-200-token
# tail, PFX_NEW greedy tokens) in 6 waves of 8: wave w takes preambles
# 2w and 2w+1 (mod 6), so waves 4-6 revisit the chains of waves 1-3.
PFX_PREAMBLES, PFX_PRE_LEN, PFX_WAVES, PFX_WAVE = 6, 1000, 6, 8
PFX_TAIL, PFX_NEW = (24, 200), 32
# run (b)'s pool (six chains plus a wave do not fit) and run (c)'s host
# tier; run (a)'s pool holds a whole wave without the cache
PFX_BLOCKS, PFX_HOST = 96, 256


def _pfx_waves(vocab, seed=25):
    """[(leaders, followers)] a wave: (uid, prompt) lists, the leaders
    one request per preamble."""
    import numpy as np
    rng = np.random.default_rng(seed)
    pres = [rng.integers(1, vocab, PFX_PRE_LEN).tolist()
            for _ in range(PFX_PREAMBLES)]
    waves, uid = [], 0
    for w in range(PFX_WAVES):
        pair = ((2 * w) % PFX_PREAMBLES, (2 * w + 1) % PFX_PREAMBLES)
        reqs = []
        for i in range(PFX_WAVE):
            n = int(rng.integers(PFX_TAIL[0], PFX_TAIL[1] + 1))
            reqs.append((uid, pres[pair[i % 2]]
                         + rng.integers(1, vocab, n).tolist()))
            uid += 1
        waves.append((reqs[:2], reqs[2:]))
    return waves


def _digest(t):
    """A hash of a tensor's bytes (device or host)."""
    import hashlib
    if t is None:
        return None
    return hashlib.sha1(t.detach().contiguous().view(-1).view(
        __import__("torch").uint8).cpu().numpy().tobytes()).hexdigest()


def _pfx_block(kv, b):
    bs = kv.cfg.block_size
    return (kv.data[:, :, b * bs:(b + 1) * bs],
            None if kv.scales is None else kv.scales[..., b * bs:(b + 1) * bs])


def _pfx_instrument(torch, eng):
    """Hold every block move of ``eng`` bit-exact as it happens: a CoW
    copy's rows (and scales) equal its source block's; a promotion's
    destination rows equal the buffer it scatters, and a promoted entry's
    buffer hashes as its rows did at the demotion gather. Returns the
    counts of each check."""
    kv, pc = eng.kv_cache, eng._prefix
    seen = {"cow_checked": 0, "promotes_checked": 0,
            "promoted_vs_demotion_hash": 0}
    sums, pending = {}, []
    copy0, demote0 = kv.copy_block, pc.demote
    promote0, blocks0 = pc.promote, kv.promote_blocks

    def same(a, b):
        return torch.equal(a[0], b[0].to(a[0].device)) and (
            a[1] is None or torch.equal(a[1], b[1].to(a[1].device)))

    def copy_block(src, dst):
        copy0(src, dst)
        if not same(_pfx_block(kv, dst), _pfx_block(kv, src)):
            raise AssertionError(f"[prefix] CoW copy {src} -> {dst}")
        seen["cow_checked"] += 1

    def demote(entries, refs):
        for e, r in zip(entries, refs):
            rows, sc = r.get()
            sums[id(e)] = (_digest(rows), _digest(sc))
        return demote0(entries, refs)

    def promote(entry, block):
        pending.append((id(entry), block))
        return promote0(entry, block)

    def promote_blocks(promotes):
        blocks0(promotes)
        for buf, dst in promotes:
            if not same(_pfx_block(kv, dst), buf):
                raise AssertionError(f"[prefix] promotion into {dst}")
            seen["promotes_checked"] += 1
        for eid, dst in pending:
            rows, sc = _pfx_block(kv, dst)
            if (_digest(rows), _digest(sc)) != sums.pop(eid):
                raise AssertionError(f"[prefix] promoted block {dst} "
                                     f"differs from its demotion gather")
            seen["promoted_vs_demotion_hash"] += 1
        pending.clear()
    kv.copy_block, pc.demote = copy_block, demote
    pc.promote, kv.promote_blocks = promote, promote_blocks
    return seen


def _pfx_pause_resume(torch, eng, uid):
    """Pause ``uid`` and resume it at once: its rows (and scales) after
    the restore equal its rows before the offload."""
    kv = eng.kv_cache
    seq = eng.state.get(uid)
    before = [t.clone() if t is not None else None
              for t in kv.gather_blocks(seq.kv_blocks)]
    eng.pause(uid)
    eng.resume(uid)
    after = kv.gather_blocks(seq.kv_blocks)
    if not all(a is None or torch.equal(a, b)
               for a, b in zip(after, before)):
        raise AssertionError(f"[prefix] resumed {uid}'s rows differ")


PFX_STATS = ("prefill_chunks_skipped_frac", "host_hit_frac", "matched_tokens",
             "prefill_tokens", "cow_copies", "demoted", "promoted",
             "host_hit_blocks", "evicted_pressure", "evicted_cap",
             "host_evicted")


def _pfx_serve(torch, eng, waves, *, wave_hook=None, decode_hook=None,
               stop=None):
    """Serve the waves on ``eng`` (each: a put of the leaders, a put of
    the followers, ``decode_pipelined`` for the rest of PFX_NEW tokens, a
    flush), the cache's invariants after each. ``wave_hook(w, uids)``
    runs before a wave's decode, ``decode_hook(w)`` may return a
    ``_pre_commit`` hook for it; ``stop``: the wave after whose decode the
    run stops (its sequences stay live). Returns streams, per-wave
    prefill seconds, decode seconds and tokens."""
    streams, prefill_s, dec_s, dec_tok = {}, [], 0.0, 0
    for w, (leaders, rest) in enumerate(waves):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = {}
        for group in (leaders, rest):
            first.update(eng.put([u for u, _ in group],
                                 [p for _, p in group], _greedy=True))
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
        uids = [u for u, _ in leaders + rest if u in first]
        if wave_hook is not None:
            wave_hook(w, uids)
        orig = eng._pre_commit
        hook = decode_hook(w) if decode_hook is not None else None
        if hook is not None:
            eng._pre_commit = hook
        t0 = time.perf_counter()
        res = eng.decode_pipelined(uids, [first[u] for u in uids],
                                   PFX_NEW - 1)
        torch.cuda.synchronize()
        eng._pre_commit = orig
        dec_s += time.perf_counter() - t0
        dec_tok += sum(len(v) for v in res.values())
        for u in uids:
            streams[u] = [first[u]] + res[u]
        if stop == w:
            return streams, prefill_s, dec_s, dec_tok
        for u in uids:
            eng.flush(u)
        if eng._prefix is not None:
            eng._prefix.check_invariants()
            eng._prefix.assert_exact_refs(eng.state.sequences.values())
    if eng.free_blocks != eng.config.num_blocks:
        raise AssertionError(f"[prefix] blocks not back: {eng.free_blocks}")
    return streams, prefill_s, dec_s, dec_tok


def _pfx_agree(streams, ref):
    uids = [u for u in streams if u in ref]
    first = sum(streams[u][:1] == ref[u][:1] for u in uids)
    whole = sum(streams[u] == ref[u] for u in uids)
    return {"first_token": first / len(uids), "stream": whole / len(uids),
            "requests": len(uids)}


def time_hit_path(torch, rng, name, rec, *, heads, block_size, num_blocks,
                  dtype, quant):
    """K1 or K2 at a step recorded on the prefix cache's hit path (start
    positions, live queries, block tables shared between slots) over a
    random pool of the engine's size: against its plain version (the
    phase's limits), its time (events and a CUDA graph), the plain
    version's, SDPA on each slot's context gathered and padded (with its
    causal mask; over an int8 pool the same K/V in bf16, a reference
    only), and the bound: bytes of the live queries, the output, and the
    distinct blocks the tables touch (a shared block read once), or the
    FLOPs of the live causal pairs."""
    from deepspeed_tpu_torch.inference.v2.kv_quant import quantize_rows
    from deepspeed_tpu_torch.ops.kernels import paged_attention as pa
    Hh, KVh, Dh = heads
    start, ntok, tables, C = rec["start"], rec["ntok"], rec["tables"], \
        rec["C"]
    S = len(start)
    lens = (start + ntok) * (ntok > 0)
    slots = (num_blocks + 1) * block_size
    dev = "cuda"
    kp = torch.randn(slots, KVh * Dh, device=dev)
    vp = torch.randn(slots, KVh * Dh, device=dev)
    ex = {}
    cdt = torch.bfloat16 if quant else dtype
    if quant:
        kq, ks = quantize_rows(kp, KVh)
        vq, vs = quantize_rows(vp, KVh)
        ex = dict(k_scales=ks.contiguous(), v_scales=vs.contiguous())
        kp, vp = kq, vq
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    q = torch.randn(S, C, Hh, Dh, device=dev).to(cdt)
    t = lambda a: torch.from_numpy(a).to(dev)       # noqa: E731
    tab, st, ln = t(tables), t(start), t(lens)
    kw = dict(block_size=block_size, sm_scale=Dh ** -0.5,
              sliding_window=None, num_kv_heads=KVh, **ex)
    fn = getattr(pa, name)
    got = fn(q, kp, vp, tab, st, ln, **kw)
    ref = pa.paged_attention_plain(q, kp, vp, tab, st, ln, **kw)
    live = torch.from_numpy(ntok > 0)
    qmask = torch.zeros(S, C, dtype=torch.bool)
    for s in range(S):
        qmask[s, :int(ntok[s])] = True
    what = (f"{name} on the hit path at S={S} C={C} starts "
            f"{sorted(set(int(x) for x in start[ntok > 0]))[:4]} live "
            f"queries {[int(x) for x in ntok]} H={Hh} KV={KVh} D={Dh} "
            f"{str(cdt)[6:]}" + (" int8 pool" if quant else ""))
    qm = qmask.to(dev)
    err = check_close(torch, f"[prefix] {what}", got[qm], ref[qm],
                      bf16_max_abs=PAGED7_BF16_MAX_ABS)
    if got[~live.to(dev)].any():
        raise AssertionError("[prefix] an idle slot's rows are not zero")
    again = fn(q, kp, vp, tab, st, ln, **kw)
    if not torch.equal(got, again):
        raise AssertionError(f"[prefix] {name} differs call to call")
    del got, ref, again
    call = lambda: fn(q, kp, vp, tab, st, ln, **kw)   # noqa: E731
    ms = _time_ms(torch, call, 50)
    graph_ms = _graph_ms(torch, [call])
    plain_ms = _time_ms(torch, lambda: pa.paged_attention_plain(
        q, kp, vp, tab, st, ln, **kw), 3)
    T = int(lens.max())
    j = torch.arange(T, device=dev)
    idx = tab.long()[:, j // block_size] * block_size + j % block_size

    def dense(pool, sc):
        x = pool[idx].float()
        if sc is not None:
            x = x.reshape(S, T, KVh, Dh) * sc.T[idx][..., None]
        return x.reshape(S, T, KVh, Dh).to(cdt).transpose(1, 2) \
            .contiguous()
    kc, vc = dense(kp, ex.get("k_scales")), dense(vp, ex.get("v_scales"))
    qc = q.transpose(1, 2).contiguous()
    pos = st.long()[:, None] + torch.arange(C, device=dev)[None, :]
    mask = (j[None, None, :] <= pos[:, :, None]) \
        & (j[None, None, :] < ln.long()[:, None, None])
    mask = mask | ~qm[:, :, None]            # padded rows: any finite row
    lib_ms = _time_ms(torch, _sdpa(qc, kc, vc, mask[:, None]), 50)
    lib_graph_ms = _graph_ms(torch, [_sdpa(qc, kc, vc, mask[:, None])])
    el = q.element_size()
    blocks = {int(tables[s, i]) for s in range(S) if ntok[s]
              for i in range(-(-int(lens[s]) // block_size))}
    nq = int(ntok.sum())
    kv_el = 1 if quant else el
    nbytes = (2 * nq * Hh * Dh * el
              + 2 * len(blocks) * block_size * KVh * Dh * kv_el
              + (2 * len(blocks) * block_size * KVh * 4 if quant else 0)
              + tables.size * 4 + 2 * S * 4)
    pairs = sum(int(start[s]) * int(ntok[s])
                + int(ntok[s]) * (int(ntok[s]) + 1) // 2 for s in range(S))
    flops = 4 * Hh * Dh * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    out = {"ms": ms, "graph_ms": graph_ms, "plain_ms": plain_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": lib_ms, "library_graph_ms": lib_graph_ms,
           "max_abs_err": err, "bytes": nbytes, "flops": flops,
           "shape": {"S": S, "C": C, "H": Hh, "KV": KVh, "D": Dh,
                     "start": [int(x) for x in start],
                     "live_queries": [int(x) for x in ntok],
                     "distinct_blocks": len(blocks),
                     "table_blocks": int(sum(-(-int(n) // block_size)
                                             for n in lens)),
                     "block_size": block_size, "dtype": str(cdt)[6:],
                     "int8_pool": quant}}
    if quant:
        out["library_note"] = ("SDPA over the same K/V in bf16: a "
                               "reference only (no PyTorch call computes "
                               "the scaled int8 function)")
    if C > 1:
        out["kernel_route"] = pa.prefill_route(C, Dh, cdt, block_size, quant)
    out["graph_bound_share"] = out["bound_ms"] / graph_ms
    log(f"[prefix] {what}: {ms:.4f} ms (graph {graph_ms:.4f}, plain "
        f"{plain_ms:.4f}, sdpa {lib_ms:.4f} / graph {lib_graph_ms:.4f}, "
        f"bound {out['bound_ms']:.4f} by {out['bound_by']}, "
        f"{out['graph_bound_share']:.1%} of it in the graph; "
        f"{len(blocks)} distinct blocks of {out['shape']['table_blocks']} "
        f"in the tables)" + (f"; route {out['kernel_route']}"
                             if C > 1 else ""))
    return out


def phase_prefix_serving(torch, ctx):
    """Phase 25: the shared-prefix workload (PFX_*) on phase 24's
    Qwen2-7B parameters (module docstring)."""
    import tempfile

    import numpy as np
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceConfig,
                                                  manifest_from_journal)
    from deepspeed_tpu_torch.ops.kernels import paged_attention as pa
    cfg, params, model = ctx["cfg"], ctx["params"], ctx["model"]
    L = cfg.num_layers
    maxb = -(-(PFX_PRE_LEN + PFX_TAIL[1] + PFX_NEW) // 64)
    waves = _pfx_waves(cfg.vocab_size)
    out, rows = {"model": model, "max_blocks_per_seq": maxb}, []

    def engine(**kw):
        base = dict(max_seqs=PFX_WAVE, chunk_size=256, block_size=64,
                    max_blocks_per_seq=maxb, dtype="bfloat16",
                    attention_impl="paged_flash", decode_loop_steps=0,
                    serve_pipeline_depth=2, num_blocks=PFX_BLOCKS,
                    prefix_cache=True)
        base.update(kw)
        eng = InferenceEngineV2(cfg, params, RaggedInferenceConfig(**base),
                                device="cuda")
        eng.pause_count = 0
        pause0 = eng.pause

        def pause(uid):
            eng.pause_count += 1
            pause0(uid)
        eng.pause = pause
        return eng

    def report(name, eng, streams, prefill_s, dec_s, dec_tok, extra=None):
        st = eng.prefix_stats
        r = {"prefix_stats": {k: st[k] for k in PFX_STATS if k in st},
             "pauses": eng.pause_count,
             "resumes": eng.pause_count,
             "prefill_s_per_wave": prefill_s, "decode_s": dec_s,
             "decode_tokens": dec_tok, "decode_tok_s": dec_tok / dec_s,
             "promote_wait_s": eng.pipeline_stats["promote_wait_s"],
             "num_blocks": eng.config.num_blocks,
             "host_blocks": eng.config.prefix_cache_host_blocks,
             "pipeline_depth": eng.pipeline_depth,
             "kv_cache_dtype": eng.config.kv_cache_dtype, **(extra or {})}
        if "a" in out:
            r["agreement_with_a"] = _pfx_agree(streams, out["a"]["streams"])
        out[name] = r
        log(f"[prefix] run ({name}): {r['prefix_stats']}; pauses "
            f"{r['pauses']}; prefill s a wave "
            f"{[round(x, 4) for x in prefill_s]}; decode {dec_tok} tokens "
            f"in {dec_s:.3f} s = {r['decode_tok_s']:.1f} tok/s; "
            f"promote_wait_s {r['promote_wait_s']:.4f}"
            + (f"; agreement with (a) {r['agreement_with_a']}"
               if "agreement_with_a" in r else ""))
        return r

    # warm-up on a throwaway engine: handles, staging, the first launches
    w0 = engine(num_blocks=2 * maxb + 4)
    w0.generate([waves[0][0][0][1][:300]], max_new_tokens=4)
    del w0

    # (a) cache off, a pool that holds a whole wave
    eng = engine(prefix_cache=False, num_blocks=PFX_WAVE * maxb + 8)
    res = _pfx_serve(torch, eng, waves)
    report("a", eng, *res)
    out["a"]["streams"] = res[0]
    del eng

    # (b) the device tier only
    eng = engine()
    res = _pfx_serve(torch, eng, waves)
    report("b", eng, *res)
    if not out["b"]["prefix_stats"]["evicted_pressure"] > 0:
        raise AssertionError("[prefix] (b) never evicted under pressure")
    del eng

    # (c) with the host tier, at depth 2 (the kernels' launches read
    # here: the phase's main path) and at depth 0 (every block move held
    # bit-exact as it happens)
    eng = engine(prefix_cache_host_blocks=PFX_HOST)
    rec = {}
    disp0 = eng._dispatch_step

    def record(plan):
        n = plan.ntok.numpy()
        key = "prefill" if plan.tokens.shape[1] > 1 else "decode"
        if key not in rec and (key == "decode" and "prefill" in rec
                               or key == "prefill"
                               and (plan.start.numpy()[n > 1]
                                    == PFX_PRE_LEN).sum() >= 2):
            rec[key] = {"start": plan.start.numpy().copy(),
                        "ntok": n.copy(),
                        "tables": plan.tables.numpy().copy(),
                        "C": plan.tokens.shape[1]}
        return disp0(plan)
    eng._dispatch_step = record
    pa.reset_launch_counts()
    eng.runner.step_counts = {"prefill": 0, "decode": 0}
    res = _pfx_serve(torch, eng, waves)
    launches = {**pa.LAUNCHES, **pa.ROUTE_LAUNCHES}
    steps = dict(eng.runner.step_counts)
    want = {"paged_prefill": L * steps["prefill"],
            "prefill_wgmma_tma": L * steps["prefill"],
            "paged_decode": L * steps["decode"],
            "decode_split": L * steps["decode"]}
    if any(launches[k] != v for k, v in want.items()) \
            or not (steps["prefill"] and steps["decode"]):
        raise AssertionError(f"[prefix] (c) launches {launches}, steps "
                             f"{steps}")
    report("c", eng, *res, extra={"launches": {k: launches[k]
                                               for k in want},
                                  "steps": steps})
    streams_c = res[0]
    st = out["c"]["prefix_stats"]
    if not (st["demoted"] > 0 and st["promoted"] > 0
            and st["host_hit_blocks"] > 0 and st["evicted_pressure"] == 0):
        raise AssertionError(f"[prefix] (c) host tier: {st}")
    if set(rec) != {"prefill", "decode"}:
        raise AssertionError(f"[prefix] hit-path steps not recorded: "
                             f"{list(rec)}")
    del eng
    eng = engine(prefix_cache_host_blocks=PFX_HOST, serve_pipeline_depth=0)
    seen = _pfx_instrument(torch, eng)
    res = _pfx_serve(torch, eng, waves)
    report("c_depth0", eng, *res, extra={"checked": dict(seen)})
    if res[0] != streams_c:
        raise AssertionError("[prefix] (c) streams differ between "
                             "depth 0 and depth 2")
    if not (seen["cow_checked"] and seen["promotes_checked"]
            and seen["promoted_vs_demotion_hash"]):
        raise AssertionError(f"[prefix] block moves not checked: {seen}")
    log(f"[prefix] (c) depth 0 = depth 2, streams identical; block moves "
        f"held bit-exact: {seen}")
    del eng

    # (d) (c) over an int8 pool (codes and scales move together)
    eng = engine(prefix_cache_host_blocks=PFX_HOST, kv_cache_dtype="int8")
    seen = _pfx_instrument(torch, eng)
    pa.reset_launch_counts()
    res = _pfx_serve(torch, eng, waves)
    launches = {**pa.LAUNCHES, **pa.ROUTE_LAUNCHES}
    if not (launches["prefill_mma"] and launches["int8"]
            and launches["decode_split"]):
        raise AssertionError(f"[prefix] (d) launches {launches}")
    report("d", eng, *res, extra={
        "checked": dict(seen), "pool_bytes": eng.kv_cache.memory_bytes(),
        "launches": {k: launches[k] for k in ("paged_prefill", "prefill_mma",
                                              "paged_decode", "int8")}})
    del eng

    # (e) on (c)'s config with a journal: a pause/resume of one follower
    # a wave, two requests aborted with steps in flight (wave 2), one
    # request past its deadline (wave 3), then a drain in wave 4 and a
    # replay of its manifest on a fresh engine
    jdir = Path(tempfile.mkdtemp(prefix="journal_"))
    try:
        jpath = str(jdir / "serve.jsonl")
        eng = engine(prefix_cache_host_blocks=PFX_HOST, serve_journal=jpath)
        aborted, deferred = waves[1][1][0][0], []
        late = waves[2][1][1][0]

        def wave_hook(w, uids):
            if w < 3:
                _pfx_pause_resume(torch, eng, waves[w][1][2][0])

        def decode_hook(w):
            orig, n = eng._pre_commit, [0]
            if w not in (1, 3):
                return None

            def hook(fl):
                r = orig(fl)
                n[0] += 1
                if w == 1 and n[0] == 3:
                    for u in (aborted, aborted + 1):
                        eng.abort(u)
                    deferred.append(sum(len(f.aborts)
                                        for f in eng._live_ring))
                if w == 3 and n[0] == 5:
                    eng.request_drain()
                return r
            return hook
        put0 = eng.put

        def put(uids, toks, **kw):
            if late in uids:
                kw["deadlines"] = {late: 1e-3}
            return put0(uids, toks, **kw)
        eng.put = put
        res = _pfx_serve(torch, eng, waves[:4], wave_hook=wave_hook,
                         decode_hook=decode_hook, stop=3)
        streams_e = res[0]
        if deferred != [2]:
            raise AssertionError(f"[prefix] (e) aborts not deferred: "
                                 f"{deferred}")
        if eng.rejections.get(late, {}).get("reason") \
                != "deadline_exceeded":
            raise AssertionError(f"[prefix] (e) deadline: "
                                 f"{eng.rejections}")
        t0 = time.perf_counter()
        manifest = eng.drain()
        drain_s = time.perf_counter() - t0
        if not manifest["pool"]["fully_recovered"]:
            raise AssertionError(f"[prefix] (e) drain: {manifest['pool']}")
        jm = manifest_from_journal(jpath)
        key = lambda m: [(s["uid"], s["prompt"], s["generated"])  # noqa
                         for s in m["sequences"]]
        if key(jm) != key(manifest):
            raise AssertionError("[prefix] (e) journal and manifest differ")
        report("e", eng, *res, extra={
            "drain_s": drain_s, "manifest_sequences":
            len(manifest["sequences"]), "deferred_aborts": deferred[0],
            "rejections": {str(u): r["reason"]
                           for u, r in eng.rejections.items()}})
        del eng
        surv = engine(prefix_cache_host_blocks=PFX_HOST)
        t0 = time.perf_counter()
        nxt = surv.replay(manifest)
        gen = {s["uid"]: list(s["generated"]) + [nxt[s["uid"]]]
               for s in manifest["sequences"]}
        uids = sorted(gen)
        more = surv.decode_pipelined(uids, [gen[u][-1] for u in uids],
                                     [PFX_NEW - len(gen[u]) for u in uids])
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t0
        for u in uids:
            gen[u] += more[u]
            surv.flush(u)
        if surv.free_blocks != surv.config.num_blocks \
                or any(len(g) != PFX_NEW for g in gen.values()):
            raise AssertionError("[prefix] (e) replay lengths or blocks")
        out["e"].update(
            replay_s=replay_s, replay_pauses=surv.pause_count,
            replay_agreement_with_c=_pfx_agree(gen, streams_c),
            waves_1_3_agreement_with_c=_pfx_agree(
                {u: v for u, v in streams_e.items()
                 if u not in (aborted, aborted + 1, late)
                 and u < 3 * PFX_WAVE}, streams_c))
        log(f"[prefix] (e) drain {drain_s:.4f} s ({len(uids)} sequences "
            f"manifested, journal equal, pool fully recovered); replay and "
            f"finish {replay_s:.3f} s with {surv.pause_count} pauses; "
            f"replayed streams agree with (c) "
            f"{out['e']['replay_agreement_with_c']}, waves 1-3's (but the "
            f"two aborted and the expired) "
            f"{out['e']['waves_1_3_agreement_with_c']}")
        del surv
    finally:
        shutil.rmtree(jdir, ignore_errors=True)
    out["a"].pop("streams")
    torch.cuda.empty_cache()

    # the two kernels at the recorded hit-path steps
    trng = np.random.default_rng(250)
    heads = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    for name, key in (("paged_prefill", "prefill"),
                      ("paged_decode", "decode")):
        for dtype, quant, tag in ((torch.bfloat16, False, ""),
                                  (torch.float16, False, "_fp16"),
                                  (torch.bfloat16, True, "_int8")):
            t = time_hit_path(torch, trng, name, rec[key], heads=heads,
                              block_size=64, num_blocks=PFX_BLOCKS,
                              dtype=dtype, quant=quant)
            if tag == "_fp16":
                n, src = 0, ("no fp16 pool is served in phase 25: held "
                             "at the hit-path shape only")
            else:
                run_ = "d" if quant else "c"
                n = out[run_]["launches"][name]
                src = f"phase 25, {model} run ({run_})"
            rows.append({"name": f"{name}_prefix_hit{tag}", "route": "cuda",
                         "source": SOURCE, "replaces": REPLACES[name],
                         "launches": n, "launches_from": src, **t})
            torch.cuda.empty_cache()
    return out, rows


# ---------------------------------------------------------------- gpt2

# phase 26: the published config.json of openai-community/gpt2-xl (gpt2:
# 48 layers, n_embd 1600, 25 heads of 64 with no GQA, vocab 50257, 1024
# positions), its tensors in bf16
GPT2_XL = {"architectures": ["GPT2LMHeadModel"], "model_type": "gpt2",
           "vocab_size": 50257, "n_positions": 1024, "n_ctx": 1024,
           "n_embd": 1600, "n_layer": 48, "n_head": 25,
           "activation_function": "gelu_new", "layer_norm_epsilon": 1e-5,
           "resid_pdrop": 0.1, "embd_pdrop": 0.1, "attn_pdrop": 0.1,
           "initializer_range": 0.02, "bos_token_id": 50256,
           "eos_token_id": 50256, "torch_dtype": "bfloat16"}
GPT2_SEQS, GPT2_PROMPT, GPT2_GEN = 16, 256, 32


def _gpt2_specs(hf):
    """Every tensor of a GPT-2 checkpoint in HF's layout, in writing order
    (the names of the hub's gpt2-xl: no ``transformer.`` prefix; Conv1D
    weights are [in, out], as the tree holds them)."""
    C, V, P = hf["n_embd"], hf["vocab_size"], hf["n_positions"]
    specs = [("wte.weight", (V, C), "gpt2_embed", "wte/embedding", False),
             ("wpe.weight", (P, C), "gpt2_embed", "wpe/embedding", False)]
    for i in range(hf["n_layer"]):
        h = f"h.{i}"
        for ln in ("ln_1", "ln_2"):
            specs += [(f"{h}.{ln}.weight", (C,), "norm",
                       f"h_{i}/{ln}/scale", False),
                      (f"{h}.{ln}.bias", (C,), "bias", f"h_{i}/{ln}/bias",
                       False)]
        for mod, name, din, dout in (("attn", "c_attn", C, 3 * C),
                                     ("attn", "c_proj", C, C),
                                     ("mlp", "c_fc", C, 4 * C),
                                     ("mlp", "c_proj", 4 * C, C)):
            specs += [(f"{h}.{mod}.{name}.weight", (din, dout), "conv1d",
                       f"h_{i}/{mod}/{name}/kernel", False),
                      (f"{h}.{mod}.{name}.bias", (dout,), "bias",
                       f"h_{i}/{mod}/{name}/bias", False)]
    specs += [("ln_f.weight", (C,), "norm", "ln_f/scale", False),
              ("ln_f.bias", (C,), "bias", "ln_f/bias", False)]
    return specs


def phase_gpt2_serving(torch):
    """Phase 26: GPT-2 XL from a random checkpoint in HF's layout through
    ``build_hf_engine`` (module docstring). Returns (out, rows)."""
    import shutil
    import tempfile

    import numpy as np
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceConfig,
                                                  SamplingParams,
                                                  build_hf_engine)
    from deepspeed_tpu_torch.inference.quantization import woq_memory_bytes
    from deepspeed_tpu_torch.inference.v2.model_runner import \
        GPT2RaggedRunner
    from deepspeed_tpu_torch.ops.kernels import paged_attention as pa
    hf, model = GPT2_XL, "openai-community/gpt2-xl"
    specs = _gpt2_specs(hf)
    L = hf["n_layer"]
    heads = (hf["n_head"], hf["n_head"], hf["n_embd"] // hf["n_head"])
    maxb = -(-(GPT2_PROMPT + GPT2_GEN) // 64)
    out, rows = {"model": model}, []
    tmp = Path(tempfile.mkdtemp(prefix="gpt2xl_"))
    try:
        t0 = time.perf_counter()
        nbytes, nshards = write_hf_checkpoint(torch, tmp, hf, seed=26,
                                              specs=specs)
        out["write_s"] = time.perf_counter() - t0
        out["checkpoint_bytes"], out["shards"] = nbytes, nshards

        def rcfg(**kw):
            return RaggedInferenceConfig(
                max_seqs=GPT2_SEQS, chunk_size=256, block_size=64,
                num_blocks=GPT2_SEQS * maxb + 8, max_blocks_per_seq=maxb,
                dtype="bfloat16", **{"attention_impl": "paged_flash",
                                     "decode_loop_steps": 0, **kw})

        t0 = time.perf_counter()
        eng0 = build_hf_engine(str(tmp), engine_config=rcfg(
            serve_pipeline_depth=0), dtype="bfloat16")
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        out["param_bytes"] = woq_memory_bytes(eng0.params)
        out["leaves_bit_identical"] = _check_written(
            torch, eng0.params, hf, seed=26, specs=specs)
        cfg, params = eng0.model_cfg, eng0.params
        if not isinstance(eng0.runner, GPT2RaggedRunner) or \
                (eng0.runner.kv_heads, eng0.runner.head_dim) != heads[1:]:
            raise AssertionError(f"[gpt2] runner {eng0.runner}")
        log(f"[gpt2] {model}: wrote {nbytes / 1e9:.3f} GB in {nshards} "
            f"shards in {out['write_s']:.1f} s; build_hf_engine "
            f"{out['load_s']:.1f} s, parameters "
            f"{out['param_bytes'] / 1e9:.3f} GB, "
            f"{out['leaves_bit_identical']} leaves bit-identical")
        engs = {"depth0": eng0,
                "depth2": InferenceEngineV2(cfg, params, rcfg(
                    serve_pipeline_depth=2), device="cuda")}
        rng = np.random.default_rng(26)
        prompts = rng.integers(0, cfg.vocab_size,
                               (GPT2_SEQS, GPT2_PROMPT)).tolist()
        for e in engs.values():              # warm-up
            e.generate([prompts[0][:80]], max_new_tokens=8)
        sp = SamplingParams(**HF_SAMPLING)
        gens, runs = {}, {}
        for mode in ("greedy", "sampled"):
            for name, e in engs.items():
                e.timing.update({k: 0 if isinstance(v, int) else 0.0
                                 for k, v in e.timing.items()})
                e.runner.step_counts = {"prefill": 0, "decode": 0}
                pa.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                gens[mode, name] = e.generate(
                    prompts, max_new_tokens=GPT2_GEN,
                    sampling=sp if mode == "sampled" else None, seed=26)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                steps = dict(e.runner.step_counts)
                launches = {**pa.LAUNCHES, **pa.ROUTE_LAUNCHES}
                want = {"paged_prefill": L * steps["prefill"],
                        "prefill_wgmma_tma": L * steps["prefill"],
                        "paged_decode": L * steps["decode"],
                        "decode_split": L * steps["decode"]}
                bad = {k: (launches[k], v) for k, v in want.items()
                       if launches[k] != v}
                if bad or not (steps["prefill"] and steps["decode"]):
                    raise AssertionError(f"[gpt2] {mode} {name}: launches "
                                         f"{launches}, steps {steps}")
                if any(len(o) != GPT2_GEN for o in gens[mode, name]) or \
                        e.free_blocks != e.config.num_blocks:
                    raise AssertionError(f"[gpt2] {name}: lengths, blocks")
                tm = e.timing
                runs[f"{mode}_{name}"] = r = {
                    "steps": steps,
                    "launches": {k: launches[k] for k in want},
                    "prefill_s": tm["prefill_s"], "decode_s": tm["decode_s"],
                    "decode_tokens": tm["decode_tokens"],
                    "decode_tok_s": tm["decode_tokens"] / tm["decode_s"],
                    "wall_s": wall,
                    "pipeline_stats": dict(e.pipeline_stats)}
                log(f"[gpt2] {mode} {name}: prefill {tm['prefill_tokens']}"
                    f" tokens in {tm['prefill_s']:.4f} s, decode "
                    f"{tm['decode_tokens']} in {tm['decode_s']:.4f} s = "
                    f"{r['decode_tok_s']:.1f} tok/s; steps {steps}; "
                    f"launches {r['launches']}")
            if gens[mode, "depth0"] != gens[mode, "depth2"]:
                raise AssertionError(f"[gpt2] {mode} streams differ between "
                                     f"depth 0 and depth 2")
        if gens["greedy", "depth0"] == gens["sampled", "depth0"]:
            raise AssertionError("[gpt2] sampling gave the greedy streams")
        log("[gpt2] greedy and sampled streams identical at depths 0 and 2")
        # the argmax over the odd vocabulary: the on-card greedy token of
        # each prompt against numpy's argmax of the logits put returns
        logits = eng0.put(list(range(100, 104)), prompts[:4])
        for u in range(100, 104):
            eng0.flush(u)
        am = [int(np.argmax(logits[100 + i])) for i in range(4)]
        if am != [g[0] for g in gens["greedy", "depth0"][:4]]:
            raise AssertionError(f"[gpt2] argmax over {cfg.vocab_size}: "
                                 f"{am}")
        out["argmax_checked"] = 4
        out["runs"] = runs
        out["vocab_size"], out["heads"] = cfg.vocab_size, list(heads)
        del engs, e, eng0, params
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # K1 on the 16 x 256 prefill step, K2 mid-decode, at 25 heads of 64
    trng = np.random.default_rng(260)
    main = runs["greedy_depth2"]
    for name, C, ctx in (("paged_prefill", 256, GPT2_PROMPT),
                         ("paged_decode", 1, GPT2_PROMPT + GPT2_GEN // 2)):
        t = time_paged(torch, trng, name, S=GPT2_SEQS, C=C, ctx=ctx,
                       block_size=64, maxb=maxb, heads=heads)
        rows.append({"name": f"{name}_gpt2_xl", "route": "cuda",
                     "source": SOURCE, "replaces": REPLACES[name],
                     "launches": main["launches"][name],
                     "launches_from": f"phase 26, {model} greedy at "
                                      f"depth 2", **t})
    torch.cuda.empty_cache()
    return out, rows


# ---------------------------------------------------------------- spec

# phase 27: speculative decoding on Llama-2-7B (bf16, prefix cache on).
# Eight prompts: a shared 128-token preamble (two blocks, cached by the
# warm-up) and 128 tokens of a per-prompt 16-token pattern repeated.
SPEC_SEQS, SPEC_PRE, SPEC_PROMPT, SPEC_GEN, SPEC_K = 8, 128, 256, 48, 4


def _spec_run(torch, pa, eng, prompts, L):
    """One case: the prompts through ``put``, then ``decode_pipelined``
    for SPEC_GEN - 1 tokens, the launch counts zeroed just before each
    and read just after. Returns (streams, record)."""
    uids = list(range(len(prompts)))
    st0 = dict(eng.spec_stats)
    pa.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = eng.put(uids, prompts, _greedy=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    prefill = {**pa.LAUNCHES}
    pa.reset_launch_counts()
    steps0 = eng.runner.step_counts["decode"]
    out = eng.decode_pipelined(uids, [first[u] for u in uids],
                               SPEC_GEN - 1)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    decode = {**pa.LAUNCHES, **{f"route_{k}": v
                                for k, v in pa.ROUTE_LAUNCHES.items()}}
    streams = [[first[u]] + out[u] for u in uids]
    st = {k: eng.spec_stats[k] - st0[k] for k in st0}
    seqs = [eng.state.get(u) for u in uids]
    rec = {"prefill_s": t1 - t0, "decode_s": t2 - t1,
           "decode_tokens": sum(len(out[u]) for u in uids),
           "prefill_launches": prefill, "decode_launches": decode,
           "target_decode_steps": eng.runner.step_counts["decode"] - steps0,
           "spec_stats": st,
           "spec_proposed": sum(s.spec_proposed for s in seqs),
           "spec_accepted": sum(s.spec_accepted for s in seqs),
           "prefix": {k: eng.prefix_stats[k] for k in
                      ("matched_tokens", "trims")}}
    rec["decode_tok_s"] = rec["decode_tokens"] / rec["decode_s"]
    if st["rounds"]:
        rec["acceptance"] = st["accepted"] / max(1, st["proposed"])
        # a sequence commits its accepted drafts and one token a round
        rec["tokens_per_seq_round"] = rec["decode_tokens"] / max(
            1, rec["decode_tokens"] - st["accepted"])
        rec["host_s_per_round"] = (st["propose_s"] + st["verify_s"]
                                   + st["commit_s"]) / st["rounds"]
        rec["verify_s_per_round"] = st["verify_s"] / st["rounds"]
        rec["propose_s_per_round"] = st["propose_s"] / st["rounds"]
        rec["target_k2_per_round"] = L * rec["target_decode_steps"] \
            / st["rounds"]
    eng._prefix.check_invariants()
    eng._prefix.assert_exact_refs(eng.state.sequences.values())
    for u in uids:
        eng.flush(u)
    d = eng._draft_engine
    rec["free_blocks"] = eng.free_blocks
    rec["draft_free_blocks"] = d.free_blocks if d is not None else None
    if eng.free_blocks != eng.config.num_blocks or (
            d is not None and (d.free_blocks != d.config.num_blocks
                               or d.state.sequences)):
        raise AssertionError(f"[spec] blocks not back: {rec}")
    if not (prefill["paged_prefill"] and decode["paged_decode"]):
        raise AssertionError(f"[spec] launches {prefill} {decode}")
    return streams, rec


def phase_spec_decoding(torch):
    """Phase 27: speculative decoding on Llama-2-7B (module docstring).
    Returns (out, rows)."""
    import numpy as np
    from deepspeed_tpu_torch.checkpoint import init_llama_params
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceConfig)
    from deepspeed_tpu_torch.models.llama import LlamaConfig
    from deepspeed_tpu_torch.ops.kernels import paged_attention as pa
    cfg = LlamaConfig.llama2_7b(dtype=torch.bfloat16)
    dcfg = LlamaConfig.tinyllama_1b(dtype=torch.bfloat16)
    params = init_llama_params(cfg, seed=27, device="cuda")
    maxb = -(-(SPEC_PROMPT + SPEC_GEN + SPEC_K + 1) // 64)
    L = cfg.num_layers

    def rcfg(**kw):
        return RaggedInferenceConfig(
            max_seqs=SPEC_SEQS, chunk_size=256, block_size=64,
            num_blocks=SPEC_SEQS * maxb + 8, max_blocks_per_seq=maxb,
            dtype="bfloat16", attention_impl="paged_flash",
            decode_loop_steps=0, serve_pipeline_depth=2, prefix_cache=True,
            **kw)

    rng = np.random.default_rng(27)
    pre = rng.integers(1, cfg.vocab_size, SPEC_PRE).tolist()
    prompts = [pre + (rng.integers(1, cfg.vocab_size, 16).tolist()
                      * 8)[:SPEC_PROMPT - SPEC_PRE]
               for _ in range(SPEC_SEQS)]
    cases = {"a_off": {}, "b_ngram": {"spec_decode": "ngram"},
             "c_draft_tinyllama": {"spec_decode": "draft"},
             "d_draft_self": {"spec_decode": "draft"}}
    out, streams = {"cases": {}}, {}
    for name, kw in cases.items():
        eng = InferenceEngineV2(cfg, params, rcfg(spec_k=SPEC_K, **kw),
                                device="cuda")
        if name == "c_draft_tinyllama":
            eng.attach_draft(dcfg, init_llama_params(dcfg, seed=28,
                                                     device="cuda"))
        elif name == "d_draft_self":
            eng.attach_draft(cfg, params)
        # warm-up: the preamble (cached, two full blocks) and 8 tokens
        f = eng.put([99], [pre], _greedy=True)
        eng.decode_pipelined([99], [f[99]], 8)
        eng.flush(99)
        eng.spec_stats.update({k: 0 if isinstance(v, int) else 0.0
                               for k, v in eng.spec_stats.items()})
        streams[name], rec = _spec_run(torch, pa, eng, prompts, L)
        if rec["prefix"]["matched_tokens"] < SPEC_SEQS * SPEC_PRE:
            raise AssertionError(f"[spec] {name}: the preamble was not "
                                 f"matched: {rec['prefix']}")
        out["cases"][name] = rec
        log(f"[spec] {name}: prefill {rec['prefill_s']:.4f} s, decode "
            f"{rec['decode_tokens']} tokens in {rec['decode_s']:.4f} s = "
            f"{rec['decode_tok_s']:.1f} tok/s; "
            + (f"acceptance {rec['acceptance']:.4f} "
               f"({rec['spec_stats']['accepted']} of "
               f"{rec['spec_stats']['proposed']}), "
               f"{rec['spec_stats']['rounds']} rounds, "
               f"{rec['tokens_per_seq_round']:.2f} tokens a sequence a "
               f"round, host "
               f"{rec['host_s_per_round']:.4f} s a round (propose "
               f"{rec['propose_s_per_round']:.4f}, verify "
               f"{rec['verify_s_per_round']:.4f}), target K2 "
               f"{rec['target_k2_per_round']:.1f} launches a round; "
               if "acceptance" in rec else "")
            + f"launches {rec['decode_launches']}; trims "
              f"{rec['prefix']['trims']}")
        del eng
        torch.cuda.empty_cache()
    ref = streams["a_off"]
    for name in ("b_ngram", "c_draft_tinyllama", "d_draft_self"):
        if streams[name] != ref:
            bad = sum(a != b for a, b in zip(streams[name], ref))
            raise AssertionError(f"[spec] {name}: {bad} streams differ "
                                 f"from spec off")
        if not out["cases"][name]["spec_stats"]["rounds"]:
            raise AssertionError(f"[spec] {name}: no verify round ran")
    acc_d = out["cases"]["d_draft_self"]["acceptance"]
    if acc_d != 1.0:
        raise AssertionError(f"[spec] a draft that is the target accepted "
                             f"{acc_d}, not 1.0")
    out["streams_identical"] = True
    base = out["cases"]["a_off"]["decode_tok_s"]
    out["tok_s_against_off"] = {n: r["decode_tok_s"] / base
                                for n, r in out["cases"].items()}
    log(f"[spec] (b)-(d) streams identical to (a); (d) acceptance 1.0; "
        f"decode tok/s against (a): {out['tok_s_against_off']}")
    # K2 at the verify rounds' shape (8 slots mid-decode at 128 heads of
    # 32 x 128), K1 at the prefill after the cached preamble
    trng = np.random.default_rng(270)
    verify = sum(r["decode_launches"]["paged_decode"]
                 for n, r in out["cases"].items() if n != "a_off")
    prefill = sum(r["prefill_launches"]["paged_prefill"]
                  for r in out["cases"].values())
    rows = []
    for name, C, ctx, n in (
            ("paged_prefill", SPEC_PROMPT - SPEC_PRE, SPEC_PROMPT, prefill),
            ("paged_decode", 1, SPEC_PROMPT + SPEC_GEN // 2, verify)):
        t = time_paged(torch, trng, name, S=SPEC_SEQS, C=C, ctx=ctx,
                       block_size=64, maxb=maxb, heads=(32, 32, 128),
                       bf16_max_abs=PAGED7_BF16_MAX_ABS)
        rows.append({"name": f"{name}_spec_7b", "route": "cuda",
                     "source": SOURCE, "replaces": REPLACES[name],
                     "launches": n,
                     "launches_from": "phase 27, Llama-2-7B: prefill of "
                     "the four cases" if C > 1 else "phase 27, Llama-2-7B:"
                     " decode of cases (b)-(d), the draft's steps too",
                     **t})
    del params
    torch.cuda.empty_cache()
    return out, rows


# ---------------------------------------------------------------- families

# phase 28 (a): the published config.json of EleutherAI/gpt-j-6b (28
# layers, n_embd 4096, 16 heads of 256, rotary_dim 64, vocab 50400, an
# untied lm_head with a bias), its tensors in bf16, served at GPTJ_LAYERS
# of its layers (cut for the whole script's time: it ran 825-993 s with
# phase 32)
GPTJ_6B = {"architectures": ["GPTJForCausalLM"], "model_type": "gptj",
           "vocab_size": 50400, "n_positions": 2048, "n_embd": 4096,
           "n_layer": 28, "n_head": 16, "rotary_dim": 64, "n_inner": None,
           "activation_function": "gelu_new", "layer_norm_epsilon": 1e-5,
           "rotary": True, "tie_word_embeddings": False,
           "bos_token_id": 50256, "eos_token_id": 50256,
           "torch_dtype": "bfloat16"}
GPTJ_LAYERS = 14
GPTJ_SEQS, GPTJ_PROMPT, GPTJ_GEN = 16, 256, 32
# phase 28 (b): the other families at their published widths, each cut
# to FAMILY_LAYERS layers (bigscience/bloom-7b1, EleutherAI/gpt-neox-20b,
# facebook/opt-6.7b, microsoft/phi-2 config.json; tiiuae/falcon-7b's
# served from seeded parameters: no HF name map)
FAMILY_LAYERS = 4
FAMILY_SEQS, FAMILY_PROMPT, FAMILY_GEN = 8, 256, 16
BLOOM_7B1 = {"architectures": ["BloomForCausalLM"], "model_type": "bloom",
             "vocab_size": 250880, "hidden_size": 4096, "n_layer": 30,
             "n_head": 32, "layer_norm_epsilon": 1e-5,
             "apply_residual_connection_post_layernorm": False,
             "bos_token_id": 1, "eos_token_id": 2, "pad_token_id": 3,
             "torch_dtype": "bfloat16"}
NEOX_20B = {"architectures": ["GPTNeoXForCausalLM"],
            "model_type": "gpt_neox", "vocab_size": 50432,
            "hidden_size": 6144, "intermediate_size": 24576,
            "num_hidden_layers": 44, "num_attention_heads": 64,
            "max_position_embeddings": 2048, "rotary_pct": 0.25,
            "rotary_emb_base": 10000, "layer_norm_eps": 1e-5,
            "use_parallel_residual": True, "tie_word_embeddings": False,
            "hidden_act": "gelu_fast", "bos_token_id": 0, "eos_token_id": 0,
            "torch_dtype": "bfloat16"}
OPT_6P7B = {"architectures": ["OPTForCausalLM"], "model_type": "opt",
            "vocab_size": 50272, "hidden_size": 4096, "ffn_dim": 16384,
            "num_hidden_layers": 32, "num_attention_heads": 32,
            "max_position_embeddings": 2048, "do_layer_norm_before": True,
            "word_embed_proj_dim": 4096, "activation_function": "relu",
            "bos_token_id": 2, "eos_token_id": 2, "pad_token_id": 1,
            "torch_dtype": "bfloat16"}
PHI_2 = {"architectures": ["PhiForCausalLM"], "model_type": "phi",
         "vocab_size": 51200, "hidden_size": 2560,
         "intermediate_size": 10240, "num_hidden_layers": 32,
         "num_attention_heads": 32, "num_key_value_heads": 32,
         "max_position_embeddings": 2048, "partial_rotary_factor": 0.4,
         "rope_theta": 10000.0, "layer_norm_eps": 1e-5,
         "hidden_act": "gelu_new", "qk_layernorm": False,
         "tie_word_embeddings": False, "bos_token_id": 50256,
         "eos_token_id": 50256, "torch_dtype": "bfloat16"}
FALCON_7B = {"architectures": ["FalconForCausalLM"], "model_type": "falcon",
             "vocab_size": 65024, "hidden_size": 4544,
             "num_hidden_layers": 32, "num_attention_heads": 71,
             "multi_query": True, "parallel_attn": True, "alibi": False,
             "new_decoder_architecture": False, "bias": False,
             "bos_token_id": 11, "eos_token_id": 11,
             "torch_dtype": "bfloat16"}
#: K1's route each family's bf16 prefill (256 queries, block 64) takes
FAMILY_ROUTE = {"gptj": "prefill_mma", "bloom": "prefill_wgmma_tma",
                "gpt_neox": "prefill_mma", "opt": "prefill_wgmma_tma",
                "phi": "prefill_mma", "falcon": "prefill_wgmma_tma"}
# the families' K1 / K2 rows hold bf16 within PAGED7_BF16_MAX_ABS; with
# ALiBi within twice BLOOM's first K1 reading (1.5625e-2, one ulp at
# outputs of 2-4): the nearest keys' weight puts an output at one V row's
# size, up to ~5, where a bf16 ulp is 3.125e-2; 2**-8 of the norm as all
FAMILY_ALIBI_BF16_MAX_ABS = 3.2e-2
# each family's suffix in its K1 / K2 ``kernels`` rows
FAMILY_TAG = {"bloom": "bloom_7b1_alibi", "gpt_neox": "gpt_neox_20b_d96",
              "opt": "opt_6p7b", "phi": "phi_2_d80", "falcon": "falcon_7b_g71"}


def _lin(name, dout, din, path, bias=True):
    """A torch Linear's weight ([out, in], transposed in the tree) and
    its bias as spec rows (path None: a fused tensor the loader splits)."""
    rows = [(f"{name}.weight", (dout, din), "linear",
             path and f"{path}/kernel", True)]
    if bias:
        rows.append((f"{name}.bias", (dout,), "bias",
                     path and f"{path}/bias", False))
    return rows


def _ln(name, M, path):
    return [(f"{name}.weight", (M,), "norm", f"{path}/scale", False),
            (f"{name}.bias", (M,), "bias", f"{path}/bias", False)]


def _gptj_specs(hf):
    M, V, L = hf["n_embd"], hf["vocab_size"], hf["n_layer"]
    I = hf["n_inner"] or 4 * M
    specs = [("transformer.wte.weight", (V, M), "embed", "wte/embedding",
              False)]
    for i in range(L):
        h, t = f"transformer.h.{i}", f"layer_{i}"
        specs += _ln(f"{h}.ln_1", M, f"{t}/ln_1")
        for x in ("q", "k", "v", "out"):
            specs += _lin(f"{h}.attn.{x}_proj", M, M, f"{t}/{x}_proj",
                          bias=False)
        specs += _lin(f"{h}.mlp.fc_in", I, M, f"{t}/fc_in")
        specs += _lin(f"{h}.mlp.fc_out", M, I, f"{t}/fc_out")
    specs += _ln("transformer.ln_f", M, "ln_f")
    specs += _lin("lm_head", V, M, "lm_head")
    return specs


def _bloom_specs(hf):
    M, V = hf["hidden_size"], hf["vocab_size"]
    specs = [("transformer.word_embeddings.weight", (V, M), "embed",
              "word_embeddings/embedding", False)]
    specs += _ln("transformer.word_embeddings_layernorm", M,
                 "word_embeddings_layernorm")
    for i in range(hf["n_layer"]):
        h, t = f"transformer.h.{i}", f"layer_{i}"
        specs += _ln(f"{h}.input_layernorm", M, f"{t}/input_layernorm")
        specs += _lin(f"{h}.self_attention.query_key_value", 3 * M, M, None)
        specs += _lin(f"{h}.self_attention.dense", M, M,
                      f"{t}/self_attention/dense")
        specs += _ln(f"{h}.post_attention_layernorm", M,
                     f"{t}/post_attention_layernorm")
        specs += _lin(f"{h}.mlp.dense_h_to_4h", 4 * M, M,
                      f"{t}/dense_h_to_4h")
        specs += _lin(f"{h}.mlp.dense_4h_to_h", M, 4 * M,
                      f"{t}/dense_4h_to_h")
    return specs + _ln("transformer.ln_f", M, "ln_f")


def _neox_specs(hf):
    M, V, I = hf["hidden_size"], hf["vocab_size"], hf["intermediate_size"]
    specs = [("gpt_neox.embed_in.weight", (V, M), "embed",
              "embed_in/embedding", False)]
    for i in range(hf["num_hidden_layers"]):
        h, t = f"gpt_neox.layers.{i}", f"layer_{i}"
        specs += _ln(f"{h}.input_layernorm", M, f"{t}/input_layernorm")
        specs += _ln(f"{h}.post_attention_layernorm", M,
                     f"{t}/post_attention_layernorm")
        specs += _lin(f"{h}.attention.query_key_value", 3 * M, M, None)
        specs += _lin(f"{h}.attention.dense", M, M, f"{t}/dense")
        specs += _lin(f"{h}.mlp.dense_h_to_4h", I, M, f"{t}/dense_h_to_4h")
        specs += _lin(f"{h}.mlp.dense_4h_to_h", M, I, f"{t}/dense_4h_to_h")
    specs += _ln("gpt_neox.final_layer_norm", M, "final_layer_norm")
    return specs + _lin("embed_out", V, M, "embed_out", bias=False)


def _opt_specs(hf):
    M, V, F = hf["hidden_size"], hf["vocab_size"], hf["ffn_dim"]
    P = hf["max_position_embeddings"] + 2
    d = "model.decoder"
    specs = [(f"{d}.embed_tokens.weight", (V, M), "embed",
              "embed_tokens/embedding", False),
             (f"{d}.embed_positions.weight", (P, M), "gpt2_embed",
              "embed_positions/embedding", False)]
    for i in range(hf["num_hidden_layers"]):
        h, t = f"{d}.layers.{i}", f"layer_{i}"
        for x in ("q", "k", "v", "out"):
            specs += _lin(f"{h}.self_attn.{x}_proj", M, M,
                          f"{t}/self_attn/{x}_proj")
        specs += _ln(f"{h}.self_attn_layer_norm", M,
                     f"{t}/self_attn_layer_norm")
        specs += _lin(f"{h}.fc1", F, M, f"{t}/fc1")
        specs += _lin(f"{h}.fc2", M, F, f"{t}/fc2")
        specs += _ln(f"{h}.final_layer_norm", M, f"{t}/final_layer_norm")
    return specs + _ln(f"{d}.final_layer_norm", M, "final_layer_norm")


def _phi_specs(hf):
    M, V, I = hf["hidden_size"], hf["vocab_size"], hf["intermediate_size"]
    specs = [("model.embed_tokens.weight", (V, M), "embed",
              "embed_tokens/embedding", False)]
    for i in range(hf["num_hidden_layers"]):
        h, t = f"model.layers.{i}", f"layer_{i}"
        specs += _ln(f"{h}.input_layernorm", M, f"{t}/input_layernorm")
        for x in ("q", "k", "v"):
            specs += _lin(f"{h}.self_attn.{x}_proj", M, M,
                          f"{t}/self_attn/{x}_proj")
        specs += _lin(f"{h}.self_attn.dense", M, M, f"{t}/self_attn/dense")
        specs += _lin(f"{h}.mlp.fc1", I, M, f"{t}/fc1")
        specs += _lin(f"{h}.mlp.fc2", M, I, f"{t}/fc2")
    specs += _ln("model.final_layernorm", M, "final_layernorm")
    return specs + _lin("lm_head", V, M, "lm_head")


def paged_rows(torch):
    """``--paged-rows``: K1 and K2 timed (against their plain versions
    too) at PAGED_ROWS's shapes. Returns name -> reading."""
    import numpy as np
    from deepspeed_tpu_torch.ops.kernels import _build
    t0 = time.perf_counter()
    _build.build(["paged_attention"])
    log(f"[build] paged_attention {time.perf_counter() - t0:.1f} s")
    lin = dict(block_size=WOQ_PROMPT + WOQ_GEN, maxb=1)
    dec7 = dict(S=WOQ_SEQS, C=1, ctx=WOQ_PROMPT + WOQ_GEN // 2,
                heads=(H7, KV7, D7), **lin)
    pre7 = dict(S=WOQ_SEQS, C=WOQ_CHUNK, ctx=WOQ_PROMPT,
                heads=(H7, KV7, D7), **lin)
    fam = dict(S=FAMILY_SEQS, C=FAMILY_PROMPT, ctx=FAMILY_PROMPT,
               block_size=64, maxb=-(-(FAMILY_PROMPT + FAMILY_GEN) // 64))
    rows = (("paged_prefill_int8", "paged_prefill", dict(pre7, quant=True)),
            ("paged_decode_int8", "paged_decode", dict(dec7, quant=True)),
            ("paged_decode_ring", "paged_decode", dict(dec7, quant=True,
                                                       ring=16)),
            ("paged_decode_bf16_7b", "paged_decode", dec7),
            ("paged_prefill", "paged_prefill",
             dict(S=16, C=256, ctx=512, block_size=64, maxb=8,
                  heads=(H, KV, D))),
            ("paged_decode", "paged_decode",
             dict(S=16, C=1, ctx=544, block_size=64, maxb=9,
                  heads=(H, KV, D))),
            ("paged_prefill_int8_qwen2", "paged_prefill",
             dict(S=8, C=256, ctx=1256, block_size=64, maxb=20,
                  heads=(28, 4, 128), quant=True)),
            ("paged_prefill_phi_2_d80", "paged_prefill",
             dict(fam, heads=(32, 32, 80))),
            ("paged_prefill_gpt_neox_20b_d96", "paged_prefill",
             dict(fam, heads=(64, 64, 96))))
    rng = np.random.default_rng(17)
    out = {}
    for name, fn, kw in rows:
        t = time_paged(torch, rng, fn, bf16_max_abs=PAGED7_BF16_MAX_ABS,
                       **kw)
        out[name] = {k: t[k] for k in ("ms", "graph_ms", "plain_ms",
                                       "library_ms", "bound_ms",
                                       "max_abs_err", "shape")}
        out[name]["route"] = t.get("kernel_route", "decode_split")
        torch.cuda.empty_cache()
    return out


def _family_gen(torch, pa, eng, prompts, gen, L, route, alibi=False,
                sampling=None, seed=28):
    """One ``generate`` of ``prompts`` with the launch counts zeroed just
    before and read just after: each kernel launched L times a step of
    its kind, K1 on ``route``, ALiBi on every launch or none. Returns
    (streams, record)."""
    e = eng
    e.timing.update({k: 0 if isinstance(v, int) else 0.0
                     for k, v in e.timing.items()})
    e.runner.step_counts = {"prefill": 0, "decode": 0}
    pa.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streams = e.generate(prompts, max_new_tokens=gen, sampling=sampling,
                         seed=seed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = dict(e.runner.step_counts)
    launches = {**pa.LAUNCHES, **pa.ROUTE_LAUNCHES}
    f32 = e.runner.compute_dtype == torch.float32
    want = {"paged_prefill": L * steps["prefill"],
            ("prefill_f32" if f32 else route): L * steps["prefill"],
            "paged_decode": L * steps["decode"],
            ("decode_f32" if f32 else "decode_split"): L * steps["decode"],
            "alibi": L * (steps["prefill"] + steps["decode"]) * alibi}
    bad = {k: (launches[k], v) for k, v in want.items() if launches[k] != v}
    if bad or not (steps["prefill"] and steps["decode"]):
        raise AssertionError(f"[family] launches {bad}, steps {steps}")
    if any(len(o) != gen for o in streams) or \
            e.free_blocks != e.config.num_blocks:
        raise AssertionError("[family] stream lengths or blocks")
    tm = e.timing
    return streams, {
        "steps": steps, "launches": {k: launches[k] for k in want},
        "prefill_s": tm["prefill_s"], "decode_s": tm["decode_s"],
        "decode_tokens": tm["decode_tokens"],
        "decode_tok_s": tm["decode_tokens"] / tm["decode_s"],
        "wall_s": wall}


def _family_cfg(seqs, prompt, gen, **kw):
    from deepspeed_tpu_torch.inference.v2 import RaggedInferenceConfig
    maxb = -(-(prompt + gen) // 64)
    base = dict(max_seqs=seqs, chunk_size=256, block_size=64,
                num_blocks=seqs * maxb + 8, max_blocks_per_seq=maxb,
                dtype="bfloat16", attention_impl="paged_flash",
                decode_loop_steps=0, serve_pipeline_depth=0)
    base.update(kw)
    return RaggedInferenceConfig(**base)


def _gptj_whole(torch, pa, out):
    """Phase 28 (a): GPT-J-6B at GPTJ_LAYERS of its layers through
    build_hf_engine, depth 0, depth 2 and the decode loop, greedy and
    sampled."""
    import shutil
    import tempfile

    import numpy as np
    from deepspeed_tpu_torch.inference.quantization import woq_memory_bytes
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  SamplingParams,
                                                  build_hf_engine)
    from deepspeed_tpu_torch.inference.v2.bloom_gptj_neox_runner import \
        GPTJRaggedRunner
    hf, L = {**GPTJ_6B, "n_layer": GPTJ_LAYERS}, GPTJ_LAYERS
    specs = _gptj_specs(hf)
    rec = out["gptj_6b"] = {"model": "EleutherAI/gpt-j-6b"}
    tmp = Path(tempfile.mkdtemp(prefix="gptj6b_"))
    torch.cuda.reset_peak_memory_stats()
    # what earlier phases left allocated; the peak is read against it
    rec["start_bytes"] = torch.cuda.memory_allocated()
    try:
        t0 = time.perf_counter()
        nbytes, nshards = write_hf_checkpoint(torch, tmp, hf, seed=28,
                                              specs=specs)
        rec["write_s"] = time.perf_counter() - t0
        rec["checkpoint_bytes"], rec["shards"] = nbytes, nshards

        def rcfg(**kw):
            return _family_cfg(GPTJ_SEQS, GPTJ_PROMPT, GPTJ_GEN, **kw)

        t0 = time.perf_counter()
        eng0 = build_hf_engine(str(tmp), engine_config=rcfg(),
                               dtype="bfloat16")
        torch.cuda.synchronize()
        rec["load_s"] = time.perf_counter() - t0
        rec["param_bytes"] = woq_memory_bytes(eng0.params)
        rec["leaves_bit_identical"] = _check_written(
            torch, eng0.params, hf, seed=28, specs=specs)
        cfg, params = eng0.model_cfg, eng0.params
        heads = (hf["n_head"], hf["n_head"], hf["n_embd"] // hf["n_head"])
        if not isinstance(eng0.runner, GPTJRaggedRunner) or \
                (eng0.runner.kv_heads, eng0.runner.head_dim) != heads[1:]:
            raise AssertionError(f"[gptj] runner {eng0.runner}")
        log(f"[gptj] {rec['model']}: wrote {nbytes / 1e9:.3f} GB in "
            f"{nshards} shards in {rec['write_s']:.1f} s; build_hf_engine "
            f"{rec['load_s']:.1f} s, parameters "
            f"{rec['param_bytes'] / 1e9:.3f} GB, "
            f"{rec['leaves_bit_identical']} leaves bit-identical")
        engs = {"depth0": eng0,
                "depth2": InferenceEngineV2(cfg, params, rcfg(
                    serve_pipeline_depth=2), device="cuda"),
                "loop": InferenceEngineV2(cfg, params, rcfg(
                    serve_pipeline_depth=2, decode_loop_steps=16),
                    device="cuda")}
        rng = np.random.default_rng(28)
        prompts = rng.integers(0, cfg.vocab_size,
                               (GPTJ_SEQS, GPTJ_PROMPT)).tolist()
        for e in engs.values():              # warm-up
            e.generate([prompts[0][:80]], max_new_tokens=20)
        sp = SamplingParams(**HF_SAMPLING)
        runs, gens = {}, {}
        for mode in ("greedy", "sampled"):
            for name, e in engs.items():
                gens[mode, name], r = _family_gen(
                    torch, pa, e, prompts, GPTJ_GEN, L, "prefill_mma",
                    sampling=sp if mode == "sampled" else None)
                runs[f"{mode}_{name}"] = r
                log(f"[gptj] {mode} {name}: prefill {r['prefill_s']:.4f} "
                    f"s, decode {r['decode_tokens']} tokens in "
                    f"{r['decode_s']:.4f} s = {r['decode_tok_s']:.1f} "
                    f"tok/s; steps {r['steps']}; launches {r['launches']}")
            if not gens[mode, "depth0"] == gens[mode, "depth2"] \
                    == gens[mode, "loop"]:
                raise AssertionError(f"[gptj] {mode} streams differ "
                                     f"between depth 0, depth 2, the loop")
        if gens["greedy", "depth0"] == gens["sampled", "depth0"]:
            raise AssertionError("[gptj] sampling gave the greedy streams")
        rec["runs"] = runs
        rec["peak_bytes"] = torch.cuda.max_memory_allocated()
        log(f"[gptj] greedy and sampled streams identical at depths 0 and "
            f"2 and through the loop; peak memory "
            f"{rec['peak_bytes'] / 2**30:.2f} GiB, "
            f"{(rec['peak_bytes'] - rec['start_bytes']) / 2**30:.2f} GiB "
            f"over the {rec['start_bytes'] / 2**30:.2f} GiB allocated at "
            f"the phase's start")
        del engs, e, eng0, params
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # K1 on the 16 x 256 prefill step, K2 mid-decode, at 16 heads of 256
    trng = np.random.default_rng(280)
    maxb = -(-(GPTJ_PROMPT + GPTJ_GEN) // 64)
    main = runs["greedy_depth2"]
    rows = []
    for name, C, ctx in (("paged_prefill", 256, GPTJ_PROMPT),
                         ("paged_decode", 1, GPTJ_PROMPT + GPTJ_GEN // 2)):
        t = time_paged(torch, trng, name, S=GPTJ_SEQS, C=C, ctx=ctx,
                       block_size=64, maxb=maxb, heads=heads,
                       bf16_max_abs=PAGED7_BF16_MAX_ABS)
        rows.append({"name": f"{name}_gptj_6b_d256", "route": "cuda",
                     "source": SOURCE, "replaces": REPLACES[name],
                     "launches": main["launches"][name],
                     "launches_from": "phase 28, EleutherAI/gpt-j-6b "
                                      "greedy at depth 2", **t})
    torch.cuda.empty_cache()
    return rows


def _family_one(torch, pa, qz, fam, hf, specs, tmp):
    """Phase 28 (b), one family at FAMILY_LAYERS layers: the fp32 kernel
    path's greedy streams against the dense path's (exactly), bf16 at
    depths 0 and 2 (identical), BLOOM also under wf8; then K1 and K2 at
    the family's heads and step shapes against their plain versions.
    Returns (record, kernels rows)."""
    import dataclasses

    import numpy as np
    from deepspeed_tpu_torch.checkpoint import init_family_params
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  build_hf_engine)
    from deepspeed_tpu_torch.models.registry import config_from_hf
    L = FAMILY_LAYERS
    alibi = fam == "bloom"
    rec = {"layers": L}

    def rcfg(**kw):
        return _family_cfg(FAMILY_SEQS, FAMILY_PROMPT, FAMILY_GEN, **kw)

    t0 = time.perf_counter()
    if specs is None:                      # Falcon: seeded parameters
        _, cfg = config_from_hf(hf)
        params = init_family_params(cfg, seed=28, device="cuda",
                                    dtype=torch.bfloat16)
        eng0 = InferenceEngineV2(cfg, params, rcfg(), device="cuda")
    else:
        nbytes, _ = write_hf_checkpoint(torch, tmp, hf, seed=28,
                                        specs=specs)
        rec["checkpoint_bytes"] = nbytes
        eng0 = build_hf_engine(str(tmp), engine_config=rcfg(),
                               dtype="bfloat16")
        cfg, params = eng0.model_cfg, eng0.params
    torch.cuda.synchronize()
    rec["setup_s"] = time.perf_counter() - t0
    rec["heads"] = [cfg.num_heads, eng0.runner.kv_heads,
                    eng0.runner.head_dim]
    rng = np.random.default_rng(281)
    prompts = rng.integers(0, cfg.vocab_size,
                           (FAMILY_SEQS, FAMILY_PROMPT)).tolist()
    route = FAMILY_ROUTE[fam]
    # fp32 with TF32 off: the kernels' streams are the dense path's
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        c32 = dataclasses.replace(cfg, dtype=torch.float32)
        got = {}
        for impl in ("paged_flash", "dense"):
            e = InferenceEngineV2(c32, params, rcfg(
                dtype="float32", attention_impl=impl), device="cuda")
            if impl == "dense":
                got[impl] = e.generate(prompts, max_new_tokens=FAMILY_GEN)
            else:
                got[impl], rec["fp32_kernels"] = _family_gen(
                    torch, pa, e, prompts, FAMILY_GEN, L, route, alibi)
            del e
            torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    if got["paged_flash"] != got["dense"]:
        raise AssertionError(f"[family] {fam}: fp32 kernel streams differ "
                             f"from the dense path's")
    runs, gens = {}, {}
    for name, e in (("depth0", eng0),
                    ("depth2", InferenceEngineV2(cfg, params, rcfg(
                        serve_pipeline_depth=2), device="cuda"))):
        e.generate([prompts[0][:80]], max_new_tokens=4)       # warm-up
        gens[name], runs[name] = _family_gen(torch, pa, e, prompts,
                                             FAMILY_GEN, L, route, alibi)
    if gens["depth0"] != gens["depth2"]:
        raise AssertionError(f"[family] {fam}: bf16 streams differ "
                             f"between depth 0 and depth 2")
    rec["bf16"] = runs
    rec["routes"] = {k: v for k, v in runs["depth2"]["launches"].items()}
    log(f"[family] {fam} ({L} layers, heads {rec['heads']}): setup "
        f"{rec['setup_s']:.1f} s; fp32 "
        f"kernel streams == dense; bf16 depths 0 and 2 identical; prefill "
        f"{runs['depth2']['prefill_s']:.4f} s, decode "
        f"{runs['depth2']['decode_tok_s']:.1f} tok/s; launches "
        f"{runs['depth2']['launches']}")
    del e, eng0, params
    torch.cuda.empty_cache()
    if fam == "bloom":
        qz.reset_launch_counts()
        engq = build_hf_engine(str(tmp), engine_config=rcfg(),
                               dtype="bfloat16", quantization_mode="wf8")
        torch.cuda.synchronize()
        qlaunch = qz.LAUNCHES["quantize_sym"]
        if qlaunch != 3 * L or qz.LAUNCHES["quantize_asym"]:
            raise AssertionError(f"[family] bloom wf8 launches {qz.LAUNCHES}")
        gq, rq = _family_gen(torch, pa, engq, prompts, 4, L, route, alibi)
        rec["wf8"] = {"quantize_launches": qlaunch, **rq,
                      "first_token_agreement_with_bf16": float(np.mean(
                          [a[0] == b[0] for a, b in
                           zip(gq, gens["depth0"])]))}
        log(f"[family] bloom wf8: {qlaunch} quantize_sym launches (q/k/v "
            f"of {L} layers); first tokens agree with bf16 on "
            f"{rec['wf8']['first_token_agreement_with_bf16']:.3f}")
        del engq
        torch.cuda.empty_cache()
    # K1 on the 8 x 256 prefill step, K2 mid-decode, at this family's
    # heads (Falcon's group of 71, NeoX's D 96, Phi's D 80, BLOOM's ALiBi)
    trng = np.random.default_rng(282)
    maxb = -(-(FAMILY_PROMPT + FAMILY_GEN) // 64)
    rows = []
    for name, C, ctx in (("paged_prefill", FAMILY_PROMPT, FAMILY_PROMPT),
                         ("paged_decode", 1,
                          FAMILY_PROMPT + FAMILY_GEN // 2)):
        t = time_paged(torch, trng, name, S=FAMILY_SEQS, C=C, ctx=ctx,
                       block_size=64, maxb=maxb, heads=tuple(rec["heads"]),
                       bf16_max_abs=(FAMILY_ALIBI_BF16_MAX_ABS if alibi
                                     else PAGED7_BF16_MAX_ABS), alibi=alibi)
        rows.append({"name": f"{name}_{FAMILY_TAG[fam]}", "route": "cuda",
                     "source": SOURCE, "replaces": REPLACES[name],
                     "launches": runs["depth2"]["launches"][name],
                     "launches_from": f"phase 28, {fam} ({L} layers) bf16 "
                                      f"greedy at depth 2", **t})
        torch.cuda.empty_cache()
    return rec, rows


def phase_family_serving(torch):
    """Phase 28: the dense families of A5.4 on the card (module
    docstring). Returns (out, rows)."""
    import shutil
    import tempfile

    from deepspeed_tpu_torch.ops.kernels import paged_attention as pa
    from deepspeed_tpu_torch.ops.kernels import quantization as qz
    out = {"reduced": {"families": f"depth cut to {FAMILY_LAYERS} layers "
                                   f"(published widths kept)",
                       "gptj_6b": f"depth cut to {GPTJ_LAYERS} of 28 "
                                  f"layers (published widths kept; the "
                                  f"whole script's time)"}}
    rows = _gptj_whole(torch, pa, out)
    for fam, hf, specs_fn in (("bloom", BLOOM_7B1, _bloom_specs),
                              ("gpt_neox", NEOX_20B, _neox_specs),
                              ("opt", OPT_6P7B, _opt_specs),
                              ("phi", PHI_2, _phi_specs),
                              ("falcon", FALCON_7B, None)):
        key = "n_layer" if "n_layer" in hf else "num_hidden_layers"
        cut = {**hf, key: FAMILY_LAYERS}
        tmp = Path(tempfile.mkdtemp(prefix=f"{fam}_"))
        try:
            out[fam], fam_rows = _family_one(
                torch, pa, qz, fam, cut, specs_fn(cut) if specs_fn else None,
                tmp)
            rows += fam_rows
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return out, rows


# ------------------------------------------------------------------ phase 29
# (a) the published config.json of Qwen/Qwen1.5-MoE-A2.7B: 24 layers,
# hidden 2048, 16 heads on 16 KV heads of 128, 60 experts top-4 of width
# 1408 (full-softmax weights: norm_topk_prob false), a shared expert of
# 5632, vocab 151936; its tensors in bf16 (about 14.3 B parameters).
# Phase 29 serves it at MOE_QWEN_LAYERS of its layers (cut for the whole
# script's time: it ran 825-993 s with phase 32)
QWEN_MOE = {"architectures": ["Qwen2MoeForCausalLM"],
            "model_type": "qwen2_moe", "hidden_size": 2048,
            "intermediate_size": 5632, "moe_intermediate_size": 1408,
            "shared_expert_intermediate_size": 5632,
            "num_hidden_layers": 24, "num_attention_heads": 16,
            "num_key_value_heads": 16, "num_experts": 60,
            "num_experts_per_tok": 4, "norm_topk_prob": False,
            "decoder_sparse_step": 1, "mlp_only_layers": [],
            "vocab_size": 151936, "max_position_embeddings": 8192,
            "rope_theta": 1000000.0, "rms_norm_eps": 1e-06,
            "tie_word_embeddings": False, "hidden_act": "silu",
            "router_aux_loss_coef": 0.001, "bos_token_id": 151643,
            "eos_token_id": 151643, "torch_dtype": "bfloat16"}
# (b) the published config.json of mistralai/Mixtral-8x7B-v0.1: hidden
# 4096, 32 heads on 8 KV heads of 128, 8 experts top-2 of width 14336,
# vocab 32000; served at MOE_MIXTRAL_LAYERS of its 32 layers (the whole
# model, 93 GB in bf16, does not fit an 80 GB card)
MIXTRAL_8X7B = {"architectures": ["MixtralForCausalLM"],
                "model_type": "mixtral", "hidden_size": 4096,
                "intermediate_size": 14336, "num_hidden_layers": 32,
                "num_attention_heads": 32, "num_key_value_heads": 8,
                "num_local_experts": 8, "num_experts_per_tok": 2,
                "vocab_size": 32000, "max_position_embeddings": 32768,
                "rope_theta": 1e6, "rms_norm_eps": 1e-5,
                "sliding_window": None, "tie_word_embeddings": False,
                "hidden_act": "silu", "router_aux_loss_coef": 0.02,
                "bos_token_id": 1, "eos_token_id": 2,
                "torch_dtype": "bfloat16"}
MOE_QWEN_LAYERS = 12
MOE_MIXTRAL_LAYERS = 8
#: layers of the Mixtral checkpoint that exercises the expert stacking
MOE_MIXTRAL_HF_LAYERS = 2
MOE_SEQS, MOE_PROMPT, MOE_GEN = 16, 256, 32
#: (c): the parity engines' depth and traffic
MOE_PARITY_LAYERS = 4
MOE_PARITY_SEQS, MOE_PARITY_PROMPT, MOE_PARITY_GEN = 8, 64, 8
GROUPED_SOURCE = "deepspeed_tpu_torch/ops/kernels/csrc/grouped_gemm.cu"
#: no Pallas kernel: the JAX package's grouped products are
#: jax.lax.ragged_dot calls
GROUPED_REPLACES = ("deepspeed_tpu/moe/sharded_moe.py:230 (jax.lax."
                    "ragged_dot; no pallas_call)")
#: the grouped GEMM against an fp32 reference: bf16 within 2**-7 of the
#: reference's largest magnitude (one ulp of a bf16 output in the top
#: binade: the output's half-ulp rounding, up to 2**-8 of it, plus the
#: fp32 sums' order), against its bf16 plain twin likewise (the two
#: round fp32 sums of another order), fp32 within 1e-5 of the largest
#: magnitude (summation order)
GROUPED_BF16_REL = 2.0 ** -7
GROUPED_FP32_REL = 1e-5
MOE_TAG = {"qwen2_moe": "qwen1p5_moe", "mixtral": "mixtral_8x7b"}


def _moe_specs(hf):
    """Every tensor of a Mixtral or Qwen2-MoE checkpoint in writing order:
    (HF name, HF shape, kind, tree path, transposed in the tree); an
    expert's path ends in ``#e``, its slot in the tree's stack."""
    qwen = hf["model_type"] == "qwen2_moe"
    M, V = hf["hidden_size"], hf["vocab_size"]
    E = hf["num_experts" if qwen else "num_local_experts"]
    I = hf["moe_intermediate_size" if qwen else "intermediate_size"]
    kvd = hf["num_key_value_heads"] * M // hf["num_attention_heads"]
    specs = [("model.embed_tokens.weight", (V, M), "embed",
              "embed/embedding", False)]
    for i in range(hf["num_hidden_layers"]):
        p, t = f"model.layers.{i}", f"layer_{i}"
        specs.append((f"{p}.input_layernorm.weight", (M,), "norm",
                      f"{t}/input_norm/scale", False))
        for x, n in (("q", M), ("k", kvd), ("v", kvd)):
            specs.append((f"{p}.self_attn.{x}_proj.weight", (n, M),
                          "linear", f"{t}/attn/{x}_proj/kernel", True))
            if qwen:
                specs.append((f"{p}.self_attn.{x}_proj.bias", (n,), "bias",
                              f"{t}/attn/{x}_proj/bias", False))
        specs.append((f"{p}.self_attn.o_proj.weight", (M, M), "linear",
                      f"{t}/attn/o_proj/kernel", True))
        specs.append((f"{p}.post_attention_layernorm.weight", (M,), "norm",
                      f"{t}/post_attn_norm/scale", False))
        moe = f"{p}.mlp" if qwen else f"{p}.block_sparse_moe"
        specs.append((f"{moe}.gate.weight", (E, M), "linear",
                      f"{t}/moe/gate", True))
        names = (("gate_proj", "up_proj", "down_proj") if qwen
                 else ("w1", "w3", "w2"))
        for e in range(E):
            for hn, kind, shape in zip(names, ("wi_gate", "wi_up", "wo"),
                                       ((I, M), (I, M), (M, I))):
                specs.append((f"{moe}.experts.{e}.{hn}.weight", shape,
                              "linear", f"{t}/moe/{kind}#{e}", True))
        if qwen:
            SE = hf["shared_expert_intermediate_size"]
            for x, shape in (("gate", (SE, M)), ("up", (SE, M)),
                             ("down", (M, SE))):
                specs.append((f"{p}.mlp.shared_expert.{x}_proj.weight",
                              shape, "linear", f"{t}/shared_{x}_proj/kernel",
                              True))
            specs.append((f"{p}.mlp.shared_expert_gate.weight", (1, M),
                          "linear", f"{t}/shared_expert_gate/kernel", True))
    specs.append(("model.norm.weight", (M,), "norm", "final_norm/scale",
                  False))
    return specs + [("lm_head.weight", (V, M), "linear", "lm_head/kernel",
                     True)]


class _RssPeak:
    """The process's resident set sampled every 5 ms on a thread (from
    /proc/self/statm) while the block runs: ``peak - start`` bytes."""

    def __init__(self):
        import os
        import threading
        self.page = os.sysconf("SC_PAGE_SIZE")
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _rss(self):
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self.page

    def _run(self):
        while not self.stop.is_set():
            self.peak = max(self.peak, self._rss())
            self.stop.wait(0.005)

    def __enter__(self):
        self.start = self.peak = self._rss()
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join()
        self.peak = max(self.peak, self._rss())
        self.delta = self.peak - self.start


def _moe_gen(torch, pa, gg, eng, prompts, gen, L, route):
    """``_family_gen`` with the grouped GEMM's launches zeroed just before
    and read just after: three a layer a step (gate, up, down)."""
    gg.reset_launch_counts()
    streams, r = _family_gen(torch, pa, eng, prompts, gen, L, route)
    steps = r["steps"]["prefill"] + r["steps"]["decode"]
    r["launches"]["grouped_gemm"] = gg.LAUNCHES["grouped_gemm"]
    r["launches"]["grouped_wgmma"] = gg.LAUNCHES["grouped_wgmma"]
    r["grouped_gemm_per_step"] = gg.LAUNCHES["grouped_gemm"] / steps
    if gg.LAUNCHES["grouped_gemm"] != 3 * L * steps:
        raise AssertionError(f"[moe] grouped_gemm launches "
                             f"{gg.LAUNCHES['grouped_gemm']}, want 3 x {L} "
                             f"layers x {steps} steps")
    return streams, r


def _moe_serve(torch, pa, gg, tag, eng, L, out):
    """Phase 29's traffic on ``eng`` (depth 2): MOE_SEQS prompts of
    MOE_PROMPT tokens, MOE_GEN greedy tokens each, after a warm-up.
    Returns the run's record."""
    import numpy as np
    cfg = eng.model_cfg
    prompts = np.random.default_rng(29).integers(
        0, cfg.vocab_size, (MOE_SEQS, MOE_PROMPT)).tolist()
    eng.generate([prompts[0][:80]], max_new_tokens=4)        # warm-up
    torch.cuda.reset_peak_memory_stats()
    streams, r = _moe_gen(torch, pa, gg, eng, prompts, MOE_GEN, L,
                          "prefill_wgmma_tma")
    # prefill on the wgmma route, decode on mma.sync
    if not 0 < r["launches"]["grouped_wgmma"] < r["launches"]["grouped_gemm"]:
        raise AssertionError(f"[moe] {tag}: grouped launches by route "
                             f"{r['launches']}")
    r["peak_bytes"] = torch.cuda.max_memory_allocated()
    r["prefill_step_s"] = r["prefill_s"] / r["steps"]["prefill"]
    out["serving"] = r
    log(f"[moe] {tag}: {MOE_SEQS} x {MOE_PROMPT} prompts, {MOE_GEN} new: "
        f"prefill {r['prefill_s']:.4f} s ({r['steps']['prefill']} steps, "
        f"{r['prefill_step_s']:.4f} s a step), decode {r['decode_tokens']} "
        f"tokens in {r['decode_s']:.4f} s = {r['decode_tok_s']:.1f} tok/s; "
        f"grouped_gemm {r['grouped_gemm_per_step']:.0f} launches a step; "
        f"launches {r['launches']}; peak {r['peak_bytes'] / 2**30:.2f} GiB")
    return r


def _check_moe_written(torch, params, hf, seed):
    """``_check_written`` over ``_moe_specs``: every loaded leaf, and
    every expert slot of the stacks, equals the tensor written."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    n = 0
    for name, shape, kind, path, transposed in _moe_specs(hf):
        t = _qwen2_tensor(torch, gen, kind, shape)
        path, _, slot = path.partition("#")
        leaf = params
        for k in path.split("/"):
            leaf = leaf[k]
        if slot:
            leaf = leaf[int(slot)]
        want = t.t() if transposed else t
        if leaf.dtype != torch.bfloat16 or leaf.shape != want.shape \
                or not torch.equal(leaf.view(torch.int16),
                                   want.view(torch.int16)):
            raise AssertionError(f"[moe] loaded {path}{'#' + slot if slot else ''}"
                                 f" differs from the written {name}")
        n += 1
    return n


def _moe_from_hf(torch, hf, seed, out, check=True):
    """Write ``hf``'s random checkpoint, load it through
    ``build_hf_engine`` (depth 2) with the host's resident set sampled,
    and check every leaf against what was written. Returns the engine;
    the directory is removed."""
    import tempfile

    from deepspeed_tpu_torch.inference.quantization import woq_memory_bytes
    from deepspeed_tpu_torch.inference.v2 import build_hf_engine
    specs = _moe_specs(hf)
    need = 2 * sum(math.prod(s[1]) for s in specs)
    tmp = Path(tempfile.mkdtemp(prefix=f"{hf['model_type']}_"))
    try:
        free = shutil.disk_usage(tmp).free
        log(f"[moe] {tmp}: {free / 1e9:.1f} GB free, the shards need "
            f"{need / 1e9:.2f} GB")
        if free < need * 1.05:
            raise AssertionError(f"[moe] {free / 1e9:.1f} GB free under "
                                 f"{tmp}; {need / 1e9:.2f} GB needed")
        t0 = time.perf_counter()
        nbytes, nshards = write_hf_checkpoint(torch, tmp, hf, seed=seed,
                                              specs=specs)
        out["write_s"] = time.perf_counter() - t0
        out["checkpoint_bytes"], out["shards"] = nbytes, nshards
        maxb = -(-(MOE_PROMPT + MOE_GEN) // 64)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _RssPeak() as rss:
            eng = build_hf_engine(str(tmp), engine_config=_family_cfg(
                MOE_SEQS, MOE_PROMPT, MOE_GEN, serve_pipeline_depth=2),
                dtype="bfloat16")
            torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        out["host_rss_peak_bytes"] = rss.peak
        out["host_rss_load_delta_bytes"] = rss.delta
        out["param_bytes"] = woq_memory_bytes(eng.params)
        if check:
            out["leaves_bit_identical"] = _check_moe_written(
                torch, eng.params, hf, seed)
        log(f"[moe] {hf['model_type']} ({hf['num_hidden_layers']} layers): "
            f"wrote {nbytes / 1e9:.3f} GB in {nshards} shards in "
            f"{out['write_s']:.1f} s; build_hf_engine {out['load_s']:.1f} s "
            f"(blocks of {maxb} x 64), parameters "
            f"{out['param_bytes'] / 1e9:.3f} GB; host resident set "
            f"{rss.start / 2**30:.2f} -> peak {rss.peak / 2**30:.2f} GiB "
            f"during the load (+{rss.delta / 2**30:.3f} GiB); "
            f"{out.get('leaves_bit_identical')} tensors bit-identical")
        return eng
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _moe_parity(torch, pa, gg, qz, mcfg, fam, out):
    """Phase 29 (c) for one family: MOE_PARITY_LAYERS layers in fp32 (TF32
    off) from a seed, the kernel route's greedy streams against the plain
    grouped route's (``ragged_dot_plain`` in the engine's place); for
    Qwen-MoE a bf16 engine under the factory's wf8 lists, and one
    ``_moe_mlp`` call at decode and one at prefill under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    import numpy as np
    from deepspeed_tpu_torch.checkpoint import init_family_params
    from deepspeed_tpu_torch.inference.quantization import \
        quantize_model_params
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.inference.v2 import engine_factory as ef
    from deepspeed_tpu_torch.inference.v2 import llama_runner as lr
    from deepspeed_tpu_torch.moe import sharded_moe
    L = MOE_PARITY_LAYERS
    rec = out.setdefault("parity", {})
    prompts = np.random.default_rng(291).integers(
        0, mcfg.vocab_size, (MOE_PARITY_SEQS, MOE_PARITY_PROMPT)).tolist()

    def rcfg(**kw):
        return _family_cfg(MOE_PARITY_SEQS, MOE_PARITY_PROMPT,
                           MOE_PARITY_GEN, **kw)

    c32 = dataclasses.replace(mcfg, num_layers=L, dtype=torch.float32)
    params = init_family_params(c32, seed=292, device="cuda",
                                dtype=torch.float32)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    kernel = sharded_moe.ragged_dot
    got = {}
    try:
        for route in ("kernel", "plain"):
            sharded_moe.ragged_dot = kernel if route == "kernel" \
                else gg.ragged_dot_plain
            e = InferenceEngineV2(c32, params, rcfg(dtype="float32"),
                                  device="cuda")
            gg.reset_launch_counts()
            got[route] = e.generate(prompts, max_new_tokens=MOE_PARITY_GEN)
            n = gg.LAUNCHES["grouped_gemm"]
            if (n > 0) != (route == "kernel"):
                raise AssertionError(f"[moe] {fam} fp32 {route} route: "
                                     f"{n} grouped_gemm launches")
            del e
    finally:
        sharded_moe.ragged_dot = kernel
        torch.backends.cuda.matmul.allow_tf32 = tf32
    del params
    torch.cuda.empty_cache()
    if got["kernel"] != got["plain"]:
        raise AssertionError(f"[moe] {fam}: fp32 streams differ between "
                             f"the kernel and the plain grouped route")
    rec[fam] = {"layers": L, "fp32_kernel_equals_plain": True}
    log(f"[moe] {fam} at {L} layers, fp32: the grouped kernel's greedy "
        f"streams equal the plain grouped route's ({MOE_PARITY_SEQS} x "
        f"{MOE_PARITY_PROMPT} prompts, {MOE_PARITY_GEN} new)")
    if fam != "qwen2_moe":
        return
    c16 = dataclasses.replace(c32, dtype=torch.bfloat16)
    params = init_family_params(c16, seed=293, device="cuda",
                                dtype=torch.bfloat16)
    # the MoE layer waits for nothing on the host
    p0 = params["layer_0"]["moe"]
    sync = {}
    for kind, C in (("decode", 1), ("prefill", MOE_PROMPT)):
        h = torch.randn(MOE_SEQS, C, c16.hidden_size, device="cuda",
                        dtype=torch.bfloat16)
        gg.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y = lr._moe_mlp(p0, h, c16, torch.bfloat16)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        if y.shape != h.shape or not torch.isfinite(y).all() \
                or gg.LAUNCHES["grouped_gemm"] != 3:
            raise AssertionError(f"[moe] _moe_mlp under sync debug: "
                                 f"{tuple(y.shape)}, launches {gg.LAUNCHES}")
        sync[kind] = MOE_SEQS * C
    rec["sync_free_moe_mlp_rows"] = sync
    log(f"[moe] _moe_mlp ran under set_sync_debug_mode('error') at "
        f"{sync} tokens: no host sync, 3 grouped_gemm launches each")
    eng = InferenceEngineV2(c16, params, rcfg(), device="cuda")
    want = eng.generate(prompts, max_new_tokens=4)
    del eng
    qz.reset_launch_counts()
    qparams = quantize_model_params(params, {"quantized_weights": {
        "enabled": True, "num_bits": 8, "modules": ef.WOQ_MODULES,
        "excluded_modules": ef.WOQ_EXCLUDED}})
    torch.cuda.synchronize()
    qn = qz.LAUNCHES["quantize_sym"]
    if qn != 7 * L:                    # q/k/v/o and the shared expert's 3
        raise AssertionError(f"[moe] wf8 quantizer launches {qz.LAUNCHES}")
    engq = InferenceEngineV2(c16, qparams, rcfg(), device="cuda")
    gq, rq = _moe_gen(torch, pa, gg, engq, prompts, 4, L,
                      "prefill_wgmma_tma")
    agree = float(np.mean([a[0] == b[0] for a, b in zip(gq, want)]))
    rec["wf8"] = {"layers": L, "quantize_launches": qn, **rq,
                  "first_token_agreement_with_bf16": agree}
    log(f"[moe] qwen2_moe wf8 at {L} layers: {qn} quantize_sym launches "
        f"(attention and the shared expert); first tokens agree with bf16 "
        f"on {agree:.3f}; launches {rq['launches']}")
    del engq, qparams, params
    torch.cuda.empty_cache()


def time_grouped(torch, gg, name, *, tokens, k, E, K, N, dead=0,
                 dtype=None):
    """The grouped GEMM alone at one shape: ``tokens`` tokens routed top-k
    over E experts by random logits (the last ``dead`` experts never
    picked), x [tokens * k, K] and w [E, K, N] random. Checks it against
    an fp32 reference and its plain twin, bit-identical call to call;
    times it by CUDA events and in a CUDA graph beside its plain twin and
    the library yardstick (``torch._grouped_mm`` where this torch has it,
    else a per-expert ``torch.matmul`` loop in a graph; timed only)."""
    from deepspeed_tpu_torch.moe import sharded_moe
    dtype = dtype or torch.bfloat16
    gen = torch.Generator(device="cuda")
    gen.manual_seed(sum(map(ord, name)))
    logits = torch.randn(tokens, E, generator=gen, device="cuda")
    if dead:
        logits[:, E - dead:] = -1e4
    top = torch.topk(logits, k, dim=-1).indices.reshape(-1)
    off = sharded_moe.group_offsets(top, E)
    R = tokens * k
    x = torch.randn(R, K, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(E, K, N, generator=gen, device="cuda")
         * K ** -0.5).to(dtype)
    sizes = (off[1:] - off[:-1]).tolist()
    live = sum(1 for s in sizes if s)
    from deepspeed_tpu_torch.utils.device import sm_count
    plan = gg.grouped_plan(R, E, N, dtype, sm_count(x.device))
    gg.reset_launch_counts()
    got = gg.ragged_dot(x, w, off)
    again = gg.ragged_dot(x, w, off)
    torch.cuda.synchronize()
    if gg.LAUNCHES["grouped_wgmma"] != (2 if plan.route == "wgmma" else 0):
        raise AssertionError(f"[grouped] {name}: route {plan.route}, "
                             f"launches {gg.LAUNCHES}")
    ref = gg.ragged_dot_plain(x.float(), w.float(), off)
    twin = gg.ragged_dot_plain(x, w, off)
    top_mag = ref.abs().max().item()
    err = (got.float() - ref).abs().max().item()
    twin_err = (got.float() - twin.float()).abs().max().item()
    f32 = dtype == torch.float32
    lim = (GROUPED_FP32_REL if f32 else GROUPED_BF16_REL) * top_mag
    what = (f"{name}: R={R} ({tokens} tokens x top-{k}) over E={E} "
            f"({live} routed), K={K} -> N={N} {str(dtype)[6:]}, route "
            f"{plan.route}, tile {plan.bm} x {plan.bn}, {plan.tiles} "
            f"row-tile slots, grid {plan.grid}")
    log(f"[grouped] {what}: max_abs_err {err:.3e} against fp32 (limit "
        f"{lim:.3e}), {twin_err:.3e} against the plain twin; rows an "
        f"expert {min(sizes)}-{max(sizes)}")
    if not err <= lim or (not f32 and twin_err > GROUPED_BF16_REL * top_mag):
        raise AssertionError(f"[grouped] {what} disagrees: {err}, "
                             f"{twin_err}")
    if not torch.equal(got, again):
        raise AssertionError(f"[grouped] {what}: two calls differ")
    del ref, twin, again
    fn = lambda: gg.ragged_dot(x, w, off)                   # noqa: E731
    ms = _time_ms(torch, fn, 20)
    graph_ms = _graph_ms(torch, [fn])
    # the host's time a call (wrapper, plan, tensor maps, launch), the
    # calls queued behind one another without a wait
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        fn()
    host_us = (time.perf_counter() - t0) / 50 * 1e6
    torch.cuda.synchronize()
    plain_ms = _time_ms(torch, lambda: gg.ragged_dot_plain(x, w, off), 3)
    lib, lib_name = None, "torch._grouped_mm"
    if hasattr(torch, "_grouped_mm") and not f32:
        ends = off[1:].contiguous()
        try:
            y = torch._grouped_mm(x, w, offs=ends)
            if (y.float() - got.float()).abs().max().item() \
                    > GROUPED_BF16_REL * top_mag:
                raise RuntimeError("disagrees with the kernel")
            lib = lambda: torch._grouped_mm(x, w, offs=ends)  # noqa: E731
        except RuntimeError as exc:
            log(f"[grouped] torch._grouped_mm refused: {exc}")
    if lib is None:
        lib_name = "per-expert torch.matmul loop"
        cuts = off.tolist()

        def lib():
            for e in range(E):
                if cuts[e + 1] > cuts[e]:
                    torch.matmul(x[cuts[e]:cuts[e + 1]], w[e])
    lib_ms = _time_ms(torch, lib, 20)
    lib_graph_ms = _graph_ms(torch, [lib])
    el = x.element_size()
    nbytes = R * K * el + live * K * N * el + R * N * el + 4 * (E + 1)
    flops = 2 * R * K * N
    bound_ms, by = _bound(nbytes, flops, F32_FLOPS_PER_S if f32
                          else BF16_FLOPS_PER_S)
    out = {"grouped_route": plan.route, "host_us": host_us,
           "ms": ms, "graph_ms": graph_ms, "plain_ms": plain_ms,
           "library_ms": lib_ms, "library_graph_ms": lib_graph_ms,
           "library": lib_name, "bound_ms": bound_ms, "bound_by": by,
           "max_abs_err": err, "twin_max_abs_err": twin_err,
           "bytes": nbytes, "flops": flops,
           "bound_share": bound_ms / ms, "graph_bound_share":
               bound_ms / graph_ms,
           "shape": {"R": R, "tokens": tokens, "k": k, "E": E,
                     "routed": live, "K": K, "N": N,
                     "dtype": str(dtype)[6:], "row_tile": plan.bm,
                     "col_tile": plan.bn, "grid": plan.grid,
                     "row_tile_slots": plan.tiles,
                     "rows_min": min(sizes), "rows_max": max(sizes)}}
    log(f"[grouped] {name} ({plan.route}): {ms:.4f} ms (graph "
        f"{graph_ms:.4f}; plain {plain_ms:.4f}; {lib_name} {lib_ms:.4f}, "
        f"graph {lib_graph_ms:.4f}); bound {bound_ms:.4f} by {by}, "
        f"{out['graph_bound_share']:.1%} of it in the graph; host "
        f"{host_us:.1f} us a call")
    return out


def phase_moe_serving(torch):
    """Phase 29: the MoE families on the card (module docstring). Returns
    (out, rows)."""
    import numpy as np
    from deepspeed_tpu_torch.checkpoint import init_family_params
    from deepspeed_tpu_torch.inference.quantization import woq_memory_bytes
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.inference.v2.llama_runner import \
        LlamaRaggedRunner
    from deepspeed_tpu_torch.models.mixtral import MixtralConfig
    from deepspeed_tpu_torch.ops.kernels import grouped_gemm as gg
    from deepspeed_tpu_torch.ops.kernels import paged_attention as pa
    from deepspeed_tpu_torch.ops.kernels import quantization as qz
    out = {"reduced": {
        "qwen1p5_moe": f"depth cut to {MOE_QWEN_LAYERS} of 24 layers "
                       f"(published widths kept; the whole script's "
                       f"time)",
        "mixtral_8x7b": f"depth cut to {MOE_MIXTRAL_LAYERS} of 32 layers "
                        f"(93 GB in bf16 uncut; published widths kept); "
                        f"its HF checkpoint at {MOE_MIXTRAL_HF_LAYERS}",
        "parity": f"{MOE_PARITY_LAYERS} layers"}}
    rows = []
    serve = {}
    # (a) Qwen1.5-MoE-A2.7B at MOE_QWEN_LAYERS layers through
    # build_hf_engine
    rec = out["qwen1p5_moe"] = {"model": "Qwen/Qwen1.5-MoE-A2.7B",
                                "layers": MOE_QWEN_LAYERS}
    torch.cuda.empty_cache()
    qwen = {**QWEN_MOE, "num_hidden_layers": MOE_QWEN_LAYERS}
    eng = _moe_from_hf(torch, qwen, 29, rec)
    qcfg = eng.model_cfg
    if not isinstance(qcfg, MixtralConfig) or \
            not isinstance(eng.runner, LlamaRaggedRunner) or \
            (qcfg.num_experts, qcfg.experts_top_k, qcfg.norm_topk_prob,
             qcfg.shared_expert_size) != tuple(QWEN_MOE[k] for k in (
                "num_experts", "num_experts_per_tok", "norm_topk_prob",
                "shared_expert_intermediate_size")):
        raise AssertionError(f"[moe] qwen config {qcfg}")
    serve["qwen2_moe"] = _moe_serve(torch, pa, gg, "qwen1p5_moe", eng,
                                    MOE_QWEN_LAYERS, rec)
    del eng
    torch.cuda.empty_cache()
    # (b) Mixtral-8x7B at its widths: seeded parameters on the card, and
    # a small HF checkpoint for the expert stacking at full width
    rec = out["mixtral_8x7b"] = {"model": "mistralai/Mixtral-8x7B-v0.1",
                                 "layers": MOE_MIXTRAL_LAYERS}
    mcfg = MixtralConfig.mixtral_8x7b(num_layers=MOE_MIXTRAL_LAYERS)
    t0 = time.perf_counter()
    params = init_family_params(mcfg, seed=294, device="cuda",
                                dtype=torch.bfloat16)
    torch.cuda.synchronize()
    rec["init_s"] = time.perf_counter() - t0
    rec["param_bytes"] = woq_memory_bytes(params)
    log(f"[moe] mixtral_8x7b at {MOE_MIXTRAL_LAYERS} layers: "
        f"{rec['param_bytes'] / 1e9:.3f} GB of seeded parameters in "
        f"{rec['init_s']:.1f} s")
    eng = InferenceEngineV2(mcfg, params, _family_cfg(
        MOE_SEQS, MOE_PROMPT, MOE_GEN, serve_pipeline_depth=2),
        device="cuda")
    serve["mixtral"] = _moe_serve(torch, pa, gg, "mixtral_8x7b", eng,
                                  MOE_MIXTRAL_LAYERS, rec)
    del eng, params
    torch.cuda.empty_cache()
    hf2 = {**MIXTRAL_8X7B, "num_hidden_layers": MOE_MIXTRAL_HF_LAYERS}
    rec["hf"] = {"layers": MOE_MIXTRAL_HF_LAYERS}
    eng = _moe_from_hf(torch, hf2, 295, rec["hf"])
    prompts = np.random.default_rng(296).integers(
        0, hf2["vocab_size"], (4, 64)).tolist()
    streams = eng.generate(prompts, max_new_tokens=8)
    if [len(s) for s in streams] != [8] * 4:
        raise AssertionError("[moe] mixtral HF streams")
    del eng
    torch.cuda.empty_cache()
    # (c) parity on the card
    _moe_parity(torch, pa, gg, qz, qcfg, "qwen2_moe", out)
    _moe_parity(torch, pa, gg, qz, mcfg, "mixtral", out)
    # (d) the kernel alone at the served shapes, then K1 / K2 at both
    # families' heads
    pre, dec = MOE_SEQS * MOE_PROMPT, MOE_SEQS
    q = (QWEN_MOE["num_experts_per_tok"], QWEN_MOE["num_experts"],
         QWEN_MOE["hidden_size"], QWEN_MOE["moe_intermediate_size"])
    m = (MIXTRAL_8X7B["num_experts_per_tok"],
         MIXTRAL_8X7B["num_local_experts"], MIXTRAL_8X7B["hidden_size"],
         MIXTRAL_8X7B["intermediate_size"])
    # (name, family, tokens, k, E, K, N, experts never picked): gate / up
    # (hidden -> width) and down (width -> hidden), at the prefill step's
    # tokens and a decode step's; empty experts at prefill too
    cases = (("grouped_gemm", "qwen2_moe", pre, q[0], q[1], q[2], q[3], 3),
             ("grouped_gemm_qwen1p5_moe_prefill_down", "qwen2_moe", pre,
              q[0], q[1], q[3], q[2], 3),
             ("grouped_gemm_qwen1p5_moe_decode", "qwen2_moe", dec, q[0],
              q[1], q[2], q[3], 0),
             ("grouped_gemm_qwen1p5_moe_decode_down", "qwen2_moe", dec,
              q[0], q[1], q[3], q[2], 0),
             ("grouped_gemm_mixtral_8x7b_prefill", "mixtral", pre, m[0],
              m[1], m[2], m[3], 1),
             ("grouped_gemm_mixtral_8x7b_prefill_down", "mixtral", pre,
              m[0], m[1], m[3], m[2], 1),
             ("grouped_gemm_mixtral_8x7b_decode", "mixtral", dec, m[0],
              m[1], m[2], m[3], 0),
             ("grouped_gemm_mixtral_8x7b_decode_down", "mixtral", dec,
              m[0], m[1], m[3], m[2], 0))
    # the prefill shapes take the wgmma route, the decode shapes mma.sync;
    # each row's launches are its route's in the served run
    for name, fam, tokens, k, E, K, N, dead in cases:
        t = time_grouped(torch, gg, name, tokens=tokens, k=k, E=E, K=K, N=N,
                         dead=dead)
        want = "wgmma" if tokens == pre else "mma"
        if t["grouped_route"] != want:
            raise AssertionError(f"[grouped] {name}: route "
                                 f"{t['grouped_route']}, want {want}")
        launched = serve[fam]["launches"]
        n = launched["grouped_wgmma"] if want == "wgmma" else \
            launched["grouped_gemm"] - launched["grouped_wgmma"]
        rows.append({"name": name, "route": "cuda",
                     "source": GROUPED_SOURCE, "replaces": GROUPED_REPLACES,
                     "launches": n,
                     "launches_from": f"phase 29, {MOE_TAG[fam]} bf16 "
                                      f"greedy at depth 2, the {want} "
                                      f"route's", **t})
        torch.cuda.empty_cache()
    out["grouped_fp32"] = time_grouped(
        torch, gg, "grouped_gemm_fp32", tokens=dec, k=m[0], E=m[1], K=m[2],
        N=m[3] // 8, dtype=torch.float32)
    maxb = -(-(MOE_PROMPT + MOE_GEN) // 64)
    trng = np.random.default_rng(297)
    for fam, hf in (("qwen2_moe", QWEN_MOE), ("mixtral", MIXTRAL_8X7B)):
        nh = hf["num_attention_heads"]
        heads = (nh, hf["num_key_value_heads"], hf["hidden_size"] // nh)
        for name, C, ctx in (("paged_prefill", MOE_PROMPT, MOE_PROMPT),
                             ("paged_decode", 1,
                              MOE_PROMPT + MOE_GEN // 2)):
            t = time_paged(torch, trng, name, S=MOE_SEQS, C=C, ctx=ctx,
                           block_size=64, maxb=maxb, heads=heads,
                           bf16_max_abs=PAGED7_BF16_MAX_ABS)
            rows.append({"name": f"{name}_{MOE_TAG[fam]}", "route": "cuda",
                         "source": SOURCE, "replaces": REPLACES[name],
                         "launches": serve[fam]["launches"][name],
                         "launches_from": f"phase 29, {MOE_TAG[fam]} bf16 "
                                          f"greedy at depth 2", **t})
            torch.cuda.empty_cache()
    return out, rows


# ------------------------------------------------------------------ fleet

# phase 30: fleet serving (A6's serving half) at Llama-2-7B's full width
# and depth. (a): FLEET_SEQS prompts of FLEET_PROMPT tokens, FLEET_GEN
# greedy tokens (the pipelined decode at depth 2, then FLEET_LOOP steps of
# the decode loop); (b)-(d): FLEET_GROUPS groups of FLEET_PER_GROUP
# requests sharing a FLEET_PRE-token preamble, a FLEET_TAIL-token tail,
# FLEET_NEW greedy tokens in pool rounds of FLEET_ROUND
FLEET_SEQS, FLEET_PROMPT, FLEET_GEN, FLEET_LOOP = 16, 512, 64, 32
FLEET_GROUPS, FLEET_PER_GROUP = 4, 8
FLEET_PRE, FLEET_TAIL, FLEET_NEW, FLEET_ROUND = 256, 64, 32, 8
#: each replica's KV pool: a decode specialist holds every (b) request's
#: chain privately (32 x 6 blocks of 64), ~6.7 GB at 7B in bf16
FLEET_BLOCKS = 200
FLEET_BLOCK = 64
FLEET_DTYPE = "bfloat16"


def _fleet_engine(torch, cfg, params, **kw):
    """Phase 30's engine configuration; ``kw`` overrides its fields."""
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceConfig)
    maxb = -(-(FLEET_PROMPT + FLEET_GEN) // FLEET_BLOCK)
    rcfg = RaggedInferenceConfig(**{
        "max_seqs": FLEET_GROUPS * FLEET_PER_GROUP, "chunk_size": 256,
        "block_size": FLEET_BLOCK, "num_blocks": FLEET_BLOCKS,
        "max_blocks_per_seq": maxb, "dtype": FLEET_DTYPE,
        "attention_impl": "paged_flash", "decode_loop_steps": FLEET_LOOP,
        "serve_pipeline_depth": 2, "prefix_cache": True, **kw})
    return InferenceEngineV2(cfg, params, rcfg, device="cuda")


def _attrib_ms(rep, steps):
    """An attribution report's step-wall components in ms a step."""
    comps = rep["components_s"]
    return {c: comps[c] / steps * 1e3 for c in
            ("plan", "dispatch", "device_execute", "commit_apply",
             "host_gap")}


def _slo_brief(rep):
    """An SLO report without its histograms' buckets."""
    out = {k: rep[k] for k in ("requests", "tokens_committed",
                               "goodput_frac")}
    for k in ("ttft_s", "tpot_s", "queue_wait_s"):
        out[k] = {q: rep[k][q] for q in ("count", "p50", "p99")}
    return out


def _fleet_tel_engine(torch, cfg, params, telemetry):
    """(a)'s engine with telemetry on or off (``DSTPU_TELEMETRY`` at its
    construction), warmed up by one short request through every path."""
    import os
    prev = os.environ.get("DSTPU_TELEMETRY")
    os.environ["DSTPU_TELEMETRY"] = "1" if telemetry else "0"
    try:
        eng = _fleet_engine(torch, cfg, params)
    finally:
        if prev is None:
            os.environ.pop("DSTPU_TELEMETRY")
        else:
            os.environ["DSTPU_TELEMETRY"] = prev
    if (eng.metrics is not None) != telemetry:
        raise AssertionError(f"[fleet] telemetry {telemetry}: metrics "
                             f"{eng.metrics}")
    w = eng.put([900], [list(range(1, 81))], _greedy=True)
    w2 = eng.decode_pipelined([900], [w[900]], 4)
    eng.decode_batch([900], [w2[900][-1]], FLEET_LOOP)
    eng.flush(900)
    return eng


def _fleet_run(torch, eng, prompts):
    """(a) once: the prompts through ``put``, the pipelined decode, then
    the decode loop, each window bracketed by registry snapshots (with
    telemetry on: the counters checked against the streams and each
    window's attribution). Returns (streams, record)."""
    from deepspeed_tpu_torch.telemetry import attribution_report
    telemetry = eng.metrics is not None
    uids = list(range(len(prompts)))
    snap = (lambda: eng.metrics.snapshot()) if telemetry else dict
    n_pipe = FLEET_GEN - 1 - FLEET_LOOP
    torch.cuda.synchronize()
    s0, t0 = snap(), time.perf_counter()
    first = eng.put(uids, prompts, _greedy=True)
    torch.cuda.synchronize()
    s1, t1 = snap(), time.perf_counter()
    pipe = eng.decode_pipelined(uids, [first[u] for u in uids], n_pipe)
    torch.cuda.synchronize()
    s2, t2 = snap(), time.perf_counter()
    loop = eng.decode_batch(uids, [pipe[u][-1] for u in uids], FLEET_LOOP)
    torch.cuda.synchronize()
    s3, t3 = snap(), time.perf_counter()
    streams = [[first[u]] + pipe[u] + loop[u] for u in uids]
    for u in uids:
        eng.flush(u)
    rec = {"telemetry": telemetry, "prefill_s": t1 - t0,
           "decode_pipelined_s": t2 - t1, "decode_loop_s": t3 - t2,
           "decode_tok_s": len(uids) * n_pipe / (t2 - t1),
           "decode_loop_tok_s": len(uids) * FLEET_LOOP / (t3 - t2)}
    if not telemetry:
        if eng.slo_report() != {}:
            raise AssertionError("[fleet] telemetry off: slo_report")
        return streams, rec
    c0, c3 = s0["counters"], s3["counters"]
    h0, h3 = s0["histograms"], s3["histograms"]

    def dc(k):
        return c3.get(k, 0) - c0.get(k, 0)

    def dh(k):
        return h3.get(k, {}).get("count", 0) \
            - h0.get(k, {}).get("count", 0)
    total = sum(len(s) for s in streams)
    rec["counters"] = {"tokens_committed": dc("serve_tokens_committed"),
                       "ttft_count": dh("serve_ttft_s"),
                       "tpot_count": dh("serve_tpot_s"),
                       "tokens_streamed": total}
    if (dc("serve_tokens_committed") != total
            or dh("serve_ttft_s") != len(uids)
            or dh("serve_tpot_s") != total - len(uids)):
        raise AssertionError(f"[fleet] (a) counters {rec['counters']}")
    pre_steps = s1["counters"]["serve_steps"] - c0.get("serve_steps", 0)
    for name, a, b, n in (("prefill", s0, s1, pre_steps),
                          ("decode", s1, s2, n_pipe),
                          ("decode_loop", s2, s3, FLEET_LOOP)):
        rep = attribution_report(b, a)
        rec[f"attrib_{name}"] = {
            "steps": n, "ms_per_step": _attrib_ms(rep, n),
            "step_wall_ms": rep["step_wall_s"] / n * 1e3,
            "closure_err_frac": rep["closure_err_frac"],
            "dominant": rep["dominant"]}
        if rep["closure_err_frac"] is None \
                or rep["closure_err_frac"] >= 0.01:
            raise AssertionError(f"[fleet] (a) {name} attribution "
                                 f"does not close: {rep}")
    rec["slo"] = _slo_brief(eng.slo_report())
    return streams, rec


def _fleet_prompts(vocab):
    import numpy as np
    rng = np.random.default_rng(31)
    pres = [rng.integers(1, vocab, FLEET_PRE).tolist()
            for _ in range(FLEET_GROUPS)]
    return {u: pres[u % FLEET_GROUPS]
            + rng.integers(1, vocab, FLEET_TAIL).tolist()
            for u in range(FLEET_GROUPS * FLEET_PER_GROUP)}


def _fleet_drive(pool, prompts, kill_at=None, kill=None):
    """One group head a ``put`` (its preamble is cached when the next
    request is placed), the rest in one ``put``, then decode rounds of
    FLEET_ROUND; ``kill(streams)`` runs before round ``kill_at``. Returns
    (streams, owners at admission, final owners)."""
    toks, placed = {}, {}
    heads = list(range(FLEET_GROUPS))
    rest = [u for u in prompts if u not in heads]
    for batch in [[u] for u in heads] + [rest]:
        out = pool.put(batch, [prompts[u] for u in batch], _greedy=True)
        for u in batch:
            toks[u] = [int(out[u])]
            placed[u] = pool.owner_of(u).replica_id
    rounds = 0
    while True:
        live = [u for u in toks if len(toks[u]) < FLEET_NEW
                and u in pool.state.sequences]
        if not live:
            break
        if rounds == kill_at:
            kill(toks)
        outs = pool.decode_pipelined(live, [toks[u][-1] for u in live],
                                     FLEET_ROUND)
        for u in live:
            toks[u].extend(outs[u][:FLEET_NEW - len(toks[u])])
        rounds += 1
    owners = {u: pool.owner_of(u).replica_id for u in toks}
    for u in toks:
        pool.flush(u)
    return toks, placed, owners


def _fleet_check_released(pool, what):
    for r in pool.replicas():
        e = r.engine
        if r.state == "dead":
            continue
        if e.state.sequences or e.free_blocks != e.config.num_blocks:
            raise AssertionError(
                f"[fleet] {what}: {r.replica_id} holds "
                f"{len(e.state.sequences)} sequences, "
                f"{e.free_blocks} of {e.config.num_blocks} blocks free")
        if e._prefix is not None:
            e._prefix.check_invariants()


def _fleet_disagg(torch, cfg, pa_, pb, prompts, want, kv=None):
    """(c): a prefill specialist and a decode specialist; every handoff's
    blocks gathered again at the destination and held against the copy
    the source sent. Returns the record."""
    from deepspeed_tpu_torch.serving import ReplicaPool
    kw = {"kv_cache_dtype": kv} if kv else {}
    pool = ReplicaPool([_fleet_engine(torch, cfg, pa_, **kw),
                        _fleet_engine(torch, cfg, pb, **kw)],
                       policy="prefix_aware", seed=0,
                       roles=["prefill", "decode"])
    dec = pool.replicas()[1].engine
    adopt = dec.handoff_in
    checked = {"sequences": 0, "blocks": 0}

    def handoff_in(manifest, exposed_s=0.0):
        res = adopt(manifest, exposed_s=exposed_s)
        for rec in manifest["sequences"]:
            if int(rec["uid"]) not in res["accepted"]:
                continue
            seq = dec.state.get(int(rec["uid"]))
            rows, scales = dec.kv_cache.gather_blocks(seq.kv_blocks)
            sent = rec["kv"] if isinstance(rec["kv"], tuple) \
                else (rec["kv"], None)
            ok = torch.equal(rows.cpu(), sent[0].cpu()) and (
                (scales is None) == (sent[1] is None)) and (
                scales is None or torch.equal(scales.cpu(),
                                              sent[1].cpu()))
            if not ok:
                raise AssertionError(f"[fleet] (c) handoff of "
                                     f"{rec['uid']} not bit-exact")
            checked["sequences"] += 1
            checked["blocks"] += int(rec["blocks"])
        return res
    dec.handoff_in = handoff_in
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, placed, owners = _fleet_drive(pool, prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if toks != want:
        bad = sum(toks[u] != want[u] for u in want)
        raise AssertionError(f"[fleet] (c){' ' + kv if kv else ''}: {bad} "
                             f"streams differ")
    # each put prefilled on r0 and handed its sequences to r1 before
    # returning: the caller sees them on r1 from the first decode on
    if set(placed.values()) != {"r1"} or set(owners.values()) != {"r1"}:
        raise AssertionError(f"[fleet] (c) placements {placed} {owners}")
    pre_m = pool.replicas()[0].engine.metrics
    dec_m = dec.metrics
    exposed = dec_m.histogram("serve_handoff_exposed_s")
    rec = {"handoff_seqs": pre_m.counter("serve_handoff_seqs").value,
           "handoff_blocks": pre_m.counter("serve_handoff_blocks").value,
           "handoff_bytes": pre_m.counter("serve_handoff_bytes").value,
           "adopted": dec_m.counter("serve_handoff_seqs_in").value,
           "exposed_s_total": exposed.sum, "exposed_count": exposed.count,
           "bit_exact": checked, "wall_s": wall}
    if rec["handoff_seqs"] != len(prompts) \
            or checked["sequences"] != len(prompts) \
            or checked["blocks"] != rec["handoff_blocks"]:
        raise AssertionError(f"[fleet] (c) handoffs {rec}")
    _fleet_check_released(pool, "(c)")
    # the wrapper's closure holds the engine: drop it with the pool
    del dec.handoff_in
    del pool, dec, handoff_in
    torch.cuda.empty_cache()
    return rec


def _fleet_trace(torch, eng, vocab):
    """(e): ``DSTPU_TRACE_DIR`` over a prefill of two fresh prompts and
    one pipelined decode window; the exported Chrome trace must hold the
    plan / dispatch / commit ranges, with the K1 and K2 launches inside
    the dispatch ranges (by the launch's correlation id, or the range's
    span on the device). Returns the record."""
    import os
    import tempfile
    from deepspeed_tpu_torch.telemetry import maybe_trace, trace_path
    import numpy as np
    fresh = np.random.default_rng(32).integers(
        1, vocab, (2, FLEET_PRE)).tolist()
    tmp = tempfile.mkdtemp(prefix="fleet_trace_")
    os.environ["DSTPU_TRACE_DIR"] = tmp
    try:
        with maybe_trace("fleet_decode") as on:
            if not on:
                raise AssertionError("[fleet] (e) tracing did not start")
            f = eng.put([60, 61], fresh, _greedy=True)
            eng.decode_pipelined([60, 61], [f[60], f[61]], 8)
            torch.cuda.synchronize()
        path = trace_path("fleet_decode")
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
        size = os.path.getsize(path)
    finally:
        os.environ.pop("DSTPU_TRACE_DIR", None)
        shutil.rmtree(tmp, ignore_errors=True)
    eng.flush(60)
    eng.flush(61)
    spans = {n: [e for e in events if e.get("ph") == "X"
                 and e.get("cat") == "user_annotation"
                 and e.get("name") == n]
             for n in ("plan", "dispatch", "commit")}
    gpu_spans = [e for e in events if e.get("ph") == "X"
                 and e.get("cat") == "gpu_user_annotation"
                 and e.get("name") == "dispatch"]
    kernels = {k: [e for e in events if e.get("cat") == "kernel"
                   and k in e.get("name", "")]
               for k in ("paged_prefill", "paged_decode")}
    launches = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None and e.get("cat") in ("cuda_runtime",
                                                  "cuda_driver"):
            launches[corr] = e

    def inside(e, rng):
        return any(r["ts"] <= e["ts"] <= r["ts"] + r["dur"]
                   and (r.get("tid") == e.get("tid") or "tid" not in e)
                   for r in rng)
    rec = {"trace_bytes": size,
           "spans": {n: len(v) for n, v in spans.items()},
           "gpu_dispatch_spans": len(gpu_spans),
           "launch_events": len(launches), "kernels": {}}
    cats = sorted({str(e.get("cat")) for e in events})
    for k, ks in kernels.items():
        by_launch = sum(
            1 for e in ks
            if (e.get("args") or {}).get("correlation") in launches
            and inside(launches[e["args"]["correlation"]],
                       spans["dispatch"]))
        by_device = sum(1 for e in ks if any(
            r["ts"] <= e["ts"] and e["ts"] + e.get("dur", 0)
            <= r["ts"] + r["dur"] for r in gpu_spans))
        rec["kernels"][k] = {"events": len(ks),
                             "launch_in_dispatch": by_launch,
                             "device_in_dispatch": by_device}
        if not ks or not (by_launch or by_device):
            raise AssertionError(f"[fleet] (e) {k}: no launch inside a "
                                 f"dispatch range: {rec}; categories "
                                 f"{cats}")
    if not all(spans.values()):
        raise AssertionError(f"[fleet] (e) missing phase ranges: {rec}; "
                             f"categories {cats}")
    return rec


#: (f): layers of Llama-2-7B (full width) the fp32 replay check serves
REPLAY_LAYERS = 4


def _fleet_replay_fp32(torch):
    """(f): (d)'s SIGTERM drain and replay once more in fp32 with TF32
    off, at REPLAY_LAYERS of Llama-2-7B's layers and its full width: every
    stream, the drained sequences' replayed continuations too, must equal
    the uninterrupted run (one engine, the same calls). Returns the
    record."""
    import os
    import signal
    import numpy as np
    from deepspeed_tpu_torch.checkpoint import init_llama_params
    from deepspeed_tpu_torch.models.llama import LlamaConfig
    from deepspeed_tpu_torch.resilience import PreemptionHandler
    from deepspeed_tpu_torch.serving import ReplicaPool
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        cfg = LlamaConfig.llama2_7b(num_layers=REPLAY_LAYERS,
                                    dtype=torch.float32)
        pa_ = init_llama_params(cfg, seed=30, device="cuda")
        pb = init_llama_params(cfg, seed=30, device="cuda")
        fprompts = _fleet_prompts(cfg.vocab_size)
        one = ReplicaPool([_fleet_engine(torch, cfg, pa_,
                                         dtype="float32")], seed=0)
        want, _, _ = _fleet_drive(one, fprompts)
        del one
        pool = ReplicaPool([_fleet_engine(torch, cfg, pa_, dtype="float32"),
                            _fleet_engine(torch, cfg, pb, dtype="float32")],
                           policy="prefix_aware", seed=0)
        handler = PreemptionHandler()
        pool.replicas()[0].engine.attach_preemption(handler)
        at_kill = {}

        def kill(streams):
            at_kill.update({u: (list(t), pool.owner_of(u).replica_id)
                            for u, t in streams.items()})
            os.kill(os.getpid(), signal.SIGTERM)
        try:
            toks, _, owners = _fleet_drive(pool, fprompts, kill_at=1,
                                           kill=kill)
        finally:
            handler.uninstall()
        r0 = pool.replicas()[0]
        if not handler.preempted or r0.state != "dead" \
                or set(owners.values()) != {"r1"}:
            raise AssertionError(f"[fleet] (f) absorb: {r0.state} "
                                 f"{owners}")
        _fleet_check_released(pool, "(f)")
        drained = sorted(u for u, (_, o) in at_kill.items() if o == "r0")
        stayed = [u for u in fprompts if u not in drained]
        first_diff = {u: next((i for i, (a, b) in enumerate(
            zip(toks[u], want[u])) if a != b), None) for u in drained}
        rec = {"model": f"Llama-2-7B width, {REPLAY_LAYERS} layers, fp32, "
                        f"TF32 off, seeded (seed 30)",
               "drained": len(drained),
               "drained_equal_uninterrupted": sum(
                   v is None for v in first_diff.values()),
               "first_token_differing": first_diff,
               "token_agreement": float(np.mean([
                   a == b for u in drained
                   for a, b in zip(toks[u], want[u])])),
               "stayed_equal_uninterrupted": sum(
                   toks[u] == want[u] for u in stayed),
               "stayed": len(stayed),
               "streams_whole": all(len(toks[u]) == FLEET_NEW
                                    for u in toks)}
        del pool, r0, kill, handler, pa_, pb
        torch.cuda.empty_cache()
        # in fp32 a replay's re-prefill of the generated tokens gives the
        # decode steps' tokens (bf16 need not: (d))
        if rec["drained_equal_uninterrupted"] != rec["drained"] \
                or rec["stayed_equal_uninterrupted"] != rec["stayed"] \
                or not rec["drained"] or not rec["streams_whole"]:
            raise AssertionError(f"[fleet] (f) fp32 replay: {rec}")
        return rec
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def phase_fleet_serving(torch):
    """Phase 30: serving telemetry, step attribution and the replica
    fleet on the card at Llama-2-7B's full width and depth (module
    docstring). Returns (out, rows, weights): ``weights`` holds the
    seeded bf16 parameters (``"params"``) for phase 31 to serve."""
    import os
    import signal
    import tempfile
    import numpy as np
    from deepspeed_tpu_torch.checkpoint import init_llama_params
    from deepspeed_tpu_torch.models.llama import LlamaConfig
    from deepspeed_tpu_torch.ops.kernels import paged_attention as pa
    from deepspeed_tpu_torch.resilience import (DISAGG_FAULT_SITE,
                                                FaultInjector,
                                                PreemptionHandler,
                                                RestartLedger,
                                                set_fault_injector)
    from deepspeed_tpu_torch.serving import ReplicaPool
    cfg = LlamaConfig.llama2_7b(dtype=torch.bfloat16)
    # two replicas, each with its own copy of the same seeded weights
    pa_ = init_llama_params(cfg, seed=30, device="cuda")
    pb = init_llama_params(cfg, seed=30, device="cuda")
    out = {"model": "Llama-2-7B, 32 layers, bf16, seeded (seed 30)",
           "reduced": "none"}
    launches = {}

    def count(part):
        launches[part] = {**pa.LAUNCHES,
                          "int8": pa.ROUTE_LAUNCHES["int8"]}
        pa.reset_launch_counts()

    # (a) one engine with telemetry off and one with it on, in turns
    # (off, on, on, off) over two prompt sets
    rng = np.random.default_rng(30)
    psets = [rng.integers(1, cfg.vocab_size,
                          (FLEET_SEQS, FLEET_PROMPT)).tolist()
             for _ in range(2)]
    pa.reset_launch_counts()
    engs = {False: _fleet_tel_engine(torch, cfg, pa_, False),
            True: _fleet_tel_engine(torch, cfg, pa_, True)}
    runs = []
    for k, on in enumerate((False, True, True, False)):
        streams, rec = _fleet_run(torch, engs[on], psets[k // 2])
        runs.append((streams, rec))
    for k in (0, 2):
        if runs[k][0] != runs[k + 1][0]:
            bad = sum(a != b for a, b in zip(runs[k][0], runs[k + 1][0]))
            raise AssertionError(f"[fleet] (a) {bad} streams differ "
                                 f"between telemetry on and off")
    recs = [r for _, r in runs]
    tok = {on: [r["decode_tok_s"] for r in recs if r["telemetry"] == on]
           for on in (False, True)}
    r_on = recs[1]
    out["a"] = {"runs": recs, "streams_identical": True,
                "decode_tok_s_on": tok[True], "decode_tok_s_off": tok[False],
                "telemetry_tok_s_ratio": sum(tok[True]) / sum(tok[False])}
    for r in (recs[1], recs[2]):
        for name in ("prefill", "decode", "decode_loop"):
            a = r[f"attrib_{name}"]
            log(f"[fleet] (a) {name} attribution, ms a step over "
                f"{a['steps']} steps: "
                + ", ".join(f"{c} {v:.3f}"
                            for c, v in a["ms_per_step"].items())
                + f"; wall {a['step_wall_ms']:.3f}, closure_err_frac "
                  f"{a['closure_err_frac']:.2e}, dominant {a['dominant']}")
    log(f"[fleet] (a) decode tok/s in turns off, on, on, off: "
        + ", ".join(f"{r['decode_tok_s']:.1f}" for r in recs)
        + f" (on / off {out['a']['telemetry_tok_s_ratio']:.4f}); loop "
        + ", ".join(f"{r['decode_loop_tok_s']:.1f}" for r in recs)
        + "; prefill s " + ", ".join(f"{r['prefill_s']:.4f}" for r in recs)
        + f"; counters {r_on['counters']}")
    eng = engs[True]
    del engs
    # (e) spans on the card, on the same engine
    out["e"] = _fleet_trace(torch, eng, cfg.vocab_size)
    log(f"[fleet] (e) trace: {out['e']}")
    del eng
    torch.cuda.empty_cache()
    count("a_e")

    # (b) two mixed replicas behind the prefix-aware router, against one
    # engine serving the same calls
    fprompts = _fleet_prompts(cfg.vocab_size)
    one = ReplicaPool([_fleet_engine(torch, cfg, pa_)], seed=0)
    want, _, _ = _fleet_drive(one, fprompts)
    _fleet_check_released(one, "(b) one engine")
    del one
    torch.cuda.empty_cache()
    pool = ReplicaPool([_fleet_engine(torch, cfg, pa_),
                        _fleet_engine(torch, cfg, pb)],
                       policy="prefix_aware", seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, placed, owners = _fleet_drive(pool, fprompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if toks != want:
        bad = sum(toks[u] != want[u] for u in want)
        raise AssertionError(f"[fleet] (b) {bad} streams differ from one "
                             f"engine's")
    groups = {g: sorted({placed[u] for u in fprompts
                         if u % FLEET_GROUPS == g})
              for g in range(FLEET_GROUPS)}
    hits = {r.replica_id: r.engine.prefix_stats["matched_tokens"]
            for r in pool.replicas()}
    if any(len(v) != 1 for v in groups.values()) \
            or not all(hits.values()):
        raise AssertionError(f"[fleet] (b) routing {groups}, hits {hits}")
    snap = pool.fleet_snapshot()
    per = [r.engine.metrics.snapshot()["histograms"]
           for r in pool.replicas()]
    for name, h in snap["histograms"].items():
        if h["count"] != sum(p.get(name, {"count": 0})["count"]
                             for p in per):
            raise AssertionError(f"[fleet] (b) rollup {name}")
    out["b"] = {"groups": groups, "prefix_hit_tokens": hits,
                "wall_s": wall, "streams_equal_one_engine": True,
                "fleet_slo": _slo_brief(pool.slo_report()),
                "tokens": sum(len(t) for t in toks.values())}
    _fleet_check_released(pool, "(b)")
    log(f"[fleet] (b) groups {groups}, prefix-hit tokens {hits}, "
        f"{out['b']['tokens']} tokens in {wall:.3f} s; streams equal one "
        f"engine's; fleet histogram counts = the replicas' sums")
    del pool
    torch.cuda.empty_cache()
    count("b")

    # (c) disaggregated: prefill on r0, decode on r1, over bf16 and int8
    out["c"] = {"bf16": _fleet_disagg(torch, cfg, pa_, pb, fprompts, want)}
    count("c_bf16")
    one = ReplicaPool([_fleet_engine(torch, cfg, pa_,
                                     kv_cache_dtype="int8")], seed=0)
    want8, _, _ = _fleet_drive(one, fprompts)
    del one
    torch.cuda.empty_cache()
    out["c"]["int8"] = _fleet_disagg(torch, cfg, pa_, pb, fprompts, want8,
                                     kv="int8")
    count("c_int8")
    for k, r in out["c"].items():
        log(f"[fleet] (c) {k}: {r['handoff_seqs']} sequences handed off, "
            f"{r['handoff_blocks']} blocks, {r['handoff_bytes']} bytes, "
            f"exposed {r['exposed_s_total']:.4f} s over "
            f"{r['exposed_count']} transfers; bit-exact "
            f"{r['bit_exact']}; wall {r['wall_s']:.3f} s")

    # (d) elastic: a real SIGTERM on r0 mid-decode; then a fault in the
    # handoff gather
    tmp = tempfile.mkdtemp(prefix="fleet_ledger_")
    ledger_path = os.path.join(tmp, "ledger.json")
    try:
        pool = ReplicaPool([_fleet_engine(torch, cfg, pa_),
                            _fleet_engine(torch, cfg, pb)],
                           policy="prefix_aware", seed=0,
                           ledger=RestartLedger(ledger_path))
        handler = PreemptionHandler()
        pool.replicas()[0].engine.attach_preemption(handler)
        at_kill = {}

        def kill(streams):
            # the streams as they stand, and who owns each, at the signal
            at_kill.update({u: (list(t), pool.owner_of(u).replica_id)
                            for u, t in streams.items()})
            os.kill(os.getpid(), signal.SIGTERM)
        try:
            toks, _, owners = _fleet_drive(pool, fprompts, kill_at=1,
                                           kill=kill)
        finally:
            handler.uninstall()
        r0 = pool.replicas()[0]
        with open(ledger_path) as fh:
            events = [e["event"] for e in json.load(fh)["events"]]
        if not handler.preempted or r0.state != "dead" \
                or not r0.manifest["pool"]["fully_recovered"] \
                or set(owners.values()) != {"r1"} \
                or "fleet_drain" not in events \
                or "fleet_replay" not in events:
            raise AssertionError(f"[fleet] (d) absorb: {r0.state} "
                                 f"{owners} {events}")
        drained = sorted(u for u, (_, o) in at_kill.items() if o == "r0")
        stayed = sorted(u for u in fprompts if u not in drained)
        # gapless: every stream whole, nothing emitted before the signal
        # changed; the survivor's own streams as (b)'s
        if any(len(toks[u]) != FLEET_NEW for u in toks) or any(
                toks[u][:len(at_kill[u][0])] != at_kill[u][0]
                or at_kill[u][0] != want[u][:len(at_kill[u][0])]
                for u in toks) or any(toks[u] != want[u] for u in stayed):
            raise AssertionError(f"[fleet] (d) streams after the absorb: "
                                 f"{ {u: (toks[u], want[u]) for u in toks} }")
        # the drained streams continue as the same manifest replayed on
        # one fresh engine, driven in the same rounds
        ref = ReplicaPool([_fleet_engine(torch, cfg, pa_)], seed=0)
        for u, t in ref.replay_manifest(r0.manifest).items():
            ref._stash_replay(u, t)
        ref_toks = {u: list(at_kill[u][0]) for u in drained}
        while True:
            live = [u for u in drained if len(ref_toks[u]) < FLEET_NEW]
            if not live:
                break
            res = ref.decode_pipelined(
                live, [ref_toks[u][-1] for u in live], FLEET_ROUND)
            for u in live:
                ref_toks[u].extend(res[u][:FLEET_NEW - len(ref_toks[u])])
        if any(toks[u] != ref_toks[u] for u in drained):
            raise AssertionError(f"[fleet] (d) the drained streams differ "
                                 f"from the manifest's replay on one "
                                 f"engine")
        for u in drained:
            ref.flush(u)
        _fleet_check_released(ref, "(d) replay reference")
        del ref
        # and against (b)'s uninterrupted streams: a replay re-prefills
        # the generated tokens, which bf16 need not round as the decode
        # steps that first wrote them did
        first_diff = {u: next((i for i, (a, b) in enumerate(
            zip(toks[u], want[u])) if a != b), None) for u in drained}
        out["d"] = {"drained_sequences": len(r0.manifest["sequences"]),
                    "drained": drained, "ledger_events": events,
                    "tokens_at_signal": {u: len(at_kill[u][0])
                                         for u in drained},
                    "streams_whole": True,
                    "stayed_equal_b": True,
                    "drained_equal_replay_on_one_engine": True,
                    "drained_equal_b": sum(v is None
                                           for v in first_diff.values()),
                    "drained_first_token_differing_from_b": first_diff,
                    "drained_token_agreement_with_b": float(np.mean([
                        a == b for u in drained
                        for a, b in zip(toks[u], want[u])]))}
        _fleet_check_released(pool, "(d)")
        # the signal's closure holds the pool: both go
        del pool, r0, kill
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    pool = ReplicaPool([_fleet_engine(torch, cfg, pa_),
                        _fleet_engine(torch, cfg, pb)],
                       policy="prefix_aware", seed=0,
                       roles=["prefill", "decode"])
    inj = FaultInjector(site=DISAGG_FAULT_SITE, mode="raise", times=1)
    set_fault_injector(inj)
    try:
        toks, placed, owners = _fleet_drive(pool, fprompts)
    finally:
        set_fault_injector(None)
    if inj._fired != 1 or toks != want or owners[0] != "r0" \
            or set(owners[u] for u in fprompts if u) != {"r1"}:
        raise AssertionError(f"[fleet] (d) aborted handoff: fired "
                             f"{inj._fired}, owners {owners}")
    _fleet_check_released(pool, "(d) fault")
    out["d"]["aborted_handoff"] = {"fired": inj._fired,
                                   "kept_on_prefill": [0],
                                   "streams_equal_b": True}
    d = out["d"]
    log(f"[fleet] (d) SIGTERM on r0 between decode rounds: "
        f"{d['drained_sequences']} sequences drained and replayed on r1; "
        f"every stream whole, the survivor's own {len(stayed)} equal "
        f"(b)'s, the drained equal the manifest's replay on one engine; "
        f"against (b): {d['drained_equal_b']} of {len(drained)} drained "
        f"streams equal, token agreement "
        f"{d['drained_token_agreement_with_b']:.4f}, first differing "
        f"token {d['drained_first_token_differing_from_b']}; ledger "
        f"{events}. A during_handoff_gather fault kept uid 0 on r0, lost "
        f"nothing, leaked no block, streams equal (b)'s")
    del pool
    torch.cuda.empty_cache()
    count("d")
    # (f) the drain and replay of (d) once more in fp32, TF32 off
    out["f"] = _fleet_replay_fp32(torch)
    count("f")
    f = out["f"]
    log(f"[fleet] (f) fp32 drain and replay at {REPLAY_LAYERS} layers: "
        f"{f['drained_equal_uninterrupted']} of {f['drained']} drained "
        f"streams equal the uninterrupted run (token agreement "
        f"{f['token_agreement']:.4f}, first differing token "
        f"{f['first_token_differing']}); the survivor's own "
        f"{f['stayed_equal_uninterrupted']} of {f['stayed']} equal")
    out["launches"] = launches
    log(f"[fleet] launches {launches}")
    for part, n in launches.items():
        if part != "f" and not (n["paged_prefill"] and n["paged_decode"]):
            raise AssertionError(f"[fleet] {part}: K1 / K2 not launched: "
                                 f"{n}")
    # the seeded weights go on to phase 31; the second copy goes here
    del pb
    torch.cuda.empty_cache()
    # K1 / K2 at this phase's shapes against their plain versions, timed
    maxb = -(-(FLEET_PROMPT + FLEET_GEN) // FLEET_BLOCK)
    bf = {k: sum(v[k] for p, v in launches.items()
                 if p not in ("c_int8", "f"))
          for k in ("paged_prefill", "paged_decode")}
    i8 = launches["c_int8"]
    trng = np.random.default_rng(300)
    rows = []
    for name, C, ctx, S, quant, n, src in (
            ("paged_prefill", 256, FLEET_PROMPT, FLEET_SEQS, False,
             bf["paged_prefill"], "(a)-(e) over bf16 pools"),
            ("paged_decode", 1, FLEET_PROMPT + FLEET_GEN // 2, FLEET_SEQS,
             False, bf["paged_decode"], "(a)-(e) over bf16 pools"),
            ("paged_prefill", FLEET_TAIL, FLEET_PRE + FLEET_TAIL,
             FLEET_GROUPS * FLEET_PER_GROUP - FLEET_GROUPS, True,
             i8["paged_prefill"], "(c) over int8 pools"),
            ("paged_decode", 1, FLEET_PRE + FLEET_TAIL + FLEET_NEW // 2,
             FLEET_GROUPS * FLEET_PER_GROUP, True, i8["paged_decode"],
             "(c) over int8 pools")):
        t = time_paged(torch, trng, name, S=S, C=C, ctx=ctx,
                       block_size=FLEET_BLOCK, maxb=maxb,
                       heads=(32, 32, 128), quant=quant,
                       bf16_max_abs=PAGED7_BF16_MAX_ABS)
        rows.append({"name": f"{name}_fleet_7b" + ("_int8" if quant
                                                    else ""),
                     "route": "cuda", "source": SOURCE,
                     "replaces": REPLACES[name], "launches": n,
                     "launches_from": f"phase 30, Llama-2-7B, {src}", **t})
        torch.cuda.empty_cache()
    return out, rows, {"params": pa_}


# phase 31: the open-loop load generator on phase 30's 7B engine
# configuration (attention "auto"): LOADGEN_LIVE slots (max_live), a
# saturating pass of LOADGEN_SAT requests offered at once, then a Poisson
# sweep of LOADGEN_N requests a rate at LOADGEN_FRACS of its completed rate
LOADGEN_LIVE, LOADGEN_SAT, LOADGEN_N = 16, 32, 32
LOADGEN_FRACS = (0.5, 0.8, 1.0, 1.3)
#: WorkloadMix's default shapes: prompts up to 512, generations up to 128
LOADGEN_MAX_PROMPT, LOADGEN_MAX_GEN = 512, 128
#: a chat service's system prompt, opening half the requests
LOADGEN_PRE = 256
LOADGEN_DEADLINE_S = 15.0
LOADGEN_SLO = 0.9
#: (f): the train_batch timer's mean against phase 7's step time
TIMER_TOL = 0.05


def _loadgen_engine(torch, cfg, params):
    """Phase 30 (a)'s engine configuration with ``attention_impl="auto"``
    (K1/K2 on the card) and a block table long enough for the mix's
    longest request (512 + 128 tokens: 10 blocks of 64)."""
    return _fleet_engine(
        torch, cfg, params, attention_impl="auto",
        max_blocks_per_seq=-(-(LOADGEN_MAX_PROMPT + LOADGEN_MAX_GEN)
                             // FLEET_BLOCK))


def _pass_row(rep):
    """One open-loop pass's report, as phase 31 prints it."""
    lat = rep["latency"]
    r = rep["requests"]
    row = {"offered_rps": rep["rates_rps"]["offered"],
           "completed_rps": rep["rates_rps"]["completed"],
           "goodput_rps": rep["rates_rps"]["goodput"],
           "goodput_frac": rep["goodput_frac"],
           "shed": r["shed"] + r["shed_late"],
           "deadline_missed": r["deadline_expired"]
           + r["completed"] - r["goodput"],
           "balance_ok": r["balance_ok"], "requests": r,
           "duration_s": rep["duration_s"],
           "output_tokens_per_sec": rep.get("output_tokens_per_sec"),
           "max_offer_lag_s": rep["open_loop"]["max_offer_lag_s"]}
    for k in ("ttft_s", "tpot_s", "queue_wait_s"):
        row[k.replace("_s", "_ms")] = {
            q: (lat[k][q] * 1e3 if lat[k].get(q) is not None else None)
            for q in ("p50", "p90", "p99")}
    return row


def _timers_check(torch, train):
    """(f): phase 7's GPT-2-1.3B steps once more with
    ``wall_clock_breakdown`` on. Returns the record."""
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.checkpoint import init_gpt2_params
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, make_model
    from deepspeed_tpu_torch.utils.timer import TRAIN_BATCH_TIMER
    torch.backends.cuda.matmul.allow_tf32 = True
    cfg = GPT2Config.xl_1p3b(dtype=torch.bfloat16)
    _, _, loss_fn = make_model(cfg)
    params = init_gpt2_params(cfg, seed=0, device="cuda")
    engine, *_ = initialize(loss_fn=loss_fn, params=params, config={
        **train_config(TRAIN_MB, TRAIN_GAS), "wall_clock_breakdown": True})
    del params
    g = torch.Generator(device="cuda").manual_seed(0)
    B = TRAIN_MB * TRAIN_GAS
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, TRAIN_T + 1),
                                     generator=g, device="cuda")}
    losses = [engine.train_batch(batch) for _ in range(2)]      # warm-up
    timer = engine.timers(TRAIN_BATCH_TIMER)
    timer.reset()
    for _ in range(TRAIN_STEPS):
        losses.append(engine.train_batch(batch))
    timer_ms = timer.mean() * 1e3
    count = timer.count
    losses = [float(x) for x in losses]
    del engine, batch
    torch.cuda.empty_cache()
    step_ms = sum(train["step_ms"]) / len(train["step_ms"])
    diffs = [abs(a - b) / abs(b) for a, b in zip(losses, train["losses"])]
    rec = {"timer_mean_ms": timer_ms, "timer_count": count,
           "phase7_step_ms": step_ms, "ratio": timer_ms / step_ms,
           "losses": losses, "losses_equal_phase7": losses == train["losses"],
           "max_loss_rel_diff": max(diffs)}
    if count != TRAIN_STEPS or abs(timer_ms / step_ms - 1) > TIMER_TOL:
        raise AssertionError(f"[loadgen] (f) train_batch timer {rec}")
    # the first loss is computed before any update: bit for bit
    if losses[0] != train["losses"][0] or max(diffs) > 1e-4:
        raise AssertionError(f"[loadgen] (f) losses with the timers on "
                             f"{losses} against phase 7's "
                             f"{train['losses']}")
    return rec


def phase_loadgen(torch, weights, train):
    """Phase 31: the open-loop load generator, the snapshot renderer,
    the serve fault drill and the wall-clock timers on the card (module
    docstring). ``weights`` is phase 30's box of seeded Llama-2-7B
    parameters (taken from it here), ``train`` phase 7's record. Returns
    (out, rows)."""
    import io
    import os
    import tempfile
    import numpy as np
    from deepspeed_tpu_torch.models.llama import LlamaConfig
    from deepspeed_tpu_torch.ops.kernels import paged_attention as pa
    from deepspeed_tpu_torch.resilience import faultdrill
    from deepspeed_tpu_torch.telemetry import attribution_report
    from deepspeed_tpu_torch.telemetry import loadgen as lg
    from deepspeed_tpu_torch.telemetry import top
    cfg = LlamaConfig.llama2_7b(dtype=torch.bfloat16)
    params = weights.pop("params")
    out = {"model": "Llama-2-7B, 32 layers, bf16, seeded (seed 30; phase "
                    "30's weights)", "reduced": "none"}
    tmp = tempfile.mkdtemp(prefix="loadgen_")
    export = os.path.join(tmp, "serve.json")
    os.environ["DSTPU_TELEMETRY_EXPORT"] = export
    try:
        eng = _loadgen_engine(torch, cfg, params)
    finally:
        os.environ.pop("DSTPU_TELEMETRY_EXPORT")
    del params
    try:
        # the longest shape alone (a 512-token prompt, 128 new): the
        # deadline must leave it room; also the engine's first calls
        longest = lg.WorkloadMix(
            prompt_lens=(LOADGEN_MAX_PROMPT,), prompt_probs=(1.0,),
            gen_lens=(LOADGEN_MAX_GEN,), gen_probs=(1.0,),
            vocab_size=cfg.vocab_size)
        alone = lg.run_open_loop(eng, lg.build_requests(
            lg.TraceArrivals([0.0]), longest, 1, seed=31,
            uid_base=31_000_000)).report
        longest_s = alone["duration_s"]
        deadline = 2.0 * longest_s if longest_s > LOADGEN_DEADLINE_S \
            else LOADGEN_DEADLINE_S
        out["longest_alone_s"] = longest_s
        out["deadline_s"] = deadline
        mix = lg.WorkloadMix(shared_prefix_frac=0.5,
                             shared_prefix_len=LOADGEN_PRE,
                             deadline_frac=1.0, deadline_s=deadline,
                             vocab_size=cfg.vocab_size)
        log(f"[loadgen] the longest shape alone {longest_s:.3f} s; "
            f"deadline {deadline:.1f} s; mix {mix.describe()}")
        # every pass from here on, with the registry around it
        passes = []
        run = lg.run_open_loop

        def recorded(engine, requests, **kw):
            s0 = engine.metrics.snapshot()
            res = run(engine, requests, **kw)
            passes.append((res.report, s0, engine.metrics.snapshot()))
            return res
        pa.reset_launch_counts()
        # (a) the service rate: every request offered at once
        torch.cuda.synchronize()
        sat = lg.run_open_loop(eng, lg.build_requests(
            lg.TraceArrivals([0.0] * LOADGEN_SAT), lg.WorkloadMix(
                shared_prefix_frac=0.5, shared_prefix_len=LOADGEN_PRE,
                vocab_size=cfg.vocab_size), LOADGEN_SAT, seed=1,
            uid_base=32_000_000), max_live=LOADGEN_LIVE).report
        R = sat["rates_rps"]["completed"]
        out["a"] = _pass_row(sat)
        out["R_rps"] = R
        log(f"[loadgen] (a) saturating pass: {LOADGEN_SAT} requests at "
            f"once, max_live {LOADGEN_LIVE}: R = {R} rps completed, "
            f"{sat['output_tokens_per_sec']} tok/s, {sat['duration_s']} s; "
            f"balance_ok {sat['requests']['balance_ok']}")
        # (b) the sweep
        rates = [f * R for f in LOADGEN_FRACS]
        lg.run_open_loop = recorded
        try:
            sweep = lg.sweep_capacity(
                eng, rates, LOADGEN_N, mix, seed=0,
                goodput_slo_frac=LOADGEN_SLO, process="poisson",
                decode_burst=8, max_live=LOADGEN_LIVE)
        finally:
            lg.run_open_loop = run
        torch.cuda.synchronize()
        launches = dict(pa.LAUNCHES)
        out["b"] = {"knee_rps": sweep["knee_rps"],
                    "knee_goodput_rps": sweep["knee_goodput_rps"],
                    "curve": sweep["curve"], "passes": []}
        for frac, (rep, s0, s1) in zip(LOADGEN_FRACS, passes):
            row = {"frac_of_R": frac, **_pass_row(rep)}
            steps = s1["counters"]["serve_steps"] \
                - s0["counters"].get("serve_steps", 0)
            att = attribution_report(s1, s0)
            row["steps"] = steps
            row["attribution_ms_per_step"] = _attrib_ms(att, steps)
            row["attribution_closure_err_frac"] = att["closure_err_frac"]
            out["b"]["passes"].append(row)
            log(f"[loadgen] (b) {frac:.1f} R: offered {row['offered_rps']} "
                f"rps, completed {row['completed_rps']}, goodput "
                f"{row['goodput_rps']} ({row['goodput_frac']}); TTFT ms "
                f"{row['ttft_ms']}, TPOT ms {row['tpot_ms']}, queue wait "
                f"ms {row['queue_wait_ms']}; shed {row['shed']}, deadline "
                f"missed {row['deadline_missed']}; balance_ok "
                f"{row['balance_ok']}")
        r10 = out["b"]["passes"][LOADGEN_FRACS.index(1.0)]
        log(f"[loadgen] (b) knee {sweep['knee_rps']} rps (goodput "
            f"{sweep['knee_goodput_rps']} rps at SLO {LOADGEN_SLO}); the "
            f"1.0 R pass's attribution, ms a step over {r10['steps']} "
            f"steps: " + ", ".join(
                f"{c} {v:.3f}"
                for c, v in r10["attribution_ms_per_step"].items())
            + f" (closure_err_frac {r10['attribution_closure_err_frac']})")
        books = [sat] + [rep for rep, _, _ in passes]
        if not all(rep["requests"]["balance_ok"] for rep in books) \
                or len(passes) != len(LOADGEN_FRACS) \
                or sat["requests"]["completed"] != LOADGEN_SAT:
            raise AssertionError(f"[loadgen] books: {out['a']} "
                                 f"{out['b']['passes']}")
        # (c) the kernels of the whole of (a) and (b)
        out["launches"] = launches
        log(f"[loadgen] (c) K1 / K2 launches over (a) and (b): {launches}")
        if not (launches["paged_prefill"] and launches["paged_decode"]):
            raise AssertionError(f"[loadgen] K1 / K2 not launched: "
                                 f"{launches}")
        # (d) the renderer over the engine's export after (b)
        snap = top.load_snapshot(export)
        text = top.render(snap)
        out["d"] = {"export_bytes": os.path.getsize(export),
                    "render_lines": len(text.splitlines())}
        log("[loadgen] (d) top.render of the export:\n" + text)
        if not text or "goodput" not in text or "ttft" not in text:
            raise AssertionError("[loadgen] (d) render names no goodput "
                                 "or TTFT")
        if eng.state.sequences or eng.free_blocks != eng.config.num_blocks:
            raise AssertionError(f"[loadgen] the engine holds "
                                 f"{len(eng.state.sequences)} sequences, "
                                 f"{eng.free_blocks} blocks free after "
                                 f"(b)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del eng
    torch.cuda.empty_cache()
    # K1 / K2 against their plain versions at the phase's largest
    # prefill and decode shapes, timed
    maxb = -(-(LOADGEN_MAX_PROMPT + LOADGEN_MAX_GEN) // FLEET_BLOCK)
    trng = np.random.default_rng(310)
    rows = []
    for name, C, ctx in (
            ("paged_prefill", 256, LOADGEN_MAX_PROMPT),
            ("paged_decode", 1, LOADGEN_MAX_PROMPT + LOADGEN_MAX_GEN)):
        t = time_paged(torch, trng, name, S=LOADGEN_LIVE, C=C, ctx=ctx,
                       block_size=FLEET_BLOCK, maxb=maxb,
                       heads=(32, 32, 128),
                       bf16_max_abs=PAGED7_BF16_MAX_ABS)
        rows.append({"name": f"{name}_loadgen_7b", "route": "cuda",
                     "source": SOURCE, "replaces": REPLACES[name],
                     "launches": launches[name],
                     "launches_from": "phase 31, Llama-2-7B, (a) and (b)",
                     **t})
        torch.cuda.empty_cache()
    # (e) the serve fault drill, its workers on the card
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = faultdrill.main(["--mode", "serve", "--sites",
                              "mid_commit,sigterm", "--device", "cuda"])
    drill = json.loads(buf.getvalue()[buf.getvalue().index("{"):])
    out["e"] = {"rc": rc, "results": drill["results"]}
    log(f"[loadgen] (e) fault drill rc {rc}: " + "; ".join(
        f"{r['site']}: crash_rc {r.get('crash_rc')}, recovered "
        f"{r['recovered']}, parity {r.get('token_parity')}"
        for r in drill["results"]))
    if rc != 0:
        raise AssertionError(f"[loadgen] (e) fault drill: {drill}")
    # (f) the timers
    out["f"] = _timers_check(torch, train)
    f = out["f"]
    log(f"[loadgen] (f) train_batch timer {f['timer_mean_ms']:.2f} ms "
        f"over {f['timer_count']} steps against phase 7's "
        f"{f['phase7_step_ms']:.2f} ms (ratio {f['ratio']:.4f}); losses "
        f"equal phase 7's: {f['losses_equal_phase7']} (max relative "
        f"difference {f['max_loss_rel_diff']:.3e})")
    return out, rows


# ------------------------------------------------------- family training

#: phase 32's runs, (micro batch, sequence) each, bf16 compute over fp32
#: master params: (a) TinyLlama-1.1B at all 22 layers, (b) Qwen1.5-MoE-
#: A2.7B (phase 29's QWEN_MOE, published widths) at FT_LAYERS of its 24,
#: (c) Mixtral-8x7B (MIXTRAL_8X7B) at FT_LAYERS of its 32
FT_RUNS = {"tinyllama_1b": (4, 2048), "qwen1p5_moe": (2, 1024),
           "mixtral_8x7b": (2, 1024)}
FT_LAYERS = {"qwen1p5_moe": 2, "mixtral_8x7b": 1}
FT_WARMUP, FT_STEPS, FT_PARITY_STEPS, FT_SEED = 2, 5, 3, 32
#: kernel route against the plain routes: phase 7's bf16 limit on the
#: losses of the first FT_PARITY_STEPS steps, relative
FT_PARITY_REL = 1e-4
#: B18 (grouped_wgrad and grouped_dgrad, the grouped GEMM's backward) has
#: no Pallas twin: JAX differentiates jax.lax.ragged_dot
B18_REPLACES = ("deepspeed_tpu/moe/sharded_moe.py:230 (the VJP of "
                "jax.lax.ragged_dot; no pallas_call)")
#: B18 at Mixtral-8x7B's expert product, timed beside run (b): tokens,
#: top-k, experts, K, N (one expert left empty); dW 481 GFLOP against
#: ~1.09 GB, bound by operations
B18_MIXTRAL = (2048, 2, 8, 4096, 14336)
#: B18's launch counts: every dX and dW, and those on the wgmma routes
B18_KEYS = ("grouped_gemm", "grouped_dgrad", "grouped_dgrad_wgmma",
            "grouped_wgrad", "grouped_wgrad_wgmma")
#: B18's kernels by count: the routes phase 32 (b) takes
B18_KERNELS = {"grouped_dgrad": "grouped_wgmma_kernel<bf16, BN, 2, KB = "
                                "true> (dX: w read in place, K-major B)",
               "grouped_wgrad": "grouped_wgrad_wgmma_kernel<bf16, BN>"}


def ft_config(torch, run, **kw):
    """The run's model config: published widths, cut in depth only."""
    from deepspeed_tpu_torch.models.llama import LlamaConfig
    from deepspeed_tpu_torch.models.registry import config_from_hf
    base = dict(dtype=torch.bfloat16, xent_impl="fused",
                attention_impl="auto")
    base.update(kw)
    if run == "tinyllama_1b":
        return LlamaConfig.tinyllama_1b(**base)
    _, cfg = config_from_hf(QWEN_MOE if run == "qwen1p5_moe"
                            else MIXTRAL_8X7B)
    return dataclasses.replace(cfg, num_layers=FT_LAYERS[run], **base)


def _ft_engine(torch, cfg, mb):
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models import llama, mixtral
    mod = mixtral if isinstance(cfg, mixtral.MixtralConfig) else llama
    _, init_fn, loss_fn = mod.make_model(cfg)
    engine, *_ = initialize(loss_fn=loss_fn, config=train_config(mb, 1),
                            params=init_fn(seed=FT_SEED, device="cuda"))
    return engine


def _ft_want(torch, cfg, fa, fx, gg, steps):
    """Each kernel's launches in ``steps`` training steps of ``cfg``: a
    flash forward and backward a layer, the three xent kernels a step,
    and on the grouped route three expert products a layer forward, their
    three data gradients and three weight gradients."""
    from deepspeed_tpu_torch.models.mixtral import MixtralConfig, moe_layer
    L = cfg.num_layers
    want = dict(flash_want(fa, cfg.head_dim, torch.bfloat16, L * steps,
                           L * steps))
    want.update(dict.fromkeys(fx.LAUNCHES, steps))
    grouped = isinstance(cfg, MixtralConfig) and \
        moe_layer(cfg).route(True) == "grouped"
    n = 3 * L * steps if grouped else 0
    # B18 at the grouped runs' prefill-sized groups (hundreds of rows an
    # expert): every dX and dW on its wgmma route
    want.update(dict.fromkeys(B18_KEYS, n))
    return want, grouped


def _ft_launches(fa, fx, gg):
    out = {**fa.LAUNCHES, **fx.LAUNCHES}
    out.update({k: gg.LAUNCHES[k] for k in B18_KEYS})
    return out


def ft_train(torch, run, trace):
    """One run's main path: 2 warm-up and 5 timed ``train_batch`` steps on
    one seeded batch, every count zeroed just before and read just after;
    then FT_PARITY_STEPS steps over fresh seeded batches on the kernel
    route and on the plain routes (``attention_impl="xla"``,
    ``xent_impl="chunked"``, the plain ``ragged_dot``; remat for
    TinyLlama's [B, H, T, T] scores), each from the same seeded weights."""
    from deepspeed_tpu_torch.moe import sharded_moe
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import fused_xent as fx
    from deepspeed_tpu_torch.ops.kernels import grouped_gemm as gg
    torch.backends.cuda.matmul.allow_tf32 = True
    mb, T = FT_RUNS[run]
    cfg = ft_config(torch, run)
    t0 = time.perf_counter()
    engine = _ft_engine(torch, cfg, mb)
    n_params = sum(p.numel() for p in engine.state.params)
    g = torch.Generator(device="cuda").manual_seed(FT_SEED)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (mb, T + 1),
                                     generator=g, device="cuda")}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    for m in (fa, fx, gg):
        m.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    losses = [engine.train_batch(batch) for _ in range(FT_WARMUP)]
    evs = [torch.cuda.Event(enable_timing=True)
           for _ in range(FT_STEPS + 1)]
    t0 = time.perf_counter()
    evs[0].record()
    for i in range(FT_STEPS):
        losses.append(engine.train_batch(batch))
        evs[i + 1].record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / FT_STEPS
    launches = _ft_launches(fa, fx, gg)
    peak = torch.cuda.max_memory_allocated()
    want, grouped = _ft_want(torch, cfg, fa, fx, gg, FT_WARMUP + FT_STEPS)
    if launches != want:
        raise AssertionError(f"[family training] {run}: launches "
                             f"{launches} != {want}")
    losses = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"[family training] {run}: losses not finite "
                             f"and falling: {losses}")
    step_ms = [evs[i].elapsed_time(evs[i + 1]) for i in range(FT_STEPS)]
    step_s = sum(step_ms) / FT_STEPS / 1e3
    out = {"params": n_params, "layers": cfg.num_layers, "micro_batch": mb,
           "seq": T, "setup_s": setup_s, "step_ms": step_ms,
           "host_wall_s": wall, "tokens_per_s": mb * T / step_s,
           "peak_bytes": peak, "losses": losses, "launches": launches,
           "launches_per_step": {k: v / (FT_WARMUP + FT_STEPS)
                                 for k, v in launches.items() if v},
           "grouped_route": grouped}
    log(f"[family training] {run}: {n_params} params, {cfg.num_layers} "
        f"layers, micro {mb} x seq {T}: step {step_s * 1e3:.1f} ms (events;"
        f" host wall {wall * 1e3:.1f} ms), {out['tokens_per_s']:.0f} "
        f"tokens/s, peak {peak / 2**30:.2f} GiB; losses "
        f"{[round(x, 5) for x in losses]}; launches {launches}")
    if trace:
        out["trace"] = _ft_trace(torch, engine, batch, run)
    del engine
    torch.cuda.empty_cache()
    # the parity: both routes from the same weights over the same fresh
    # batches (on the timed run's one batch the loss falls ~1.2 a step,
    # and Adam's first, sign-like update turns rounding into a share of
    # that fall)
    batches = [{"tokens": torch.randint(0, cfg.vocab_size, (mb, T + 1),
                                        generator=g, device="cuda")}
               for _ in range(FT_PARITY_STEPS)]
    plain_cfg = dataclasses.replace(cfg, attention_impl="xla",
                                    xent_impl="chunked",
                                    remat=run == "tinyllama_1b")
    runs = {}
    saved = sharded_moe.ragged_dot
    for route, rcfg in (("kernels", cfg), ("plain", plain_cfg)):
        if route == "plain":
            sharded_moe.ragged_dot = gg.ragged_dot_plain
        try:
            engine = _ft_engine(torch, rcfg, mb)
            runs[route] = [float(engine.train_batch(b)) for b in batches]
        finally:
            sharded_moe.ragged_dot = saved
        del engine
        torch.cuda.empty_cache()
    kern, plain = runs["kernels"], runs["plain"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(kern, plain))
    log(f"[family training] {run} parity: kernels {kern} plain {plain} "
        f"max rel {rel:.3e} (limit {FT_PARITY_REL})")
    if not rel <= FT_PARITY_REL:
        raise AssertionError(f"[family training] {run}: kernel route "
                             f"{rel} from the plain routes")
    out["parity"] = {"kernels": kern, "plain": plain, "max_rel": rel}
    return cfg, out


def _ft_trace(torch, engine, batch, run):
    """``--trace`` only: torch.profiler over one ``train_batch``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.train_batch(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = _device_summary(prof, wall, 1, top=12)
    for part in ("flash_", "xent_", "grouped_"):
        out[f"{part}ms"] = _kernel_ms_by_name(prof, part)
    log(f"[trace] family training {run}: {json.dumps(out)}")
    return out


def _flash_gqa_bound(B, T, Hh, Hk, Dh, products, n_q, n_kv, n_rows):
    """(bound ms, bound_by, bytes, flops) of a causal flash kernel at GQA:
    ``products`` matrix products a live (query, key) pair, ``n_q`` bf16
    [B, H, T, D] and ``n_kv`` bf16 [B, Hk, T, D] tensors read or written,
    ``n_rows`` fp32 [B, H, T] rows."""
    flops = 2 * Dh * products * B * Hh * T * (T + 1) // 2
    nbytes = (n_q * Hh + n_kv * Hk) * B * T * Dh * 2 + n_rows * B * Hh * T * 4
    ms, by = _bound(nbytes, flops, BF16_FLOPS_PER_S)
    return ms, by, nbytes, flops


def ft_flash(torch, run, cfg, mb, T):
    """Flash forward and backward at the run's GQA shape against their
    plain versions (bf16), then timed by events and in a CUDA graph beside
    the plain versions and SDPA with ``enable_gqa`` (forward, and its
    backward as ``_sdpa_bwd_ms`` takes it)."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    Hh, Hk, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v, do = flash_inputs(torch, B=mb, Tq=T, Tk=T, H=Hh, Hk=Hk, D=Dh,
                               dtype=torch.bfloat16, seed=T + Hk)
    kw = dict(causal=True, sm_scale=Dh ** -0.5)
    got = flash_all(fa, q, k, v, do, plain=False, **kw)
    ref = flash_all(fa, q, k, v, do, plain=True, **kw)
    errs = {"flash_fwd": 0.0, "flash_bwd": 0.0}
    for (name, part), g_, r_ in zip(flash_outputs(fa, Dh, torch.bfloat16),
                                    got, ref):
        # dK and dV sum H / Hk query heads: their outputs grow with the
        # group, so the bf16 limit is the larger of the flash limit and
        # 2**-7 of the largest output (as the grouped GEMM's)
        lim = max(FLASH_BF16_MAX_ABS,
                  GROUPED_BF16_REL * r_.float().abs().max().item())
        e = check_close(torch, f"[family training] {run} {name} {part} "
                        f"B{mb} T{T} H{Hh}/{Hk} D{Dh}", g_, r_,
                        bf16_max_abs=lim)
        key = "flash_fwd" if name == "flash_fwd" else "flash_bwd"
        errs[key] = max(errs[key], e)
    o, lse = ref[0], ref[1]
    del got, ref
    sdpa = dict(is_causal=True)
    try:
        F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **sdpa)
        sdpa["enable_gqa"] = True
    except TypeError:
        sdpa = None
    out = {}
    for name, kern, plain, work in (
            ("flash_fwd", lambda: fa.flash_fwd(q, k, v, **kw),
             lambda: fa.flash_fwd_plain(q, k, v, **kw), (2, 2, 2, 1)),
            ("flash_bwd", lambda: fa.flash_bwd(q, k, v, do, o, lse, None,
                                               **kw),
             lambda: fa.flash_bwd_plain(q, k, v, do, o, lse, None, **kw),
             (5, 4, 4, 2))):
        bound, by, nbytes, flops = _flash_gqa_bound(mb, T, Hh, Hk, Dh,
                                                    *work)
        r = {"shape": {"B": mb, "T": T, "H": Hh, "Hk": Hk, "D": Dh,
                       "dtype": "bf16", "causal": True},
             "max_abs_err": errs[name], "ms": _time_ms(torch, kern, 10),
             "graph_ms": _graph_ms(torch, [kern], reps=10),
             "plain_ms": _time_ms(torch, plain, 2), "bound_ms": bound,
             "bound_by": by, "bytes": nbytes, "flops": flops,
             "library_ms": None, "library_graph_ms": None}
        if sdpa is not None and name == "flash_fwd":
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, **sdpa)
            r["library_ms"] = _time_ms(torch, lib, 10)
            r["library_graph_ms"] = _graph_ms(torch, [lib], reps=10)
        elif sdpa is not None:
            r["library_ms"], r["library_graph_ms"] = _sdpa_bwd_ms(
                torch, q, k, v, do, **sdpa)
        r["bound_share"] = bound / r["graph_ms"]
        out[name] = r
        log(f"[family training] {run} {name} GQA {Hh}/{Hk} D{Dh}: "
            f"{r['ms']:.4f} ms (graph {r['graph_ms']:.4f}, plain "
            f"{r['plain_ms']:.4f}, SDPA {r['library_ms']}, graph "
            f"{r['library_graph_ms']}); bound {bound:.4f} by {by}, "
            f"{r['bound_share']:.1%} of it")
    return out


def ft_xent(torch, run, cfg, mb, T):
    """The fused xent's three kernels at the run's (N, V, C) in bf16
    against their plain versions."""
    from deepspeed_tpu_torch.ops.kernels import fused_xent as fx
    N, V, C = mb * T, cfg.vocab_size, cfg.hidden_size
    h, e, t = xent_inputs(torch, N=N, V=V, C=C, dtype=torch.bfloat16,
                          seed=V, bad_ids=False)
    scale = torch.tensor([1.0 / N], device="cuda")
    kw = dict(ignore=None, z=0.0, eps=0.0)
    got = xent_all(fx, h, e, t, scale, plain=False, **kw)
    ref = xent_all(fx, h, e, t, scale, plain=True, **kw)
    return check_xent(torch, f"[family training] {run} N{N} V{V} C{C}",
                      "bf16", got, ref)


def _b18_routing(torch, gg, tokens, k, E, dead, seed):
    """Offsets of ``tokens`` routed top-k over E experts by seeded logits,
    the last ``dead`` experts never picked."""
    from deepspeed_tpu_torch.moe import sharded_moe
    g = torch.Generator(device="cuda").manual_seed(seed)
    logits = torch.randn(tokens, E, generator=g, device="cuda")
    logits[:, E - dead:] = -1e4
    top = torch.topk(logits, k, dim=-1).indices.reshape(-1)
    return sharded_moe.group_offsets(top, E), g


def _grouped_mm_lib(torch, fn, check, tol):
    """``torch._grouped_mm`` as ``fn`` computes it, if this torch has it
    and it agrees with ``check`` within ``tol``; else None (timed only,
    never on the path)."""
    if not hasattr(torch, "_grouped_mm"):
        return None
    try:
        y = fn()
        if (y.float() - check.float()).abs().max().item() > tol:
            raise RuntimeError("disagrees with the kernel")
        return fn
    except RuntimeError as exc:
        log(f"[B18] torch._grouped_mm refused: {exc}")
        return None


def time_b18(torch, gg, name, *, tokens, k, E, K, N, dead):
    """B18, both directions, at one expert-product shape: x [R, K] routed
    rows, w [E, K, N], dy [R, N] bf16 (R = tokens k, the last ``dead``
    experts empty). dX (``ragged_dot_dgrad``: the forward's kernels over w
    read in place as its transpose, on ``grouped_plan``'s route) and dW
    (``ragged_dot_wgrad``: ``wgrad_plan``'s) against fp32 references
    within 2**-7 of the largest magnitude and against their bf16 plain
    twins; dW of an empty expert exactly zero; a group whose length is no
    multiple of the tiles; each bit-identical between two calls; both on
    their wgmma routes (``LAUNCHES``). Timed by events and in a CUDA graph
    beside the plain twins and ``torch._grouped_mm``."""
    off, g = _b18_routing(torch, gg, tokens, k, E, dead, len(name) + K)
    R = tokens * k
    x = torch.randn(R, K, generator=g, device="cuda").to(torch.bfloat16)
    w = (torch.randn(E, K, N, generator=g, device="cuda")
         * K ** -0.5).to(torch.bfloat16)
    dy = torch.randn(R, N, generator=g, device="cuda").to(torch.bfloat16)
    sizes = (off[1:] - off[:-1]).tolist()
    live = sum(1 for s in sizes if s)
    if sizes.count(0) < 1 or all(s % 32 == 0 for s in sizes):
        raise AssertionError(f"[B18] {name}: want an empty expert and a "
                             f"ragged group, got {sizes}")
    gg.reset_launch_counts()
    dx, dw = gg.ragged_dot_dgrad(dy, w, off), gg.ragged_dot_wgrad(x, dy, off)
    dx2, dw2 = gg.ragged_dot_dgrad(dy, w, off), gg.ragged_dot_wgrad(x, dy,
                                                                     off)
    torch.cuda.synchronize()
    if any(gg.LAUNCHES[k] != 2 for k in B18_KEYS[1:]):
        raise AssertionError(f"[B18] {name}: launches {gg.LAUNCHES}, want "
                             f"two of each, on the wgmma routes")
    from deepspeed_tpu_torch.utils.device import sm_count
    plans = {"grouped_dgrad": gg.grouped_plan(R, E, K, torch.bfloat16,
                                              sm_count(x.device))._asdict(),
             "grouped_wgrad": gg.wgrad_plan(R, E, K, N, torch.bfloat16,
                                            sm_count(x.device))._asdict()}
    wt = w.transpose(1, 2).contiguous()
    refs = {"grouped_dgrad": gg.ragged_dot_plain(dy.float(), wt.float(), off),
            "grouped_wgrad": gg.ragged_dot_wgrad_plain(x.float(), dy.float(),
                                                       off)}
    twins = {"grouped_dgrad": lambda: gg.ragged_dot_plain(dy, wt, off),
             "grouped_wgrad": lambda: gg.ragged_dot_wgrad_plain(x, dy, off)}
    got = {"grouped_dgrad": (dx, dx2), "grouped_wgrad": (dw, dw2)}
    for e, s in enumerate(sizes):
        if s == 0 and dw[e].any():
            raise AssertionError(f"[B18] {name}: dW of empty expert {e} "
                                 f"not zero")
    ends = off[1:].contiguous()
    libs = {"grouped_dgrad": lambda: torch._grouped_mm(
                dy, w.transpose(1, 2), offs=ends),
            "grouped_wgrad": lambda: torch._grouped_mm(
                x.t(), dy, offs=ends)}
    calls = {"grouped_dgrad": lambda: gg.ragged_dot_dgrad(dy, w, off),
             "grouped_wgrad": lambda: gg.ragged_dot_wgrad(x, dy, off)}
    el = 2
    work = {"grouped_dgrad": (R * N * el + live * K * N * el + R * K * el,
                              2 * R * K * N),
            "grouped_wgrad": (R * K * el + R * N * el + E * K * N * el,
                              2 * R * K * N)}
    out = {}
    for kname in ("grouped_dgrad", "grouped_wgrad"):
        a, b = got[kname]
        ref = refs[kname]
        top = ref.abs().max().item()
        err = (a.float() - ref).abs().max().item()
        twin = twins[kname]()
        twin_err = (a.float() - twin.float()).abs().max().item()
        lim = GROUPED_BF16_REL * top
        log(f"[B18] {name} {kname}: R={R} over E={E} ({live} routed), K={K}"
            f" N={N}: max_abs_err {err:.3e} against fp32, {twin_err:.3e} "
            f"against the plain twin (limit {lim:.3e}); rows an expert "
            f"{min(sizes)}-{max(sizes)}")
        if not (err <= lim and twin_err <= lim):
            raise AssertionError(f"[B18] {name} {kname} disagrees: {err}, "
                                 f"{twin_err}")
        if not torch.equal(a, b):
            raise AssertionError(f"[B18] {name} {kname}: two calls differ")
        lib = _grouped_mm_lib(torch, libs[kname], a, lim)
        nbytes, flops = work[kname]
        bound_ms, by = _bound(nbytes, flops, BF16_FLOPS_PER_S)
        r = {"max_abs_err": err, "twin_max_abs_err": twin_err,
             "ms": _time_ms(torch, calls[kname], 10),
             "graph_ms": _graph_ms(torch, [calls[kname]], reps=10),
             "plain_ms": _time_ms(torch, twins[kname], 2),
             "library_ms": _time_ms(torch, lib, 10) if lib else None,
             "library_graph_ms": _graph_ms(torch, [lib], reps=10)
             if lib else None,
             "bound_ms": bound_ms, "bound_by": by, "bytes": nbytes,
             "flops": flops, "kernel": B18_KERNELS[kname],
             "plan": plans[kname],
             "shape": {"R": R, "tokens": tokens, "k": k, "E": E,
                       "routed": live, "K": K, "N": N, "dtype": "bf16",
                       "rows_min": min(sizes), "rows_max": max(sizes)}}
        r["graph_bound_share"] = bound_ms / r["graph_ms"]
        log(f"[B18] {name} {kname}: {r['ms']:.4f} ms (graph "
            f"{r['graph_ms']:.4f}; plain {r['plain_ms']:.4f}; "
            f"torch._grouped_mm {r['library_ms']}, graph "
            f"{r['library_graph_ms']}); bound {bound_ms:.4f} by {by}, "
            f"{r['graph_bound_share']:.1%} of it in the graph")
        out[kname] = r
    return out


def ft_grouped_sync(torch, cfg, mb, T):
    """The grouped MoE layer's forward and backward at run (b)'s shapes
    under ``torch.cuda.set_sync_debug_mode("error")``: no device value
    reaches the host on the grouped path (offsets, the kernels, B18)."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.moe import sharded_moe
    g = torch.Generator(device="cuda").manual_seed(FT_SEED + 1)
    M, E, I = cfg.hidden_size, cfg.num_experts, cfg.intermediate_size
    S = mb * T

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(
            torch.bfloat16).requires_grad_()
    tokens = rnd(S, M)
    ws = (rnd(E, M, I, scale=M ** -0.5), rnd(E, M, I, scale=M ** -0.5),
          rnd(E, I, M, scale=I ** -0.5))
    wg = torch.randn(M, E, generator=g, device="cuda") * M ** -0.5
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, l_aux = sharded_moe.grouped_moe_ffn(
            tokens, tokens.float() @ wg, cfg.experts_top_k, ws, F.silu,
            torch.bfloat16, normalize_weights=False)
        (y.float().square().mean() + l_aux).backward()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    ok = all(torch.isfinite(t.grad.float()).all().item()
             for t in (tokens, *ws))
    log(f"[family training] grouped path forward + backward at S={S}, "
        f"E={E}, top-{cfg.experts_top_k}: no host sync; grads finite {ok}")
    if not ok:
        raise AssertionError("[family training] grouped path grads not "
                             "finite")
    return True


def phase_family_training(torch, trace):
    """Phase 32: train the Llama and MoE families on the card through
    their ``make_model`` entry points and ``Engine.train_batch`` (module
    docstring), hold every kernel of each run against its plain version at
    the run's shapes, and time B18 and the flash kernels at GQA."""
    from deepspeed_tpu_torch.ops.kernels import grouped_gemm as gg
    out, rows = {}, []
    for run in FT_RUNS:
        mb, T = FT_RUNS[run]
        cfg, r = ft_train(torch, run, trace)
        r["xent_max_abs_err"] = ft_xent(torch, run, cfg, mb, T)
        if run != "qwen1p5_moe":
            r["flash_gqa"] = ft_flash(torch, run, cfg, mb, T)
        else:
            K, N = cfg.hidden_size, cfg.intermediate_size
            r["grouped_fwd"] = time_grouped(
                torch, gg, "qwen1p5_moe_train_gate_up", tokens=mb * T,
                k=cfg.experts_top_k, E=cfg.num_experts, K=K, N=N, dead=3)
            b18 = {"gate_up": time_b18(
                       torch, gg, "qwen1p5_moe_train_gate_up",
                       tokens=mb * T, k=cfg.experts_top_k,
                       E=cfg.num_experts, K=K, N=N, dead=3),
                   "down": time_b18(
                       torch, gg, "qwen1p5_moe_train_down", tokens=mb * T,
                       k=cfg.experts_top_k, E=cfg.num_experts, K=N, N=K,
                       dead=3)}
            b18["mixtral_expert"] = time_b18(
                torch, gg, "mixtral_8x7b_expert", tokens=B18_MIXTRAL[0],
                k=B18_MIXTRAL[1], E=B18_MIXTRAL[2], K=B18_MIXTRAL[3],
                N=B18_MIXTRAL[4], dead=1)
            r["b18"] = b18
            r["grouped_no_sync"] = ft_grouped_sync(torch, cfg, mb, T)
            for kname in ("grouped_dgrad", "grouped_wgrad"):
                row = dict(b18["gate_up"][kname])
                row.update(name=kname, route="cuda", source=GROUPED_SOURCE,
                           replaces=B18_REPLACES,
                           launches=r["launches"][kname],
                           launches_wgmma=r["launches"][kname + "_wgmma"],
                           launches_per_step=r["launches_per_step"][kname],
                           launches_from=f"phase 32 {run}",
                           down=b18["down"][kname],
                           mixtral_expert=b18["mixtral_expert"][kname])
                rows.append(row)
        out[run] = r
        torch.cuda.empty_cache()
    return out, rows


# --------------------------------------------------- resumable training

#: phase 33: phase 32 (a)'s TinyLlama-1.1B run saved and resumed. Steps
#: before the save and after it; the async save's extra steps; the
#: preempted worker's depth (of 22 layers), its steps and the step it
#: sends itself SIGTERM before; the seeds of the batches and of the
#: second engine's weights
RT_STEPS, RT_ASYNC_STEPS = 3, 2
RT_WORKER_LAYERS, RT_WORKER_STEPS, RT_WORKER_SIGTERM = 2, 6, 3
RT_SEED, RT_OTHER_SEED = 33, 34
#: resumed losses against the uninterrupted ones: phase 32's bound
#: between routes (the bf16 flash backward's dQ is not bit-identical
#: from call to call)
RT_REL = FT_PARITY_REL
#: free space the phase needs beyond its two tags (the worker's tags)
RT_DISK_MARGIN = 8 << 30
RT_WORKER_TIMEOUT_S = 600


def _rt_engine(torch, cfg, mb, seed, **ds):
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models import llama
    _, init_fn, loss_fn = llama.make_model(cfg)
    engine, *_ = initialize(loss_fn=loss_fn, config={**train_config(mb, 1),
                                                     **ds},
                            params=init_fn(seed=seed, device="cuda"))
    return engine


def _rt_batches(torch, cfg, mb, T, n):
    g = torch.Generator(device="cuda").manual_seed(RT_SEED)
    return [{"tokens": torch.randint(0, cfg.vocab_size, (mb, T + 1),
                                     generator=g, device="cuda")}
            for _ in range(n)]


def _rt_digest(torch, engine):
    """A digest of every leaf of the engine's state, on the card, by its
    path in the checkpoint: a tensor's bits as integers summed plain,
    position-weighted and squared (int64, wrapping); a scalar as itself."""
    from deepspeed_tpu_torch.checkpoint import engine_checkpoint as ec
    words = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = {}
    for path, v, _ in ec.state_leaves(engine):
        if not isinstance(v, torch.Tensor):
            out[path] = v
            continue
        w = v.detach().reshape(-1).view(words[v.element_size()]).long()
        pos = torch.arange(w.numel(), device=w.device) % 1000003 + 1
        out[path] = torch.stack([w.sum(), (w * pos).sum(),
                                 (w * w).sum()]).tolist()
    return out


def _rt_steps(torch, engine, batches):
    """``train_batch`` over ``batches``: the losses and each step's ms by
    CUDA events."""
    evs = [torch.cuda.Event(enable_timing=True)
           for _ in range(len(batches) + 1)]
    evs[0].record()
    losses = []
    for i, b in enumerate(batches):
        losses.append(engine.train_batch(b))
        evs[i + 1].record()
    torch.cuda.synchronize()
    return [float(x) for x in losses], \
        [evs[i].elapsed_time(evs[i + 1]) for i in range(len(batches))]


def _rt_stats(engine, what):
    """The engine's split times of its last save or load, the host bytes
    as ``host_bytes``."""
    out = dict(engine.checkpoint_stats[what])
    out["host_bytes"] = out.pop("bytes", None)
    return out


def _rt_tag_bytes(path):
    return sum(f.stat().st_size for f in Path(path).iterdir())


def rt_worker() -> int:
    """Phase 33 (c)'s worker (a subprocess under ``run_elastic``; set up
    by env): TinyLlama at RT_WORKER_LAYERS of its 22 layers at published
    widths, with ``resilience.preemption`` (urgent saves to
    RT_SAVE_DIR) and ``resilience.watchdog`` (heartbeat RT_HEARTBEAT);
    resumes from RT_SAVE_DIR, sends itself SIGTERM before step
    RT_WORKER_SIGTERM, runs to step RT_WORKER_STEPS and writes its
    progress to RT_PROGRESS."""
    import os
    import signal
    import torch
    sys.path.insert(0, str(ROOT))
    save_dir, hb = os.environ["RT_SAVE_DIR"], os.environ["RT_HEARTBEAT"]
    mb, T = FT_RUNS["tinyllama_1b"]
    cfg = ft_config(torch, "tinyllama_1b", num_layers=RT_WORKER_LAYERS)
    engine = _rt_engine(torch, cfg, mb, FT_SEED, resilience={
        "preemption": {"enabled": True, "save_dir": save_dir},
        "watchdog": {"enabled": True, "check_interval_s": 0.5,
                     "heartbeat_file": hb}})
    path, _ = engine.load_checkpoint(save_dir)
    batches = _rt_batches(torch, cfg, mb, T, RT_WORKER_STEPS)
    progress = {"resumed_from": path, "losses": {}}
    while engine.global_steps < RT_WORKER_STEPS:
        if engine.global_steps + 1 == RT_WORKER_SIGTERM and path is None:
            os.kill(os.getpid(), signal.SIGTERM)   # before this step
        step = engine.global_steps
        loss = float(engine.train_batch(batches[step]))
        progress["losses"][step + 1] = loss
        progress["global_steps"] = engine.global_steps
        with open(os.environ["RT_PROGRESS"], "a") as f:
            f.write(json.dumps(progress) + "\n")
    return 0


def phase_resumable_training(torch):
    """Phase 33: (a) a sync save of phase 32 (a)'s TinyLlama run at step
    RT_STEPS and its resume on a second engine, every leaf bit-equal; (b)
    an async save with steps over the writer; (c) a preempted worker
    restarted under ``run_elastic``."""
    import tempfile
    from deepspeed_tpu_torch.checkpoint import (engine_checkpoint as ec,
                                                validate_checkpoint_dir)
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import fused_xent as fx
    from deepspeed_tpu_torch.ops.kernels import grouped_gemm as gg
    torch.backends.cuda.matmul.allow_tf32 = True
    mb, T = FT_RUNS["tinyllama_1b"]
    cfg = ft_config(torch, "tinyllama_1b")
    work = Path(tempfile.mkdtemp(prefix=".phase33-", dir=ROOT))
    out = {"layers": cfg.num_layers, "micro_batch": mb, "seq": T}
    try:
        # ---------------------------------------------------- (a) sync
        n = 2 * RT_STEPS + RT_ASYNC_STEPS
        batches = _rt_batches(torch, cfg, mb, T, n)
        engine = _rt_engine(torch, cfg, mb, FT_SEED)
        state_bytes = sum(v.numel() * v.element_size()
                          for _, v, _ in ec.state_leaves(engine)
                          if isinstance(v, torch.Tensor))
        free = shutil.disk_usage(work).free
        need = 2 * state_bytes + RT_DISK_MARGIN
        log(f"[resumable] {work}: {free / 2**30:.1f} GiB free, "
            f"{need / 2**30:.1f} GiB needed (two tags of "
            f"{state_bytes / 2**30:.2f} GiB and the worker's)")
        out.update(params=sum(p.numel() for p in engine.state.params),
                   state_bytes=state_bytes, disk_free_bytes=free)
        if free < need:
            raise AssertionError(f"[resumable] {free} bytes free under "
                                 f"{work}, {need} needed")
        for m in (fa, fx, gg):
            m.reset_launch_counts()
        first, _ = _rt_steps(torch, engine, batches[:RT_STEPS])
        save_dir = work / "ckpt"
        with _RssPeak() as rss:
            t0 = time.perf_counter()
            path = engine.save_checkpoint(str(save_dir))
            save_s = time.perf_counter() - t0
        tag = Path(path).name
        out["sync"] = {"tag": tag, "save_s": save_s,
                       **_rt_stats(engine, "save"),
                       "bytes": _rt_tag_bytes(path),
                       "host_rss_peak_bytes": rss.peak,
                       "host_rss_delta_bytes": rss.delta}
        saved = _rt_digest(torch, engine)
        lr, counters = engine.get_lr()[0], (engine.global_steps,
                                            engine.global_samples)
        want, a_ms = _rt_steps(torch, engine, batches[RT_STEPS:2 * RT_STEPS])
        del engine
        torch.cuda.empty_cache()
        engine = _rt_engine(torch, cfg, mb, RT_OTHER_SEED,
                            checkpoint={"async_save": True})
        with _RssPeak() as rss:
            t0 = time.perf_counter()
            loaded, _ = engine.load_checkpoint(str(save_dir))
            load_s = time.perf_counter() - t0
        out["load"] = {"load_s": load_s, **_rt_stats(engine, "load"),
                       "host_rss_peak_bytes": rss.peak,
                       "host_rss_delta_bytes": rss.delta}
        got = _rt_digest(torch, engine)
        bad = [p for p in saved if got.get(p) != saved[p]]
        if Path(loaded).name != tag or bad or set(got) != set(saved):
            raise AssertionError(f"[resumable] loaded {loaded}: leaves "
                                 f"differ from the saved state: {bad[:8]}")
        if (engine.get_lr()[0], (engine.global_steps,
                                 engine.global_samples)) != (lr, counters):
            raise AssertionError(f"[resumable] lr / counters after the "
                                 f"load: {engine.get_lr()[0]} "
                                 f"{engine.global_steps} != {lr} {counters}")
        resumed, _ = _rt_steps(torch, engine,
                               batches[RT_STEPS:2 * RT_STEPS])
        rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, want))
        out.update(leaves=len(saved), bit_equal=True, lr=lr,
                   losses={"first": first, "uninterrupted": want,
                           "resumed": resumed, "max_rel": rel},
                   step_ms=a_ms)
        log(f"[resumable] (a) {tag}: {out['sync']['bytes']} bytes, save "
            f"{save_s:.2f} s {json.dumps(out['sync'])}; load "
            f"{load_s:.2f} s {json.dumps(out['load'])}; "
            f"{len(saved)} leaves bit-equal; losses {want} resumed "
            f"{resumed} (max rel {rel:.3e}, limit {RT_REL}); step ms "
            f"{[round(x, 2) for x in a_ms]}")
        if not rel <= RT_REL:
            raise AssertionError(f"[resumable] resumed losses {rel} from "
                                 f"the uninterrupted run")
        # --------------------------------------------------- (b) async
        t0 = time.perf_counter()
        path = engine.save_checkpoint(str(save_dir))
        hold_s = time.perf_counter() - t0
        ck = engine._ckpt_engine
        losses, b_ms = _rt_steps(torch, engine, batches[2 * RT_STEPS:])
        overlapped = ck._thread is not None and ck._thread.is_alive()
        t0 = time.perf_counter()
        ck.commit()
        commit_s = time.perf_counter() - t0
        ok, reason = validate_checkpoint_dir(path, deep=True)
        latest = (save_dir / ec.LATEST_FILE).read_text()
        out["async"] = {"tag": Path(path).name, "hold_s": hold_s,
                        "commit_wait_s": commit_s,
                        **_rt_stats(engine, "save"),
                        "bytes": _rt_tag_bytes(path), "step_ms": b_ms,
                        "writer_ran_over_steps": overlapped,
                        "losses": losses, "valid": ok}
        log(f"[resumable] (b) async {Path(path).name}: save_checkpoint "
            f"held {hold_s:.2f} s, steps {[round(x, 2) for x in b_ms]} ms "
            f"over the writer ({overlapped}) against (a)'s "
            f"{[round(x, 2) for x in a_ms]}, commit waited "
            f"{commit_s:.2f} s; {json.dumps(out['async'])}; {reason}")
        if not ok or latest != Path(path).name or \
                not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"[resumable] async tag: {reason}, latest "
                                 f"{latest}, losses {losses}")
        launches = _ft_launches(fa, fx, gg)
        # engine one's 2 x RT_STEPS steps, engine two's RT_STEPS resumed
        # and RT_ASYNC_STEPS over the writer
        expect, _ = _ft_want(torch, cfg, fa, fx, gg,
                             3 * RT_STEPS + RT_ASYNC_STEPS)
        out["launches"] = launches
        if launches != expect:
            raise AssertionError(f"[resumable] launches {launches} != "
                                 f"{expect}")
        del engine, ck
        torch.cuda.empty_cache()
        shutil.rmtree(save_dir)
        # ------------------------------------------- (c) the preempted
        out["preempted"] = rt_preempted(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def rt_preempted(work):
    """Phase 33 (c): ``rt_worker`` under ``run_elastic``; the checks of
    the module docstring."""
    import os
    from deepspeed_tpu_torch.checkpoint import find_valid_tag
    from deepspeed_tpu_torch.elasticity import run_elastic
    save_dir, ledger = work / "worker", work / "ledger.json"
    hb, progress = work / "heartbeat.json", work / "progress.jsonl"
    env = {"RT_SAVE_DIR": str(save_dir), "RT_HEARTBEAT": str(hb),
           "RT_PROGRESS": str(progress),
           "PYTHONPATH": str(ROOT) + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    cmd = [sys.executable, "-c", "import sys, chip_smoke; "
           "sys.exit(chip_smoke.rt_worker())"]
    t0 = time.perf_counter()
    rc = run_elastic(cmd, {"max_train_batch_size": 8,
                           "micro_batch_sizes": [FT_RUNS["tinyllama_1b"][0]],
                           "min_gpus": 1, "max_gpus": 1, "version": 0.1},
                     max_restarts=2, min_restart_interval_s=0.0,
                     crash_loop_budget=1, ledger_path=str(ledger), env=env)
    wall = time.perf_counter() - t0
    events = json.loads(ledger.read_text())["events"]
    kinds = [e["event"] for e in events]
    restart = next((e for e in events if e["event"] == "restart"), {})
    runs = [json.loads(x) for x in progress.read_text().splitlines()]
    tag = find_valid_tag(str(save_dir))
    out = {"rc": rc, "wall_s": wall, "events": kinds,
           "restart": {k: restart.get(k) for k in
                       ("rc", "membership_change", "runtime_s")},
           "tag": tag, "final_steps": runs[-1]["global_steps"],
           "resumed_from": runs[-1]["resumed_from"],
           "losses": runs[-1]["losses"], "heartbeat": hb.exists(),
           "layers": RT_WORKER_LAYERS}
    log(f"[resumable] (c) agent rc {rc} in {wall:.1f} s: {kinds}, restart "
        f"{out['restart']}, resumed from {out['resumed_from']} to step "
        f"{out['final_steps']}, valid tag {tag}, heartbeat {out['heartbeat']}")
    if not (rc == 0 and tag == f"global_step{RT_WORKER_SIGTERM}"
            and restart.get("rc") == 99 and restart.get("membership_change")
            is True and kinds[-1] == "success"
            and out["final_steps"] == RT_WORKER_STEPS
            and Path(out["resumed_from"] or "").name == tag
            and out["heartbeat"]):
        raise AssertionError(f"[resumable] the preempted worker: {out}")
    return out


def main(argv) -> int:
    unknown = [a for a in argv
               if a not in ("--trace", "--fp6-sweep", "--norm-sweep",
                            "--paged-rows")]
    if unknown:
        print(f"chip_smoke: unknown arguments {unknown} (only --trace, "
              f"--fp6-sweep, --norm-sweep, --paged-rows)", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (ROOT / "deepspeed_tpu_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(deepspeed_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.manual_seed(0)              # the kernel inputs' torch.randn
    t_all = time.perf_counter()
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    tracing = "--trace" in argv
    phase_s = {}
    if "--fp6-sweep" in argv:
        phase_build()
        print(json.dumps({"fp6_sweep": fp6_plan_sweep(torch), "card": card}),
              flush=True)
        return 0
    if "--paged-rows" in argv:
        print(json.dumps({"paged_rows": paged_rows(torch), "card": card}),
              flush=True)
        return 0
    if "--norm-sweep" in argv:
        phase_build()
        print(json.dumps({"norm_sweep": norm_plan_sweep(torch),
                          "card": card}), flush=True)
        return 0

    def run(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[fn.__name__] = time.perf_counter() - t0
        log(f"[phase] {fn.__name__}: {phase_s[fn.__name__]:.1f} s")
        return out

    run(phase_build)
    worst = run(phase_parity, torch)
    flash_worst = run(phase_flash_parity, torch)
    xent_worst = run(phase_xent_parity, torch)
    serving, eng, prompts = run(phase_serving, torch)
    trace = run(phase_trace, torch, eng, prompts) if tracing else None
    del eng
    torch.cuda.empty_cache()
    run(phase_engine_parity, torch)
    rows = run(phase_timing, torch, serving, worst)
    train = run(phase_training, torch, tracing)
    train_parity = run(phase_training_parity, torch)
    rows += run(phase_flash_timing, torch, train, flash_worst)
    bench = run(phase_gpt1p3b, torch, tracing)
    fused_parity = run(phase_fused_training_parity, torch)
    rows += run(phase_xent_timing, torch, bench, xent_worst)
    woq_worst = run(phase_woq_parity, torch)
    woq = run(phase_woq_serving, torch, tracing)
    woq_parity = run(phase_woq_engine_parity, torch)
    rows += run(phase_woq_timing, torch, woq, woq_worst, rows)
    rows += run(phase_norm_ops, torch)
    rows += run(phase_adamw_op, torch)
    rows += run(phase_sparse_op, torch)
    rows += run(phase_evoformer_op, torch)
    c1, c1_rows = run(phase_c1_shapes, torch)
    rows += c1_rows
    kv_pool, kv_rows = run(phase_kv_pool, torch, woq, tracing)
    rows += kv_rows
    hf, hf_rows, hf_ctx = run(phase_hf_serving, torch)
    rows += hf_rows
    try:
        prefix, prefix_rows = run(phase_prefix_serving, torch, hf_ctx)
    finally:
        shutil.rmtree(hf_ctx.pop("dir"), ignore_errors=True)
    del hf_ctx
    torch.cuda.empty_cache()
    rows += prefix_rows
    gpt2, gpt2_rows = run(phase_gpt2_serving, torch)
    rows += gpt2_rows
    spec, spec_rows = run(phase_spec_decoding, torch)
    rows += spec_rows
    families, family_rows = run(phase_family_serving, torch)
    rows += family_rows
    moe, moe_rows = run(phase_moe_serving, torch)
    rows += moe_rows
    fleet, fleet_rows, weights = run(phase_fleet_serving, torch)
    rows += fleet_rows
    loadgen, loadgen_rows = run(phase_loadgen, torch, weights, train)
    del weights
    rows += loadgen_rows
    family_training, ft_rows = run(phase_family_training, torch, tracing)
    rows += ft_rows
    resumable = run(phase_resumable_training, torch)
    for r in rows:
        if r["name"] in resumable["launches"]:
            r["launches_phase33"] = resumable["launches"][r["name"]]
        if r["name"] in ("flash_fwd", "flash_bwd"):
            r["gqa"] = {run: t["flash_gqa"][r["name"]] for run, t in
                        family_training.items() if "flash_gqa" in t}
    log(f"[total] {time.perf_counter() - t_all:.1f} s")
    result = {"kernels": rows, "card": card, "phase_s": phase_s,
              "serving": {k: serving[k] for k in
                          ("prefill_s", "decode_s", "decode_tokens",
                           "peak_bytes", "steps")},
              "training": {k: v for k, v in train.items() if k != "trace"},
              "training_parity": train_parity,
              "gpt1p3b": {k: ({kk: vv for kk, vv in v.items()
                               if kk != "trace"} if isinstance(v, dict)
                              else v) for k, v in bench.items()},
              "fused_training_parity": fused_parity,
              "woq_serving": {m: {k: v for k, v in r.items() if k != "trace"}
                              for m, r in woq.items()},
              "woq_engine_parity": woq_parity, "c1": c1,
              "kv_pool": {k: v for k, v in kv_pool.items() if k != "timing"},
              "hf_serving": hf, "prefix_serving": prefix,
              "gpt2_serving": gpt2, "spec_decoding": spec,
              "family_serving": families, "moe_serving": moe,
              "fleet_serving": fleet, "loadgen": loadgen,
              "family_training": {run: {k: v for k, v in r.items()
                                        if k != "trace"}
                                  for run, r in family_training.items()},
              "resumable_training": resumable}
    if trace is not None:
        result["trace"] = trace
        result["train_trace"] = train["trace"]
        result["gpt1p3b_trace"] = bench["fused"]["trace"]
        result["woq_trace"] = {m: r["trace"] for m, r in woq.items()}
        result["kv_pool_trace"] = kv_pool["llama2_7b_int8"].pop("trace")
        result["family_training_trace"] = {
            run: r["trace"] for run, r in family_training.items()}
    print(json.dumps(result), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
