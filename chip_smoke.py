#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py          # from the repository root, one card
    python3 chip_smoke.py --parent DIR
        # DIR: a checkout of the parent revision; phase 1 also builds its
        # flash_attention.cu, flash_chunk.cu and fused_ce.cu, phases 9, 13
        # and 21 time its bf16 attention kernels and its bf16 fused CE
        # forward in turns with this revision's (phase 21 also compares
        # B8/B9's outputs bit for bit), and phase 22 times four training
        # steps with its kernels in turns

The main paths, all BLOOM-560m at full width (vocab 250880, hidden 1024,
24 layers, 16 heads) with random weights made from seed 0:

- serving: ``pipegoose_tpu_torch.serving.ServingEngine`` with chunked
  prefill over a paged KV pool, every attention read going through the
  hand-written CUDA paged-attention kernel, and with int8 or int4 weights
  (``weight_dtype``) every block product through the hand-written CUDA
  quantized-matmul kernels, chunked or with the monolithic prefill; with
  the prefix cache and self-speculative decoding, whose draft steps,
  verifications and copied-on-write tails read through the same kernel;
- training: ``pipegoose_tpu_torch.trainer.train_step`` (loss, backward,
  Adam), its attention going through the hand-written CUDA flash-attention
  forward, dQ and dK/dV kernels, and with ``fused_ce`` its loss through the
  hand-written CUDA fused cross-entropy forward, d-hidden and d-weight
  kernels (in bf16 the forward on warpgroup MMAs fed by TMA, the latter two
  on the tensor cores, a thread-block cluster splitting H);
- sequence-parallel training: ``pipegoose_tpu_torch.trainer.sp_train_step``
  over a ``ParallelContext`` (one rank over NCCL, sp = 1: the driver's
  machine has one card), its attention the ring of ``ring_flash_attention``
  through the hand-written CUDA ring-chunk forward, dQ and dK/dV kernels;
- hybrid tensor x data parallel training with ZeRO-1:
  ``pipegoose_tpu_torch.parallel.make_hybrid_train_step`` over a
  ``ParallelContext`` with the "tensor" and "data" axes named (one rank:
  tp = dp = 1 on one card), the loss tensor-parallel through the flash and
  fused cross-entropy kernels, the optimizer ``DistributedOptimizer``;
  every kernel a tp = 2 or 4 rank launches is also checked at its shard
  shape against the whole;
- the Trainer: ``pipegoose_tpu_torch.trainer.Trainer.fit`` over that
  hybrid step, fed by the port's ``data.TokenDataset`` on its native
  route, with its callbacks, checkpoints (``utils.checkpoint``, on
  ``torch.distributed.checkpoint``), resume and ``AutoRecovery``;
- tensor-parallel serving: ``ServingEngine(param_specs=tp_specs(params),
  tp_axis="tensor")`` and ``models.generate.generate_tp`` over that
  context (tp = 1: every collective the identity), through the same
  paged and quantized-matmul kernels; every kernel a tp = 2 or 4 rank
  launches is also checked at its shard shape against the whole;
- the comm engine and pipeline parallelism: ``make_hybrid_train_step``
  with ``grad_comm`` bf16 / int8 (``DistributedOptimizer(error_feedback=)``)
  and ``overlap_tp``, and with ``models.bloom.loss_fn_pp`` (GPipe),
  ``loss_fn_1f1b`` and ``loss_fn_pp_sp`` over that context (every axis of
  size 1 on one card: the reductions still round, the pipelines run their
  microbatches through the flash, ring-chunk and fused CE kernels);
- expert parallelism: ``models.bloom_moe.loss_fn`` (BLOOM-MoE, every
  block's MLP 8 routed experts, top-2, dispatched over ``all_to_all`` on the
  "expert" axis) through ``Trainer.fit(with_rng=True)`` and
  ``make_hybrid_train_step`` over that context ("expert" named too, every
  axis of size 1), upcycled from the dense weights by
  ``nn.expert_parallel.ExpertParallel.from_dense``, its attention through
  the flash kernels;
- the Llama and Mixtral families: ``models.llama`` and ``models.mixtral``
  (RMSNorm, RoPE, GQA with 32 query heads over 8 KV heads at head_dim
  128, SwiGLU, Mixtral's routed experts and sliding window) through
  ``Trainer.fit`` over that context at Llama-3-8B's and Mixtral-8x7B's
  published widths (depth cut to 4 and 2 layers), their attention through
  the flash kernels and their untied (H, V) heads through the fused
  cross-entropy kernels;
- the ALBERT encoder family: ``models.albert`` (one shared layer applied
  12 times, factorized embedding, post-LN, the tied MLM head) at
  albert-base-v2's published widths through ``Trainer.fit`` over that
  context, its bidirectional attention through the flash kernels
  (``causal=False``), and ``fill_mask``; DiLoCo's outer loop
  (``optim.DiLoCoHybrid`` on the "diloco" axis, W = 1 on one card) around
  the hybrid step on bloom-560m.

Phases, each fatal on failure:

  0  the card: name and power limit (nvidia-smi), torch and CUDA versions;
  1  build every kernel from the sources in this checkout (nvcc, in
     parallel) and print ptxas's registers / shared memory / spills, and
     the shared memory of the bf16 fused CE forward's blocks;
  2  the paged kernel against its plain PyTorch version on the card at
     bloom-560m's shapes (decode B=8 C=1, chunked prefill B=1 C=128, one
     long decode row whose keys split over a cluster; float32, bf16 and
     int8 pages; float32 q, bf16 q and bf16 q as a strided view of the
     fused qkv product), through both routes;
  3  the float32 engine on the card against the same engine on the CPU
     (a 320-token context, ``CARD_VS_CPU_CONTEXT``): identical greedy
     tokens, and agreeing finite logits;
  4  timed bf16 serving runs (fp KV, then int8 KV), each after a warm-up
     run of the same workload with telemetry on (phase 34 checks it):
     tokens/s, mean TTFT, mean decode-step ms, and the kernel's launch
     count, which must be n_layer x (decode steps + prefill chunks): the
     decode steps on the FMA route, the chunks on the tensor-core route;
  5  the kernel's time at phase 4's decode shape and at its chunk shape
     (B=1, C=128 from position 384) beside its bound, its plain version's
     time and SDPA's; then a bf16 bloom-560m prefill of 512 tokens in
     128-token chunks through the kernel against the same chunks through
     the plain version, fp and int8 KV (last-position logits, greedy
     next token);
  6  the three flash-attention kernels against their plain versions at
     bloom-560m's attention shape (B=8, S=1024, nh=16, hd=64) in bf16 and
     float32, and on a right-padded mask, S=100, GQA g=2, window=64 and
     causal=False; every bf16 launch must take the tensor-core route, every
     float32 one the FMA route;
  7  the float32 train step on the card against the same step on the CPU
     (full width, depth cut to 2 layers): loss, every gradient, and the
     losses over 3 Adam steps;
  8  timed bf16 training steps exactly as ``bench.py``'s "flash" variant
     (24 layers, remat, flash, batch 8 x 1024, Adam 1e-4): step ms,
     tokens/s, MFU, peak memory, falling losses, the kernels' launch
     counts (also by route: every bf16 launch of B1-B3 and B7-B9 on the
     tensor cores), and where one profiled step's device time goes;
  9  each flash kernel's time at phase 8's shape beside its bound, its
     plain version's time and PyTorch's SDPA forward or backward, with its
     route and ptxas's registers and spills (with --parent, the parent
     revision's three kernels in turns with this one's);
 10  the three fused cross-entropy kernels (forward, d-hidden, d-weight)
     against their plain versions on the card: float32 and bf16, ragged T
     and V with a nonzero offset and valid_size < V, both weight layouts,
     and bench.py's shape in bf16 (T = 8 x 1023, H = 1024, V = 250880),
     both layouts, and a bf16 (H, V) weight with V not a multiple of 8;
     every bf16 forward launch must take the "wgmma" route
     (fused_ce_fwd_wgmma.cu) but that last one, which TMA cannot address,
     on "wmma", every float32 one "wmma"; every bf16 d-hidden and d-weight
     launch the tensor-core route ("mma"), every float32 one "wmma";
 11  phase 7's float32 train step on the card with fused_ce=True,
     ce_chunks=8, remat_policy="dots" and remat_policy="attn", each against
     phase 7's CPU run (the options change the order of float32 sums or
     what the backward recomputes, not the function; phase 7's tolerances);
     on the card the fused loss also equals the full-logits loss of the
     same weights;
 12  timed bf16 training as phase 8 in bench.py's "flash+fusedce",
     "noremat+flash+fusedce" and "flash+ce8" variants: step ms, tokens/s,
     MFU, peak memory (below phase 8's for the fused variants), falling
     losses, every kernel's launches per step (the fused CE forward's by
     route and layout: all on "wgmma", "vh"), and one profiled step's
     device time with the fused kernels' share;
 13  each fused kernel's time at phase 12's shape beside its bound, its
     plain version's time and a composite of PyTorch calls that computes
     the same function through the full logits, with its route, plan and
     ptxas's registers and spills, each also with an (H, V) weight (with
     --parent, the parent revision's bf16 forward, fused_ce.cu's WMMA
     kernel, in turns with this one's);
 14  the int8 and int4 (G = 32) quantized-matmul kernels against their plain
     version at bloom-560m's four products (qkv, out, up, down) and T in
     {1, 8, 128, 512}: the tensor-core route with bf16 x, the float32
     route with float32 and with bf16 x; quantized_linear (the cast and the
     bias in the kernel's epilogue) equal to the unfused composite bit for
     bit; the card's quantize_params against the CPU's on the full
     bloom-560m tree, byte for byte; a bf16 bloom-560m prefill with int8
     and int4 weights through the kernels against the same prefill through
     the plain composite (last-position logits, greedy next token);
 15  phase 3's float32 card-vs-CPU check with int8 and int4 weights, each
     with chunked and with monolithic prefill, bloom-560m's widths at 12
     layers (the CPU engines' cost); the card engine's tokens
     also equal the card's generate() on the engine's quantized params;
 16  phase 4's timed workload in four arms (fp, int8 weights, int4 weights,
     int8 weights + int8 KV): tokens/s, mean TTFT, mean decode-step ms, the
     memory report's weight and KV bytes (weights exactly as the shapes
     give), each quantized kernel's launch count (4 x n_layer x (decode
     steps + prefill chunks), all on the tensor-core route), and the
     kernels a profiled decode tick launches and the quantized kernels'
     share of its device time; the fp arm is phase 4's fp-KV run (the same
     engine and requests), its numbers read from there and checked here;
 17  each quantized kernel's time at the decode (T = 8) and chunk (T = 128)
     shapes, bf16, per bloom-560m product, beside its bound, its plain
     version's time, the float32-route kernel on the same inputs, cuBLAS's
     bf16 product with the dequantized weight, PyTorch's weight-only
     int8/int4 matmul where it applies, and the whole biased layer product
     before (float32-route kernel, split combine, cast, bias) and after
     (quantized_linear, one launch);
 18  the ring-chunk kernels (B7 forward, B8 dQ, B9 dK/dV) against their plain
     versions: (a) at phase 20's attention shape (B*nh = 16, S = 8192,
     hd = 64, bf16, the diagonal chunk); (b) every (rank, kv_rank) pair of an
     sp = 4 split of S = 4096 in ring order with carried state, float32 and
     bf16, right- and left-padded masks (the latter with the ALiBi
     correction) and GQA g = 2, a fully-future pair leaving the state bit for
     bit; (c) the chain over the split against the whole-sequence flash
     kernels B1-B3, unpadded and right-padded. bf16 B7-B9 must take the
     tensor-core route (B7's acc, dq, dk, dv within 2^-7 of the largest
     value), float32 the FMA route (2e-4); m within 2^-21, l 2e-4;
 19  the float32 SP loss at sp = 1 (``loss_fn_sp`` with flash) against the
     card's and the CPU's single-device ``loss_fn`` (2 layers, 2 x 512,
     right-padded, fused_ce off and on: the loss and every gradient), then 3
     ``sp_train_step``s against 3 ``train_step``s; B1-B3 never launch on
     the SP path; then the same loss in bf16 (B8/B9 on the tensor cores)
     against the bf16 flash ``loss_fn`` (B1-B3): the loss within 2^-7
     relative, every gradient within 2^-6 of its leaf's largest value;
 20  timed bf16 SP training, bloom-560m at 24 layers, remat, flash, fused CE,
     batch 1 x 8192: step ms, tokens/s, MFU, peak memory, falling losses,
     launches per step (B7 48, B8 and B9 24 on the tensor-core route, B1-B3
     0, fused CE 1 each), the chunk kernels' share of a profiled step; then
     the same shape through ``train_step``;
 21  each chunk kernel's time at phase 20's shape beside its bound, its plain
     version's time and PyTorch's SDPA forward or backward, with its route
     and ptxas's registers and spills (with --parent, the parent revision's
     B7-B9 in turns with this one's, and B8/B9's outputs equal to the
     parent's bit for bit);
 22  with --parent only, right after phase 20 in its context: phase 8's
     "flash" step, phase 12's "flash+fusedce" step, phase 20's SP step and
     train_step at 1 x 8192, each timed with this revision's kernels and
     with the parent's (its flash_attention and flash_chunk libraries
     loaded in their place, its bf16 fused CE forward, fused_ce.cu's WMMA
     kernel, called directly; the fused CE backward on fused_ce_mma.cu as
     the parent ran it: that source is unchanged, so this revision's build
     serves both) in turns: parent, this, this, parent;
 23  the float32 engine with the prefix cache on a skewed prefix-reuse
     trace (``make_skewed_replay``: 6 requests over 2 prefixes of 200
     tokens, so every hit copies a page on write; 16 new tokens, 4 slots,
     chunk 128), bloom-560m's widths cut to its first 13 layers (the CPU
     engines' cost), over weights drawn with init std 0.06 (HF's is 0.02,
     under which every stream repeats one token) so that the greedy
     streams vary and drafts are rejected, on the card against the CPU:
     (a) fp and int8 KV; (b) with speculative decoding (1, 3) and (12,
     3); (c) behind three requests that open the admission ledger's
     hole, a 41-page pool that evicts cache pages and retracts a request.
     Greedy tokens of the fp KV runs equal under the near-tie rule; for
     (a) each block of the fp and int8 KV forwards on the card from the
     CPU's inputs (a prefill and a decode step): its output over the
     CPU's pages and the values it writes within 1e-5 of their max, but
     for int8 values one step off at most 1e-3 of them (whole int8 runs
     part under float32 noise, each rounding flip growing layer by
     layer); the hit tokens, prefill
     tokens, chunks, steps, COW copies, evictions, retractions, drafts,
     acceptances and cycles equal; more than one token id in every stream
     and a rejected draft in every speculative run; the paged kernel's
     launches by route and by query count equal what the run's counts
     imply (n_layer per decode step and chunk, k per draft step, n_layer
     per verification); the speculative card engines give the plain card
     engine's tokens;
 24  timed bf16 serving of a larger skewed trace (16 requests over 3
     prefixes of 392 tokens, 32 new tokens, 8 slots, context 1024, chunk
     128) over phase 23's weights, through ``prefix_replay_benchmark``,
     each arm measured on its third run on the same engine: chunked
     without the cache, cache + chunked (fp, then int8 KV), and with
     speculation (1, 3) and (12, 3): tokens/s, mean and p99 TTFT, mean
     step or cycle ms, prefill tokens, hit rate, COW copies, acceptance,
     tokens a cycle, launches by route and by query count (checked as in
     23); then the paged kernel at the verification's shape (B = 8, C =
     4, bf16 pages, FMA route) against its plain version, and its time
     beside its bound, the plain version's and SDPA's;
 25  what each tensor-parallel rank launches, for tp in {2, 4}, bf16 and
     float32: B1-B3 on every rank's 16/tp heads (B = 8, S = 1024, hd = 64)
     with its slice of the ALiBi slopes against the same heads of the
     16-head launch; B4-B6 on every (V/tp, H) vocab shard at offset r V/tp
     (T = 8184, H = 1024), the shards' (lse, target logit) combined with
     ``ops.fused_ce.combine_shards`` and dh summed, against the
     whole-vocabulary launch, also with a padded vocabulary whose last
     shard at tp = 4 holds slots >= valid_size; every launch on its
     dtype's route (as phases 6 and 10). Then each kernel at rank tp-1's
     shard shape against its plain version and timed beside its bound,
     its plain version's time and SDPA's or the composite's (their rows'
     ``launches`` are 0: the one-card main path runs tp = 1);
 26  the hybrid step over a one-rank NCCL context with the "tensor" and
     "data" axes named: (a) float32, full width at 2 layers, 3 steps of
     ``make_hybrid_train_step`` (loss_fn with tp_axis="tensor",
     tp_specs, DistributedOptimizer over "data") against 3 ``train_step``s
     on the card, full logits and fused CE, and with n_accum = 2 against
     the whole batch (phase 7's loss tolerances; each leaf within
     HYBRID_PARAM_REL of train_step's move and moved by more than lr; the
     same launches); (b) bf16
     bloom-560m, 24 layers, 8 x 1024, remat + flash + fused CE, timed
     exactly as phase 12's "flash+fusedce": step ms, tokens/s, peak, the
     ZeRO state's bytes, and the launches, which must equal phase 12's;
 27  sampled ``generate()``: bf16 bloom-560m with its vocabulary padded for
     tp = 3 at temperature 0.7, the same generator seed giving the same
     tokens twice and no token in the padded slots; then the pick alone,
     200 000 draws of one float32 row of 8 logits on the card against
     softmax(logits / T) by a chi-square test, p > 1e-3;
 28  the Trainer on phase 26's context, its files under build/ (deleted
     after): (a) float32, full width at 2 layers, batch 2 x 256 of a
     Zipf token file through ``TokenDataset`` on the native route
     (asserted), remat + flash + fused CE: ``Trainer.fit`` for 4 steps
     (CheckpointCallback at step 4, LossLoggerCallback) against 6 steps of
     ``make_hybrid_train_step`` called by hand on the same batches, a new
     ``Trainer(resume_dir=)`` at step 4 for 2 steps against the last two,
     ``AutoRecovery`` over a poisoned fifth batch (one restore of the
     fit's checkpoint) against the
     first four, all bit for bit (else phase 7's loss tolerance, params
     within lr, and the log says so), the launches 4 x a step's;
     ``evaluate`` equal to the mean of the loss's forward; (b) phase
     26(b)'s step (bf16 bloom-560m, 8 x 1024, remat + flash + fused CE,
     Adam 1e-4) through ``Trainer.fit`` from the loader: 2 warm-up and 6
     timed steps (fit wall / steps) beside phase 26(b)'s, tokens/s, peak,
     the launches per step equal to phase 26(b)'s, falling losses; one
     checkpoint of the full train state (free disk checked first) saved and
     restored into a fresh Trainer, its seconds and bytes, params and
     moments equal bit for bit and the next loss equal; the Chrome trace
     of one step through ``fit(profiler_trace_dir=)`` naming B1-B6; the
     hand-called step and the Trainer in turns;
 29  tensor-parallel serving on phase 26's context (tp = 1 on the named
     "tensor" axis): (a) the float32 engine with int8 weights on phase 3's
     requests with ``param_specs=tp_specs`` and without, tokens equal bit
     for bit and the paged and quantized kernels' launches by route equal,
     then ``generate_tp`` against ``generate()`` on those prompts (a ragged
     left-padded batch), bit for bit; (b) phase 4's bf16 fp-KV workload
     through the TP engine and the plain engine in turns (plain, TP, TP,
     plain), timed beside phase 4's fp arm, every run's tokens equal to
     phase 4's and the paged kernel's launches n_layer x (decode steps +
     chunks) on their routes; (c) what each tp 2 / 4 rank launches: the
     paged kernel on every rank's 16/tp heads (its slope slice) of phase
     5's decode and chunk shapes and phase 24's verification shape, bf16
     and int8 pages, against the same heads of the 16-head launch and its
     plain version (phase 2's tolerances; decode and verification on the
     FMA route, the chunk on the tensor cores), and B10-B11 (int8, int4 G
     = 32, bf16 x at T = 8 and 128) on every rank's shard of qkv, out, up
     and down quantized whole: a column shard equal to the whole launch's
     columns, the row shards' partial products summed equal to the whole,
     within 1e-5 of the largest value, every launch on the tensor-core
     route; then rank tp-1's shards timed as phases 5 and 17 time the
     whole, beside their bounds, plain versions and SDPA or cuBLAS bf16
     (their rows' ``launches`` are 0: the one-card main path runs tp = 1);
 30  the comm engine and the pipelines on phase 26's context ("tensor",
     "pipe", "data" and "seq" named, each of size 1): (a) float32, full
     width at 2 layers, batch 4 x 256 with a right-padded row, flash:
     2 steps with overlap_tp against the monolithic step (full logits and
     fused CE; phase 26's criteria, the same launches); 2 steps with
     grad_comm bf16, int8 and int8 + error feedback, each on the CPU too,
     fed the card's gradients: step 1's int8 payloads and scales equal bit
     for bit; for bf16 and int8 the reduced gradients of step 1 bit for
     bit (the later steps run on the card alone); for int8 + error feedback the whole step on CPU copies of the
     params, within one int8 step of each leaf's scale and the losses after
     each step to phase 7's Adam tolerance; each update different from the
     float32 reduction's (the rounding ran at dp = 1); one step of GPipe and 1F1B
     at M = 2 and 4 and of PP x SP at M = 2 (fused CE) against loss_fn /
     loss_fn_sp on the whole batch (loss and every gradient, phase 7's
     tolerances), launching B1-B3 (B7-B9 for PP x SP) n_layer x M times
     and B4-B6 M times; (b) bf16 bloom-560m, 24 layers, 8 x 1024, remat +
     flash + fused CE: the hybrid step, int8 + error feedback, GPipe and
     1F1B at M = 4, each checked (launches per step, falling losses) and
     timed in one round of turns (the arms forward then back), 2 steps a
     turn: ms/step, tokens/s, the
     ratio to the hybrid step with its range over the turns, each arm's
     peak above what was allocated before it, the ZeRO state's and the
     residuals' bytes; one profiled step of GPipe (phase 26 profiles the
     hybrid step);
 31  BLOOM-MoE on phase 26's context, "expert" named too: (a) float32, full
     width at 2 layers, 8 experts, top-2, capacity factor 1.25, no router
     noise, remat + flash, upcycled from the seed-0 weights on the CPU,
     batch 4 x 256 with row 1 right-padded by 128 pad ids: the loss and
     every gradient on the card against the same code on the CPU (phase
     7's tolerances), each layer's dispatch equal (apart only from a token
     whose top-k gap is below 1e-5, named), the dropped tokens per layer
     (more than 0 in all); 3 steps of ``make_hybrid_train_step`` with
     ``moe_specs``, batch spec (("data", "expert"),), the loss over
     ("data", "expert") and the trunk's gradients averaged over "expert",
     against 3 hand-called steps of the same loss and Adam, bit for bit,
     launching B1 2 L and B2/B3 L times a step on the float32 route; (b)
     bf16, bloom-560m's widths at 24 layers upcycled on the card
     (``ExpertParallel(8, jitter=0.01).from_dense``, a seeded card
     generator), top-2, capacity factor 1.25, router noise 0.1, remat +
     flash, Adam 1e-4, through ``Trainer.fit(with_rng=True)``, batch 4 x
     1024: 2 warm-up and 5 timed steps, step ms, tokens/s, peak, MFU (6 x
     the active parameters + 12 L H S a token; the dense dispatch and
     combine products' flops beside it), falling losses, launches per step
     (B1 48, B2/B3 24, all on the tensor cores), the dropped share per
     layer, and one profiled step;
 32  the Llama and Mixtral families on phase 26's context: (a) float32,
     head_dim 128 with GQA g = 4 (width 512, 4 query heads over 1 KV head,
     FFN 1536, vocab 32000, 2 layers), flash + fused CE, batch 2 x 256
     with row 1 right-padded by 48: Llama untied and tied and Mixtral (8
     experts, top-2, sliding window 64), the loss and every gradient on the
     card against the CPU (phase 7's tolerances), each run's launches by
     kernel and route (float32 routes); Llama's ``loss_fn_sp`` at sp = 1
     (B7-B9) against its ``loss_fn``; Mixtral's ``loss_fn_1f1b`` with aux at
     pp = 1, M = 2 against ``loss_fn_pp`` (gradients) and ``loss_fn`` with
     per-microbatch router means (value); greedy ``generate`` card vs CPU;
     (b) bf16 through ``Trainer.fit``: Llama-3-8B's widths at 4 layers
     (batch 4 x 1024, remat + flash + fused CE on the untied "hv" head,
     Adam 1e-4), its step-1 loss within 2^-7 of a float32 loss of the same
     weights, then a short greedy ``generate`` (plain attention, no
     kernel); Mixtral-8x7B's widths at 2 layers (batch 2 x 1024, capacity
     factor 1.25, jitter 0.01, ``fit(with_rng=True)``): 2 warm-up and 3
     timed steps each, step ms, tokens/s, MFU, peak, launches per step on
     the tensor-core routes; then B1-B3 at the Llama shape (g = 4, hd 128,
     S 1024) without and with a window of 256, and B4-B6 on the "hv" head
     at T = 4092, H = 4096, V = 128256, each against its plain version and
     timed beside its bound, plain version and SDPA (``enable_gqa``) or the
     full-logits composite;
 33  ALBERT and DiLoCo on phase 26's context ("seq", "pipe" and "diloco" of
     size 1 too): (a) float32: B1-B3 against their plain versions at B = 2,
     12 heads, S = 256, hd 64, bidirectional, row 1 ending in 64 padded keys,
     f32 ("fma") and bf16 ("mma"); albert-base-v2's widths (H 768, E 128,
     12 heads, FFN 3072, vocab 30000, 12 applications), flash, batch 2 x
     256 with 64 pad ids ending row 1 and 15% MLM labels: the loss and every
     gradient card vs CPU (phase 7's tolerances; a leaf below 1e-4 of the
     tree's largest gradient, the key bias, against that floor), B1-B3 L
     launches each on "fma"; ``loss_fn_sp`` at sp = 1 (ring, Ulysses) and
     ``loss_fn_pp`` / ``loss_fn_1f1b`` at pp = 1, M = 2 against ``loss_fn``;
     ``fill_mask`` tokens card vs CPU; DiLoCoHybrid at W = 1 on phase 30
     (a)'s float32 2-layer BLOOM with fused CE: 3 inner steps equal 3 hybrid
     steps bit for bit, the sync a hand-computed Nesterov update within
     1e-6, the worker the anchor bit for bit; (b) bf16 albert-base-v2 at full
     width and depth, 16 x 512 with 15% MLM labels, remat + flash, Adam 1e-4,
     through ``Trainer.fit``: 2 warm-up and 3 timed steps, step ms,
     tokens/s, MFU (6 x flop-bearing params, the shared layer once per
     application, + 12 L H S a token), peak, launches per step (B1 2 L,
     B2/B3 L, all "mma"), one profiled step's busy share, the step-1 loss
     within 2^-7 of float32's; ``fill_mask`` sequences/s at 64 x 512; one
     DiLoCoHybrid round (4 inner steps) on bf16 bloom-560m at 8 x 1024
     beside the hybrid step in turns, the sync's ms, the anchor's, outer
     momentum's and ZeRO state's bytes; then B1-B3 at ALBERT's shape (B*nh
     192, S 512, hd 64, bidirectional, padded keys) against their plain
     versions and timed beside their bound, plain version and SDPA with a
     boolean key mask;
 34  the telemetry core (right after phase 28, on its context): (a) phase
     4's warm-up runs, fp and int8 KV, through engines with an enabled
     private registry, a FlightRecorder and the memory ledger: tokens and
     launches by route equal the timed registry-off runs'; every counter,
     end gauge (the ledger's bytes as pages) and histogram count, and the
     ledger's per-tick pages, equal the port's CPU engine's on the same
     requests (a 1-layer, width-32 model at bloom-560m's vocabulary: the
     schedule does not depend on the weights); the ledger conserved on
     every tick and its audit clean; a run forced to stall (a pool that
     cannot admit) raises and its black box names the card; (b) phase
     28 (b)'s 8 batches through a Trainer with TelemetryCallback(
     flops_per_step=, hbm_every=1, fence=True), a FlightRecorder and
     FailureDetector(recorder=): losses and params bit for bit phase 28
     (b)'s, its launches per step, one train.step and one train.data span
     sample a step, train.mfu the phase's MFU formula from the same step
     time (1e-12 relative), train.hbm_bytes_in_use the allocator's in-use
     bytes read at that point; (c) inside a CUDA-graph capture a counter
     and a span record nothing, and ten replays add nothing; (d) the
     serving decode tick (3 rounds of on, off, off, on, 4 ticks a turn)
     and the Trainer step (one round, 2 steps a turn) with telemetry on
     and off, each ratio with its range.

Every phase's seconds are logged as "seconds: <phase> <s>".

The line before the last is a JSON object with every kernel's numbers
(each row's ``trainer_launches``: its launches in phase 28 (b)'s timed
fit; ``moe_launches``: in phase 31 (b)'s timed steps), phase 28's under
``trainer``, phase 30's under ``comm_pipeline``, phase 31's under
``moe``, phase 32's under ``families``, phase 33's under ``albert`` and
phase 34's under ``telemetry``;
the last line is
{"ok": true, "device": {...}}. Without a card, or
without the rest of the repository beside it, the script exits non-zero
and prints no result.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12      # H100 SXM bf16 dense tensor cores
ATOL = {"f32": 1e-4, "int8": 1e-4, "bf16": 2e-3}   # online-softmax reassociation
LOGIT_ATOL = 1e-3              # float32 card vs CPU logits after 24 layers
NEAR_TIE = 1e-4                # top-2 margin below which a flip is a genuine tie
KERNEL = {
    "source": "pipegoose_tpu_torch/ops/csrc/paged_attention.cu",
    "replaces": "pipegoose_tpu/ops/paged_attention.py:217",
    "route": "cuda",
}
FLASH_SOURCE = "pipegoose_tpu_torch/ops/csrc/flash_attention.cu"
FLASH_REPLACES = {
    "fwd": "pipegoose_tpu/ops/flash_attention.py:88",
    "dq": "pipegoose_tpu/ops/flash_attention.py:187",
    "dkv": "pipegoose_tpu/ops/flash_attention.py:270",
}
# flash kernel vs plain, on max |diff| against the largest |plain| value M:
# float32 outputs 1e-5 + 2e-4 M (the sums run in another order; ALiBi
# scores reach ~512 at S=1024, where a float32 ulp is 6.1e-5, and the
# backward multiplies P's relative error by dO.V); bf16 outputs
# 1e-5 + 2^-7 M (both sides round float32 values that differ in their last
# bits, so they may land one bf16 ulp, at most 2^-7 of the value, apart);
# lse, float32 in both dtypes, 1e-5 + 2^-21 M (four float32 ulps).
FLASH_RTOL = {torch.float32: 2e-4, torch.bfloat16: 2.0 ** -7}
FLASH_ATOL = 1e-5
LSE_RTOL = 2.0 ** -21
# float32 train step, card vs CPU, full width at 2 layers: the loss to
# 1e-4 absolute and every gradient to 1e-3 of its leaf's largest value
# (float32 sums over 1024-wide products, 512 tokens and 250880 vocab
# entries, taken in another order by cuBLAS and the CPU's BLAS); after
# Adam steps the losses to 1e-3, since Adam moves a weight whose gradient
# is near zero by up to lr whatever the gradient's rounding
FUSED_FWD_SOURCE = "pipegoose_tpu_torch/ops/csrc/fused_ce_fwd_wgmma.cu"   # bf16 forward
FUSED_MMA_SOURCE = "pipegoose_tpu_torch/ops/csrc/fused_ce_mma.cu"   # bf16 dh, dw
FUSED_REPLACES = {
    "fwd": "pipegoose_tpu/ops/fused_ce.py:63",
    "dh": "pipegoose_tpu/ops/fused_ce.py:163",
    "dw": "pipegoose_tpu/ops/fused_ce.py:221",
}
# fused CE kernel vs plain, on max |diff| against the largest finite |plain|
# value M (a masked target's logit, exactly -1e9, is left out of M), with no
# absolute floor, since dh and dw scale with g = 1/T: lse and target logit
# 2^-18 M (bf16 products are exact in float32 and only the order of the sums
# differs; float32 inputs run in split TF32, which drops 2^-22 of each
# product); float32 dh, dw 1e-4 M (split-TF32 products summed over the
# vocabulary or the tokens in another order); bf16 dh, dw 2^-6 M, two bf16
# ulps: the final rounding, and the dlogits tile that the kernels round to
# bf16 before the second product (on both routes)
FUSED_STAT_RTOL = 2.0 ** -18
FUSED_GRAD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}
QUANT_SOURCE = "pipegoose_tpu_torch/ops/csrc/quant_matmul.cu"
QUANT_REPLACES = {"int8": "pipegoose_tpu/quant/matmul.py:94",
                  "int4": "pipegoose_tpu/quant/matmul.py:132"}
# quantized matmul kernel vs plain, max |diff| against the largest |plain|
# value M: 1e-5 M on both routes. A bf16 x times an int8 or int4 weight is
# exact in float32 (and in bf16 for the tensor cores' operands): only the
# order of up to 4096 float32 sums differs, and for int4 on the tensor
# cores a group's sum is scaled where the plain version scales each weight
QUANT_RTOL = 1e-5
# bf16 bloom-560m prefill with quantized weights, kernels vs the plain
# composite, last-position logits: 2^-5 of the largest |logit| (four bf16
# ulps of it). The forwards differ only where a product's float32 sum,
# taken in another order, rounds to the other bf16 neighbour; such one-ulp
# (2^-8) steps ride the residual stream through 24 layers. A greedy token
# may differ only where the plain forward's top-2 margin is below that.
QUANT_LOGIT_RTOL = 2.0 ** -5
BLOOM_KN = ((1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024))  # qkv, out, up, down
# bloom-560m bf16 resident weight bytes, from its shapes: every leaf in
# bf16; the 24 x 4 block kernels as int8 + float32 per-channel scales; as
# packed int4 + float32 scales per 32 rows
WEIGHT_BYTES = {"fp": 1_118_429_184, "int8": 817_324_032, "int4": 703_193_088}
TRAIN_LOSS_ATOL = 1e-4
TRAIN_GRAD_RTOL = 1e-3
TRAIN_ADAM_LOSS_ATOL = 1e-3
CHUNK_SOURCE = "pipegoose_tpu_torch/ops/csrc/flash_chunk.cu"
CHUNK_REPLACES = {
    "fwd": "pipegoose_tpu/ops/flash_attention.py:371",
    "dq": "pipegoose_tpu/ops/flash_attention.py:514",
    "dkv": "pipegoose_tpu/ops/flash_attention.py:596",
}
SP_BF16_LOSS_RTOL = 2.0 ** -7  # bf16 SP loss vs the flash path's, relative
NEG_INF_F = -1e9               # the models' finite NEG_INF: a ring state's initial m
SP_SEQ = 8192                  # phase 20's tokens a step (bench.py's 8 x 1024) in one sequence


def log(msg: str) -> None:
    print(msg, flush=True)


# -- phase 0 -------------------------------------------------------------------

def phase0_card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card visible to torch; nothing ran")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"phase 0: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, {torch.cuda.device_count()} card(s), "
        f"using {torch.cuda.get_device_name(0)}")
    return card


# -- phase 1 -------------------------------------------------------------------

# the sources of the attention and fused CE kernels
PARENT_SOURCES = ("flash_attention", "flash_chunk", "fused_ce")


def phase1_build(parent=None) -> dict:
    """Build every source of this checkout (and, given a checkout of the
    parent revision, its PARENT_SOURCES into build/parent-kernels), one
    nvcc per source, all at once. Returns the parent's loaded libraries by
    source name (empty without a parent)."""
    import ctypes
    from pathlib import Path

    from pipegoose_tpu_torch.ops import _build

    names = sorted(p.stem for p in _build.SRC_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    out_dir = _build.BUILD_DIR.parent / "parent-kernels"
    procs = {}
    if parent:
        out_dir.mkdir(parents=True, exist_ok=True)
        src = Path(parent) / _build.SRC_DIR.relative_to(_build.SRC_DIR.parents[2])
        procs = {n: subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                                      str(out_dir / f"{n}.so"), str(src / f"{n}.cu")],
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True) for n in PARENT_SOURCES}
    _build.build(names)
    libs = {}
    for n, proc in procs.items():
        out, _ = proc.communicate(timeout=_build.BUILD_TIMEOUT_S)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the parent's {n}.cu:\n{out}")
        libs[n] = ctypes.CDLL(str(out_dir / f"{n}.so"))
    log(f"phase 1: built {names}" + (f" and the parent's {list(procs)} from {parent}"
                                     if procs else "") + f" in {time.perf_counter() - t0:.1f} s")
    for name in names:
        fn = "?"
        for line in _build.build_log(name).splitlines():
            if "Function properties for" in line:   # ptxas -v names each kernel first
                fn = line.split("Function properties for")[-1].strip()[:72]
            elif "registers" in line or "spill" in line:
                log(f"  {name} {fn}: {line.strip()}")
    from pipegoose_tpu_torch.ops import fused_ce as fce

    for hd in (1024, 4096):
        plan = fce.fwd_plan(torch.bfloat16, 8184, hd, 250880, True)
        log(f"  fused_ce_fwd_wgmma at H={hd}: BN {plan['bn']}, {plan['stages']} stages, "
            f"{plan['smem_bytes']} bytes of dynamic shared memory a block")
    return libs


# -- phase 2 -------------------------------------------------------------------

def make_case(rng, dev, *, rows, c, starts, width, ps=16, nh=16, hd=64,
              layers=1):
    """Garbage-filled banks (NULL page included) for ``layers`` layers, a
    table of distinct random pages over each row's live prefix and NULL
    beyond it, f32 queries, ALiBi slopes of 16 heads."""
    from pipegoose_tpu_torch.models.bloom import alibi_slopes

    live = [(s + c - 1) // ps + 1 for s in starts]
    n_pages = 1 + sum(live)
    perm = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((rows, width), np.int32)
    at = 0
    for b, n in enumerate(live):
        table[b, :n] = perm[at:at + n]
        at += n
    k = torch.randn(layers, n_pages, ps, nh, hd, device=dev)
    v = torch.randn(layers, n_pages, ps, nh, hd, device=dev)
    q = torch.randn(rows, c, nh, hd, device=dev)
    return {
        "q": q, "k": k, "v": v,
        "table": torch.from_numpy(table).to(dev),
        "start": torch.tensor(starts, dtype=torch.int32, device=dev),
        "slopes": torch.from_numpy(alibi_slopes(nh)).to(dev),
    }


def pages_as(case, fmt):
    """The case's float32 banks in page format ``fmt`` (f32, bf16, int8)."""
    from pipegoose_tpu_torch.serving.kv_pool import quantize_kv

    if fmt == "f32":
        return case["k"], case["v"]
    if fmt == "bf16":
        return case["k"].to(torch.bfloat16), case["v"].to(torch.bfloat16)
    out = []
    for x in (case["k"], case["v"]):
        q, s = quantize_kv(x)
        out.append({"q": q, "scale": s})
    return tuple(out)


def layer_of(pages, i):
    from pipegoose_tpu_torch.serving.kv_pool import layer_bank

    return layer_bank(pages, i)


def q_variants(q):
    """The queries as the engines hand them to the kernel: float32 (the
    float32 engine), bf16, and bf16 as the q slice of a fused (B, C, nh, 3,
    hd) qkv product (head stride 3 hd), read in place."""
    fused = torch.stack([q, torch.randn_like(q), torch.randn_like(q)], dim=3)
    return {"f32 q": q, "bf16 q": q.to(torch.bfloat16),
            "strided bf16 q": fused.to(torch.bfloat16)[..., 0, :]}


def phase2_kernel_vs_plain(dev) -> dict:
    """Every route of the paged kernel against its plain version. Returns
    the largest error per (page format, decode | chunk)."""
    from pipegoose_tpu_torch.ops import paged_attention as pa

    rng = np.random.default_rng(SEED)
    torch.manual_seed(SEED)
    cases = {
        # starts: row at 0, a partial last page, one near max_context (1024)
        "decode B=8 C=1": make_case(rng, dev, rows=8, c=1, width=64,
                                    starts=[0, 17, 1023, 100, 300, 511, 700, 15]),
        "chunk B=1 C=128": make_case(rng, dev, rows=1, c=128, width=64,
                                     starts=[200]),
        # one long row: its keys split over a cluster's blocks
        "long decode B=1 C=1": make_case(rng, dev, rows=1, c=1, width=64,
                                         starts=[1023]),
    }
    errs = {}
    for label, case in cases.items():
        kind = "chunk" if "chunk" in label else "decode"
        for fmt in ("f32", "bf16", "int8"):
            k, v = (layer_of(p, 0) for p in pages_as(case, fmt))
            for qname, q in q_variants(case["q"]).items():
                args = (q, k, v, case["table"], case["start"])
                pages = k["q"] if fmt == "int8" else k
                b, c, nh, hd = q.shape
                plan = pa.paged_plan(b, c, nh, hd, pages.shape[1],
                                     case["table"].shape[1], q.dtype, pages.dtype)
                before = pa.paged_attention.launches
                out = pa.paged_attention(*args, slopes=case["slopes"])
                torch.cuda.synchronize()
                if pa.paged_attention.launches != before + 1:
                    raise AssertionError(f"{label} {fmt}: launch counter did not move")
                ref = pa.paged_attention_reference(*args, slopes=case["slopes"])
                if out.shape != ref.shape or not torch.isfinite(out).all():
                    raise AssertionError(f"{label} {fmt}: bad output {tuple(out.shape)}")
                err = (out - ref).abs().max().item()
                ok = err <= ATOL[fmt]
                log(f"phase 2: {label} {fmt} pages, {qname} ({plan['route']} route, "
                    f"{plan['splits']} splits): max_abs_err={err} (atol {ATOL[fmt]}) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{label} {fmt} {qname}: kernel disagrees with plain")
                errs[f"{fmt} {kind}"] = max(errs.get(f"{fmt} {kind}", 0.0), err)
    return errs


# -- phase 3 -------------------------------------------------------------------

def prefill_logits(params, config, prompt, dev, kv_dtype=None, chunk=None):
    """Float32 logits after ``prompt`` from paged chunks of ``chunk`` tokens
    (one chunk of the whole prompt by default) over a fresh pool (pages
    1..W in order): an engine-free reference forward."""
    from pipegoose_tpu_torch.serving.kv_pool import init_pages, paged_prefill_chunk

    ps, n = 16, len(prompt)
    chunk = chunk or n
    width = -(-n // ps)
    k, v = init_pages(config, width + 1, ps, kv_dtype=kv_dtype, device=dev)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)  # noqa: E731
    table = i32([list(range(1, width + 1))])
    for s in range(0, n, chunk):
        toks = np.zeros(chunk, np.int64)
        toks[:min(chunk, n - s)] = prompt[s:s + chunk]
        logits = paged_prefill_chunk(params, i32([toks.tolist()]), k, v, table, i32([s]),
                                     i32([min(chunk, n - s)]), config)
    return logits


def make_engine(params, config, dev, *, num_slots, kv_dtype=None, **knobs):
    """The main path's engine: page size 16, 1024-token context, 128-token
    prefill chunks and enough pages for every slot's worst case unless
    ``knobs`` say otherwise."""
    from pipegoose_tpu_torch.serving import ServingEngine

    knobs = {"prefill_chunk": 128, "num_pages": num_slots * (1024 // 16) + 1,
             "max_context": 1024, **knobs}
    return ServingEngine(params, config, num_slots=num_slots, page_size=16,
                         kv_dtype=kv_dtype, device=dev, **knobs)


def as_requests(requests):
    from pipegoose_tpu_torch.serving import Request

    return [Request(prompt=p, max_new_tokens=n) for p, n in requests]


def serve(params, config, requests, dev, *, num_slots, kv_dtype=None, **knobs):
    eng = make_engine(params, config, dev, num_slots=num_slots, kv_dtype=kv_dtype,
                      **knobs)
    return eng, *eng.run(as_requests(requests))


def serving_counters():
    """Every kernel of the serving path's launch counter, by name."""
    from pipegoose_tpu_torch.ops import paged_attention as pa
    from pipegoose_tpu_torch.quant import matmul as qm

    return {"paged_attention": pa.paged_attention,
            "int8": qm.quantized_matmul_int8, "int4": qm.quantized_matmul_int4}


def check_quant_launches(label, counts, metrics, n_layer, weight_dtype):
    """With ``weight_dtype`` set, its quantized matmul must launch 4 times
    per layer per forward (qkv, out, up, down) and the other kernel never;
    without, neither launches. A chunked engine reports its prefill
    chunks; a monolithic prefill is one forward, counted in ``prefills``."""
    forwards = metrics["decode_steps"] + metrics.get("prefill_chunks",
                                                     metrics["prefills"])
    want = {k: (4 * n_layer * forwards if k == weight_dtype else 0)
            for k in ("int8", "int4")}
    got = {k: counts[k] for k in want}
    log(f"  {label}: quantized matmul launches {got}, want {want} (4 x n_layer x "
        f"{forwards} forwards for {weight_dtype or 'fp'} weights)")
    if got != want:
        raise AssertionError(f"{label}: the quantized path bypassed its kernel")


def check_launches(label, launches, metrics, n_layer, chunked=True):
    """The paged kernel runs once per layer in every decode step and, with
    chunked prefill, every prefill chunk; a monolithic prefill attends
    through its contiguous cache instead, as the JAX engine's does."""
    chunks = metrics["prefill_chunks"] if chunked else 0
    want = n_layer * (metrics["decode_steps"] + chunks)
    log(f"  {label}: kernel launches {launches}, n_layer x (decode steps "
        f"{metrics['decode_steps']} + prefill chunks {chunks}) = {want}")
    if launches != want or launches == 0:
        raise AssertionError(f"{label}: the main path bypassed the kernel")


def phase3_engine_vs_cpu(np_tree, dev):
    from pipegoose_tpu_torch.models.bloom import BloomConfig
    from pipegoose_tpu_torch.models.weights import params_from_jax

    cfg = BloomConfig.bloom_560m()
    requests = card_vs_cpu_requests(cfg)
    log(f"phase 3: bloom-560m float32, prompts {[len(p) for p, _ in requests]}, "
        f"16 new tokens each, 4 slots, chunk 128, context {CARD_VS_CPU_CONTEXT}")
    cpu_params = params_from_jax(np_tree, cfg, device="cpu")
    gpu_params = params_from_jax(np_tree, cfg, device=dev)
    engines_agree(cfg, requests, cpu_params, gpu_params, dev,
                  max_context=CARD_VS_CPU_CONTEXT)
    prompt = requests[0][0]
    lg = prefill_logits(gpu_params, cfg, prompt, dev)
    lc = prefill_logits(cpu_params, cfg, prompt, "cpu")
    if lg.shape != (1, cfg.vocab_size) or not torch.isfinite(lg).all():
        raise AssertionError(f"card logits bad: shape {tuple(lg.shape)}")
    err = (lg.cpu() - lc).abs().max().item()
    log(f"  logits after a {len(prompt)}-token prompt: finite, card vs cpu "
        f"max_abs_err={err} (atol {LOGIT_ATOL})")
    if err > LOGIT_ATOL:
        raise AssertionError("card and cpu logits disagree")


# phases 3 and 15's context: the longest request card_vs_cpu_requests can
# draw (300 + 16 tokens) rounded up to a page. The CPU engine's plain
# attention reads every key of the page table, so a table narrower than the
# main path's 1024 makes the CPU runs cheaper; the card reads only the
# keys each sequence holds.
CARD_VS_CPU_CONTEXT = 320


def card_vs_cpu_requests(cfg):
    """Three seeded requests, prompts 40-300 tokens, 16 new tokens each."""
    rng = np.random.default_rng(SEED + 3)
    return [(rng.integers(0, cfg.vocab_size, int(n)), 16)
            for n in rng.integers(40, 301, 3)]


def check_flip(label, params, cfg, prompt, want, got):
    """Fails unless token streams ``want`` and ``got`` agree, or part
    first where the CPU's top-2 logits after the common prefix are a
    near-tie."""
    diff = np.nonzero(np.asarray(want) != np.asarray(got))[0]
    if diff.size == 0:
        log(f"  {label}: {len(got)} tokens identical")
        return
    step = int(diff[0])
    prefix = np.concatenate([prompt, np.asarray(want)[:step]])
    top2 = torch.topk(prefill_logits(params, cfg, prefix, "cpu")[0], 2).values
    margin = (top2[0] - top2[1]).item()
    log(f"  {label}: diverges at step {step}, cpu top-2 margin {margin}")
    if margin >= NEAR_TIE:
        raise AssertionError(f"{label} diverged at step {step}, margin {margin} "
                             f"is not a near-tie")


def engines_agree(cfg, requests, cpu_params, gpu_params, dev, **knobs):
    """The float32 engine with ``knobs`` on the CPU and on the card: the
    card run must launch the paged kernel (and, with ``weight_dtype``,
    its quantized matmul) on every forward, and give the CPU's greedy
    tokens, a flip allowed only at a CPU top-2 margin below NEAR_TIE.
    Returns the CPU engine, the card engine and the card's outputs."""
    counters = serving_counters()
    t0 = time.perf_counter()
    cpu_eng, cpu_outs, _ = serve(cpu_params, cfg, requests, "cpu", num_slots=4, **knobs)
    log(f"  cpu engine: {time.perf_counter() - t0:.1f} s")
    for c in counters.values():
        c.launches = 0
    gpu_eng, gpu_outs, gpu_metrics = serve(gpu_params, cfg, requests, dev,
                                           num_slots=4, **knobs)
    counts = {n: c.launches for n, c in counters.items()}
    check_launches("card engine", counts["paged_attention"], gpu_metrics, cfg.n_layer,
                   chunked=knobs.get("prefill_chunk", 128) is not None)
    check_quant_launches("card engine", counts, gpu_metrics, cfg.n_layer,
                         gpu_eng.weight_dtype)
    for (prompt, _), c, g in zip(requests, cpu_outs, gpu_outs):
        check_flip(f"request {c.uid}", cpu_eng.params, cfg, prompt, c.generated,
                   g.generated)
    return cpu_eng, gpu_eng, gpu_outs


# -- phase 4 -------------------------------------------------------------------

def phase4_requests(cfg):
    """Phase 4's workload: 12 seeded requests, prompts 128-512, 64 new tokens."""
    rng = np.random.default_rng(SEED + 4)
    return [(rng.integers(0, cfg.vocab_size, int(n)), 64)
            for n in rng.integers(128, 513, 12)]


def phase4_timed_serving(np_tree, dev):
    """Timed bf16 serving, fp then int8 KV, each after a warm-up run of
    the same workload with telemetry on (phase 34 (a) checks it). Returns
    the paged kernel's launches by arm and route, and the fp arm's run
    (metrics, tokens, memory report, quantized launches, decode profile)
    for phases 16 and 29, which time the same workload, with phase 34's
    telemetry runs under "telemetry" (the warm-ups, a stalled run, the
    serving cost turns)."""
    from pipegoose_tpu_torch.models.bloom import BloomConfig
    from pipegoose_tpu_torch.models.weights import params_from_jax
    from pipegoose_tpu_torch.ops import paged_attention as pa

    cfg = BloomConfig.bloom_560m(dtype=torch.bfloat16)
    params = params_from_jax(np_tree, cfg, device=dev)
    requests = phase4_requests(cfg)
    log(f"phase 4: bloom-560m bf16, 12 requests, prompts 128-512 "
        f"(sum {sum(len(p) for p, _ in requests)}), 64 new tokens, 8 slots")
    launches = {}
    tele = {"requests": requests}       # phase 34 (a) and (d) check these
    for kv in (None, "int8"):
        label = f"{kv or 'fp'} KV"
        # the warm-up, with telemetry on
        tele[kv or "fp"] = phase34_instrumented_serve(params, cfg, requests, dev, kv)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        serving_counters_zero()
        eng, outs, m = serve(params, cfg, requests, dev, num_slots=8, kv_dtype=kv)
        launches[kv or "fp"] = {"all": pa.paged_attention.launches,
                                **pa.paged_attention.routes}
        tele[kv or "fp"].update(timed_tokens=[o.generated.tolist() for o in outs],
                                timed_launches=dict(launches[kv or "fp"]))
        if kv is None:
            fp_arm = {"metrics": m, "tokens": [o.generated for o in outs],
                      "memory": eng.memory_report(),
                      "quant": {k: c.launches for k, c in serving_counters().items()}}
        log(f"  {label}: {m['decode_tokens_per_s']} tokens/s, "
            f"mean TTFT {m['mean_ttft_s'] * 1e3} ms, mean decode step "
            f"{m['decode_step_time_s'] / m['decode_steps'] * 1e3} ms, "
            f"{m['generated_tokens']} tokens in {m['wall_time_s']} s, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if m["generated_tokens"] != 12 * 64 or any(
                len(o.generated) != 64 for o in outs):
            raise AssertionError(f"{label}: not every request got 64 tokens")
        check_launches(label, launches[kv or "fp"]["all"], m, cfg.n_layer)
        routes = {r: launches[kv or "fp"][r] for r in ("fma", "mma")}
        want = {"fma": cfg.n_layer * m["decode_steps"],
                "mma": cfg.n_layer * m["prefill_chunks"]}
        log(f"  {label}: launches by route {routes}, want {want} (decode steps on "
            f"the FMA route, 128-token bf16 chunks on the tensor cores)")
        if routes != want:
            raise AssertionError(f"{label}: a route of the paged kernel did not run")
        prof = decode_profile(eng, requests[:8], label)
        del eng
        if kv is None:
            fp_arm["profile"] = prof
    tele["stall"] = phase34_stall(params, cfg, dev)
    tele["cost"] = phase34_serving_cost(params, cfg, requests[:8], dev)
    fp_arm["telemetry"] = tele
    return launches, fp_arm


# decode ticks a serving profile covers (phases 4 and 16)
PROFILE_TICKS = 8


def decode_profile(eng, requests, label, ticks=PROFILE_TICKS):
    """Where a decode step's time goes on ``eng``, an idle 8-slot engine:
    fill the slots, let every prefill finish, then run ``ticks`` decode-only
    ticks under torch.profiler and report wall time, device busy time and
    the top kernels per tick. Returns what ``profile_device`` returns."""
    from pipegoose_tpu_torch.serving import Status

    eng.start_run(as_requests(requests))
    while eng.sched.queue or any(r.status is Status.PREFILL
                                 for r in eng.sched.active()):
        eng.tick_once()
    # device activity only: tracing every host op of a tick costs seconds a
    # profile and adds to the wall it measures
    prof = profile_device(eng.tick_once, ticks,
                          f"{label} decode tick (8 slots, profiled)", "tick", top=6,
                          host=False)
    eng.finish_run()
    return prof


def profile_device(fn, n, label, unit, top, host=True):
    """Run ``fn()`` ``n`` times under torch.profiler after a sync; log the
    wall time, the device busy time (summed kernel time) and its share,
    and the ``top`` kernels by device time, each per ``unit``. Returns
    (wall ms, busy ms, the profiler's device-kernel averages). ``host=False``
    records the device's activity alone (a step of tens of thousands of
    host ops takes seconds to trace)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    if busy_ms == 0:
        log(f"  {label}: {wall_ms} ms wall under the profiler; device time "
            f"not measured (the profiler saw no device activity)")
        return wall_ms, busy_ms, kernels
    log(f"  {label}: {wall_ms} ms wall, device busy {busy_ms} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), "
        f"{sum(e.count for e in kernels) / n:.0f} kernels per {unit}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"    {e.self_device_time_total / 1e3 / n:.4f} ms/{unit} "
            f"{e.count / n:.0f} launches/{unit}  {e.key[:90]}")
    return wall_ms, busy_ms, kernels


# -- phase 5 -------------------------------------------------------------------

def time_ms(fn, calls, replays=20):
    """Per-call ms of ``fn(i)`` for i in range(calls), timed with CUDA events
    two ways: (device ms, call ms). Device ms replays a CUDA graph of the
    ``calls`` calls, so no host work sits between the launches; call ms
    calls ``fn`` eagerly, the host's Python and launch overhead included."""
    stream = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(stream)
    with torch.cuda.stream(side):          # warm-up off the capture stream
        for i in range(3):
            fn(i)
    stream.wait_stream(side)
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0.record()
    for i in range(calls):
        fn(i)
    t1.record()
    torch.cuda.synchronize()
    call_ms = t0.elapsed_time(t1) / calls
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    t0.record()
    for _ in range(replays):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (replays * calls), call_ms


def paged_bound_ms(case, fmt, route):
    """Least time for one call: each visible K/V value of a row (those of
    its last query, plus their scales for int8), the bf16 queries, the
    float32 output, the visited table entries, starts and slopes moved once
    at 3.35 TB/s, against 4 hd flops per visible (query, key) pair (q.k and
    p.v) at 67 TFLOP/s on the FMA route and 989 TFLOP/s (bf16 tensor
    cores) on the tensor-core route."""
    b, c, nh, hd = case["q"].shape
    starts = case["start"].long().tolist()
    keys = sum(s + c for s in starts)
    pairs = sum(c * (s + 1) + c * (c - 1) // 2 for s in starts)
    per = {"f32": 4, "bf16": 2, "int8": 1}[fmt]
    kv = 2 * keys * nh * (hd * per + (4 if fmt == "int8" else 0))
    pages = sum((s + c - 1) // 16 + 1 for s in starts)
    nbytes = kv + b * c * nh * hd * (2 + 4) + pages * 4 + b * 4 + nh * 4
    flops = 4 * pairs * nh * hd
    rate = BF16_FLOPS_PER_S if route == "mma" else F32_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def paged_time(case, fmt, n_layer, dev):
    """Device and eager ms per call of the paged kernel, its plain version
    and SDPA over the pre-gathered view (bf16, float32 for int8 pages; with
    the same additive bias; the gather itself not timed). bf16 queries, as
    the bf16 engine's; each call reads the next of ``n_layer`` layer banks
    (L2-cold)."""
    from pipegoose_tpu_torch.models.bloom import NEG_INF
    from pipegoose_tpu_torch.ops import paged_attention as pa
    from pipegoose_tpu_torch.serving.kv_pool import gather_pages

    k, v = pages_as(case, fmt)
    banks = [(layer_of(k, i), layer_of(v, i)) for i in range(n_layer)]
    q = case["q"].to(torch.bfloat16)
    table, start, slopes = case["table"], case["start"], case["slopes"]
    c = q.shape[1]
    calls = {
        "kernel": lambda kb, vb: pa.paged_attention(q, kb, vb, table, start, slopes=slopes),
        "plain": lambda kb, vb: pa.paged_attention_reference(q, kb, vb, table, start,
                                                             slopes=slopes),
    }
    sdpa_dtype = torch.bfloat16 if fmt == "bf16" else torch.float32
    views = [(gather_pages(kb, table).to(sdpa_dtype).transpose(1, 2).contiguous(),
              gather_pages(vb, table).to(sdpa_dtype).transpose(1, 2).contiguous())
             for kb, vb in banks]
    key_pos = torch.arange(views[0][0].shape[2], device=dev)
    q_pos = start.long()[:, None] + torch.arange(c, device=dev)[None, :]
    keep = key_pos[None, None, :] <= q_pos[:, :, None]                   # (B, C, K)
    bias = (slopes[None, :, None, None] * key_pos.float()[None, None, None, :]
            + torch.where(keep, 0.0, NEG_INF)[:, None]).to(sdpa_dtype)
    qs = q.to(sdpa_dtype).transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for name, fn in calls.items():
        out[name] = time_ms(lambda i, fn=fn: fn(*banks[i % n_layer]), n_layer)
    out["library"] = time_ms(
        lambda i: sdpa(qs, *views[i % n_layer], attn_mask=bias), n_layer)
    del banks, views
    return out


def phase5_cases(dev, n_layer):
    """Phase 5's inputs over ``n_layer`` layer banks: phase 4's decode shape
    (8 rows from seeded starts) and its chunk shape (B=1, C=128 from 384)."""
    rng = np.random.default_rng(SEED + 5)
    starts = [int(s) for s in rng.integers(128, 576, 8)]
    return {
        "decode": make_case(rng, dev, rows=8, c=1, width=64, starts=starts,
                            layers=n_layer),
        "chunk": make_case(rng, dev, rows=1, c=128, width=64, starts=[384],
                           layers=n_layer),
    }


def phase5_kernel_time(dev, card, errs, launches) -> list:
    """The kernel's time at phase 5's shapes, bf16 and int8 pages, beside
    the bound, the plain version and SDPA."""
    from pipegoose_tpu_torch.ops import paged_attention as pa

    n_layer = 24
    cases = phase5_cases(dev, n_layer)
    starts = cases["decode"]["start"].tolist()
    log(f"phase 5: decode B=8 C=1 nh=16 hd=64 ps=16 W=64, starts {starts}; chunk B=1 "
        f"C=128 from 384; bf16 q; each call reads the next of {n_layer} layer banks "
        f"(L2-cold), on {card}")
    rows = []
    for kind, case in cases.items():
        for fmt, kv in (("bf16", "fp"), ("int8", "int8")):
            b, c, nh, hd = case["q"].shape
            plan = pa.paged_plan(b, c, nh, hd, 16, 64, torch.bfloat16,
                                 torch.bfloat16 if fmt == "bf16" else torch.int8)
            t = paged_time(case, fmt, n_layer, dev)
            bound_ms, bound_by = paged_bound_ms(case, fmt, plan["route"])
            (ms, call_ms), (plain_ms, _), (library_ms, _) = t["kernel"], t["plain"], t["library"]
            log(f"  {kind} {fmt} pages ({plan['route']} route, {plan['splits']} splits, "
                f"{plan['blocks']} blocks), device ms per call: kernel {ms}, bound "
                f"{bound_ms} ({bound_by}), plain {plain_ms}, SDPA {library_ms} [{card}]")
            log(f"  {kind} {fmt} pages, eager ms per call (host included): kernel "
                f"{call_ms}, plain {t['plain'][1]}, SDPA {t['library'][1]}")
            rows.append({
                "name": f"paged_attention ({fmt} pages, {kind}, {plan['route']} route)",
                **KERNEL, "kernel_route": plan["route"], "launches": launches[kv][plan["route"]],
                "max_abs_err": errs[f"{fmt} {kind}"], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
                "call_ms": call_ms,
            })
    return rows


def paged_prefill_vs_plain(np_tree, dev) -> None:
    """bf16 bloom-560m: a 512-token prompt prefilled in four 128-token chunks
    through the kernel (tensor-core route, 4 x 24 launches), fp and int8 KV,
    against the same chunks with kv_pool's paged attention patched to the
    plain version: last-position logits within 2^-5 of the largest, the
    greedy token equal unless the plain top-2 margin is below that."""
    from pipegoose_tpu_torch.models.bloom import BloomConfig
    from pipegoose_tpu_torch.models.weights import params_from_jax
    from pipegoose_tpu_torch.ops import paged_attention as pa
    from pipegoose_tpu_torch.serving import kv_pool

    cfg = BloomConfig.bloom_560m(dtype=torch.bfloat16)
    params = params_from_jax(np_tree, cfg, device=dev)
    prompt = np.random.default_rng(SEED + 50).integers(0, cfg.vocab_size, 512)
    for kv in (None, "int8"):
        before = pa.paged_attention.routes["mma"]
        got = prefill_logits(params, cfg, prompt, dev, kv, chunk=128)[0].float()
        if pa.paged_attention.routes["mma"] - before != 4 * cfg.n_layer:
            raise AssertionError(f"{kv or 'fp'} KV prefill: "
                                 f"{pa.paged_attention.routes['mma'] - before} tensor-core "
                                 f"launches, want {4 * cfg.n_layer}")
        kv_pool.paged_attention = pa.paged_attention_reference
        try:
            want = prefill_logits(params, cfg, prompt, dev, kv, chunk=128)[0].float()
        finally:
            kv_pool.paged_attention = pa.paged_attention
        err = (got - want).abs().max().item()
        tol = QUANT_LOGIT_RTOL * want.abs().max().item()
        top2 = torch.topk(want, 2).values
        margin = (top2[0] - top2[1]).item()
        tok_got, tok_want = int(got.argmax()), int(want.argmax())
        log(f"phase 5: bf16 prefill of {len(prompt)} tokens in 128-token chunks, "
            f"{kv or 'fp'} KV, kernel vs plain: logits max |diff| {err:.4g} (tol {tol:.4g}), "
            f"next token {tok_got} vs {tok_want} (plain top-2 margin {margin:.4g})")
        if not torch.isfinite(got).all() or err > tol:
            raise AssertionError(f"{kv or 'fp'} KV prefill: logits differ by {err} > {tol}")
        if tok_got != tok_want and margin >= tol:
            raise AssertionError(f"{kv or 'fp'} KV prefill: next token {tok_got} != "
                                 f"{tok_want} at a top-2 margin {margin} >= {tol}")
    del params
    gc.collect()
    torch.cuda.empty_cache()


# -- phase 6 -------------------------------------------------------------------

def flash_case(dev, dtype, *, b, s=1024, nh=16, nkv=16, hd=64, pad=0, seed=0):
    """Flattened flash-kernel operands: q, dO (B*nh, S, hd) and k, v
    (B*nkv, S, hd) in ``dtype`` from a seeded normal, BLOOM's ALiBi slopes,
    and kv_pos / kv_neg from a mask whose last row ends in ``pad`` padded
    keys (all ones when pad is 0)."""
    from pipegoose_tpu_torch.models.bloom import alibi_slopes
    from pipegoose_tpu_torch.ops.flash_attention import mask_to_kv_bias

    gen = torch.Generator(device=dev).manual_seed(seed)
    rand = lambda rows: torch.randn(rows, s, hd, device=dev, generator=gen).to(dtype)  # noqa: E731
    mask = torch.ones(b, s, device=dev)
    if pad:
        mask[-1, s - pad:] = 0
    kpos, kneg = (x[:, None].expand(b, nkv, s).reshape(b * nkv, s).contiguous()
                  for x in mask_to_kv_bias(mask))
    slopes = torch.from_numpy(alibi_slopes(nh)).to(dev).repeat(b)
    return {"q": rand(b * nh), "k": rand(b * nkv), "v": rand(b * nkv),
            "do": rand(b * nh), "slopes": slopes, "kpos": kpos, "kneg": kneg,
            "g": nh // nkv, "scale": hd ** -0.5}


def flash_args(case, causal=True, window=None):
    """(forward args, backward args without lse/delta, mode) of a case."""
    fwd = tuple(case[n] for n in ("q", "k", "v", "slopes", "kpos", "kneg"))
    return fwd, (case["scale"], causal, case["g"], window)


def flash_bwd_args(case, lse, delta):
    return (case["q"], case["k"], case["v"], case["do"], lse, delta,
            case["slopes"], case["kpos"], case["kneg"])


def flash_err(got, want, rtol):
    """(max abs error, tolerance) of a kernel output against its plain
    version; fails on a bad shape or a non-finite value."""
    if got.shape != want.shape or not torch.isfinite(got.float()).all():
        raise AssertionError(f"bad kernel output {tuple(got.shape)}")
    err = (got.float() - want.float()).abs().max().item()
    return err, FLASH_ATOL + rtol * want.float().abs().max().item()


def check_flash(label, case, causal=True, window=None, phase="phase 6") -> dict:
    """Each flash kernel once against its plain version on one case;
    every launch counter must move by exactly one. Returns each kernel's
    max abs error."""
    from pipegoose_tpu_torch.ops import flash_attention as fa

    fwd, mode = flash_args(case, causal, window)
    dtype = case["q"].dtype
    kernels = (fa.flash_fwd, fa.flash_dq, fa.flash_dkv)
    counts = tuple(f.launches for f in kernels)
    hd, s = case["q"].shape[2], case["q"].shape[1]
    route = fa.fwd_plan(dtype, hd, s, s)["route"]
    if fa.bwd_plan(dtype, hd, s)["route"] != route:
        raise AssertionError(f"{label}: the backward's plan left the forward's route")
    routed = tuple(f.routes[route] for f in kernels)
    out, lse = fa.flash_fwd(*fwd, *mode)
    ref_out, ref_lse = fa.flash_fwd_reference(*fwd, *mode)
    delta = (case["do"].float() * ref_out.float()).sum(-1)
    bwd = flash_bwd_args(case, ref_lse, delta)
    dq = fa.flash_dq(*bwd, *mode)
    dk, dv = fa.flash_dkv(*bwd, *mode)
    torch.cuda.synchronize()
    moved = tuple(f.launches - c for f, c in zip(kernels, counts))
    if moved != (1, 1, 1):
        raise AssertionError(f"{label}: launch counters moved by {moved}")
    if tuple(f.routes[route] - r for f, r in zip(kernels, routed)) != (1, 1, 1):
        raise AssertionError(f"{label}: a kernel left the {route} route")
    ref_dk, ref_dv = fa.flash_dkv_reference(*bwd, *mode)
    checks = {
        "out": flash_err(out, ref_out, FLASH_RTOL[dtype]),
        "lse": flash_err(lse, ref_lse, LSE_RTOL),
        "dq": flash_err(dq, fa.flash_dq_reference(*bwd, *mode), FLASH_RTOL[dtype]),
        "dk": flash_err(dk, ref_dk, FLASH_RTOL[dtype]),
        "dv": flash_err(dv, ref_dv, FLASH_RTOL[dtype]),
    }
    bad = [n for n, (err, tol) in checks.items() if err > tol]
    log(f"{phase}: {label} (all three on the {route} route): " + ", ".join(
        f"{n} {err:.3g} (tol {tol:.3g})" for n, (err, tol) in checks.items())
        + (f" FAIL {bad}" if bad else " ok"))
    if bad:
        raise AssertionError(f"{label}: flash kernels disagree with plain on {bad}")
    return {"fwd": max(checks["out"][0], checks["lse"][0]), "dq": checks["dq"][0],
            "dkv": max(checks["dk"][0], checks["dv"][0])}


def phase6_flash_vs_plain(dev) -> dict:
    """Returns the max abs errors of the bloom-560m bf16 case, the shape
    and dtype of phase 8's calls."""
    errs = {}
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        main = check_flash(f"{name} B=8 S=1024 nh=16 hd=64 causal",
                           flash_case(dev, dtype, b=8, seed=SEED))
        if dtype is torch.bfloat16:
            errs = main
        check_flash(f"{name} B=2 right-padded (300 keys)",
                    flash_case(dev, dtype, b=2, pad=300, seed=SEED + 1))
        check_flash(f"{name} B=2 S=100 (ragged tile)",
                    flash_case(dev, dtype, b=2, s=100, seed=SEED + 2))
        check_flash(f"{name} B=2 GQA nh=16 nkv=8",
                    flash_case(dev, dtype, b=2, nkv=8, seed=SEED + 3))
        check_flash(f"{name} B=2 window=64",
                    flash_case(dev, dtype, b=2, seed=SEED + 4), window=64)
        check_flash(f"{name} B=2 causal=False",
                    flash_case(dev, dtype, b=2, seed=SEED + 5), causal=False)
    return errs


# -- phase 7 -------------------------------------------------------------------

def phase7_train_vs_cpu(np_tree, dev):
    """Returns the CPU run, which phase 11 holds its options against."""
    return train_vs_cpu(np_tree, dev, "phase 7")[3]


def train_vs_cpu(np_tree, dev, label, cpu=None, **opts):
    """The float32 train step on the card against the same step on the
    CPU: full widths, depth cut to 2 layers, batch 2 x 256 with a
    right-padded row, remat and flash, plus the config options ``opts``.
    ``cpu``: an earlier call's CPU run (its losses and first gradients) to
    hold the card against, in place of running the CPU again: the options
    of phase 11 change the order of float32 sums (the fused and the chunked
    cross entropy) or what the backward recomputes (the remat policies),
    not the function, so the plain config's CPU step is their reference
    too, at the same tolerances. Returns the card's params after the
    steps, the config, the batch and the CPU run."""
    from pipegoose_tpu_torch.models.bloom import BloomConfig, loss_fn
    from pipegoose_tpu_torch.models.weights import grads_of, params_from_jax, params_to_jax
    from pipegoose_tpu_torch.trainer import make_optimizer, train_step

    n_layer, b, s, pad, lr = 2, 2, 256, 57, 1e-4
    vocab, hidden = np_tree["embed"]["weight"].shape
    cfg = BloomConfig(vocab_size=vocab, hidden_size=hidden, n_layer=n_layer,
                      n_head=16, **{"remat": True, "use_flash": True, **opts})
    tree = {**np_tree, "blocks": cut_layers(np_tree["blocks"], n_layer)}
    rng = np.random.default_rng(SEED + 7)
    ids = rng.integers(0, cfg.vocab_size, (b, s))
    mask = np.ones((b, s), np.int64)
    mask[1, s - pad:] = 0
    extra = "".join(f", {k}={v!r}" for k, v in opts.items())
    log(f"{label}: float32 train step, card vs CPU: vocab {vocab}, hidden "
        f"{hidden}, 16 heads, depth cut 24 -> {n_layer} layers, batch {b} x {s} (row 1 right-padded by {pad}), "
        f"remat={cfg.remat}, flash, Adam lr {lr}{extra}")
    runs = {} if cpu is None else {"cpu": cpu}
    for where in (("cpu",) if cpu is None else ()) + (dev,):
        t0 = time.perf_counter()
        params = params_from_jax(tree, cfg, device=where)
        opt = make_optimizer(params, lr)
        losses = [train_step(params, opt, ids, mask, ids, cfg, device=where).item()]
        grads = params_to_jax(grads_of(params))
        for _ in range(2):
            losses.append(train_step(params, opt, ids, mask, ids, cfg,
                                     device=where).item())
        with torch.no_grad():
            as_t = lambda a: torch.from_numpy(a).to(where)  # noqa: E731
            losses.append(loss_fn(params, as_t(ids), as_t(mask), as_t(ids), cfg).item())
        runs[str(where)] = (losses, grads, params if where != "cpu" else None)
        log(f"  {where}: losses {losses} in {time.perf_counter() - t0:.1f} s")
        del opt, params
    if cpu is not None:
        log(f"  cpu: phase 7's run of the plain config, losses {cpu[0]}")
    (cpu_losses, cpu_grads, _), (gpu_losses, gpu_grads, gpu_params) = (
        runs["cpu"], runs["cuda"])
    if not all(np.isfinite(gpu_losses)):
        raise AssertionError(f"non-finite card losses {gpu_losses}")
    loss_err = abs(gpu_losses[0] - cpu_losses[0])
    adam_err = max(abs(a - c) for a, c in zip(gpu_losses[1:], cpu_losses[1:]))
    worst = max(((path, leaf_rel_err(g, c)) for path, g, c in
                 zip_leaves(gpu_grads, cpu_grads)), key=lambda x: x[1])
    log(f"  loss err {loss_err} (atol {TRAIN_LOSS_ATOL}); worst gradient "
        f"{worst[0]} rel err {worst[1]} (rtol {TRAIN_GRAD_RTOL}); losses after "
        f"1-3 Adam steps err {adam_err} (atol {TRAIN_ADAM_LOSS_ATOL})")
    if (loss_err > TRAIN_LOSS_ATOL or worst[1] > TRAIN_GRAD_RTOL
            or adam_err > TRAIN_ADAM_LOSS_ATOL):
        raise AssertionError("card and CPU train steps disagree")
    return gpu_params, cfg, (ids, mask), runs["cpu"]


def init_trees(config, seed, stds) -> list:
    """``init_params_numpy(replace(config, initializer_range=std), seed)``
    for each std of ``stds``, bit for bit, from one draw: the tree at std 1
    (the draws times 1, exact), each normal leaf (every kernel and the
    embedding) then scaled in float32 as ``init_params_numpy`` scales it,
    the zeros and ones copied."""
    from pipegoose_tpu_torch.models.bloom import init_params_numpy

    unit = init_params_numpy(dataclasses.replace(config, initializer_range=1.0), seed)

    def scaled(tree, std, key=None, parent=None):
        if isinstance(tree, dict):
            return {k: scaled(v, std, k, key) for k, v in tree.items()}
        if key == "kernel" or (parent, key) == ("embed", "weight"):
            return tree * np.float32(std)
        return tree.copy()

    return [scaled(unit, std) for std in stds]


def cut_layers(blocks, n):
    """The first ``n`` layers of a stacked per-layer numpy subtree."""
    if isinstance(blocks, dict):
        return {k: cut_layers(v, n) for k, v in blocks.items()}
    return blocks[:n]


def zip_leaves(a, b, path=""):
    if isinstance(a, dict):
        for k in a:
            yield from zip_leaves(a[k], b[k], f"{path}/{k}")
    else:
        yield path, a, b


def leaf_rel_err(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# -- phase 8 -------------------------------------------------------------------

def phase8_timed_training(np_tree, dev, card) -> dict:
    """bench.py's "flash" variant on the card; returns its run (the flash
    launch counts of its 7 steps under "launches", its peak memory)."""
    from pipegoose_tpu_torch.models.bloom import BloomConfig

    cfg = BloomConfig.bloom_560m(dtype=torch.bfloat16, remat=True, use_flash=True)
    return timed_training(np_tree, dev, card, cfg, "phase 8",
                          "'flash': remat, flash, fused_ce off")


def kernel_counters():
    """Every ported training kernel's launch counter, by name."""
    from pipegoose_tpu_torch.ops import flash_attention as fa
    from pipegoose_tpu_torch.ops import fused_ce as fce

    return {"fwd": fa.flash_fwd, "dq": fa.flash_dq, "dkv": fa.flash_dkv,
            "fused_ce_fwd": fce.fused_ce_fwd, "fused_ce_dh": fce.fused_ce_dh,
            "fused_ce_dw": fce.fused_ce_dw, "chunk_fwd": fa.flash_ring_chunk,
            "chunk_dq": fa.flash_chunk_dq, "chunk_dkv": fa.flash_chunk_dkv}


def timed_training(np_tree, dev, card, cfg, label, variant, batch=8, seq=1024,
                   step_fn=None, fwd_route=None) -> dict:
    """Timed bf16 train steps (by default at bench.py's shape, batch 8 x 1024)
    of RandomState(0) ids, labels = ids, no mask, Adam 1e-4, 2 warm-up and 5
    timed steps between CUDA events, every launch counter set to 0 just
    before the steps and read just after; then one profiled step.
    ``step_fn`` is ``train_step`` unless given (``sp_train_step`` runs the
    ring: its chunk kernels take the flash kernels' launches). Fails unless
    the kernels launch as ``cfg`` asks, each fused CE kernel on the route its
    plan picks (the forward on ``fwd_route`` when given) with the (V, H)
    weight, and the losses fall."""
    from pipegoose_tpu_torch.models.weights import param_leaves, params_from_jax
    from pipegoose_tpu_torch.trainer import make_optimizer, sp_train_step, train_step

    step_fn = step_fn or train_step
    warm, timed = 2, 5
    params = params_from_jax(np_tree, cfg, device=dev)
    opt = make_optimizer(params, 1e-4)
    ids = torch.from_numpy(
        np.random.RandomState(0).randint(0, cfg.vocab_size, (batch, seq))).to(dev)
    n_params = sum(t.numel() for t in param_leaves(params))
    log(f"{label}: bloom-560m bf16 train step (bench.py {variant}), batch {batch} "
        f"x {seq}, Adam 1e-4, {n_params} params, {warm} warm-up + {timed} timed "
        f"steps, on {card}")

    def step():
        return step_fn(params, opt, ids, None, ids, cfg, device=dev)

    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
        for by in (getattr(c, "routes", {}), getattr(c, "layouts", {})):
            for r in by:
                by[r] = 0
    losses = [step() for _ in range(warm)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    losses += [step() for _ in range(timed)]
    t1.record()
    torch.cuda.synchronize()
    counts = {name: c.launches for name, c in counters.items()}
    routes = {name: dict(c.routes) for name, c in counters.items() if hasattr(c, "routes")}
    layouts = {name: dict(c.layouts) for name, c in counters.items() if hasattr(c, "layouts")}
    steps = warm + timed
    step_ms = t0.elapsed_time(t1) / timed
    tokens_per_s = batch * seq / (step_ms / 1e3)
    flops_per_token = 6 * n_params + 12 * cfg.n_layer * cfg.hidden_size * seq
    mfu = tokens_per_s * flops_per_token / BF16_FLOPS_PER_S
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = [x.item() for x in losses]
    log(f"  step {step_ms} ms, {tokens_per_s} tokens/s, MFU {mfu} (bench.py's "
        f"{flops_per_token} flops/token over 989 TFLOP/s bf16), peak "
        f"{peak_gib:.2f} GiB")
    log(f"  losses over {steps} steps on one batch: {losses}")
    fwd_per_layer = 2 if cfg.remat else 1
    attn = "chunk_" if step_fn is sp_train_step else ""   # the ring at sp = 1
    per_step = {k: 0 for k in counters}
    per_step.update({f"{attn}fwd": fwd_per_layer * cfg.n_layer,
                     f"{attn}dq": cfg.n_layer, f"{attn}dkv": cfg.n_layer})
    per_step.update({k: int(cfg.fused_ce) for k in
                     ("fused_ce_fwd", "fused_ce_dh", "fused_ce_dw")})
    want = {k: steps * n for k, n in per_step.items()}
    log(f"  launches over {steps} steps {counts}; want per step {per_step} "
        f"(flash fwd {fwd_per_layer} x {cfg.n_layer} layers"
        f"{': remat recomputes the forward' if cfg.remat else ''})")
    if counts != want:
        raise AssertionError(f"{label}: the training step bypassed a kernel")
    from pipegoose_tpu_torch.ops import fused_ce as fce

    route = "mma" if cfg.dtype == torch.bfloat16 else "fma"
    # the fused CE kernels' routes by their plans (the WMMA kernels in float32)
    t_ce = batch * (seq - 1)
    ce_route = fce.bwd_plan(cfg.dtype, t_ce, cfg.hidden_size, cfg.vocab_size, "dh")["route"]
    fwd_route = fwd_route or fce.fwd_plan(cfg.dtype, t_ce, cfg.hidden_size, cfg.vocab_size,
                                          True)["route"]
    want_route = {n: ce_route if n.startswith("fused_ce") else route for n in routes}
    want_route["fused_ce_fwd"] = fwd_route
    log(f"  launches by route over {steps} steps: B1 {routes['fwd']}, B2 {routes['dq']}, B3 "
        f"{routes['dkv']}, B4 {routes['fused_ce_fwd']}, B5 {routes['fused_ce_dh']}, B6 "
        f"{routes['fused_ce_dw']}, B7 {routes['chunk_fwd']}, B8 {routes['chunk_dq']}, B9 "
        f"{routes['chunk_dkv']}; all must be {route}, B4 {fwd_route}, B5/B6 {ce_route}; "
        f"fused CE by layout {layouts} (all (V, H), 'vh')")
    if any(routes[n][want_route[n]] != counts[n] or sum(routes[n].values()) != counts[n]
           for n in routes):
        raise AssertionError(f"{label}: a kernel left its route")
    if any(n["vh"] != counts[name] or sum(n.values()) != counts[name]
           for name, n in layouts.items()):
        raise AssertionError(f"{label}: fused CE launches by layout {layouts} are not all "
                             f"(V, H)")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    _, busy_ms, kernels = profile_device(step, 1, "one profiled train step",
                                         "step", top=10)
    fused_ms = sum(e.self_device_time_total for e in kernels
                   if "fused_ce" in e.key) / 1e3
    if cfg.fused_ce:
        log(f"  fused cross-entropy kernels: {fused_ms} ms of the profiled step's "
            f"{busy_ms} ms device time "
            f"({100 * fused_ms / busy_ms if busy_ms else float('nan'):.1f}%)")
    if attn:
        chunk_ms = sum(e.self_device_time_total for e in kernels
                       if "chunk_" in e.key) / 1e3
        log(f"  chunk kernels B7-B9: {chunk_ms} ms of the profiled step's {busy_ms} ms "
            f"device time ({100 * chunk_ms / busy_ms if busy_ms else float('nan'):.1f}%)")
    run = {"launches": {k: v for k, v in counts.items() if want[k]}, "routes": routes,
           "layouts": layouts, "step_ms": step_ms, "peak_gib": peak_gib, "losses": losses,
           "tokens_per_s": tokens_per_s, "mfu": mfu}
    del params, opt
    return run


# -- phase 9 -------------------------------------------------------------------

def time_eager_ms(fn, calls):
    """Per-call ms of ``fn()`` called ``calls`` times eagerly between CUDA
    events, after a warm-up call."""
    fn()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0.record()
    for _ in range(calls):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / calls


def flash_bound_ms(kind, case, tensors, causal=True):
    """Least time for one call: the flops of the visible (q, k) pairs (fwd
    4 hd, dq 6 hd, dkv 8 hd per pair) at 989 TFLOP/s bf16, against every
    input read once and every output written once at 3.35 TB/s."""
    bh, s, hd = case["q"].shape
    pairs = bh * (s * (s + 1) // 2 if causal else s * s)
    flops = {"fwd": 4, "dq": 6, "dkv": 8}[kind] * hd * pairs
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    t_ops, t_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def parent_turns(kernel, parent, calls, replays=20):
    """Device ms per call of this revision's ``kernel`` and of ``parent``,
    timed in turns (parent, kernel, kernel, parent) in one process:
    (kernel's two, parent's two)."""
    p0 = time_ms(parent, calls, replays)[0]
    k0 = time_ms(kernel, calls, replays)[0]
    k1 = time_ms(kernel, calls, replays)[0]
    return [k0, k1], [p0, time_ms(parent, calls, replays)[0]]


def parent_fn(lib, entry, n_ptr, n_int):
    """A parent library's C entry with its ctypes signature."""
    import ctypes

    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def parent_calls(lib, prefix, ins, outs, ints, scale):
    """For each kernel kind of ``ins``, a call of the parent library's bf16
    entry ``{prefix}_{kind}_bf16`` on the tensors ``ins[kind]``, writing into
    new tensors shaped as ``outs[kind]``. Returns ({kind: call}, {kind: the
    tensors it writes})."""
    calls, written = {}, {}
    for kind, tensors in ins.items():
        written[kind] = tuple(torch.empty_like(t) for t in outs[kind])
        ptrs = tensors + written[kind]
        fn = parent_fn(lib, f"{prefix}_{kind}_bf16", len(ptrs), len(ints))
        calls[kind] = (lambda i, fn=fn, ptrs=ptrs: fn(
            *(t.data_ptr() for t in ptrs), *ints, scale,
            torch.cuda.current_stream().cuda_stream))
    return calls, written


def sdpa_ms(case, b, nh, s, hd):
    """The flash kernels' library yardstick on a case's (B, nh, S, hd) bf16
    q, k, v: SDPA with the ALiBi and causal terms as one additive bias.
    (forward device ms, backward ms: dq, dk and dv in one autograd call,
    timed eagerly, since autograd runs it on a worker thread, outside a
    CUDA graph capture)."""
    from pipegoose_tpu_torch.models.bloom import NEG_INF

    dev = case["q"].device
    heads = lambda t: t.reshape(b, nh, s, hd).detach().clone().requires_grad_()  # noqa: E731
    qs, ks, vs = heads(case["q"]), heads(case["k"]), heads(case["v"])
    kpos = torch.arange(s, device=dev, dtype=torch.float32)
    keep = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
    bias = torch.where(keep, case["slopes"][:nh, None, None] * kpos, NEG_INF)
    bias = bias[None].to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    so = sdpa(qs, ks, vs, attn_mask=bias)
    go = case["do"].reshape(b, nh, s, hd)
    with torch.no_grad():
        fwd_ms, _ = time_ms(lambda i: sdpa(qs, ks, vs, attn_mask=bias), 8)
    bwd_ms = time_eager_ms(
        lambda: torch.autograd.grad(so, (qs, ks, vs), go, retain_graph=True), 8)
    return fwd_ms, bwd_ms


def phase9_flash_time(dev, card, errs, launches, parent=None) -> list:
    from pipegoose_tpu_torch.ops import flash_attention as fa

    b, nh, s, hd = 8, 16, 1024, 64
    case = flash_case(dev, torch.bfloat16, b=b, seed=SEED + 9)
    fwd, mode = flash_args(case)
    out, lse = fa.flash_fwd(*fwd, *mode)
    delta = (case["do"].float() * out.float()).sum(-1)
    bwd = flash_bwd_args(case, lse, delta)
    dq = fa.flash_dq(*bwd, *mode)
    dk, dv = fa.flash_dkv(*bwd, *mode)
    io_out = {"fwd": (out, lse), "dq": (dq,), "dkv": (dk, dv)}
    io = {"fwd": fwd + io_out["fwd"], "dq": bwd + io_out["dq"], "dkv": bwd + io_out["dkv"]}
    calls = {
        "fwd": (lambda i: fa.flash_fwd(*fwd, *mode),
                lambda i: fa.flash_fwd_reference(*fwd, *mode)),
        "dq": (lambda i: fa.flash_dq(*bwd, *mode),
               lambda i: fa.flash_dq_reference(*bwd, *mode)),
        "dkv": (lambda i: fa.flash_dkv(*bwd, *mode),
                lambda i: fa.flash_dkv_reference(*bwd, *mode)),
    }
    lib_fwd_ms, lib_bwd_ms = sdpa_ms(case, b, nh, s, hd)
    log(f"phase 9: flash kernels at phase 8's shape (B*nh={b * nh}, S={s}, "
        f"hd={hd}, bf16, causal, no padding), device ms per call, on {card}")
    bwd_route = fa.bwd_plan(torch.bfloat16, hd, s)["route"]
    routes = {"fwd": fa.fwd_plan(torch.bfloat16, hd, s, s)["route"], "dq": bwd_route,
              "dkv": bwd_route}
    mangled = {kind: f"flash_{kind}_mma_kernelILi{hd}E" for kind in ("fwd", "dq", "dkv")}
    old = {}   # a call of the parent's kernel of each kind on this run's inputs
    if parent:
        old, _ = parent_calls(parent["flash_attention"], "flash",
                              {"fwd": fwd, "dq": bwd, "dkv": bwd}, io_out,
                              (b * nh, s, hd, 1, 1, 0), case["scale"])
    rows = []
    for kind in ("fwd", "dq", "dkv"):
        kernel, plain = calls[kind]
        ms, call_ms = time_ms(kernel, 8)
        plain_ms, _ = time_ms(plain, 4)
        bound_ms, bound_by = flash_bound_ms(kind, case, io[kind])
        library_ms = lib_fwd_ms if kind == "fwd" else lib_bwd_ms
        regs, spills = ptxas_usage("flash_attention", mangled[kind])
        turns = None
        if kind in old:
            turns = parent_turns(kernel, old[kind], 8)
            log(f"  flash_{kind} in turns with the parent's kernel (parent, this, this, "
                f"parent): this {turns[0]}, parent {turns[1]}")
        log(f"  flash_{kind} ({routes[kind]} route, {regs} registers, {spills} bytes spilled): "
            f"kernel {ms} (eager {call_ms}), bound {bound_ms} "
            f"({bound_by}), plain {plain_ms}, SDPA {'forward' if kind == 'fwd' else 'backward (dq, dk, dv in one call, eager)'} "
            f"{library_ms}")
        rows.append({
            "name": f"flash_{kind} (bf16, B*nh=128, S=1024, hd=64, causal, {routes[kind]} route)",
            "source": FLASH_SOURCE, "replaces": FLASH_REPLACES[kind],
            "route": "cuda", "kernel_route": routes[kind], "launches": launches[kind],
            "max_abs_err": errs[kind], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "call_ms": call_ms, "registers": regs,
            "spill_store_bytes": spills,
            **({"turns_ms": turns[0], "parent_turns_ms": turns[1]} if turns else {}),
        })
    return rows


# -- phase 10 ------------------------------------------------------------------

def fused_case(dev, dtype, *, t, hd, v, offset=0, valid=None, vh=True, seed=0):
    """Fused CE operands: h (T, H) unit normal (a final LayerNorm's scale),
    w like BLOOM's embedding (normal, std 0.02) in the "vh" (V, H) or "hv"
    (H, V) layout, seeded targets over [0, offset + V), and g = 1/T per
    token (the mean loss's cotangent)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn(t, hd, device=dev, generator=gen).to(dtype)
    w = (torch.randn(v, hd, device=dev, generator=gen) * 0.02).to(dtype)
    if not vh:
        w = w.t().contiguous()
    targets = torch.randint(0, offset + v, (t,), device=dev, generator=gen,
                            dtype=torch.int32)
    g = torch.full((t,), 1.0 / t, device=dev)
    return {"h": h, "w": w, "targets": targets, "g": g, "offset": offset,
            "valid": valid, "vh": vh}


def fused_err(got, want, rtol):
    """(max abs error, tolerance) against the largest finite |plain| value
    (entries of -1e9, masked target logits, are left out of the scale)."""
    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"bad kernel output {tuple(got.shape)}")
    finite = want.abs() < 1e8
    scale = want[finite].abs().max().item() if finite.any() else 0.0
    return (got - want).abs().max().item(), rtol * scale


def check_fused(label, case, fwd_route=None, phase="phase 10") -> dict:
    """Each fused kernel once against its plain version on one case; every
    launch counter must move by exactly one, the forward's on ``fwd_route``
    (default: bf16 "wgmma", float32 "wmma") and the backward kernels' on
    their dtype's route (bf16 "mma", float32 "wmma"). Returns each kernel's
    max abs error."""
    from pipegoose_tpu_torch.ops import fused_ce as fce

    dtype = case["h"].dtype
    fwd = (case["h"], case["w"], case["targets"], case["offset"], case["valid"],
           case["vh"])
    t, hd = case["h"].shape
    v = case["w"].shape[0] if case["vh"] else case["w"].shape[1]
    route = fce.bwd_plan(dtype, t, hd, v, "dh")["route"]
    if route != ("mma" if dtype == torch.bfloat16 else "wmma"):
        raise AssertionError(f"{label}: the backward plan names the {route} route")
    fwd_route = fwd_route or ("wgmma" if dtype == torch.bfloat16 else "wmma")
    planned = fce.card_fwd_plan(case["h"], case["w"], case["vh"])["route"]
    if planned != fwd_route:
        raise AssertionError(f"{label}: the forward plan names the {planned} route, "
                             f"not {fwd_route}")
    counters = (fce.fused_ce_fwd, fce.fused_ce_dh, fce.fused_ce_dw)
    before = tuple(c.launches for c in counters)
    routed = (fce.fused_ce_fwd.routes[fwd_route],) + tuple(
        c.routes[route] for c in counters[1:])
    lse, tl = fce.fused_ce_fwd(*fwd)
    ref_lse, ref_tl = fce.fused_ce_fwd_reference(*fwd)
    bwd = (case["h"], case["w"], case["targets"], ref_lse, case["g"],
           case["offset"], case["valid"], case["vh"])
    dh = fce.fused_ce_dh(*bwd)
    dw = fce.fused_ce_dw(*bwd)
    torch.cuda.synchronize()
    moved = tuple(c.launches - b for c, b in zip(counters, before))
    if moved != (1, 1, 1):
        raise AssertionError(f"{label}: launch counters moved by {moved}")
    if (fce.fused_ce_fwd.routes[fwd_route] - routed[0],) + tuple(
            c.routes[route] - r for c, r in zip(counters[1:], routed[1:])) != (1, 1, 1):
        raise AssertionError(f"{label}: a launch left its route (fwd {fwd_route}, "
                             f"dh/dw {route})")
    checks = {"lse": fused_err(lse, ref_lse, FUSED_STAT_RTOL),
              "target logit": fused_err(tl, ref_tl, FUSED_STAT_RTOL)}
    del ref_lse, ref_tl
    checks["dh"] = fused_err(dh, fce.fused_ce_dh_reference(*bwd), FUSED_GRAD_RTOL[dtype])
    checks["dw"] = fused_err(dw, fce.fused_ce_dw_reference(*bwd), FUSED_GRAD_RTOL[dtype])
    bad = [n for n, (err, tol) in checks.items() if err > tol]
    log(f"{phase}: {label} (fwd {fwd_route}, dh/dw {route} route): " + ", ".join(
        f"{n} {err:.3g} (tol {tol:.3g}, {err / tol if tol else float('inf'):.2f} of it)"
        for n, (err, tol) in checks.items())
        + (f" FAIL {bad}" if bad else " ok"))
    if bad:
        raise AssertionError(f"{label}: fused kernels disagree with plain on {bad}")
    return {"fwd": max(checks["lse"][0], checks["target logit"][0]),
            "dh": checks["dh"][0], "dw": checks["dw"][0]}


def phase10_fused_vs_plain(dev) -> dict:
    """Returns the max abs errors at bench.py's shape in bf16, the shape
    and dtype of phase 12's calls, by layout ("vh", "hv")."""
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for vh in (True, False):
            check_fused(f"{name} T=100 H=1024 V=1000 offset=300 valid=1283 "
                        f"{'vh' if vh else 'hv'}",
                        fused_case(dev, dtype, t=100, hd=1024, v=1000, offset=300,
                                   valid=1283, vh=vh, seed=SEED + 10))
    # an (H, V) weight whose rows TMA cannot address (V % 8 != 0): "wmma"
    check_fused("bf16 T=100 H=1024 V=1001 offset=300 valid=1283 hv",
                fused_case(dev, torch.bfloat16, t=100, hd=1024, v=1001, offset=300,
                           valid=1283, vh=False, seed=SEED + 10), fwd_route="wmma")
    errs = {}
    for vh in (True, False):
        layout = "vh" if vh else "hv"
        errs[layout] = check_fused(f"bf16 T=8184 H=1024 V=250880 {layout} (bench.py's shape)",
                                   fused_case(dev, torch.bfloat16, t=8 * 1023, hd=1024,
                                              v=250880, vh=vh, seed=SEED + 11))
        gc.collect()
        torch.cuda.empty_cache()
    return errs


# -- phase 11 ------------------------------------------------------------------

def phase11_train_options_vs_cpu(np_tree, dev, cpu) -> None:
    """Phase 7's check with each option of this slice, against phase 7's
    CPU run ``cpu`` (``train_vs_cpu``); the fused run's kernels must
    launch, and its loss must equal the full-logits loss of the same
    weights on the card."""
    from pipegoose_tpu_torch.models.bloom import loss_fn

    counters = kernel_counters()
    for opts in (dict(fused_ce=True), dict(ce_chunks=8),
                 dict(remat_policy="dots"), dict(remat_policy="attn")):
        for c in counters.values():
            c.launches = 0
        params, cfg, (ids, mask), _ = train_vs_cpu(np_tree, dev, "phase 11", cpu=cpu, **opts)
        counts = {n: c.launches for n, c in counters.items() if "fused" in n}
        if cfg.fused_ce:
            # 3 steps and the last loss: 4 forwards, 3 backwards
            log(f"  fused launches {counts}; want fwd 4, dh 3, dw 3")
            if counts != {"fused_ce_fwd": 4, "fused_ce_dh": 3, "fused_ce_dw": 3}:
                raise AssertionError("the fused train step bypassed its kernels")
            with torch.no_grad():
                as_t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
                fused = loss_fn(params, as_t(ids), as_t(mask), as_t(ids), cfg).item()
                full = loss_fn(params, as_t(ids), as_t(mask), as_t(ids),
                               dataclasses.replace(cfg, fused_ce=False)).item()
            log(f"  card: fused loss {fused}, full-logits loss {full}, err "
                f"{abs(fused - full)} (atol {TRAIN_LOSS_ATOL})")
            if abs(fused - full) > TRAIN_LOSS_ATOL:
                raise AssertionError("fused and full-logits losses disagree")
        elif any(counts.values()):
            raise AssertionError(f"fused kernels launched without fused_ce: {counts}")
        del params
        gc.collect()
        torch.cuda.empty_cache()


# -- phase 12 ------------------------------------------------------------------

def phase12_timed_variants(np_tree, dev, card, flash_peak_gib) -> dict:
    """bench.py's fused and chunked variants, timed as phase 8. Returns the
    runs by variant name."""
    from pipegoose_tpu_torch.models.bloom import BloomConfig

    variants = {
        "flash+fusedce": dict(remat=True, use_flash=True, fused_ce=True),
        "noremat+flash+fusedce": dict(remat=False, use_flash=True, fused_ce=True),
        "flash+ce8": dict(remat=True, use_flash=True, ce_chunks=8),
    }
    runs = {}
    for name, kw in variants.items():
        cfg = BloomConfig.bloom_560m(dtype=torch.bfloat16, **kw)
        runs[name] = timed_training(np_tree, dev, card, cfg, "phase 12",
                                    f"'{name}'")
        gc.collect()
        torch.cuda.empty_cache()
        if cfg.fused_ce and not runs[name]["peak_gib"] < flash_peak_gib:
            raise AssertionError(
                f"{name}: peak {runs[name]['peak_gib']:.2f} GiB is not below the "
                f"full-logits step's {flash_peak_gib:.2f} GiB")
    log("phase 12: " + ", ".join(
        f"{n} {r['step_ms']:.1f} ms / {r['peak_gib']:.2f} GiB" for n, r in runs.items())
        + f" (phase 8 'flash' peak {flash_peak_gib:.2f} GiB)")
    return runs


# -- phase 13 ------------------------------------------------------------------

def fused_bound_ms(kind, case, tensors):
    """Least time for one call: 2 T V H flops for the forward's logits, 4 T
    V H for dh and dw (the logits and the second product) at 989 TFLOP/s
    bf16, against every input read once and every output written once at
    3.35 TB/s."""
    t, hd = case["h"].shape
    v = case["w"].shape[0] if case["vh"] else case["w"].shape[1]
    flops = (2 if kind == "fwd" else 4) * t * v * hd
    nbytes = sum(x.numel() * x.element_size() for x in tensors)
    t_ops, t_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def fused_library(h, w, targets, g, vh, offset=0):
    """The fused kernels' library yardstick, a composite: the full-logits
    path's PyTorch calls for the same function on this weight (a vocab
    shard's local work at ``offset``). fwd: the bf16 cuBLAS logits,
    logsumexp and a gather; dh and dw: softmax minus one-hot from the saved
    float32 logits, times g, in bf16, then one cuBLAS product each. Returns
    the calls by kind."""
    t = h.shape[0]
    v = w.shape[0] if vh else w.shape[1]
    rows_t = torch.arange(t, device=h.device)
    tg = (targets.long() - offset).clamp(0, v - 1)
    wv = w.t() if vh else w                      # (H, V) view

    def lib_fwd():
        lg = torch.matmul(h, wv).float()
        return torch.logsumexp(lg, dim=-1), lg.gather(1, tg[:, None])

    saved = torch.matmul(h, wv).float()

    def lib_dl():
        p = torch.softmax(saved, dim=-1)
        p[rows_t, tg] -= 1.0
        return (p * g[:, None]).to(torch.bfloat16)

    return {"fwd": lib_fwd, "dh": lambda: torch.matmul(lib_dl(), wv.t()),
            "dw": (lambda: torch.matmul(lib_dl().t(), h)) if vh
            else (lambda: torch.matmul(h.t(), lib_dl()))}


def phase13_fused_time(dev, card, errs, run, parent=None) -> list:
    """Each fused kernel at phase 12's shape, with a (V, H) weight (bench.py's
    tied embedding) and with an (H, V) one. A row's launches are phase 12's
    ``run``'s by layout: the (H, V) kernels' are that step's (H, V)
    launches, which BLOOM's tied (V, H) embedding never makes. With the
    parent, its bf16 forward in turns with this one."""
    from pipegoose_tpu_torch.ops import fused_ce as fce

    t, hd, v = 8 * 1023, 1024, 250880
    rows = []
    for vh in (True, False):
        layout = "vh" if vh else "hv"
        case = fused_case(dev, torch.bfloat16, t=t, hd=hd, v=v, vh=vh, seed=SEED + 13)
        h, w, targets, g = case["h"], case["w"], case["targets"], case["g"]
        lse, tl = fce.fused_ce_fwd(h, w, targets, 0, None, vh)
        bwd = (h, w, targets, lse, g, 0, None, vh)
        dh = fce.fused_ce_dh(*bwd)
        dw = fce.fused_ce_dw(*bwd)
        io = {"fwd": (h, w, targets, lse, tl), "dh": bwd[:5] + (dh,), "dw": bwd[:5] + (dw,)}
        calls = {
            "fwd": (lambda i: fce.fused_ce_fwd(h, w, targets, 0, None, vh),
                    lambda: fce.fused_ce_fwd_reference(h, w, targets, 0, None, vh)),
            "dh": (lambda i: fce.fused_ce_dh(*bwd), lambda: fce.fused_ce_dh_reference(*bwd)),
            "dw": (lambda i: fce.fused_ce_dw(*bwd), lambda: fce.fused_ce_dw_reference(*bwd)),
        }
        library = fused_library(h, w, targets, g, vh)
        old = parent_ce_fwd(parent["fused_ce"]) if parent else None
        log(f"phase 13: fused CE kernels at phase 12's shape (T={t}, H={hd}, V={v}, "
            f"bf16, {layout}), device ms per call, on {card}")
        for kind in ("fwd", "dh", "dw"):
            kernel, plain = calls[kind]
            ms, call_ms = time_ms(kernel, 2, replays=5)
            plain_ms = time_eager_ms(plain, 2)
            library_ms = time_eager_ms(library[kind], 2)
            bound_ms, bound_by = fused_bound_ms(kind, case, io[kind])
            name = f"fused_ce_{kind}"
            row = {"name": f"{name} (bf16, T={t}, H={hd}, V={v}, {layout})", "route": "cuda",
                   "launches": run["layouts"][name][layout],
                   "max_abs_err": errs[layout][kind], "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
                   "call_ms": call_ms}
            if kind == "fwd":
                plan = fce.card_fwd_plan(h, w, vh)
                if plan["route"] != "wgmma":
                    raise AssertionError(f"phase 13: the bf16 forward planned {plan['route']}")
                regs, spills = ptxas_usage(
                    "fused_ce_fwd_wgmma", f"fused_ce_fwd_wgmma_kernelILi{plan['bn']}ELb{int(not vh)}E")
                row.update(source=FUSED_FWD_SOURCE, replaces=FUSED_REPLACES[kind],
                           kernel_route=plan["route"], bn=plan["bn"], splits=plan["splits"],
                           stages=plan["stages"], smem_bytes=plan["smem_bytes"],
                           registers=regs, spill_store_bytes=spills,
                           tflops=2 * t * v * hd / (ms * 1e9))
                extra = (f"{plan['route']} route, BM {plan['bm']}, BN {plan['bn']}, "
                         f"{plan['stages']} stages, {plan['splits']} splits, "
                         f"{plan['smem_bytes']} bytes of shared memory, {regs} registers "
                         f"(launch bound; setmaxnreg moves them), {spills} bytes spilled, "
                         f"{row['tflops']:.1f} TFLOP/s; ")
                if old is not None:
                    turns = parent_turns(kernel, lambda i: old(h, w, targets, 0, None, vh),
                                         2, replays=5)
                    log(f"  fused_ce_fwd in turns with the parent's kernel (fused_ce.cu WMMA; "
                        f"parent, this, this, parent): this {turns[0]}, parent {turns[1]}")
                    row.update(turns_ms=turns[0], parent_turns_ms=turns[1])
            else:
                plan = fce.card_plan(h, w, kind, vh)
                mangled = (f"fused_ce_bwd_mma_kernelILb{int(kind == 'dw')}ELb{int(not vh)}"
                           f"ELi{plan['bm']}E")
                regs, spills = ptxas_usage("fused_ce_mma", mangled)
                row.update(source=FUSED_MMA_SOURCE, replaces=FUSED_REPLACES[kind],
                           kernel_route=plan["route"], cluster=plan["cluster"],
                           bm=plan["bm"], splits=plan["splits"], registers=regs,
                           spill_store_bytes=spills)
                extra = (f"{plan['route']} route, cluster {plan['cluster']}, BM {plan['bm']}, "
                         f"{plan['splits']} split(s), {regs} registers, {spills} bytes "
                         f"spilled; ")
            log(f"  fused_ce_{kind} ({extra}kernel {ms} (eager {call_ms}), bound {bound_ms} "
                f"({bound_by}), plain {plain_ms}, full-logits composite {library_ms}; "
                f"{row['launches']} {layout} launches in phase 12's 'flash+fusedce' steps")
            rows.append(row)
            gc.collect()
            torch.cuda.empty_cache()
        del case, calls, library, io, old
        gc.collect()
        torch.cuda.empty_cache()
    return rows


# -- phase 14 ------------------------------------------------------------------

def quant_case(dev, kind, k, n, t, dtype, seed, layers=1):
    """x (T, K) unit normal in ``dtype`` and ``layers`` weights like BLOOM's
    (normal, std 0.02) quantized on the card: int8, or int4 with G = 32."""
    from pipegoose_tpu_torch.quant.weights import QuantSpec, _quantize_kernel

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(t, k, device=dev, generator=gen).to(dtype)
    leaves = [_quantize_kernel(torch.randn(k, n, device=dev, generator=gen) * 0.02,
                               QuantSpec(kind, 32)) for _ in range(layers)]
    return x, [(leaf["q"], leaf["scale"]) for leaf in leaves]


def check_quant_call(kind, route, x, q, scale, forced):
    """One product through ``route`` against the plain version; returns
    (max |diff|, tolerance, y). ``forced`` launches the float32 route for
    any x; otherwise the wrapper picks, and must pick ``route``."""
    from pipegoose_tpu_torch.quant import matmul as qm

    wrapper = getattr(qm, f"quantized_matmul_{kind}")
    before, routes = wrapper.launches, dict(wrapper.routes)
    y = qm._launch(kind, x, q, scale, route=route) if forced else wrapper(x, q, scale)
    torch.cuda.synchronize()
    if wrapper.launches != before + 1 or wrapper.routes[route] != routes[route] + 1:
        raise AssertionError(f"{kind}: the {route} route's launch counter did not move")
    ref = qm.quantized_matmul_reference(x, q, scale)
    if y.shape != ref.shape or y.dtype != torch.float32 or not torch.isfinite(y).all():
        raise AssertionError(f"{kind} {route}: bad output {tuple(y.shape)} {y.dtype}")
    return (y - ref).abs().max().item(), QUANT_RTOL * ref.abs().max().item(), y


def phase14_quant_vs_plain(np_tree, dev) -> dict:
    """Both quantized matmul kernels against their plain version at
    bloom-560m's four products and T in {1, 8, 128, 512}: the tensor-core
    route (bf16 x), the float32 route (float32 x, and bf16 x forced onto
    it); quantized_linear with a bias equal to the unfused composite bit
    for bit; then the card's quantize_params against the CPU's on the full
    tree, and a bf16 prefill with quantized weights through the kernels
    against the plain composite. Returns each kernel's largest tensor-core
    error at T = 8 and 128, phase 17's dtype and shapes."""
    from pipegoose_tpu_torch.models.bloom import BloomConfig
    from pipegoose_tpu_torch.models.weights import params_from_jax
    from pipegoose_tpu_torch.quant import matmul as qm
    from pipegoose_tpu_torch.quant.weights import QuantSpec, quantize_params

    errs = {"int8": 0.0, "int4": 0.0}
    arms = (("mma", torch.bfloat16, False), ("fma", torch.float32, False),
            ("fma", torch.bfloat16, True))
    for kind in ("int8", "int4"):
        for route, dtype, forced in arms:
            name = f"{route} route, {str(dtype).split('.')[-1]} x"
            for t in (1, 8, 128, 512):
                parts = []
                for i, (k, n) in enumerate(BLOOM_KN):
                    x, [(q, scale)] = quant_case(dev, kind, k, n, t, dtype, SEED + 14 + i)
                    err, tol, y = check_quant_call(kind, route, x, q, scale, forced)
                    parts.append(f"{k}x{n} {err:.3g} (tol {tol:.3g})")
                    if err > tol:
                        raise AssertionError(f"{kind} {name} T={t} {k}x{n}: kernel "
                                             f"disagrees with plain: {err} > {tol}")
                    if route == "mma":
                        if t in (8, 128):
                            errs[kind] = max(errs[kind], err)
                        bias = torch.randn(n, device=dev).to(dtype) * 0.1
                        lin = qm.quantized_linear(x, q, scale, bias)
                        if not torch.equal(lin, y.to(dtype) + bias):
                            raise AssertionError(f"{kind} T={t} {k}x{n}: quantized_linear "
                                                 f"differs from the unfused composite")
                log(f"phase 14: {kind} {name} T={t}: " + ", ".join(parts) + " ok"
                    + (", quantized_linear == y.to(bf16) + bias bit for bit"
                       if route == "mma" else ""))
    cfg = BloomConfig.bloom_560m()
    cpu = params_from_jax(np_tree, cfg, device="cpu")
    gpu = params_from_jax(np_tree, cfg, device=dev)
    for spec in (QuantSpec("int8"), QuantSpec("int4", 32)):
        qc, qg = quantize_params(cpu, spec), quantize_params(gpu, spec)
        for i, (bc, bg) in enumerate(zip(qc["blocks"], qg["blocks"])):
            for a, b in (("attn", "qkv"), ("attn", "out"), ("mlp", "up"), ("mlp", "down")):
                for plane in ("q", "scale"):
                    if not torch.equal(bg[a][b][plane].cpu(), bc[a][b][plane]):
                        raise AssertionError(f"{spec.weight_dtype}: layer {i} {a}.{b} "
                                             f"{plane} differs card vs CPU")
        log(f"phase 14: quantize_params {spec.weight_dtype} (G={spec.group_size}) of "
            f"bloom-560m float32: every q byte and scale equal, card vs CPU")
        del qc, qg
    del cpu, gpu
    quant_prefill_vs_plain(np_tree, dev)
    return errs


def quant_prefill_vs_plain(np_tree, dev) -> None:
    """bf16 bloom-560m with int8 and int4 (G = 32) weights: one prefill of
    each of three seeded prompts through the kernels (4 x 24 launches on
    the tensor-core route) against the same prefill with the layers'
    quantized product patched to the plain composite."""
    from pipegoose_tpu_torch.models.bloom import BloomConfig
    from pipegoose_tpu_torch.models.weights import params_from_jax
    from pipegoose_tpu_torch.nn.tensor_parallel import layers
    from pipegoose_tpu_torch.quant import matmul as qm
    from pipegoose_tpu_torch.quant.weights import QuantSpec, quantize_params

    cfg = BloomConfig.bloom_560m(dtype=torch.bfloat16)
    params = params_from_jax(np_tree, cfg, device=dev)
    rng = np.random.default_rng(SEED + 140)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (100, 256, 512)]
    for spec in (QuantSpec("int8"), QuantSpec("int4", 32)):
        kind = spec.weight_dtype
        wrapper = getattr(qm, f"quantized_matmul_{kind}")
        qparams = quantize_params(params, spec)
        for prompt in prompts:
            before = wrapper.routes["mma"]
            got = prefill_logits(qparams, cfg, prompt, dev)[0].float()
            if wrapper.routes["mma"] - before != 4 * cfg.n_layer:
                raise AssertionError(f"{kind} prefill: {wrapper.routes['mma'] - before} "
                                     f"tensor-core launches, want {4 * cfg.n_layer}")
            layers.quantized_linear = qm.quantized_linear_reference
            try:
                want = prefill_logits(qparams, cfg, prompt, dev)[0].float()
            finally:
                layers.quantized_linear = qm.quantized_linear
            err = (got - want).abs().max().item()
            tol = QUANT_LOGIT_RTOL * want.abs().max().item()
            top2 = torch.topk(want, 2).values
            margin = (top2[0] - top2[1]).item()
            tok_got, tok_want = int(got.argmax()), int(want.argmax())
            log(f"phase 14: bf16 {kind} prefill of {len(prompt)} tokens, kernels vs plain "
                f"composite: logits max |diff| {err:.4g} (tol {tol:.4g}), next token "
                f"{tok_got} vs {tok_want} (plain top-2 margin {margin:.4g})")
            if not torch.isfinite(got).all() or err > tol:
                raise AssertionError(f"{kind} prefill: logits differ by {err} > {tol}")
            if tok_got != tok_want and margin >= tol:
                raise AssertionError(f"{kind} prefill: next token {tok_got} != {tok_want} "
                                     f"at a top-2 margin {margin} >= {tol}")
        del qparams
    del params
    gc.collect()
    torch.cuda.empty_cache()


# -- phase 15 ------------------------------------------------------------------

# phase 15's depth: bloom-560m's widths, its first 12 layers (its four CPU
# engines cost in proportion; phase 3 holds the full depth)
PHASE15_LAYERS = 12


def phase15_quant_engine_vs_cpu(np_tree, dev) -> None:
    """Phase 3's float32 check with int8 and int4 weights, chunked and
    monolithic prefill, at PHASE15_LAYERS layers; the card engine's tokens
    must also equal the card's generate() on the engine's own quantized
    params."""
    from pipegoose_tpu_torch.models.bloom import BloomConfig
    from pipegoose_tpu_torch.models.generate import generate
    from pipegoose_tpu_torch.models.weights import params_from_jax

    cfg = dataclasses.replace(BloomConfig.bloom_560m(), n_layer=PHASE15_LAYERS)
    np_tree = {**np_tree, "blocks": cut_layers(np_tree["blocks"], PHASE15_LAYERS)}
    requests = card_vs_cpu_requests(cfg)
    cpu_params = params_from_jax(np_tree, cfg, device="cpu")
    gpu_params = params_from_jax(np_tree, cfg, device=dev)
    for weight_dtype in ("int8", "int4"):
        for chunk in (128, None):
            log(f"phase 15: bloom-560m float32 at {PHASE15_LAYERS} layers, {weight_dtype} "
                f"weights (G=32), "
                f"{'chunk 128' if chunk else 'monolithic prefill'}, prompts "
                f"{[len(p) for p, _ in requests]}, 16 new tokens, 4 slots, context "
                f"{CARD_VS_CPU_CONTEXT}")
            cpu_eng, eng, outs = engines_agree(cfg, requests, cpu_params, gpu_params,
                                               dev, weight_dtype=weight_dtype,
                                               prefill_chunk=chunk,
                                               max_context=CARD_VS_CPU_CONTEXT)
            for (prompt, n), o in zip(requests, outs):
                ref = generate(eng.params, prompt[None], cfg, n, device=dev)
                check_flip(f"request {o.uid} engine vs card generate()", cpu_eng.params,
                           cfg, prompt, ref[0, len(prompt):].cpu().numpy(), o.generated)
            del cpu_eng, eng
            gc.collect()
            torch.cuda.empty_cache()


# -- phase 16 ------------------------------------------------------------------

def phase16_quant_serving(np_tree, dev, fp_arm) -> dict:
    """Phase 4's workload in four arms: fp, int8 weights, int4 weights
    (G = 32) and int8 weights + int8 KV. The fp arm IS phase 4's fp-KV run
    (``fp_arm``: the same engine, knobs and requests), so its numbers are
    read from there and checked here, not run again. Returns each
    quantized kernel's launch count from its arm's timed run."""
    from pipegoose_tpu_torch.models.bloom import BloomConfig
    from pipegoose_tpu_torch.models.weights import params_from_jax

    cfg = BloomConfig.bloom_560m(dtype=torch.bfloat16)
    params = params_from_jax(np_tree, cfg, device=dev)
    requests = phase4_requests(cfg)
    log(f"phase 16: phase 4's workload (bloom-560m bf16, 12 requests, prompts "
        f"128-512, 64 new tokens, 8 slots, chunk 128) in four arms")
    m, report = fp_arm["metrics"], fp_arm["memory"]
    log(f"  fp (phase 4's fp-KV run): {m['decode_tokens_per_s']} tokens/s, mean TTFT "
        f"{m['mean_ttft_s'] * 1e3} ms, mean decode step "
        f"{m['decode_step_time_s'] / m['decode_steps'] * 1e3} ms, weights "
        f"{report['weights']['total_bytes']} bytes {report['weights']['bytes_by_dtype']}, "
        f"KV {report['kv']['total_bytes']} bytes")
    if report["weights"]["total_bytes"] != WEIGHT_BYTES["fp"]:
        raise AssertionError(f"fp: weights {report['weights']['total_bytes']} bytes, "
                             f"want {WEIGHT_BYTES['fp']}")
    check_quant_launches("fp", fp_arm["quant"], m, cfg.n_layer, None)
    _, busy_ms, kernels = fp_arm["profile"]
    log(f"  fp: {sum(e.count for e in kernels) / PROFILE_TICKS:.0f} kernels a decode tick, "
        f"{busy_ms} ms device time (phase 4's profile)")
    arms = {"int8w": dict(weight_dtype="int8"),
            "int4w": dict(weight_dtype="int4", weight_group_size=32),
            "int8w+int8kv": dict(weight_dtype="int8", kv_dtype="int8")}
    counters = serving_counters()
    launches = {}
    for arm, knobs in arms.items():
        serve(params, cfg, requests, dev, num_slots=8, **knobs)          # warm-up
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        for kind in ("int8", "int4"):
            counters[kind].routes = {"mma": 0, "fma": 0}
        eng, outs, m = serve(params, cfg, requests, dev, num_slots=8, **knobs)
        counts = {n: c.launches for n, c in counters.items()}
        if any(counters[kind].routes["fma"] for kind in ("int8", "int4")):
            raise AssertionError(f"{arm}: a bf16 quantized product left the tensor cores")
        report = eng.memory_report()
        wbytes, kvbytes = report["weights"]["total_bytes"], report["kv"]["total_bytes"]
        log(f"  {arm}: {m['decode_tokens_per_s']} tokens/s, mean TTFT "
            f"{m['mean_ttft_s'] * 1e3} ms, mean decode step "
            f"{m['decode_step_time_s'] / m['decode_steps'] * 1e3} ms, weights "
            f"{wbytes} bytes {report['weights']['bytes_by_dtype']}, KV {kvbytes} bytes")
        if m["generated_tokens"] != 12 * 64 or any(len(o.generated) != 64 for o in outs):
            raise AssertionError(f"{arm}: not every request got 64 tokens")
        want_bytes = WEIGHT_BYTES[eng.weight_dtype or "fp"]
        if wbytes != want_bytes:
            raise AssertionError(f"{arm}: weights {wbytes} bytes, want {want_bytes}")
        check_launches(arm, counts["paged_attention"], m, cfg.n_layer)
        check_quant_launches(arm, counts, m, cfg.n_layer, eng.weight_dtype)
        if eng.weight_dtype and eng.weight_dtype not in launches:
            launches[eng.weight_dtype] = counts[eng.weight_dtype]
        _, busy_ms, kernels = decode_profile(eng, requests[:8], arm)
        del eng
        quant_ms = sum(e.self_device_time_total for e in kernels
                       if "quant_m" in e.key) / 1e3 / PROFILE_TICKS
        per_tick = sum(e.count for e in kernels) / PROFILE_TICKS
        if busy_ms:
            log(f"  {arm}: {per_tick:.0f} kernels a decode tick; quantized matmul kernels "
                f"{quant_ms} ms of the tick's {busy_ms} ms device time "
                f"({100 * quant_ms / busy_ms:.1f}%)")
        gc.collect()
        torch.cuda.empty_cache()
    return launches


# -- phase 17 ------------------------------------------------------------------

def quant_bound_ms(x, q, scale, t, k, n):
    """Least time for one call: x, q, scale and the float32 y each moved
    once at 3.35 TB/s, against 2 T K N flops at 989 TFLOP/s (the bf16
    tensor-core rate, as the product could run at)."""
    nbytes = (x.numel() * x.element_size() + q.numel() + scale.numel() * 4 + t * n * 4)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * t * k * n / BF16_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, t_bytes, t_ops


def packed_library_call(kind, x, q, scale):
    """PyTorch's own one-call weight-only matmul for this function, or
    (None, reason). ``_weight_int8pack_mm`` takes (N, K) int8 and
    per-channel scales; ``_weight_int4pack_mm`` takes tinygemm's packed
    layout with bf16 (scale, zero) pairs, so its int4 weights here are
    q4 + 8 with zero point 0 (the same weights, scales rounded to bf16)."""
    from pipegoose_tpu_torch.quant.matmul import unpack_int4

    try:
        if kind == "int8":
            w = q.t().contiguous()
            fn = lambda: torch._weight_int8pack_mm(x, w, scale.to(x.dtype))  # noqa: E731
        else:
            u = (unpack_int4(q).t().to(torch.int32) + 8).contiguous()        # (N, K)
            packed = ((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8)
            wp = torch._convert_weight_to_int4pack(packed, 8)
            sz = torch.stack([scale, torch.zeros_like(scale)], dim=-1).to(torch.bfloat16)
            fn = lambda: torch._weight_int4pack_mm(x, wp, 32, sz.contiguous())  # noqa: E731
        fn()
        torch.cuda.synchronize()
        return fn, None
    except Exception as e:   # the op is missing or refuses this card or layout
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"


def phase17_quant_time(dev, card, errs, launches) -> list:
    """Each quantized matmul kernel at the decode (T = 8) and chunk (T = 128)
    shapes, bf16, per product of one layer; each call reads the next of 24
    layers' weights (L2-cold). Beside the tensor-core kernel: the float32
    route's kernel on the same inputs, the plain version, cuBLAS bf16, and
    the biased layer product before (float32 route, combine, cast, bias)
    and after (quantized_linear). Rows: one layer's four products summed."""
    from pipegoose_tpu_torch.quant import matmul as qm

    n_layer = 24
    log(f"phase 17: quantized matmul kernels, bf16 x, device ms per call, each call "
        f"reading the next of {n_layer} layers' weights, on {card}")
    rows = []
    for kind in ("int8", "int4"):
        kernel = getattr(qm, f"quantized_matmul_{kind}")
        for t, shape in ((8, "decode"), (128, "chunk")):
            keys = ("ms", "call_ms", "fma_ms", "plain_ms", "library_ms", "before_ms",
                    "after_ms", "bound_ms", "bytes", "ops")
            tot = dict.fromkeys(keys, 0.0)
            for i, (k, n) in enumerate(BLOOM_KN):
                x, layers = quant_case(dev, kind, k, n, t, torch.bfloat16,
                                       SEED + 17 + i, layers=n_layer)
                bias = torch.randn(n, device=dev).to(torch.bfloat16) * 0.1
                deq = [qm.dequantize_weight(q, s).to(torch.bfloat16) for q, s in layers]

                def fma(j):
                    return qm._launch(kind, x, *layers[j % n_layer], route="fma")

                got = {}
                got["ms"], got["call_ms"] = time_ms(
                    lambda j: kernel(x, *layers[j % n_layer]), n_layer)
                got["fma_ms"], _ = time_ms(fma, n_layer)
                got["plain_ms"], _ = time_ms(
                    lambda j: qm.quantized_matmul_reference(x, *layers[j % n_layer]), n_layer)
                got["library_ms"], _ = time_ms(lambda j: torch.matmul(x, deq[j % n_layer]),
                                               n_layer)
                got["before_ms"], _ = time_ms(
                    lambda j: fma(j).to(torch.bfloat16) + bias, n_layer)
                got["after_ms"], _ = time_ms(
                    lambda j: qm.quantized_linear(x, *layers[j % n_layer], bias), n_layer)
                got["bound_ms"], got["bytes"], got["ops"] = quant_bound_ms(
                    x, *layers[0], t, k, n)
                packed, why = packed_library_call(kind, x, *layers[0])
                packed_txt = (f"{time_eager_ms(packed, 20)} (one layer's weights, eager)"
                              if packed else f"not applicable ({why})")
                log(f"  {kind} T={t} {k}x{n}: kernel {got['ms']} (eager {got['call_ms']}), "
                    f"float32 route {got['fma_ms']}, bound {got['bound_ms']} "
                    f"({'bytes' if got['bytes'] >= got['ops'] else 'operations'}), plain "
                    f"{got['plain_ms']}, cuBLAS bf16 x @ dequantized bf16 "
                    f"{got['library_ms']}, torch._weight_{kind}pack_mm {packed_txt}; "
                    f"biased product before {got['before_ms']}, after {got['after_ms']}")
                for key in keys:
                    tot[key] += got[key]
                del layers, deq
                gc.collect()
                torch.cuda.empty_cache()
            rows.append({
                "name": f"quantized_matmul_{kind} (bf16, {shape} T={t}, one layer's "
                        f"qkv+out+up+down summed)",
                "source": QUANT_SOURCE, "replaces": QUANT_REPLACES[kind], "route": "cuda",
                "kernel_route": "mma", "launches": launches[kind], "max_abs_err": errs[kind],
                "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
                "bound_by": "bytes" if tot["bytes"] >= tot["ops"] else "operations",
                "library_ms": tot["library_ms"], "call_ms": tot["call_ms"],
                "fma_route_ms": tot["fma_ms"], "layer_before_ms": tot["before_ms"],
                "layer_after_ms": tot["after_ms"],
            })
            log(f"  {kind} T={t} one layer: kernel {tot['ms']}, float32 route "
                f"{tot['fma_ms']}, bound {tot['bound_ms']}, plain {tot['plain_ms']}, "
                f"cuBLAS bf16 {tot['library_ms']}, biased product before "
                f"{tot['before_ms']} -> after {tot['after_ms']}")
    return rows


# -- phase 18 ------------------------------------------------------------------

def sp_case(dev, dtype, *, b, nh=16, nkv=None, s, hd=64, pad=None, seed=0):
    """One sequence's flattened ring operands: q, dO (B*nh, S, hd), k, v
    (B*nkv, S, hd) from a seeded normal, BLOOM's ALiBi slopes, the mask,
    and the per-head key bias (B*nkv, S): padding NEG_INF, plus under left
    padding the mask-aware ALiBi correction slope * (alibi_pos - pos) that
    ``ring_flash_attention`` folds in (it needs nh == nkv). Padded queries
    get zero dO, as the models give them."""
    from pipegoose_tpu_torch.models.bloom import NEG_INF, alibi_slopes

    nkv = nkv or nh
    gen = torch.Generator(device=dev).manual_seed(seed)
    rand = lambda rows: torch.randn(rows, s, hd, device=dev, generator=gen)  # noqa: E731
    q, do, k, v = rand(b * nh), rand(b * nh), rand(b * nkv), rand(b * nkv)
    mask = torch.ones(b, s, device=dev)
    if pad == "right":
        mask[-1, s - s // 5:] = 0
    elif pad == "left":
        mask[0, :s // 5] = 0
        mask[-1, :7] = 0
    slopes = torch.from_numpy(alibi_slopes(nh)).to(dev).repeat(b)
    heads = lambda x, h: x[:, None].expand(b, h, s).reshape(b * h, s)  # noqa: E731
    kneg = heads((1 - mask) * NEG_INF, nkv)
    if pad == "left":
        apos = (torch.cumsum(mask, -1) - 1) * mask
        kneg = kneg + slopes[:, None] * (heads(apos, nh) - torch.arange(s, device=dev).float())
    do = do * heads(mask, nh)[..., None]
    return {"q": q.to(dtype), "k": k.to(dtype), "v": v.to(dtype), "do": do.to(dtype),
            "slopes": slopes, "kneg": kneg.contiguous(), "mask": mask,
            "g": nh // nkv, "scale": hd ** -0.5}


def chunk_args(case, sp, rank, kv_rank):
    """(q, k, v, do, slopes, qpos, kpos, kneg) of one (rank, kv_rank) pair
    of an sp-way split: plain global positions, as the ring passes them."""
    s = case["q"].shape[1]
    sl = s // sp
    dev = case["q"].device
    qs, ks = slice(rank * sl, (rank + 1) * sl), slice(kv_rank * sl, (kv_rank + 1) * sl)
    bh, bkv = case["q"].shape[0], case["k"].shape[0]
    pos = lambda r, rows: (r * sl + torch.arange(sl, device=dev)).float()[None].expand(rows, sl).contiguous()  # noqa: E731
    c = lambda t, part: t[:, part].contiguous()  # noqa: E731
    return (c(case["q"], qs), c(case["k"], ks), c(case["v"], ks), c(case["do"], qs),
            case["slopes"], pos(rank, bh), pos(kv_rank, bkv), c(case["kneg"], ks))


def chunk_err(got, want, rtol):
    """(max abs error, tolerance) against the largest |plain| value."""
    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"bad kernel output {tuple(got.shape)}")
    if want.numel() == 0:
        return 0.0, FLASH_ATOL
    err = (got - want).abs().max().item()
    return err, FLASH_ATOL + rtol * want.abs().max().item()


def ring_walk(label, case, sp):
    """Every (rank, kv_rank) pair of an sp-way split in ring order: B7 from
    the state the plain chain carries into the pair, on the rows that have
    seen an unmasked key (a fully-future pair must return its state bit for
    bit); then B8 and B9 with the chain's final lse against their plain
    versions everywhere. The state is float32 in both dtypes: m, a maximum
    of scores, holds to LSE_RTOL and l, a float32 sum of float32 p, to
    float32's FLASH_RTOL. acc, dq, dk and dv hold to FLASH_RTOL of the
    inputs' dtype: float32 inputs take the FMA route (2e-4), bf16 inputs
    the tensor-core route, which rounds P (and dS) once to bf16 before the
    second product (2^-7); each call must launch that route. Returns each
    kernel's worst error."""
    from pipegoose_tpu_torch.ops import flash_attention as fa

    rtol = FLASH_RTOL[torch.float32]
    tc_rtol = FLASH_RTOL[case["q"].dtype]
    route = fa.chunk_bwd_plan(case["q"].dtype, case["q"].shape[2], 1, 1)["route"]
    if fa.fwd_plan(case["q"].dtype, case["q"].shape[2], 1, 1)["route"] != route:
        raise AssertionError("the chunk forward and backward plans name other routes")
    fns = (fa.flash_ring_chunk, fa.flash_chunk_dq, fa.flash_chunk_dkv)
    routes = [fn.routes[route] for fn in fns]
    bh, s, hd = case["q"].shape
    sl, g, scale, dev = s // sp, case["g"], case["scale"], case["q"].device
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    bad = []
    finals = []
    for rank in range(sp):
        state = (torch.full((bh, sl), NEG_INF_F, device=dev),
                 torch.zeros((bh, sl), device=dev), torch.zeros((bh, sl, hd), device=dev))
        for t in range(sp):
            kv_rank = (rank - t) % sp
            q, k, v, _, slopes, qpos, kpos, kneg = chunk_args(case, sp, rank, kv_rank)
            got = fa.flash_ring_chunk(q, k, v, slopes, qpos, kpos, kneg, *state, scale, g)
            want = fa.flash_ring_chunk_reference(q, k, v, slopes, qpos, kpos, kneg,
                                                 *state, scale, g)
            if kv_rank > rank and not all(torch.equal(a, b) for a, b in zip(got, state)):
                bad.append(f"fully-future pair ({rank}, {kv_rank}) moved the state")
            seen = want[0] > NEG_INF_F / 10
            for name, a, b, tol_r in (("m", got[0], want[0], LSE_RTOL),
                                      ("l", got[1], want[1], rtol),
                                      ("acc", got[2], want[2], tc_rtol)):
                err, tol = chunk_err(a[seen], b[seen], tol_r)
                worst["fwd"] = max(worst["fwd"], err)
                if err > tol:
                    bad.append(f"B7 {name} ({rank}, {kv_rank}) {err:.3g} > {tol:.3g}")
            state = want
        m, l, acc = state
        l = torch.clamp_min(l, 1e-30)
        finals.append(((acc / l[..., None]).to(case["q"].dtype), m + torch.log(l)))
        del got, want
    for rank in range(sp):
        out, lse = finals[rank]
        for kv_rank in range(sp):
            q, k, v, do, slopes, qpos, kpos, kneg = chunk_args(case, sp, rank, kv_rank)
            delta = (do.float() * out.float()).sum(-1)
            args = (q, k, v, do, lse, delta, slopes, qpos, kpos, kneg, scale, g)
            err, tol = chunk_err(fa.flash_chunk_dq(*args), fa.flash_chunk_dq_reference(*args),
                                 tc_rtol)
            worst["dq"] = max(worst["dq"], err)
            if err > tol:
                bad.append(f"B8 ({rank}, {kv_rank}) {err:.3g} > {tol:.3g}")
            for name, a, b in zip(("dk", "dv"), fa.flash_chunk_dkv(*args),
                                  fa.flash_chunk_dkv_reference(*args)):
                err, tol = chunk_err(a, b, tc_rtol)
                worst["dkv"] = max(worst["dkv"], err)
                if err > tol:
                    bad.append(f"B9 {name} ({rank}, {kv_rank}) {err:.3g} > {tol:.3g}")
    torch.cuda.synchronize()
    moved = [fn.routes[route] - n for fn, n in zip(fns, routes)]
    if moved != [sp * sp] * 3:
        bad.append(f"B7/B8/B9 launched the {route} route {moved} times, not {sp * sp}")
    log(f"phase 18: {label}: worst errors {worst} (B7-B9 {route} route, acc/dq/dk/dv "
        f"rtol {tc_rtol})" + (f" FAIL {bad[:6]}" if bad else " ok"))
    if bad:
        raise AssertionError(f"{label}: chunk kernels disagree with plain: {bad[:6]}")
    return worst


def ring_chain_vs_flash(label, case, sp):
    """The ring chain against the whole-sequence flash kernels B1-B3: B7 over
    the kv ranks in ring order, normalized, equals B1's output and lse on
    each rank's rows; with B1's lse and delta, B8 summed over the kv ranks
    equals B2's dQ and B9 summed over the query ranks B3's dK/dV."""
    from pipegoose_tpu_torch.ops import flash_attention as fa

    dtype = case["q"].dtype
    bh, s, hd = case["q"].shape
    sl, scale, dev = s // sp, case["scale"], case["q"].device
    b = case["mask"].shape[0]
    kv_pos, kv_neg = (x[:, None].expand(b, bh // b, s).reshape(bh, s).contiguous()
                      for x in fa.mask_to_kv_bias(case["mask"]))
    fwd = (case["q"], case["k"], case["v"], case["slopes"], kv_pos, kv_neg)
    out, lse = fa.flash_fwd(*fwd, scale, True)
    delta = (case["do"].float() * out.float()).sum(-1)
    bwd = (case["q"], case["k"], case["v"], case["do"], lse, delta, case["slopes"],
           kv_pos, kv_neg, scale, True)
    dq_full, (dk_full, dv_full) = fa.flash_dq(*bwd), fa.flash_dkv(*bwd)
    checks = {n: 0.0 for n in ("out", "lse", "dq", "dk", "dv")}
    bad = []
    dk_sum = torch.zeros((bh, s, hd), device=dev)
    dv_sum = torch.zeros((bh, s, hd), device=dev)
    for rank in range(sp):
        rows = slice(rank * sl, (rank + 1) * sl)
        state = (torch.full((bh, sl), NEG_INF_F, device=dev),
                 torch.zeros((bh, sl), device=dev), torch.zeros((bh, sl, hd), device=dev))
        dq = torch.zeros((bh, sl, hd), device=dev)
        for t in range(sp):
            kv_rank = (rank - t) % sp
            q, k, v, do, slopes, qpos, kpos, kneg = chunk_args(case, sp, rank, kv_rank)
            state = fa.flash_ring_chunk(q, k, v, slopes, qpos, kpos, kneg, *state, scale)
            args = (q, k, v, do, lse[:, rows].contiguous(), delta[:, rows].contiguous(),
                    slopes, qpos, kpos, kneg, scale)
            dq += fa.flash_chunk_dq(*args)
            dk, dv = fa.flash_chunk_dkv(*args)
            keys = slice(kv_rank * sl, (kv_rank + 1) * sl)
            dk_sum[:, keys] += dk
            dv_sum[:, keys] += dv
        m, l, acc = state
        l = torch.clamp_min(l, 1e-30)
        pairs = (("out", (acc / l[..., None]).to(dtype), out[:, rows], FLASH_RTOL[dtype]),
                 ("lse", m + torch.log(l), lse[:, rows], LSE_RTOL),
                 ("dq", dq, dq_full[:, rows], FLASH_RTOL[dtype]))
        for name, got, want, rtol in pairs:
            err, tol = chunk_err(got, want, rtol)
            checks[name] = max(checks[name], err)
            if err > tol:
                bad.append(f"{name} rank {rank} {err:.3g} > {tol:.3g}")
    for name, got, want in (("dk", dk_sum, dk_full), ("dv", dv_sum, dv_full)):
        err, tol = chunk_err(got, want, FLASH_RTOL[dtype])
        checks[name] = err
        if err > tol:
            bad.append(f"{name} {err:.3g} > {tol:.3g}")
    torch.cuda.synchronize()
    log(f"phase 18: {label}: chain vs B1-B3 max errors {checks}"
        + (f" FAIL {bad}" if bad else " ok"))
    if bad:
        raise AssertionError(f"{label}: the ring chain disagrees with B1-B3: {bad}")


def phase18_chunk_vs_plain(dev) -> dict:
    """B7-B9 against their plain versions: (a) at phase 20's attention shape,
    the diagonal chunk from zero state; (b) every pair of an sp = 4 split;
    (c) the chain against B1-B3. Returns (a)'s errors."""
    counts = [fn.launches for fn in chunk_counters()]
    case = sp_case(dev, torch.bfloat16, b=1, s=SP_SEQ, seed=SEED + 18)
    errs = ring_walk(f"(a) bf16 B*nh=16 S={SP_SEQ} hd=64, diagonal chunk", case, 1)
    del case
    gc.collect()
    torch.cuda.empty_cache()
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for pad, nkv in (("right", 16), ("left", 16), ("right", 8)):
            label = (f"(b) {name} B=2 nh=16 nkv={nkv} S=4096 sp=4, {pad}-padded"
                     + (" with the ALiBi correction" if pad == "left" else ""))
            ring_walk(label, sp_case(dev, dtype, b=2, nkv=nkv, s=4096, pad=pad,
                                     seed=SEED + 181), 4)
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for pad in (None, "right"):
            ring_chain_vs_flash(f"(c) {name} B=2 nh=16 S=4096 sp=4, "
                                f"{pad or 'un'}{'-' if pad else ''}padded",
                                sp_case(dev, dtype, b=2, s=4096, pad=pad, seed=SEED + 182), 4)
    moved = [fn.launches - c for fn, c in zip(chunk_counters(), counts)]
    if min(moved) <= 0:
        raise AssertionError(f"phase 18: the chunk wrappers did not launch: {moved}")
    gc.collect()
    torch.cuda.empty_cache()
    return errs


def chunk_counters():
    """The chunk kernels' wrappers, B7, B8, B9."""
    counters = kernel_counters()
    return [counters[n] for n in ("chunk_fwd", "chunk_dq", "chunk_dkv")]


# -- phase 19 ------------------------------------------------------------------

def sp_context():
    """A world of one rank over NCCL (a FileStore in a temporary
    directory: no network) and ``ParallelContext(sequence_parallel_size=1)``
    over it; the caller destroys it."""
    import tempfile

    import torch.distributed as dist

    from pipegoose_tpu_torch.distributed import ParallelContext

    store_dir = tempfile.mkdtemp(prefix="chip_smoke_store_")
    store = dist.FileStore(f"{store_dir}/store", 1)
    return ParallelContext.init_multihost(store=store, world_size=1, rank=0,
                                          device="cuda", sequence_parallel_size=1)


def phase19_sp_loss_vs_single(np_tree, dev) -> None:
    """The float32 SP loss at sp = 1 with use_flash against the card's
    single-device loss and the CPU's, fused_ce off and on; then 3
    sp_train_steps against 3 train_steps. B1-B3 never launch on the SP path.
    Then the bf16 arm (``sp_bf16_vs_flash``)."""
    from pipegoose_tpu_torch.models.bloom import BloomConfig, loss_fn, loss_fn_sp
    from pipegoose_tpu_torch.models.weights import grads_of, params_from_jax, params_to_jax
    from pipegoose_tpu_torch.trainer import make_optimizer, sp_train_step, train_step

    n_layer, b, s, pad, lr = 2, 2, 512, 57, 1e-4
    vocab, hidden = np_tree["embed"]["weight"].shape
    tree = {**np_tree, "blocks": cut_layers(np_tree["blocks"], n_layer)}
    rng = np.random.default_rng(SEED + 19)
    ids = rng.integers(0, vocab, (b, s))
    mask = np.ones((b, s), np.int64)
    mask[1, s - pad:] = 0
    flash = [kernel_counters()[n] for n in ("fwd", "dq", "dkv")]
    chunk = chunk_counters()
    for fused in (False, True):
        cfg = BloomConfig(vocab_size=vocab, hidden_size=hidden, n_layer=n_layer,
                          n_head=16, remat=True, use_flash=True, fused_ce=fused)
        log(f"phase 19: float32 SP loss at sp=1 vs the single-device loss: depth cut "
            f"24 -> {n_layer}, batch {b} x {s} (row 1 right-padded by {pad}), remat, "
            f"flash, fused_ce={fused}")
        grads = {}
        for label, where, fn in (("card sp", dev, loss_fn_sp), ("card", dev, loss_fn),
                                 ("cpu", "cpu", loss_fn)):
            params = params_from_jax(tree, cfg, device=where)
            make_optimizer(params, lr)
            as_t = lambda a: torch.from_numpy(a).to(where)  # noqa: E731
            before = [c.launches for c in flash + chunk]
            loss = fn(params, as_t(ids), as_t(mask), as_t(ids), cfg)
            loss.backward()
            moved = [c.launches - n for c, n in zip(flash + chunk, before)]
            grads[label] = (loss.item(), params_to_jax(grads_of(params)))
            log(f"  {label}: loss {grads[label][0]}, launches B1-B3 {moved[:3]}, "
                f"B7-B9 {moved[3:]}")
            if label == "card sp" and (any(moved[:3]) or not all(moved[3:])):
                raise AssertionError(f"the SP path launched B1-B3 {moved[:3]} or "
                                     f"skipped B7-B9 {moved[3:]}")
            del params
        sp_loss, sp_grads = grads["card sp"]
        for ref in ("card", "cpu"):
            loss_err = abs(sp_loss - grads[ref][0])
            worst = max(((path, leaf_rel_err(g, c)) for path, g, c in
                         zip_leaves(sp_grads, grads[ref][1])), key=lambda x: x[1])
            log(f"  card sp vs {ref}: loss err {loss_err} (atol {TRAIN_LOSS_ATOL}); "
                f"worst gradient {worst[0]} rel err {worst[1]} (rtol {TRAIN_GRAD_RTOL})")
            if loss_err > TRAIN_LOSS_ATOL or worst[1] > TRAIN_GRAD_RTOL:
                raise AssertionError(f"SP loss or gradients disagree with {ref}")
        losses = {}
        for label, step in (("sp_train_step", sp_train_step), ("train_step", train_step)):
            params = params_from_jax(tree, cfg, device=dev)
            opt = make_optimizer(params, lr)
            losses[label] = [step(params, opt, ids, mask, ids, cfg, device=dev).item()
                             for _ in range(3)]
            del params, opt
        err = max(abs(a - c) for a, c in zip(*losses.values()))
        log(f"  3 steps: {losses}, err {err} (atol {TRAIN_ADAM_LOSS_ATOL})")
        if err > TRAIN_ADAM_LOSS_ATOL or not all(np.isfinite(losses["sp_train_step"])):
            raise AssertionError("sp_train_step and train_step disagree")
        gc.collect()
        torch.cuda.empty_cache()
    sp_bf16_vs_flash(tree, ids, mask, dev, n_layer)


def sp_bf16_vs_flash(tree, ids, mask, dev, n_layer) -> None:
    """bf16 on the card: the SP loss at sp = 1 (``loss_fn_sp``: B7, and B8/B9
    on the tensor cores) against the single-device ``loss_fn`` with
    use_flash (B1-B3) on the same weights and batch. Both run bf16
    activations with float32 sums, and B8/B9 round P and dS to bf16 where
    B2/B3 do not, so the loss holds to SP_BF16_LOSS_RTOL relative and every
    gradient to FUSED_GRAD_RTOL[bfloat16] of its leaf's largest value."""
    from pipegoose_tpu_torch.models.bloom import BloomConfig, loss_fn, loss_fn_sp
    from pipegoose_tpu_torch.models.weights import grads_of, params_from_jax, params_to_jax
    from pipegoose_tpu_torch.ops import flash_attention as fa
    from pipegoose_tpu_torch.trainer import make_optimizer

    vocab, hidden = tree["embed"]["weight"].shape
    cfg = BloomConfig(vocab_size=vocab, hidden_size=hidden, n_layer=n_layer, n_head=16,
                      remat=True, use_flash=True, dtype=torch.bfloat16)
    log(f"phase 19: bf16 SP loss at sp=1 (B7-B9) vs the single-device flash loss "
        f"(B1-B3) on the card: depth {n_layer}, batch {tuple(ids.shape)}, row 1 "
        f"right-padded, remat, fused_ce off")
    runs = {}
    for label, fn in (("sp", loss_fn_sp), ("flash", loss_fn)):
        params = params_from_jax(tree, cfg, device=dev)
        make_optimizer(params, 1e-4)
        mma = [f.routes["mma"] for f in (fa.flash_chunk_dq, fa.flash_chunk_dkv)]
        as_t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        loss = fn(params, as_t(ids), as_t(mask), as_t(ids), cfg)
        loss.backward()
        moved = [f.routes["mma"] - n for f, n in zip((fa.flash_chunk_dq, fa.flash_chunk_dkv), mma)]
        if label == "sp" and moved != [n_layer] * 2:
            raise AssertionError(f"bf16 B8/B9 took the tensor cores {moved} times, "
                                 f"not {n_layer} each")
        runs[label] = (loss.item(), params_to_jax(grads_of(params)))
        del params
    (sp_loss, sp_grads), (ref_loss, ref_grads) = runs["sp"], runs["flash"]
    loss_err = abs(sp_loss - ref_loss) / abs(ref_loss)
    worst = max(((path, leaf_rel_err(g, c)) for path, g, c in zip_leaves(sp_grads, ref_grads)),
                key=lambda x: x[1])
    log(f"  loss sp {sp_loss} vs flash {ref_loss}: rel err {loss_err} (rtol "
        f"{SP_BF16_LOSS_RTOL}); worst gradient {worst[0]} rel err {worst[1]} (rtol "
        f"{FUSED_GRAD_RTOL[torch.bfloat16]})")
    if (not np.isfinite(sp_loss) or loss_err > SP_BF16_LOSS_RTOL
            or worst[1] > FUSED_GRAD_RTOL[torch.bfloat16]):
        raise AssertionError("the bf16 SP loss or gradients disagree with the flash path")
    gc.collect()
    torch.cuda.empty_cache()


# -- phase 20 ------------------------------------------------------------------

def phase20_timed_sp_training(np_tree, dev, card) -> dict:
    """Timed bf16 SP training at sp = 1, bloom-560m at full width and depth,
    remat, flash, fused CE, batch 1 x 8192, through sp_train_step; then the
    same shape through train_step ("flash+fusedce"). Returns the SP run."""
    from pipegoose_tpu_torch.models.bloom import BloomConfig
    from pipegoose_tpu_torch.trainer import sp_train_step

    cfg = BloomConfig.bloom_560m(dtype=torch.bfloat16, remat=True, use_flash=True,
                                 fused_ce=True)
    run = timed_training(np_tree, dev, card, cfg, "phase 20",
                         "sp_train_step at sp=1: remat, flash (the ring), fused_ce",
                         batch=1, seq=SP_SEQ, step_fn=sp_train_step)
    gc.collect()
    torch.cuda.empty_cache()
    single = timed_training(np_tree, dev, card, cfg, "phase 20",
                            "train_step, 'flash+fusedce'", batch=1, seq=SP_SEQ)
    log(f"phase 20: 1 x {SP_SEQ} step: sp_train_step {run['step_ms']} ms, train_step "
        f"{single['step_ms']} ms (ring at sp=1 / flash: "
        f"{run['step_ms'] / single['step_ms']:.3f}x)")
    gc.collect()
    torch.cuda.empty_cache()
    return run


# -- phase 21 ------------------------------------------------------------------

def chunk_bound_ms(kind, case, tensors):
    """Least time for one diagonal-chunk call: 4 hd (fwd), 6 hd (dq) or
    8 hd (dkv) flops per visible (q, k) pair at 989 TFLOP/s bf16, against
    every input read once and every output written once (the forward's
    float32 state in and out included) at 3.35 TB/s."""
    bh, s, hd = case["q"].shape
    flops = {"fwd": 4, "dq": 6, "dkv": 8}[kind] * hd * bh * (s * (s + 1) // 2)
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    t_ops, t_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def ptxas_usage(source, kernel):
    """(registers, spill store bytes) of the one instantiation of ``source``'s
    build whose mangled name contains ``kernel``, from ptxas's report."""
    from pipegoose_tpu_torch.ops import _build

    fn, regs, spills = "", None, None
    for line in _build.build_log(source).splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for")[-1]
        elif kernel in fn and "spill stores" in line:
            spills = int(next(p for p in line.split(",") if "spill stores" in p).split()[0])
        elif kernel in fn and "registers" in line:
            regs = int(line.split("Used")[1].split("registers")[0])
    return regs, spills


def phase21_chunk_time(dev, card, errs, launches, parent=None) -> list:
    from pipegoose_tpu_torch.models.bloom import NEG_INF
    from pipegoose_tpu_torch.ops import flash_attention as fa

    b, nh, s, hd = 1, 16, SP_SEQ, 64
    case = sp_case(dev, torch.bfloat16, b=b, s=s, seed=SEED + 21)
    q, k, v, do, slopes, qpos, kpos, kneg = chunk_args(case, 1, 0, 0)
    bh = b * nh
    state = (torch.full((bh, s), NEG_INF_F, device=dev), torch.zeros((bh, s), device=dev),
             torch.zeros((bh, s, hd), device=dev))
    fwd = (q, k, v, slopes, qpos, kpos, kneg, *state, case["scale"])
    m, l, acc = fa.flash_ring_chunk(*fwd)
    out = (acc / l[..., None]).to(q.dtype)
    lse = m + torch.log(l)
    delta = (do.float() * out.float()).sum(-1)
    bwd = (q, k, v, do, lse, delta, slopes, qpos, kpos, kneg, case["scale"])
    dq = fa.flash_chunk_dq(*bwd)
    dk, dv = fa.flash_chunk_dkv(*bwd)
    io = {"fwd": fwd[:-1] + (m, l, acc), "dq": bwd[:-1] + (dq,), "dkv": bwd[:-1] + (dk, dv)}
    calls = {
        "fwd": (lambda i: fa.flash_ring_chunk(*fwd),
                lambda: fa.flash_ring_chunk_reference(*fwd)),
        "dq": (lambda i: fa.flash_chunk_dq(*bwd), lambda: fa.flash_chunk_dq_reference(*bwd)),
        "dkv": (lambda i: fa.flash_chunk_dkv(*bwd), lambda: fa.flash_chunk_dkv_reference(*bwd)),
    }
    # the library yardstick: SDPA on (B, nh, S, hd) bf16 with the ALiBi and
    # causal terms of the diagonal chunk as one additive bias; its backward
    # gives dq, dk and dv in one autograd call, timed eagerly
    heads = lambda t: t.reshape(b, nh, s, hd).detach().clone().requires_grad_()  # noqa: E731
    qs, ks, vs = heads(q), heads(k), heads(v)
    pos = torch.arange(s, device=dev, dtype=torch.float32)
    keep = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
    bias = torch.where(keep, slopes[:nh, None, None] * pos, NEG_INF)[None].to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    so = sdpa(qs, ks, vs, attn_mask=bias)
    with torch.no_grad():
        lib_fwd_ms, _ = time_ms(lambda i: sdpa(qs, ks, vs, attn_mask=bias), 2, replays=5)
    lib_bwd_ms = time_eager_ms(
        lambda: torch.autograd.grad(so, (qs, ks, vs), do.reshape(b, nh, s, hd),
                                    retain_graph=True), 2)
    del so, bias, keep
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 21: chunk kernels at phase 20's shape (B*nh={bh}, S={s}, hd={hd}, "
        f"bf16, the diagonal chunk, zero state), device ms per call, on {card}")
    plan = fa.chunk_bwd_plan(q.dtype, hd, s, s)
    routes = {"fwd": fa.fwd_plan(q.dtype, hd, s, s)["route"], "dq": plan["route"],
              "dkv": plan["route"]}
    mangled = {kind: f"chunk_{kind}_mma_kernelILi{hd}E" for kind in ("fwd", "dq", "dkv")}
    old = {}   # a call of the parent's kernel of each kind on this run's inputs
    if parent:
        old, theirs = parent_calls(parent["flash_chunk"], "flash_chunk",
                                   {"fwd": fwd[:-1], "dq": bwd[:-1], "dkv": bwd[:-1]},
                                   {"fwd": (m, l, acc), "dq": (dq,), "dkv": (dk, dv)},
                                   (bh, s, s, hd, 1), case["scale"])
        # the backward kernels run on the shared loops now: their outputs must
        # not move
        old["dq"](0)
        old["dkv"](0)
        torch.cuda.synchronize()
        same = [torch.equal(a, b_) for a, b_ in zip((dq, dk, dv), theirs["dq"] + theirs["dkv"])]
        log(f"phase 21: B8/B9 outputs equal to the parent's bit for bit: dq {same[0]}, "
            f"dk {same[1]}, dv {same[2]}")
        if not all(same):
            raise AssertionError("B8/B9's outputs moved from the parent's")
    rows = []
    for kind in ("fwd", "dq", "dkv"):
        kernel, plain = calls[kind]
        ms, call_ms = time_ms(kernel, 2, replays=5)
        plain_ms = time_eager_ms(plain, 2)
        gc.collect()
        torch.cuda.empty_cache()
        bound_ms, bound_by = chunk_bound_ms(kind, case, io[kind])
        library_ms = lib_fwd_ms if kind == "fwd" else lib_bwd_ms
        regs, spills = ptxas_usage("flash_chunk", mangled[kind])
        turns = None
        if kind in old:
            turns = parent_turns(kernel, old[kind], 2, replays=5)
            log(f"  flash_chunk_{kind} in turns with the parent's kernel (parent, this, this, "
                f"parent): this {turns[0]}, parent {turns[1]}")
        log(f"  flash_chunk_{kind} ({routes[kind]} route, {regs} registers, {spills} bytes "
            f"spilled): kernel {ms} (eager {call_ms}), bound {bound_ms} ({bound_by}), "
            f"plain {plain_ms}, SDPA "
            f"{'forward' if kind == 'fwd' else 'backward (dq, dk, dv in one call, eager)'} "
            f"{library_ms}")
        rows.append({
            "name": f"flash_chunk_{kind} (bf16, B*nh={bh}, S={s}, hd={hd}, diagonal chunk, "
                    f"{routes[kind]} route)",
            "source": CHUNK_SOURCE, "replaces": CHUNK_REPLACES[kind], "route": "cuda",
            "kernel_route": routes[kind],
            "launches": launches[f"chunk_{kind}"], "max_abs_err": errs[kind], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "call_ms": call_ms, "registers": regs,
            "spill_store_bytes": spills,
            **({"turns_ms": turns[0], "parent_turns_ms": turns[1]} if turns else {}),
        })
    return rows


# -- phase 22 ------------------------------------------------------------------

def parent_ce_fwd(lib):
    """``fused_ce_fwd`` as the parent revision ran it in bf16 and float32: the
    WMMA entry ``fused_ce_fwd_{dtype}`` of its ``fused_ce`` library ``lib``,
    called directly with the splits and partials its wrapper gave it, with
    the wrapper's counters (all on "wmma")."""
    import ctypes

    from pipegoose_tpu_torch.ops import fused_ce as fce

    def run(h, w, targets, offset=0, valid=None, vh=True):
        t, hd = h.shape
        v = w.shape[0] if vh else w.shape[1]
        splits = fce.fwd_plan(torch.float32, t, hd, v, vh)["splits"]   # the WMMA plan
        part = torch.empty((3, splits, t), dtype=torch.float32, device=h.device)
        lse = torch.empty(t, dtype=torch.float32, device=h.device)
        tl = torch.empty(t, dtype=torch.float32, device=h.device)
        fn = getattr(lib, f"fused_ce_fwd_{'bf16' if h.dtype == torch.bfloat16 else 'f32'}")
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = fn(*(x.data_ptr() for x in (h, w, targets, part, lse, tl)), t, hd, v, offset,
                 fce.NO_VALID if valid is None else valid, int(bool(vh)), splits,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the parent's fused_ce_fwd: cudaError {err}")
        run.launches += 1
        run.routes["wmma"] += 1
        run.layouts["vh" if vh else "hv"] += 1
        return lse, tl

    run.launches, run.routes, run.layouts = 0, {"wgmma": 0, "wmma": 0}, {"vh": 0, "hv": 0}
    return run


def phase22_steps_vs_parent(np_tree, dev, card, parent) -> dict:
    """Four steps through the attention kernels (the flash kernels B1-B3,
    the ring-chunk kernels B7-B9) and, with fused CE, its kernels (B4-B6),
    with this revision's kernels and the parent's in turns; returns the
    step ms of each as {step: {"this": [...], "parent": [...]}}. The
    parent's flash_attention and flash_chunk libraries take the place of
    this revision's, and its fused CE forward is called as the parent
    called it: the WMMA entries of its ``fused_ce`` library
    (``parent_ce_fwd``). Its fused CE backward ran on fused_ce_mma.cu, which
    this revision leaves byte for byte as it was, so this revision's build
    of it serves both sides. The attention route counters still name the
    route this revision's plan picks."""
    from pipegoose_tpu_torch.models.bloom import BloomConfig
    from pipegoose_tpu_torch.ops import _build
    from pipegoose_tpu_torch.ops import fused_ce as fce
    from pipegoose_tpu_torch.trainer import sp_train_step

    flash = BloomConfig.bloom_560m(dtype=torch.bfloat16, remat=True, use_flash=True)
    fused = BloomConfig.bloom_560m(dtype=torch.bfloat16, remat=True, use_flash=True,
                                   fused_ce=True)
    steps = {"phase 8 'flash' train_step, 8 x 1024": (flash, {}),
             "phase 12 'flash+fusedce' train_step, 8 x 1024": (fused, {}),
             "phase 20 sp_train_step, 1 x 8192": (fused, dict(batch=1, seq=SP_SEQ,
                                                               step_fn=sp_train_step)),
             "phase 20 train_step 'flash+fusedce', 1 x 8192": (fused, dict(batch=1, seq=SP_SEQ))}
    ours = {n: _build.load(n) for n in PARENT_SOURCES}
    this_fwd, old_fwd = fce.fused_ce_fwd, parent_ce_fwd(parent["fused_ce"])
    out = {}
    for name, (cfg, kw) in steps.items():
        out[name] = {"this": [], "parent": []}
        for who in ("parent", "this", "this", "parent"):
            _build._loaded.update(parent if who == "parent" else ours)
            fce.fused_ce_fwd = old_fwd if who == "parent" else this_fwd
            try:
                run = timed_training(np_tree, dev, card, cfg, f"phase 22 ({who})", name,
                                     fwd_route="wmma" if who == "parent" else None, **kw)
            finally:
                _build._loaded.update(ours)
                fce.fused_ce_fwd = this_fwd
            out[name][who].append(run["step_ms"])
            gc.collect()
            torch.cuda.empty_cache()
        log(f"phase 22: {name}: step ms this {out[name]['this']}, parent {out[name]['parent']} "
            f"(in turns parent, this, this, parent) on {card}")
    return out


# -- phases 23-24 --------------------------------------------------------------

# make_skewed_replay's arguments (beside vocab) of phase 23's trace: two
# prefixes of 12.5 pages, so every hit ends in a copy-on-write
PHASE23_TRACE = dict(n_requests=6, n_prefixes=2, prefix_len=200, suffix_lens=(8, 24, 40),
                     max_new=16, seed=SEED)
# phases 23-24's weights: drawn with a wider init than HF's 0.02, under
# which every greedy stream repeats one token and every draft is accepted,
# so that the streams vary and the verification rejects drafts
VARIED_INIT_STD = 0.06
# phase 24's trace: 16 requests over three Zipf-drawn prefixes of 392 tokens
PHASE24_TRACE = dict(n_requests=16, n_prefixes=3, prefix_len=392, suffix_lens=(32, 64, 96),
                     max_new=32, seed=SEED, zipf_a=1.2)
LEDGER_HOLE_PAGES = 41         # phase 23 (c)'s pool: 40 pages besides the NULL page
# phase 23's context: its longest request (300 + 16 tokens) rounded up to a
# page. A narrower page table than the main path's 1024 keeps the CPU
# engine's plain attention, which reads every key of the table, three times
# cheaper.
PHASE23_CONTEXT = 320
# phase 23's depth: bloom-560m's widths, its first 13 layers (the CPU engines
# cost in proportion), which keeps the (12, 3) draft a shallow exit
PHASE23_LAYERS = 13


def paged_counters_zero():
    from pipegoose_tpu_torch.ops import paged_attention as pa

    pa.paged_attention.launches = 0
    pa.paged_attention.routes = {"fma": 0, "mma": 0}
    pa.paged_attention.queries = {}


def paged_counts():
    from pipegoose_tpu_torch.ops import paged_attention as pa

    return {"all": pa.paged_attention.launches, **pa.paged_attention.routes,
            "queries": dict(pa.paged_attention.queries)}


def expected_launches(eng, metrics):
    """The paged kernel's launches that a run's own counts imply, by query
    count C and by route: n_layer per plain decode step (C = 1) and per
    prefill chunk (C = prefill_chunk), and per speculative cycle n draft
    steps of k layers (C = 1) plus one n_layer verification (C = n + 1);
    a fully cached prefix launches nothing. Each route as ``paged_route``
    picks it for the engine's q and page dtypes."""
    from pipegoose_tpu_torch.ops import paged_attention as pa

    pages = eng.k_pages["q"] if isinstance(eng.k_pages, dict) else eng.k_pages
    n_layer = eng.config.n_layer
    cycles = metrics.get("speculative", {}).get("cycles", 0)
    by_c = {}

    def add(c, launches):
        if launches:
            by_c[c] = by_c.get(c, 0) + launches

    add(1, n_layer * (metrics["decode_steps"] - cycles))
    add(eng.prefill_chunk, n_layer * metrics["prefill_chunks"])
    if cycles:
        k, n = eng.speculative
        add(1, cycles * k * n)
        add(n + 1, cycles * n_layer)
    want = {"all": sum(by_c.values()), "fma": 0, "mma": 0, "queries": by_c}
    for c, launches in by_c.items():
        want[pa.paged_route(c, eng.config.dtype, pages.dtype)] += launches
    return want


def check_routes(label, eng, metrics, got):
    want = expected_launches(eng, metrics)
    cycles = metrics.get("speculative", {}).get("cycles", 0)
    log(f"  {label}: paged kernel launches {got}, want {want} (decode steps "
        f"{metrics['decode_steps'] - cycles}, speculative cycles {cycles}, prefill "
        f"chunks {metrics['prefill_chunks']})")
    if got != want or got["all"] == 0:
        raise AssertionError(f"{label}: paged launches disagree with the run's counts")


def run_counts(eng, metrics):
    """The host-side counts a run must reproduce on any device."""
    out = {"prefill_tokens": metrics["prefill_tokens"],
           "prefill_chunks": metrics["prefill_chunks"],
           "decode_steps": metrics["decode_steps"],
           "hit_tokens": metrics["prefix_cache"]["hit_tokens"],
           "cow_copies": metrics["prefix_cache"]["cow_copies"],
           "evictions": eng.prefix_cache.evictions,
           "retractions": eng.sched.retractions}
    if "speculative" in metrics:
        s = metrics["speculative"]
        out.update(drafted=s["draft_tokens"], accepted=s["accepted_tokens"],
                   cycles=s["cycles"])
    return out


def ledger_hole_requests(trace, vocab):
    """Three requests that open the admission ledger's one hole, ahead of
    ``trace``: A (prefix 1 + 8 tokens, 1 new token) and B (prefix 1 + 100
    tokens) prefill prefix 1 side by side; A publishes it and finishes two
    ticks before B's last chunk, so C (prefix 2 + 40 tokens), blocked until
    then, is admitted on A's now evictable pages; then B publishes a page
    under them, C's growth finds them pinned, and the scheduler retracts
    B. Later requests of the trace then evict cache pages."""
    prefixes = []
    for prompt, _ in trace:
        if not any(np.array_equal(prompt[:200], p) for p in prefixes):
            prefixes.append(prompt[:200])
    rng = np.random.default_rng(SEED + 23)
    tail = lambda n: rng.integers(1, vocab, n)  # noqa: E731
    return [(np.concatenate([prefixes[0], tail(8)]), 1),
            (np.concatenate([prefixes[0], tail(100)]), 16),
            (np.concatenate([prefixes[1], tail(40)]), 16)]


# each block on the card from the CPU's inputs: its output (over the CPU's
# pages) and the values it writes are float32 noise apart, except that an
# int8 value within that noise of a rounding boundary lands one step off
LAYER_REL_ERR = 1e-5    # of the block output's max; of each written plane's max
LAYER_FLIPS = 1e-3      # int8 values written one step off, a share of those written


def layers_vs_cpu(label, cpu_params, gpu_params, cfg, prompt, dev, kv):
    """The paged forward one block at a time: a prefill of ``prompt`` (C =
    len, from 0), then one decode step (C = 1), each block run on the CPU
    and twice on the card from the CPU's input and pages. The first card
    run writes its own k/v: the values must equal the CPU's within
    LAYER_REL_ERR (fp; int8 scales) or, for int8 values, but for a
    LAYER_FLIPS share one step off. The second starts from the CPU's
    pages after its write and sends its own write to the NULL page: the
    output must equal the CPU's within LAYER_REL_ERR. Whole int8 runs
    cannot be held token for token: each one-step flip changes a key the
    next layer reads, and the flips grow layer by layer."""
    from pipegoose_tpu_torch.serving import kv_pool as kp

    n, ps = len(prompt), 16
    width = -(-(n + 1) // ps)
    pools = {d: kp.init_pages(cfg, width + 1, ps, kv_dtype=kv, device=d) for d in ("cpu", dev)}
    planes = lambda bank: bank.items() if isinstance(bank, dict) else [("fp", bank)]  # noqa: E731
    out_err = write_err = 0.0
    flips = steps = written = 0
    token = None
    for c, start in ((n, 0), (1, n)):
        args = {}
        for d in ("cpu", dev):
            i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=d)  # noqa: E731
            pos = torch.arange(start, start + c, device=d)[None, :]
            args[d] = dict(tokens=i32([list(prompt)]) if c > 1 else i32([[token]]),
                           page=1 + pos // ps, off=pos % ps, null=torch.zeros_like(pos),
                           table=i32([list(range(1, width + 1))]), start=i32([start]),
                           qmask=torch.ones((1, c), dtype=torch.bool, device=d) if c > 1 else None,
                           slopes=kp._local_slopes(cfg, None, d))
        a, g = args["cpu"], args[dev]
        at = (a["page"][0], a["off"][0])                 # the positions this pass writes
        x = kp._embed(cpu_params, a["tokens"], cfg)
        for i, blk in enumerate(cpu_params["blocks"]):
            cpu_banks = [kp.layer_bank(pools["cpu"][j], i) for j in (0, 1)]
            card_banks = [kp.layer_bank(pools[dev][j], i) for j in (0, 1)]

            def card_pages_from_cpu():
                for src, dst in zip(cpu_banks, card_banks):
                    for (_, s), (_, t) in zip(planes(src), planes(dst)):
                        t.copy_(s)

            card_block = lambda page, off: kp._block(  # noqa: E731
                gpu_params["blocks"][i], x.to(dev), *card_banks, page, off, g["table"],
                g["start"], g["slopes"], g["qmask"], cfg)
            card_pages_from_cpu()
            y = kp._block(blk, x, *cpu_banks, a["page"], a["off"], a["table"], a["start"],
                          a["slopes"], a["qmask"], cfg)
            card_block(g["page"], g["off"])
            for src, dst in zip(cpu_banks, card_banks):
                for (name, s), (_, t) in zip(planes(src), planes(dst)):
                    s, t = s[at], t.cpu()[at]
                    if name == "q":
                        d = (s.int() - t.int()).abs()
                        flips += int((d > 0).sum())
                        steps = max(steps, int(d.max()))
                        written += s.numel()
                    else:
                        write_err = max(write_err,
                                        ((t - s).abs().max() / s.abs().max()).item())
            card_pages_from_cpu()
            yg = card_block(g["null"], g["null"])
            out_err = max(out_err, ((yg.cpu() - y).abs().max() / y.abs().max()).item())
            x = y
        x = kp.layer_norm(cpu_params["ln_f"], x, cfg.layer_norm_epsilon)
        token = int(kp.logits_fn(cpu_params, x)[0, -1].argmax())
    share = flips / max(written, 1)
    log(f"  {label}: each block on the card from the CPU's inputs ({n}-token prefill, one "
        f"decode step): output over the CPU's pages {out_err} of its max, written "
        f"{'scales' if kv else 'values'} {write_err} of their max (limit {LAYER_REL_ERR})"
        + (f", int8 values one step off {flips} of {written} ({share}; limit {LAYER_FLIPS}), "
           f"largest step {steps}" if kv else ""))
    if out_err > LAYER_REL_ERR or write_err > LAYER_REL_ERR or share > LAYER_FLIPS or steps > 1:
        raise AssertionError(f"{label}: a block on the card disagrees with the CPU's")


def phase23_cache_spec_vs_cpu(np_tree, dev) -> None:
    """The float32 engine with the prefix cache, speculative decoding and
    a pool small enough to evict and retract, on the card against the
    CPU, over weights of init std VARIED_INIT_STD: greedy tokens of the
    fp KV runs (check_flip's near-tie rule), each block of the fp and
    int8 KV forwards from the CPU's inputs (``layers_vs_cpu``), and every
    host-side count equal (the
    speculative counts follow the tokens, so they are held equal where
    the tokens are); the paged kernel's launches by route and by query
    count equal to what the card run's counts imply; more than one
    distinct token in every stream and a rejected draft in every
    speculative run; the cached and speculative card engines give the
    plain card engine's tokens."""
    from pipegoose_tpu_torch.models.bloom import BloomConfig
    from pipegoose_tpu_torch.models.weights import params_from_jax
    from pipegoose_tpu_torch.serving import make_skewed_replay

    cfg = dataclasses.replace(BloomConfig.bloom_560m(), n_layer=PHASE23_LAYERS)
    np_tree = {**np_tree, "blocks": cut_layers(np_tree["blocks"], PHASE23_LAYERS)}
    trace = make_skewed_replay(vocab=cfg.vocab_size, **PHASE23_TRACE)
    log(f"phase 23: bloom-560m float32 cut to {PHASE23_LAYERS} layers, init std "
        f"{VARIED_INIT_STD}, make_skewed_replay {PHASE23_TRACE}: prompts "
        f"{[len(p) for p, _ in trace]}, 4 slots, pages of 16, chunk 128, context "
        f"{PHASE23_CONTEXT}")
    cpu_params = params_from_jax(np_tree, cfg, device="cpu")
    gpu_params = params_from_jax(np_tree, cfg, device=dev)
    hole = ledger_hole_requests(trace, cfg.vocab_size) + trace
    ctx = dict(max_context=PHASE23_CONTEXT)
    arms = [("(a) cache, fp KV", trace, dict(prefix_cache=True, **ctx)),
            ("(a) cache, int8 KV", trace, dict(prefix_cache=True, kv_dtype="int8", **ctx)),
            ("(b) cache + speculative (1, 3)", trace,
             dict(prefix_cache=True, speculative=(1, 3), **ctx)),
            ("(b) cache + speculative (12, 3)", trace,
             dict(prefix_cache=True, speculative=(12, 3), **ctx)),
            ("(c) cache, 41-page pool", hole,
             dict(prefix_cache=True, num_pages=LEDGER_HOLE_PAGES, **ctx))]
    card_tokens = {}
    for label, requests, knobs in arms:
        t0 = time.perf_counter()
        cpu_eng, cpu_outs, cpu_m = serve(cpu_params, cfg, requests, "cpu", num_slots=4,
                                         **knobs)
        t1 = time.perf_counter()
        paged_counters_zero()
        gpu_eng, gpu_outs, gpu_m = serve(gpu_params, cfg, requests, dev, num_slots=4,
                                         **knobs)
        got = paged_counts()
        log(f"  {label}: cpu engine {t1 - t0:.1f} s, card engine "
            f"{time.perf_counter() - t1:.1f} s")
        check_routes(label, gpu_eng, gpu_m, got)
        kv = knobs.get("kv_dtype")
        for (prompt, _), c, g in zip(requests, cpu_outs, gpu_outs):
            if kv is None:
                check_flip(f"{label} request {c.uid}", cpu_eng.params, cfg, prompt,
                           c.generated, g.generated)
                continue
            diff = np.nonzero(c.generated != g.generated)[0]
            log(f"  {label} request {c.uid}: card tokens " + (
                f"first differ from the cpu's at step {int(diff[0])}" if diff.size
                else "identical to the cpu's") + " (int8 runs are held block by block)")
        if label.startswith("(a)"):
            layers_vs_cpu(label, cpu_params, gpu_params, cfg, requests[0][0], dev, kv)
        distinct = [len(set(g.generated.tolist())) for g in gpu_outs]
        log(f"  {label}: distinct token ids per request {distinct}")
        if any(d < 2 for d, (_, n) in zip(distinct, requests) if n > 1):
            raise AssertionError(f"{label}: a stream repeats one token id")
        cc, gc_ = run_counts(cpu_eng, cpu_m), run_counts(gpu_eng, gpu_m)
        log(f"  {label}: card counts {gc_}")
        identical = all(np.array_equal(c.generated, g.generated)
                        for c, g in zip(cpu_outs, gpu_outs))
        if cc != gc_ and (identical or "speculative" not in knobs):
            raise AssertionError(f"{label}: card counts {gc_} != cpu counts {cc}")
        if cc != gc_:
            log(f"  {label}: after a near-tie flip the cpu counts are {cc}")
        if "speculative" in knobs and gc_["accepted"] >= gc_["drafted"]:
            raise AssertionError(f"{label}: the verification rejected no draft")
        if label.startswith("(c)"):
            log(f"  {label}: {gc_['evictions']} LRU evictions, {gc_['retractions']} "
                f"retractions")
            if gc_["evictions"] < 1 or gc_["retractions"] < 1:
                raise AssertionError(f"{label}: the run neither evicted nor retracted")
        if gpu_m["prefix_cache"]["cow_copies"] < 1:
            raise AssertionError(f"{label}: no copy-on-write ran")
        card_tokens[label] = [g.generated for g in gpu_outs]
        del cpu_eng, gpu_eng
        gc.collect()
        torch.cuda.empty_cache()
    paged_counters_zero()
    plain_eng, plain_outs, plain_m = serve(gpu_params, cfg, trace, dev, num_slots=4, **ctx)
    check_routes("plain card engine", plain_eng, plain_m, paged_counts())
    del plain_eng
    for label in ("(b) cache + speculative (1, 3)", "(b) cache + speculative (12, 3)"):
        for (prompt, _), p, s in zip(trace, plain_outs, card_tokens[label]):
            check_flip(f"plain card engine vs {label}, request {p.uid}", cpu_params, cfg,
                       prompt, p.generated, s)
    del cpu_params, gpu_params
    gc.collect()
    torch.cuda.empty_cache()


def verify_case(dev, n_layer):
    """The verification's call at phase 24's geometry: 8 rows of C = 4
    queries from seeded starts inside its prompts' span, 24 layer banks."""
    rng = np.random.default_rng(SEED + 24)
    starts = [int(s) for s in rng.integers(392 + 32, 392 + 96 + 60, 8)]
    return make_case(rng, dev, rows=8, c=4, width=64, starts=starts, layers=n_layer)


def phase24_timed_cache_spec(np_tree, dev, card) -> list:
    """Timed bf16 serving of a skewed prefix-reuse trace in five arms,
    over phase 23's weights, through ``prefix_replay_benchmark`` (each arm measured on its third
    run, after a cold and a warm one, so the cached arms are measured
    warm): per arm tokens/s, TTFT, step ms, prefill tokens, hit rate, COW
    copies, acceptance, tokens a cycle and the paged kernel's launches by
    route and by query count in the measured run (equal to what its
    counts imply). Then the paged kernel at the verification's shape
    beside its bound, its plain version and SDPA. Returns that kernel
    row, whose launches are the C = 4 launches counted in the measured
    run of the (1, 3) arm."""
    from pipegoose_tpu_torch.models.bloom import BloomConfig
    from pipegoose_tpu_torch.models.weights import params_from_jax
    from pipegoose_tpu_torch.ops import paged_attention as pa
    from pipegoose_tpu_torch.serving import prefix_replay_benchmark
    from pipegoose_tpu_torch.serving.engine import _quantile

    cfg = BloomConfig.bloom_560m(dtype=torch.bfloat16)
    params = params_from_jax(np_tree, cfg, device=dev)
    log(f"phase 24: bloom-560m bf16, init std {VARIED_INIT_STD}, make_skewed_replay "
        f"{PHASE24_TRACE}, 8 slots, pages of 16, context 1024, chunk 128, on {card}")
    chunk = dict(prefill_chunk=128)
    cached = dict(prefix_cache=True, **chunk)
    arms = {"chunked": chunk,
            "cache+chunked": cached,
            "cache+chunked, int8 KV": dict(kv_dtype="int8", **cached),
            "cache+chunked+spec (1, 3)": dict(speculative=(1, 3), **cached),
            "cache+chunked+spec (12, 3)": dict(speculative=(12, 3), **cached)}
    counted = {}

    def measure(label, eng, run):
        torch.cuda.synchronize()
        paged_counters_zero()
        outs, m = run()
        counted[label] = got = paged_counts()
        ttft = [o.ttft_s for o in outs]
        pc = m.get("prefix_cache", {})
        sp = m.get("speculative")
        log(f"  {label}: {m['decode_tokens_per_s']} tokens/s, TTFT mean "
            f"{np.mean(ttft) * 1e3} ms, p99 {_quantile(ttft, 0.99) * 1e3} ms, mean decode "
            f"{'cycle' if sp else 'step'} {m['decode_step_time_s'] / m['decode_steps'] * 1e3} "
            f"ms over {m['decode_steps']}, {m['generated_tokens']} tokens in "
            f"{m['wall_time_s']} s [{card}]")
        log(f"  {label}: prefill tokens {m['prefill_tokens']} in {m['prefill_chunks']} "
            f"chunks, hit rate {pc.get('hit_rate', 0.0)}, hit tokens "
            f"{pc.get('hit_tokens', 0)}, COW copies {pc.get('cow_copies', 0)}"
            + (f", acceptance {sp['acceptance_rate']} ({sp['accepted_tokens']} of "
               f"{sp['draft_tokens']} drafts), {sp['tokens'] / sp['cycles']} tokens a "
               f"cycle over {sp['cycles']} cycles" if sp else ""))
        log(f"  {label}: distinct token ids per request "
            f"{[len(set(o.generated.tolist())) for o in outs]}")
        want = PHASE24_TRACE["max_new"]
        if m["generated_tokens"] != want * len(outs) or any(len(o.generated) != want
                                                            for o in outs):
            raise AssertionError(f"{label}: not every request got its tokens")
        check_routes(label, eng, m, got)
        return outs, m

    rows = prefix_replay_benchmark(params, cfg, **PHASE24_TRACE, num_slots=8,
                                   num_pages=8 * (1024 // 16) + 1, page_size=16,
                                   max_context=1024, arms=arms, measure=measure, device=dev)
    for label, row in rows.items():
        log(f"  {label}: prefix_replay_benchmark row {row}")
    verify_launches = counted["cache+chunked+spec (1, 3)"]["queries"].get(4, 0)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    case = verify_case(dev, cfg.n_layer)
    k, v = (layer_of(p, 0) for p in pages_as(case, "bf16"))
    q = case["q"].to(torch.bfloat16)
    args = (q, k, v, case["table"], case["start"])
    plan = pa.paged_plan(8, 4, 16, 64, 16, 64, torch.bfloat16, torch.bfloat16)
    out = pa.paged_attention(*args, slopes=case["slopes"])
    ref = pa.paged_attention_reference(*args, slopes=case["slopes"])
    err = (out - ref).abs().max().item()
    log(f"  verify shape B=8 C=4 bf16 pages ({plan['route']} route, {plan['splits']} "
        f"splits): kernel vs plain max_abs_err={err} (atol {ATOL['bf16']})")
    if plan["route"] != "fma" or err > ATOL["bf16"] or not torch.isfinite(out).all():
        raise AssertionError("verify shape: kernel disagrees with plain or left the FMA route")
    t = paged_time(case, "bf16", cfg.n_layer, dev)
    bound_ms, bound_by = paged_bound_ms(case, "bf16", plan["route"])
    (ms, call_ms), (plain_ms, _), (library_ms, _) = t["kernel"], t["plain"], t["library"]
    log(f"  verify shape, starts {case['start'].tolist()}, device ms per call: kernel {ms}, "
        f"bound {bound_ms} ({bound_by}), plain {plain_ms}, SDPA {library_ms}; eager: kernel "
        f"{call_ms} [{card}]")
    del case
    gc.collect()
    torch.cuda.empty_cache()
    return [{"name": "paged_attention (bf16 pages, speculative verification C=4, fma route)",
             **KERNEL, "kernel_route": plan["route"], "launches": verify_launches,
             "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": library_ms, "call_ms": call_ms}]


# -- phase 25 ------------------------------------------------------------------

TP_SIZES = (2, 4)              # phase 25's tensor-parallel degrees
# phase 26(a): each leaf's L2 distance from train_step's params after 3
# float32 steps, over the L2 distance train_step moved it. A leaf the step
# left alone or updated in part is near 1; Adam steps of gradients that
# differ only in summation order part where a gradient is near zero.
HYBRID_PARAM_REL = 1e-2


def head_shard(x, b, nh, h0, lh):
    """Rows of heads ``[h0, h0 + lh)`` of a flattened (B*nh, ...) operand,
    as the tensor-parallel rank holding those heads has them."""
    return x.reshape(b, nh, *x.shape[1:])[:, h0:h0 + lh].reshape(
        b * lh, *x.shape[1:]).contiguous()


def flash_shard_case(case, b, nh, tp, r):
    """Rank r's part of a flash case at tp: its nh/tp heads of q, k, v, dO
    and the key bias, and its slice of the ALiBi slopes."""
    lh = nh // tp
    return {**{n: head_shard(case[n], b, nh, r * lh, lh)
               for n in ("q", "k", "v", "do", "slopes", "kpos", "kneg")},
            "g": case["g"], "scale": case["scale"]}


def flash_shards_vs_whole(label, case, b, nh, tp) -> dict:
    """B1-B3 on every rank's head shard (each with its slope slice) against
    the same heads of the whole nh-head launch, on the route phase 6 takes;
    every launch counter moves by tp. Returns max abs errors."""
    from pipegoose_tpu_torch.ops import flash_attention as fa

    dtype = case["q"].dtype
    s, hd = case["q"].shape[1], case["q"].shape[2]
    route = fa.fwd_plan(dtype, hd, s, s)["route"]
    kernels = (fa.flash_fwd, fa.flash_dq, fa.flash_dkv)

    def run(c):
        fwd, mode = flash_args(c)
        out, lse = fa.flash_fwd(*fwd, *mode)
        bwd = flash_bwd_args(c, lse, (c["do"].float() * out.float()).sum(-1))
        return (out, lse, fa.flash_dq(*bwd, *mode), *fa.flash_dkv(*bwd, *mode))

    whole = run(case)
    before = tuple(f.launches for f in kernels)
    routed = tuple(f.routes[route] for f in kernels)
    parts = [run(flash_shard_case(case, b, nh, tp, r)) for r in range(tp)]
    torch.cuda.synchronize()
    if tuple(f.launches - n for f, n in zip(kernels, before)) != (tp,) * 3 or tuple(
            f.routes[route] - n for f, n in zip(kernels, routed)) != (tp,) * 3:
        raise AssertionError(f"{label}: the shards' launches left the {route} route")
    lh = nh // tp
    checks, exact = {}, True
    for i, name in enumerate(("out", "lse", "dq", "dk", "dv")):
        want = whole[i].reshape(b, nh, *whole[i].shape[1:])
        got = torch.stack([p[i].reshape(b, lh, *p[i].shape[1:]) for p in parts], 1)
        got = got.reshape(want.shape)
        exact = exact and torch.equal(got, want)
        checks[name] = flash_err(got, want, LSE_RTOL if name == "lse" else FLASH_RTOL[dtype])
    bad = [n for n, (err, tol) in checks.items() if err > tol]
    log(f"phase 25: {label}, {tp} shards of {lh} heads vs the whole (all on the {route} "
        f"route{', bit for bit' if exact else ''}): " + ", ".join(
            f"{n} {err:.3g} (tol {tol:.3g})" for n, (err, tol) in checks.items())
        + (f" FAIL {bad}" if bad else " ok"))
    if bad:
        raise AssertionError(f"{label}: head shards disagree with the whole on {bad}")
    return {"fwd": max(checks["out"][0], checks["lse"][0]), "dq": checks["dq"][0],
            "dkv": max(checks["dk"][0], checks["dv"][0])}


def fused_shards_vs_whole(label, case, tp) -> None:
    """B4-B6 on every rank's (V/tp, H) shard at offset r V/tp, as rank r of
    the tensor axis launches them: the shards' (lse, target logit) combined
    with the port's arithmetic (``ops.fused_ce.combine_shards``), dh summed
    over the shards, each shard's dw; held against the whole-vocabulary
    launch to phase 10's tolerances, every launch on its dtype's route."""
    from pipegoose_tpu_torch.ops import fused_ce as fce

    h, w, targets, g, valid = case["h"], case["w"], case["targets"], case["g"], case["valid"]
    dtype, v = h.dtype, w.shape[0]
    vl = v // tp
    fwd_route = "wgmma" if dtype == torch.bfloat16 else "wmma"
    bwd_route = "mma" if dtype == torch.bfloat16 else "wmma"
    lse, tl = fce.fused_ce_fwd(h, w, targets, 0, valid, True)
    dh = fce.fused_ce_dh(h, w, targets, lse, g, 0, valid, True)
    dw = fce.fused_ce_dw(h, w, targets, lse, g, 0, valid, True)
    counters = (fce.fused_ce_fwd, fce.fused_ce_dh, fce.fused_ce_dw)
    before = tuple(c.launches for c in counters)
    routed = (fce.fused_ce_fwd.routes[fwd_route], fce.fused_ce_dh.routes[bwd_route],
              fce.fused_ce_dw.routes[bwd_route])
    shards = [w[r * vl:(r + 1) * vl].contiguous() for r in range(tp)]
    parts = [fce.fused_ce_fwd(h, shards[r], targets, r * vl, valid, True) for r in range(tp)]
    lse_s, tl_s = fce.combine_shards(torch.stack([p[0] for p in parts]),
                                     torch.stack([p[1] for p in parts]),
                                     lambda x: x.amax(0), lambda x: x.sum(0))
    dh_s = sum(fce.fused_ce_dh(h, shards[r], targets, lse_s, g, r * vl, valid, True).float()
               for r in range(tp))
    dw_s = torch.cat([fce.fused_ce_dw(h, shards[r], targets, lse_s, g, r * vl, valid, True)
                      for r in range(tp)])
    torch.cuda.synchronize()
    moved = tuple(c.launches - n for c, n in zip(counters, before))
    now = (fce.fused_ce_fwd.routes[fwd_route], fce.fused_ce_dh.routes[bwd_route],
           fce.fused_ce_dw.routes[bwd_route])
    if moved != (tp,) * 3 or tuple(a - b for a, b in zip(now, routed)) != (tp,) * 3:
        raise AssertionError(f"{label}: shard launches moved {moved}, off the "
                             f"{fwd_route}/{bwd_route} routes")
    checks = {"lse": fused_err(lse_s, lse, FUSED_STAT_RTOL),
              "target logit": fused_err(tl_s, tl, FUSED_STAT_RTOL),
              "dh": fused_err(dh_s, dh, FUSED_GRAD_RTOL[dtype]),
              "dw": fused_err(dw_s, dw, FUSED_GRAD_RTOL[dtype])}
    bad = [n for n, (err, tol) in checks.items() if err > tol]
    log(f"phase 25: {label}, {tp} shards of V/tp={vl} (fwd {fwd_route}, dh/dw {bwd_route}) "
        f"vs the whole: " + ", ".join(
            f"{n} {err:.3g} (tol {tol:.3g}, {err / tol if tol else float('inf'):.2f} of it)"
            for n, (err, tol) in checks.items()) + (f" FAIL {bad}" if bad else " ok"))
    if bad:
        raise AssertionError(f"{label}: vocab shards disagree with the whole on {bad}")


def flash_shard_rows(dev, card, tp) -> list:
    """B1-B3 at rank tp-1's shard of phase 8's shape (B=8, S=1024, 16/tp
    heads of hd 64, bf16): each against its plain version, its time beside
    its bound, the plain version's and SDPA's at that shape."""
    from pipegoose_tpu_torch.ops import flash_attention as fa

    b, nh, s, hd = 8, 16, 1024, 64
    lh = nh // tp
    case = flash_shard_case(flash_case(dev, torch.bfloat16, b=b, seed=SEED + 25), b, nh,
                            tp, tp - 1)
    errs = check_flash(f"bf16 rank {tp - 1} of tp={tp}: B=8 S=1024 nh={lh} hd=64 causal, "
                       f"slopes {case['slopes'][0].item():.6g}..", case, phase="phase 25")
    fwd, mode = flash_args(case)
    out, lse = fa.flash_fwd(*fwd, *mode)
    bwd = flash_bwd_args(case, lse, (case["do"].float() * out.float()).sum(-1))
    dq = fa.flash_dq(*bwd, *mode)
    dk, dv = fa.flash_dkv(*bwd, *mode)
    io = {"fwd": fwd + (out, lse), "dq": bwd + (dq,), "dkv": bwd + (dk, dv)}
    calls = {"fwd": (lambda i: fa.flash_fwd(*fwd, *mode),
                     lambda i: fa.flash_fwd_reference(*fwd, *mode)),
             "dq": (lambda i: fa.flash_dq(*bwd, *mode),
                    lambda i: fa.flash_dq_reference(*bwd, *mode)),
             "dkv": (lambda i: fa.flash_dkv(*bwd, *mode),
                     lambda i: fa.flash_dkv_reference(*bwd, *mode))}
    lib = dict(zip(("fwd", "bwd"), sdpa_ms(case, b, lh, s, hd)))
    route = fa.fwd_plan(torch.bfloat16, hd, s, s)["route"]
    rows = []
    for kind in ("fwd", "dq", "dkv"):
        kernel, plain = calls[kind]
        ms, call_ms = time_ms(kernel, 8)
        plain_ms, _ = time_ms(plain, 4)
        bound_ms, bound_by = flash_bound_ms(kind, case, io[kind])
        library_ms = lib["fwd" if kind == "fwd" else "bwd"]
        log(f"  flash_{kind} at tp={tp} ({route} route): kernel {ms} (eager {call_ms}), "
            f"bound {bound_ms} ({bound_by}), plain {plain_ms}, SDPA {library_ms}, on {card}")
        rows.append({
            "name": f"flash_{kind} (bf16, B*nh={b * lh}: rank {tp - 1}'s {lh} heads at "
                    f"tp={tp}, S=1024, hd=64, causal, {route} route)",
            "source": FLASH_SOURCE, "replaces": FLASH_REPLACES[kind], "route": "cuda",
            "kernel_route": route, "tp": tp, "launches": 0,
            "max_abs_err": errs[kind], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "call_ms": call_ms})
    return rows


def fused_shard_rows(dev, card, tp) -> list:
    """B4-B6 at rank tp-1's (V/tp, H) shard of phase 12's shape (T=8184,
    H=1024, offset (tp-1) V/tp, bf16): each against its plain version, its
    time beside its bound, the plain version's and the composite's."""
    from pipegoose_tpu_torch.ops import fused_ce as fce

    t, hd, v = 8 * 1023, 1024, 250880
    vl, off = v // tp, (tp - 1) * (v // tp)
    case = fused_case(dev, torch.bfloat16, t=t, hd=hd, v=vl, offset=off, seed=SEED + 25)
    h, w, targets, g = case["h"], case["w"], case["targets"], case["g"]
    errs = check_fused(f"bf16 rank {tp - 1} of tp={tp}: T={t} H={hd} V/tp={vl} "
                       f"offset={off} vh", case, phase="phase 25")
    lse, tl = fce.fused_ce_fwd(h, w, targets, off, None, True)
    bwd = (h, w, targets, lse, g, off, None, True)
    dh = fce.fused_ce_dh(*bwd)
    dw = fce.fused_ce_dw(*bwd)
    io = {"fwd": (h, w, targets, lse, tl), "dh": bwd[:5] + (dh,), "dw": bwd[:5] + (dw,)}
    calls = {"fwd": (lambda i: fce.fused_ce_fwd(h, w, targets, off, None, True),
                     lambda: fce.fused_ce_fwd_reference(h, w, targets, off, None, True)),
             "dh": (lambda i: fce.fused_ce_dh(*bwd), lambda: fce.fused_ce_dh_reference(*bwd)),
             "dw": (lambda i: fce.fused_ce_dw(*bwd), lambda: fce.fused_ce_dw_reference(*bwd))}
    library = fused_library(h, w, targets, g, True, off)
    source = {"fwd": FUSED_FWD_SOURCE, "dh": FUSED_MMA_SOURCE, "dw": FUSED_MMA_SOURCE}
    rows = []
    for kind in ("fwd", "dh", "dw"):
        kernel, plain = calls[kind]
        ms, call_ms = time_ms(kernel, 2, replays=5)
        plain_ms = time_eager_ms(plain, 2)
        library_ms = time_eager_ms(library[kind], 2)
        bound_ms, bound_by = fused_bound_ms(kind, case, io[kind])
        route = (fce.card_fwd_plan(h, w, True) if kind == "fwd"
                 else fce.card_plan(h, w, kind, True))["route"]
        log(f"  fused_ce_{kind} at tp={tp} ({route} route): kernel {ms} (eager {call_ms}), "
            f"bound {bound_ms} ({bound_by}), plain {plain_ms}, composite {library_ms}, "
            f"on {card}")
        rows.append({
            "name": f"fused_ce_{kind} (bf16, T={t}, H={hd}, V/tp={vl}: rank {tp - 1}'s vocab "
                    f"shard at tp={tp}, offset {off}, vh)",
            "source": source[kind], "replaces": FUSED_REPLACES[kind], "route": "cuda",
            "kernel_route": route, "tp": tp, "launches": 0,
            "max_abs_err": errs[kind], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "call_ms": call_ms})
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def phase25_tp_shards(dev, card) -> list:
    """What each tensor-parallel rank launches, on one card: for tp in
    TP_SIZES, B1-B3 on every head shard and B4-B6 on every vocab shard,
    bf16 and float32, against the whole (plus a padded vocabulary whose last
    shard holds slots >= valid_size); then each kernel at rank tp-1's shard
    shape against its plain version and timed. Returns the kernels' rows,
    each with ``launches`` 0: the main path on one card runs tp = 1, so no
    shard shape is launched there."""
    b, nh = 8, 16
    t, hd, v = 8 * 1023, 1024, 250880
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        case = flash_case(dev, dtype, b=b, seed=SEED + 25)
        for tp in TP_SIZES:
            flash_shards_vs_whole(f"{name} flash B=8 S=1024 nh=16 hd=64 causal", case, b,
                                  nh, tp)
        del case
        case = fused_case(dev, dtype, t=t, hd=hd, v=v, seed=SEED + 25)
        for tp in TP_SIZES:
            fused_shards_vs_whole(f"{name} fused CE T={t} H={hd} V={v}", case, tp)
        valid = v - 3 * v // 16     # 3/4 of the last shard at tp = 4 is padding
        case["valid"] = valid
        case["targets"] = case["targets"] % valid
        fused_shards_vs_whole(f"{name} fused CE T={t} H={hd} V={v} valid={valid}",
                              case, 4)
        del case
        gc.collect()
        torch.cuda.empty_cache()
    log(f"phase 25: each kernel at rank tp-1's shard shape, device ms per call, on {card}")
    rows = []
    for tp in TP_SIZES:
        rows += flash_shard_rows(dev, card, tp)
        rows += fused_shard_rows(dev, card, tp)
    return rows


# -- phase 26 ------------------------------------------------------------------

def hybrid_context():
    """A world of one rank over NCCL (as ``sp_context``) and
    ``ParallelContext(tensor_parallel_size=1, data_parallel_size=1)`` over
    it: the "tensor" and "data" axes named, each of size 1 (no NCCL group of
    more than one rank runs on one card). The caller destroys it."""
    import tempfile

    import torch.distributed as dist

    from pipegoose_tpu_torch.distributed import ParallelContext

    store_dir = tempfile.mkdtemp(prefix="chip_smoke_store_")
    store = dist.FileStore(f"{store_dir}/store", 1)
    return ParallelContext.init_multihost(store=store, world_size=1, rank=0, device="cuda",
                                          tensor_parallel_size=1, data_parallel_size=1,
                                          expert_parallel_size=1)


class HybridSteps:
    """``make_hybrid_train_step`` behind ``train_step``'s signature (the
    optimizer argument unused): the BLOOM loss with ``tp_axis="tensor"`` on
    the batch (ids, or (ids, mask); labels = ids), ``tp_specs``,
    ``DistributedOptimizer(adam(lr), axis_name="data")``; built on the first
    call over that call's params."""

    def __init__(self, lr, n_accum=1):
        self.lr, self.n_accum, self.step, self.state = lr, n_accum, None, None

    def __call__(self, params, _opt, ids, mask, labels, cfg, device):
        from pipegoose_tpu_torch.models.bloom import loss_fn, tp_specs
        from pipegoose_tpu_torch.optim import DistributedOptimizer, adam
        from pipegoose_tpu_torch.parallel import make_hybrid_train_step

        if self.step is None:
            def lf(p, batch):
                ids, mask = batch if isinstance(batch, tuple) else (batch, None)
                return loss_fn(p, ids, mask, ids, cfg, tp_axis="tensor")

            init_fn, make_step = make_hybrid_train_step(
                lf, tp_specs(params), DistributedOptimizer(adam(self.lr), axis_name="data"),
                n_accum=self.n_accum)
            self.state = init_fn(params)
            self.step = make_step(params)
        _, self.state, loss = self.step(params, self.state,
                                        ids if mask is None else (ids, mask))
        return loss

    def state_bytes(self) -> int:
        return sum(v.numel() * v.element_size() for st in self.state.inner.state.values()
                   for v in st.values() if torch.is_tensor(v))


def phase26_hybrid_vs_train_step(np_tree, dev) -> None:
    """(a) The float32 hybrid step at tp = dp = 1 on the named axes against
    ``train_step`` on the card: phase 7's shape (full width, 2 layers, batch
    2 x 256 with a right-padded row, remat, flash), full logits and fused
    CE, 3 steps each: the losses to phase 7's tolerances; the params after
    the steps no element more than one step (lr) from ``train_step``'s, and
    each leaf's distance from them within HYBRID_PARAM_REL of the distance
    ``train_step`` moved it (L2 norms), every leaf moved by more than lr;
    then ``n_accum = 2`` on an unpadded batch against the whole batch's
    ``train_step``."""
    from pipegoose_tpu_torch.models.bloom import BloomConfig
    from pipegoose_tpu_torch.models.weights import params_from_jax, params_to_jax
    from pipegoose_tpu_torch.trainer import make_optimizer, train_step

    n_layer, b, s, pad, lr = 2, 2, 256, 57, 1e-4
    vocab, hidden = np_tree["embed"]["weight"].shape
    tree = {**np_tree, "blocks": cut_layers(np_tree["blocks"], n_layer)}
    rng = np.random.default_rng(SEED + 26)
    ids = torch.from_numpy(rng.integers(0, vocab, (b, s))).to(dev)
    mask = torch.ones((b, s), dtype=torch.int64, device=dev)
    mask[1, s - pad:] = 0
    counters = kernel_counters()
    for opts, m, n_accum in ((dict(), mask, 1), (dict(fused_ce=True), mask, 1),
                             (dict(), None, 2)):
        cfg = BloomConfig(vocab_size=vocab, hidden_size=hidden, n_layer=n_layer, n_head=16,
                          remat=True, use_flash=True, **opts)
        runs = {}
        for label, fn in (("train_step", train_step), ("hybrid", HybridSteps(lr, n_accum))):
            params = params_from_jax(tree, cfg, device=dev)
            opt = make_optimizer(params, lr)
            before = {k: c.launches for k, c in counters.items()}
            losses = [fn(params, opt, ids, m, ids, cfg, device=dev).item() for _ in range(3)]
            moved = {k: c.launches - before[k] for k, c in counters.items()}
            runs[label] = (losses, params_to_jax(params), moved)
            del params, opt
        (ref, ref_p, ref_moved), (got, got_p, got_moved) = runs["train_step"], runs["hybrid"]
        loss_err = abs(got[0] - ref[0])
        adam_err = max(abs(a - c) for a, c in zip(got, ref))
        param_err = max(float(np.abs(g - r).max()) for _, g, r in zip_leaves(got_p, ref_p))
        start = dict((path, a) for path, a, _ in zip_leaves(tree, tree))
        moved = min(float(np.abs(r - start[path]).max()) for path, r, _ in
                    zip_leaves(ref_p, ref_p))
        param_rel = max(float(np.linalg.norm(g - r) / np.linalg.norm(r - start[path]))
                        for path, g, r in zip_leaves(got_p, ref_p))
        log(f"phase 26: float32 hybrid step (tp = dp = 1, named axes) vs train_step, "
            f"depth 2, batch {b} x {s}{' (row 1 right-padded by 57)' if m is not None else ''}"
            f", {opts or 'full logits'}, n_accum {n_accum}: losses {got} vs {ref}; first "
            f"loss err {loss_err} (atol {TRAIN_LOSS_ATOL}), 3-step err {adam_err} (atol "
            f"{TRAIN_ADAM_LOSS_ATOL}), params max err {param_err} (lr = {lr}), largest "
            f"per-leaf |hybrid - train_step| / |train_step's move| {param_rel} (limit "
            f"{HYBRID_PARAM_REL}), least per-leaf max move {moved} (> lr); launches "
            f"{got_moved} vs {ref_moved}")
        if (loss_err > TRAIN_LOSS_ATOL or adam_err > TRAIN_ADAM_LOSS_ATOL
                or param_err > lr or param_rel > HYBRID_PARAM_REL or moved <= lr
                or not all(np.isfinite(got))):
            raise AssertionError("the hybrid step and train_step disagree")
        # each microbatch runs its own forward and backward
        if got_moved != {k: n_accum * n for k, n in ref_moved.items()} or not got_moved["fwd"]:
            raise AssertionError("the hybrid step launched other kernels than train_step")
        gc.collect()
        torch.cuda.empty_cache()


def phase26_timed_hybrid(np_tree, dev, card, train_run) -> dict:
    """(b) bf16 bloom-560m through ``make_hybrid_train_step`` at tp = dp = 1,
    timed exactly as phase 12's "flash+fusedce" (``timed_training``): its
    launches must equal that run's; step ms, tokens/s and peak beside it,
    and the ZeRO state's bytes."""
    from pipegoose_tpu_torch.models.bloom import BloomConfig

    cfg = BloomConfig.bloom_560m(dtype=torch.bfloat16, remat=True, use_flash=True,
                                 fused_ce=True)
    steps = HybridSteps(1e-4)
    run = timed_training(np_tree, dev, card, cfg, "phase 26",
                         "'flash+fusedce' through make_hybrid_train_step, tp = dp = 1",
                         step_fn=steps)
    state_bytes = steps.state_bytes()
    del steps
    log(f"phase 26: hybrid step {run['step_ms']} ms, {run['tokens_per_s']} tokens/s, peak "
        f"{run['peak_gib']:.2f} GiB, ZeRO state {state_bytes} bytes; phase 12's train_step "
        f"{train_run['step_ms']} ms, {train_run['tokens_per_s']} tokens/s, peak "
        f"{train_run['peak_gib']:.2f} GiB (hybrid / train_step "
        f"{run['step_ms'] / train_run['step_ms']:.4f}); launches {run['launches']} vs "
        f"{train_run['launches']}")
    if run["launches"] != train_run["launches"]:
        raise AssertionError("the hybrid step's launches differ from train_step's")
    run["zero_state_bytes"] = state_bytes
    run["turns_ms"] = step_turns(np_tree, dev, cfg)
    return run


def step_turns(np_tree, dev, cfg, steps=3, rounds=1) -> dict:
    """Step ms of ``train_step`` and of the hybrid step on the same batch, in
    turns (``rounds`` x (train_step, hybrid, hybrid, train_step); each turn
    ``steps`` steps between CUDA events, after one warm-up step of each),
    each on its own copy of the weights: the host's spread between calls
    and phases does not enter the ratio of the medians."""
    from pipegoose_tpu_torch.models.weights import params_from_jax
    from pipegoose_tpu_torch.trainer import make_optimizer, train_step

    ids = torch.from_numpy(
        np.random.RandomState(0).randint(0, cfg.vocab_size, (8, 1024))).to(dev)
    arms = {}
    for name, fn in (("train_step", train_step), ("hybrid", HybridSteps(1e-4))):
        params = params_from_jax(np_tree, cfg, device=dev)
        opt = make_optimizer(params, 1e-4)
        arms[name] = (lambda fn=fn, params=params, opt=opt:
                      fn(params, opt, ids, None, ids, cfg, device=dev))
        arms[name]()
    out = {"train_step": [], "hybrid": []}
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for name in ("train_step", "hybrid", "hybrid", "train_step") * rounds:
        torch.cuda.synchronize()
        t0.record()
        for _ in range(steps):
            arms[name]()
        t1.record()
        torch.cuda.synchronize()
        out[name].append(t0.elapsed_time(t1) / steps)
    med = {k: float(np.median(v)) for k, v in out.items()}
    log(f"  in turns ({rounds} x (train_step, hybrid, hybrid, train_step), {steps} steps "
        f"each): train_step {out['train_step']} ms, hybrid {out['hybrid']} ms; medians "
        f"{med['train_step']} / {med['hybrid']}, ratio {med['hybrid'] / med['train_step']:.4f}")
    del arms
    return out


# -- phase 27 ------------------------------------------------------------------

SAMPLE_T = 0.7
SAMPLE_DRAWS = 200_000
SAMPLE_LOGITS = (1.5, -0.3, 0.8, 2.1, -1.7, 0.0, 1.1, -0.6)
SAMPLE_P_MIN = 1e-3


def chi2_sf(x: float, df: int) -> float:
    """P(chi-square with an odd ``df`` degrees of freedom > x), in closed
    form: erfc(sqrt(x/2)) + sqrt(2x/pi) exp(-x/2) sum_j x^(j-1) / (1 3 ...
    (2j-1)) for j = 1 .. (df-1)/2."""
    import math

    if df % 2 != 1:
        raise ValueError(f"odd degrees of freedom only, got {df}")
    total, term = 0.0, 1.0
    for j in range(1, (df - 1) // 2 + 1):
        term = 1.0 if j == 1 else term * x / (2 * j - 1)
        total += term
    return math.erfc(math.sqrt(x / 2)) + math.sqrt(2 * x / math.pi) * math.exp(-x / 2) * total


def phase27_sampled_generate(np_tree, dev) -> None:
    """Sampled ``generate()`` on the card: bf16 bloom-560m with its
    vocabulary padded for tp = 3 (valid_vocab_size 250880) at temperature
    0.7; the same generator seed gives the same tokens twice, another seed
    others, and no token reaches the padded slots. Then the pick alone:
    200 000 draws of one float32 row of 8 logits against softmax(logits /
    T), a chi-square test, p > 1e-3."""
    from pipegoose_tpu_torch.models._decode import sample_token
    from pipegoose_tpu_torch.models.bloom import BloomConfig, pad_for_tp
    from pipegoose_tpu_torch.models.generate import generate
    from pipegoose_tpu_torch.models.weights import params_from_jax

    tree, cfg = pad_for_tp(np_tree, BloomConfig.bloom_560m(dtype=torch.bfloat16), 3)
    params = params_from_jax(tree, cfg, device=dev)
    del tree
    prompts = np.random.default_rng(SEED + 27).integers(0, cfg.valid_vocab_size, (4, 32))
    new = 32

    def sample(seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return generate(params, prompts, cfg, new, temperature=SAMPLE_T, device=dev,
                        generator=gen).cpu().numpy()

    t0 = time.perf_counter()
    a, again, other = sample(7), sample(7), sample(8)
    toks = a[:, 32:]
    log(f"phase 27: sampled generate, bf16 bloom-560m padded to {cfg.vocab_size} "
        f"(valid {cfg.valid_vocab_size}), 4 prompts x 32, {new} new tokens at T "
        f"{SAMPLE_T}, three runs in {time.perf_counter() - t0:.1f} s: {len(np.unique(toks))} "
        f"distinct ids, max {toks.max()}; seed 7 twice equal: {np.array_equal(a, again)}; "
        f"seed 8 tokens equal to seed 7's: {int((other[:, 32:] == toks).sum())} of {toks.size}")
    if (not np.array_equal(a, again) or np.array_equal(a, other) or toks.max() >= cfg.valid_vocab_size
            or not np.array_equal(a[:, :32], prompts)):
        raise AssertionError("sampled generate: not reproducible, or a padded slot drawn")
    del params
    logits = torch.tensor(SAMPLE_LOGITS, device=dev).repeat(SAMPLE_DRAWS, 1)
    tok = sample_token(logits, SAMPLE_T, torch.Generator(device=dev).manual_seed(SEED))
    counts = torch.bincount(tok, minlength=len(SAMPLE_LOGITS)).cpu().numpy()
    p = torch.softmax(torch.tensor(SAMPLE_LOGITS, dtype=torch.float64) / SAMPLE_T, 0).numpy()
    expected = SAMPLE_DRAWS * p
    stat = float(((counts - expected) ** 2 / expected).sum())
    p_value = chi2_sf(stat, len(SAMPLE_LOGITS) - 1)
    log(f"phase 27: the pick alone on the card, {SAMPLE_DRAWS} draws at T {SAMPLE_T}: "
        f"counts {counts.tolist()}, expected {np.round(expected, 1).tolist()}, chi-square "
        f"{stat:.3f} on {len(SAMPLE_LOGITS) - 1} degrees of freedom, p {p_value:.4f} "
        f"(must exceed {SAMPLE_P_MIN})")
    if not p_value > SAMPLE_P_MIN:
        raise AssertionError("the sampled pick does not follow softmax(logits / T)")


# -- phase 28 ------------------------------------------------------------------

# the Trainer's files (token files, checkpoints, the profiler trace) live in
# the checkout's build/ directory, which git ignores; phase 28 deletes them
TRAINER_WORK = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                            "chip_smoke_trainer")
# (a) keeps one float32 checkpoint of 2 layers at full width (~3.4 GB) on
# disk, (b) one bf16 bloom-560m train state (~3.4 GB)
TRAINER_DISK_BYTES = 12 * 2**30
TRAINER_POISON = 0             # (a)'s sentinel id: a batch that starts with it has a NaN loss
TRAINER_KERNELS = ("flash_fwd_mma_kernel", "flash_dq_mma_kernel", "flash_dkv_mma_kernel",
                   "fused_ce_fwd_wgmma_kernel", "fused_ce_bwd_mma_kernel")


def token_dataset(path, vocab, batch, seq, windows, seed):
    """A token file of ``windows`` x ``seq`` ids in [1, vocab) from ``seed``
    (0 stays free for the poison), Zipf-distributed as a corpus's are (so
    the steps have a unigram to learn and the loss falls over batches it
    has not seen), through the port's ``write_token_file``, and a
    ``TokenDataset`` over it on the native route (asserted)."""
    from pipegoose_tpu_torch.data import TokenDataset, write_token_file

    ids = np.random.RandomState(seed).zipf(1.2, windows * seq) % (vocab - 1) + 1
    write_token_file(ids, path)
    ds = TokenDataset(path, batch=batch, seq=seq, seed=SEED, native=True)
    if ds.route != "native":
        raise AssertionError(f"the token loader runs on {ds.route}, not the native build")
    return ds


def per_step_launches(cfg) -> dict:
    """Each kernel's launches in one train step of ``cfg``."""
    per = {k: 0 for k in kernel_counters()}
    per.update(fwd=(2 if cfg.remat else 1) * cfg.n_layer, dq=cfg.n_layer, dkv=cfg.n_layer)
    per.update({k: int(cfg.fused_ce) for k in ("fused_ce_fwd", "fused_ce_dh", "fused_ce_dw")})
    return per


def counters_zero() -> None:
    for c in kernel_counters().values():
        c.launches = 0
        for by in (getattr(c, "routes", {}), getattr(c, "layouts", {})):
            for r in by:
                by[r] = 0


def counters_read() -> dict:
    return {k: c.launches for k, c in kernel_counters().items()}


def bloom_loss(cfg, poison=False):
    """The BLOOM loss with ``tp_axis="tensor"`` on a batch of ids (labels =
    ids); with ``poison`` NaN on a batch whose first id is TRAINER_POISON, as
    ``tests/trainer/test_recovery.py`` does it."""
    from pipegoose_tpu_torch.models.bloom import loss_fn

    def lf(p, ids):
        base = loss_fn(p, ids, None, ids, cfg, tp_axis="tensor")
        if not poison:
            return base
        return torch.where(ids[0, 0] == TRAINER_POISON, torch.full_like(base, float("nan")),
                           base)

    return lf


def bloom_trainer(tree, cfg, lr, dev, poison=False, **kw):
    """A ``Trainer`` over the whole numpy ``tree`` put on the card: the BLOOM
    loss, ``tp_specs``, ``DistributedOptimizer(adam(lr))`` over "data"."""
    from pipegoose_tpu_torch.models.bloom import tp_specs
    from pipegoose_tpu_torch.models.weights import params_from_jax
    from pipegoose_tpu_torch.optim import DistributedOptimizer, adam
    from pipegoose_tpu_torch.trainer import Trainer

    whole = params_from_jax(tree, cfg, device=dev)
    return Trainer(bloom_loss(cfg, poison), whole, tp_specs(whole),
                   DistributedOptimizer(adam(lr), axis_name="data"), **kw)


def hand_step(tree, cfg, lr, dev):
    """(params, step) of ``make_hybrid_train_step`` called by hand, as phase
    26 calls it: ``step(batch)`` returns the loss."""
    from pipegoose_tpu_torch.models.bloom import tp_specs
    from pipegoose_tpu_torch.models.weights import params_from_jax
    from pipegoose_tpu_torch.optim import DistributedOptimizer, adam
    from pipegoose_tpu_torch.parallel import make_hybrid_train_step

    params = params_from_jax(tree, cfg, device=dev)
    init_fn, make_step = make_hybrid_train_step(
        bloom_loss(cfg), tp_specs(params), DistributedOptimizer(adam(lr), axis_name="data"))
    box = [params, init_fn(params), make_step(params)]

    def step(batch):
        box[0], box[1], loss = box[2](box[0], box[1], batch)
        return loss

    return params, step


def same_run(label, losses, want_losses, params, want_params, lr) -> bool:
    """Whether a run's losses and params equal the hand-called steps' bit
    for bit. If they do not, the run is held to phase 7's loss tolerance
    after Adam steps and its params to within one step (lr) of the
    hand-called run's, as phase 26 holds them, and the log says so."""
    from pipegoose_tpu_torch.nn.parallel import tree_leaves

    bits = losses == want_losses and same_tensors(params, want_params)
    loss_err = max(abs(a - b) for a, b in zip(losses, want_losses))
    param_err = max(float((a.detach() - b.detach()).abs().max()) for a, b in
                    zip(tree_leaves(params), tree_leaves(want_params)))
    log(f"  {label}: losses {losses} vs the hand-called steps' {want_losses}; equal bit for "
        f"bit: {bits}" + ("" if bits else f" (NOT: loss err {loss_err}, atol "
                          f"{TRAIN_ADAM_LOSS_ATOL}; params max err {param_err}, limit lr = "
                          f"{lr}: the same kernels in the same order should repeat their bits, "
                          f"so a difference names a kernel or reduction that does not)"))
    if len(losses) != len(want_losses) or loss_err > TRAIN_ADAM_LOSS_ATOL or param_err > lr:
        raise AssertionError(f"phase 28 (a): {label} differs from the hand-called steps")
    return bits


def same_tensors(a, b) -> bool:
    from pipegoose_tpu_torch.nn.parallel import tree_leaves

    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def snapshot(params):
    from pipegoose_tpu_torch.nn.parallel import tree_map

    return tree_map(lambda p: p.detach().clone(), params)


def phase28a_trainer_vs_steps(np_tree, dev) -> dict:
    """(a) float32, full width at 2 layers, batch 2 x 256 from the native
    token loader, remat + flash + fused CE, Adam 1e-4: ``Trainer.fit`` (4
    steps, CheckpointCallback at step 4, LossLoggerCallback) against 6 steps
    of ``make_hybrid_train_step`` called by hand on the same batches; a new
    Trainer resuming at step 4 for 2 steps; AutoRecovery over a poisoned
    fifth batch, restoring the fit's step-4 checkpoint; ``evaluate``; each
    bit for bit."""
    import shutil

    from pipegoose_tpu_torch.models.bloom import BloomConfig
    from pipegoose_tpu_torch.trainer import AutoRecovery, CheckpointCallback, LossLoggerCallback

    n_layer, b, s, lr = 2, 2, 256, 1e-4
    vocab, hidden = np_tree["embed"]["weight"].shape
    tree = {**np_tree, "blocks": cut_layers(np_tree["blocks"], n_layer)}
    cfg = BloomConfig(vocab_size=vocab, hidden_size=hidden, n_layer=n_layer, n_head=16,
                      remat=True, use_flash=True, fused_ce=True)
    per = per_step_launches(cfg)
    path = os.path.join(TRAINER_WORK, "tokens_a.bin")
    ds = token_dataset(path, vocab, b, s, 64, SEED + 28)
    batches = ds.take(6)
    ds.close()
    log(f"phase 28 (a): float32 Trainer.fit vs make_hybrid_train_step by hand, vocab "
        f"{vocab}, hidden {hidden}, 16 heads, depth cut 24 -> {n_layer}, batch {b} x {s} from "
        f"TokenDataset (native route), remat, flash, fused CE, Adam lr {lr}")

    # by hand: 6 steps, the params after 4 and 5 kept
    counters_zero()
    params, step = hand_step(tree, cfg, lr, dev)
    hand, p4, p5 = [], None, None
    for i, batch in enumerate(batches):
        hand.append(step(batch).item())
        if i == 3:
            p4 = snapshot(params)
        if i == 4:
            p5 = snapshot(params)
    hand_counts = counters_read()
    p6 = params
    del step
    log(f"  by hand: losses {hand}; launches {hand_counts}")
    if hand_counts != {k: 6 * n for k, n in per.items()}:
        raise AssertionError("phase 28 (a): the hand-called step launched other kernels")

    # Trainer.fit over the loader, a checkpoint at step 4
    run_a = os.path.join(TRAINER_WORK, "run_a")
    seen = []

    def feed(loader):
        for x in loader:
            seen.append(x)
            yield x

    ds = token_dataset(path, vocab, b, s, 64, SEED + 28)
    t = bloom_trainer(tree, cfg, lr, dev,
                      callbacks=[CheckpointCallback(run_a, every=4), LossLoggerCallback(every=2)])
    counters_zero()
    t0 = time.perf_counter()
    st = t.fit(feed(ds), max_steps=4)
    fit_s = time.perf_counter() - t0
    counts = counters_read()
    ds.close()
    fit_losses = [float(x) for x in st.losses]
    same_batches = len(seen) == 4 and all(
        x.tobytes() == y.tobytes() for x, y in zip(seen, batches))
    bits = {"fit": same_run("Trainer.fit", fit_losses, hand[:4], t.params, p4, lr)}
    log(f"  Trainer.fit: {fit_s:.1f} s (1 checkpoint); the same batches as by hand: "
        f"{same_batches}; launches {counts} (want 4 x {per})")
    if not same_batches:
        raise AssertionError("phase 28 (a): Trainer.fit and the hand-called steps differ")
    if counts != {k: 4 * n for k, n in per.items()}:
        raise AssertionError("phase 28 (a): Trainer.fit launched other kernels than the step")
    # evaluate: the mean of the loss's forward on the same params
    ev = t.evaluate(batches[4:6])
    with torch.no_grad():
        want = [bloom_loss(cfg)(t.params, torch.from_numpy(x.astype(np.int64)).to(dev)).item()
                for x in batches[4:6]]
    log(f"  evaluate {ev}; the mean of the loss's forward {sum(want) / 2}")
    if ev != sum(want) / 2:
        raise AssertionError("phase 28 (a): evaluate differs from the loss's mean")
    del t

    # a new Trainer resumes at step 4
    t = bloom_trainer(tree, cfg, lr, dev, resume_dir=run_a)
    resumed = [float(x) for x in t.fit(batches[4:6]).losses]
    log(f"  resumed at step 4 from {run_a}, now at step {t.state.step}")
    bits["resume"] = same_run("the resumed run", resumed, hand[4:], t.params, p6, lr)
    if t.state.step != 6:
        raise AssertionError("phase 28 (a): the resumed run did not take 2 steps")
    del t

    # AutoRecovery over a poisoned fifth batch, checkpointing into run_a:
    # its step 4 is on disk already (the fit above wrote it from the same
    # steps, so the callback does not write it again), the poisoned step
    # restores it, and the fifth step runs again
    poisoned = batches[4].copy()
    poisoned[0, 0] = TRAINER_POISON
    rec = AutoRecovery(run_a, max_restores=1)
    t = bloom_trainer(tree, cfg, lr, dev, poison=True,
                      callbacks=[CheckpointCallback(run_a, every=4, save_final=False), rec])
    st = t.fit(batches[:4] + [poisoned, batches[4]])
    log(f"  AutoRecovery over a poisoned fifth batch: {rec.restores} restore(s), step "
        f"{st.step}")
    bits["recovery"] = same_run("the recovered run", [float(x) for x in st.losses],
                                hand[:5], t.params, p5, lr)
    if rec.restores != 1 or st.step != 5:
        raise AssertionError("phase 28 (a): AutoRecovery did not restore once")
    del t, p4, p5, p6
    shutil.rmtree(run_a)
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": hand, "launches_per_step": per, "fit_s": fit_s, "bit_for_bit": bits}


def dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def zero_state_equal(a, b) -> bool:
    """The two trainers' inner optimizer states: every tensor equal."""
    for sa, sb in zip(a.shards, b.shards):
        x, y = a.inner.state[sa], b.inner.state[sb]
        if set(x) != set(y) or not all(torch.equal(x[k], y[k]) for k in x):
            return False
    return True


def trace_kernels(trace_dir) -> dict:
    """The launches of each TRAINER_KERNELS name in the Chrome trace, and
    its device kernels' count and summed ms ("kernels", "busy_ms")."""
    with open(os.path.join(trace_dir, "trace_rank0.json")) as f:
        events = json.load(f)["traceEvents"]
    names = [str(e.get("name", "")) for e in events]
    found = {k: sum(k in n for n in names) for k in TRAINER_KERNELS}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    found["kernels"] = len(kernels)
    found["busy_ms"] = sum(float(e.get("dur", 0)) for e in kernels) / 1e3
    return found


def phase28b_timed_trainer(np_tree, dev, card, hybrid_run, keep=None) -> dict:
    """(b) phase 26(b)'s step through ``Trainer.fit``: bf16 bloom-560m, 8 x
    1024 from the native token loader, remat + flash + fused CE, Adam 1e-4,
    a LossLoggerCallback; 2 warm-up and 6 timed steps (fit wall / steps),
    the launches equal to phase 26(b)'s per step; one checkpoint of the full
    train state saved and restored into a fresh Trainer bit for bit, its
    seconds and bytes; the Chrome trace of one step through
    ``fit(profiler_trace_dir=)``; then the hand-called step and the Trainer
    in turns. ``keep``, a dict, gets the 8 batches of the warm-up and timed
    fits, their losses and the params after them (phase 34 (b))."""
    import shutil

    from pipegoose_tpu_torch.models.bloom import BloomConfig
    from pipegoose_tpu_torch.trainer import LossLoggerCallback
    from pipegoose_tpu_torch.utils.checkpoint import save_train_state

    cfg = BloomConfig.bloom_560m(dtype=torch.bfloat16, remat=True, use_flash=True,
                                 fused_ce=True)
    per = per_step_launches(cfg)
    warm, timed, bs, seq = 2, 6, 8, 1024
    ds = token_dataset(os.path.join(TRAINER_WORK, "tokens_b.bin"), cfg.vocab_size, bs, seq,
                       128, SEED + 29)
    pulled = []

    def recorded(source):
        for batch in source:
            pulled.append(batch)
            yield batch

    it = recorded(iter(ds))
    t = bloom_trainer(np_tree, cfg, 1e-4, dev, callbacks=[LossLoggerCallback(every=8)])
    log(f"phase 28 (b): bloom-560m bf16 through Trainer.fit, batch {bs} x {seq} from "
        f"TokenDataset (native route), remat, flash, fused CE, Adam 1e-4, {warm} warm-up + "
        f"{timed} timed steps, on {card}")
    t.fit(it, max_steps=warm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters_zero()
    t0 = time.perf_counter()
    st = t.fit(it, max_steps=warm + timed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = counters_read()
    layouts = {k: dict(c.layouts) for k, c in kernel_counters().items()
               if hasattr(c, "layouts")}
    step_ms = wall * 1e3 / timed
    tokens_per_s = bs * seq / (step_ms / 1e3)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(x) for x in st.losses]
    if keep is not None:    # phase 34 (b) replays these batches with telemetry on
        keep.update(batches=list(pulled), losses=list(losses), params=snapshot(t.params))
    hybrid_per = {k: n // 7 for k, n in hybrid_run["launches"].items()}
    log(f"  Trainer.fit step {step_ms} ms (fit wall / {timed} steps), {tokens_per_s} "
        f"tokens/s, peak {peak_gib:.2f} GiB; phase 26(b)'s hand-called step "
        f"{hybrid_run['step_ms']} ms (Trainer / hand {step_ms / hybrid_run['step_ms']:.4f}); "
        f"losses {losses}")
    log(f"  launches over {timed} steps {counts} (fused CE by weight layout {layouts}); per "
        f"step {per}; phase 26(b)'s per step {hybrid_per}")
    if counts != {k: timed * n for k, n in per.items()} or any(
            per[k] != n for k, n in hybrid_per.items()):
        raise AssertionError("phase 28 (b): the Trainer's launches differ from phase 26(b)'s")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"phase 28 (b): losses not finite and falling: {losses}")

    # one checkpoint of the full train state, restored into a fresh Trainer
    free = shutil.disk_usage(TRAINER_WORK).free
    log(f"  free disk under {TRAINER_WORK}: {free} bytes (need {TRAINER_DISK_BYTES})")
    if free < TRAINER_DISK_BYTES:
        raise AssertionError(f"phase 28 (b): {free} bytes free, too few for a checkpoint")
    ckpt, saved = os.path.join(TRAINER_WORK, "run_b"), t.state.step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = save_train_state(ckpt, saved, t.params, t.opt_state, specs=t.param_specs,
                            parallel_context=t.parallel_context)
    save_s = time.perf_counter() - t0
    ckpt_bytes = dir_bytes(path)
    fresh = bloom_trainer(np_tree, cfg, 1e-4, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh.restore_from(ckpt, saved)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    equal = same_tensors(fresh.params, t.params) and zero_state_equal(
        fresh.opt_state, t.opt_state)
    batch = next(it)
    nxt = [float(x.fit([batch]).losses[-1]) for x in (t, fresh)]
    log(f"  checkpoint of step {saved}: {ckpt_bytes} bytes, saved in {save_s:.2f} s "
        f"({ckpt_bytes / save_s / 1e9:.2f} GB/s), restored into a fresh Trainer in "
        f"{restore_s:.2f} s ({ckpt_bytes / restore_s / 1e9:.2f} GB/s); params and moments "
        f"equal bit for bit: {equal}; next loss {nxt[0]} vs the restored Trainer's {nxt[1]}")
    if not equal or nxt[0] != nxt[1]:
        raise AssertionError("phase 28 (b): the restored train state differs")
    del fresh
    shutil.rmtree(ckpt)

    # the Chrome trace of one step
    trace_dir = os.path.join(TRAINER_WORK, "trace")
    t0 = time.perf_counter()
    t.fit([next(it)], profiler_trace_dir=trace_dir)
    found = trace_kernels(trace_dir)
    trace_bytes = dir_bytes(trace_dir)
    log(f"  fit(profiler_trace_dir=) of one step: {trace_bytes} bytes of Chrome trace in "
        f"{time.perf_counter() - t0:.1f} s; kernel launches named in it, and the device "
        f"kernels' count and summed ms {found}")
    if not all(found[k] for k in TRAINER_KERNELS):
        raise AssertionError("phase 28 (b): the trace does not name every kernel of the step")
    shutil.rmtree(trace_dir)

    # in turns with the hand-called step, on one batch
    params, hand = hand_step(np_tree, cfg, 1e-4, dev)
    hand(batch)
    arms = {"hand": lambda: hand(batch), "trainer": lambda: t.fit([batch])}
    turns = {"hand": [], "trainer": []}
    steps = 3
    for name in ("hand", "trainer", "trainer", "hand"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            arms[name]()
        torch.cuda.synchronize()
        turns[name].append((time.perf_counter() - t0) * 1e3 / steps)
    med = {k: float(np.median(v)) for k, v in turns.items()}
    log(f"  in turns (hand, Trainer, Trainer, hand; {steps} steps each, wall): hand "
        f"{turns['hand']} ms, Trainer {turns['trainer']} ms; medians {med['hand']} / "
        f"{med['trainer']}, ratio {med['trainer'] / med['hand']:.4f}")
    ds.close()
    del t, params, hand, arms
    gc.collect()
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "hybrid_step_ms": hybrid_run["step_ms"],
            "tokens_per_s": tokens_per_s, "peak_gib": peak_gib, "losses": losses,
            "launches_per_step": per, "launches": counts, "layouts": layouts,
            "turns_ms": turns,
            "turns_median_ratio": med["trainer"] / med["hand"],
            "checkpoint_bytes": ckpt_bytes, "save_s": save_s, "restore_s": restore_s,
            "trace_bytes": trace_bytes, "trace_kernels": found}


def phase28_trainer(np_tree, dev, card, hybrid_run, keep=None) -> dict:
    os.makedirs(TRAINER_WORK, exist_ok=True)
    try:
        a = phase28a_trainer_vs_steps(np_tree, dev)
        b = phase28b_timed_trainer(np_tree, dev, card, hybrid_run, keep)
    finally:
        import shutil

        shutil.rmtree(TRAINER_WORK, ignore_errors=True)
    return {"a": a, "b": b}


TRAINER_COUNTERS = {FLASH_REPLACES["fwd"]: "fwd", FLASH_REPLACES["dq"]: "dq",
                    FLASH_REPLACES["dkv"]: "dkv", FUSED_REPLACES["fwd"]: "fused_ce_fwd",
                    FUSED_REPLACES["dh"]: "fused_ce_dh", FUSED_REPLACES["dw"]: "fused_ce_dw"}


def trainer_launches(row, run) -> int:
    """A kernels-line row's launches in phase 28 (b)'s timed fit: its
    kernel's count there at the whole-model shapes, a fused CE row's by its
    weight layout (a tp shard row, or a kernel off the path, 0)."""
    name = TRAINER_COUNTERS.get(row["replaces"])
    if "tp" in row or row.get("family") or name is None:
        return 0
    if name in run["layouts"]:
        return run["layouts"][name].get("hv" if row["name"].endswith("hv)") else "vh", 0)
    return run["launches"][name]


# -- phase 29 ------------------------------------------------------------------

def tp_knobs(params):
    """The engine's tensor-parallel options over the current context's
    "tensor" axis (size 1 on one card)."""
    from pipegoose_tpu_torch.models.bloom import tp_specs

    return {"param_specs": tp_specs(params), "tp_axis": "tensor"}


def serving_counters_zero():
    """Every serving kernel's launch and route counters to 0."""
    paged_counters_zero()
    for name, c in serving_counters().items():
        if name != "paged_attention":
            c.launches = 0
            c.routes = {"mma": 0, "fma": 0}


def serving_counts():
    """The serving kernels' launches by route: the paged kernel's (and by
    query count) and each quantized matmul's."""
    counters = serving_counters()
    return {"paged": paged_counts(),
            **{k: {"all": counters[k].launches, **counters[k].routes} for k in ("int8", "int4")}}


def phase29a_tp_engine_vs_plain(np_tree, dev) -> None:
    """(a) At tp = 1 on the named "tensor" axis: the float32 engine with int8
    weights, chunked, on phase 3's requests, with ``param_specs`` and
    without; every collective is the identity, so the tokens must be equal
    bit for bit and the kernels' launches by route equal. Then
    ``generate_tp`` against ``generate()`` on the same prompts (a ragged
    left-padded batch, 16 new tokens), bit for bit."""
    from pipegoose_tpu_torch.models.bloom import BloomConfig
    from pipegoose_tpu_torch.models.generate import generate, generate_tp
    from pipegoose_tpu_torch.models.weights import params_from_jax

    cfg = BloomConfig.bloom_560m()
    requests = card_vs_cpu_requests(cfg)
    params = params_from_jax(np_tree, cfg, device=dev)
    knobs = dict(weight_dtype="int8")
    log(f"phase 29 (a): bloom-560m float32, int8 weights, chunk 128, 4 slots, phase 3's "
        f"requests (prompts {[len(p) for p, _ in requests]}, 16 new tokens), with and "
        f"without param_specs=tp_specs on the one-rank \"tensor\" axis")
    runs = {}
    for label, extra in (("plain", {}), ("tp", tp_knobs(params))):
        serving_counters_zero()
        eng, outs, m = serve(params, cfg, requests, dev, num_slots=4, **knobs, **extra)
        counts = serving_counts()
        log(f"  {label} engine: launches {counts}, decode steps {m['decode_steps']}, "
            f"chunks {m['prefill_chunks']}")
        check_launches(f"{label} engine", counts["paged"]["all"], m, cfg.n_layer)
        check_quant_launches(f"{label} engine", {k: v["all"] for k, v in counts.items()}, m,
                             cfg.n_layer, "int8")
        runs[label] = ([o.generated for o in outs], counts, eng.memory_report())
        del eng
    (pt, pc, pm), (tt, tc, tm) = runs["plain"], runs["tp"]
    same = all(np.array_equal(a, b) for a, b in zip(pt, tt))
    log(f"  tp engine vs plain engine: tokens bit for bit {same}, launches by route "
        f"equal {pc == tc}, memory reports equal {pm == tm}")
    if not (same and pc == tc and pm == tm):
        raise AssertionError("phase 29 (a): the tp = 1 engine differs from the plain one")
    width = max(len(p) for p, _ in requests)
    ids = np.zeros((len(requests), width), np.int64)
    mask = np.zeros_like(ids)
    for i, (p, _) in enumerate(requests):
        ids[i, width - len(p):] = p
        mask[i, width - len(p):] = 1
    want = generate(params, ids, cfg, 16, attention_mask=mask, device=dev).cpu().numpy()
    got = generate_tp(params, ids, cfg, 16, tp_knobs(params)["param_specs"],
                      attention_mask=mask, device=dev).cpu().numpy()
    log(f"  generate_tp vs generate(), {len(requests)} left-padded prompts x {width}, 16 "
        f"new tokens: equal bit for bit {np.array_equal(got, want)}")
    if not np.array_equal(got, want):
        raise AssertionError("phase 29 (a): generate_tp differs from generate()")
    del params
    gc.collect()
    torch.cuda.empty_cache()


def phase29b_timed_tp_serving(np_tree, dev, card, fp_arm) -> None:
    """(b) Phase 4's bf16 fp-KV workload through the TP engine at tp = 1 and
    through the plain engine, in turns (plain, TP, TP, plain; phase 4's
    runs warmed the card): tokens/s, mean TTFT and mean step ms of each,
    beside phase 4's fp arm; every run's tokens equal phase 4's bit for bit
    and each TP run's paged launches n_layer x (decode steps + chunks) on
    their routes."""
    from pipegoose_tpu_torch.models.bloom import BloomConfig
    from pipegoose_tpu_torch.models.weights import params_from_jax

    cfg = BloomConfig.bloom_560m(dtype=torch.bfloat16)
    params = params_from_jax(np_tree, cfg, device=dev)
    requests = phase4_requests(cfg)
    base = fp_arm["metrics"]
    log(f"phase 29 (b): phase 4's workload (bf16, fp KV, 12 requests, 8 slots), the plain "
        f"and the TP engine at tp = 1 in turns; phase 4's fp arm {base['decode_tokens_per_s']} "
        f"tokens/s, mean TTFT {base['mean_ttft_s'] * 1e3} ms, mean decode step "
        f"{base['decode_step_time_s'] / base['decode_steps'] * 1e3} ms [{card}]")
    runs = {"plain": [], "tp": []}
    for label in ("plain", "tp", "tp", "plain"):
        torch.cuda.synchronize()
        serving_counters_zero()
        knobs = tp_knobs(params) if label == "tp" else {}
        _, outs, m = serve(params, cfg, requests, dev, num_slots=8, **knobs)
        counts = paged_counts()
        step_ms = m["decode_step_time_s"] / m["decode_steps"] * 1e3
        runs[label].append((m["decode_tokens_per_s"], m["mean_ttft_s"] * 1e3, step_ms))
        log(f"  {label} engine: {m['decode_tokens_per_s']} tokens/s, mean TTFT "
            f"{m['mean_ttft_s'] * 1e3} ms, mean decode step {step_ms} ms")
        check_launches(f"{label} engine", counts["all"], m, cfg.n_layer)
        routes = {r: counts[r] for r in ("fma", "mma")}
        want = {"fma": cfg.n_layer * m["decode_steps"],
                "mma": cfg.n_layer * m["prefill_chunks"]}
        same = all(np.array_equal(o.generated, t) for o, t in zip(outs, fp_arm["tokens"]))
        if routes != want or not same:
            raise AssertionError(f"phase 29 (b): the {label} engine left a route "
                                 f"({routes}, want {want}) or phase 4's tokens")
    mean = {k: np.mean(v, axis=0) for k, v in runs.items()}
    log(f"  in turns, mean of two runs each: tp {mean['tp'].tolist()}, plain "
        f"{mean['plain'].tolist()} (tokens/s, TTFT ms, step ms); tp / plain step ms "
        f"{mean['tp'][2] / mean['plain'][2]}; every run's tokens equal phase 4's [{card}]")
    del params
    gc.collect()
    torch.cuda.empty_cache()


def shard_heads(pages, h):
    """Heads ``h`` of a bank (fp, or int8 with its scale plane), contiguous."""
    if isinstance(pages, dict):
        return {"q": pages["q"][..., h, :].contiguous(),
                "scale": pages["scale"][..., h].contiguous()}
    return pages[..., h, :].contiguous()


def paged_shard_case(case, tp, r):
    """Rank r's part of a paged case at tp: its nh/tp heads of q and of the
    float32 banks, and its slice of the ALiBi slopes."""
    nh = case["q"].shape[2]
    h = slice(r * nh // tp, (r + 1) * nh // tp)
    return {**case, "q": case["q"][:, :, h].contiguous(), "k": shard_heads(case["k"], h),
            "v": shard_heads(case["v"], h), "slopes": case["slopes"][h].contiguous()}


def paged_shards_vs_whole(label, case, fmt, tp, want_route) -> float:
    """The paged kernel on every rank's head shard (its slope slice) against
    the same heads of the whole launch and against its plain version, to
    phase 2's tolerance; every launch on ``want_route``. Returns the
    largest error."""
    from pipegoose_tpu_torch.ops import paged_attention as pa

    q = case["q"].to(torch.bfloat16)
    k, v = (layer_of(p, 0) for p in pages_as(case, fmt))
    args = (case["table"], case["start"])
    whole = pa.paged_attention(q, k, v, *args, slopes=case["slopes"])
    b, c, nh, hd = q.shape
    lh = nh // tp
    pages = k["q"] if fmt == "int8" else k
    plans = [pa.paged_plan(b, c, n, hd, pages.shape[1], case["table"].shape[1], q.dtype,
                           pages.dtype) for n in (nh, lh)]
    before = dict(pa.paged_attention.routes)
    err = 0.0
    for r in range(tp):
        h = slice(r * lh, (r + 1) * lh)
        qs, ks, vs, sl = q[:, :, h].contiguous(), shard_heads(k, h), shard_heads(v, h), \
            case["slopes"][h].contiguous()
        out = pa.paged_attention(qs, ks, vs, *args, slopes=sl)
        ref = pa.paged_attention_reference(qs, ks, vs, *args, slopes=sl)
        if not torch.isfinite(out).all():
            raise AssertionError(f"{label}: non-finite shard output")
        err = max(err, (out - whole[:, :, h]).abs().max().item(),
                  (out - ref).abs().max().item())
    torch.cuda.synchronize()
    moved = {r: pa.paged_attention.routes[r] - before[r] for r in before}
    ok = err <= ATOL[fmt] and moved == {**dict.fromkeys(before, 0), want_route: tp}
    log(f"phase 29 (c): {label} {fmt} pages at tp={tp}: {tp} shards of {lh} heads vs the "
        f"whole and vs plain max_abs_err={err} (atol {ATOL[fmt]}); routes {moved} (want "
        f"{want_route}); splits whole {plans[0]['splits']} x {plans[0]['blocks']} blocks, "
        f"shard {plans[1]['splits']} x {plans[1]['blocks']} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label} {fmt} tp={tp}: head shards disagree or left "
                             f"the {want_route} route")
    return err


def paged_shard_rows(dev, card) -> list:
    """The paged kernel at every tp 2 / tp 4 rank's heads of phase 5's decode
    and chunk shapes and phase 24's verification shape, bf16 and int8 pages;
    then rank tp-1's shard timed as phase 5 times the whole."""
    from pipegoose_tpu_torch.ops import paged_attention as pa

    n_layer = 24
    cases = {**phase5_cases(dev, n_layer), "verification": verify_case(dev, n_layer)}
    routes = {"decode": "fma", "chunk": "mma", "verification": "fma"}
    rows = []
    for kind, case in cases.items():
        for fmt in ("bf16", "int8"):
            for tp in TP_SIZES:
                err = paged_shards_vs_whole(kind, case, fmt, tp, routes[kind])
                shard = paged_shard_case(case, tp, tp - 1)
                b, c, lh, hd = shard["q"].shape
                plan = pa.paged_plan(b, c, lh, hd, 16, 64, torch.bfloat16,
                                     torch.bfloat16 if fmt == "bf16" else torch.int8)
                t = paged_time(shard, fmt, n_layer, dev)
                bound_ms, bound_by = paged_bound_ms(shard, fmt, plan["route"])
                (ms, call_ms), (plain_ms, _), (library_ms, _) = (t["kernel"], t["plain"],
                                                                 t["library"])
                log(f"  {kind} {fmt} pages, rank {tp - 1}'s {lh} heads at tp={tp} "
                    f"({plan['route']} route, {plan['splits']} splits, {plan['blocks']} "
                    f"blocks), device ms per call: kernel {ms}, bound {bound_ms} "
                    f"({bound_by}), plain {plain_ms}, SDPA {library_ms}; eager kernel "
                    f"{call_ms} [{card}]")
                rows.append({
                    "name": f"paged_attention ({fmt} pages, {kind} B={b} C={c}: rank "
                            f"{tp - 1}'s {lh} heads at tp={tp}, {plan['route']} route)",
                    **KERNEL, "kernel_route": plan["route"], "tp": tp, "launches": 0,
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
                    "call_ms": call_ms})
                del shard
        del case
        gc.collect()
        torch.cuda.empty_cache()
    return rows


# each bloom-560m product's tensor-parallel role: qkv and up column-parallel
# (N sharded), out and down row-parallel (K sharded)
BLOOM_ROLES = ("column", "row", "column", "row")


def quant_shard(kind, role, x, q, scale, tp, r):
    """Rank r's operands of one quantized product at tp: a column shard's
    N/tp columns of q and scale (x whole); a row shard's K/tp columns of x
    and rows of q (K/2tp packed int4 rows), its int4 scales' K/(G tp) groups
    (int8 scales whole)."""
    if role == "column":
        n = q.shape[1] // tp
        cols = slice(r * n, (r + 1) * n)
        return x, q[:, cols].contiguous(), scale[..., cols].contiguous()
    k = x.shape[1] // tp
    rows = slice(r * k, (r + 1) * k)
    qk = q.shape[0] // tp
    q_rows = slice(r * qk, (r + 1) * qk)
    if kind == "int8":
        return x[:, rows].contiguous(), q[q_rows].contiguous(), scale
    g = scale.shape[0] // tp
    return (x[:, rows].contiguous(), q[q_rows].contiguous(),
            scale[r * g:(r + 1) * g].contiguous())


def quant_shards_vs_whole(dev, kind, t, tp) -> float:
    """Every rank's shard of bloom-560m's four products (int4 G = 32), bf16
    x at T tokens, from the whole weight quantized once (the engine's
    order): a column shard equals the whole launch's column slice, the row
    shards' partial products summed equal the whole product, each within
    QUANT_RTOL of the largest value; every launch on the tensor-core route.
    Returns the largest error over the tolerance's scale."""
    from pipegoose_tpu_torch.quant import matmul as qm

    wrapper = getattr(qm, f"quantized_matmul_{kind}")
    worst = 0.0
    for i, ((k, n), role) in enumerate(zip(BLOOM_KN, BLOOM_ROLES)):
        x, [(q, scale)] = quant_case(dev, kind, k, n, t, torch.bfloat16, SEED + 29 + i)
        whole = wrapper(x, q, scale)
        before = dict(wrapper.routes)
        parts = [wrapper(*quant_shard(kind, role, x, q, scale, tp, r)) for r in range(tp)]
        torch.cuda.synchronize()
        if wrapper.routes != {**before, "mma": before["mma"] + tp}:
            raise AssertionError(f"{kind} T={t} {k}x{n} tp={tp}: a shard left the "
                                 f"tensor-core route")
        got = torch.cat(parts, dim=1) if role == "column" else sum(parts)
        tol = QUANT_RTOL * whole.abs().max().item()
        err = (got - whole).abs().max().item()
        worst = max(worst, err)
        log(f"phase 29 (c): {kind} T={t} {k}x{n} {role}-parallel at tp={tp}: "
            f"{'columns' if role == 'column' else 'summed partials'} vs the whole "
            f"max_abs_err={err} (tol {tol}) {'ok' if err <= tol else 'FAIL'}")
        if err > tol or not torch.isfinite(got).all():
            raise AssertionError(f"{kind} {k}x{n} tp={tp}: shards disagree with the whole")
    return worst


def quant_shard_rows(dev, card) -> list:
    """B10-B11 at every tp 2 / 4 shard against the whole (decode T = 8 and
    chunk T = 128), then rank tp-1's shard of each product timed as phase 17
    times the whole, each call reading the next of 24 layers' weights: one
    layer's four products summed per row."""
    from pipegoose_tpu_torch.quant import matmul as qm

    n_layer = 24
    rows = []
    for kind in ("int8", "int4"):
        kernel = getattr(qm, f"quantized_matmul_{kind}")
        for t, shape in ((8, "decode"), (128, "chunk")):
            for tp in TP_SIZES:
                err = quant_shards_vs_whole(dev, kind, t, tp)
                tot = dict.fromkeys(("ms", "call_ms", "plain_ms", "library_ms", "bound_ms",
                                     "bytes", "ops"), 0.0)
                for i, ((k, n), role) in enumerate(zip(BLOOM_KN, BLOOM_ROLES)):
                    x, layers = quant_case(dev, kind, k, n, t, torch.bfloat16,
                                           SEED + 17 + i, layers=n_layer)
                    shards = [quant_shard(kind, role, x, q, s, tp, tp - 1) for q, s in layers]
                    xs = shards[0][0]
                    ops = [(q, s) for _, q, s in shards]
                    deq = [qm.dequantize_weight(q, s).to(torch.bfloat16) for q, s in ops]
                    got = {}
                    got["ms"], got["call_ms"] = time_ms(
                        lambda j: kernel(xs, *ops[j % n_layer]), n_layer)
                    got["plain_ms"], _ = time_ms(
                        lambda j: qm.quantized_matmul_reference(xs, *ops[j % n_layer]),
                        n_layer)
                    got["library_ms"], _ = time_ms(
                        lambda j: torch.matmul(xs, deq[j % n_layer]), n_layer)
                    kl, nl = xs.shape[1], deq[0].shape[1]
                    got["bound_ms"], got["bytes"], got["ops"] = quant_bound_ms(
                        xs, *ops[0], t, kl, nl)
                    log(f"  {kind} T={t} rank {tp - 1}'s {role} shard {kl}x{nl} of {k}x{n} "
                        f"at tp={tp}: kernel {got['ms']} (eager {got['call_ms']}), bound "
                        f"{got['bound_ms']}, plain {got['plain_ms']}, cuBLAS bf16 x @ "
                        f"dequantized bf16 {got['library_ms']} [{card}]")
                    for key in tot:
                        tot[key] += got[key]
                    del layers, shards, ops, deq
                gc.collect()
                torch.cuda.empty_cache()
                log(f"  {kind} T={t} at tp={tp}, one layer's four shards: kernel {tot['ms']}, "
                    f"bound {tot['bound_ms']}, plain {tot['plain_ms']}, cuBLAS bf16 "
                    f"{tot['library_ms']}")
                rows.append({
                    "name": f"quantized_matmul_{kind} (bf16, {shape} T={t}: rank {tp - 1}'s "
                            f"shards of qkv+out+up+down at tp={tp}, summed)",
                    "source": QUANT_SOURCE, "replaces": QUANT_REPLACES[kind],
                    "route": "cuda", "kernel_route": "mma", "tp": tp, "launches": 0,
                    "max_abs_err": err, "ms": tot["ms"], "plain_ms": tot["plain_ms"],
                    "bound_ms": tot["bound_ms"],
                    "bound_by": "bytes" if tot["bytes"] >= tot["ops"] else "operations",
                    "library_ms": tot["library_ms"], "call_ms": tot["call_ms"]})
    return rows


def phase29_tp_serving(np_tree, dev, card, fp_arm) -> list:
    """Tensor-parallel serving on the current one-rank context: (a) the
    engine and generate_tp at tp = 1 against their single-device selves,
    (b) phase 4's fp arm through the TP engine, timed, (c) the paged and
    quantized kernels at every tp 2 / 4 rank's shard against the whole, and
    rank tp-1's shards timed. Returns (c)'s rows, each with ``launches`` 0:
    the one-card main path runs tp = 1."""
    phase29a_tp_engine_vs_plain(np_tree, dev)
    phase29b_timed_tp_serving(np_tree, dev, card, fp_arm)
    log(f"phase 29 (c): the serving kernels at every tensor-parallel rank's shard, on {card}")
    return paged_shard_rows(dev, card) + quant_shard_rows(dev, card)


# -- phase 30 ------------------------------------------------------------------

PHASE30_STEPS = 2              # (a)'s steps an arm
PHASE30_MIRROR_STEPS = 1       # bf16 and int8: the steps whose reduction runs on the CPU too
PHASE30_MICRO = (2, 4)
# (b)'s turns: rounds of the arms forward then back, steps a turn
PHASE30_ROUNDS = 1
PHASE30_TURN_STEPS = 2


def phase30_loss(kind, micro=None):
    """The loss of one phase 30 arm as ``lf(params, ids, mask, cfg)``, the
    labels the ids: "dense" (``loss_fn``), "pp" (GPipe), "1f1b", "sp"
    (``loss_fn_sp`` at sp = 1) or "pp_sp", every one with
    ``tp_axis="tensor"`` on the one-rank context."""
    from pipegoose_tpu_torch.models import bloom

    if kind == "dense":
        return lambda p, ids, m, cfg: bloom.loss_fn(p, ids, m, ids, cfg, tp_axis="tensor")
    if kind == "sp":
        return lambda p, ids, m, cfg: bloom.loss_fn_sp(p, ids, m, ids, cfg,
                                                       tp_axis="tensor", sp_axis="seq")
    fn = {"pp": bloom.loss_fn_pp, "1f1b": bloom.loss_fn_1f1b,
          "pp_sp": bloom.loss_fn_pp_sp}[kind]
    return lambda p, ids, m, cfg: fn(p, ids, m, ids, cfg, micro, tp_axis="tensor")


class MirroredOptimizer:
    """A ``DistributedOptimizer`` whose compressed reduction is also run on
    the CPU, on a CPU copy of the card's gradients at each of the first
    PHASE30_MIRROR_STEPS steps: the reduced gradients (what the inner Adam
    takes) on the card against the CPU's, bit for bit, and on the first step
    each leaf's int8 payload and per-chunk scale. With ``trajectory`` the
    whole step instead, at every step: the same optimizer over CPU copies of
    the params, fed the card's gradients, its params after each step kept on
    the card (``trajectory``)."""

    def __init__(self, opt, params, trajectory=False):
        from pipegoose_tpu_torch.optim import DistributedOptimizer

        self.opt = opt
        self.device = params["embed"]["weight"].device
        self.trajectory = [] if trajectory else None
        self.cpu_opt = DistributedOptimizer(opt.inner, opt.axis_name, opt.grad_comm,
                                            opt.error_feedback)
        if trajectory:
            self.cpu_params = to_device(params, "cpu")
            self.cpu_state = self.cpu_opt.init(self.cpu_params)
        self.first = None   # per leaf: (payload and scale equal, its int8 step)
        self.reduced_equal = True
        self.cpu_s = 0.0
        self.steps = 0

    def __getattr__(self, name):
        return getattr(self.opt, name)

    def init(self, params):
        return self.opt.init(params)

    def step(self, grads, state, params):
        from pipegoose_tpu_torch.distributed.compressed import (
            _quantize_chunks,
            compressed_reduce_scatter_mean,
        )
        from pipegoose_tpu_torch.nn.parallel import tree_leaves, tree_map

        self.steps += 1
        if self.trajectory is None and self.steps > PHASE30_MIRROR_STEPS:
            return self.opt.step(grads, state, params)
        t0 = time.perf_counter()
        cpu_grads = tree_map(lambda g: g.detach().to("cpu", copy=True), grads)
        if self.first is None:   # (the payloads only where the wire is int8)
            self.first = []
            for g, c in zip(tree_leaves(grads), tree_leaves(cpu_grads)):
                qg, sg = _quantize_chunks(g.detach().float().reshape(1, -1))
                same = True
                if self.opt.grad_comm == "int8":
                    qc, sc = _quantize_chunks(c.float().reshape(1, -1))
                    same = torch.equal(qg.cpu(), qc) and torch.equal(sg.cpu(), sc)
                self.first.append((same, float(sg.max())))
        if self.trajectory is not None:
            self.cpu_opt.step(cpu_grads, self.cpu_state, self.cpu_params)
            self.trajectory.append(to_device(self.cpu_params, self.device))
        self.cpu_s += time.perf_counter() - t0
        out = self.opt.step(grads, state, params)
        if self.trajectory is None:   # at dp = 1 each leaf's .grad is what Adam took
            t0 = time.perf_counter()
            for p, c in zip(tree_leaves(params), tree_leaves(cpu_grads)):
                want = compressed_reduce_scatter_mean(c, self.opt.axis_name,
                                                      self.opt.grad_comm)[0]
                self.reduced_equal &= torch.equal(p.grad.cpu(), want.to(p.dtype))
            self.cpu_s += time.perf_counter() - t0
        return out


def to_device(tree, device):
    """A copy of a params tree (dicts and lists of tensors) on ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.detach().to(device, copy=True)


def phase30_arm(template, cfg, kind, ids, mask, lr, micro=None, grad_comm="fp32",
                error_feedback=False, steps=PHASE30_STEPS, mirror=None):
    """``steps`` steps of ``make_hybrid_train_step`` on one batch from a copy
    of ``template``: the loss of ``kind`` (``phase30_loss``) with JAX's
    gradient sync for it (("pipe",) for the pipelines, ("seq", "sum") too
    for PP x SP), the sequence over "seq" for the SP arms, ZeRO-1 over
    "data" at ``grad_comm``. Returns (losses, params, launches per kernel
    over the steps, the optimizer, its state)."""
    from pipegoose_tpu_torch.models import bloom
    from pipegoose_tpu_torch.optim import DistributedOptimizer, adam
    from pipegoose_tpu_torch.parallel import make_hybrid_train_step

    params = to_device(template, template["embed"]["weight"].device)
    loss = phase30_loss(kind, micro)
    sync = {"pp": ("pipe",), "1f1b": ("pipe",), "sp": (("seq", "sum"),),
            "pp_sp": (("pipe", "sum"), ("seq", "sum"))}.get(kind, ())
    spec = (None, "seq") if kind in ("sp", "pp_sp") else ("data",)
    specs = bloom.pp_specs(params) if kind in ("pp", "1f1b", "pp_sp") else \
        bloom.tp_specs(params)
    opt = DistributedOptimizer(adam(lr), "data", grad_comm=grad_comm,
                               error_feedback=error_feedback)
    if mirror is not None:   # "reduction" or "trajectory"
        opt = MirroredOptimizer(opt, params, trajectory=mirror == "trajectory")
    init_fn, make_step = make_hybrid_train_step(
        lambda p, b: loss(p, b[0], b[1], cfg), specs, opt, batch_spec=spec,
        grad_sync_axes=sync, overlap_tp=cfg.overlap_tp)
    state = init_fn(params)
    step = make_step(params)
    counters_zero()
    losses = [step(params, state, (ids, mask))[2].item() for _ in range(steps)]
    torch.cuda.synchronize()
    return losses, params, counters_read(), opt, state


def phase30_hold(label, got, ref, tree, lr) -> None:
    """Phase 26's criteria between two runs from the same weights: the first
    loss to TRAIN_LOSS_ATOL, the later ones to TRAIN_ADAM_LOSS_ATOL, every
    param within lr of the reference's and each leaf's distance from it
    within HYBRID_PARAM_REL of the distance the reference moved it, every
    leaf moved by more than lr."""
    from pipegoose_tpu_torch.models.weights import params_to_jax

    (g_loss, g_p), (r_loss, r_p) = got, ref
    g_p, r_p = params_to_jax(g_p), params_to_jax(r_p)
    loss_err = abs(g_loss[0] - r_loss[0])
    adam_err = max(abs(a - b) for a, b in zip(g_loss, r_loss))
    param_err = max(float(np.abs(g - r).max()) for _, g, r in zip_leaves(g_p, r_p))
    start = dict((path, a) for path, a, _ in zip_leaves(tree, tree))
    moved = min(float(np.abs(r - start[path]).max()) for path, r, _ in zip_leaves(r_p, r_p))
    rel = max(float(np.linalg.norm(g - r) / np.linalg.norm(r - start[path]))
              for path, g, r in zip_leaves(g_p, r_p))
    log(f"  {label}: losses {g_loss} vs {r_loss}; first loss err {loss_err}, "
        f"{len(g_loss)}-step err {adam_err}, params max err {param_err} (lr = {lr}), "
        f"per-leaf distance / move {rel} (limit {HYBRID_PARAM_REL}), least move {moved}")
    if (loss_err > TRAIN_LOSS_ATOL or adam_err > TRAIN_ADAM_LOSS_ATOL or param_err > lr
            or rel > HYBRID_PARAM_REL or moved <= lr or not all(np.isfinite(g_loss))):
        raise AssertionError(f"phase 30: {label} disagrees with its reference")


def phase30_pipeline_launches(cfg, kind, micro) -> dict:
    """Each kernel's launches in one pipelined step of ``cfg`` at one stage:
    the blocks' attention kernels n_layer x M times (the forward twice under
    remat: GPipe recomputes the checkpointed stage, 1F1B its checkpointed
    blocks inside the backward slot's recompute), the ring's at sp = 1 for
    PP x SP, the fused CE kernels once per microbatch."""
    per = {k: 0 for k in kernel_counters()}
    attn = "chunk_" if kind == "pp_sp" else ""
    per.update({f"{attn}fwd": (2 if cfg.remat else 1) * cfg.n_layer * micro,
                f"{attn}dq": cfg.n_layer * micro, f"{attn}dkv": cfg.n_layer * micro})
    per.update({k: micro * int(cfg.fused_ce)
                for k in ("fused_ce_fwd", "fused_ce_dh", "fused_ce_dw")})
    return per


def phase30a_float32(np_tree, dev) -> dict:
    """(a) float32, full width at 2 layers, batch 4 x 256 with row 1
    right-padded by 57, flash, 2 steps each on the one-rank context:
    overlap_tp against the monolithic step (full logits and fused CE); the
    bf16, int8 and int8 + error-feedback reductions mirrored on the CPU
    (``MirroredOptimizer``: step 1's int8 payloads and scales bit for bit;
    for bf16 and int8 the reduced gradients of step 1 bit for bit; for
    int8 + error feedback the whole step, the params within one int8 step
    of each chunk's scale and the losses after each step to phase 7's Adam
    tolerance), each differing from the float32 reduction (the rounding ran
    at dp = 1); one step of GPipe
    and 1F1B at M = 2 and 4 and PP x SP at M = 2 (fused CE) against the
    dense and the SP loss on the whole batch (the loss and every gradient,
    phase 7's tolerances), with their launches in the step."""
    from pipegoose_tpu_torch.models.bloom import BloomConfig
    from pipegoose_tpu_torch.models.weights import params_from_jax
    from pipegoose_tpu_torch.nn.parallel import tree_leaves

    n_layer, b, s, pad, lr = 2, 4, 256, 57, 1e-4
    vocab, hidden = np_tree["embed"]["weight"].shape
    tree = {**np_tree, "blocks": cut_layers(np_tree["blocks"], n_layer)}
    rng = np.random.default_rng(SEED + 30)
    ids = torch.from_numpy(rng.integers(0, vocab, (b, s))).to(dev)
    mask = torch.ones((b, s), dtype=torch.int64, device=dev)
    mask[1, s - pad:] = 0
    base = dict(vocab_size=vocab, hidden_size=hidden, n_layer=n_layer, n_head=16,
                use_flash=True)
    out = {"overlap": {}, "grad_comm": {}, "pipeline": {}}
    t0 = time.perf_counter()

    template = params_from_jax(tree, BloomConfig(**base), device=dev)   # fused_ce aside
    for fused in (False, True):
        cfg = BloomConfig(**base, fused_ce=fused)
        ref = phase30_arm(template, cfg, "dense", ids, mask, lr)
        ovl = phase30_arm(template, dataclasses.replace(cfg, overlap_tp=True), "dense",
                          ids, mask, lr)
        label = f"overlap_tp vs monolithic, {'fused CE' if fused else 'full logits'}"
        phase30_hold(label, ovl[:2], ref[:2], tree, lr)
        if ovl[2] != ref[2]:
            raise AssertionError(f"phase 30: {label}: launches {ovl[2]} vs {ref[2]}")
        out["overlap"]["fused_ce" if fused else "full_logits"] = dict(
            losses=ovl[0], ref_losses=ref[0], launches=ovl[2])
        if not fused:
            fp32 = ref
            for mode, ef in (("bf16", False), ("int8", False), ("int8", True)):
                name = mode + ("+ef" if ef else "")
                # the whole step mirrored for int8 + error feedback (it
                # carries every part: quantize, residual, Adam); the
                # reduction alone, on the first step, for bf16 and int8
                losses, params, launches, opt, state = phase30_arm(
                    template, cfg, "dense", ids, mask, lr, grad_comm=mode,
                    error_feedback=ef, mirror="trajectory" if ef else "reduction")
                first = opt.first
                worst = ef_err = loss_err = None
                if ef:
                    # card vs CPU after the steps, each leaf against one int8
                    # step of its gradient (step 1's per-chunk scale; a chunk
                    # is the leaf at dp = 1)
                    worst = max(float((g.detach().cpu() - c).abs().max()) / max(st, 1e-30)
                                for g, c, (_, st) in zip(tree_leaves(params),
                                                         tree_leaves(opt.cpu_params), first))
                    ef_err = max(float((a.cpu() - c).abs().max())
                                 for a, c in zip(state.ef, opt.cpu_state.ef))
                    # the losses after each step: the card's params against
                    # the CPU optimizer's, both evaluated on the card
                    lf = phase30_loss("dense")
                    with torch.no_grad():
                        after = losses[1:] + [lf(params, ids, mask, cfg).item()]
                        cpu_after = [lf(p, ids, mask, cfg).item() for p in opt.trajectory]
                    loss_err = max(abs(x - y) for x, y in zip(after, cpu_after))
                moved = max(float((g.detach() - r.detach()).abs().max()) for g, r in
                            zip(tree_leaves(params), tree_leaves(fp32[1])))
                vs_fp32 = max(abs(x - y) for x, y in zip(losses, fp32[0]))
                bits = all(same for same, _ in first)
                log(f"phase 30: grad_comm {name} at dp = 1 (full logits): step 1's int8 "
                    f"payloads and scales card == CPU on every leaf: "
                    f"{bits if mode == 'int8' else '(int8 only)'}; " + (
                        f"params card vs CPU after {PHASE30_STEPS} steps, largest error "
                        f"over the leaf's int8 step {worst} (<= 1); residuals card vs "
                        f"CPU {ef_err}; losses after each step {after} vs the CPU "
                        f"optimizer's params' {cpu_after} (err {loss_err}, atol "
                        f"{TRAIN_ADAM_LOSS_ATOL})" if ef else
                        f"the reduced gradients card == CPU at the first "
                        f"{PHASE30_MIRROR_STEPS} step(s): {opt.reduced_equal}") +
                    f"; max |params - the float32 reduction's| {moved} (> 0: the "
                    f"reduction rounded), losses {losses} vs float32's {fp32[0]} (max "
                    f"difference {vs_fp32}); launches {launches}; the CPU mirror took "
                    f"{opt.cpu_s:.1f} s")
                if (not bits or not opt.reduced_equal or moved <= 0 or launches != fp32[2]
                        or (ef and (worst > 1 or loss_err > TRAIN_ADAM_LOSS_ATOL
                                    or ef_err > 1e-6
                                    or not any(float(e.abs().max()) > 0 for e in state.ef)))):
                    raise AssertionError(f"phase 30: grad_comm {name} fails its checks")
                log(f"    ({time.perf_counter() - t0:.1f} s into phase 30)")
                out["grad_comm"][name] = dict(losses=losses, fp32_losses=fp32[0],
                                              payloads_equal=bits,
                                              reduced_equal=opt.reduced_equal,
                                              params_err_over_int8_step=worst,
                                              ef_err=ef_err, losses_vs_cpu=loss_err,
                                              update_vs_fp32=moved)
                del params, opt, state
        gc.collect()
        torch.cuda.empty_cache()

    log(f"    ({time.perf_counter() - t0:.1f} s into phase 30)")
    # one step each: the loss and every gradient (the leaves' .grad after the
    # step, the synced gradient the optimizer took) to phase 7's tolerances
    refs = {"dense": phase30_arm(template, cfg, "dense", ids, mask, lr, steps=1),
            "sp": phase30_arm(template, cfg, "sp", ids, mask, lr, steps=1)}
    arms = [(k, m) for k in ("pp", "1f1b") for m in PHASE30_MICRO] + [("pp_sp", 2)]
    for kind, micro in arms:
        got = phase30_arm(template, cfg, kind, ids, mask, lr, micro=micro, steps=1)
        ref = refs["sp" if kind == "pp_sp" else "dense"]
        label = f"{kind} M = {micro} vs {'loss_fn_sp' if kind == 'pp_sp' else 'loss_fn'}"
        loss_err = abs(got[0][0] - ref[0][0])
        grad_err = max(float((g.grad - r.grad).abs().max() / r.grad.abs().max())
                       for g, r in zip(tree_leaves(got[1]), tree_leaves(ref[1])))
        want = phase30_pipeline_launches(cfg, kind, micro)
        log(f"  {label}: loss {got[0][0]} vs {ref[0][0]} (err {loss_err}, atol "
            f"{TRAIN_LOSS_ATOL}), largest gradient error over its leaf's max {grad_err} "
            f"(rtol {TRAIN_GRAD_RTOL}); launches in the step {got[2]}, want {want}")
        if loss_err > TRAIN_LOSS_ATOL or grad_err > TRAIN_GRAD_RTOL or got[2] != want:
            raise AssertionError(f"phase 30: {label} disagrees or bypassed a kernel")
        out["pipeline"][f"{kind}_M{micro}"] = dict(loss=got[0][0], ref_loss=ref[0][0],
                                                   grad_rel_err=grad_err,
                                                   launches_per_step=got[2])
    del template, refs
    log(f"phase 30 (a): every arm held, {time.perf_counter() - t0:.1f} s")
    return out


def phase30b_timed(np_tree, dev, card, hybrid_run) -> dict:
    """(b) bf16 bloom-560m, 24 layers, batch 8 x 1024, remat + flash + fused
    CE, Adam 1e-4, beside phase 26(b)'s hybrid step: the hybrid step with
    int8 + error feedback, GPipe (``loss_fn_pp``) at M = 4 and 1F1B at M = 4.
    Each arm: one warm-up step (its peak memory above what was allocated
    before the arm was built, the ZeRO state's and the residuals' bytes),
    then every arm timed in turns (``PHASE30_ROUNDS`` rounds of the arms
    forward then back, ``PHASE30_TURN_STEPS`` steps a turn between CUDA
    events; every turn's launches checked; each ratio to the hybrid step
    with its range over the turns; the losses falling), and one profiled step
    of GPipe (device busy time, the top kernels; phase 26 profiles the
    hybrid step)."""
    from pipegoose_tpu_torch.models.bloom import BloomConfig
    from pipegoose_tpu_torch.models.weights import params_from_jax
    from pipegoose_tpu_torch.optim import DistributedOptimizer, adam
    from pipegoose_tpu_torch.parallel import make_hybrid_train_step
    from pipegoose_tpu_torch.models import bloom

    cfg = BloomConfig.bloom_560m(dtype=torch.bfloat16, remat=True, use_flash=True,
                                 fused_ce=True)
    b, s, micro = 8, 1024, 4
    t0 = time.perf_counter()
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab_size,
                                                            (b, s))).to(dev)
    template = params_from_jax(np_tree, cfg, device=dev)
    arms_cfg = {"hybrid": ("dense", "fp32", False), "int8+ef": ("dense", "int8", True),
                "gpipe_M4": ("pp", "fp32", False), "1f1b_M4": ("1f1b", "fp32", False)}
    arms, out = {}, {}
    for name, (kind, comm, ef) in arms_cfg.items():
        # this arm's own peak: above what the template and the earlier arms hold
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        params = to_device(template, dev)
        loss = phase30_loss(kind, micro)
        specs = bloom.pp_specs(params) if kind != "dense" else bloom.tp_specs(params)
        opt = DistributedOptimizer(adam(1e-4), "data", grad_comm=comm, error_feedback=ef)
        init_fn, make_step = make_hybrid_train_step(
            lambda p, x, loss=loss: loss(p, x, None, cfg), specs, opt,
            grad_sync_axes=("pipe",) if kind != "dense" else ())
        state = init_fn(params)
        step = make_step(params)

        def run(step=step, params=params, state=state):
            return step(params, state, ids)[2]

        first = run().item()   # the warm-up step
        torch.cuda.synchronize()
        zero_bytes = sum(v.numel() * v.element_size() for st in state.inner.state.values()
                         for v in st.values() if torch.is_tensor(v))
        ef_bytes = sum(e.numel() * e.element_size() for e in (state.ef or []))
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        log(f"phase 30 (b): {name}: peak {peak:.2f} GiB above the {base / 2**30:.2f} GiB "
            f"held before it, ZeRO state {zero_bytes} bytes, residuals {ef_bytes} bytes "
            f"({time.perf_counter() - t0:.1f} s into phase 30 (b))")
        arms[name] = run
        out[name] = dict(losses=[first], peak_gib=peak, zero_state_bytes=zero_bytes,
                         ef_bytes=ef_bytes, launches_per_step=(
                             per_step_launches(cfg) if kind == "dense"
                             else phase30_pipeline_launches(cfg, kind, micro)))
    del template
    # the turns: each turn's launches checked against its steps, its last
    # loss kept (the losses must fall from the warm-up step's)
    order = list(arms)
    times = {k: [] for k in order}
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for name in (order + order[::-1]) * PHASE30_ROUNDS:
        torch.cuda.synchronize()
        counters_zero()
        t0.record()
        for _ in range(PHASE30_TURN_STEPS):
            loss = arms[name]()
        t1.record()
        torch.cuda.synchronize()
        times[name].append(t0.elapsed_time(t1) / PHASE30_TURN_STEPS)
        out[name]["losses"].append(loss.item())
        want = {k: PHASE30_TURN_STEPS * n for k, n in out[name]["launches_per_step"].items()}
        if counters_read() != want:
            raise AssertionError(f"phase 30 (b): {name} launched {counters_read()} in "
                                 f"{PHASE30_TURN_STEPS} steps, want {want}")
    hyb = times["hybrid"]
    for name in order:
        losses = out[name]["losses"]
        log(f"phase 30 (b): {name}: launches per step {out[name]['launches_per_step']} "
            f"(every turn); the warm-up's loss, then each turn's last {losses}")
        if not losses[-1] < losses[0] or not all(np.isfinite(losses)):
            raise AssertionError(f"phase 30 (b): {name}'s losses do not fall")
        ms = float(np.median(times[name]))
        ratio = ms / float(np.median(hyb))
        # the widest ratio the turns allow: unresolved when it spans 1
        lo, hi = min(times[name]) / max(hyb), max(times[name]) / min(hyb)
        resolved = name == "hybrid" or not lo <= 1 <= hi
        out[name].update(step_ms=ms, turns_ms=times[name], tokens_per_s=b * s / (ms / 1e3),
                         ratio_to_hybrid=ratio, ratio_range=[lo, hi], resolved=resolved)
        log(f"phase 30 (b): {name}: {ms} ms/step (median of turns {times[name]}, "
            f"{PHASE30_TURN_STEPS} steps each), {b * s / (ms / 1e3)} tokens/s, beside "
            f"the hybrid step {ratio:.4f}x (range over the turns {lo:.4f}-{hi:.4f}"
            f"{'' if resolved else ': unresolved'}); phase 26(b) ran "
            f"{hybrid_run['step_ms']} ms on {card}")
    # where a pipelined step's time goes (phase 26 profiles the hybrid step)
    wall, busy, _ = profile_device(arms["gpipe_M4"], 1, "phase 30 (b): gpipe_M4, one "
                                   "profiled step", "step", 8, host=False)
    out["gpipe_M4"].update(profiled_wall_ms=wall, device_busy_ms=busy)
    del arms
    return out


def phase30_comm_pipeline(np_tree, dev, card, hybrid_run) -> dict:
    out = {"a": phase30a_float32(np_tree, dev)}
    gc.collect()
    torch.cuda.empty_cache()
    out["b"] = phase30b_timed(np_tree, dev, card, hybrid_run)
    return out


# -- phase 31 ------------------------------------------------------------------

MOE_EXPERTS, MOE_TOP_K, MOE_CF = 8, 2, 1.25
MOE_TIE_MARGIN = 1e-5          # a top-k gap below which card and CPU may route apart
MOE_BATCH_SPEC = (("data", "expert"),)   # examples/moe_training.py's P(("data", "expert"))
BLOOM_PAD_ID = 3               # BLOOM's pad token id


def moe_config(**kw):
    """bloom-560m's widths as BLOOM-MoE: 8 experts, top-2, capacity factor
    1.25, remat and flash."""
    from pipegoose_tpu_torch.models.bloom_moe import BloomMoEConfig

    kw = {"remat": True, "use_flash": True, **kw}
    return BloomMoEConfig.bloom_560m(num_experts=MOE_EXPERTS, top_k=MOE_TOP_K,
                                     capacity_factor=MOE_CF, **kw)


def moe_loss(cfg):
    """The path's loss (``examples/moe_training.py:53-61``): BLOOM-MoE with
    ``tp_axis="tensor"``, ``ep_axis="expert"`` on a batch of ids (or ids and
    a mask; labels = ids); with an rng, ``train=True`` and the seed folded
    with ``data_index x ep + expert_index``, so that every rank draws its
    own router noise."""
    from pipegoose_tpu_torch.core.accumulation import fold_in
    from pipegoose_tpu_torch.distributed.functional import axis_index, axis_size
    from pipegoose_tpu_torch.models import bloom_moe

    def lf(p, batch, *rng):
        ids, mask = batch if isinstance(batch, tuple) else (batch, None)
        seed = None
        if rng:
            seed = fold_in(rng[0], axis_index("data") * axis_size("expert")
                           + axis_index("expert"))
        return bloom_moe.loss_fn(p, ids, mask, ids, cfg, tp_axis="tensor",
                                 ep_axis="expert", rng=seed, train=bool(rng))

    return lf


class RouteRecorder:
    """While active, ``TopKRouter.__call__`` also records each call's tokens
    and dropped tokens (those given fewer than k slots) and, with
    ``detail``, its dispatch on the host and each token's smallest gap
    between neighbouring probabilities of its top k + 1 (from the clean
    logits: phase 31 (a) has no noise). Reading them syncs the host; the
    timed steps run without it. Under remat the recompute routes again:
    the first ``n_layer`` calls are the forward's."""

    def __init__(self, detail=False):
        self.detail, self.calls = detail, []

    def __enter__(self):
        from pipegoose_tpu_torch.nn.expert_parallel.routers import TopKRouter

        self._orig = orig = TopKRouter.__call__
        rec = self

        def call(router, params, x, key=None, train=False, capacity=None):
            out = orig(router, params, x, key=key, train=train, capacity=capacity)
            with torch.no_grad():
                kept = out.dispatch.sum(dim=(1, 2))
                row = {"tokens": x.shape[0],
                       "dropped": int((kept < router.top_k).sum())}
                if rec.detail:
                    probs = torch.softmax(x.float() @ params["gate"]["kernel"].float(), -1)
                    top = torch.sort(probs, dim=-1, descending=True).values
                    top = top[:, :router.top_k + 1]
                    row["gap"] = (top[:, :-1] - top[:, 1:]).min(dim=-1).values.cpu()
                    row["dispatch"] = out.dispatch.detach().cpu()
                rec.calls.append(row)
            return out

        TopKRouter.__call__ = call
        return self

    def __exit__(self, *exc):
        from pipegoose_tpu_torch.nn.expert_parallel.routers import TopKRouter

        TopKRouter.__call__ = self._orig
        return False


def moe_dispatch_agree(label, card_calls, cpu_calls, n_layer) -> list:
    """Each layer's dispatch, card against CPU: equal, or apart only from a
    token whose top-k gap is below MOE_TIE_MARGIN (named in the log)."""
    notes = []
    for layer, (g, c) in enumerate(zip(card_calls[:n_layer], cpu_calls[:n_layer])):
        rows = (g["dispatch"] != c["dispatch"]).flatten(1).any(dim=1)
        if not rows.any():
            notes.append(0)
            continue
        first = int(rows.nonzero()[0])
        ties = (c["gap"][:first + 1] < MOE_TIE_MARGIN).nonzero().flatten().tolist()
        log(f"  {label}: layer {layer} dispatch differs from token {first} on "
            f"({int(rows.sum())} rows apart); tokens at or before it with a top-k gap below "
            f"{MOE_TIE_MARGIN}: {ties} (gaps {[float(c['gap'][t]) for t in ties]})")
        if not ties:
            raise AssertionError(f"phase 31: {label}: layer {layer} routes apart with no "
                                 f"near tie")
        notes.append(int(rows.sum()))
    return notes


def phase31a_moe_float32(np_tree, dev) -> dict:
    """(a) float32 BLOOM-MoE at full width, 2 layers, 8 experts, top-2,
    capacity factor 1.25, no noise, flash + remat, batch 4 x 256 with row 1
    right-padded by 128 pad ids (every pad routes alike and takes capacity,
    so tokens drop), upcycled from the seed-0 weights
    (``ExpertParallel(jitter=0.01).from_dense`` on the CPU): the loss and
    every gradient on the card against the same code on the CPU (phase 7's
    tolerances), each layer's dispatch equal (``moe_dispatch_agree``), the
    dropped tokens per layer (> 0); then 3 steps of
    ``make_hybrid_train_step`` (``moe_specs``, the path's batch spec, loss
    axes and expert-mean sync, ZeRO-1 over "data") against 3 hand-called
    steps of the same loss and Adam, bit for bit, launching B1 2 L, B2 and
    B3 L times a step, all on the float32 route."""
    from pipegoose_tpu_torch.models import bloom_moe
    from pipegoose_tpu_torch.models.bloom import BloomConfig
    from pipegoose_tpu_torch.models.weights import params_from_jax
    from pipegoose_tpu_torch.nn.expert_parallel import ExpertParallel
    from pipegoose_tpu_torch.nn.parallel import tree_leaves
    from pipegoose_tpu_torch.optim import DistributedOptimizer, adam
    from pipegoose_tpu_torch.parallel import make_hybrid_train_step

    n_layer, b, s, pad, lr, steps = 2, 4, 256, 128, 1e-4, 3
    vocab = np_tree["embed"]["weight"].shape[0]
    dense_cfg = dataclasses.replace(BloomConfig.bloom_560m(), n_layer=n_layer)
    cfg = dataclasses.replace(moe_config(router_noise_eps=0.0), n_layer=n_layer)
    t0 = time.perf_counter()
    dense = params_from_jax({**np_tree, "blocks": cut_layers(np_tree["blocks"], n_layer)},
                            dense_cfg, device="cpu")
    cpu_tree = ExpertParallel(num_experts=MOE_EXPERTS, jitter=0.01).from_dense(
        dense, key=SEED + 31)
    del dense
    rng = np.random.default_rng(SEED + 31)
    ids = torch.from_numpy(rng.integers(0, vocab, (b, s)))
    ids[1, s - pad:] = BLOOM_PAD_ID   # a padded row carries the pad id
    mask = torch.ones((b, s), dtype=torch.int64)
    mask[1, s - pad:] = 0
    lf = moe_loss(cfg)
    runs = {}
    for where in ("card", "cpu"):
        d = dev if where == "card" else torch.device("cpu")
        params = to_device(cpu_tree, d)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        with RouteRecorder(detail=True) as rec:
            loss = lf(params, (ids.to(d), mask.to(d)))
            loss.backward()
        runs[where] = (loss.item(), [p.grad.detach().cpu() for p in tree_leaves(params)],
                       rec.calls)
        del params, loss
    (g_loss, g_grads, g_calls), (c_loss, c_grads, c_calls) = runs["card"], runs["cpu"]
    loss_err = abs(g_loss - c_loss)
    grad_err = max(float((g - c).abs().max() / max(float(c.abs().max()), 1e-30))
                   for g, c in zip(g_grads, c_grads))
    apart = moe_dispatch_agree("card vs CPU", g_calls, c_calls, n_layer)
    dropped = [c["dropped"] for c in g_calls[:n_layer]]
    cap = c_calls[0]["dispatch"].shape[2]
    log(f"phase 31 (a): float32 BLOOM-MoE, width {cfg.hidden_size}, vocab {vocab}, {n_layer} layers, "
        f"{MOE_EXPERTS} experts, top-{MOE_TOP_K}, capacity factor {MOE_CF} (C = {cap} of "
        f"{b * s} tokens), batch {b} x {s} (row 1 right-padded by {pad} pad ids), remat + "
        f"flash, "
        f"card vs CPU: loss {g_loss} vs {c_loss} (err {loss_err}, atol {TRAIN_LOSS_ATOL}), "
        f"largest gradient error over its leaf's max {grad_err} (rtol {TRAIN_GRAD_RTOL}); "
        f"dispatch rows apart per layer {apart}; dropped tokens per layer {dropped} of "
        f"{b * s}; the router ran {len(g_calls)} times (forward + remat recompute)")
    if loss_err > TRAIN_LOSS_ATOL or grad_err > TRAIN_GRAD_RTOL or not np.isfinite(g_loss):
        raise AssertionError("phase 31 (a): the card's MoE loss or gradients disagree "
                             "with the CPU's")
    if min(dropped) <= 0:
        raise AssertionError(f"phase 31 (a): capacity factor {MOE_CF} dropped no token "
                             f"in some layer: {dropped}")
    if len(g_calls) != 2 * n_layer:
        raise AssertionError("phase 31 (a): remat did not recompute every block")

    # 3 steps of the hybrid step against 3 hand-called steps, bit for bit
    card_tree = to_device(cpu_tree, dev)
    del cpu_tree
    batch = (ids.to(dev), mask.to(dev))
    params = to_device(card_tree, dev)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    opt = adam(lr)(leaves)
    hand = []
    for _ in range(steps):
        for p in leaves:
            p.grad = None
        loss = lf(params, batch)
        loss.backward()
        opt.step()
        hand.append(loss.item())
    hand_params = params
    del opt
    params = to_device(card_tree, dev)
    init_fn, make_step = make_hybrid_train_step(
        lf, bloom_moe.moe_specs(params), DistributedOptimizer(adam(lr), axis_name="data"),
        batch_spec=MOE_BATCH_SPEC, loss_axis=("data", "expert"),
        grad_sync_axes=(("expert", "mean"),))
    state = init_fn(params)
    step = make_step(params)
    counters_zero()
    hybrid = [step(params, state, batch)[2].item() for _ in range(steps)]
    torch.cuda.synchronize()
    counts = counters_read()
    routes = {k: dict(c.routes) for k, c in kernel_counters().items() if k in ("fwd", "dq", "dkv")}
    want = {k: steps * n for k, n in per_step_launches(cfg).items()}
    same = hybrid == hand and same_tensors(params, hand_params)
    moved = min(float((p.detach() - q).abs().max()) for p, q in
                zip(tree_leaves(params), tree_leaves(card_tree)))
    log(f"  make_hybrid_train_step (moe_specs, batch spec {MOE_BATCH_SPEC}, loss over "
        f"(data, expert), (expert, mean) sync, ZeRO-1 over data) vs hand-called steps, "
        f"{steps} Adam steps lr {lr}: losses {hybrid} vs {hand}, bit for bit: {same}; least "
        f"per-leaf move {moved} (> 0); launches over the steps {counts} (want {want}), by "
        f"route {routes} (all 'fma')")
    if not same or moved <= 0 or not all(np.isfinite(hybrid)):
        raise AssertionError("phase 31 (a): the hybrid MoE step and the hand-called steps "
                             "differ")
    if counts != want or any(r.get("fma", 0) != counts[k] for k, r in routes.items()):
        raise AssertionError("phase 31 (a): the MoE step bypassed a kernel or left the "
                             "float32 route")
    log(f"phase 31 (a): held, {time.perf_counter() - t0:.1f} s")
    return {"loss": g_loss, "cpu_loss": c_loss, "grad_rel_err": grad_err,
            "dispatch_rows_apart": apart, "dropped": dropped, "capacity": cap,
            "hybrid_losses": hybrid, "launches": counts}


def moe_active_params(params, cfg) -> tuple:
    """(all parameters, those a token uses: the trunk, the router and top_k
    of the E experts of each layer)."""
    from pipegoose_tpu_torch.nn.parallel import tree_leaves

    total = sum(p.numel() for p in tree_leaves(params))
    experts = sum(p.numel() for blk in params["blocks"] for p in tree_leaves(blk["moe"]))
    return total, total - experts + experts * cfg.top_k // cfg.num_experts


def phase31b_timed_moe(np_tree, dev, card) -> dict:
    """(b) bf16 BLOOM-MoE at bloom-560m's widths, 24 layers: phase 8's seed-0
    weights upcycled on the card (``ExpertParallel(8, jitter=0.01).from_dense``
    with a seeded card generator), top-2, capacity factor 1.25, router noise
    0.1, flash + remat, Adam 1e-4, through ``Trainer.fit(with_rng=True)`` on
    the path's axes, batch 4 x 1024 ``RandomState(0)`` ids: 2 warm-up and 5
    timed steps between CUDA events (every counter zeroed just before the
    timed steps and read after), step ms, tokens/s, peak, MFU (the dense
    dispatch and combine products apart), falling losses, launches per step
    (B1 48, B2 and B3 24, all on the tensor-core route); then one step with
    the dropped share per layer recorded, and one profiled step."""
    import itertools

    from pipegoose_tpu_torch.models import bloom_moe
    from pipegoose_tpu_torch.models.bloom import BloomConfig
    from pipegoose_tpu_torch.models.weights import params_from_jax
    from pipegoose_tpu_torch.nn.expert_parallel import ExpertParallel
    from pipegoose_tpu_torch.optim import DistributedOptimizer, adam
    from pipegoose_tpu_torch.trainer import Trainer

    warm, timed, b, s = 2, 5, 4, 1024
    cfg = moe_config(dtype=torch.bfloat16, router_noise_eps=0.1)
    t0 = time.perf_counter()
    dense = params_from_jax(np_tree, BloomConfig.bloom_560m(dtype=torch.bfloat16), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    whole = ExpertParallel(num_experts=MOE_EXPERTS, jitter=0.01).from_dense(dense, gen)
    del dense
    torch.cuda.synchronize()
    upcycle_s = time.perf_counter() - t0
    n_total, n_active = moe_active_params(whole, cfg)
    trainer = Trainer(moe_loss(cfg), whole, bloom_moe.moe_specs(whole),
                      DistributedOptimizer(adam(1e-4), axis_name="data"),
                      batch_spec=MOE_BATCH_SPEC, loss_axis=("data", "expert"),
                      grad_sync_axes=(("expert", "mean"),), with_rng=True)
    del whole
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab_size, (b, s))).to(dev)
    batches = itertools.repeat(ids)
    cap = cfg.router().capacity(b * s)
    log(f"phase 31 (b): bf16 BLOOM-MoE, bloom-560m's widths at {cfg.n_layer} layers, upcycled on the "
        f"card in {upcycle_s:.2f} s ({MOE_EXPERTS} experts, jitter 0.01, seeded card "
        f"generator): {n_total} params, {n_active} active a token (top-{MOE_TOP_K}); "
        f"capacity factor {MOE_CF} (C = {cap} of {b * s} tokens), router noise 0.1, "
        f"remat + flash, Adam 1e-4, Trainer.fit(with_rng=True), batch {b} x {s}, "
        f"{warm} warm-up + {timed} timed steps, on {card}")
    trainer.fit(batches, max_steps=warm, rng=SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters_zero()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    trainer.fit(batches, max_steps=warm + timed, rng=SEED)
    e1.record()
    torch.cuda.synchronize()
    counts = counters_read()
    routes = {k: dict(c.routes) for k, c in kernel_counters().items()
              if k in ("fwd", "dq", "dkv")}
    step_ms = e0.elapsed_time(e1) / timed
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    tokens_per_s = b * s / (step_ms / 1e3)
    flops_tok = 6 * n_active + 12 * cfg.n_layer * cfg.hidden_size * s
    # the dispatch and combine products, forward and backward (6 x their
    # multiply-adds, as 6 N counts a weight), left out of MFU's count
    dispatch_tok = 12 * MOE_EXPERTS * cap * cfg.hidden_size * cfg.n_layer
    mfu = tokens_per_s * flops_tok / BF16_FLOPS_PER_S
    mfu_all = tokens_per_s * (flops_tok + dispatch_tok) / BF16_FLOPS_PER_S
    losses = [float(x) for x in trainer.state.losses]
    per = per_step_launches(cfg)
    log(f"  step {step_ms} ms, {tokens_per_s} tokens/s, peak {peak_gib:.2f} GiB; MFU {mfu} "
        f"({flops_tok} flops a token: 6 x active params + 12 L H S, over 989 TFLOP/s bf16; "
        f"the dense dispatch and combine products add {dispatch_tok} flops a token, "
        f"{100 * dispatch_tok / flops_tok:.1f}%, MFU with them {mfu_all}); losses over "
        f"{warm + timed} steps on one batch {losses}")
    log(f"  launches over {timed} steps {counts}, per step want {per}; by route {routes} "
        f"(all 'mma')")
    if counts != {k: timed * n for k, n in per.items()}:
        raise AssertionError("phase 31 (b): the MoE step bypassed a kernel")
    if any(r.get("mma", 0) != counts[k] for k, r in routes.items()):
        raise AssertionError("phase 31 (b): a bf16 attention launch left the tensor cores")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"phase 31 (b): losses not finite and falling: {losses}")
    with RouteRecorder() as rec:
        trainer.fit(batches, max_steps=trainer.state.step + 1, rng=SEED)
    share = [c["dropped"] / c["tokens"] for c in rec.calls[:cfg.n_layer]]
    log(f"  dropped share per layer (one step, noise on): {[round(x, 4) for x in share]} "
        f"(mean {float(np.mean(share)):.4f})")
    _, busy_ms, kernels = profile_device(
        lambda: trainer.fit(batches, max_steps=trainer.state.step + 1, rng=SEED), 1,
        "one profiled MoE train step", "step", top=10)
    out = {"step_ms": step_ms, "tokens_per_s": tokens_per_s, "peak_gib": peak_gib,
           "mfu": mfu, "mfu_with_dispatch": mfu_all, "flops_per_token": flops_tok,
           "dispatch_flops_per_token": dispatch_tok, "params": n_total,
           "active_params": n_active, "capacity": cap, "losses": losses,
           "launches": counts, "dropped_share": share,
           "busy_ms": busy_ms, "upcycle_s": upcycle_s}
    del trainer
    return out


def phase31_moe(np_tree, dev, card) -> dict:
    out = {"a": phase31a_moe_float32(np_tree, dev)}
    gc.collect()
    torch.cuda.empty_cache()
    out["b"] = phase31b_timed_moe(np_tree, dev, card)
    return out


# -- phase 32 ------------------------------------------------------------------

FAMILY_VOCAB_A = 32000          # phase 32 (a)'s vocabulary (Mixtral-8x7B's)
FAMILY_WINDOW_A = 64            # phase 32 (a)'s Mixtral sliding window
FAMILY_WINDOW_ROW = 256         # the windowed kernel rows' window at S = 1024
FAMILY_BF16_LOSS_RTOL = 2.0 ** -7   # bf16 step-1 loss vs float32 of the same weights


def family_configs_a():
    """Phase 32 (a)'s float32 configurations: head_dim 128 with GQA g = 4
    (4 query heads over 1 KV head) at width 512, FFN 1536, 2 layers,
    vocabulary 32000, flash and fused CE: Llama untied and tied (theta
    5e5), Mixtral (8 experts, top-2, no-drop capacity, aux 0.02, z 0.001)
    with a sliding window of 64."""
    from pipegoose_tpu_torch.models import llama, mixtral

    base = dict(vocab_size=FAMILY_VOCAB_A, hidden_size=512, intermediate_size=1536,
                n_layer=2, n_head=4, n_kv_head=1, use_flash=True, fused_ce=True)
    return {
        "llama untied": (llama, llama.LlamaConfig(**base, rope_theta=5e5)),
        "llama tied": (llama, llama.LlamaConfig(**base, rope_theta=5e5,
                                                tie_word_embeddings=True)),
        "mixtral window 64": (mixtral, mixtral.MixtralConfig(
            **base, num_experts=8, top_k=2, aux_loss_weight=0.02, z_loss_weight=0.001,
            sliding_window=FAMILY_WINDOW_A)),
    }


def family_loss(module, cfg, kind="dense", micro=2):
    """The path's loss of a RoPE family on a batch (ids, mask; labels = ids)
    with ``tp_axis="tensor"`` (and ``ep_axis="expert"`` for Mixtral):
    ``loss_fn``, ``loss_fn_sp`` over "seq", or the pipeline losses over
    "pipe" with ``micro`` microbatches."""
    moe = hasattr(cfg, "num_experts")
    kw = {"tp_axis": "tensor", **({"ep_axis": "expert", "train": False} if moe else {})}

    def lf(p, batch):
        ids, mask = batch
        if kind == "sp":
            return module.loss_fn_sp(p, ids, mask, ids, cfg, sp_axis="seq", **kw)
        if kind in ("gpipe", "1f1b"):
            fn = module.loss_fn_pp if kind == "gpipe" else module.loss_fn_1f1b
            return fn(p, ids, mask, ids, cfg, micro, **kw)
        return module.loss_fn(p, ids, mask, ids, cfg, **kw)

    return lf


def family_grads(params, lf, batch):
    """(loss, every leaf's gradient on the host) of ``lf`` at ``params``."""
    from pipegoose_tpu_torch.nn.parallel import tree_leaves

    leaves = tree_leaves(params)
    for p in leaves:
        p.grad = None
        p.requires_grad_(True)
    loss = lf(params, batch)
    loss.backward()
    out = loss.item(), [p.grad.detach().cpu() if p.grad is not None else torch.zeros(p.shape)
                        for p in leaves]
    for p in leaves:
        p.grad = None
    return out


def grads_apart(a, b, names=None):
    """The largest gradient error over its leaf's largest value (with
    ``names``, also the name of the leaf where it is)."""
    errs = [float((x - y).abs().max() / max(float(y.abs().max()), 1e-30))
            for x, y in zip(a, b)]
    worst = int(np.argmax(errs))
    return (errs[worst], names[worst]) if names is not None else errs[worst]


def leaf_names(params) -> list:
    from pipegoose_tpu_torch.nn.parallel import path_str, tree_leaves, tree_map_with_path

    return tree_leaves(tree_map_with_path(lambda p, _: path_str(p), params))


def family_counts() -> dict:
    """Every training kernel's launches and routes since ``counters_zero``."""
    return {k: (c.launches, {r: n for r, n in getattr(c, "routes", {}).items() if n})
            for k, c in kernel_counters().items() if c.launches}


def phase32a_float32(dev) -> dict:
    """(a) float32, card against CPU, at phase 7's tolerances: for each of
    ``family_configs_a`` the loss and every gradient through flash (B1-B3
    at head_dim 128, g = 4, Mixtral's with its window) and fused CE (B4-B6,
    "hv" untied, "vh" tied); Llama's ``loss_fn_sp`` at sp = 1 (the chunk
    kernels B7-B9) against its ``loss_fn`` on the card; Mixtral's
    ``loss_fn_1f1b`` with aux at pp = 1, M = 2 against ``loss_fn_pp`` (its
    gradients) and against ``loss_fn`` with the microbatch means of the
    routers' losses (its value); greedy ``generate`` tokens card vs CPU. Each
    run's launches are counted by kernel and route (all float32 routes)."""
    from pipegoose_tpu_torch.models.weights import params_from_jax

    # 48 pads under a window of 64: every padded query still sees a valid
    # key (a query that sees none gets each route's own finite garbage,
    # which the routers' z and aux losses, means over every token, carry)
    b, s, pad = 2, 256, 48
    t0 = time.perf_counter()
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for window in (None, FAMILY_WINDOW_A):
            case = flash_case(dev, dtype, b=b, s=s, nh=4, nkv=1, hd=128, pad=pad,
                              seed=SEED + 32)
            case["slopes"] = torch.zeros_like(case["slopes"])   # RoPE: no ALiBi
            check_flash(f"{name} B={b} nh=4/nkv=1 (g 4) S={s} hd=128 right-padded by {pad}, "
                        f"window {window}", case, window=window, phase="phase 32 (a)")
    rng = np.random.default_rng(SEED + 32)
    ids = torch.from_numpy(rng.integers(0, FAMILY_VOCAB_A, (b, s)))
    mask = torch.ones((b, s), dtype=torch.int64)
    mask[1, s - pad:] = 0
    out, launches = {}, {}
    for name, (module, cfg) in family_configs_a().items():
        tree = module.init_params_numpy(cfg, seed=SEED + 32)
        runs, calls = {}, {}
        moe = "mixtral" in name
        for where in ("card", "cpu"):
            d = dev if where == "card" else torch.device("cpu")
            params = params_from_jax(tree, cfg, device=d)
            counters_zero()
            with RouteRecorder(detail=True) as rec:
                runs[where] = family_grads(params, family_loss(module, cfg),
                                           (ids.to(d), mask.to(d)))
            calls[where] = rec.calls
            if where == "card":
                torch.cuda.synchronize()
                launches[name] = family_counts()
                card_params = params
        (g_loss, g_grads), (c_loss, c_grads) = runs["card"], runs["cpu"]
        err, worst = grads_apart(g_grads, c_grads, leaf_names(card_params))
        if moe:
            apart = moe_dispatch_agree(name, calls["card"], calls["cpu"], cfg.n_layer)
            log(f"  {name}: dispatch rows apart per layer, card vs CPU: {apart}")
        want = {"fwd": cfg.n_layer, "dq": cfg.n_layer, "dkv": cfg.n_layer,
                "fused_ce_fwd": 1, "fused_ce_dh": 1, "fused_ce_dw": 1}
        got = {k: n for k, (n, _) in launches[name].items()}
        routes_ok = all(r == {"fma": n} if k in ("fwd", "dq", "dkv") else r == {"wmma": n}
                        for k, (n, r) in launches[name].items())
        log(f"phase 32 (a): float32 {name} (H {cfg.hidden_size}, {cfg.n_head}/"
            f"{cfg.n_kv_head} heads, head_dim {cfg.head_dim}, vocab {cfg.vocab_size}, "
            f"{cfg.n_layer} layers, flash + fused CE), batch {b} x {s} (row 1 right-padded "
            f"by {pad}), card vs CPU: loss {g_loss} vs {c_loss} (err {abs(g_loss - c_loss)}, "
            f"atol {TRAIN_LOSS_ATOL}), largest gradient error over its leaf's max {err} "
            f"({worst}; rtol {TRAIN_GRAD_RTOL}); launches {launches[name]}")
        if (abs(g_loss - c_loss) > TRAIN_LOSS_ATOL or err > TRAIN_GRAD_RTOL
                or not np.isfinite(g_loss)):
            raise AssertionError(f"phase 32 (a): {name}: card and CPU disagree")
        if got != want or not routes_ok:
            raise AssertionError(f"phase 32 (a): {name}: launches {launches[name]}, want "
                                 f"{want} on the float32 routes")
        out[name] = {"loss": g_loss, "cpu_loss": c_loss, "grad_rel_err": err}
        batch = (ids.to(dev), mask.to(dev))
        if name == "llama untied":   # the ring at sp = 1 against loss_fn
            counters_zero()
            sp_loss, sp_grads = family_grads(card_params, family_loss(module, cfg, "sp"), batch)
            torch.cuda.synchronize()
            launches["llama untied sp"] = family_counts()
            sp_err = grads_apart(sp_grads, g_grads)
            log(f"  loss_fn_sp at sp = 1 (ring through B7-B9) vs loss_fn: loss {sp_loss} vs "
                f"{g_loss}, gradient error {sp_err}; launches {launches['llama untied sp']}")
            want_sp = {"chunk_fwd": cfg.n_layer, "chunk_dq": cfg.n_layer,
                       "chunk_dkv": cfg.n_layer, "fused_ce_fwd": 1, "fused_ce_dh": 1,
                       "fused_ce_dw": 1}
            if (abs(sp_loss - g_loss) > TRAIN_LOSS_ATOL or sp_err > TRAIN_GRAD_RTOL
                    or {k: n for k, (n, _) in launches["llama untied sp"].items()} != want_sp):
                raise AssertionError("phase 32 (a): loss_fn_sp at sp = 1 parts from loss_fn")
            out[name]["sp"] = {"loss": sp_loss, "grad_rel_err": sp_err}
        if moe:   # 1F1B with aux at pp = 1, M = 2
            counters_zero()
            f_loss, f_grads = family_grads(card_params, family_loss(module, cfg, "1f1b"), batch)
            torch.cuda.synchronize()
            launches["mixtral 1f1b"] = family_counts()
            p_loss, p_grads = family_grads(card_params, family_loss(module, cfg, "gpipe"), batch)
            f_err = grads_apart(f_grads, p_grads)
            with torch.no_grad():   # loss_fn with the routers' losses averaged per microbatch
                aux = z = 0.0
                for i in range(2):
                    _, a, zl = module.forward_hidden(card_params, batch[0][i:i + 1],
                                                     batch[1][i:i + 1], cfg)
                    aux, z = aux + a.mean().item() / 2, z + zl.mean().item() / 2
                _, a, zl = module.forward_hidden(card_params, *batch, cfg)
                want_loss = (g_loss + cfg.aux_loss_weight * (aux - a.mean().item())
                             + cfg.z_loss_weight * (z - zl.mean().item()))
            log(f"  loss_fn_1f1b (with_aux) at pp = 1, M = 2: loss {f_loss} vs loss_fn with "
                f"microbatch router means {want_loss} (GPipe {p_loss}); gradient error vs "
                f"GPipe {f_err}; launches {launches['mixtral 1f1b']}")
            if (abs(f_loss - want_loss) > TRAIN_LOSS_ATOL or abs(f_loss - p_loss) > TRAIN_LOSS_ATOL
                    or f_err > TRAIN_GRAD_RTOL):
                raise AssertionError("phase 32 (a): Mixtral 1F1B with aux parts from loss_fn")
            out[name]["1f1b"] = {"loss": f_loss, "want": want_loss, "grad_rel_err": f_err}
        if name != "llama tied":   # greedy tokens, card vs CPU
            cpu_params = params_from_jax(tree, cfg, device="cpu")
            prompt = ids[:, :16]
            with torch.no_grad():
                got_t = module.generate(card_params, prompt, cfg, 8, device="cuda").cpu()
                want_t = module.generate(cpu_params, prompt, cfg, 8, device="cpu")
            log(f"  greedy generate, 2 x 16 prompt + 8 tokens: card {got_t[:, 16:].tolist()} "
                f"vs CPU {want_t[:, 16:].tolist()}")
            if not torch.equal(got_t, want_t):
                raise AssertionError(f"phase 32 (a): {name}: greedy tokens differ")
            del cpu_params
        del card_params, runs, tree
        gc.collect()
        torch.cuda.empty_cache()
    log(f"phase 32 (a): held, {time.perf_counter() - t0:.1f} s")
    return {"runs": out, "launches": {k: {n: c for n, (c, _) in v.items()}
                                      for k, v in launches.items()}}


def family_timed(label, module, cfg, params, lf, batch, warm, timed, rng, card,
                 active) -> dict:
    """``Trainer.fit`` over the hybrid step on the path's axes (all of size
    1), ZeRO-1 Adam 1e-4 over "data": ``warm`` warm-up and ``timed`` steps
    between CUDA events, every counter zeroed before the timed steps and read
    after. Returns step ms, tokens/s, MFU, peak, launches per step, the
    losses and the trainer."""
    import itertools

    from pipegoose_tpu_torch.optim import DistributedOptimizer, adam
    from pipegoose_tpu_torch.trainer import Trainer

    trainer = Trainer(lf, params, module.specs(params),
                      DistributedOptimizer(adam(1e-4), axis_name="data"),
                      with_rng=rng is not None)
    batches = itertools.repeat(batch)
    kw = {} if rng is None else {"rng": rng}
    trainer.fit(batches, max_steps=warm, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters_zero()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    trainer.fit(batches, max_steps=warm + timed, **kw)
    e1.record()
    torch.cuda.synchronize()
    counts = family_counts()
    b, s = batch.shape
    step_ms = e0.elapsed_time(e1) / timed
    tokens_per_s = b * s / (step_ms / 1e3)
    flops_tok = 6 * active + 12 * cfg.n_layer * cfg.hidden_size * s
    mfu = tokens_per_s * flops_tok / BF16_FLOPS_PER_S
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(x) for x in trainer.state.losses]
    per_step = {k: n / timed for k, (n, _) in counts.items()}
    want = {"fwd": 2 * cfg.n_layer, "dq": cfg.n_layer, "dkv": cfg.n_layer,
            "fused_ce_fwd": 1, "fused_ce_dh": 1, "fused_ce_dw": 1}
    routes_ok = all(r == {"wgmma" if k == "fused_ce_fwd" else "mma": n}
                    for k, (n, r) in counts.items())
    log(f"  {label}: step {step_ms} ms, {tokens_per_s} tokens/s, MFU {mfu} ({flops_tok} "
        f"flops a token: 6 x {active} active params + 12 L H S, over 989 TFLOP/s bf16), "
        f"peak {peak_gib:.2f} GiB; losses over {warm + timed} steps on one batch {losses}; "
        f"launches over {timed} steps {counts} (per step want {want}, bf16 routes: "
        f"flash 'mma', fused CE forward 'wgmma', dh/dw 'mma'), on {card}")
    if per_step != want or not routes_ok:
        raise AssertionError(f"phase 32 (b): {label}: a kernel was bypassed or left its "
                             f"tensor-core route")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"phase 32 (b): {label}: losses not finite: {losses}")
    return {"step_ms": step_ms, "tokens_per_s": tokens_per_s, "mfu": mfu,
            "flops_per_token": flops_tok, "active_params": active, "peak_gib": peak_gib,
            "losses": losses, "launches": {k: n for k, (n, _) in counts.items()},
            "launches_per_step": per_step, "trainer": trainer}


def phase32b_timed(dev, card) -> dict:
    """(b) bf16 at the published widths, Trainer.fit over the hybrid step:
    Llama-3-8B cut to 4 layers (batch 4 x 1024, flash, fused CE on the
    untied "hv" head, remat), its step-1 loss held within 2^-7 of a float32
    loss of the same weights on the card; Mixtral-8x7B cut to 2 layers
    (batch 2 x 1024, capacity factor 1.25, router jitter 0.01 under
    ``fit(with_rng=True)``); then a short bf16 greedy ``generate`` at the
    Llama widths (its attention is plain einsum over the cache, no kernel)."""
    from pipegoose_tpu_torch.models import llama, mixtral
    from pipegoose_tpu_torch.nn.parallel import tree_leaves

    t0 = time.perf_counter()
    out = {}
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(
        dtype=torch.bfloat16, remat=True, use_flash=True, fused_ce=True), n_layer=4)
    params = llama.init_params(cfg, SEED + 32, device=dev)
    n = sum(p.numel() for p in tree_leaves(params))
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab_size, (4, 1024))).to(dev)
    lf32 = family_loss(llama, dataclasses.replace(cfg, dtype=torch.float32))
    with torch.no_grad():
        f32 = lf32(to_f32(params), (ids, None)).item()
    log(f"phase 32 (b): bf16 Llama-3-8B widths at {cfg.n_layer} layers ({n} params; H "
        f"{cfg.hidden_size}, FFN {cfg.intermediate_size}, {cfg.n_head}/{cfg.n_kv_head} heads, "
        f"vocab {cfg.vocab_size}, theta {cfg.rope_theta}), weights from a seeded card "
        f"generator, remat + flash + fused CE (untied hv), Adam 1e-4, batch 4 x 1024; "
        f"float32 loss of the same weights {f32}")
    lf = family_loss(llama, cfg)
    run = family_timed("llama", llama, cfg, params, lambda p, batch: lf(p, (batch, None)),
                       ids, 2, 3, None, card, n)
    del params
    trainer = run.pop("trainer")
    rel = abs(run["losses"][0] - f32) / abs(f32)
    log(f"  step-1 bf16 loss {run['losses'][0]} vs float32 {f32}: relative {rel} "
        f"(tol {FAMILY_BF16_LOSS_RTOL})")
    if rel > FAMILY_BF16_LOSS_RTOL:
        raise AssertionError("phase 32 (b): the bf16 Llama loss parts from float32")
    run["f32_loss"], run["bf16_rel"] = f32, rel
    prompt, new = ids[:2, :32], 32
    with torch.no_grad():
        llama.generate(trainer.params, prompt, cfg, 2, device="cuda")   # warm-up
        torch.cuda.synchronize()
        g0 = time.perf_counter()
        toks = llama.generate(trainer.params, prompt, cfg, new, device="cuda")
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - g0
    run["generate_tokens_per_s"] = prompt.shape[0] * new / gen_s
    log(f"  bf16 greedy generate at these widths, 2 x 32 prompt + {new} tokens: "
        f"{run['generate_tokens_per_s']} tokens/s on the host clock (attention is plain "
        f"einsum over the nkv-wide cache: no kernel); tokens finite ints "
        f"{bool((toks >= 0).all())}")
    out["llama"] = run
    del trainer, toks
    gc.collect()
    torch.cuda.empty_cache()

    mcfg = dataclasses.replace(mixtral.MixtralConfig.mixtral_8x7b(
        dtype=torch.bfloat16, remat=True, use_flash=True, fused_ce=True,
        capacity_factor=1.25, router_jitter=0.01), n_layer=2)
    params = mixtral.init_params(mcfg, SEED + 33, device=dev)
    total = sum(p.numel() for p in tree_leaves(params))
    experts = sum(p.numel() for blk in params["blocks"] for p in tree_leaves(blk["moe"]))
    active = total - experts + experts * mcfg.top_k // mcfg.num_experts
    ids = torch.from_numpy(np.random.RandomState(1).randint(0, mcfg.vocab_size, (2, 1024))).to(dev)
    log(f"phase 32 (b): bf16 Mixtral-8x7B widths at {mcfg.n_layer} layers ({total} params, "
        f"{active} active a token; {mcfg.num_experts} experts, top-{mcfg.top_k}, capacity "
        f"factor {mcfg.capacity_factor} (C = {mcfg.router().capacity(2 * 1024)} of 2048 "
        f"tokens), jitter {mcfg.router_jitter}), remat + flash + fused CE (hv), Adam 1e-4, "
        f"Trainer.fit(with_rng=True), batch 2 x 1024")

    def mlf(p, batch, rng):
        return mixtral.loss_fn(p, batch, None, batch, mcfg, tp_axis="tensor",
                               ep_axis="expert", rng=rng, train=True)

    run = family_timed("mixtral", mixtral, mcfg, params, mlf, ids, 2, 3, SEED, card, active)
    del params, run["trainer"]
    out["mixtral"] = run
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 32 (b): done, {time.perf_counter() - t0:.1f} s")
    return out


def to_f32(params):
    """A float32 copy of a params tree (dicts and lists of tensors)."""
    if isinstance(params, dict):
        return {k: to_f32(v) for k, v in params.items()}
    if isinstance(params, list):
        return [to_f32(v) for v in params]
    return params.detach().float()


def window_pairs(s, window):
    """Visible (q, k) pairs of one causal sequence of ``s`` under a window."""
    return sum(min(q + 1, window) for q in range(s))


def sdpa_gqa_ms(case, b, nh, nkv, s, hd, window=None):
    """The GQA flash rows' library yardstick: SDPA with ``enable_gqa`` on
    the case's bf16 q (B, nh, S, hd) and k, v (B, nkv, S, hd), causal (a
    boolean mask with the window). (forward device ms, backward ms: dq, dk,
    dv in one eager autograd call)."""
    dev = case["q"].device
    q = case["q"].reshape(b, nh, s, hd).detach().clone().requires_grad_()
    k = case["k"].reshape(b, nkv, s, hd).detach().clone().requires_grad_()
    v = case["v"].reshape(b, nkv, s, hd).detach().clone().requires_grad_()
    kw = {"is_causal": True}
    if window is not None:
        i = torch.arange(s, device=dev)
        keep = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
        kw = {"attn_mask": keep}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    so = sdpa(q, k, v, enable_gqa=True, **kw)
    go = case["do"].reshape(b, nh, s, hd)
    with torch.no_grad():
        fwd_ms, _ = time_ms(lambda i: sdpa(q, k, v, enable_gqa=True, **kw), 4)
    bwd_ms = time_eager_ms(lambda: torch.autograd.grad(so, (q, k, v), go, retain_graph=True), 4)
    return fwd_ms, bwd_ms


def family_flash_rows(dev, card, launches) -> list:
    """B1-B3 at phase 32 (b)'s Llama shape (B 4, 32 query heads over 8 KV
    heads, S 1024, head_dim 128, bf16, causal) without and with a window of
    256: each against its plain version (phase 6's tolerances, counters and
    routes), its device ms, bound (visible pairs), plain ms and SDPA's
    (``enable_gqa``). ``launches``: {"plain": phase 32 (b)'s Llama counts,
    "window": phase 32 (a)'s windowed Mixtral counts}."""
    from pipegoose_tpu_torch.ops import flash_attention as fa

    b, nh, nkv, s, hd = 4, 32, 8, 1024, 128
    rows = []
    for window in (None, FAMILY_WINDOW_ROW):
        case = flash_case(dev, torch.bfloat16, b=b, s=s, nh=nh, nkv=nkv, hd=hd,
                          seed=SEED + 32)
        case["slopes"] = torch.zeros_like(case["slopes"])   # RoPE: no ALiBi
        tag = f"window {window}" if window else "no window"
        errs = check_flash(f"bf16 B={b} nh={nh}/nkv={nkv} (g 4) S={s} hd={hd} causal, {tag}",
                           case, window=window, phase="phase 32")
        fwd, mode = flash_args(case, True, window)
        out, lse = fa.flash_fwd(*fwd, *mode)
        delta = (case["do"].float() * out.float()).sum(-1)
        bwd = flash_bwd_args(case, lse, delta)
        dq = fa.flash_dq(*bwd, *mode)
        dk, dv = fa.flash_dkv(*bwd, *mode)
        io = {"fwd": fwd + (out, lse), "dq": bwd + (dq,), "dkv": bwd + (dk, dv)}
        calls = {"fwd": (lambda i: fa.flash_fwd(*fwd, *mode),
                         lambda: fa.flash_fwd_reference(*fwd, *mode)),
                 "dq": (lambda i: fa.flash_dq(*bwd, *mode),
                        lambda: fa.flash_dq_reference(*bwd, *mode)),
                 "dkv": (lambda i: fa.flash_dkv(*bwd, *mode),
                         lambda: fa.flash_dkv_reference(*bwd, *mode))}
        lib_fwd, lib_bwd = sdpa_gqa_ms(case, b, nh, nkv, s, hd, window)
        pairs = b * nh * (window_pairs(s, window) if window else s * (s + 1) // 2)
        src = launches["window" if window else "plain"]
        log(f"phase 32: flash kernels at B*nh={b * nh}, g 4, S={s}, hd={hd}, bf16, causal, "
            f"{tag}, device ms per call, on {card}")
        for kind in ("fwd", "dq", "dkv"):
            kernel, plain = calls[kind]
            ms, call_ms = time_ms(kernel, 8)
            plain_ms = time_eager_ms(plain, 2)
            flops = {"fwd": 4, "dq": 6, "dkv": 8}[kind] * hd * pairs
            nbytes = sum(t.numel() * t.element_size() for t in io[kind])
            t_ops, t_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
            bound_ms = max(t_ops, t_bytes) * 1e3
            bound_by = "operations" if t_ops >= t_bytes else "bytes"
            library_ms = lib_fwd if kind == "fwd" else lib_bwd
            log(f"  flash_{kind}: kernel {ms} (eager {call_ms}), bound {bound_ms} ({bound_by}), "
                f"plain {plain_ms}, SDPA (enable_gqa) {library_ms}; {src.get(kind, 0)} launches "
                f"in phase 32's {'windowed (a)' if window else '(b) Llama'} run")
            rows.append({
                "name": f"flash_{kind} (bf16, B*nh={b * nh}, nkv 8 (g 4), S={s}, hd={hd}, "
                        f"causal, {tag}, mma route)",
                "source": FLASH_SOURCE, "replaces": FLASH_REPLACES[kind], "route": "cuda",
                "kernel_route": "mma", "launches": src.get(kind, 0),
                "launches_from": "phase 32 (a) Mixtral window 64, float32" if window
                else "phase 32 (b) Llama timed steps",
                "max_abs_err": errs[kind], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
                "call_ms": call_ms, "family": True})
        del case, io, calls
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def family_fused_rows(dev, card, launches) -> list:
    """B4-B6 on the untied "hv" head at phase 32 (b)'s Llama shape (T = 4 x
    1023 shifted tokens, H 4096, V 128256, bf16): each against its plain
    version (phase 10's check: counters, the forward on "wgmma", the
    backward on "mma" with its cluster plan), its device ms, bound, plain ms
    and the full-logits composite's (cuBLAS logits + logsumexp)."""
    from pipegoose_tpu_torch.ops import fused_ce as fce

    t, hd, v = 4 * 1023, 4096, 128256
    case = fused_case(dev, torch.bfloat16, t=t, hd=hd, v=v, vh=False, seed=SEED + 32)
    errs = check_fused(f"bf16 T={t} H={hd} V={v} hv", case, phase="phase 32")
    h, w, targets, g = case["h"], case["w"], case["targets"], case["g"]
    lse, tl = fce.fused_ce_fwd(h, w, targets, 0, None, False)
    bwd = (h, w, targets, lse, g, 0, None, False)
    dh = fce.fused_ce_dh(*bwd)
    dw = fce.fused_ce_dw(*bwd)
    io = {"fwd": (h, w, targets, lse, tl), "dh": bwd[:5] + (dh,), "dw": bwd[:5] + (dw,)}
    calls = {"fwd": (lambda i: fce.fused_ce_fwd(h, w, targets, 0, None, False),
                     lambda: fce.fused_ce_fwd_reference(h, w, targets, 0, None, False)),
             "dh": (lambda i: fce.fused_ce_dh(*bwd), lambda: fce.fused_ce_dh_reference(*bwd)),
             "dw": (lambda i: fce.fused_ce_dw(*bwd), lambda: fce.fused_ce_dw_reference(*bwd))}
    library = fused_library(h, w, targets, g, False)
    fplan = fce.card_fwd_plan(h, w, False)
    log(f"phase 32: fused CE kernels at T={t}, H={hd}, V={v}, bf16, hv (forward plan "
        f"{fplan['route']}, BN {fplan['bn']}, {fplan['splits']} splits; dh plan "
        f"{fce.card_plan(h, w, 'dh', False)}; dw plan {fce.card_plan(h, w, 'dw', False)}), "
        f"device ms per call, on {card}")
    if fplan["route"] != "wgmma":
        raise AssertionError(f"phase 32: the hv forward planned {fplan['route']}")
    rows = []
    for kind in ("fwd", "dh", "dw"):
        kernel, plain = calls[kind]
        ms, call_ms = time_ms(kernel, 2, replays=5)
        plain_ms = time_eager_ms(plain, 1)
        library_ms = time_eager_ms(library[kind], 2)
        bound_ms, bound_by = fused_bound_ms(kind, case, io[kind])
        name = f"fused_ce_{kind}"
        log(f"  {name}: kernel {ms} (eager {call_ms}), bound {bound_ms} ({bound_by}), plain "
            f"{plain_ms}, full-logits composite {library_ms}; {launches.get(name, 0)} hv "
            f"launches in phase 32 (b)'s Llama timed steps")
        rows.append({
            "name": f"{name} (bf16, T={t}, H={hd}, V={v}, hv)", "route": "cuda",
            "source": FUSED_FWD_SOURCE if kind == "fwd" else FUSED_MMA_SOURCE,
            "replaces": FUSED_REPLACES[kind],
            "kernel_route": fplan["route"] if kind == "fwd" else "mma",
            "launches": launches.get(name, 0),
            "launches_from": "phase 32 (b) Llama timed steps",
            "max_abs_err": errs[kind], "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms, "call_ms": call_ms,
            "family": True})
        gc.collect()
        torch.cuda.empty_cache()
    del case, calls, library, io
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def phase32_families(dev, card) -> tuple:
    """Phase 32: the Llama and Mixtral families. Returns (its summary, its
    kernel rows)."""
    out = {"a": phase32a_float32(dev)}
    gc.collect()
    torch.cuda.empty_cache()
    out["b"] = phase32b_timed(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    window = out["a"]["launches"]["mixtral window 64"]
    rows = family_flash_rows(dev, card, {"plain": out["b"]["llama"]["launches"],
                                          "window": window})
    rows += family_fused_rows(dev, card, out["b"]["llama"]["launches"])
    return out, rows


# -- phase 33 ------------------------------------------------------------------

ALBERT_MASK_ID = 4              # albert-base-v2's [MASK] id (its tokenizer's)
ALBERT_MLM_RATE = 0.15          # the share of valid positions an MLM batch scores
ALBERT_PAD_A = 64               # phase 33 (a)'s pad ids (id 0) ending row 1
ALBERT_ZERO_GRAD = 1e-4         # of the tree's largest gradient: a smaller leaf is held absolutely
DILOCO_SYNC_EVERY = 4           # phase 33 (b)'s inner steps a DiLoCo round
DILOCO_SYNC_RTOL = 1e-6         # the W = 1 outer step against a hand-computed Nesterov update


def albert_batch(cfg, b, s, pad=0, seed=SEED):
    """An MLM batch from ``RandomState(seed)``: ids drawn above the special
    ids, ``pad`` pad ids (0) ending the last row, ``ALBERT_MLM_RATE`` of the
    valid positions scored (their input id replaced by [MASK], their label
    the drawn id). numpy arrays: ids, mask, labels, lmask."""
    rng = np.random.RandomState(seed)
    orig = rng.randint(5, cfg.vocab_size, (b, s))
    mask = np.ones((b, s), np.int64)
    if pad:
        mask[-1, s - pad:] = 0
        orig[-1, s - pad:] = 0
    lmask = ((rng.rand(b, s) < ALBERT_MLM_RATE) & (mask > 0)).astype(np.int64)
    return {"ids": np.where(lmask > 0, ALBERT_MASK_ID, orig), "mask": mask,
            "labels": orig, "lmask": lmask}


def on_device(batch, dev):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in batch.items()}


def albert_loss(cfg, kind="dense", micro=2):
    """ALBERT's MLM loss of one path on a batch dict, ``tp_axis="tensor"``:
    ``loss_fn``, ``loss_fn_sp`` over "seq" ("ring", "ulysses"), or the
    pipeline losses over "pipe" ("gpipe", "1f1b") with ``micro``
    microbatches."""
    from pipegoose_tpu_torch.models import albert

    def lf(p, batch):
        args = (p, batch["ids"], batch["mask"], batch["labels"], cfg)
        kw = {"tp_axis": "tensor", "label_mask": batch["lmask"]}
        if kind in ("ring", "ulysses"):
            return albert.loss_fn_sp(*args, sp_axis="seq", variant=kind, **kw)
        if kind in ("gpipe", "1f1b"):
            fn = albert.loss_fn_pp if kind == "gpipe" else albert.loss_fn_1f1b
            return fn(*args, micro, **kw)
        return albert.loss_fn(*args, **kw)

    return lf


def albert_grads_apart(a, b, names):
    """The largest gradient error over its leaf's largest value, a leaf
    below ``ALBERT_ZERO_GRAD`` of the tree's largest gradient held against
    that floor instead (the key bias: softmax over keys cancels its
    gradient, zero in exact arithmetic, rounding alone is left); with the
    leaf's name."""
    floor = ALBERT_ZERO_GRAD * max(float(y.abs().max()) for y in b)
    errs = [float((x - y).abs().max()) / max(float(y.abs().max()), floor, 1e-30)
            for x, y in zip(a, b)]
    worst = int(np.argmax(errs))
    return errs[worst], names[worst]


def albert_launch_check(label, got, want, route):
    """The flash kernels' launches since ``counters_zero`` against ``want``
    (every other training kernel 0), all on ``route``."""
    counts = {k: n for k, (n, _) in got.items()}
    routes_ok = all(r == {route: n} for k, (n, r) in got.items())
    if counts != {k: n for k, n in want.items() if n} or not routes_ok:
        raise AssertionError(f"phase 33: {label}: launches {got}, want {want} on {route!r}")


def phase33a_float32(np_tree, dev) -> dict:
    """(a) float32: B1-B3 against their plain versions at this shape
    (causal=False, padded keys, no ALiBi), f32 and bf16; albert-base-v2's
    widths (H 768, E 128, 12 heads, FFN 3072, vocab 30000, 12 applications
    of the shared layer), flash, no remat, batch 2 x 256 with 64 pad ids
    ending row 1 and 15% MLM labels: the loss and every gradient card vs
    CPU (phase 7's tolerances), B1-B3 L launches each on "fma"; at sp = 1
    ``loss_fn_sp`` (ring, Ulysses) and at pp = 1 ``loss_fn_pp`` /
    ``loss_fn_1f1b`` (M = 2) against ``loss_fn``; ``fill_mask`` tokens card vs
    CPU; DiLoCoHybrid at W = 1 on phase 30 (a)'s float32 2-layer BLOOM with
    fused CE: 3 inner steps equal 3 hybrid steps bit for bit, the sync a
    hand-computed Nesterov update within 1e-6, the worker the anchor."""
    from pipegoose_tpu_torch.models import albert
    from pipegoose_tpu_torch.models.weights import params_from_jax

    b, s, pad = 2, 256, ALBERT_PAD_A
    t0 = time.perf_counter()
    out = {}
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        case = flash_case(dev, dtype, b=b, s=s, nh=12, nkv=12, hd=64, pad=pad,
                          seed=SEED + 33)
        case["slopes"] = torch.zeros_like(case["slopes"])   # ALBERT: no ALiBi
        check_flash(f"{name} B={b} nh=12 S={s} hd=64 bidirectional, row 1 right-padded by "
                    f"{pad}", case, causal=False, phase="phase 33 (a)")
    cfg = albert.AlbertConfig.albert_base(use_flash=True)
    tree = albert.init_params_numpy(cfg, seed=SEED + 33)
    batch = albert_batch(cfg, b, s, pad)
    L = cfg.n_layer
    runs = {}
    for where in ("card", "cpu"):
        d = dev if where == "card" else torch.device("cpu")
        params = params_from_jax(tree, cfg, device=d)
        counters_zero()
        runs[where] = family_grads(params, albert_loss(cfg), on_device(batch, d))
        if where == "card":
            torch.cuda.synchronize()
            launches = family_counts()
            card_params = params
        else:
            cpu_params = params
    names = leaf_names(card_params)
    (g_loss, g_grads), (c_loss, c_grads) = runs["card"], runs["cpu"]
    err, worst = albert_grads_apart(g_grads, c_grads, names)
    log(f"phase 33 (a): float32 albert-base-v2 widths (H {cfg.hidden_size}, E "
        f"{cfg.embedding_size}, {cfg.n_head} heads, FFN {cfg.intermediate_size}, vocab "
        f"{cfg.vocab_size}, {L} applications of the shared layer), flash, batch {b} x {s} "
        f"(row 1 ending in {pad} pad ids, {int(batch['lmask'].sum())} MLM labels), card vs "
        f"CPU: loss {g_loss} vs {c_loss} (err {abs(g_loss - c_loss)}, atol "
        f"{TRAIN_LOSS_ATOL}), largest gradient error {err} ({worst}; rtol "
        f"{TRAIN_GRAD_RTOL}, a leaf below {ALBERT_ZERO_GRAD} of the tree's largest gradient "
        f"against that floor); launches {launches}")
    if abs(g_loss - c_loss) > TRAIN_LOSS_ATOL or err > TRAIN_GRAD_RTOL or not np.isfinite(g_loss):
        raise AssertionError("phase 33 (a): ALBERT card and CPU disagree")
    albert_launch_check("loss_fn", launches, {"fwd": L, "dq": L, "dkv": L}, "fma")
    out["dense"] = {"loss": g_loss, "cpu_loss": c_loss, "grad_rel_err": err, "worst": worst,
                    "launches": {k: n for k, (n, _) in launches.items()}}
    dbatch = on_device(batch, dev)
    micro = 2   # the pipelines' microbatches: M x L applications each
    for kind, want in (("ring", {}), ("ulysses", {"fwd": L, "dq": L, "dkv": L}),
                       ("gpipe", {"fwd": micro * L, "dq": micro * L, "dkv": micro * L}),
                       ("1f1b", {"fwd": micro * L, "dq": micro * L, "dkv": micro * L})):
        counters_zero()
        k_loss, k_grads = family_grads(card_params, albert_loss(cfg, kind, micro), dbatch)
        torch.cuda.synchronize()
        got = family_counts()
        k_err, k_worst = albert_grads_apart(k_grads, g_grads, names)
        where = "sp = 1" if kind in ("ring", "ulysses") else "pp = 1, M = 2"
        log(f"  {kind} at {where} vs loss_fn: loss {k_loss} vs {g_loss}, gradient error "
            f"{k_err} ({k_worst}); launches {got}")
        if abs(k_loss - g_loss) > TRAIN_LOSS_ATOL or k_err > TRAIN_GRAD_RTOL:
            raise AssertionError(f"phase 33 (a): ALBERT {kind} parts from loss_fn")
        albert_launch_check(kind, got, want, "fma")
        out[kind] = {"loss": k_loss, "grad_rel_err": k_err}
    with torch.no_grad():
        counters_zero()
        got_t = albert.fill_mask(card_params, dbatch["ids"], ALBERT_MASK_ID, cfg,
                                 dbatch["mask"]).cpu()
        fill_launches = family_counts()
        cb = on_device(batch, "cpu")
        want_t = albert.fill_mask(cpu_params, cb["ids"], ALBERT_MASK_ID, cfg, cb["mask"])
    filled = int((batch["ids"] == ALBERT_MASK_ID).sum())
    log(f"  fill_mask: {filled} [MASK] slots, card tokens equal the CPU's: "
        f"{bool(torch.equal(got_t, want_t))}; launches {fill_launches}")
    if not torch.equal(got_t, want_t):
        raise AssertionError("phase 33 (a): fill_mask tokens differ card vs CPU")
    albert_launch_check("fill_mask", fill_launches, {"fwd": L}, "fma")
    out["fill_mask"] = {"slots": filled, "equal": True}
    del card_params, cpu_params, runs, g_grads, c_grads
    gc.collect()
    torch.cuda.empty_cache()
    out["diloco"] = diloco_w1_float32(np_tree, dev)
    log(f"phase 33 (a): held, {time.perf_counter() - t0:.1f} s")
    return out


def diloco_w1_float32(np_tree, dev) -> dict:
    """DiLoCoHybrid at W = 1 ("diloco" of size 1 on the one-rank context) on
    phase 30 (a)'s float32 bloom-560m widths at 2 layers (batch 4 x 256, row
    1 right-padded by 57, flash, fused CE, ZeRO-1 Adam 1e-4): 3 inner steps
    against 3 ``make_hybrid_train_step`` steps from the same weights, the
    losses, parameters and launches bit for bit; the sync against a
    hand-computed Nesterov update (lr 0.7, momentum 0.9: anchor - 0.7 x 1.9
    x (anchor - worker)) within 1e-6 of each leaf's largest value; after it
    the worker equal to the anchor bit for bit."""
    from pipegoose_tpu_torch.models import bloom
    from pipegoose_tpu_torch.models.bloom import BloomConfig
    from pipegoose_tpu_torch.models.weights import params_from_jax
    from pipegoose_tpu_torch.nn.parallel import tree_leaves
    from pipegoose_tpu_torch.optim import DiLoCoHybrid, DistributedOptimizer, adam
    from pipegoose_tpu_torch.parallel import make_hybrid_train_step

    n_layer, b, s, pad, lr = 2, 4, 256, 57, 1e-4
    vocab, hidden = np_tree["embed"]["weight"].shape
    tree = {**np_tree, "blocks": cut_layers(np_tree["blocks"], n_layer)}
    rng = np.random.default_rng(SEED + 30)
    ids = torch.from_numpy(rng.integers(0, vocab, (b, s))).to(dev)
    mask = torch.ones((b, s), dtype=torch.int64, device=dev)
    mask[1, s - pad:] = 0
    batch = {"ids": ids, "mask": mask}
    cfg = BloomConfig(vocab_size=vocab, hidden_size=hidden, n_layer=n_layer, n_head=16,
                      use_flash=True, fused_ce=True)

    def lf(p, x):
        return bloom.loss_fn(p, x["ids"], x["mask"], x["ids"], cfg, tp_axis="tensor")

    template = params_from_jax(tree, cfg, device=dev)
    params = to_device(template, dev)
    init_fn, make_step = make_hybrid_train_step(
        lf, bloom.tp_specs(params), DistributedOptimizer(adam(lr), axis_name="data"))
    state, step = init_fn(params), make_step(params)
    counters_zero()
    h_losses = [step(params, state, batch)[2].item() for _ in range(3)]
    h_launches = counters_read()
    del state, step
    anchor = to_device(template, dev)
    del template
    dl = DiLoCoHybrid(lf, bloom.tp_specs(anchor),
                      DistributedOptimizer(adam(lr), axis_name="data"), sync_every=3)
    wp, inner, outer = dl.init(anchor)
    inner_step = dl.make_inner_step(wp)
    counters_zero()
    d_losses = [inner_step(wp, inner, batch)[2].item() for _ in range(3)]
    d_launches = counters_read()
    same = all(torch.equal(x, y) for x, y in zip(tree_leaves(wp), tree_leaves(params)))
    del params
    a0 = [t.detach().clone() for t in tree_leaves(anchor)]
    w = [t.detach().clone() for t in tree_leaves(wp)]
    torch.cuda.synchronize()
    anchor, wp, outer = dl.make_sync_step(anchor)(anchor, wp, outer)
    torch.cuda.synchronize()
    sync_err = max(float((got - (a - 0.7 * (1.9 * (a - x)))).abs().max())
                   / max(float(a.abs().max()), 1e-30)
                   for got, a, x in zip(tree_leaves(anchor), a0, w))
    reset = all(torch.equal(x, y) for x, y in zip(tree_leaves(wp), tree_leaves(anchor)))
    moved = min(float((got - a).abs().max()) for got, a in zip(tree_leaves(anchor), a0))
    log(f"  DiLoCoHybrid at W = 1, float32 bloom-560m widths at {n_layer} layers, batch "
        f"{b} x {s} (row 1 right-padded by {pad}), flash + fused CE: inner losses "
        f"{d_losses} vs the hybrid step's {h_losses}, parameters equal bit for bit {same}, "
        f"launches {d_launches} vs {h_launches}; the sync against anchor - 0.7 x 1.9 x "
        f"(anchor - worker): largest error over its leaf's max {sync_err} (tol "
        f"{DILOCO_SYNC_RTOL}), least leaf move {moved}; the worker equals the new anchor "
        f"bit for bit {reset}")
    if d_losses != h_losses or not same or d_launches != h_launches:
        raise AssertionError("phase 33 (a): DiLoCoHybrid's inner steps part from the hybrid step")
    if sync_err > DILOCO_SYNC_RTOL or not reset or not moved > 0:
        raise AssertionError("phase 33 (a): the DiLoCo sync parts from the Nesterov update")
    del anchor, wp, inner, outer, a0, w
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": d_losses, "hybrid_losses": h_losses, "bit_equal": same,
            "sync_rel_err": sync_err, "launches": d_launches}


def albert_flops_per_token(cfg, s) -> float:
    """6 x the flop-bearing parameters (the E -> H projection, the shared
    layer once per application, the head's dense and its tied decoder; the
    embedding lookups bear none) + 12 L H S (attention's scores and
    context, forward and backward)."""
    h, e, i, L = cfg.hidden_size, cfg.embedding_size, cfg.intermediate_size, cfg.n_layer
    active = e * h + L * (4 * h * h + 2 * h * i) + h * e + cfg.vocab_size * e
    return 6 * active + 12 * L * h * s, active


def phase33b_timed(np_tree, dev, card) -> dict:
    """(b) bf16: albert-base-v2 at full width and depth (12 applications),
    weights from a seeded card generator, 16 x 512 ids from RandomState(0)
    with 15% MLM labels, remat + flash, ZeRO-1 Adam 1e-4 through
    ``Trainer.fit``: 2 warm-up and 3 timed steps, step ms, tokens/s, MFU,
    peak, launches per step (B1 2 L, B2/B3 L, all "mma"), the device-busy
    share of one profiled step, the step-1 loss within 2^-7 of a float32 loss
    of the same weights; ``fill_mask`` sequences/s at 64 x 512. Then one
    DiLoCoHybrid round (``DILOCO_SYNC_EVERY`` inner steps) on bf16 bloom-560m
    at 8 x 1024 (remat + flash + fused CE, Adam 1e-4): its inner steps beside
    the hybrid step's in turns (hybrid, DiLoCo, DiLoCo, hybrid; 2 steps a
    turn), launches equal; the sync's ms; the anchor's and the outer
    momentum's bytes beside the ZeRO state's."""
    import itertools

    from pipegoose_tpu_torch.models import albert
    from pipegoose_tpu_torch.nn.parallel import tree_leaves
    from pipegoose_tpu_torch.optim import DistributedOptimizer, adam
    from pipegoose_tpu_torch.trainer import Trainer

    t0 = time.perf_counter()
    cfg = albert.AlbertConfig.albert_base(dtype=torch.bfloat16, remat=True, use_flash=True)
    L, (b, s) = cfg.n_layer, (16, 512)
    params = albert.init_params(cfg, SEED + 33, device=dev)
    batch = on_device(albert_batch(cfg, b, s), dev)
    lf = albert_loss(cfg)
    with torch.no_grad():
        f32 = albert_loss(dataclasses.replace(cfg, dtype=torch.float32))(
            to_f32(params), batch).item()
    flops_tok, active = albert_flops_per_token(cfg, s)
    n = sum(p.numel() for p in tree_leaves(params))
    log(f"phase 33 (b): bf16 albert-base-v2 ({n} params, {active} flop-bearing a token "
        f"with the shared layer counted {L} times), weights from a seeded card generator, "
        f"remat + flash, Adam 1e-4, batch {b} x {s} with {int(batch['lmask'].sum())} MLM "
        f"labels, Trainer.fit; float32 loss of the same weights {f32}")
    trainer = Trainer(lf, params, albert.tp_specs(params),
                      DistributedOptimizer(adam(1e-4), axis_name="data"))
    batches = itertools.repeat(batch)
    warm, timed = 2, 3
    trainer.fit(batches, max_steps=warm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters_zero()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    trainer.fit(batches, max_steps=warm + timed)
    e1.record()
    torch.cuda.synchronize()
    counts = family_counts()
    step_ms = e0.elapsed_time(e1) / timed
    tokens_per_s = b * s / (step_ms / 1e3)
    mfu = tokens_per_s * flops_tok / BF16_FLOPS_PER_S
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(x) for x in trainer.state.losses]
    launches = {k: c for k, (c, _) in counts.items()}
    log(f"  step {step_ms} ms, {tokens_per_s} tokens/s, MFU {mfu} ({flops_tok} flops a "
        f"token over 989 TFLOP/s bf16), peak {peak_gib:.2f} GiB; losses {losses}; launches "
        f"over {timed} steps {counts}, on {card}")
    albert_launch_check("timed steps", counts,
                        {"fwd": 2 * L * timed, "dq": L * timed, "dkv": L * timed}, "mma")
    rel = abs(losses[0] - f32) / abs(f32)
    log(f"  step-1 bf16 loss {losses[0]} vs float32 {f32}: relative {rel} (tol "
        f"{FAMILY_BF16_LOSS_RTOL})")
    if rel > FAMILY_BF16_LOSS_RTOL or not all(np.isfinite(losses)):
        raise AssertionError("phase 33 (b): the bf16 ALBERT loss parts from float32")
    wall, busy, _ = profile_device(
        lambda: trainer.fit(batches, max_steps=trainer.state.step + 1), 1,
        "phase 33 (b): ALBERT, one profiled Trainer step", "step", 6)
    out = {"step_ms": step_ms, "tokens_per_s": tokens_per_s, "mfu": mfu,
           "flops_per_token": flops_tok, "active_params": active, "peak_gib": peak_gib,
           "losses": losses, "f32_loss": f32, "bf16_rel": rel, "launches": launches,
           "profiled_wall_ms": wall, "device_busy_ms": busy}
    # fill_mask at 64 x 512: one forward, B1 L launches a call
    fb = on_device(albert_batch(cfg, 64, s, seed=SEED + 1), dev)
    with torch.no_grad():
        albert.fill_mask(trainer.params, fb["ids"], ALBERT_MASK_ID, cfg)   # warm-up
        counters_zero()
        calls = 3
        e0.record()
        for _ in range(calls):
            filled = albert.fill_mask(trainer.params, fb["ids"], ALBERT_MASK_ID, cfg)
        e1.record()
        torch.cuda.synchronize()
    fill_counts = family_counts()
    seq_per_s = 64 * calls / (e0.elapsed_time(e1) / 1e3)
    kept = bool(torch.equal(filled[fb["lmask"] == 0], fb["ids"][fb["lmask"] == 0]))
    log(f"  fill_mask at 64 x {s}: {seq_per_s} sequences/s ({calls} calls between CUDA "
        f"events), unmasked ids kept {kept}; launches {fill_counts}")
    albert_launch_check("fill_mask", fill_counts, {"fwd": L * calls}, "mma")
    if not kept:
        raise AssertionError("phase 33 (b): fill_mask rewrote an unmasked id")
    out["fill_mask_seq_per_s"] = seq_per_s
    del trainer, params, batch, fb
    gc.collect()
    torch.cuda.empty_cache()
    out["diloco"] = diloco_bf16_round(np_tree, dev, card)
    log(f"phase 33 (b): done, {time.perf_counter() - t0:.1f} s")
    return out


def diloco_bf16_round(np_tree, dev, card) -> dict:
    """One DiLoCoHybrid round on bf16 bloom-560m, 8 x 1024, remat + flash +
    fused CE, ZeRO-1 Adam 1e-4, beside the hybrid step (see phase33b_timed)."""
    from pipegoose_tpu_torch.models import bloom
    from pipegoose_tpu_torch.models.bloom import BloomConfig
    from pipegoose_tpu_torch.models.weights import params_from_jax
    from pipegoose_tpu_torch.nn.parallel import tree_leaves
    from pipegoose_tpu_torch.optim import DiLoCoHybrid, DistributedOptimizer, adam
    from pipegoose_tpu_torch.parallel import make_hybrid_train_step

    cfg = BloomConfig.bloom_560m(dtype=torch.bfloat16, remat=True, use_flash=True,
                                 fused_ce=True)
    b, s, turn = 8, 1024, 2
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab_size, (b, s))).to(dev)

    def lf(p, x):
        return bloom.loss_fn(p, x, None, x, cfg, tp_axis="tensor")

    def zero_bytes(state):
        return sum(v.numel() * v.element_size() for st in state.inner.state.values()
                   for v in st.values() if torch.is_tensor(v))

    anchor = params_from_jax(np_tree, cfg, device=dev)
    params = to_device(anchor, dev)
    init_fn, make_step = make_hybrid_train_step(
        lf, bloom.tp_specs(params), DistributedOptimizer(adam(1e-4), axis_name="data"))
    h_state, h_step = init_fn(params), make_step(params)
    dl = DiLoCoHybrid(lf, bloom.tp_specs(anchor),
                      DistributedOptimizer(adam(1e-4), axis_name="data"),
                      sync_every=DILOCO_SYNC_EVERY)
    wp, inner, outer = dl.init(anchor)
    inner_step, sync = dl.make_inner_step(wp), dl.make_sync_step(anchor)
    arms = {"hybrid": lambda: h_step(params, h_state, ids)[2],
            "diloco": lambda: inner_step(wp, inner, ids)[2]}
    # round 0: one inner step and a sync, the warm-up of both
    arms["hybrid"]()
    arms["diloco"]()
    anchor, wp, outer = sync(anchor, wp, outer)
    torch.cuda.synchronize()
    times, losses = {k: [] for k in arms}, {k: [] for k in arms}
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    want = {k: turn * n for k, n in per_step_launches(cfg).items()}
    for name in ("hybrid", "diloco", "diloco", "hybrid"):
        torch.cuda.synchronize()
        counters_zero()
        e0.record()
        for _ in range(turn):
            loss = arms[name]()
        e1.record()
        torch.cuda.synchronize()
        times[name].append(e0.elapsed_time(e1) / turn)
        losses[name].append(loss.item())
        if counters_read() != want:
            raise AssertionError(f"phase 33 (b): DiLoCo {name} launched {counters_read()} "
                                 f"in {turn} steps, want {want}")
    e0.record()
    anchor, wp, outer = sync(anchor, wp, outer)   # round 1: 4 inner steps, then this
    e1.record()
    torch.cuda.synchronize()
    sync_ms = e0.elapsed_time(e1)
    reset = all(torch.equal(x, y) for x, y in zip(tree_leaves(wp), tree_leaves(anchor)))
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)   # noqa: E731
    anchor_bytes = nbytes(tree_leaves(anchor))
    momentum_bytes = nbytes(st["momentum_buffer"] for st in outer.state.values()
                            if st.get("momentum_buffer") is not None)
    med = {k: float(np.median(v)) for k, v in times.items()}
    log(f"phase 33 (b): DiLoCoHybrid, bf16 bloom-560m, {b} x {s}, remat + flash + fused CE, "
        f"sync every {DILOCO_SYNC_EVERY}: in turns (hybrid, DiLoCo, DiLoCo, hybrid; {turn} "
        f"steps a turn) hybrid {times['hybrid']} ms, DiLoCo inner {times['diloco']} ms "
        f"(medians {med['hybrid']} / {med['diloco']}, ratio "
        f"{med['diloco'] / med['hybrid']:.4f}); losses {losses}; sync {sync_ms} ms; the "
        f"worker equals the anchor after it {reset}; anchor {anchor_bytes} bytes, outer "
        f"momentum {momentum_bytes} bytes, ZeRO state {zero_bytes(inner)} bytes (the hybrid "
        f"step's {zero_bytes(h_state)}), on {card}")
    if not reset or not all(np.isfinite(v) for l in losses.values() for v in l):
        raise AssertionError("phase 33 (b): the DiLoCo round failed its checks")
    out = {"hybrid_ms": times["hybrid"], "inner_ms": times["diloco"],
           "ratio": med["diloco"] / med["hybrid"], "sync_ms": sync_ms,
           "anchor_bytes": anchor_bytes, "outer_momentum_bytes": momentum_bytes,
           "zero_state_bytes": zero_bytes(inner), "losses": losses}
    del arms, params, h_state, anchor, wp, inner, outer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def albert_flash_rows(dev, card, launches) -> list:
    """B1-B3 at ALBERT's training shape (B 16, 12 heads: B*nh = 192, S 512,
    hd 64, bf16, bidirectional, the last row ending in 64 padded keys, no
    ALiBi): each against its plain version (phase 6's check, "mma"), its
    device ms, bound (the visible pairs), plain ms and SDPA's with a boolean
    key mask. ``launches``: phase 33 (b)'s timed steps."""
    from pipegoose_tpu_torch.ops import flash_attention as fa

    b, nh, s, hd, pad = 16, 12, 512, 64, ALBERT_PAD_A
    case = flash_case(dev, torch.bfloat16, b=b, s=s, nh=nh, nkv=nh, hd=hd, pad=pad,
                      seed=SEED + 33)
    case["slopes"] = torch.zeros_like(case["slopes"])   # no ALiBi
    errs = check_flash(f"bf16 B={b} nh={nh} S={s} hd={hd} bidirectional, the last row "
                       f"ending in {pad} padded keys", case, causal=False, phase="phase 33")
    fwd, mode = flash_args(case, False)
    out, lse = fa.flash_fwd(*fwd, *mode)
    delta = (case["do"].float() * out.float()).sum(-1)
    bwd = flash_bwd_args(case, lse, delta)
    dq = fa.flash_dq(*bwd, *mode)
    dk, dv = fa.flash_dkv(*bwd, *mode)
    io = {"fwd": fwd + (out, lse), "dq": bwd + (dq,), "dkv": bwd + (dk, dv)}
    calls = {"fwd": (lambda i: fa.flash_fwd(*fwd, *mode),
                     lambda: fa.flash_fwd_reference(*fwd, *mode)),
             "dq": (lambda i: fa.flash_dq(*bwd, *mode),
                    lambda: fa.flash_dq_reference(*bwd, *mode)),
             "dkv": (lambda i: fa.flash_dkv(*bwd, *mode),
                     lambda: fa.flash_dkv_reference(*bwd, *mode))}
    # SDPA with the padding as a boolean key mask (B, 1, 1, S)
    heads = lambda t: t.reshape(b, nh, s, hd).detach().clone().requires_grad_()  # noqa: E731
    q, k, v = heads(case["q"]), heads(case["k"]), heads(case["v"])
    keep = (case["kneg"].reshape(b, nh, s)[:, :1, None, :] == 0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    so = sdpa(q, k, v, attn_mask=keep)
    with torch.no_grad():
        lib_fwd, _ = time_ms(lambda i: sdpa(q, k, v, attn_mask=keep), 8)
    lib_bwd = time_eager_ms(lambda: torch.autograd.grad(
        so, (q, k, v), case["do"].reshape(b, nh, s, hd), retain_graph=True), 8)
    pairs = nh * ((b - 1) * s * s + s * (s - pad))   # every query sees every valid key
    log(f"phase 33: flash kernels at ALBERT's shape, B*nh={b * nh}, S={s}, hd={hd}, bf16, "
        f"bidirectional, {pad} padded keys in the last row, device ms per call, on {card}")
    rows = []
    for kind in ("fwd", "dq", "dkv"):
        kernel, plain = calls[kind]
        ms, call_ms = time_ms(kernel, 8)
        plain_ms = time_eager_ms(plain, 2)
        flops = {"fwd": 4, "dq": 6, "dkv": 8}[kind] * hd * pairs
        nbytes = sum(t.numel() * t.element_size() for t in io[kind])
        t_ops, t_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
        bound_ms = max(t_ops, t_bytes) * 1e3
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        library_ms = lib_fwd if kind == "fwd" else lib_bwd
        log(f"  flash_{kind}: kernel {ms} (eager {call_ms}), bound {bound_ms} ({bound_by}), "
            f"plain {plain_ms}, SDPA (boolean key mask) {library_ms}; {launches.get(kind, 0)} "
            f"launches in phase 33 (b)'s timed ALBERT steps")
        rows.append({
            "name": f"flash_{kind} (bf16, B*nh={b * nh}, S={s}, hd={hd}, bidirectional, "
                    f"padded keys, ALBERT, mma route)",
            "source": FLASH_SOURCE, "replaces": FLASH_REPLACES[kind], "route": "cuda",
            "kernel_route": "mma", "launches": launches.get(kind, 0),
            "launches_from": "phase 33 (b) ALBERT timed steps",
            "max_abs_err": errs[kind], "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms, "call_ms": call_ms,
            "family": True})
    del case, io, calls, q, k, v, so
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def phase33_albert_diloco(np_tree, dev, card) -> tuple:
    """Phase 33: the ALBERT family and DiLoCo. Returns (its summary, its
    kernel rows)."""
    out = {"a": phase33a_float32(np_tree, dev)}
    gc.collect()
    torch.cuda.empty_cache()
    out["b"] = phase33b_timed(np_tree, dev, card)
    rows = albert_flash_rows(dev, card, out["b"]["launches"])
    return out, rows


# -- phase 34 ------------------------------------------------------------------

# the black boxes phase 34's flight recorders write; deleted at the end of the run
TELEMETRY_WORK = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                              "chip_smoke_telemetry")
TELEMETRY_TIME_VALUED = ("serving.tokens_per_s",)   # left out of the card-vs-CPU counts
TELEMETRY_BYTES_GAUGES = "serving.memledger."         # bytes: compared as pages
TELEMETRY_COST_TICKS = 4       # decode ticks a serving turn of (d)
TELEMETRY_COST_ROUNDS = 3      # (d)'s serving rounds of turns (on, off, off, on)
TELEMETRY_FIT_TURN = 2         # (d)'s Trainer steps a turn
TELEMETRY_FIT_ROUNDS = 2       # (d)'s Trainer rounds of turns (on, off, off, on)
TELEMETRY_HOST_CALLS = 500     # calls a turn of (d)'s timing of the host work alone
TELEMETRY_MFU_RTOL = 1e-12     # the callback's MFU against the phase's formula
# the CPU engine that predicts the card's host counts: the schedule depends
# on the trace, the pool and the knobs, not on the weights (no eos, greedy)
TELEMETRY_CPU_MODEL = dict(hidden_size=32, n_layer=1, n_head=4)


def telemetry_counts(reg, bytes_per_page) -> dict:
    """A registry's counters, its gauges at the end of the run (NaN, never
    set, as None; the memory ledger's byte gauges in pages; time-valued
    gauges left out) and its histograms' sample counts."""
    snap = reg.snapshot()
    gauges = {}
    for k, v in snap["gauges"].items():
        if k in TELEMETRY_TIME_VALUED:
            continue
        if v != v:
            v = None
        elif k.startswith(TELEMETRY_BYTES_GAUGES) and k.endswith("_bytes"):
            v = v / bytes_per_page
        gauges[k] = v
    return {"counters": snap["counters"], "gauges": gauges,
            "histograms": {k: h["count"] for k, h in snap["histograms"].items()}}


def telemetry_engine(params, cfg, dev, kv, label):
    """Phase 4's engine with telemetry on: an enabled private registry, a
    FlightRecorder writing under TELEMETRY_WORK, and the memory ledger."""
    from pipegoose_tpu_torch.telemetry import FlightRecorder, MetricsRegistry

    reg = MetricsRegistry(enabled=True)
    rec = FlightRecorder(os.path.join(TELEMETRY_WORK, label), capacity=1024)
    eng = make_engine(params, cfg, dev, num_slots=8, kv_dtype=kv, registry=reg,
                      recorder=rec, memledger=True)
    return eng, reg, rec


def telemetry_ledger(eng) -> dict:
    """The run's memory-ledger verdicts: ticks, conservation failures (the
    check runs on every tick), a fresh audit, the per-tick page samples."""
    led = eng.memledger
    audit = led.audit()
    return {"ticks": led.ticks, "conservation_failures": led.conservation_failures,
            "audit_ok": audit["ok"], "leaks": len(audit["leaks"]),
            "double_owners": len(audit["double_owners"]),
            "stranded": audit["stranded_reserved_pages"],
            "bytes_per_page": led.bytes_per_page,
            "samples": [{k: v for k, v in s.items() if k != "t"} for s in led.samples]}


def phase34_instrumented_serve(params, cfg, requests, dev, kv) -> dict:
    """Phase 4's warm-up run of one arm, instrumented (phase 34 (a) checks
    it): every serving counter set to 0 just before and read just after."""
    from pipegoose_tpu_torch.ops import paged_attention as pa

    label = kv or "fp"
    eng, reg, rec = telemetry_engine(params, cfg, dev, kv, f"serve_{label}")
    serving_counters_zero()
    outs, m = eng.run(as_requests(requests))
    torch.cuda.synchronize()
    out = {"tokens": [o.generated.tolist() for o in outs], "metrics": m,
           "launches": {"all": pa.paged_attention.launches, **pa.paged_attention.routes},
           "counts": telemetry_counts(reg, eng.memledger.bytes_per_page),
           "ledger": telemetry_ledger(eng), "records": len(rec.records),
           "dumps": list(rec.dumps), "memory": m["memory"]}
    del eng
    return out


def phase34_stall(params, cfg, dev) -> dict:
    """A run forced to stall: a 3-page pool, two pages held outside any
    request, a head whose worst case needs two. The watchdog must raise
    after ``stall_patience`` ticks, naming the black box it wrote."""
    from pipegoose_tpu_torch.telemetry import FlightRecorder

    rec = FlightRecorder(os.path.join(TELEMETRY_WORK, "stall"))
    eng = make_engine(params, cfg, dev, num_slots=2, num_pages=4, max_context=64,
                      prefill_chunk=16, stall_patience=3, recorder=rec)
    eng.pool.alloc(2)
    prompt = np.arange(1, 21)
    try:
        eng.run(as_requests([(prompt, 4)]))
    except RuntimeError as e:
        err = str(e)
    else:
        raise AssertionError("phase 34 (a): the stalled run did not raise")
    if not rec.dumps or rec.dumps[-1] not in err:
        raise AssertionError(f"phase 34 (a): the stall names no black box: {err}")
    with open(rec.dumps[-1]) as f:
        box = json.load(f)
    return {"error": err, "path": rec.dumps[-1], "trigger": box["trigger"]["name"],
            "environment": box["environment"], "context": box["context"]}


def phase34_serving_cost(params, cfg, requests, dev) -> dict:
    """(d) for serving: one fp-KV engine fills its 8 slots, then runs decode
    ticks with telemetry on (registry enabled, the recorder, a freshly bound
    memory ledger) and off (registry disabled, no recorder, no ledger) in
    turns, on, off, off, on, TELEMETRY_COST_TICKS ticks a turn, for
    TELEMETRY_COST_ROUNDS rounds. Returns each turn's ms a tick and each
    round's on / off ratio. Then the telemetry's host work a tick alone, in
    the same turns of TELEMETRY_HOST_CALLS calls: the decode step's span,
    ``_observe_step`` and ``_ledger_tick`` over the live decoding slots."""
    from pipegoose_tpu_torch.serving import Status
    from pipegoose_tpu_torch.telemetry import MemoryLedger, span

    def telemetry_on(on):
        if on:
            reg.enable()
            eng.recorder = rec
            eng.attach_memledger(MemoryLedger())
        else:
            reg.disable()
            eng.recorder = None
            eng.attach_memledger(None)

    eng, reg, rec = telemetry_engine(params, cfg, dev, None, "cost")
    eng.start_run(as_requests(requests))
    while eng.sched.queue or any(r.status is Status.PREFILL for r in eng.sched.active()):
        eng.tick_once()
    turns = {"on": [], "off": []}
    ratios = []
    failures = 0
    for _ in range(TELEMETRY_COST_ROUNDS):
        got = {"on": [], "off": []}
        for name in ("on", "off", "off", "on"):
            if eng.memledger is not None:
                failures += eng.memledger.conservation_failures
            telemetry_on(name == "on")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TELEMETRY_COST_TICKS):
                eng.tick_once()
            torch.cuda.synchronize()
            got[name].append((time.perf_counter() - t0) * 1e3 / TELEMETRY_COST_TICKS)
        ratios.append(sum(got["on"]) / sum(got["off"]))
        for k in turns:
            turns[k] += got[k]
    rs = eng._run
    active = [r for r in eng.sched.active() if r.status is Status.DECODE]
    if not active:
        raise AssertionError("phase 34 (d): no decoding slot left to time the host work on")
    host = {"on": [], "off": []}
    for name in ("on", "off", "off", "on"):
        if eng.memledger is not None:
            failures += eng.memledger.conservation_failures
        telemetry_on(name == "on")
        t0 = time.perf_counter()
        for _ in range(TELEMETRY_HOST_CALLS):
            with span("serving.decode_step", registry=eng.registry):
                pass
            eng._observe_step(rs, active, len(active), 0.0)
            eng._ledger_tick(rs)
        host[name].append((time.perf_counter() - t0) * 1e6 / TELEMETRY_HOST_CALLS)
    failures += eng.memledger.conservation_failures
    eng.attach_memledger(None)
    eng.finish_run()
    del eng
    return {"turns_ms": turns, "round_ratios": ratios, "ledger_failures": failures,
            "host_us": host, "host_slots": len(active)}


def phase34_cpu_counts(requests, kv) -> dict:
    """The port's CPU engine on phase 4's requests with the same knobs and
    telemetry, over TELEMETRY_CPU_MODEL at bloom-560m's vocabulary: its
    host counts are the card's prediction."""
    from pipegoose_tpu_torch.models.bloom import BloomConfig, init_params_numpy
    from pipegoose_tpu_torch.models.weights import params_from_jax

    cfg = BloomConfig(vocab_size=250880, **TELEMETRY_CPU_MODEL)
    params = params_from_jax(init_params_numpy(cfg, seed=SEED), cfg, device="cpu")
    eng, reg, rec = telemetry_engine(params, cfg, "cpu", kv, f"cpu_{kv or 'fp'}")
    outs, m = eng.run(as_requests(requests))
    return {"metrics": m, "counts": telemetry_counts(reg, eng.memledger.bytes_per_page),
            "ledger": telemetry_ledger(eng), "records": len(rec.records)}


def phase34a_serving(card, tele) -> dict:
    """(a) phase 4's two warm-up runs, instrumented: tokens and launches by
    route equal the timed (registry-off) runs'; every counter, end gauge and
    histogram count equal the CPU engine's; the ledger conserved every
    tick, its audit clean; the stall's black box naming the card."""
    requests = tele["requests"]
    out = {}
    for kv in ("fp", "int8"):
        arm = tele[kv]
        label = f"phase 34 (a) {kv} KV"
        t0 = time.perf_counter()
        cpu = phase34_cpu_counts(requests, None if kv == "fp" else "int8")
        log(f"  {label}: cpu engine {time.perf_counter() - t0:.1f} s")
        same_tokens = arm["tokens"] == arm["timed_tokens"]
        log(f"  {label}: tokens equal the registry-off engine's: {same_tokens}; launches "
            f"{arm['launches']} vs phase 4's {arm['timed_launches']}")
        if not same_tokens:
            raise AssertionError(f"{label}: telemetry changed the tokens")
        if arm["launches"] != arm["timed_launches"]:
            raise AssertionError(f"{label}: telemetry changed the kernel launches")
        got, want = arm["counts"], cpu["counts"]
        log(f"  {label}: counters {got['counters']}")
        log(f"  {label}: end gauges {got['gauges']}")
        log(f"  {label}: histogram counts {got['histograms']}")
        for part in ("counters", "gauges", "histograms"):
            if got[part] != want[part]:
                diff = {k: (got[part].get(k), want[part].get(k))
                        for k in set(got[part]) | set(want[part])
                        if got[part].get(k) != want[part].get(k)}
                raise AssertionError(f"{label}: {part} differ from the CPU engine's: {diff}")
        led, cled = arm["ledger"], cpu["ledger"]
        log(f"  {label}: ledger {led['ticks']} ticks, {led['conservation_failures']} "
            f"conservation failures, audit ok {led['audit_ok']} (leaks {led['leaks']}, "
            f"double owners {led['double_owners']}, stranded {led['stranded']}), "
            f"{led['bytes_per_page']} bytes a page, run summary {arm['memory']}")
        if led["conservation_failures"] or not led["ticks"] or not led["audit_ok"]:
            raise AssertionError(f"{label}: the memory ledger broke conservation or leaked")
        if led["samples"] != cled["samples"] or led["ticks"] != cled["ticks"]:
            raise AssertionError(f"{label}: the ledger's per-tick pages differ from the CPU's")
        if arm["records"] != arm["metrics"]["decode_steps"] or arm["dumps"]:
            raise AssertionError(f"{label}: the recorder kept {arm['records']} records for "
                                 f"{arm['metrics']['decode_steps']} steps, dumps {arm['dumps']}")
        out[kv] = {"counts": got, "ledger_ticks": led["ticks"], "memory": arm["memory"],
                   "bytes_per_page": led["bytes_per_page"]}
    stall = tele["stall"]
    name = torch.cuda.get_device_name(0)
    log(f"  phase 34 (a) stall: {stall['error']}")
    log(f"  phase 34 (a) stall black box: trigger {stall['trigger']}, environment "
        f"{stall['environment']}, context {stall['context']}")
    if stall["trigger"] != "decode_stall" or stall["environment"].get("device_name") != name:
        raise AssertionError("phase 34 (a): the stall's black box does not name the card")
    out["stall"] = {"trigger": stall["trigger"], "device_name": name}
    return out


def phase34b_trainer(np_tree, dev, card, keep) -> dict:
    """(b) phase 28 (b)'s first 8 batches through a fresh Trainer with
    TelemetryCallback(flops_per_step=, hbm_every=1, fence=True) on the
    global registry, a FlightRecorder and FailureDetector(recorder=):
    losses and params bit for bit phase 28 (b)'s, launches per step its
    own, one train.step and one train.data span sample a step, train.mfu
    the phase's MFU formula from the same step time, train.hbm_bytes_in_use
    the allocator's in-use bytes read at that point; then (d): the unfenced
    step with the registry on and off in turns, and its host work alone."""
    from pipegoose_tpu_torch.models.bloom import BloomConfig
    from pipegoose_tpu_torch.telemetry import (FlightRecorder, TelemetryCallback,
                                               get_registry, span)
    from pipegoose_tpu_torch.telemetry.derived import hbm_utilization
    from pipegoose_tpu_torch.nn.parallel import tree_leaves
    from pipegoose_tpu_torch.trainer import Callback, FailureDetector, LossLoggerCallback

    class HbmProbe(Callback):
        """After TelemetryCallback (order 5): the allocator's in-use bytes
        at the point the callback set its gauge."""

        order = 6

        def __init__(self):
            self.pairs = []

        def on_step_end(self, trainer, step, loss):
            self.pairs.append((reg.gauge("train.hbm_bytes_in_use").value,
                               float(torch.cuda.memory_allocated(dev))))

    cfg = BloomConfig.bloom_560m(dtype=torch.bfloat16, remat=True, use_flash=True,
                                 fused_ce=True)
    per = per_step_launches(cfg)
    batches = keep["batches"]
    bs, seq = batches[0].shape
    n_params = sum(int(np.size(a)) for a in tree_leaves(np_tree))
    flops_per_token = 6 * n_params + 12 * cfg.n_layer * cfg.hidden_size * seq
    reg = get_registry()
    reg.clear()
    reg.disable()
    events = []
    reg.attach(events.append)
    rec = FlightRecorder(os.path.join(TELEMETRY_WORK, "train"))
    probe = HbmProbe()
    tele_cbs = [TelemetryCallback(flops_per_step=bs * seq * flops_per_token, hbm_every=1,
                                  fence=True), rec, FailureDetector(recorder=rec), probe]
    logger_cb = LossLoggerCallback(every=8)
    t = bloom_trainer(np_tree, cfg, 1e-4, dev, callbacks=[logger_cb, *tele_cbs])
    log(f"phase 34 (b): phase 28 (b)'s {len(batches)} batches ({bs} x {seq}) through a "
        f"Trainer with TelemetryCallback(flops_per_step, hbm_every=1, fence=True), a "
        f"FlightRecorder and FailureDetector(recorder=), on {card}")
    counters_zero()
    st = t.fit(list(batches))
    torch.cuda.synchronize()
    counts = counters_read()
    losses = [float(x) for x in st.losses]
    same_losses = losses == keep["losses"]
    same_params = same_tensors(t.params, keep["params"])
    snap = reg.snapshot()
    hists = {k: h["count"] for k, h in snap["histograms"].items()}
    steps = [e for e in events if e["kind"] == "train.step"]
    mfu_err = max(abs(e["mfu"] - bs * seq / e["dur_s"] * flops_per_token / BF16_FLOPS_PER_S)
                  / e["mfu"] for e in steps)
    hbm_equal = all(a == b for a, b in probe.pairs)
    log(f"  losses {losses}; equal bit for bit to phase 28 (b)'s: {same_losses}; params "
        f"equal bit for bit: {same_params}")
    log(f"  launches over {len(batches)} steps {counts}, per step {per}")
    log(f"  histogram counts {hists}; counters {snap['counters']}")
    log(f"  train.mfu per step {[e['mfu'] for e in steps]} (flops a step {bs * seq * flops_per_token},"
        f" peak {BF16_FLOPS_PER_S}): worst relative gap to the phase's formula {mfu_err} "
        f"(rtol {TELEMETRY_MFU_RTOL})")
    log(f"  train.hbm_bytes_in_use vs the allocator's in-use bytes at that point: "
        f"{probe.pairs[:3]} ... equal every step: {hbm_equal}")
    log(f"  recorder: {len(rec.records)} records, dumps {rec.dumps}")
    if not (same_losses and same_params):
        raise AssertionError("phase 34 (b): telemetry changed the losses or params")
    if counts != {k: len(batches) * n for k, n in per.items()}:
        raise AssertionError("phase 34 (b): the launches differ from phase 28 (b)'s per step")
    if (hists.get("span.train.step.seconds") != len(batches)
            or hists.get("span.train.data.seconds") != len(batches)
            or hists.get("train.step_seconds") != len(batches)):
        raise AssertionError(f"phase 34 (b): the fit's spans are not one sample a step: {hists}")
    if len(steps) != len(batches) or mfu_err > TELEMETRY_MFU_RTOL:
        raise AssertionError("phase 34 (b): train.mfu is not the phase's MFU formula")
    if len(probe.pairs) != len(batches) or not hbm_equal:
        raise AssertionError("phase 34 (b): train.hbm_bytes_in_use is not the allocator's")
    if len(rec.records) != len(batches) or rec.dumps:
        raise AssertionError("phase 34 (b): the recorder's ring or a stray trigger is off")

    # (d): the step with the registry on and off, in turns (on, off, off, on),
    # unfenced: on, the fit's spans and a TelemetryCallback(fence=False); off,
    # neither. The recorder reads the loss every step by design and stays out.
    turn = list(batches[:TELEMETRY_FIT_TURN])
    tele_cb = TelemetryCallback(flops_per_step=bs * seq * flops_per_token, hbm_every=1)
    arms = {"on": [logger_cb, tele_cb], "off": [logger_cb]}
    turns = {"on": [], "off": []}
    for name in ("on", "off", "off", "on") * TELEMETRY_FIT_ROUNDS:
        if name == "on":
            reg.enable()
        else:
            reg.disable()
        t.callbacks = arms[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t.fit(turn)
        torch.cuda.synchronize()
        turns[name].append((time.perf_counter() - t0) * 1e3 / len(turn))
    ratio = sum(turns["on"]) / sum(turns["off"])
    pairs = [a / b for a, b in zip(turns["on"], turns["off"])]
    log(f"  (d) Trainer step with the registry on / off in turns ({TELEMETRY_FIT_TURN} steps a "
        f"turn, {TELEMETRY_FIT_ROUNDS} rounds, unfenced, wall): on {turns['on']} ms, off "
        f"{turns['off']} ms; ratio {ratio:.4f} (turn pairs {min(pairs):.4f}-{max(pairs):.4f}) "
        f"on {card}")
    # the same host work alone: the two spans and the callback's hooks a step
    # (on), the two disabled spans (off)
    loss = torch.zeros((), device=dev)
    host = {"on": [], "off": []}
    for name in ("on", "off", "off", "on"):
        if name == "on":
            reg.enable()
        else:
            reg.disable()
        cbs = arms[name][1:]
        t0 = time.perf_counter()
        for i in range(TELEMETRY_HOST_CALLS):
            with span("train.data"):
                pass
            for cb in cbs:
                cb.on_step_start(t, i)
            with span("train.step"):
                pass
            for cb in cbs:
                cb.on_step_end(t, i + 1, loss)
        host[name].append((time.perf_counter() - t0) * 1e6 / TELEMETRY_HOST_CALLS)
    t0 = time.perf_counter()
    for _ in range(TELEMETRY_HOST_CALLS):
        hbm_utilization(dev)
    host["hbm_utilization"] = (time.perf_counter() - t0) * 1e6 / TELEMETRY_HOST_CALLS
    log(f"  (d) Trainer host work a step alone (the two spans and TelemetryCallback's hooks; "
        f"{TELEMETRY_HOST_CALLS} calls a turn, on, off, off, on): on {host['on']} us, off "
        f"{host['off']} us; on - off {np.median(host['on']) - np.median(host['off']):.2f} us a step, "
        f"of it the allocator read (hbm_every=1) {host['hbm_utilization']:.2f} us on {card}")
    reg.disable()
    reg.clear()
    del t
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "launches": counts, "histograms": hists,
            "mfu": [e["mfu"] for e in steps], "mfu_rel_err": mfu_err,
            "hbm_bytes_in_use": [a for a, _ in probe.pairs],
            "cost": {"turns_ms": turns, "ratio": ratio, "pair_range": [min(pairs), max(pairs)],
                     "host_us": host}}


def phase34c_capture(dev) -> dict:
    """(c) inside a ``torch.cuda.graph`` capture a counter's ``inc`` and a
    ``span`` record nothing, and ten replays add nothing."""
    from pipegoose_tpu_torch.telemetry import MetricsRegistry, span

    reg = MetricsRegistry(enabled=True)
    c = reg.counter("captured.calls")
    x = torch.ones(1 << 16, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):         # warm-up off the capture stream
        y = x * 2
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        c.inc()
        with span("captured", registry=reg) as sp:
            y = x * 2 + 1
            sp.fence(y)
    for _ in range(10):
        graph.replay()
    torch.cuda.synchronize()
    hists = reg.snapshot()["histograms"]
    c.inc()
    out = {"counter_after_capture_and_replays": c.value - 1.0,
           "span_samples": hists.get("span.captured.seconds", {}).get("count", 0),
           "replayed_sum": float(y.sum())}
    log(f"  phase 34 (c): inside a CUDA-graph capture and 10 replays: {out}; a counter "
        f"outside a capture counts (1 increment -> {c.value})")
    if out["counter_after_capture_and_replays"] or out["span_samples"] or c.value != 1.0:
        raise AssertionError("phase 34 (c): a capture recorded telemetry")
    if out["replayed_sum"] != 3.0 * x.numel():
        raise AssertionError("phase 34 (c): the captured work did not replay")
    return out


def phase34_telemetry(np_tree, dev, card, tele, keep) -> dict:
    """Phase 34: the telemetry core on the card, (a) serving, (b) training,
    (c) a capture, (d) the cost of instrumenting each path."""
    import shutil

    try:
        log(f"phase 34: the telemetry core on {card}: (a) phase 4's engines with an enabled "
            f"registry, a FlightRecorder and the memory ledger; (b) phase 28 (b)'s Trainer "
            f"with TelemetryCallback, a FlightRecorder and FailureDetector(recorder=); (c) a "
            f"CUDA-graph capture; (d) each path on and off in turns")
        a = phase34a_serving(card, tele)
        cost = tele["cost"]
        log(f"  (d) serving decode tick with telemetry on / off in turns "
            f"({TELEMETRY_COST_TICKS} ticks a turn, {TELEMETRY_COST_ROUNDS} rounds, wall): "
            f"on {cost['turns_ms']['on']} ms, off {cost['turns_ms']['off']} ms; round "
            f"ratios {cost['round_ratios']} (range {min(cost['round_ratios']):.4f}-"
            f"{max(cost['round_ratios']):.4f}) on {card}")
        host = cost["host_us"]
        log(f"  (d) serving host work a tick alone (the decode step's span, _observe_step, "
            f"_ledger_tick; {cost['host_slots']} slots, {TELEMETRY_HOST_CALLS} calls a turn, "
            f"on, off, off, on): on {host['on']} us, off {host['off']} us; on - off "
            f"{np.median(host['on']) - np.median(host['off']):.2f} us a tick on {card}")
        if cost["ledger_failures"]:
            raise AssertionError("phase 34 (d): the re-bound ledgers broke conservation")
        b = phase34b_trainer(np_tree, dev, card, keep)
        c = phase34c_capture(dev)
    finally:
        shutil.rmtree(TELEMETRY_WORK, ignore_errors=True)
    return {"a": a, "b": b, "c": c, "serving_cost": {
        "turns_ms": cost["turns_ms"], "round_ratios": cost["round_ratios"],
        "host_us": cost["host_us"]}}


def main(argv) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Drive the port's main path on one H100.")
    ap.add_argument("--parent", default=None,
                    help="a checkout of the parent revision: time its bf16 attention "
                         "kernels and three training steps in turns with this revision's "
                         "(phases 9, 21 and 22)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    laps = [t_start]

    def lap(name):
        """Log the seconds since the last lap, so every second of the run
        is charged to a phase."""
        now = time.perf_counter()
        log(f"seconds: {name} {now - laps[-1]:.1f}")
        laps.append(now)
        gc.collect()
        torch.cuda.empty_cache()

    card = phase0_card()
    dev = torch.device("cuda")
    from pipegoose_tpu_torch import resolve_device
    from pipegoose_tpu_torch.models.bloom import BloomConfig

    resolve_device(dev)   # float32 products without TF32
    lap("phase 0")
    parent = phase1_build(args.parent)
    lap("phase 1")
    errs = phase2_kernel_vs_plain(dev)
    lap("phase 2")
    std = BloomConfig.bloom_560m().initializer_range
    np_tree, varied = init_trees(BloomConfig.bloom_560m(), SEED, (std, VARIED_INIT_STD))
    lap(f"weights: bloom-560m from seed {SEED}, init std {std} and {VARIED_INIT_STD}")
    phase3_engine_vs_cpu(np_tree, dev)
    lap("phase 3")
    launches, fp_arm = phase4_timed_serving(np_tree, dev)
    lap("phase 4")
    rows = phase5_kernel_time(dev, card, errs, launches)
    lap("phase 5")
    paged_prefill_vs_plain(np_tree, dev)
    lap("paged prefill vs plain")   # the serving state is gone before training
    flash_errs = phase6_flash_vs_plain(dev)
    lap("phase 6")
    cpu_run = phase7_train_vs_cpu(np_tree, dev)
    lap("phase 7")
    flash_run = phase8_timed_training(np_tree, dev, card)
    lap("phase 8")
    rows += phase9_flash_time(dev, card, flash_errs, flash_run["launches"], parent)
    lap("phase 9")
    fused_errs = phase10_fused_vs_plain(dev)
    lap("phase 10")
    phase11_train_options_vs_cpu(np_tree, dev, cpu_run)
    del cpu_run
    lap("phase 11")
    fused_runs = phase12_timed_variants(np_tree, dev, card, flash_run["peak_gib"])
    lap("phase 12")
    rows += phase13_fused_time(dev, card, fused_errs, fused_runs["flash+fusedce"], parent)
    lap("phase 13")
    quant_errs = phase14_quant_vs_plain(np_tree, dev)
    lap("phase 14")
    phase15_quant_engine_vs_cpu(np_tree, dev)
    lap("phase 15")
    quant_launches = phase16_quant_serving(np_tree, dev, fp_arm)
    lap("phase 16")
    rows += phase17_quant_time(dev, card, quant_errs, quant_launches)
    lap("phase 17")
    chunk_errs = phase18_chunk_vs_plain(dev)
    lap("phase 18")
    ctx = sp_context()
    try:
        phase19_sp_loss_vs_single(np_tree, dev)
        lap("phase 19")
        sp_run = phase20_timed_sp_training(np_tree, dev, card)
        lap("phase 20")
        if parent:
            phase22_steps_vs_parent(np_tree, dev, card, parent)
            lap("phase 22")
    finally:
        ctx.destroy()
    rows += phase21_chunk_time(dev, card, chunk_errs, sp_run["launches"], parent)
    lap("phase 21")
    shard_rows = phase25_tp_shards(dev, card)
    lap("phase 25")
    ctx = hybrid_context()
    try:
        phase26_hybrid_vs_train_step(np_tree, dev)
        hybrid_run = phase26_timed_hybrid(np_tree, dev, card, fused_runs["flash+fusedce"])
        lap("phase 26")
        trainer_keep = {}
        trainer = phase28_trainer(np_tree, dev, card, hybrid_run, trainer_keep)
        lap("phase 28")
        telemetry = phase34_telemetry(np_tree, dev, card, fp_arm["telemetry"], trainer_keep)
        del trainer_keep
        lap("phase 34")
        rows += phase29_tp_serving(np_tree, dev, card, fp_arm)
        lap("phase 29")
        comm_pipeline = phase30_comm_pipeline(np_tree, dev, card, hybrid_run)
        lap("phase 30")
        moe = phase31_moe(np_tree, dev, card)
        lap("phase 31")
        families, family_rows = phase32_families(dev, card)
        lap("phase 32")
        albert, albert_rows = phase33_albert_diloco(np_tree, dev, card)
        lap("phase 33")
    finally:
        ctx.destroy()
    del fp_arm
    rows += shard_rows + family_rows + albert_rows
    phase27_sampled_generate(np_tree, dev)
    lap("phase 27")
    del np_tree
    phase23_cache_spec_vs_cpu(varied, dev)
    lap("phase 23")
    rows += phase24_timed_cache_spec(varied, dev, card)
    lap("phase 24")
    del varied
    log(f"wall time {time.perf_counter() - t_start:.1f} s")
    for row in rows:
        row["trainer_launches"] = trainer_launches(row, trainer["b"])
        row["moe_launches"] = trainer_launches(row, {**moe["b"], "layouts": {}})
    print(json.dumps({"kernels": rows, "trainer": trainer, "comm_pipeline": comm_pipeline,
                      "moe": moe, "families": families, "albert": albert,
                      "telemetry": telemetry}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
