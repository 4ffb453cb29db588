#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (``src/repro_torch``).

Run from the repo root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. device      — the card's name and power limit; no CUDA, no run
  2. build       — nvcc builds every kernel of the paths from the sources in
                   this checkout, one nvcc per source, all started together
                   (registers / shared memory from -Xptxas -v; B2's and B3's
                   registers and spills per D template, none at D 32; B7's
                   per dtype, row blocks and load path, none in the main
                   path's fp32, 2 row blocks, 16-byte template; B5's per
                   path, dtype, lane width and pooling, none in the deep
                   kernel's or the short 16-byte ones; the segmented
                   merge's per pass, dtype and lane width, all 8 there,
                   none spilling in the 16-byte ones)
  3. kernels     — each kernel against its plain torch version on the card,
                   reached through dispatch's auto backend: the HSTU forward
                   (B1) at the serving shape and ragged / wide / causal
                   shapes, and at the two-tower user tower's (causal, S 64,
                   B 64 and 13); the cached-prefix forward (B4) at the serving
                   shape with n_new 1, 8 and 64 and at ragged, wide and
                   extend-only shapes, and its prefix-0 case against B1
                   (bit for bit: one tile body); rab on and off, masked
                   rows exactly 0, two calls equal bit for bit
  4. bwd kernels — the backward kernels B2 (dq + drab) and B3 (dk + dv)
                   through the autograd Function that dispatch's cuda rung
                   runs (forward B1), against their plain torch version at
                   the training shape (rab on and off), a ragged S = 100
                   shape, Dqk = Dv = 128, a causal shape and a clip shape
                   (max_rel_pos < S), and the tiling's edges: S 81 and 17
                   (the latter with D % 4 != 0), a B*H at which the k split
                   is dropped, D 64, no history (n_hist 0) and the
                   userarch_hstu step's causal B 32, S 64; two calls equal
                   bit for bit, masked rows and columns exactly 0, all
                   finite; the forward-only prefix rung refuses a call
                   under grad
     gr-train-long — B1, B2 and B3 at the cell's attention (B 2, H 8,
                   S 8,256, D 128, max_rel_pos 8,256, one full and one
                   partial history) against float64 head by head, within
                   1.5e-4 of the largest value (plain TF32 reads 2.5e-4 or
                   more), bit for bit on repeat, then timed beside their
                   bounds; B1 also at the traffic's short end (4,096 +
                   4,096 events, 8 targets each), its masked rows exactly
                   0 at both, its shared memory a block and the occupancy
                   query's blocks an SM printed; after the bag and dot
                   kernels, one sparse-row step of the cell's
                   configuration (its driver's scenario and pool, the
                   Trainer) launches B1, B2 and B3 once a layer (24 each)
                   and the segmented merge once
  5. bag kernels — the embedding-bag forward (B5) through dispatch's auto
                   backend against its plain version, sum / mean / max, at
                   the LSR training, serving and impression-level shapes,
                   ragged lengths with zeros, D 8 and 128 and out-of-range
                   ids (empty bags exactly 0; bf16 against the plain
                   version on the same bf16 table); the backward through
                   ``embedding_bag`` (``GroupedEmbeddingBagFn`` at one
                   field: B6 + the densify) against autograd
                   of the plain version, B6's rows and ids equal to the
                   plain COO function, two backward calls bitwise equal;
                   the padded bag under REPRO_TORCH_EMB_DEDUP=always still
                   launches B5 and B6; the long-bag sweep (below) through
                   ``embedding_bag``; the raw wrappers refuse a
                   grad-requiring input and launch nothing. Then the
                   grouped launch (B5 and B6 over all fields of a lookup)
                   through ``GroupedEmbeddingBagFn``: dlrm-mlperf's RO and
                   NRO sides at its scoring and training batches (13
                   fields, vocabs capped at 2**21), F = 1 at the LSR
                   shapes, and groups of three fields at the edge shapes
                   (ragged, D 8, D 20, out-of-range ids, V 4 at B 8,192
                   and 3,072, bf16), sum / mean / max: against the plain
                   grouped version, bit for bit against the stack of the
                   F = 1 launches and (sum, mean) against slot-ordered fp32
                   adds, B6's rows and ids equal to plain, two backward
                   calls bit for bit, table gradients vs autograd of plain,
                   one B5 and one B6 launch a call; the 16-byte and
                   one-element load paths bit for bit, strided int64 ids,
                   forced dedup (still one grouped launch each way), the
                   long-bag sweep through ``embedding_bag_grouped`` at
                   F = 3, and every B5 launch the host can choose reached
                   over the phase; the raw grouped wrappers' refusals. The
                   long-bag sweep: B 1, 8, 32, 64, 192, 2,048 x L 5, 50,
                   64, 200 x D 8, 32, 64, 128 (and bf16 D 256, short
                   one-element and 16-byte bags), fp32 and bf16, sum /
                   mean / max: equal to the slot-ordered adds bit for bit
                   (sum, mean), to plain within BAG_TOL (fp32 sum and mean:
                   + RTOL x the bag of the rows' magnitudes; bf16:
                   BF16_ATOL / BF16_RTOL), grouped to its F = 1 stack bit
                   for bit; each shape's launch (VEC, U, threads a block,
                   blocks) printed
  6. dot kernels — the DLRM dot interaction (B7) through dispatch's auto
                   backend against its plain version, with and without the
                   diagonal, at the dlrm-mlperf scoring (512, 26, 128) and
                   training (8,192, 26, 128) shapes, the scenario's
                   reduced DLRM (F 4, D 16), B 1 and 37, D 24, F 1, 8, 13,
                   40 and 63 (4 row blocks, D 256), the tiles' row-block
                   edges (F1 16, 17, 32, 33), D 13 (4-byte loads), inputs
                   one element off 16-byte alignment, each k split (1, 2
                   and 4 warps a sample: B 8,192, 1,003 and 512) and a B
                   (1,003) that is not a multiple of the samples a block;
                   every call twice, bit for bit; bf16 against the plain
                   version on the same bf16 inputs (also 2 bytes off, and
                   at 4 row blocks); the backward through
                   ``DotInteractionFn`` against autograd of the plain
                   version, bitwise on repeat; the raw wrapper refuses a grad-requiring input
                   and an unsupported shape and launches nothing
  7. serve       — ROOServer with random hstu-gr params (seeded
                   torch.Generator) scores 1,000 simulated requests on the
                   card through B1; launch counts, failed batches and
                   scores are checked against the torch-dense server and a
                   CPU server
  8. incremental — the state-store engine serves 64 users over 4 waves of
                   appended events (then the simulated stream) through B4
                   alone: hits, launch counts and scores vs the stateless
                   server, requests/s of both, and where the time goes
  9. cache       — ROOServer with the user-tower cache serves the stream
                   twice; the second pass is all full-cache batches with
                   the same scores; a weight swap empties the cache
 10. train       — the hstu-gr Trainer (Adam on dense weights, row-wise
                   Adagrad on the tables) takes 20 steps on ROOBatcher
                   batches of the simulated stream (32 requests / 192
                   impressions) through B1-B3: launch counts, no skipped
                   step, NE logged, per-step losses vs the same run on
                   torch-dense and on the CPU, the w_uvqk gradient vs
                   torch-dense, a kill at step 12 and a restart from the
                   checkpoint vs the uninterrupted run; steps/s,
                   requests/s and a per-step breakdown
 11. lsr serve   — roo-lsr ``userarch`` at lsr_config width (seeded random
                   params) scores the 1,000 requests through B5 (launches
                   == scored batches, B1 0) against the plain embedding
                   backend on the card and a CPU server; ROO vs
                   impression-level logits on one batch (B5 at B_NRO); the
                   user-tower cache over the stream twice (the second pass
                   all full-cache, 0 B5 launches, the same scores);
                   requests/s of both servers
 12. lsr train   — the roo-lsr ``userarch`` Trainer, 20 steps through B5 and
                   B6 (B5 = steps + NE forwards, B6 = steps, B1-B4 0):
                   losses vs the plain embedding backend on the card and
                   the CPU run, the item_emb gradient vs plain, a kill at
                   step 12 and a restart, steps/s and a per-step breakdown;
                   then ``userarch_hstu`` for 10 steps through B1-B3 (B5,
                   B6 0), losses vs torch-dense attention
 13. dlrm score  — dlrm-mlperf at its published widths (tables capped at
                   2**21 rows each: 13,693,773 rows, 7.0 GB; seeded
                   random params) scores 16 synthetic batches of 128
                   requests / 512 impressions under no_grad: B7 1 and B5
                   2 launches per ROO forward (one grouped launch a side;
                   1 for the impression-level forward's 26 fields), B1-B4
                   and B6 0; logits vs the plain dot and bag backends on
                   the card and vs the impression-level forward;
                   impressions/s, requests/s and peak memory
 14. dlrm train  — the dlrm-mlperf Trainer (Adam + row-wise Adagrad, dense
                   table gradients) takes 20 steps of 2,048 requests /
                   8,192 impressions: B7 20, B5 = B6 = 40, the segmented
                   merge 200 (``dlrm_merges``: the 10 NRO fields of 64
                   rows or more, past 3,072 ids, a step; the plain-backend
                   run's gathers take it as often), B1-B4 0, no
                   skipped step; losses vs the plain backends on the card,
                   and at a 2**14-row cap (64 / 256, 10 steps) vs the CPU;
                   steps/s, impressions/s, a per-step breakdown, peak
                   memory (no kill-and-restart here: phases 10 and 12
                   check that contract, and a 7 GB checkpoint would
                   dominate the phase)
 15. sparse rows — both trainers again on sparse rows
                   (``make_sparse_value_and_grad`` + row-wise Adagrad on the
                   touched rows, in place): roo-lsr ``userarch`` 20 steps
                   (item_emb and user_cat_emb gathered, act_emb dense; B5 =
                   steps + NE, B6 = steps) and dlrm-mlperf 20 steps on the
                   dense phase's capped config and batches (B7 20, B5 = B6
                   = 40: the grouped bags over the gathered rows and the
                   dense tiny tables; the segmented merge 200, into the
                   NRO side's gathered rows); every table of 64 rows or
                   more gets a SparseRows of one row per declared id and
                   no (V, D) gradient; each step's loss vs the dense
                   tables on the plain backends and on the CPU (dlrm: at a
                   2**14-row cap) on the same params and batch; densified
                   gradients vs the dense path's; a second run bit for bit
                   (losses and params); steps/s, breakdown and (dlrm) peak
                   memory beside the dense phase's
 16. times       — each kernel vs its plain version (CUDA events; device
                   time with the host run ahead, and host-issued call time)
                   beside its bound, the bag kernels also beside one
                   PyTorch call (F.embedding_bag and its backward), B7 at
                   the dlrm scoring and training shapes beside torch.bmm
                   + the tril index_select (two calls), and the servers'
                   and trainers' rates (B7's plain backward, the rest of
                   DotInteractionFn, at the training shape too); also B1
                   at the training shape, B4 at n_new 1, 8 and 64, and
                   B5 / B6 at dlrm's one-hot bags (D 128, B 512 and
                   8,192) beside F.embedding_bag,
                   and B2 / B3 also at the userarch_hstu step's shape; the
                   grouped B5 / B6 for each dlrm side at both batches
                   beside their summed bound, plain, 13 F = 1 launches and
                   13 F.embedding_bag calls (for B6 the backward of 13
                   sparse=True calls: the per-slot COO rows), and one
                   host-issued _field_lookup, grouped vs per-field; the
                   grouped B5 / B6 at the operands the sparse dlrm step
                   hands them (gathered rows + a zero row, dense tiny
                   tables, ids as positions) vs plain, bound and 13
                   F.embedding_bag calls; SparseRows.to_dense of 8,192
                   ids into dlrm's tiny tables (4, 14, 36 rows: the
                   one-hot product) and into a 108-row table's gathered
                   rows, beside the sorted index_put_; the segmented
                   merge at the dlrm training cell's three shapes under
                   Zipf 1.05 and uniform ids, bit for bit on repeat and
                   against plain, beside index_put_, plain and its bound

 17. other archs — after the roo-lsr phases, the remaining recsys archs at
                   the reference scenario's registered shapes (50,000
                   items, hist 64, 32 requests / 192 impressions a training
                   batch, the 1,000-request stream for serving), each from
                   seeded random params made once and shared by every run
                   of the phase: roo-esr in "hstu" user-tower mode serves
                   stateless (B1 = n_layers x batches) and through the
                   user-tower cache (pass 2 all full-cache, B1 0), then
                   trains 20 steps dense and 20 on sparse rows (B1 =
                   n_layers x (steps + NE forwards), B2 = B3 = n_layers x
                   steps); roo-esr in "mlp" mode trains dense and on sparse
                   rows (B5 = steps + NE, B6 = steps; over the gathered
                   rows on sparse rows); roo-retrieval ("hstu") serves
                   stateless through its fan-out scores and trains dense and
                   on sparse rows; mind and dien serve and train dense and
                   on sparse rows, bert4rec serves and trains dense (its
                   cloze mask from the step's generator), all three with
                   no kernel launch. Every server's scores within 1e-4 of
                   the plain backends on the card and of a CPU server;
                   every step's loss against the plain backends on the
                   card and the CPU on the same params, batch and
                   generator state; on sparse rows the gradient rule and
                   the densified gradients vs the dense path; a second run
                   from the same init tree bit for bit (the Trainer leaves
                   the caller's tree as it was); requests/s and steps/s.
                   The times phase adds B1 at roo-esr's serving shape and
                   B5 / B6 at the "mlp" tower's mean bag (the operands one
                   step hands them: the dense table and the gathered rows),
                   and the dlrm sparse phase prints its peak memory during
                   Trainer.init_state (the state's copy of the tables) and
                   over the steps after it, the latter gated at 8 GiB
 18. scenarios   — the port driven as a user drives it, through the
                   scenario layer (``repro_torch.scenario``): every
                   registered scenario (and roo-lsr ``userarch``, the
                   scenario path's bag route outside dlrm) trains 20 steps
                   at full width through ``train_from_scenario``: the
                   launches its model's route implies (B1-B3 for the HSTU
                   towers, B5 / B6 for the history bag, B5 / B6 a side and
                   B7 for dlrm-mlperf's reduced config), the checkpoint
                   meta's scenario hash, each step's loss against the
                   plain backends on the same params, the plain-backend
                   spec's first loss, runs two and three bit for bit, and
                   the ``train.sparse_emb`` twin (not bert4rec: its first
                   loss equal to the dense run's); the seven servable archs
                   serve the spec's stream through
                   ``ScoringEngine.from_scenario`` on the trained params
                   (launches, scores vs the plain-backend spec, the
                   user-tower cache where the adapter splits, incremental
                   serving for hstu-gr through B4); ``python -m
                   repro_torch.launch.train`` runs as a subprocess on the
                   card for roo-lsr and dlrm-mlperf, flags against the
                   ``--config`` of its own ``--dump-config``, checkpoints
                   bit for bit; obs: an hstu-gr serve-and-train run under
                   ``obs.mode=trace`` with a telemetry file (the engine's
                   and the trainer's spans, the report over the JSONL),
                   ``device_trace`` around five steps holding B1-B3's
                   kernel events, requests/s with obs off / metrics /
                   trace; faults: a seeded ``engine.score`` plan resolves
                   exactly the fired batches' requests to ScoreError and
                   leaves every other score bit for bit, and poisoned
                   batches (``train.batch:nan``) skip exactly 2 steps; the
                   times phase adds B5 / B6 / B7 at the operands of the
                   dlrm-mlperf scenario's training step
 19. disk        — ``data.source="disk"`` through ``train_from_scenario``:
                   hstu-gr (B1-B3) and roo-lsr ``userarch`` (B5 / B6) at
                   full width, 60 steps (two epoch boundaries of the
                   800-request stream's ~25 batches of 32 / 192, 4 shards
                   in a ``tempfile.mkdtemp()`` directory), a checkpoint
                   and a cursor every 20: the shards built, reused
                   untouched and refused for another ``data.seed``; the
                   route's launches; prefetch off bit for bit prefetch on;
                   a run killed after step 30 resumed from 20 with a fresh
                   loader, bit for bit the uninterrupted run; each step's
                   loss against the plain backends on the same params;
                   the four pipeline fault sites (``prefetch.io`` retried
                   bit for bit, ``prefetch.stall`` restarting one producer
                   under a 1.5 s watchdog, a byte flipped on disk and a
                   ``shard.read`` corruption each quarantining exactly its
                   shard, a ``shard.write`` kill's torn ``.tmp`` swept);
                   steps/s from memory, disk with and without prefetch in
                   turns, the pipeline's span times, queue depth and peak
                   memory; the stream's ROO and impression-level bytes

 20. spmd        — training over a mesh (``phase_spmd``): hstu-gr under a
                   1x1 NCCL mesh bit for bit the run without one, two gloo
                   ranks sharing the card, dlrm scoring under a 1x2 plan
                   and B7 on one rank's D slice
 21. lm / mace   — the LM family at full width, cut in depth
                   (phi3-medium-14b 2 of 40 layers at batch 1 x 4,096,
                   granite-moe-3b-a800m 4 of 32 at 2 x 4,096): 5 training
                   steps twice from one init tree, bit for bit, and with
                   full_attn_max_seq = q_chunk = 1,024 (each step's loss vs
                   the unchunked loss on the same params, rtol 1e-5);
                   steps/s, tokens/s, peak memory, the model-FLOP share of
                   the dense bf16 peak; decode: prefill 4 x 1,024 into
                   s_max 1,152, 64 serve_steps, the first 4 steps' logits
                   vs the full forward (f32 compute: max within 1e-3 of
                   the logits' rms of the forward over the cache's bf16
                   K/V; bf16: mean within 2e-2 of it, printed for the
                   MoE, whose routing jumps); MACE at mace_cells'
                   molecule shape (128 graphs of 30 nodes / 64 edges,
                   channels 128): 10 steps twice bit for bit, the energy
                   under a rotation + translation (2e-4), vs the CPU
                   (1e-4), hoist_gathers on vs off (1e-5); the five LM
                   archs' and MACE's smoke configs 10 steps through the
                   launcher on the card and in process against the CPU
                   per step (2e-2 bf16, 1e-4 MACE); none of these launches
                   B1-B7. ``kernels/ops.py``: use_pallas "always" / "auto"
                   vs "never" for B1 (serving shape), B5 (a dlrm scoring
                   field) and B7 (dlrm scoring), one launch a call, with
                   times
 22. dry run     — ``python -m repro_torch.launch.dryrun`` over all 40
                   cells on the 16 x 16 and the 2 x 16 x 16 fake worlds
                   and on 1 x 1, in parallel processes (``--shard``): 40
                   OK lines from each, each cell's dominant roofline term;
                   then every cell whose 1 x 1 peak estimate is under 60
                   GiB (at least mace/molecule and mind, bert4rec and dien
                   serve_p99) on the card under a 1 x 1 NCCL plan, its
                   state and inputs from a seeded generator, the plain
                   backends set through the env vars: FlopCounterMode's
                   count of a step equal to the dry run's, the card's peak
                   memory within 20 % of the estimate, 3 steps timed
                   against the roofline's largest term (no gate), B1-B7
                   launches
 23. examples    — ``examples/torch_*.py`` in process, each ``main(["--device",
                   "cuda"])`` at the reference examples' sizes and default
                   steps: the launches of B1-B7 in each run against the
                   counts the code gives (the examples' roo-lsr
                   ``userarch_hstu`` and roo-retrieval HSTU towers run
                   B1-B3; no example reaches B4-B7); serve_roo's scores
                   against the same example on the CPU (1e-4); the
                   pipeline's resume bit for bit (the example asserts it);
                   NE and losses finite; storage_analysis's table. Then the
                   dense-mask HSTU branch on the card against the MaskSpec
                   route (B1) at 1e-5, both mask ranks; the impression-level
                   baseline (``impression_batches``, B_RO = B_NRO = 192)
                   beside the quickstart's ROO batches, 10 steps each,
                   steps/s and impressions/s; B1-B3 timed at the operands
                   each example's run recorded, beside the plain version
                   and the bound
 24. bf16        — (runs right after phase 10, beside the fp32 hstu-gr
                   phases: after phases 22 and 23 a torch.profiler trace
                   of the card recorded no device activity in this
                   process) hstu-gr with bf16 params (``gr_init(..., dtype=
                   torch.bfloat16)``) and the bf16 variants of B1-B4: each
                   against the fp32 oracle on the same bf16 values (the
                   reference's bf16 kernel tolerance, 2e-2) and bit for bit
                   against the fp32 kernel on those values rounded once to
                   bf16 (the same products, less those that are exactly 0),
                   at the serving (B 64) and training (B 32) shapes, D 64,
                   D 128 and a D 18 / 13 shape (one-element copies), rab on
                   and off; B4 at n_new 1, 8 and 64 and its prefix-0 case
                   bit for bit B1's; B2 / B3 through autograd; a
                   torch.profiler count of the kernels of one call (one
                   bf16 kernel, no cast of q, k, v or the output). Then the
                   model through its entry points: ROOServer stateless (the
                   1,000 requests, B1 = n_layers x batches) and with the
                   user-tower cache (pass 2 all full-cache, bit for bit
                   pass 1), the incremental engine on the repeat waves
                   (B4 alone, hits, bf16 K/V states of two bytes an
                   element) against the stateless server, each against a
                   CPU server on the same params (2e-2 + 2e-2 |score|);
                   20 Trainer steps (B1-B3 launches, each step's loss
                   against torch-dense on the same params, rtol 5e-3);
                   roo-lsr ``userarch_hstu`` and roo-esr's ``"hstu"`` user
                   tower in bf16: one step's loss, gradients and scores
                   through B1-B3 against the CPU; requests/s and steps/s
                   beside the fp32 phases'; bf16 and fp32 kernel times in
                   turns at the same shapes
 25. bf16 bags   — (runs after phase 17's other archs, before the times
                   phases and phases 18-23) the bag models with bf16 tables
                   and bf16 state at rest, each wrapper's operand dtypes
                   recorded: dlrm-mlperf at the 2**21 cap in bf16 (4.0 GB of
                   tables) scores 16 batches of 128 / 512 (B5 2 a forward
                   in bf16, B7 1 on fp32 operands: a bf16 dlrm's bottom MLP
                   output is fp32, and the interaction promotes as the
                   reference's concatenation does), vs the plain backends
                   and, at the 2**14 cap, the CPU, and the impression-level
                   forward (B7 once, fp32) vs ROO; 20 dense training steps
                   of 2,048 / 8,192 and 20 on sparse rows (B5 2, B6 2, B7 1
                   a step, no skipped step, each step's loss vs the plain
                   backends on its own params, the tables bf16 and on
                   sparse rows only rows the batches name moved), steps/s
                   and peak memory beside the fp32 phases'; roo-lsr
                   ``userarch`` and ``baseline`` in bf16 serving stateless
                   and through the user-tower cache (B5 = batches; pass 2
                   none) and training 20 steps, and the two-tower ``"mlp"``
                   tower 20 steps (B5 = steps + NE, B6 = steps), each vs the
                   plain backends and the CPU and a second run bit for bit;
                   a bf16 hstu-gr Trainer killed after step 12 and restarted
                   from its bf16 checkpoint, bit for bit the uninterrupted
                   run, the checkpoint's bytes beside an fp32 state's, and
                   params_to_numpy of the bf16 tree and back bit for bit;
                   B5 / B6 in bf16 timed at dlrm's scoring and training
                   shapes and at lsr's (B 32, 64 and 192) beside the fp32
                   kernel, plain, the library calls and the bound at
                   2-byte rows. bf16
                   tolerance: 2e-2 (atol and rtol), the reference's

Numerics: the reference is fp32 end to end, so TF32 is switched off for
matmuls and cuDNN; kernel and plain versions then differ only in summation
order (atol = rtol = 1e-5 on attention outputs and on dq, dk, dv; 1e-4 on
drab, a sum over B·S² cells, and on logits and gradients of the model).
Bag outputs: |kernel - plain| <= 1e-5 with the table at lsr_init's scale;
the table gradient atol = rtol = 1e-5; B6's rows and ids bit for bit; the
grouped B5 bit for bit against its F = 1 launches and, for sum and mean,
against fp32 adds in slot order (the kernel adds in that order).
Dot interaction: atol 1e-4, rtol 1e-5 at std-1 inputs (sums of up to 256
O(1) products, summed in another order); DLRM logits 1e-4; losses 1e-5.
The LM computes in bf16 as the reference does; cuBLAS's reduced-precision
bf16 reductions are off, so bf16 products are summed in f32 as the
reference's dots sum them.

The second-to-last lines are the kernels' JSON record and the card's name
and power limit; the last line is ``{"ok": true, "device": {...}}``.
It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
ATOL = RTOL = 1e-5            # attention outputs and dq/dk/dv, vs plain
LOGIT_TOL = 1e-4              # logits / scores; drab; model gradients
LOSS_TOL = 1e-5               # per-step training losses (rtol; atol 1e-6)
PARAM_TOL = 1e-5              # params after a kill and restart (atol)
BAG_TOL = 1e-5                # embedding-bag outputs vs plain (atol)
BF16_RTOL = 1e-2              # bf16 B5 vs plain on the same bf16 table
BF16_ATOL = 1e-3              # (table ~ N(0, 1): outputs are O(1))
DOT_ATOL, DOT_RTOL = 1e-4, 1e-5  # B7 vs plain, std-1 inputs: sums of up
                                 # to 256 O(1) products in another order
DLRM_CAP = 2 ** 21            # rows per dlrm-mlperf table on the card
DLRM_CPU_CAP = 2 ** 14        # rows per table in the CPU cross-check
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, published
FP32_FLOP_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
BF16_FLOP_PER_S = 989e12      # H100 SXM bf16 tensor cores, dense
SPARSE_STEPS_PEAK_GIB = 8.0   # dlrm sparse steps' peak: 7.50 GiB before
                              # the Trainer copied its state, + 0.5


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def call_ms(fn, iters: int, warmup: int = 10) -> float:
    """Mean time per call of ``fn`` issued back to back by the host (CUDA
    events): what a caller pays, host launch overhead included."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float:
    """Mean device time per call of ``fn``: a sleep kernel holds the card
    while the host enqueues every call, so the CUDA events between them
    time the device alone. Fails if the host did not get ahead — also when
    ``iters`` calls launch more kernels than the launch queue holds (about
    a thousand), since the host then waits for the card."""
    import torch
    host_s = call_ms(fn, iters) * 1e-3 * iters        # also the warm-up
    for cycles in (4e9 * host_s + 1e7, 40e9 * host_s + 1e8):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(cycles))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        ahead = not start.query()   # the card had not reached the calls yet
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / iters
    raise SystemExit("device_ms: the host never got ahead of the card")


def attention_inputs(shape, seed, device):
    """Random q/k/v/rab and ragged lengths (incl. zeros) from numpy."""
    import numpy as np
    import torch
    b, h, s, dqk, dv, n_hist, max_rel = shape
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, s, dqk)).astype(np.float32)
    k = rng.normal(size=(b, h, s, dqk)).astype(np.float32)
    v = rng.normal(size=(b, h, s, dv)).astype(np.float32)
    rab = (0.5 * rng.normal(size=(h, 2 * max_rel + 1))).astype(np.float32)
    hl = rng.integers(0, n_hist + 1, size=b).astype(np.int32)
    tc = rng.integers(0, s - n_hist + 1, size=b).astype(np.int32)
    hl[0], tc[0] = 0, s - n_hist          # no history, every target
    if b > 1:
        hl[1], tc[1] = n_hist, 0          # full history, no target
    t = lambda a: torch.from_numpy(a).to(device)
    return dict(q=t(q), k=t(k), v=t(v), rab=t(rab), hl=t(hl), tc=t(tc),
                n_hist=n_hist, max_rel=max_rel)


def op_rate(x) -> float:
    """The card's peak rate for the operands' type: fp32 outside the
    tensor cores, or bf16 on them."""
    import torch
    return (BF16_FLOP_PER_S if x["q"].dtype == torch.bfloat16
            else FP32_FLOP_PER_S)


def bound(x) -> tuple:
    """Least time (ms) the card needs for one call on these inputs: bytes
    over HBM rate vs FLOPs over the rate for the operands' type
    (``op_rate``), both counted on what the ROO mask keeps. Bytes: the q, k
    and v rows the output depends on (history rows < hist_lengths, target
    rows < target_counts) read once, the whole output written once, rab
    and the lengths (int32), at the operands' element size. FLOPs:
    2 (Dqk + Dv) per cell the mask keeps."""
    from repro_torch.core.masks import roo_spec
    b, h, s, dqk = x["q"].shape
    dv = x["v"].shape[-1]
    es = x["q"].element_size()
    valid_rows = int((x["hl"] + x["tc"]).sum()) * h
    n_bytes = es * (valid_rows * (2 * dqk + dv) + b * h * s * dv
                    + x["rab"].numel()) + 4 * 2 * b
    cells = int(roo_spec(x["hl"], x["tc"], x["n_hist"]).dense(s).sum()) * h
    ops = 2 * cells * (dqk + dv)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / op_rate(x)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", n_bytes, ops)


def prefix_inputs(shape, seed, device):
    """Random q/k/v/rab for the cached-prefix layout and ragged per-request
    counts from numpy, honoring prefix + new <= n_hist, with edge rows: a
    full request from an empty cache, a request that fills the cache with
    no target, and (B > 2) a request with nothing valid."""
    import numpy as np
    import torch
    b, h, n_hist, n_new, m, dqk, dv, max_rel, scale_len = shape
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, n_new + m, dqk)).astype(np.float32)
    k = rng.normal(size=(b, h, n_hist + m, dqk)).astype(np.float32)
    v = rng.normal(size=(b, h, n_hist + m, dv)).astype(np.float32)
    rab = (0.5 * rng.normal(size=(h, 2 * max_rel + 1))).astype(np.float32)
    hl = rng.integers(0, n_hist + 1, size=b)
    pfx = (rng.random(b) * (hl + 1)).astype(np.int64)
    nc = np.minimum(hl - pfx, n_new)
    tc = rng.integers(0, m + 1, size=b)
    full = min(n_hist, n_new)
    pfx[0], nc[0], tc[0] = 0, full, m
    if b > 1:
        pfx[1], nc[1], tc[1] = n_hist - full, full, 0
    if b > 2:
        nc[2], tc[2] = 0, 0
    t = lambda a: torch.from_numpy(a).to(device)
    i32 = lambda a: t(a.astype(np.int32))
    return dict(q=t(q), k=t(k), v=t(v), rab=t(rab), pfx=i32(pfx),
                nc=i32(nc), tc=i32(tc), n_hist=n_hist, n_new=n_new,
                max_rel=max_rel, scale_len=scale_len)


def bound_prefix(x) -> tuple:
    """Least time (ms) the card needs for one cached-prefix call on these
    inputs, on the mask's basis as for ``bound()``. Bytes: the q rows the
    mask keeps (new < new_counts, targets < target_counts), the k and v
    columns it keeps (prefix + new + targets), the whole output, rab and
    the three (B,) counts. FLOPs: 2 (Dqk + Dv) per cell the mask keeps."""
    from repro_torch.core.masks import prefix_spec
    b, h, n_rows, dqk = x["q"].shape
    n_cols, dv = x["k"].shape[2], x["v"].shape[-1]
    es = x["q"].element_size()
    q_rows = int((x["nc"] + x["tc"]).sum()) * h
    kv_cols = int((x["pfx"] + x["nc"] + x["tc"]).sum()) * h
    n_bytes = es * (q_rows * dqk + kv_cols * (dqk + dv)
                    + b * h * n_rows * dv + x["rab"].numel()) + 4 * 3 * b
    spec = prefix_spec(x["pfx"], x["nc"], x["tc"], x["n_hist"], x["n_new"])
    cells = int(spec.dense(n_rows, n_cols).sum()) * h
    ops = 2 * cells * (dqk + dv)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / op_rate(x)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", n_bytes, ops)


def phase_build(kmods) -> None:
    """Build every kernel at once: one nvcc per source, started together."""
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kmods)) as pool:
        built = list(pool.map(lambda m: m.build(), kmods))
    print(f"[build] {len(kmods)} kernels in {time.perf_counter() - t0:.2f} s")
    for path, log in built:
        print(f"[build] {path.name}")
        for line in log.splitlines():
            if "ptxas info" in line or "spill" in line:
                print(f"[build] {line.strip()}")
    hstu = hstu_registers("\n".join(log for _, log in built))
    for (name, dp, dtype), (regs, spill) in sorted(hstu.items()):
        print(f"[build] {name} {dtype} D{dp}: {regs} registers, {spill} "
              f"bytes spilled")
    if len(hstu) != 24 or any(
            spill for (name, dp, _), (_, spill) in hstu.items()
            if dp == 32 and name in ("B2", "B3")):
        raise SystemExit("the backward kernels' D 32 templates spill (the "
                         "main path's) or a template is missing")
    dot = dot_registers("\n".join(log for _, log in built))
    for (dtype, rb, vec), (regs, spill) in sorted(dot.items()):
        print(f"[build] B7 {dtype} {rb} row blocks "
              f"{'16-byte' if vec else '4-byte'} loads: {regs} registers, "
              f"{spill} bytes spilled")
    if len(dot) != 16 or dot.get(("fp32", 2, True), (0, 1))[1]:
        raise SystemExit("B7's main-path template (fp32, 2 row blocks, "
                         "16-byte loads) spills or a template is missing")
    merge = merge_registers("\n".join(log for _, log in built))
    for (which, dtype, vec), (regs, spill) in sorted(merge.items()):
        print(f"[build] segment merge {which} {dtype} VEC {vec}: {regs} "
              f"registers, {spill} bytes spilled")
    if len(merge) != 8 or any(spill for (_, _, vec), (_, spill)
                              in merge.items() if vec > 1):
        raise SystemExit("a 16-byte segmented-merge template (the main "
                         "path's) spills, or a template is missing")
    bag = bag_registers("\n".join(log for _, log in built))
    for (path, dtype, vec, pool), (regs, spill) in sorted(bag.items()):
        print(f"[build] B5 {path} {dtype} VEC {vec} "
              f"{('sum', 'mean', 'max')[pool]}: {regs} registers, {spill} "
              f"bytes spilled")
    if len(bag) != 42 or any(spill for (path, _, vec, _), (_, spill)
                             in bag.items()
                             if path == "deep" or (path == "short"
                                                   and vec > 1)):
        raise SystemExit("a main-path B5 template (the deep kernel's, the "
                         "short 16-byte ones) spills, or a template is "
                         "missing")


def ptxas_registers(log: str, key) -> dict:
    """{key(entry name): (registers, spill store + load bytes)} of the
    kernels whose mangled name ``key`` maps to a key (None: skipped), from
    ``-Xptxas -v``."""
    import re
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = key(m.group(1))
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[cur] = (None, int(m.group(1)) + int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur] = (int(m.group(1)), out.get(cur, (None, 0))[1])
            cur = None
    return out


def hstu_registers(log: str) -> dict:
    """{(B1 | B4 | B2 | B3, padded D, fp32 | bf16): (registers, spill
    bytes)} of the HSTU kernels' templates."""
    import re
    names = {"hstu_fwd_kernel": "B1", "hstu_prefix_fwd_kernel": "B4",
             "hstu_bwd_dq_kernel": "B2", "hstu_bwd_dkv_kernel": "B3"}

    def key(name):
        k = re.search(r"(hstu_(?:prefix_fwd|fwd|bwd_dq|bwd_dkv)_kernel)"
                      r"ILi(\d+)E(f|13__nv_bfloat16)E", name)
        return ((names[k.group(1)], int(k.group(2)),
                 "fp32" if k.group(3) == "f" else "bf16") if k else None)
    return ptxas_registers(log, key)


def bag_registers(log: str) -> dict:
    """{(short | long | deep, fp32 | bf16, VEC, pooling code): (registers,
    spill bytes)} of B5's templates."""
    import re

    def key(name):
        k = re.search(r"embedding_bag_fwd_(deep|grouped)_kernelI"
                      r"(f|13__nv_bfloat16)Li(\d+)ELi(\d)E(?:Li\d+ELb([01]))?",
                      name)
        if not k:
            return None
        path = ("deep" if k.group(1) == "deep"
                else "short" if k.group(5) == "1" else "long")
        return (path, "fp32" if k.group(2) == "f" else "bf16",
                int(k.group(3)), int(k.group(4)))
    return ptxas_registers(log, key)


def dot_registers(log: str) -> dict:
    """{(fp32 | bf16, row blocks, 16-byte loads): (registers, spill bytes)}
    of B7's templates."""
    import re

    def key(name):
        k = re.search(r"dot_interaction_fwd_kernelI(f|13__nv_bfloat16)"
                      r"Li(\d+)ELb([01])E", name)
        return (("fp32" if k.group(1) == "f" else "bf16"), int(k.group(2)),
                k.group(3) == "1") if k else None
    return ptxas_registers(log, key)


B1_SHAPES = {   # (B, H, S, Dqk, Dv, n_hist, max_rel); "causal" names: no
               # targets (the history alone, under the causal mask)
    "serve B64 S80": (64, 2, 80, 32, 32, 64, 64),
    "ragged S203": (5, 3, 203, 48, 40, 150, 100),
    "wide D128 S160": (3, 2, 160, 128, 128, 140, 128),  # > 48 KB smem
    "causal S96": (4, 2, 96, 32, 32, 96, 64),
}
# the two-tower user tower (roo-esr / roo-retrieval, "hstu" mode): the
# history alone under the causal mask, at serving's top rung and a bucket
ESR_B1_SHAPES = {
    "causal ESR serve B64 S64": (64, 2, 64, 32, 32, 64, 64),
    "causal ESR bucket B13 S64": (13, 2, 64, 32, 32, 64, 64),
}


def phase_kernels(kmod, device, shapes=None) -> float:
    """Kernel vs plain version (and the chunked path) on the card, the
    kernel reached through the dispatch entry the model calls (auto
    backend), at ``shapes`` (default ``B1_SHAPES``); returns the largest
    |kernel - plain|."""
    import torch
    from repro_torch.core.hstu import hstu_attention_chunked
    from repro_torch.core.masks import roo_spec
    from repro_torch.kernels import dispatch
    shapes = B1_SHAPES if shapes is None else shapes
    worst = 0.0
    for i, (name, shape) in enumerate(shapes.items()):
        x = attention_inputs(shape, seed=i, device=device)
        if name.startswith("causal"):
            x["tc"].zero_()
        for use_rab in (True, False):
            rab = x["rab"] if use_rab else None
            spec = roo_spec(x["hl"], x["tc"], x["n_hist"])
            before = kmod.launch_count
            got = dispatch.hstu_attention(x["q"], x["k"], x["v"], rab, spec,
                                          max_rel_pos=x["max_rel"])
            if kmod.launch_count != before + 1:
                raise SystemExit("dispatch auto did not launch the kernel "
                                 "on a CUDA tensor")
            plain = kmod.hstu_attention_plain(
                x["q"], x["k"], x["v"], rab, x["n_hist"], x["hl"], x["tc"],
                x["max_rel"])
            chunked = hstu_attention_chunked(
                x["q"], x["k"], x["v"], rab, spec,
                max_rel_pos=x["max_rel"], chunk=32)
            torch.cuda.synchronize()
            err = (got - plain).abs()
            worst = max(worst, float(err.max()))
            ok = bool(torch.all(err <= ATOL + RTOL * plain.abs()))
            ok_chunk = torch.allclose(got, chunked, atol=ATOL, rtol=RTOL)
            s = x["q"].shape[2]
            dead = ~spec.dense(s).any(-1)                     # (B, S)
            zero = bool(torch.all(got.transpose(1, 2)[dead] == 0))
            finite = bool(torch.isfinite(got).all())
            print(f"[kernels] {name} rab={use_rab}: max|kernel-plain| = "
                  f"{float(err.max()):.3e} ok={ok} chunked_ok={ok_chunk} "
                  f"masked_rows_zero={zero} finite={finite} (then a second "
                  f"call, bit for bit)")
            if not (ok and ok_chunk and zero and finite):
                raise SystemExit(f"kernel disagrees with its plain version "
                                 f"at {name} rab={use_rab}")
            again = dispatch.hstu_attention(x["q"], x["k"], x["v"], rab,
                                            spec, max_rel_pos=x["max_rel"])
            if not torch.equal(got, again):
                raise SystemExit(f"two B1 calls differ at {name} "
                                 f"rab={use_rab}")
    return worst


def phase_prefix_kernels(kmod, pmod, device) -> float:
    """B4 vs its plain version (and the chunked path) on the card through
    dispatch's auto backend; its prefix-0 case vs B1. Returns the largest
    |kernel - plain|."""
    import torch
    from repro_torch.core.hstu import hstu_attention_prefix_chunked
    from repro_torch.core.masks import prefix_spec
    from repro_torch.kernels import dispatch
    # (B, H, n_hist, n_new, m, Dqk, Dv, max_rel, scale_len)
    shapes = {
        "serve n_new=1": (64, 2, 64, 1, 16, 32, 32, 64, 80),
        "serve n_new=8": (64, 2, 64, 8, 16, 32, 32, 64, 80),
        "serve n_new=64": (64, 2, 64, 64, 16, 32, 32, 64, 80),
        "ragged": (5, 3, 150, 37, 5, 48, 40, 100, 155),
        "wide D128": (3, 2, 140, 20, 20, 128, 128, 128, 160),  # > 48 KB smem
        "extend-only": (64, 2, 64, 8, 0, 32, 32, 64, 80),
    }
    worst = 0.0
    for i, (name, shape) in enumerate(shapes.items()):
        x = prefix_inputs(shape, seed=10 + i, device=device)
        spec = prefix_spec(x["pfx"], x["nc"], x["tc"], x["n_hist"],
                           x["n_new"])
        for use_rab in (True, False):
            rab = x["rab"] if use_rab else None
            before = pmod.launch_count
            got = dispatch.hstu_attention_prefix(
                x["q"], x["k"], x["v"], rab, spec,
                scale_len=x["scale_len"], max_rel_pos=x["max_rel"])
            if pmod.launch_count != before + 1:
                raise SystemExit("dispatch auto did not launch the prefix "
                                 "kernel on a CUDA tensor")
            plain = pmod.hstu_attention_prefix_plain(
                x["q"], x["k"], x["v"], rab, x["n_hist"], x["n_new"],
                x["pfx"], x["nc"], x["tc"], x["scale_len"], x["max_rel"])
            chunked = hstu_attention_prefix_chunked(
                x["q"], x["k"], x["v"], rab, spec, x["scale_len"],
                max_rel_pos=x["max_rel"], chunk=32)
            torch.cuda.synchronize()
            err = (got - plain).abs()
            worst = max(worst, float(err.max()))
            ok = bool(torch.all(err <= ATOL + RTOL * plain.abs()))
            ok_chunk = torch.allclose(got, chunked, atol=ATOL, rtol=RTOL)
            dead = ~spec.dense(got.shape[2], x["k"].shape[2]).any(-1)
            zero = bool(torch.all(got.transpose(1, 2)[dead] == 0))
            finite = bool(torch.isfinite(got).all())
            print(f"[kernels] prefix {name} rab={use_rab}: max|kernel-plain|"
                  f" = {float(err.max()):.3e} ok={ok} chunked_ok={ok_chunk} "
                  f"masked_rows_zero={zero} finite={finite} (then a second "
                  f"call, bit for bit)")
            if not (ok and ok_chunk and zero and finite):
                raise SystemExit(f"prefix kernel disagrees with its plain "
                                 f"version at {name} rab={use_rab}")
            again = dispatch.hstu_attention_prefix(
                x["q"], x["k"], x["v"], rab, spec,
                scale_len=x["scale_len"], max_rel_pos=x["max_rel"])
            if not torch.equal(got, again):
                raise SystemExit(f"two B4 calls differ at {name} "
                                 f"rab={use_rab}")

    # the unified fallback: prefix 0 and n_new == n_hist is the full ROO
    # forward, so B4 must agree with B1 on the same inputs
    x = attention_inputs((64, 2, 80, 32, 32, 64, 64), seed=7, device=device)
    zeros = torch.zeros_like(x["hl"])
    spec = prefix_spec(zeros, x["hl"], x["tc"], 64, 64)
    for use_rab in (True, False):
        rab = x["rab"] if use_rab else None
        b4 = dispatch.hstu_attention_prefix(x["q"], x["k"], x["v"], rab, spec,
                                            scale_len=80,
                                            max_rel_pos=x["max_rel"])
        b1 = kmod.hstu_attention_cuda(x["q"], x["k"], x["v"], rab, 64,
                                      x["hl"], x["tc"], x["max_rel"])
        torch.cuda.synchronize()
        diff = float((b4 - b1).abs().max())
        ok = torch.equal(b4, b1)       # one tile body, one summation order
        print(f"[kernels] prefix 0, n_new = n_hist vs B1 rab={use_rab}: "
              f"max|B4-B1| = {diff:.3e} bitwise={ok}")
        if not ok:
            raise SystemExit("the prefix kernel's full-recompute case is "
                             "not bit for bit the HSTU forward kernel")
    return worst


def bound_bwd(x, which: str) -> tuple:
    """Least time (ms) the card needs for one backward kernel call on these
    inputs, on ``bound()``'s basis. Bytes: the q, k, v and g rows the mask
    keeps, read once, rab and the lengths, and the kernel's outputs written
    once (B2: dq and drab; B3: dk and dv). FLOPs per kept cell: B2
    2 (2 Dqk + Dv) (score, g.v, dq), B3 4 (Dqk + Dv) (score, g.v, dk, dv)."""
    from repro_torch.core.masks import roo_spec
    b, h, s, dqk = x["q"].shape
    dv = x["v"].shape[-1]
    es = x["q"].element_size()
    valid_rows = int((x["hl"] + x["tc"]).sum()) * h
    n_rab = x["rab"].numel()
    outputs = (b * h * s * dqk + n_rab if which == "dq"
               else b * h * s * (dqk + dv))
    n_bytes = es * (valid_rows * 2 * (dqk + dv) + n_rab + outputs) + 4 * 2 * b
    cells = int(roo_spec(x["hl"], x["tc"], x["n_hist"]).dense(s).sum()) * h
    ops = cells * (2 * (2 * dqk + dv) if which == "dq" else 4 * (dqk + dv))
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / op_rate(x)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", n_bytes, ops)


def phase_bwd_kernels(kmod, pmod, bmod, device) -> dict:
    """B2 and B3 against their plain version on the card, reached the way
    training reaches them: autograd through dispatch's auto (cuda) rung,
    i.e. ``HSTUAttentionFn``. Returns the largest |kernel - plain| of each
    kernel's outputs."""
    import torch
    from repro_torch.core.masks import prefix_spec, roo_spec
    from repro_torch.kernels import dispatch
    shapes = {   # (B, H, S, Dqk, Dv, n_hist, max_rel)
        "train B32 S80": (32, 2, 80, 32, 32, 64, 64),
        "ragged S100": (5, 3, 100, 48, 40, 70, 100),
        "wide D128 S160": (3, 2, 160, 128, 128, 140, 128),  # > 48 KB smem
        "causal S96": (4, 2, 96, 32, 32, 96, 96),
        "clip S80 max_rel16": (8, 2, 80, 32, 32, 64, 16),
        # the tiling's edges: S no multiple of 16, D % 4 != 0 (4-byte
        # copies), a B*H at which tile_config drops the split, D 64, no
        # history row, and the userarch_hstu step's causal shape
        "ragged S81": (6, 2, 81, 32, 32, 64, 64),
        "short S17 D18/13": (7, 3, 17, 18, 13, 12, 8),
        "no split B132 S80": (132, 2, 80, 32, 32, 64, 64),
        "D64 S80": (8, 2, 80, 64, 64, 64, 64),
        "all targets S40": (6, 2, 40, 32, 32, 0, 32),
        "causal B32 S64": (32, 2, 64, 32, 32, 64, 64),
    }
    worst = {"dq": 0.0, "dkv": 0.0}
    for i, (name, shape) in enumerate(shapes.items()):
        x = attention_inputs(shape, seed=20 + i, device=device)
        if name.startswith("causal"):
            x["tc"].zero_()
        b, h, s = shape[:3]
        rows = bmod.rows_per_block(b * h, s)
        print(f"[bwd kernels] {name}: {rows} rows a block, "
              f"{4 // (rows // bmod.ROWS)}-way split")
        if name.startswith("no split") and rows != 64:
            raise SystemExit(f"{name}: tile_config kept the split")
        g = torch.randn(x["v"].shape, generator=torch.Generator(
            device=device).manual_seed(i), device=device)
        spec = roo_spec(x["hl"], x["tc"], x["n_hist"])
        for use_rab in (True, False):
            leaves = [x["q"], x["k"], x["v"]] + ([x["rab"]] if use_rab
                                                 else [])
            runs = []
            for _ in range(2):
                args = [t.detach().requires_grad_(True) for t in leaves]
                rab = args[3] if use_rab else None
                before = (kmod.launch_count, bmod.dq_launch_count,
                          bmod.dkv_launch_count)
                out = dispatch.hstu_attention(
                    args[0], args[1], args[2], rab, spec,
                    max_rel_pos=x["max_rel"])
                runs.append(torch.autograd.grad(out, args, g))
                after = (kmod.launch_count, bmod.dq_launch_count,
                         bmod.dkv_launch_count)
                if tuple(a - b for a, b in zip(after, before)) != (1, 1, 1):
                    raise SystemExit(f"{name}: autograd through dispatch did "
                                     f"not launch B1, B2 and B3 once each")
            plain = bmod.hstu_attention_bwd_plain(
                x["q"], x["k"], x["v"], x["rab"] if use_rab else None,
                x["n_hist"], x["hl"], x["tc"], x["max_rel"], g)
            torch.cuda.synchronize()
            errs, oks = {}, []
            for key, got, want, tol in zip(
                    ("dq", "dk", "dv", "drab"), runs[0], plain,
                    (ATOL, ATOL, ATOL, LOGIT_TOL)):
                err = (got - want).abs()
                errs[key] = float(err.max())
                oks.append(bool(torch.all(err <= tol + tol * want.abs())))
                worst["dq" if key in ("dq", "drab") else "dkv"] = max(
                    worst["dq" if key in ("dq", "drab") else "dkv"],
                    errs[key])
            same = all(torch.equal(a, b) for a, b in zip(*runs))
            dead_r = ~spec.dense(x["q"].shape[2]).any(-1)       # (B, S)
            dead_c = ~spec.dense(x["q"].shape[2]).any(-2)
            zero = (bool(torch.all(runs[0][0].transpose(1, 2)[dead_r] == 0))
                    and bool(torch.all(runs[0][1].transpose(1, 2)[dead_c]
                                       == 0))
                    and bool(torch.all(runs[0][2].transpose(1, 2)[dead_c]
                                       == 0)))
            finite = all(bool(torch.isfinite(a).all()) for a in runs[0])
            print(f"[bwd kernels] {name} rab={use_rab}: max|kernel-plain| "
                  + " ".join(f"{k} {v:.3e}" for k, v in errs.items())
                  + f" ok={all(oks)} bitwise_repeat={same} "
                  f"masked_zero={zero} finite={finite}")
            if not (all(oks) and same and zero and finite):
                raise SystemExit(f"backward kernels disagree with their "
                                 f"plain version at {name} rab={use_rab}")

    # the cached-prefix attention is forward only: refused under grad
    x = prefix_inputs((4, 2, 64, 8, 16, 32, 32, 64, 80), seed=30,
                      device=device)
    spec = prefix_spec(x["pfx"], x["nc"], x["tc"], x["n_hist"], x["n_new"])
    before = pmod.launch_count
    try:
        dispatch.hstu_attention_prefix(
            x["q"].requires_grad_(True), x["k"], x["v"], x["rab"], spec,
            scale_len=x["scale_len"], max_rel_pos=x["max_rel"])
    except RuntimeError as err:
        print(f"[bwd kernels] prefix rung under grad refused: {err}")
    else:
        raise SystemExit("the prefix rung ran under grad")
    if pmod.launch_count != before:
        raise SystemExit("the refused prefix call launched its kernel")
    return worst


# gr-train-long's attention (B, H, S, D, n_hist, max_rel) and its two
# requests, one full and one partial history
GR_LONG = (2, 8, 8256, 128, 8192, 8256)
GR_LONG_REQUESTS = ((8192, 64), (5003, 17))
# the traffic's short end: the most padded rows, which B1 skips
GR_LONG_SHORT = ((4096, 8), (4096, 8))
# a kernel's largest error against float64, as a share of the largest
# value: its products are 3xTF32 (fp32-accurate), but the tensor cores add
# each 8-term product into the fp32 accumulator without rounding to
# nearest, ~3 x S / 8 = 3,100 times for a row of S 8,256. On an H100 the
# kernels read 5.2e-5 to 7.3e-5 (drab 1.1e-6), the plain version 2.7e-6
# to 4.7e-6 in fp32 and 2.5e-4 to 5.8e-4 in TF32: a kernel that computed
# in TF32 fails this. A wrong rab bin shows in drab, compared bin by bin.
GR_LONG_TOL = 1.5e-4


def gr_long_inputs(device, seed=36) -> dict:
    """Random q, k, v, g (B, H, S, D), rab (H, 2 max_rel + 1) and the two
    requests' lengths at gr-train-long's attention shape."""
    import torch
    b, h, s, d, n_hist, max_rel = GR_LONG
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=device) * std
    q, k, v, g = (randn(b, h, s, d) for _ in range(4))
    rab = randn(h, 2 * max_rel + 1, std=0.1)
    hl, tc = (torch.tensor(x, device=device)
              for x in zip(*GR_LONG_REQUESTS))
    return dict(q=q, k=k, v=v, g=g, rab=rab, hl=hl, tc=tc, n_hist=n_hist,
                max_rel=max_rel)


def gr_long_dense64(q, k, v, rab, hl, tc):
    """One head's attention in float64, dense: q, k, v (B, S, D), rab
    (2 max_rel + 1,)."""
    import torch
    from repro_torch.core.masks import roo_batch_mask
    _, _, s, d, n_hist, max_rel = GR_LONG
    pos = torch.arange(s, device=q.device)
    delta = (pos[:, None] - pos[None, :]).clamp(-max_rel, max_rel) + max_rel
    scores = q @ k.transpose(1, 2) / d ** 0.5 + rab[delta]
    keep = roo_batch_mask(hl, tc, n_hist, s - n_hist)
    return (torch.nn.functional.silu(scores) / s * keep) @ v


def gr_long_with_grads(fn, q, k, v, rab, g):
    """(out, dq, dk, dv, drab) of ``fn`` by autograd."""
    q, k, v, rab = (x.detach().requires_grad_(True) for x in (q, k, v, rab))
    out = fn(q, k, v, rab)
    out.backward(g)
    return out.detach(), q.grad, k.grad, v.grad, rab.grad


def gr_long_masked_rows_zero(kmod, x, what: str) -> None:
    """B1 at ``x`` on memory the allocator last held NaN in: the rows the
    mask zeroes (padded history, target slots past the count) must come
    back exactly 0 (the output is ``torch.empty``)."""
    import torch
    from repro_torch.core.masks import roo_batch_mask
    s, n_hist = x["q"].shape[2], x["n_hist"]
    junk = torch.full_like(x["v"], float("nan"))
    held = junk.data_ptr()
    del junk
    out = kmod.hstu_attention_cuda(x["q"], x["k"], x["v"], x["rab"], n_hist,
                                   x["hl"], x["tc"], x["max_rel"])
    if out.data_ptr() != held:
        raise SystemExit(f"gr-train-long B1 ({what}): the output did not "
                         f"reuse the NaN-filled block, so its zeros test "
                         f"nothing")
    dead = ~roo_batch_mask(x["hl"], x["tc"], n_hist, s - n_hist).any(-1)
    if torch.count_nonzero(out.transpose(1, 2)[dead]):
        raise SystemExit(f"gr-train-long B1 ({what}): a row the mask zeroes "
                         f"is not exactly 0")
    print(f"[gr-train-long kernels] B1 ({what}): the {int(dead.sum())} rows "
          f"the mask zeroes are exactly 0")


def gr_long_kernel_errors(kmod, bmod, x) -> dict:
    """B1, B2 and B3 at gr-train-long's attention shape: one launch each,
    bit for bit on repeat, B1's masked rows exactly 0
    (``gr_long_masked_rows_zero``), no gradient at a negative delta (the
    mask keeps i >= j), and each output's largest error against float64
    head by head as a share of the largest value, ``{(name, head):
    share}``; beside it (printed) the plain version's in fp32 and in TF32
    (``hstu_attention_plain``, its gradients by autograd:
    ``hstu_attention_bwd_plain`` sums drab through an
    (S^2, 2 max_rel + 1) one-hot, 4.5 TB here)."""
    import torch
    q, k, v, g, rab, hl, tc = (x[n] for n in ("q", "k", "v", "g", "rab",
                                              "hl", "tc"))
    h_n, max_rel = GR_LONG[1], GR_LONG[5]
    args = (q, k, v, rab, x["n_hist"], hl, tc, max_rel)
    kmod.reset_launch_count()
    bmod.reset_launch_count()
    out = kmod.hstu_attention_cuda(*args)
    grads = bmod.hstu_attention_bwd_cuda(*args, g)
    if (kmod.launch_count, bmod.dq_launch_count,
            bmod.dkv_launch_count) != (1, 1, 1):
        raise SystemExit("gr-train-long attention: not one launch of each "
                         "of B1, B2 and B3")
    if not (torch.equal(out, kmod.hstu_attention_cuda(*args)) and all(
            torch.equal(a, b) for a, b in zip(
                grads, bmod.hstu_attention_bwd_cuda(*args, g)))):
        raise SystemExit("gr-train-long attention: not bit for bit on "
                         "repeat")
    gr_long_masked_rows_zero(kmod, x, "the cell's requests")
    if torch.count_nonzero(grads[3][:, :max_rel]):
        raise SystemExit("gr-train-long attention: drab at a negative "
                         "delta")

    def error(got, want) -> float:
        return float((got.double() - want).abs().max())
    worst = {}
    for h in range(h_n):
        q1, k1, v1, g1 = (t[:, h:h + 1].contiguous() for t in (q, k, v, g))

        def plain(tf32):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            try:
                got = gr_long_with_grads(lambda *t: kmod.hstu_attention_plain(
                    *t, x["n_hist"], hl, tc, max_rel), q1, k1, v1,
                    rab[h:h + 1].contiguous(), g1)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            return (*(t[:, 0] for t in got[:4]), got[4][0])
        p32, ptf = plain(False), plain(True)
        want = gr_long_with_grads(
            lambda *t: gr_long_dense64(*t, hl, tc),
            *(t[:, 0].double() for t in (q1, k1, v1)), rab[h].double(),
            g1[:, 0].double())
        kern = (out[:, h], *(t[:, h] for t in grads[:3]), grads[3][h])
        for name, a, p, t, w in zip(("out", "dq", "dk", "dv", "drab"), kern,
                                    p32, ptf, want):
            top = float(w.abs().max())
            share = [error(e, w) / top for e in (a, p, t)]
            print(f"[gr-train-long kernels] {name} h{h}: from float64, of "
                  f"the largest |value| {top:.3e}: kernel {share[0]:.2e}, "
                  f"plain fp32 {share[1]:.2e}, plain TF32 {share[2]:.2e}")
            worst[name, h] = share[0]
        del p32, ptf, want
    return worst


def gr_long_fwd_error(kmod, x, what: str) -> float:
    """B1 alone at ``x``: its largest error against float64, head by head,
    as a share of the largest value (the forward half of
    ``gr_long_kernel_errors``, for a request mix the step's backward is
    not checked at)."""
    q, k, v, rab, hl, tc = (x[n] for n in ("q", "k", "v", "rab", "hl",
                                           "tc"))
    out = kmod.hstu_attention_cuda(q, k, v, rab, x["n_hist"], hl, tc,
                                   x["max_rel"])
    worst = 0.0
    for h in range(q.shape[1]):
        want = gr_long_dense64(*(t[:, h].double() for t in (q, k, v)),
                               rab[h].double(), hl, tc)
        top = float(want.abs().max())
        share = float((out[:, h].double() - want).abs().max()) / top
        print(f"[gr-train-long kernels] out ({what}) h{h}: from float64, "
              f"of the largest |value| {top:.3e}: kernel {share:.2e}")
        worst = max(worst, share)
        del want
    return worst


def phase_gr_long_kernels(kmod, bmod, device, card: str) -> dict:
    """B1, B2 and B3 at gr-train-long's attention shape (B 2, H 8,
    S 8,256, D 128, ``max_rel_pos`` 8,256) against float64 within
    ``GR_LONG_TOL`` of the largest value (``gr_long_kernel_errors``), then
    timed, each beside its bound; B1 also at the traffic's short end
    (``GR_LONG_SHORT``: its masked rows exactly 0, its output against
    float64 within the same share, ``gr_long_fwd_error``), with its shared
    memory a block and the occupancy query's blocks an SM. Returns ``{"b1" |
    "b1_short" | "dq" | "dkv": entry}`` for the kernels line."""
    import torch
    x = gr_long_inputs(device)
    worst = gr_long_kernel_errors(kmod, bmod, x)
    bad = {f"{n} h{h}": e for (n, h), e in worst.items()
           if not e <= GR_LONG_TOL}
    if bad:
        raise SystemExit(f"gr-train-long attention past {GR_LONG_TOL} of "
                         f"the largest value: {bad}")
    args = (x["q"], x["k"], x["v"], x["rab"], x["n_hist"], x["hl"], x["tc"],
            x["max_rel"])
    short = dict(x, **{n: torch.tensor(t, device=device) for n, t in
                       zip(("hl", "tc"), zip(*GR_LONG_SHORT))})
    gr_long_masked_rows_zero(kmod, short, "the short end")
    worst["short", 0] = gr_long_fwd_error(kmod, short, "the short end")
    if not worst["short", 0] <= GR_LONG_TOL:
        raise SystemExit(f"gr-train-long B1 at the short end past "
                         f"{GR_LONG_TOL} of the largest value: "
                         f"{worst['short', 0]:.2e}")
    short_args = (*args[:5], short["hl"], short["tc"], x["max_rel"])
    b, h, s, d, _, max_rel = GR_LONG
    blocks, smem = kmod.occupancy(b, h, s, d, d, max_rel)
    print(f"[gr-train-long kernels] {card}: b1 {smem:,} B of shared memory "
          f"a block, {blocks} blocks an SM (the occupancy query)")
    out = {}
    for key, fn, names, how in (
            ("b1", lambda: kmod.hstu_attention_cuda(*args), ("out",),
             bound(x)),
            ("b1_short", lambda: kmod.hstu_attention_cuda(*short_args),
             ("short",), bound(short)),
            ("dq", lambda: bmod.hstu_attention_bwd_dq_cuda(*args, x["g"]),
             ("dq", "drab"), bound_bwd(x, "dq")),
            ("dkv", lambda: bmod.hstu_attention_bwd_dkv_cuda(*args, x["g"]),
             ("dk", "dv"), bound_bwd(x, "dkv"))):
        ms = device_ms(fn, 3)
        out[key] = {"max_err_of_largest": max(
            e for (n, _), e in worst.items() if n in names),
            "ms": ms, "bound_ms": how[0], "bound_by": how[1],
            "plain_ms": None}
        if key.startswith("b1"):
            out[key].update(smem_bytes=smem, blocks_per_sm=blocks)
        print(f"[gr-train-long kernels] {card}: {key} {ms:.3f} ms, bound "
              f"{how[0]:.3f} ms ({how[1]}), "
              f"{100 * how[0] / ms:.2f} % of it")
    return out


def gr_long_step(device, n_items: int):
    """One sparse-row training step of gr-train-long's configuration (its
    item table cut to ``n_items`` rows: no launch depends on it) through
    its driver's scenario and pool and the program's ``Trainer``. Returns
    (the configuration, the step's requests)."""
    import torch
    from repro_torch.scenario.build import build_model
    from repro_torch.train.loop import Trainer, TrainLoopConfig
    from repro_torch.train.optim import (adam, default_is_embedding,
                                         make_mixed, rowwise_adagrad)
    from repro_torch.tree import tree_map
    from roobench import harness, weights
    from roobench.drivers import gr_train
    _, cfg, tr = harness.resolve(harness.load_bench(), "gr-train-long")
    cfg["n_items"], tr["pool_batches"] = n_items, 1
    spec = gr_train.spec(cfg, tr)
    batches, groups, _ = gr_train.pool(36, cfg, tr, spec)
    bundle = build_model(spec, torch.Generator(), sparse=True,
                         device=device, params=weights.gr(36, cfg, device))
    held = [bundle.params]
    o = cfg["optimizer"]
    trainer = Trainer(bundle.loss_fn,
                      make_mixed(adam(o["adam"]["lr"]),
                                 rowwise_adagrad(o["rowwise_adagrad"]["lr"]),
                                 default_is_embedding),
                      TrainLoopConfig(total_steps=1, log_every=10),
                      lambda: held.pop(), value_and_grad_fn=bundle.vag_fn,
                      device=device)
    batch = tree_map(lambda t: t.to(device), batches[0])
    trainer.run(lambda start: iter([batch]), seed=36)
    torch.cuda.synchronize()
    return cfg, groups[0]


def gr_long_entries(kern: dict, launches: dict) -> list:
    """The kernels line's entries for B1, B2 and B3 at gr-train-long's
    shape: ``phase_gr_long_kernels``' errors, times and bounds beside a
    step's launches (``phase_gr_long_step``; the step never runs the short
    end's mix, so that entry has none)."""
    shape = "B 2, H 8, S 8,256, D 128, max_rel_pos 8,256"
    return [{
        "name": f"{name} (gr-train-long: {shape})", "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{src}",
        "replaces": f"src/repro/kernels/hstu_attention.py:{line}",
        "launches": launches[key] if key else None, **kern[which],
        "library_ms": None}
        for name, src, line, key, which in (
            ("hstu_attention_fwd", "hstu_attention_fwd.cu", 80, "b1", "b1"),
            ("hstu_attention_fwd, histories 4,096 + 4,096",
             "hstu_attention_fwd.cu", 80, None, "b1_short"),
            ("hstu_attention_bwd_dq", "hstu_attention_bwd.cu", 108, "b2",
             "dq"),
            ("hstu_attention_bwd_dkv", "hstu_attention_bwd.cu", 170, "b3",
             "dkv"))]


def phase_gr_long_step(mods, smod, device) -> dict:
    """One gr-train-long step (``gr_long_step``) launches B1 once a layer
    (one step: no logging forward), B2 and B3 once each a layer, the
    history's item merge (16,384 ids) on the segment route and nothing
    else of the port's kernels. Returns its launches."""
    reset_counts(mods + (smod,))
    cfg, _ = gr_long_step(device, 1 << 20)
    got = {**all_counts(mods), "merge": smod.launch_count}
    n = cfg["n_layers"]
    want = dict(b1=n, b2=n, b3=n, b4=0, b5=0, b6=0, b7=0, merge=1)
    print(f"[gr-train-long step] launches {got}")
    if got != want:
        raise SystemExit(f"a gr-train-long step launched {got}, not {want}")
    return got


@functools.lru_cache(maxsize=None)
def train_batches(n_items: int, hist_len: int) -> list:
    """The scenario's simulated stream (800 requests, 200 users) packed
    into 32-request / 192-impression batches on the host (made once per
    width; callers only read them)."""
    from repro_torch.core.joiner import RequestLevelJoiner
    from repro_torch.data.batcher import BatcherConfig, ROOBatcher
    from repro_torch.data.events import EventSimulator, EventStreamConfig
    samples = RequestLevelJoiner().join(list(EventSimulator(
        EventStreamConfig(n_requests=800, n_users=200, n_items=n_items,
                          hist_init_max=48, seed=0)).stream()))
    return list(ROOBatcher(BatcherConfig(b_ro=32, b_nro=192,
                                         hist_len=hist_len),
                           device="cpu").batches(samples))


def mixed_optimizer():
    """The scenario's optimizer: Adam on dense weights, row-wise Adagrad on
    the tables."""
    from repro_torch.train.optim import (adam, default_is_embedding,
                                         make_mixed, rowwise_adagrad)
    return make_mixed(adam(1e-3), rowwise_adagrad(0.05), default_is_embedding)


def train_setup(device, attn_backend=None):
    """hstu-gr at gr_config width with seeded random params, the
    scenario's optimizer and NE metric, and the train batches."""
    import dataclasses
    import torch
    from repro_torch.configs.roo_models import gr_config
    from repro_torch.models.gr import (gr_init, gr_ranking_logits,
                                       gr_ranking_loss)
    from repro_torch.train.metrics import make_ne_metrics
    cfg = gr_config()
    cfg = dataclasses.replace(cfg, hstu=dataclasses.replace(
        cfg.hstu, attn_backend=attn_backend))
    return dict(
        cfg=cfg, batches=train_batches(cfg.n_items, cfg.hist_len),
        loss=lambda p, b, gen: gr_ranking_loss(p, cfg, b),
        opt=mixed_optimizer(),
        init=lambda: gr_init(torch.Generator().manual_seed(0), cfg,
                             device=device),
        ne=make_ne_metrics(lambda p, b: (gr_ranking_logits(p, cfg, b)[:, 0],
                                         b.labels[:, 0],
                                         b.impression_mask())))


def lsr_train_setup(device, mode="userarch", attn_backend=None):
    """roo-lsr at lsr_config width in ``mode``, otherwise as
    :func:`train_setup`."""
    import torch
    from repro_torch.configs.roo_models import lsr_config
    from repro_torch.models.lsr import lsr_init, lsr_logits_roo, lsr_loss
    from repro_torch.train.metrics import make_ne_metrics
    cfg = lsr_config(mode, attn_backend)
    return dict(
        cfg=cfg, batches=train_batches(cfg.n_items, cfg.hist_len),
        loss=lambda p, b, gen: lsr_loss(p, cfg, b),
        opt=mixed_optimizer(),
        init=lambda: lsr_init(torch.Generator().manual_seed(0), cfg,
                              device=device),
        ne=make_ne_metrics(lambda p, b: (lsr_logits_roo(p, cfg, b)[:, 0],
                                         b.labels[:, 0],
                                         b.impression_mask())))


def batch_to(batch, device):
    """A ROOBatch, or a dlrm field dict of tensors, on ``device``."""
    if isinstance(batch, dict):
        return {k: v.to(device) for k, v in batch.items()}
    return batch.to(device)


def run_trainer(setup, device, steps=20, log_every=10, ckpt_dir=None,
                stop_after=None, halt_after_skips=1, peaks=None):
    """One Trainer run over the setup's batches (copied to ``device`` per
    step); returns (trainer, final state, per-step losses). A setup with
    ``table_ids`` trains on sparse rows (``make_sparse_value_and_grad``),
    calling its ``before_step(params, batch)``, if any, on each step's
    full params under no_grad. A setup's ``shadow(params, batch, gen)``
    runs under no_grad on each step's params (detached; the full params on
    sparse rows) with a generator in the step's generator's state. With
    ``peaks`` (a dict) the card's peak memory is read during
    ``Trainer.init_state`` (``peaks["init"]``) and over the steps after it
    (``peaks["steps"]``): the state's copy of the caller's tree shows in
    the first alone."""
    import torch
    from repro_torch.embeddings.sparse import make_sparse_value_and_grad
    from repro_torch.train.loop import Trainer, TrainLoopConfig
    from repro_torch.tree import tree_map
    losses = []
    sparse = "table_ids" in setup
    shadow = setup.get("shadow")

    def loss_fn(p, b, gen):
        if shadow is not None and not sparse:
            with torch.no_grad():
                shadow(tree_map(lambda x: x.detach(), p), b, clone_gen(gen))
        loss = setup["loss"](p, b, gen)
        losses.append(loss.detach())
        return loss

    vag = None
    if sparse:
        sparse_vag = make_sparse_value_and_grad(loss_fn, setup["table_ids"])
        before = setup.get("before_step")

        def vag(p, b, gen):
            with torch.no_grad():
                if before is not None:
                    before(p, b)
                if shadow is not None:
                    shadow(p, b, clone_gen(gen))
            return sparse_vag(p, b, gen)

    batches = setup["batches"]

    def batch_iter(start):
        step = start
        while True:
            yield batch_to(batches[step % len(batches)], device)
            step += 1

    trainer = Trainer(loss_fn, setup["opt"], TrainLoopConfig(
        total_steps=steps, log_every=log_every, ckpt_dir=ckpt_dir,
        ckpt_every=4, halt_after_skips=halt_after_skips), setup["init"],
        value_and_grad_fn=vag, metrics_fn=setup.get("ne"), device=device)
    if peaks is not None:
        init_state = trainer.init_state

        def measured_init(seed=0):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            state = init_state(seed)
            torch.cuda.synchronize()
            peaks["init"] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            return state
        trainer.init_state = measured_init
    state = trainer.run(batch_iter, 0, stop_after=stop_after)
    if peaks is not None:
        torch.cuda.synchronize()
        peaks["steps"] = torch.cuda.max_memory_allocated()
    return trainer, state, torch.stack(losses).cpu()


def clone_gen(gen):
    """A generator in ``gen``'s state (None stays None): a shadow loss
    draws what the step's loss draws, and the step's generator does not
    move."""
    import torch
    if gen is None:
        return None
    twin = torch.Generator(device=gen.device)
    twin.set_state(gen.get_state())
    return twin


def phase_train(kmod, pmod, bmod, device, card: str) -> dict:
    import shutil
    import numpy as np
    import torch
    from repro_torch.interop import params_to_numpy
    from repro_torch.train.loop import value_and_grad
    from repro_torch.tree import leaves
    setup = train_setup(device)
    cfg, steps = setup["cfg"], 20
    n_layers = cfg.hstu.n_layers
    print(f"[train] hstu-gr d_model={cfg.hstu.d_model} heads="
          f"{cfg.hstu.n_heads} layers={n_layers} hist={cfg.hist_len} "
          f"m={cfg.m_targets} items={cfg.n_items}; {len(setup['batches'])} "
          f"batches of 32 requests / 192 impressions; {steps} steps")
    for mod in (kmod, pmod, bmod):
        mod.reset_launch_count()
    trainer, state, losses = run_trainer(setup, device, steps)
    torch.cuda.synchronize()
    launches = dict(b1=kmod.launch_count, b2=bmod.dq_launch_count,
                    b3=bmod.dkv_launch_count, b4=pmod.launch_count)
    n_metric = sum(1 for row in trainer.history if "ne" in row)
    print(f"[train] launches B1 {launches['b1']} B2 {launches['b2']} B3 "
          f"{launches['b3']} B4 {launches['b4']}; {n_metric} NE forwards; "
          f"history {trainer.history}")
    if launches["b2"] != n_layers * steps or launches["b3"] != launches["b2"] \
            or launches["b1"] != n_layers * (steps + n_metric) \
            or launches["b4"] or n_metric != steps // 10:
        raise SystemExit("train: launch counts are not B2 = B3 = n_layers x "
                         "steps, B1 = n_layers x (steps + NE forwards), B4 0")
    if int(state["step"]) != steps or len(losses) != steps \
            or not bool(torch.isfinite(losses).all()):
        raise SystemExit("train: wrong step count or a non-finite loss")

    # the same run on torch-dense (card) and torch-chunked (CPU)
    for mod in (kmod, pmod, bmod):
        mod.reset_launch_count()
    _, dense_state, dense_losses = run_trainer(
        train_setup(device, "torch-dense"), device, steps)
    if kmod.launch_count or bmod.dq_launch_count or bmod.dkv_launch_count:
        raise SystemExit("train: the torch-dense run launched a kernel")
    _, _, cpu_losses = run_trainer(train_setup("cpu"), "cpu", steps)
    for what, other in (("torch-dense on the card", dense_losses),
                        ("torch-chunked on the CPU", cpu_losses)):
        diff = float((losses - other).abs().max())
        ok = torch.allclose(losses, other, atol=1e-6, rtol=LOSS_TOL)
        print(f"[train] per-step losses vs {what}: max|diff| {diff:.3e} "
              f"ok={ok}")
        if not ok:
            raise SystemExit(f"train: losses disagree with {what}")
    print(f"[train] losses {[round(float(v), 6) for v in losses]}")

    # the w_uvqk gradient after 20 steps: kernels vs torch-dense on the
    # same params and batch
    params = state["params"]
    batch = setup["batches"][steps % len(setup["batches"])].to(device)
    grads = {}
    for name, s in (("cuda", setup), ("dense", train_setup(device,
                                                           "torch-dense"))):
        _, g = value_and_grad(s["loss"])(params, batch, None)
        grads[name] = g["hstu"]["layers"]
    diff = max(float((a["w_uvqk"] - b["w_uvqk"]).abs().max())
               for a, b in zip(grads["cuda"], grads["dense"]))
    ok = all(torch.allclose(a["w_uvqk"], b["w_uvqk"], atol=LOGIT_TOL,
                            rtol=LOGIT_TOL)
             for a, b in zip(grads["cuda"], grads["dense"]))
    print(f"[train] w_uvqk gradient after {steps} steps, kernels vs "
          f"torch-dense: max|diff| {diff:.3e} ok={ok}")
    if not ok:
        raise SystemExit("train: the w_uvqk gradient disagrees with the "
                         "torch-dense backward")

    # kill at step 12, restart from the checkpoint, end where the
    # uninterrupted run ended
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    run_trainer(setup, device, steps, ckpt_dir=str(ckpt_dir), stop_after=12)
    _, resumed, _ = run_trainer(setup, device, steps, ckpt_dir=str(ckpt_dir))
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    a, b = params_to_numpy(state["params"]), params_to_numpy(
        resumed["params"])
    diff = max(float(np.abs(x - y).max()) for x, y in zip(leaves(a),
                                                         leaves(b)))
    print(f"[train] kill at step 12 + restart vs uninterrupted: final "
          f"params max|diff| {diff:.3e} (tolerance {PARAM_TOL})")
    if int(resumed["step"]) != steps or diff > PARAM_TOL:
        raise SystemExit("train: the restarted run did not end at the "
                         "uninterrupted run's params")

    # throughput, and where a step's time goes
    run_trainer(setup, device, steps, halt_after_skips=0)        # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_trainer(setup, device, steps, halt_after_skips=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    req_per_batch = float(np.mean([
        int(b.request_mask().sum()) for b in setup["batches"][:steps]]))
    print(f"[train] {card}: {steps} steps in {wall * 1e3:.1f} ms "
          f"({steps / wall:.2f} steps/s, {steps * req_per_batch / wall:.1f} "
          f"requests/s; Trainer.run incl. init and 2 NE forwards)")
    breakdown = step_breakdown(setup, device, state)
    for rnd, parts in enumerate(breakdown):
        print(f"[train] {card}: breakdown {rnd + 1} (ms per step, card "
              f"synchronised after each stage): "
              + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))
    return dict(launches=launches, steps_per_s=steps / wall,
                requests_per_s=steps * req_per_batch / wall)


def step_breakdown(setup, device, state, steps=10, rounds=2) -> list:
    """Per-step time of the train step's stages, host clocks around work
    that ends in a synchronize: host batch copy, forward, backward,
    optimizer (update + the non-finite guard). A setup with ``table_ids``
    runs the sparse step: the gathers count to the forward, and the
    optimizer writes the touched rows in place (the state's tables
    change)."""
    import torch
    from repro_torch.embeddings.sparse import sparse_forward, sparse_grads
    from repro_torch.tree import leaves, tree_map, unflatten
    opt = setup["opt"]
    sparse = "table_ids" in setup
    out = []
    for _ in range(rounds):
        params, opt_state = state["params"], state["opt"]
        acc = dict.fromkeys(("batch copy", "forward", "backward",
                             "optimizer"), 0.0)
        for i in range(steps):
            t0 = time.perf_counter()
            batch = batch_to(setup["batches"][i % len(setup["batches"])],
                             device)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if sparse:
                loss, tape = sparse_forward(setup["loss"],
                                            setup["table_ids"], params,
                                            batch, None)
            else:
                flat = [p.detach().requires_grad_(True)
                        for p in leaves(params)]
                loss = setup["loss"](unflatten(params, flat), batch, None)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if sparse:
                grads = sparse_grads(loss, tape)
            else:
                grads = unflatten(params, [
                    torch.zeros_like(p) if g is None else g
                    for p, g in zip(flat, torch.autograd.grad(
                        loss, flat, allow_unused=True))])
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            ok = torch.isfinite(loss)
            new_p, new_s = opt.update(grads, opt_state, params,
                                      **({"ok": ok} if sparse else {}))
            keep = lambda n, o: n if n is o else torch.where(ok, n, o)
            params = tree_map(keep, new_p, params)
            opt_state = tree_map(keep, new_s, opt_state)
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            for key, dt in zip(acc, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                acc[key] += dt
        parts = {k: v * 1e3 / steps for k, v in acc.items()}
        parts["total"] = sum(parts.values())
        out.append(parts)
    return out


def make_requests(cfg, n_requests):
    from repro_torch.core.joiner import RequestLevelJoiner
    from repro_torch.data.events import EventSimulator, EventStreamConfig
    evs = EventSimulator(EventStreamConfig(
        n_requests=n_requests, n_items=cfg.n_items,
        hist_init_max=cfg.hist_len, seed=0)).stream()
    return RequestLevelJoiner().join(evs)


def phase_serve(kmod, device) -> dict:
    import numpy as np
    import torch
    from repro_torch.configs.roo_models import gr_config
    from repro_torch.interop import params_from_numpy, params_to_numpy
    from repro_torch.models.gr import gr_init, gr_ranking_logits
    from repro_torch.serve.engine import ScoreError
    from repro_torch.serve.serving import ROOServer, ServeConfig

    cfg = gr_config()
    params = gr_init(torch.Generator().manual_seed(0), cfg, device=device)
    score = lambda p, b: gr_ranking_logits(p, cfg, b)
    requests = make_requests(cfg, 1000)
    print(f"[serve] hstu-gr d_model={cfg.hstu.d_model} heads="
          f"{cfg.hstu.n_heads} layers={cfg.hstu.n_layers} hist="
          f"{cfg.hist_len} m={cfg.m_targets} items={cfg.n_items}; "
          f"{len(requests)} requests, "
          f"{sum(r.num_impressions for r in requests)} impressions")

    serve_cfg = ServeConfig(b_ro=64, b_nro=512, hist_len=cfg.hist_len)
    ROOServer(params, score, serve_cfg, device=device).score_requests(
        requests[:80])                                  # warm-up
    torch.cuda.synchronize()

    server = ROOServer(params, score, serve_cfg, device=device)
    kmod.reset_launch_count()
    t0 = time.perf_counter()
    scores = server.score_requests(requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kmod.launch_count
    st = server.stats
    print(f"[serve] {len(requests)} requests in {wall * 1e3:.1f} ms "
          f"({len(requests) / wall:.1f} requests/s), {st.n_batches} batches "
          f"{st.buckets.snapshot()['counts']}, kernel launches {launches}")

    errors = [s for s in scores if isinstance(s, ScoreError)]
    if errors or st.n_failed_batches:
        raise SystemExit(f"{len(errors)} ScoreError(s), "
                         f"{st.n_failed_batches} failed batch(es): "
                         f"{errors[:1]}")
    if len(scores) != len(requests) or any(
            s.shape != (r.num_impressions, cfg.n_tasks)
            or not np.isfinite(s).all() for r, s in zip(requests, scores)):
        raise SystemExit("scores misaligned with requests or not finite")
    if launches != cfg.hstu.n_layers * st.n_batches or launches == 0:
        raise SystemExit(f"kernel launches {launches} != n_layers x "
                         f"n_batches = {cfg.hstu.n_layers * st.n_batches}")

    # where the serving time goes: host packing + copy vs the forward,
    # measured twice, before the CPU comparison below can load the host
    from repro_torch.data.batcher import BatcherConfig, ROOBatcher
    packer = ROOBatcher(BatcherConfig(b_ro=64, b_nro=512,
                                      hist_len=cfg.hist_len), device=device)
    for _ in range(2):
        t0 = time.perf_counter()
        batches = list(packer.batches(requests))
        torch.cuda.synchronize()
        pack_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with torch.inference_mode():
            for b in batches:
                score(params, b).to("cpu")
        fwd_s = time.perf_counter() - t0
        print(f"[serve] breakdown over {len(batches)} top-rung batches: "
              f"pack + copy to card {pack_s * 1e3:.1f} ms, forward + copy "
              f"back {fwd_s * 1e3:.1f} ms; engine total {wall * 1e3:.1f} ms")

    before = kmod.launch_count
    dense = ROOServer(params, score, ServeConfig(
        b_ro=64, b_nro=512, hist_len=cfg.hist_len,
        attn_backend="torch-dense"), device=device).score_requests(requests)
    if kmod.launch_count != before:
        raise SystemExit("the torch-dense server launched the kernel")
    diff = max(float(np.abs(a - b).max(initial=0.0))
               for a, b in zip(scores, dense))
    ok = all(np.allclose(a, b, atol=LOGIT_TOL, rtol=LOGIT_TOL)
             for a, b in zip(scores, dense))
    print(f"[serve] max|cuda - torch-dense| over scores = {diff:.3e} "
          f"ok={ok}")
    if not ok:
        raise SystemExit("served scores disagree with the torch-dense run")

    cpu_params = params_from_numpy(params_to_numpy(params), "cpu")
    cpu = ROOServer(cpu_params, score, serve_cfg,
                    device="cpu").score_requests(requests[:48])
    diff_cpu = max(float(np.abs(a - b).max(initial=0.0))
                   for a, b in zip(scores[:48], cpu))
    ok_cpu = all(np.allclose(a, b, atol=LOGIT_TOL, rtol=LOGIT_TOL)
                 for a, b in zip(scores[:48], cpu))
    print(f"[serve] max|card - CPU torch-chunked| over 48 requests = "
          f"{diff_cpu:.3e} ok={ok_cpu}")
    if not ok_cpu:
        raise SystemExit("served scores disagree with the CPU server")

    return dict(launches=launches, requests_per_s=len(requests) / wall,
                n_batches=st.n_batches, cfg=cfg, params=params, score=score,
                requests=requests, scores=scores)


def max_diff_ok(got, want, what: str, tol: float = LOGIT_TOL) -> float:
    """Largest |got - want| over aligned score lists; fails beyond ``tol``
    (atol and rtol; 1e-4 by default)."""
    import numpy as np
    from repro_torch.serve.engine import ScoreError
    if len(got) != len(want) or any(isinstance(g, ScoreError)
                                    for g in got):
        raise SystemExit(f"{what}: misaligned results or a ScoreError")
    diff = max(float(np.abs(a - b).max(initial=0.0))
               for a, b in zip(got, want))
    if not all(a.shape == b.shape and np.allclose(a, b, atol=tol, rtol=tol)
               for a, b in zip(got, want)):
        raise SystemExit(f"{what}: scores disagree (max |diff| {diff:.3e})")
    return diff


def repeat_waves(cfg, n_users=64, n_waves=4, seed=1):
    """Repeat traffic: ``n_users`` users, each of ``n_waves`` waves appends
    1-8 events to every user's history (which stays inside the hist_len
    window) and asks for 1-8 candidates; one request per user per wave."""
    import numpy as np
    from repro_torch.core.joiner import ROOSample
    rng = np.random.default_rng(seed)
    start_max = cfg.hist_len - 8 * (n_waves - 1)
    hists = [list(rng.integers(1, cfg.n_items,
                               size=int(rng.integers(0, start_max + 1))))
             for _ in range(n_users)]
    waves = []
    for w in range(n_waves):
        reqs = []
        for u in range(n_users):
            if w:
                hists[u] = hists[u] + list(rng.integers(
                    1, cfg.n_items, size=int(rng.integers(1, 9))))
            items = [int(i) for i in rng.integers(
                1, cfg.n_items, size=int(rng.integers(1, 9)))]
            hist = [int(i) for i in hists[u]]
            reqs.append(ROOSample(
                request_id=w * n_users + u, user_id=u,
                ro_dense=np.full((8,), float(u), np.float32),
                ro_idlist=[1 + u % 7], history_ids=hist,
                history_actions=[i % 4 for i in hist], item_ids=items,
                item_dense=[np.zeros((8,), np.float32) for _ in items],
                item_idlist=[[1 + i % 7] for i in items],
                labels=[{"click": 0.0, "view_sec": 0.0} for _ in items]))
        waves.append(reqs)
    return waves


def incremental_engine(serve, device, capacity=4096):
    """The state-store engine for hstu-gr at the stateless server's
    admission policy and bucket ladder."""
    from repro_torch.models.gr import (gr_extend_user_state,
                                       gr_score_from_state, gr_state_init)
    from repro_torch.serve.adapter import ServeAdapter
    from repro_torch.serve.bucketing import BucketLadder
    from repro_torch.serve.engine import EnginePolicy, ScoringEngine
    from repro_torch.serve.user_cache import UserStateStore
    cfg = serve["cfg"]
    adapter = ServeAdapter(
        score=serve["score"],
        init_user_state=lambda: gr_state_init(cfg, device=device),
        extend_user_state=lambda p, b, s, *, n_new:
            gr_extend_user_state(p, cfg, b, s, n_new=n_new),
        score_from_state=lambda p, b, s, *, n_new:
            gr_score_from_state(p, cfg, b, s, n_new=n_new),
        state_hist_len=cfg.hist_len)
    return ScoringEngine(
        serve["params"], adapter=adapter,
        policy=EnginePolicy(max_requests=64, max_impressions=512,
                            hist_len=cfg.hist_len),
        ladder=BucketLadder.geometric(min_b_ro=4, min_b_nro=32,
                                      max_b_ro=64, max_b_nro=512),
        state_store=UserStateStore(capacity), device=device)


def serve_waves(engine, waves):
    """One score_requests call per wave; returns (scores, wall seconds)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores = [s for wave in waves for s in engine.score_requests(wave)]
    torch.cuda.synchronize()
    return scores, time.perf_counter() - t0


def timed_breakdown(engine, waves) -> dict:
    """Serve ``waves`` through ``engine`` with each stage of the
    incremental path wrapped in host timers (the card is synchronised at
    the end of each device stage); returns seconds per stage."""
    import dataclasses
    import torch
    acc = {"probe": 0.0, "stack + copy to card": 0.0, "forward": 0.0,
           "copy back": 0.0, "store writes": 0.0}

    def timed(name, fn, sync):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            acc[name] += time.perf_counter() - t0
            return out
        return run

    store = engine.state_store
    store.probe = timed("probe", store.probe, False)
    store.put = timed("store writes", store.put, False)
    engine._stack_states = timed("stack + copy to card",
                                 engine._stack_states, True)
    engine._states_to_host = timed("copy back", engine._states_to_host,
                                   False)
    engine.adapter = dataclasses.replace(
        engine.adapter, score_from_state=timed(
            "forward", engine.adapter.score_from_state, True))
    _, wall = serve_waves(engine, waves)
    acc["rest (pack, batch copy, scores back, engine)"] = \
        wall - sum(acc.values())
    acc["total"] = wall
    return acc


def phase_incremental(kmod, pmod, device, serve) -> dict:
    """Incremental serving at gr_config width: repeat traffic and the
    simulated stream through the state-store engine on the card."""
    from repro_torch.serve.serving import ROOServer, ServeConfig
    cfg = serve["cfg"]
    n_layers = cfg.hstu.n_layers
    waves = repeat_waves(cfg)
    n_req = sum(len(w) for w in waves)
    stateless = ROOServer(serve["params"], serve["score"], ServeConfig(
        b_ro=64, b_nro=512, hist_len=cfg.hist_len), device=device)
    want, stateless_s = serve_waves(stateless, waves)
    serve_waves(incremental_engine(serve, device), waves)      # warm-up

    engine = incremental_engine(serve, device)
    kmod.reset_launch_count()
    pmod.reset_launch_count()
    got, wall = serve_waves(engine, waves)
    b1, b4 = kmod.launch_count, pmod.launch_count
    st, ss = engine.stats, engine.state_store.stats
    print(f"[incremental] repeat traffic: {len(waves)} waves x "
          f"{len(waves[0])} users, {st.n_batches} batches, hits {ss.hits} "
          f"misses {ss.misses} prefix_mismatches {ss.prefix_mismatches}; "
          f"launches B4 {b4} B1 {b1}; failed batches "
          f"{st.n_failed_batches}")
    if st.n_failed_batches or ss.prefix_mismatches \
            or ss.hits != len(waves[0]) * (len(waves) - 1):
        raise SystemExit("repeat traffic: failed batches, or hits != "
                         "users x repeat waves, or a prefix mismatch")
    if b4 != n_layers * st.n_batches or b4 == 0 or b1 != 0 \
            or st.n_incremental_batches != st.n_batches:
        raise SystemExit(f"repeat traffic: B4 launches {b4} != n_layers x "
                         f"n_batches = {n_layers * st.n_batches}, or B1 "
                         f"launched {b1} times")
    diff = max_diff_ok(got, want, "incremental vs stateless server")
    print(f"[incremental] max|incremental - stateless| over scores = "
          f"{diff:.3e}")
    print(f"[incremental] {n_req} requests: incremental {wall * 1e3:.1f} ms "
          f"({n_req / wall:.1f} requests/s), stateless server "
          f"{stateless_s * 1e3:.1f} ms ({n_req / stateless_s:.1f} "
          f"requests/s)")
    for rnd in range(2):
        parts = timed_breakdown(incremental_engine(serve, device), waves)
        print(f"[incremental] breakdown {rnd + 1} (ms over {len(waves)} "
              f"batches): " + ", ".join(f"{k} {v * 1e3:.2f}"
                                         for k, v in parts.items()))

    stream = incremental_engine(serve, device)
    kmod.reset_launch_count()
    pmod.reset_launch_count()
    got_stream, stream_s = serve_waves(stream, [serve["requests"]])
    ss, st = stream.state_store.stats, stream.stats
    diff_stream = max_diff_ok(got_stream, serve["scores"],
                              "incremental stream vs stateless server")
    print(f"[incremental] stream: {len(serve['requests'])} requests in "
          f"{stream_s * 1e3:.1f} ms, {st.n_batches} batches, hits {ss.hits} "
          f"misses {ss.misses} prefix_mismatches {ss.prefix_mismatches}; "
          f"launches B4 {pmod.launch_count} B1 {kmod.launch_count}; "
          f"max|incremental - stateless| = {diff_stream:.3e}")
    if pmod.launch_count != n_layers * st.n_batches or kmod.launch_count \
            or st.n_failed_batches:
        raise SystemExit("stream: wrong launch counts or a failed batch")
    return dict(launches=b4, requests_per_s=n_req / wall,
                stateless_requests_per_s=n_req / stateless_s)


def phase_cache(kmod, pmod, device, serve) -> None:
    """ROOServer with the user-tower cache serves the stream twice."""
    from repro_torch.models.gr import (gr_history_repr,
                                       gr_ranking_logits_from_history)
    from repro_torch.serve.serving import ROOServer, ServeConfig
    cfg, params, requests = serve["cfg"], serve["params"], serve["requests"]
    server = ROOServer(
        params, serve["score"], ServeConfig(
            b_ro=64, b_nro=512, hist_len=cfg.hist_len,
            cache_user_tower=True),
        user_fn=lambda p, b: gr_history_repr(p, cfg, b),
        score_from_user=lambda p, b, u:
            gr_ranking_logits_from_history(p, cfg, b, u),
        device=device)
    kmod.reset_launch_count()
    pmod.reset_launch_count()
    first, first_s = serve_waves(server, [requests])
    st = server.stats
    batches_1, full_1 = st.n_batches, st.n_full_cache_batches
    second, second_s = serve_waves(server, [requests])
    batches_2 = st.n_batches - batches_1
    full_2 = st.n_full_cache_batches - full_1
    cs = server.cache.stats
    print(f"[cache] pass 1: {first_s * 1e3:.1f} ms "
          f"({len(requests) / first_s:.1f} requests/s), {batches_1} "
          f"batches, {full_1} full-cache; pass 2: {second_s * 1e3:.1f} ms "
          f"({len(requests) / second_s:.1f} requests/s), {batches_2} "
          f"batches, {full_2} full-cache; cache hits {cs.hits} misses "
          f"{cs.misses}; launches B1 {kmod.launch_count} B4 "
          f"{pmod.launch_count}")
    if full_2 != batches_2 or batches_2 == 0 or st.n_failed_batches:
        raise SystemExit("cache: the second pass was not all full-cache "
                         "batches, or a batch failed")
    if kmod.launch_count != cfg.hstu.n_layers * st.n_batches \
            or pmod.launch_count:
        raise SystemExit("cache: B1 launches != n_layers x n_batches, or "
                         "B4 launched")
    d_pass = max_diff_ok(second, first, "cache pass 2 vs pass 1")
    d_stateless = max_diff_ok(first, serve["scores"],
                              "cache path vs stateless server")
    server.params = params                         # weight swap
    print(f"[cache] max|pass 2 - pass 1| = {d_pass:.3e}, max|cache path - "
          f"stateless| = {d_stateless:.3e}; after a weight swap the cache "
          f"holds {len(server.cache)} rows")
    if len(server.cache):
        raise SystemExit("cache: a weight swap did not empty the cache")


def phase_times(kmod, device, card: str) -> dict:
    """B1 at the hstu-gr serving shape (B 64; the JSON's entry) and
    training shape (B 32), H 2, S 80, D 32, and at roo-esr's serving shape
    (B 64, S 64, causal: the JSON's ESR entry), rab on, beside the plain
    version and the bound. Returns {"serve": ..., "esr serve": ...}."""
    out = {}
    for key, (b, s, n_hist) in (("serve", (64, 80, 64)),
                                ("train", (32, 80, 64)),
                                ("esr serve", (64, 64, 64))):
        x = attention_inputs((b, 2, s, 32, 32, n_hist, 64), seed=0,
                             device=device)
        if key == "esr serve":
            x["tc"].zero_()
        args = (x["q"], x["k"], x["v"], x["rab"], x["n_hist"], x["hl"],
                x["tc"], x["max_rel"])
        kernel = lambda: kmod.hstu_attention_cuda(*args)
        plain = lambda: kmod.hstu_attention_plain(*args)
        # plain, kernel, kernel, plain: turns within one call on one card
        plain_ms = device_ms(plain, iters=20)
        ms = device_ms(kernel, iters=200)
        ms_again = device_ms(kernel, iters=200)
        plain_again = device_ms(plain, iters=20)
        kernel_call, plain_call = call_ms(kernel, 200), call_ms(plain, 50)
        bound_ms, bound_by, n_bytes, ops = bound(x)
        print(f"[times] {card}: hstu_attention_fwd ({key}) B{b} H2 S{s} "
              f"D32 rab{' causal' if key == 'esr serve' else ''}, device "
              f"time per call: kernel {ms:.5f} ms (again "
              f"{ms_again:.5f}), plain torch {plain_ms:.5f} ms (again "
              f"{plain_again:.5f}); bound {bound_ms:.5f} ms ({bound_by}: "
              f"{n_bytes} B, {ops} FLOP at 3.35 TB/s / 67 TFLOP/s); "
              f"library: none")
        print(f"[times] {card}: host-issued back-to-back calls: kernel "
              f"{kernel_call:.5f} ms, plain torch {plain_call:.5f} ms")
        out[key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by)
    return out


def phase_prefix_times(pmod, device, card: str) -> dict:
    """B4 at the serving shape (B 64, H 2, n_hist 64, m 16, D 32, rab on)
    with n_new 1, 8 (the JSON's entry) and 64, beside the plain version
    and the bound."""
    out = {}
    for n_new in (1, 8, 64):
        x = prefix_inputs((64, 2, 64, n_new, 16, 32, 32, 64, 80), seed=11,
                          device=device)
        args = (x["q"], x["k"], x["v"], x["rab"], x["n_hist"], x["n_new"],
                x["pfx"], x["nc"], x["tc"], x["scale_len"], x["max_rel"])
        kernel = lambda: pmod.hstu_attention_prefix_cuda(*args)
        plain = lambda: pmod.hstu_attention_prefix_plain(*args)
        plain_ms = device_ms(plain, iters=20)
        ms = device_ms(kernel, iters=200)
        ms_again = device_ms(kernel, iters=200)
        plain_again = device_ms(plain, iters=20)
        kernel_call, plain_call = call_ms(kernel, 200), call_ms(plain, 50)
        bound_ms, bound_by, n_bytes, ops = bound_prefix(x)
        print(f"[times] {card}: hstu_attention_prefix_fwd B64 H2 n_hist64 "
              f"n_new{n_new} m16 D32 rab, device time per call: kernel "
              f"{ms:.5f} ms (again {ms_again:.5f}), plain torch "
              f"{plain_ms:.5f} ms (again {plain_again:.5f}); bound "
              f"{bound_ms:.5f} ms ({bound_by}: {n_bytes} B, {ops} FLOP at "
              f"3.35 TB/s / 67 TFLOP/s); library: none")
        print(f"[times] {card}: host-issued back-to-back calls: prefix "
              f"kernel {kernel_call:.5f} ms, plain torch {plain_call:.5f} "
              f"ms")
        out[n_new] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by)
    return out[8]


def phase_bwd_times(bmod, device, card: str) -> dict:
    """B2 and B3 at the hstu-gr training shape (B 32, H 2, S 80, D 32, rab
    on) and at the roo-lsr ``userarch_hstu`` step's (B 32, S 64, causal
    over the history) beside the plain backward (which computes all four
    gradients) and each kernel's bound. Returns the training shape's
    under "dq" / "dkv", and each shape's under (causal, "dq" | "dkv"): the
    causal one is also the two-tower user tower's step."""
    import torch
    shapes = {"B32 H2 S80 D32 rab": ((32, 2, 80, 32, 32, 64, 64), False),
              "userarch_hstu B32 H2 S64 causal D32 rab":
                  ((32, 2, 64, 32, 32, 64, 64), True)}
    out = {}
    for shape_name, (shape, causal) in shapes.items():
        x = attention_inputs(shape, seed=0, device=device)
        if causal:
            x["tc"].zero_()
        g = torch.randn(x["v"].shape, generator=torch.Generator(
            device=device).manual_seed(0), device=device)
        args = (x["q"], x["k"], x["v"], x["rab"], x["n_hist"], x["hl"],
                x["tc"], x["max_rel"], g)
        b2 = lambda: bmod.hstu_attention_bwd_dq_cuda(*args)
        b3 = lambda: bmod.hstu_attention_bwd_dkv_cuda(*args)
        plain = lambda: bmod.hstu_attention_bwd_plain(*args)
        # the plain backward issues ~60 launches a call: 8 calls stay
        # inside the launch queue, so the host can run ahead of the card
        plain_ms = device_ms(plain, iters=8)
        ms = {"dq": device_ms(b2, iters=200), "dkv": device_ms(b3, iters=200)}
        again = {"dq": device_ms(b2, iters=200),
                 "dkv": device_ms(b3, iters=200)}
        plain_again = device_ms(plain, iters=8)
        for which, label in (("dq", "B2 hstu_attention_bwd_dq"),
                             ("dkv", "B3 hstu_attention_bwd_dkv")):
            bound_ms, bound_by, n_bytes, ops = bound_bwd(x, which)
            print(f"[times] {card}: {label} {shape_name}, device time per "
                  f"call: kernel {ms[which]:.5f} ms (again "
                  f"{again[which]:.5f}); bound {bound_ms:.5f} ms "
                  f"({bound_by}: {n_bytes} B, {ops} FLOP at 3.35 TB/s / 67 "
                  f"TFLOP/s); {ms[which] / bound_ms:.1f}x the bound; "
                  f"library: none")
            out.setdefault(which, dict(ms=ms[which], plain_ms=plain_ms,
                                       bound_ms=bound_ms, bound_by=bound_by))
            out[causal, which] = dict(ms=ms[which], plain_ms=plain_ms,
                                      bound_ms=bound_ms, bound_by=bound_by)
        print(f"[times] {card}: plain torch backward (dq, dk, dv, drab) "
              f"{shape_name} {plain_ms:.5f} ms (again {plain_again:.5f}); "
              f"host-issued back-to-back calls: B2 {call_ms(b2, 200):.5f} "
              f"ms, B3 {call_ms(b3, 200):.5f} ms, plain "
              f"{call_ms(plain, 50):.5f} ms")
    return out


BAG_SHAPES = {   # (B, L, D, V): the LSR history bag, edge shapes, and a
                 # dlrm-mlperf field at B_NRO 8,192: many ids into few rows
    "train B32 L64 D64": (32, 64, 64, 50000),
    "serve B64 L64 D64": (64, 64, 64, 50000),
    "impression B192 L64 D64": (192, 64, 64, 50000),
    "ragged B37 L50 D64": (37, 50, 64, 50000),
    "D8": (16, 20, 8, 1000),
    "D128": (16, 20, 128, 5000),
    "out-of-range ids": (16, 20, 64, 300),
    "dlrm field B8192 L1 D128 V4": (8192, 1, 128, 4),
    "B3072 L1 D128 V4": (3072, 1, 128, 4),      # the densify's other path
}


def bag_inputs(shape, seed, device, dtype=None, scale=0.02):
    """A table at lsr_init's scale (std 0.02, or ``scale``), ids with
    out-of-range entries, ragged lengths with zeros and full bags, a bag of
    one repeated id (ties for max), and an output gradient g ~ N(0, 1),
    from numpy."""
    import numpy as np
    import torch
    b, l, d, v = shape
    rng = np.random.default_rng(seed)
    table = (scale * rng.normal(size=(v, d))).astype(np.float32)
    ids = rng.integers(0, v, size=(b, l)).astype(np.int32)
    if v < 1000:                        # the out-of-range shape: half of them
        far = rng.random((b, l)) < 0.5
        ids[far] = rng.integers(-2 * v, 3 * v, size=int(far.sum()))
    ids[0, 0], ids[-1, -1] = -3, v + 7
    lens = rng.integers(0, l + 1, size=b).astype(np.int32)
    lens[::5] = 0
    lens[0], lens[-1] = l, 0
    ids[1, :], lens[1] = ids[1, 0], l
    g = rng.normal(size=(b, d)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(device)
    out = dict(table=t(table), ids=t(ids), lens=t(lens), g=t(g), v=v)
    if dtype is not None:
        out["table"], out["g"] = out["table"].to(dtype), out["g"].to(dtype)
    return out


def phase_bag_kernels(emod, device) -> dict:
    """B5 against its plain version through dispatch's auto backend, and B6
    through ``embedding_bag`` (``GroupedEmbeddingBagFn`` at one field)
    against autograd of the plain version, at
    the LSR shapes and edge shapes. Returns the largest |kernel - plain| of
    each kernel's outputs."""
    import torch
    worst = {"fwd": 0.0, "coo": 0.0}
    for i, (name, shape) in enumerate(BAG_SHAPES.items()):
        x = bag_inputs(shape, 40 + i, device)
        args = (x["ids"], x["lens"])
        empty = x["lens"] <= 0
        for pooling in ("sum", "mean", "max"):
            before = emod.fwd_launch_count
            got = emod.embedding_bag(x["table"], *args, pooling)
            if emod.fwd_launch_count != before + 1:
                raise SystemExit("dispatch auto did not launch B5 on a CUDA "
                                 "table")
            plain = emod.embedding_bag_fwd_plain(x["table"], *args, pooling)
            torch.cuda.synchronize()
            err = float((got - plain).abs().max())
            worst["fwd"] = max(worst["fwd"], err)
            zero = bool(torch.all(got[empty] == 0))
            finite = bool(torch.isfinite(got).all())

            # the backward: the Function (B5 then B6 + densify) vs autograd
            # of the plain version; max takes the plain tie split
            grads = []
            for _ in range(2):
                table = x["table"].detach().requires_grad_(True)
                b5, b6 = emod.fwd_launch_count, emod.coo_launch_count
                out = emod.embedding_bag(table, *args, pooling)
                grads.append(torch.autograd.grad(out, table, x["g"])[0])
                if (emod.fwd_launch_count - b5, emod.coo_launch_count - b6) \
                        != (1, 0 if pooling == "max" else 1):
                    raise SystemExit(f"{name} {pooling}: the Function did not "
                                     f"launch B5 and B6 once each")
            table = x["table"].detach().requires_grad_(True)
            want = torch.autograd.grad(emod.embedding_bag_fwd_plain(
                table, *args, pooling), table, x["g"])[0]
            torch.cuda.synchronize()
            gerr = float((grads[0] - want).abs().max())
            grad_ok = torch.allclose(grads[0], want, atol=ATOL, rtol=RTOL)
            same = torch.equal(grads[0], grads[1])
            coo = "-"
            coo_ok = True
            if pooling != "max":
                cids, rows = emod.embedding_bag_coo_rows_cuda(
                    x["g"], *args, x["v"], pooling)
                pids, prows = emod.embedding_bag_coo_rows_plain(
                    x["g"], *args, x["v"], pooling)
                torch.cuda.synchronize()
                rerr = float((rows - prows).abs().max())
                worst["coo"] = max(worst["coo"], rerr)
                coo_ok = torch.equal(cids, pids) and rerr == 0.0
                coo = f"{rerr:.3e} ids_equal={torch.equal(cids, pids)}"
            print(f"[bag kernels] {name} {pooling}: max|B5-plain| {err:.3e} "
                  f"empty_zero={zero} finite={finite}; table grad "
                  f"max|Fn-plain| {gerr:.3e} ok={grad_ok} bitwise_repeat="
                  f"{same}; B6 rows max|diff| {coo}")
            if not (err <= BAG_TOL and zero and finite and grad_ok and same
                    and coo_ok):
                raise SystemExit(f"the bag kernels disagree with their plain "
                                 f"versions at {name} {pooling}")

    # bf16 tables at std 1 (outputs O(1), so a kernel that wrote zeros or
    # pooled the wrong slots fails): B5 accumulates in fp32 and rounds once;
    # the plain version on the same bf16 table rounds its sum, then its
    # mean, so the two differ by about one bf16 rounding (2**-8 relative)
    x = bag_inputs(BAG_SHAPES["train B32 L64 D64"], 50, device,
                   torch.bfloat16, scale=1.0)
    for pooling in ("sum", "mean", "max"):
        got = emod.embedding_bag(x["table"], x["ids"], x["lens"], pooling)
        want = emod.embedding_bag_fwd_plain(x["table"], x["ids"], x["lens"],
                                            pooling).float()
        cids, rows = emod.embedding_bag_coo_rows_cuda(
            x["g"], x["ids"], x["lens"], x["v"], "mean")
        pids, prows = emod.embedding_bag_coo_rows_plain(
            x["g"], x["ids"], x["lens"], x["v"], "mean")
        torch.cuda.synchronize()
        err = float((got.float() - want).abs().max())
        ok = got.dtype == torch.bfloat16 and torch.allclose(
            got.float(), want, atol=BF16_ATOL, rtol=BF16_RTOL)
        same = torch.equal(rows, prows) and torch.equal(cids, pids)
        print(f"[bag kernels] bf16 {pooling}: max|B5-plain| {err:.3e} "
              f"(max|plain| {float(want.abs().max()):.3e}) ok={ok}; B6 rows "
              f"equal to plain={same}")
        if not (ok and same):
            raise SystemExit(f"bf16 bag kernels disagree at {pooling}")

    # forced dedup: the padded bag pools the distinct rows by the inverse
    # ids, still through B5 and B6; same output and table gradient as plain
    import os
    from repro_torch.embeddings import collection
    x = bag_inputs(BAG_SHAPES["train B32 L64 D64"], 52, device)
    os.environ[collection.DEDUP_KNOB.env_var] = "always"
    try:
        for pooling in ("sum", "mean"):
            table = x["table"].detach().requires_grad_(True)
            b5, b6 = emod.fwd_launch_count, emod.coo_launch_count
            got = collection.bag_lookup_dense(table, x["ids"], x["lens"],
                                              pooling)
            grad = torch.autograd.grad(got, table, x["g"])[0]
            launched = (emod.fwd_launch_count - b5,
                        emod.coo_launch_count - b6)
            ptable = x["table"].detach().requires_grad_(True)
            want = emod.embedding_bag_fwd_plain(ptable, x["ids"], x["lens"],
                                                pooling)
            pgrad = torch.autograd.grad(want, ptable, x["g"])[0]
            torch.cuda.synchronize()
            err = float((got - want).detach().abs().max())
            gerr = float((grad - pgrad).abs().max())
            print(f"[bag kernels] dedup=always {pooling}: launches B5/B6 "
                  f"{launched}; max|out-plain| {err:.3e}, max|grad-plain| "
                  f"{gerr:.3e}")
            if launched != (1, 1) or err > BAG_TOL or not torch.allclose(
                    grad, pgrad, atol=ATOL, rtol=RTOL):
                raise SystemExit(f"the dedup=always bag did not run B5 and "
                                 f"B6 once, or disagrees at {pooling}")
    finally:
        del os.environ[collection.DEDUP_KNOB.env_var]

    # B5's every launch over the long-bag sweep, as the models call it
    bag_sweep(emod, device, grouped=False)

    # the raw wrappers build outputs outside autograd: refused under grad,
    # before any launch
    x = bag_inputs(BAG_SHAPES["D8"], 51, device)
    before = (emod.fwd_launch_count, emod.coo_launch_count)
    for call in (lambda: emod.embedding_bag_fwd_cuda(
                     x["table"].requires_grad_(True), x["ids"], x["lens"]),
                 lambda: emod.embedding_bag_coo_rows_cuda(
                     x["g"].requires_grad_(True), x["ids"], x["lens"],
                     x["v"])):
        try:
            call()
        except RuntimeError as err:
            print(f"[bag kernels] raw wrapper under grad refused: {err}")
        else:
            raise SystemExit("a raw bag wrapper ran on a grad-requiring input")
    if (emod.fwd_launch_count, emod.coo_launch_count) != before:
        raise SystemExit("a refused raw bag call launched its kernel")
    return worst


def dlrm_side_vocabs(side: str) -> list:
    """The padded vocabs of dlrm-mlperf's RO ("ro") or NRO ("nro") fields,
    capped at DLRM_CAP rows as the dlrm phases cap them."""
    return [t.vocab for t in dlrm_config(DLRM_CAP).tables().tables
            if t.side == side]


def group_inputs(b, l, d, vocabs, seed, device, dtype=None, scale=0.02,
                 one_hot=False):
    """A group's tables (std ``scale``, from a generator on ``device``:
    dlrm's fields hold 2**21 rows), ids (B, F, L) with out-of-range entries,
    ragged lengths with zeros, full bags and bags past L (all ones when
    ``one_hot``, as dlrm's), and an output gradient g (B, F, D) ~ N(0, 1);
    ids, lengths and g from numpy."""
    import numpy as np
    import torch
    f = len(vocabs)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    tables = [scale * torch.randn((v, d), generator=gen, device=device)
              for v in vocabs]
    ids = np.stack([rng.integers(0, v, size=(b, l)) for v in vocabs],
                   axis=1).astype(np.int32)
    if one_hot:
        lens = np.ones((b, f), np.int32)
    else:
        far = rng.random((b, f, l)) < 0.1
        ids[far] = rng.integers(-5, 2 * max(vocabs) + 5, size=int(far.sum()))
        lens = rng.integers(0, l + 3, size=(b, f)).astype(np.int32)
        lens[::5] = 0
        lens[0], lens[-1] = l, 0
    g = rng.normal(size=(b, f, d)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(device)
    out = dict(tables=tables, ids=t(ids), lens=t(lens), g=t(g),
               vocabs=list(vocabs))
    if dtype is not None:
        out["tables"] = [x.to(dtype) for x in tables]
        out["g"] = out["g"].to(dtype)
    return out


def ordered_sums(tables, ids, lens) -> list:
    """Each field's bags added slot by slot in slot order, in fp32 with one
    rounding per add (B5's order of operations), not yet rounded."""
    import torch
    b, _, l = ids.shape
    sums = []
    for j, t in enumerate(tables):
        n = lens[:, j].clamp(0, l)
        acc = torch.zeros((b, t.shape[1]), device=t.device)
        for s in range(l):
            row = t[ids[:, j, s].long().clamp(0, t.shape[0] - 1)].float()
            acc = torch.where((s < n)[:, None], acc + row, acc)
        sums.append(acc)
    return sums


def ordered_bags(tables, ids, lens, pooling, sums=None):
    """Sum or mean bags added slot by slot in slot order, in fp32 with one
    rounding per add, then rounded to the table's dtype and divided there:
    B5's order of operations, so its output must equal this bit for bit.
    ``sums``: ``ordered_sums`` of the same inputs, if already made."""
    import torch
    sums = ordered_sums(tables, ids, lens) if sums is None else sums
    outs = []
    for j, (t, acc) in enumerate(zip(tables, sums)):
        r = acc.to(t.dtype)
        if pooling == "mean":
            den = lens[:, j].clamp(min=1).to(t.dtype).float()
            r = (r.float() / den[:, None]).to(t.dtype)
        outs.append(r)
    return torch.stack(outs, 1)


# B5's launches as embedding_bag.fwd_plan names them, (VEC, U, threads a
# block), by dtype: the short and long paths' 16-byte and one-element
# templates and the deep kernel's 4-, 8- and 16-byte lanes (the source's
# launch_fwd_plan). Phase 5 reaches each of them.
def b5_launches(dtype) -> set:
    import torch
    esz = 4 if dtype == torch.float32 else 2
    return ({(16 // esz, 4, 128), (1, 4, 128), (16 // esz, 8, 128),
             (1, 8, 128)}
            | {(size // esz, 64, 32) for size in (4, 8, 16)})


# the long-bag sweep (phase 5): every (B, L, D) of the grid, plus a bf16
# D 256 (16-byte deep lanes), short one-element bags (L 4 and 1, D 18) and
# short 16-byte ones (L 2, D 64)
BAG_SWEEP = dict(B=(1, 8, 32, 64, 192, 2048), L=(5, 50, 64, 200),
                 D=(8, 32, 64, 128))
BAG_SWEEP_EDGES = ((32, 64, 256), (192, 50, 256), (64, 4, 18), (64, 1, 18),
                   (64, 2, 64))


def bag_sweep(emod, device, grouped: bool) -> set:
    """B5 over BAG_SWEEP in fp32 (tables at std 0.02) and bf16 (std 1),
    sum / mean / max, ragged lengths with zeros, full bags and bags past
    L, out-of-range ids: through ``embedding_bag`` at F = 1 (dispatch's
    auto backend: what the models call) or, ``grouped``, through
    ``embedding_bag_grouped`` at F = 3, held bit for bit to the stack of
    its F = 1 launches. Sum and mean equal ``ordered_bags`` bit for bit;
    against the plain version, max is within BAG_TOL, fp32 sum and mean
    (up to 200 adds in another order) within BAG_TOL + RTOL times the same
    bag of the rows' magnitudes, bf16 within BF16_ATOL / BF16_RTOL. Prints
    each shape's launch (``fwd_plan``); returns the (dtype, VEC, U,
    threads) launches seen."""
    import itertools

    import torch
    vocabs = [5000, 977, 3] if grouped else [5000]
    f = len(vocabs)
    tag = "grouped F3" if grouped else "F1"
    seen, n = set(), 0
    shapes = list(itertools.product(BAG_SWEEP["B"], BAG_SWEEP["L"],
                                    BAG_SWEEP["D"])) + list(BAG_SWEEP_EDGES)
    for dtype, scale in ((torch.float32, 0.02), (torch.bfloat16, 1.0)):
        plans = {}
        for i, (b, l, d) in enumerate(shapes):
            if d == 256 and dtype == torch.float32:
                continue
            x = group_inputs(b, l, d, vocabs, 200 + i, device, dtype, scale)
            tables, ids, lens = x["tables"], x["ids"], x["lens"]
            plan = emod.fwd_plan(f, b, l, d, dtype)
            launch = (plan["vec"], plan["u"], plan["threads"])
            seen.add((dtype, *launch))
            plans.setdefault((l, d, launch), []).append(
                f"B{b}: {plan['blocks']}")
            sums = ordered_sums(tables, ids, lens)
            for pooling in ("sum", "mean", "max"):
                before = emod.fwd_launch_count
                if grouped:
                    got = emod.embedding_bag_grouped(tables, ids, lens,
                                                     pooling)
                    plain = emod.embedding_bag_grouped_plain(tables, ids,
                                                             lens, pooling)
                else:
                    got = emod.embedding_bag(tables[0], ids[:, 0, :],
                                             lens[:, 0], pooling)[:, None]
                    plain = emod.embedding_bag_fwd_plain(
                        tables[0], ids[:, 0, :], lens[:, 0],
                        pooling)[:, None]
                launched = emod.fwd_launch_count - before
                same = True
                if grouped:
                    before = emod.fwd_launch_count
                    single = torch.stack([emod.embedding_bag_fwd_cuda(
                        t, ids[:, j, :], lens[:, j], pooling)
                        for j, t in enumerate(tables)], 1)
                    same = (torch.equal(got, single)
                            and emod.fwd_launch_count - before == f)
                if dtype == torch.float32 and pooling == "max":
                    close = bool(((got - plain).abs() <= BAG_TOL).all())
                elif dtype == torch.float32:
                    # up to 200 adds in another order than plain's: within
                    # BAG_TOL + RTOL times the bag of the rows' magnitudes
                    mags = (emod.embedding_bag_grouped_plain(
                        [t.abs() for t in tables], ids, lens, pooling)
                        if grouped else emod.embedding_bag_fwd_plain(
                            tables[0].abs(), ids[:, 0, :], lens[:, 0],
                            pooling)[:, None])
                    close = bool(((got - plain).abs()
                                  <= BAG_TOL + RTOL * mags).all())
                else:
                    close = got.dtype == dtype and torch.allclose(
                        got.float(), plain.float(), atol=BF16_ATOL,
                        rtol=BF16_RTOL)
                in_order = pooling == "max" or torch.equal(
                    got, ordered_bags(tables, ids, lens, pooling, sums))
                n += 1
                if not (launched == 1 and same and close and in_order):
                    err = float((got.float() - plain.float()).abs().max())
                    raise SystemExit(
                        f"bag sweep {tag} {dtype} B{b} L{l} D{d} {pooling} "
                        f"(launch {launch}): launches {launched}, == F=1 "
                        f"stack {same}, max|B5-plain| {err:.3e} within "
                        f"tolerance {close}, in slot order {in_order}")
            del x, tables, sums
        for (l, d, launch), blocks in sorted(plans.items()):
            print(f"[bag sweep] {tag} {dtype} L{l} D{d}: (VEC, U, threads a "
                  f"block) {launch}, blocks " + ", ".join(blocks))
    torch.cuda.empty_cache()
    print(f"[bag sweep] {tag}: {n} launches, each equal to plain and (sum, "
          f"mean) to slot-ordered fp32 adds bit for bit"
          + (", and to its F = 1 stack bit for bit" if grouped else ""))
    return seen


def group_cases() -> dict:
    """name: (B, L, D, vocabs, dtype, scale, one-hot). dlrm's sides at its
    scoring and training batches (13 fields, capped vocabs), F = 1 at the
    LSR shapes, and BAG_SHAPES' edges as groups of three fields."""
    import torch
    ro, nro = dlrm_side_vocabs("ro"), dlrm_side_vocabs("nro")
    f32, bf16 = torch.float32, torch.bfloat16
    return {
        "dlrm RO score B128 F13": (128, 1, 128, ro, f32, 0.01, True),
        "dlrm NRO score B512 F13": (512, 1, 128, nro, f32, 0.01, True),
        "dlrm RO train B2048 F13": (2048, 1, 128, ro, f32, 0.01, True),
        "dlrm NRO train B8192 F13": (8192, 1, 128, nro, f32, 0.01, True),
        "LSR train B32 L64 D64 F1": (32, 64, 64, [50000], f32, 0.02, False),
        "LSR serve B64 L64 D64 F1": (64, 64, 64, [50000], f32, 0.02, False),
        "LSR impression B192 L64 D64 F1": (192, 64, 64, [50000], f32, 0.02,
                                           False),
        "ragged B37 L50 D64 F3": (37, 50, 64, [50000, 3, 977], f32, 0.02,
                                  False),
        "D8 F3": (16, 20, 8, [1000, 4, 37], f32, 0.02, False),
        "D20 (16-byte loads, 5 of 8 lanes) F3": (16, 9, 20, [100, 3, 77],
                                                 f32, 0.02, False),
        "D18 (one element a lane) F3": (16, 9, 18, [100, 3, 77], f32, 0.02,
                                        False),
        "out-of-range ids F3": (16, 20, 64, [300, 3, 50], f32, 0.02, False),
        "V4 B8192 L1 D128 F3": (8192, 1, 128, [4, 4, 4], f32, 0.02, False),
        "V4 B3072 L1 D128 F2": (3072, 1, 128, [4, 4], f32, 0.02, False),
        "bf16 B32 L64 D64 F3": (32, 64, 64, [50000, 3, 977], bf16, 1.0,
                                False),
        "bf16 D128 F3": (33, 7, 128, [300, 50, 3], bf16, 1.0, False),
        "bf16 D12 (one element a lane) F3": (16, 9, 12, [100, 3, 77], bf16,
                                             1.0, False),
    }


def phase_grouped_bag_kernels(emod, device) -> dict:
    """The grouped B5 and B6 (one launch over a group of fields) through
    ``embedding_bag_grouped`` (dispatch's auto backend, so
    ``GroupedEmbeddingBagFn``), at every ``group_cases`` shape, sum / mean
    / max: the output against the plain grouped version (BAG_TOL; bf16 at
    BF16_ATOL / BF16_RTOL), bit for bit against the stack of the F = 1
    launches and (sum, mean) against ``ordered_bags``; B6's rows and ids
    equal to the plain grouped version; two backward calls bit for bit,
    their table gradients against autograd of the plain version (fp32;
    ATOL + RTOL times each row's sum of |g| contributions, as rows sum
    thousands of entries in another order);
    one B5 and one B6 launch a forward and backward. Then the 16-byte and
    the one-element paths on the same data (fp32 and bf16: a table and a g
    one element off), strided int64 ids and lengths, and forced dedup. Returns the
    largest |kernel - plain| of each kernel's fp32 outputs."""
    import torch
    from repro_torch.embeddings import collection
    worst = {"fwd": 0.0, "coo": 0.0}
    seen = set()        # B5's launches, (dtype, VEC, U, threads)
    for i, (name, (b, l, d, vocabs, dtype, scale, one_hot)) in enumerate(
            group_cases().items()):
        x = group_inputs(b, l, d, vocabs, 70 + i, device, dtype, scale,
                         one_hot)
        tables, ids, lens, g = x["tables"], x["ids"], x["lens"], x["g"]
        fp32 = dtype == torch.float32
        plan = emod.fwd_plan(len(tables), b, l, d, dtype)
        seen.add((dtype, plan["vec"], plan["u"], plan["threads"]))
        for pooling in ("sum", "mean", "max"):
            grads, counts = [], []
            for _ in range(2):
                leaves = [t.detach().requires_grad_(True) for t in tables]
                b5, b6 = emod.fwd_launch_count, emod.coo_launch_count
                got = emod.embedding_bag_grouped(leaves, ids, lens, pooling)
                grads.append(torch.autograd.grad(got, leaves, g))
                counts.append((emod.fwd_launch_count - b5,
                               emod.coo_launch_count - b6))
            got = got.detach()
            plain = emod.embedding_bag_grouped_plain(tables, ids, lens,
                                                     pooling)
            b5 = emod.fwd_launch_count
            single = torch.stack([emod.embedding_bag_fwd_cuda(
                t, ids[:, j, :], lens[:, j], pooling)
                for j, t in enumerate(tables)], 1)
            singles = emod.fwd_launch_count - b5
            torch.cuda.synchronize()
            err = float((got.float() - plain.float()).abs().max())
            if fp32:
                worst["fwd"] = max(worst["fwd"], err)
                fwd_ok = err <= BAG_TOL
            else:
                fwd_ok = got.dtype == dtype and torch.allclose(
                    got.float(), plain.float(), atol=BF16_ATOL,
                    rtol=BF16_RTOL)
            same_single = torch.equal(got, single)
            in_order = (pooling == "max"
                        or torch.equal(got, ordered_bags(tables, ids, lens,
                                                         pooling)))
            repeat = all(torch.equal(a, c) for a, c in zip(*grads))
            grad_ok, gerr = True, "-"
            if fp32:
                # a table row's gradient sums up to 2,048 of g's entries
                # (8,192 ids into 4 rows), in another order than autograd
                # of the plain version: held to ATOL + RTOL times the sum
                # of the entries' magnitudes (the same gradient of |g|)
                leaves = [t.detach().requires_grad_(True) for t in tables]
                pout = emod.embedding_bag_grouped_plain(leaves, ids, lens,
                                                        pooling)
                want = torch.autograd.grad(pout, leaves, g,
                                           retain_graph=True)
                mags = torch.autograd.grad(pout, leaves, g.abs())
                gerr = max(float((a - w).abs().max())
                           for a, w in zip(grads[0], want))
                grad_ok = all(bool(((a - w).abs() <= ATOL + RTOL * m).all())
                              for a, w, m in zip(grads[0], want, mags))
                gerr = f"{gerr:.3e}"
                del pout, want, mags
            coo_ok, coo = True, "-"
            if pooling != "max":
                cids, rows = emod.embedding_bag_grouped_coo_rows_cuda(
                    g, ids, lens, vocabs, pooling)
                pids, prows = emod.embedding_bag_grouped_coo_rows_plain(
                    g, ids, lens, vocabs, pooling)
                torch.cuda.synchronize()
                rerr = float((rows.float() - prows.float()).abs().max())
                if fp32:
                    worst["coo"] = max(worst["coo"], rerr)
                coo_ok = torch.equal(cids, pids) and torch.equal(rows, prows)
                coo = f"{rerr:.3e} ids_equal={torch.equal(cids, pids)}"
            want_counts = [(1, 0 if pooling == "max" else 1)] * 2
            print(f"[grouped bags] {name} {pooling}: max|B5-plain| "
                  f"{err:.3e}; == F=1 launches {same_single}; in slot order "
                  f"{in_order}; table grads max|Fn-plain| {gerr} "
                  f"bitwise_repeat={repeat}; B6 rows max|diff| {coo}; "
                  f"launches B5/B6 {counts}, F=1 {singles}")
            if not (fwd_ok and same_single and in_order and repeat
                    and grad_ok and coo_ok and counts == want_counts
                    and singles == len(tables)):
                raise SystemExit(f"the grouped bag kernels disagree or "
                                 f"launched wrongly at {name} {pooling}")
            del grads, got, plain, single
        del x, tables
    torch.cuda.empty_cache()

    # the same group on both load paths: a table and a g one element off
    # (4 bytes in fp32, 2 in bf16) take the one-element path, their aligned
    # copies the 16-byte one
    def offset(t):
        flat = torch.empty(t.numel() + 1, device=device, dtype=t.dtype)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        return view
    # (fp32 last: the checks below reuse its inputs)
    for dtype, scale in ((torch.bfloat16, 1.0), (torch.float32, 0.02)):
        x = group_inputs(37, 9, 128, [300, 50, 3], 90, device, dtype, scale)
        tables, ids, lens, g = x["tables"], x["ids"], x["lens"], x["g"]
        shifted = [tables[0], offset(tables[1]), tables[2]]
        plan = emod.fwd_plan(3, 37, 9, 128, dtype, aligned=False)
        seen.add((dtype, plan["vec"], plan["u"], plan["threads"]))
        for pooling in ("sum", "mean", "max"):
            a = emod.embedding_bag_grouped_fwd_cuda(tables, ids, lens,
                                                    pooling)
            s = emod.embedding_bag_grouped_fwd_cuda(shifted, ids, lens,
                                                    pooling)
            same = torch.equal(a, s)
            if pooling != "max":
                ca, ra = emod.embedding_bag_grouped_coo_rows_cuda(
                    g, ids, lens, x["vocabs"], pooling)
                cs, rs = emod.embedding_bag_grouped_coo_rows_cuda(
                    offset(g), ids, lens, x["vocabs"], pooling)
                same = same and torch.equal(ca, cs) and torch.equal(ra, rs)
            print(f"[grouped bags] {dtype} 16-byte vs one-element path "
                  f"{pooling}: equal bit for bit {same}")
            if not same:
                raise SystemExit("the grouped bag kernels' load paths "
                                 "disagree")

    # ids and lengths read through their strides, int64 converted
    wide = torch.zeros((37, 5, 18), dtype=torch.int64, device=device)
    wide[:, 1:4, ::2] = ids.long()
    wlens = torch.zeros((37, 5), dtype=torch.int64, device=device)
    wlens[:, 1:4] = lens.long()
    for pooling in ("sum", "max"):
        a = emod.embedding_bag_grouped_fwd_cuda(tables, ids, lens, pooling)
        s = emod.embedding_bag_grouped_fwd_cuda(
            tables, wide[:, 1:4, ::2], wlens[:, 1:4], pooling)
        print(f"[grouped bags] strided int64 ids and lengths {pooling}: "
              f"equal bit for bit {torch.equal(a, s)}")
        if not torch.equal(a, s):
            raise SystemExit("the grouped bag kernels read strided ids "
                             "wrongly")

    # forced dedup: each field pools its own distinct rows, still one group
    for pooling in ("sum", "mean"):
        leaves = [t.detach().requires_grad_(True) for t in tables]
        b5, b6 = emod.fwd_launch_count, emod.coo_launch_count
        got = collection.bag_lookup_dense_grouped(leaves, ids, lens, pooling,
                                                  dedup=True)
        grads = torch.autograd.grad(got, leaves, g)
        launched = (emod.fwd_launch_count - b5, emod.coo_launch_count - b6)
        pleaves = [t.detach().requires_grad_(True) for t in tables]
        want = emod.embedding_bag_grouped_plain(pleaves, ids, lens, pooling)
        pgrads = torch.autograd.grad(want, pleaves, g, retain_graph=True)
        mags = torch.autograd.grad(want, pleaves, g.abs())
        torch.cuda.synchronize()
        err = float((got - want).detach().abs().max())
        ok = launched == (1, 1) and err <= BAG_TOL and all(
            bool(((a - w).abs() <= ATOL + RTOL * m).all())
            for a, w, m in zip(grads, pgrads, mags))
        print(f"[grouped bags] dedup=always {pooling}: launches B5/B6 "
              f"{launched}; max|out-plain| {err:.3e}; grads ok {ok}")
        if not ok:
            raise SystemExit(f"the dedup=always grouped bag did not run B5 "
                             f"and B6 once, or disagrees at {pooling}")

    # the long-bag sweep, and every launch the host can choose reached
    seen |= bag_sweep(emod, device, grouped=True)
    for dtype in (torch.float32, torch.bfloat16):
        got = {launch[1:] for launch in seen if launch[0] == dtype}
        print(f"[grouped bags] {dtype} B5 launches (VEC, U, threads) "
              f"reached: {sorted(got)}")
        if got != b5_launches(dtype):
            raise SystemExit(f"phase 5 reached B5's launches {sorted(got)} "
                             f"in {dtype}, not "
                             f"{sorted(b5_launches(dtype))}")

    # the raw grouped wrappers refuse a grad-requiring input, launching
    # nothing
    before = (emod.fwd_launch_count, emod.coo_launch_count)
    for call in (lambda: emod.embedding_bag_grouped_fwd_cuda(
                     [t.detach().requires_grad_(True) for t in tables], ids,
                     lens),
                 lambda: emod.embedding_bag_grouped_coo_rows_cuda(
                     g.detach().requires_grad_(True), ids, lens,
                     x["vocabs"])):
        try:
            call()
        except RuntimeError as err:
            print(f"[grouped bags] raw grouped wrapper under grad refused: "
                  f"{err}")
        else:
            raise SystemExit("a raw grouped bag wrapper ran on a "
                             "grad-requiring input")
    if (emod.fwd_launch_count, emod.coo_launch_count) != before:
        raise SystemExit("a refused raw grouped bag call launched its kernel")
    return worst


def phase_lsr_serve(emod, kmod, device) -> dict:
    """roo-lsr ``userarch`` at lsr_config width: the stateless server over
    the simulated stream through B5, against the plain embedding backend on
    the card and a CPU server; ROO vs impression-level logits on one batch
    (B5 at B_NRO); the user-tower cache over the stream twice."""
    import numpy as np
    import torch
    from repro_torch.configs.roo_models import lsr_config
    from repro_torch.data.batcher import BatcherConfig, ROOBatcher
    from repro_torch.interop import params_from_numpy, params_to_numpy
    from repro_torch.kernels import dispatch
    from repro_torch.models.lsr import (lsr_init, lsr_logits_from_user,
                                        lsr_logits_impression,
                                        lsr_logits_roo, lsr_user_repr)
    from repro_torch.serve.serving import ROOServer, ServeConfig

    cfg = lsr_config("userarch")
    params = lsr_init(torch.Generator().manual_seed(0), cfg, device=device)
    score = lambda p, b: lsr_logits_roo(p, cfg, b)
    requests = make_requests(cfg, 1000)
    print(f"[lsr serve] roo-lsr mode={cfg.mode} items={cfg.n_items} "
          f"embed_dim={cfg.embed_dim} hist={cfg.hist_len} LCE "
          f"{cfg.lce_n_out}x{cfg.lce_d_out} cross={cfg.n_cross_layers} top "
          f"{cfg.top_mlp + (cfg.n_tasks,)}; {len(requests)} requests, "
          f"{sum(r.num_impressions for r in requests)} impressions")
    serve_cfg = ServeConfig(b_ro=64, b_nro=512, hist_len=cfg.hist_len)
    ROOServer(params, score, serve_cfg, device=device).score_requests(
        requests[:80])                                  # warm-up

    server = ROOServer(params, score, serve_cfg, device=device)
    emod.reset_launch_count()
    kmod.reset_launch_count()
    scores, wall = serve_waves(server, [requests])
    st = server.stats
    b5 = emod.fwd_launch_count
    print(f"[lsr serve] {len(requests)} requests in {wall * 1e3:.1f} ms "
          f"({len(requests) / wall:.1f} requests/s), {st.n_batches} batches "
          f"{st.buckets.snapshot()['counts']}; launches B5 {b5} B6 "
          f"{emod.coo_launch_count} B1 {kmod.launch_count}")
    if st.n_failed_batches or len(scores) != len(requests) or any(
            s.shape != (r.num_impressions, cfg.n_tasks)
            or not np.isfinite(s).all() for r, s in zip(requests, scores)):
        raise SystemExit("lsr serve: a failed batch, or scores misaligned "
                         "or not finite")
    if b5 != st.n_batches or b5 == 0 or kmod.launch_count \
            or emod.coo_launch_count:
        raise SystemExit(f"lsr serve: B5 launches {b5} != scored batches "
                         f"{st.n_batches}, or B1 / B6 launched")

    dispatch.set_default_emb_backend("torch")
    try:
        plain = ROOServer(params, score, serve_cfg,
                          device=device).score_requests(requests)
    finally:
        dispatch.set_default_emb_backend(None)
    if emod.fwd_launch_count != b5:
        raise SystemExit("lsr serve: the plain-backend server launched B5")
    d_plain = max_diff_ok(scores, plain, "lsr serve vs the plain backend")
    cpu_params = params_from_numpy(params_to_numpy(params), "cpu")
    cpu = ROOServer(cpu_params, score, serve_cfg,
                    device="cpu").score_requests(requests[:48])
    d_cpu = max_diff_ok(scores[:48], cpu, "lsr serve vs a CPU server")
    print(f"[lsr serve] max|B5 - plain backend| over scores {d_plain:.3e}; "
          f"max|card - CPU| over 48 requests {d_cpu:.3e}")

    batch = next(ROOBatcher(BatcherConfig(b_ro=64, b_nro=512,
                                          hist_len=cfg.hist_len),
                            device=device).batches(requests))
    before = emod.fwd_launch_count
    with torch.inference_mode():
        roo = lsr_logits_roo(params, cfg, batch)
        imp = lsr_logits_impression(params, cfg, batch)
    torch.cuda.synchronize()
    mask = batch.impression_mask()
    d_imp = float((roo[mask] - imp[mask]).abs().max())
    ok = torch.allclose(roo[mask], imp[mask], atol=LOGIT_TOL, rtol=LOGIT_TOL)
    print(f"[lsr serve] ROO vs impression-level logits on one batch "
          f"(B_RO {batch.b_ro}, B_NRO {batch.b_nro}, {int(mask.sum())} "
          f"impressions): max|diff| {d_imp:.3e} ok={ok}; B5 launches "
          f"{emod.fwd_launch_count - before}")
    if not ok or emod.fwd_launch_count - before != 2:
        raise SystemExit("lsr serve: ROO and impression-level logits "
                         "disagree, or B5 did not run at B_RO and B_NRO")

    cached = ROOServer(
        params, score, ServeConfig(b_ro=64, b_nro=512, hist_len=cfg.hist_len,
                                   cache_user_tower=True),
        user_fn=lambda p, b: lsr_user_repr(p, cfg, b),
        score_from_user=lambda p, b, u: lsr_logits_from_user(p, cfg, b, u),
        device=device)
    emod.reset_launch_count()
    first, first_s = serve_waves(cached, [requests])
    cs = cached.stats
    batches_1, full_1, b5_1 = (cs.n_batches, cs.n_full_cache_batches,
                               emod.fwd_launch_count)
    second, second_s = serve_waves(cached, [requests])
    batches_2 = cs.n_batches - batches_1
    full_2 = cs.n_full_cache_batches - full_1
    b5_2 = emod.fwd_launch_count - b5_1
    print(f"[lsr cache] pass 1: {first_s * 1e3:.1f} ms "
          f"({len(requests) / first_s:.1f} requests/s), {batches_1} batches, "
          f"{full_1} full-cache, B5 {b5_1}; pass 2: {second_s * 1e3:.1f} ms "
          f"({len(requests) / second_s:.1f} requests/s), {batches_2} "
          f"batches, {full_2} full-cache, B5 {b5_2}")
    if full_2 != batches_2 or batches_2 == 0 or b5_2 \
            or b5_1 != batches_1 - full_1 or cs.n_failed_batches:
        raise SystemExit("lsr cache: the second pass was not all full-cache "
                         "with 0 B5 launches, or pass 1 launched B5 other "
                         "than once per computed batch")
    d_pass = max_diff_ok(second, first, "lsr cache pass 2 vs pass 1")
    d_stateless = max_diff_ok(first, scores, "lsr cache vs stateless")
    print(f"[lsr cache] max|pass 2 - pass 1| {d_pass:.3e}, max|cache path - "
          f"stateless| {d_stateless:.3e}")
    return dict(launches=b5, requests_per_s=len(requests) / wall,
                cached_requests_per_s=len(requests) / second_s)


def phase_lsr_train(emod, kmod, pmod, bmod, device, card: str) -> dict:
    """roo-lsr ``userarch`` training through B5 and B6: launch counts,
    losses vs the plain embedding backend on the card and the CPU run, the
    item_emb gradient vs plain, kill at 12 + restart, throughput and a
    per-step breakdown."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.interop import params_to_numpy
    from repro_torch.kernels import dispatch
    from repro_torch.train.loop import value_and_grad
    from repro_torch.tree import leaves
    setup = lsr_train_setup(device)
    cfg, steps = setup["cfg"], 20
    mods = (emod, kmod, pmod, bmod)
    print(f"[lsr train] roo-lsr mode={cfg.mode} items={cfg.n_items}; "
          f"{len(setup['batches'])} batches of 32 requests / 192 "
          f"impressions; {steps} steps")
    for mod in mods:
        mod.reset_launch_count()
    trainer, state, losses = run_trainer(setup, device, steps)
    torch.cuda.synchronize()
    launches = dict(b5=emod.fwd_launch_count, b6=emod.coo_launch_count,
                    hstu=(kmod.launch_count, bmod.dq_launch_count,
                          bmod.dkv_launch_count, pmod.launch_count))
    n_metric = sum(1 for row in trainer.history if "ne" in row)
    print(f"[lsr train] launches B5 {launches['b5']} B6 {launches['b6']} "
          f"B1-B4 {launches['hstu']}; {n_metric} NE forwards; history "
          f"{trainer.history}")
    if launches["b5"] != steps + n_metric or launches["b6"] != steps \
            or any(launches["hstu"]) or n_metric != steps // 10:
        raise SystemExit("lsr train: launch counts are not B5 = steps + NE "
                         "forwards, B6 = steps, B1-B4 0")
    if int(state["step"]) != steps or len(losses) != steps \
            or not bool(torch.isfinite(losses).all()):
        raise SystemExit("lsr train: wrong step count or a non-finite loss")

    dispatch.set_default_emb_backend("torch")
    try:
        b5 = emod.fwd_launch_count
        _, plain_state, plain_losses = run_trainer(lsr_train_setup(device),
                                                   device, steps)
        if emod.fwd_launch_count != b5:
            raise SystemExit("lsr train: the plain-backend run launched B5")
    finally:
        dispatch.set_default_emb_backend(None)
    _, _, cpu_losses = run_trainer(lsr_train_setup("cpu"), "cpu", steps)
    for what, other in (("the plain embedding backend on the card",
                         plain_losses), ("the CPU run", cpu_losses)):
        diff = float((losses - other).abs().max())
        ok = torch.allclose(losses, other, atol=1e-6, rtol=LOSS_TOL)
        print(f"[lsr train] per-step losses vs {what}: max|diff| "
              f"{diff:.3e} ok={ok}")
        if not ok:
            raise SystemExit(f"lsr train: losses disagree with {what}")
    print(f"[lsr train] losses {[round(float(v), 6) for v in losses]}")

    # the item_emb gradient after 20 steps: kernels vs the plain backend on
    # the same params and batch (history bag + item rows)
    params = state["params"]
    batch = setup["batches"][steps % len(setup["batches"])].to(device)
    _, g_kernel = value_and_grad(setup["loss"])(params, batch, None)
    dispatch.set_default_emb_backend("torch")
    try:
        _, g_plain = value_and_grad(setup["loss"])(params, batch, None)
    finally:
        dispatch.set_default_emb_backend(None)
    diff = float((g_kernel["item_emb"] - g_plain["item_emb"]).abs().max())
    ok = torch.allclose(g_kernel["item_emb"], g_plain["item_emb"],
                        atol=LOGIT_TOL, rtol=LOGIT_TOL)
    print(f"[lsr train] item_emb gradient after {steps} steps, kernels vs "
          f"plain: max|diff| {diff:.3e} ok={ok}")
    if not ok:
        raise SystemExit("lsr train: the item_emb gradient disagrees with "
                         "the plain backward")

    ckpt_dir = ROOT / "build" / "chip_smoke_lsr_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    run_trainer(setup, device, steps, ckpt_dir=str(ckpt_dir), stop_after=12)
    _, resumed, _ = run_trainer(setup, device, steps, ckpt_dir=str(ckpt_dir))
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    a, b = params_to_numpy(state["params"]), params_to_numpy(
        resumed["params"])
    diff = max(float(np.abs(x - y).max()) for x, y in zip(leaves(a),
                                                         leaves(b)))
    print(f"[lsr train] kill at step 12 + restart vs uninterrupted: final "
          f"params max|diff| {diff:.3e} (tolerance {PARAM_TOL})")
    if int(resumed["step"]) != steps or diff > PARAM_TOL:
        raise SystemExit("lsr train: the restarted run did not end at the "
                         "uninterrupted run's params")

    run_trainer(setup, device, steps, halt_after_skips=0)        # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_trainer(setup, device, steps, halt_after_skips=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    req_per_batch = float(np.mean([
        int(b.request_mask().sum()) for b in setup["batches"][:steps]]))
    print(f"[lsr train] {card}: {steps} steps in {wall * 1e3:.1f} ms "
          f"({steps / wall:.2f} steps/s, {steps * req_per_batch / wall:.1f} "
          f"requests/s; Trainer.run incl. init and 2 NE forwards)")
    breakdown = step_breakdown(setup, device, state)
    for rnd, parts in enumerate(breakdown):
        print(f"[lsr train] {card}: breakdown {rnd + 1} (ms per step, card "
              f"synchronised after each stage): "
              + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))
    return dict(launches=launches, steps_per_s=steps / wall,
                requests_per_s=steps * req_per_batch / wall,
                breakdown=breakdown)


def phase_lsr_hstu_train(emod, kmod, pmod, bmod, device) -> None:
    """roo-lsr ``userarch_hstu`` (the default mode) trains through B1-B3
    and never reaches the bag kernels; losses vs the torch-dense
    attention run."""
    import torch
    steps = 10
    setup = lsr_train_setup(device, "userarch_hstu")
    for mod in (emod, kmod, pmod, bmod):
        mod.reset_launch_count()
    trainer, state, losses = run_trainer(setup, device, steps)
    torch.cuda.synchronize()
    n_layers = len(state["params"]["hstu"]["layers"])
    n_metric = sum(1 for row in trainer.history if "ne" in row)
    got = (kmod.launch_count, bmod.dq_launch_count, bmod.dkv_launch_count,
           pmod.launch_count, emod.fwd_launch_count, emod.coo_launch_count)
    print(f"[lsr hstu train] mode=userarch_hstu, {steps} steps: launches "
          f"B1 {got[0]} B2 {got[1]} B3 {got[2]} B4 {got[3]} B5 {got[4]} B6 "
          f"{got[5]}; {n_metric} NE forward")
    if got != (n_layers * (steps + n_metric), n_layers * steps,
               n_layers * steps, 0, 0, 0) or n_metric != 1:
        raise SystemExit("lsr hstu train: launch counts are not B1 = "
                         "n_layers x (steps + NE forwards), B2 = B3 = "
                         "n_layers x steps, B4 = B5 = B6 = 0")
    _, _, dense_losses = run_trainer(
        lsr_train_setup(device, "userarch_hstu", "torch-dense"), device,
        steps)
    diff = float((losses - dense_losses).abs().max())
    ok = bool(torch.isfinite(losses).all()) and torch.allclose(
        losses, dense_losses, atol=1e-6, rtol=LOSS_TOL)
    print(f"[lsr hstu train] per-step losses vs torch-dense attention: "
          f"max|diff| {diff:.3e} ok={ok}")
    if not ok:
        raise SystemExit("lsr hstu train: losses disagree with torch-dense")


def at_path(tree, path: str):
    for key in path.split("/"):
        tree = tree[key]
    return tree


def check_sparse_grads(tag: str, grads, params, table_ids) -> tuple:
    """The sparse path's gradient rule: each declared table of at least
    SPARSE_MIN_VOCAB rows gets a unique-id ``SparseRows`` of one row per
    declared id, and no (V, D) gradient; the smaller ones a dense (V, D)
    one. Returns the (sparse, dense) table paths."""
    import torch
    from repro_torch.embeddings.sparse import SPARSE_MIN_VOCAB, is_sparse
    sparse, dense = [], []
    for path, ids in table_ids.items():
        p, g = at_path(params, path), at_path(grads, path)
        if p.shape[0] >= SPARSE_MIN_VOCAB:
            ok = is_sparse(g) and g.unique and tuple(g.rows.shape) == (
                ids.numel(),) + tuple(p.shape[1:])
            sparse.append(path)
        else:
            ok = isinstance(g, torch.Tensor) and g.shape == p.shape
            dense.append(path)
        if not ok:
            raise SystemExit(
                f"{tag}: the gradient of {path} ({p.shape[0]} rows, "
                f"{ids.numel()} ids) is {type(g).__name__} "
                f"{tuple(getattr(g, 'shape', ()))}, not the sparse path's")
    return sparse, dense


def sparse_vs_dense_grads(tag: str, setup, params, batch) -> tuple:
    """Every leaf's gradient on the sparse path (``SparseRows``
    densified) against the dense path's, on the same params and batch;
    the gradient rule checked on the way. Returns the largest |diff| with
    its path, and the (sparse, dense) table paths."""
    import torch
    from repro_torch.embeddings.sparse import (is_sparse,
                                               make_sparse_value_and_grad)
    from repro_torch.train.loop import value_and_grad
    from repro_torch.tree import flatten_with_path, leaves
    _, g_sparse = make_sparse_value_and_grad(
        setup["loss"], setup["table_ids"])(params, batch, None)
    paths = check_sparse_grads(tag, g_sparse, params,
                               setup["table_ids"](batch))
    _, g_dense = value_and_grad(setup["loss"])(params, batch, None)
    worst = (0.0, ())
    for (path, a), b in zip(flatten_with_path(g_sparse, is_leaf=is_sparse),
                            leaves(g_dense)):
        a = a.to_dense() if is_sparse(a) else a
        worst = max(worst, (float((a - b).abs().max()), path))
        if not torch.allclose(a, b, atol=LOGIT_TOL, rtol=LOGIT_TOL):
            raise SystemExit(f"{tag}: the sparse path's gradient of "
                             f"{'/'.join(path)} disagrees with the dense "
                             f"path's: max|diff| {worst[0]:.3e}")
    return worst, paths


def same_run(tag: str, losses, state, again, state_again) -> None:
    """Two runs' per-step losses and final params, bit for bit."""
    import torch
    from repro_torch.tree import leaves
    same = torch.equal(losses, again) and all(
        torch.equal(a, b) for a, b in zip(leaves(state["params"]),
                                          leaves(state_again["params"])))
    print(f"[{tag}] a second run: per-step losses and final params equal "
          f"bit for bit {same}")
    if not same:
        raise SystemExit(f"{tag}: two runs differ")


def print_beside(tag: str, card: str, sparse: dict, dense: dict) -> None:
    print(f"[{tag}] {card}: sparse rows {sparse['steps_per_s']:.2f} "
          f"steps/s, dense {dense['steps_per_s']:.2f} steps/s"
          + (f"; peak memory sparse {sparse['peak'] / 2 ** 30:.2f} GiB, "
             f"dense {dense['peak'] / 2 ** 30:.2f} GiB"
             if "peak" in sparse else ""))
    for rnd, (a, b) in enumerate(zip(sparse["breakdown"],
                                     dense["breakdown"])):
        print(f"[{tag}] {card}: breakdown {rnd + 1} (ms per step, card "
              f"synchronised after each stage), sparse / dense: "
              + ", ".join(f"{k} {a[k]:.3f} / {b[k]:.3f}" for k in a))


def phase_lsr_sparse_train(emod, kmod, pmod, bmod, device, card: str,
                           dense: dict) -> dict:
    """roo-lsr ``userarch`` training on sparse rows, 20 steps:
    ``item_emb`` (50,000 rows) and ``user_cat_emb`` (200) are gathered and
    get ``SparseRows``, ``act_emb`` (4) a dense gradient; the history bag
    still runs B5 and B6, over the gathered rows (B5 = steps + NE
    forwards, B6 = steps, B1-B4 0); at every step the loss of the plain
    embedding backend on the card and of the CPU, on the same full params
    and batch; densified gradients vs the dense path after 20 steps; a
    second run bit for bit; steps/s and the breakdown beside the dense
    phase's."""
    import numpy as np
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.models.lsr import lsr_table_ids
    from repro_torch.tree import tree_map
    tag = "lsr sparse train"
    setup = lsr_train_setup(device)
    cfg, steps = setup["cfg"], 20
    setup["table_ids"] = lambda b: lsr_table_ids(cfg, b)
    cpu = lsr_train_setup("cpu")
    shadows = {"plain": [], "cpu": []}

    def before(p, b):
        with dispatch.use_emb_backend("torch"):    # the CPU's is plain too
            shadows["plain"].append(setup["loss"](p, b, None).detach())
            shadows["cpu"].append(cpu["loss"](
                tree_map(lambda x: x.detach().cpu(), p), batch_to(b, "cpu"),
                None))

    print(f"[{tag}] roo-lsr mode={cfg.mode} items={cfg.n_items}; "
          f"{len(setup['batches'])} batches of 32 requests / 192 "
          f"impressions; {steps} steps")
    for mod in (emod, kmod, pmod, bmod):
        mod.reset_launch_count()
    trainer, state, losses = run_trainer(dict(setup, before_step=before),
                                         device, steps)
    torch.cuda.synchronize()
    launches = dict(b5=emod.fwd_launch_count, b6=emod.coo_launch_count,
                    hstu=(kmod.launch_count, bmod.dq_launch_count,
                          bmod.dkv_launch_count, pmod.launch_count))
    n_metric = sum(1 for row in trainer.history if "ne" in row)
    print(f"[{tag}] launches B5 {launches['b5']} B6 {launches['b6']} B1-B4 "
          f"{launches['hstu']}; {n_metric} NE forwards; history "
          f"{trainer.history}")
    if launches["b5"] != steps + n_metric or launches["b6"] != steps \
            or any(launches["hstu"]) or n_metric != steps // 10:
        raise SystemExit(f"{tag}: launch counts are not B5 = steps + NE "
                         f"forwards, B6 = steps, B1-B4 0")
    if int(state["step"]) != steps or len(losses) != steps \
            or not bool(torch.isfinite(losses).all()) \
            or trainer.skipped_steps:
        raise SystemExit(f"{tag}: wrong step count, a skipped step or a "
                         f"non-finite loss")
    for what, key in (("the plain embedding backend on the card", "plain"),
                      ("the CPU", "cpu")):
        other = torch.stack(shadows[key]).cpu()
        diff = float((losses - other).abs().max())
        ok = torch.allclose(losses, other, atol=1e-6, rtol=LOSS_TOL)
        print(f"[{tag}] per-step losses vs {what} (dense tables) on the "
              f"same params and batch: max|diff| {diff:.3e} ok={ok}")
        if not ok:
            raise SystemExit(f"{tag}: losses disagree with {what}")
    print(f"[{tag}] losses {[round(float(v), 6) for v in losses]}")

    batch = setup["batches"][steps % len(setup["batches"])].to(device)
    worst, paths = sparse_vs_dense_grads(tag, setup, state["params"], batch)
    print(f"[{tag}] sparse tables {paths[0]}, dense {paths[1]}; gradients "
          f"after {steps} steps, sparse (densified) vs dense path: max|diff| "
          f"{worst[0]:.3e} (at {'/'.join(worst[1])})")
    _, state_again, again = run_trainer(setup, device, steps)
    same_run(tag, losses, state, again, state_again)
    del state_again

    run_trainer(setup, device, steps, halt_after_skips=0)        # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, state, _ = run_trainer(setup, device, steps, halt_after_skips=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    req_per_batch = float(np.mean([
        int(b.request_mask().sum()) for b in setup["batches"][:steps]]))
    out = dict(launches=launches, steps_per_s=steps / wall,
               requests_per_s=steps * req_per_batch / wall,
               breakdown=step_breakdown(setup, device, state))
    print(f"[{tag}] {card}: {steps} steps in {wall * 1e3:.1f} ms "
          f"({steps / wall:.2f} steps/s, {steps * req_per_batch / wall:.1f} "
          f"requests/s; Trainer.run incl. init and 2 NE forwards)")
    print_beside(tag, card, out, dense)
    return out


def bound_bag(x, which: str) -> tuple:
    """Least time (ms) the card needs for one B5 or B6 call on these
    inputs. B5 bytes: each distinct table row the valid slots read (a row
    that repeats need not move twice), the ids and lengths, the (B, D)
    output; its operations one add per kept element (and a divide per
    output). B6 bytes: g, the ids and lengths read, all B·L·D rows and B·L
    ids written; one multiply per row element. Rows, outputs, g and the
    COO rows at the table's element size (2 bytes in bf16), ids and
    lengths at 4."""
    import torch
    b, l = x["ids"].shape
    v, d = x["table"].shape
    es = x["table"].element_size()
    n = x["lens"].clamp(0, l)
    kept = int(n.sum())
    if which == "fwd":
        valid = torch.arange(l, device=n.device)[None, :] < n[:, None]
        rows = int(x["ids"].long().clamp(0, v - 1)[valid].unique().numel())
        n_bytes = es * (rows * d + b * d) + 4 * (b * l + b)
        ops = kept * d + b * d
    else:
        n_bytes = es * (b * d + b * l * d) + 4 * (b * l + b + b * l)
        ops = b * l * d
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", n_bytes, ops)


def phase_bag_times(emod, device, card: str) -> dict:
    """B5 and B6 (mean pooling) at the LSR training shape (B 32, L 64,
    D 64, V 50,000) beside their plain versions, their bounds and one
    PyTorch call each (``F.embedding_bag`` on the flat valid ids; its
    autograd backward, which includes the densify), and the densify."""
    import torch
    import torch.nn.functional as F
    from repro_torch.embeddings.sparse import SparseRows
    x = bag_inputs(BAG_SHAPES["train B32 L64 D64"], 60, device)
    table, ids, lens, g, v = x["table"], x["ids"], x["lens"], x["g"], x["v"]
    b, l = ids.shape
    fwd = lambda: emod.embedding_bag_fwd_cuda(table, ids, lens, "mean")
    fwd_plain = lambda: emod.embedding_bag_fwd_plain(table, ids, lens, "mean")
    coo = lambda: emod.embedding_bag_coo_rows_cuda(g, ids, lens, v, "mean")
    coo_plain = lambda: emod.embedding_bag_coo_rows_plain(g, ids, lens, v,
                                                          "mean")
    cids, rows = coo()
    densify = lambda: SparseRows(cids, rows, v).to_dense()
    # a dlrm field at B_NRO: 8,192 ids into 4 rows take the sorted path
    xd = bag_inputs(BAG_SHAPES["dlrm field B8192 L1 D128 V4"], 61, device)
    dids, drows = emod.embedding_bag_coo_rows_cuda(xd["g"], xd["ids"],
                                                   xd["lens"], xd["v"])
    densify_dlrm = lambda: SparseRows(dids, drows, xd["v"]).to_dense()
    # the library yardstick: the valid ids flattened, one offset per bag
    valid = torch.arange(l, device=device)[None, :] < lens[:, None]
    flat = ids.clamp(0, v - 1)[valid].long()
    offsets = torch.cumsum(lens.clamp(0, l), 0) - lens.clamp(0, l)
    lib_fwd = lambda: F.embedding_bag(flat, table, offsets.long(),
                                      mode="mean")
    tg = table.detach().requires_grad_(True)
    lib_out = F.embedding_bag(flat, tg, offsets.long(), mode="mean")
    lib_bwd = lambda: torch.autograd.grad(lib_out, tg, g, retain_graph=True)
    torch.cuda.synchronize()
    if not torch.allclose(lib_fwd(), fwd(), atol=ATOL, rtol=RTOL):
        raise SystemExit("times: F.embedding_bag disagrees with B5")
    # plain, kernel, kernel, plain; iters x launches per call stay under
    # ~1,000 (the launch queue)
    ms = {key: device_ms(fn, iters) for key, fn, iters in (
        ("fwd_plain", fwd_plain, 40), ("fwd", fwd, 200),
        ("fwd_again", fwd, 200), ("fwd_plain_again", fwd_plain, 40),
        ("coo_plain", coo_plain, 40), ("coo", coo, 200),
        ("coo_again", coo, 200), ("coo_plain_again", coo_plain, 40),
        ("densify", densify, 20), ("densify_dlrm", densify_dlrm, 20),
        ("lib_fwd", lib_fwd, 100),
        ("lib_bwd", lib_bwd, 20))}
    calls = {"fwd": call_ms(fwd, 200), "coo": call_ms(coo, 200),
             "fwd_plain": call_ms(fwd_plain, 50),
             "coo_plain": call_ms(coo_plain, 50)}
    out = {}
    for which, label, lib in (("fwd", "B5 embedding_bag_fwd", "lib_fwd"),
                              ("coo", "B6 embedding_bag_bwd_coo",
                               "lib_bwd")):
        bound_ms, bound_by, n_bytes, ops = bound_bag(x, which)
        print(f"[times] {card}: {label} mean B32 L64 D64 V50000, device time "
              f"per call: kernel {ms[which]:.5f} ms (again "
              f"{ms[which + '_again']:.5f}), plain torch "
              f"{ms[which + '_plain']:.5f} ms (again "
              f"{ms[which + '_plain_again']:.5f}); bound {bound_ms:.5f} ms "
              f"({bound_by}: {n_bytes} B, {ops} FLOP at 3.35 TB/s / 67 "
              f"TFLOP/s); library {ms[lib]:.5f} ms; host-issued calls: "
              f"kernel {calls[which]:.5f} ms, plain "
              f"{calls[which + '_plain']:.5f} ms")
        out[which] = dict(ms=ms[which], plain_ms=ms[which + "_plain"],
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=ms[lib])
    print(f"[times] {card}: densify of the B6 rows to the (50000, 64) table "
          f"gradient (SparseRows.to_dense, 2,048 ids: "
          f"aten.embedding_dense_backward) "
          f"{ms['densify']:.5f} "
          f"ms; F.embedding_bag's backward (incl. its densify) "
          f"{ms['lib_bwd']:.5f} ms; densify of 8,192 ids into a (4, 128) "
          f"table (index_put_ with accumulate) {ms['densify_dlrm']:.5f} ms")
    return out


def phase_dlrm_bag_times(emod, device, card: str) -> None:
    """B5 and B6 (sum pooling) at dlrm-mlperf's shapes: one-hot bags of a
    field capped at DLRM_CAP rows, D 128, B 512 (scoring) and B 8,192
    (training), beside their plain versions, their bounds and one PyTorch
    call each (``F.embedding_bag``; its backward includes the densify into
    the whole (DLRM_CAP, 128) table gradient)."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device=device).manual_seed(62)
    table = 0.02 * torch.randn((DLRM_CAP, 128), generator=gen,
                               device=device)
    for b in (512, 8192):
        ids = torch.randint(0, DLRM_CAP, (b, 1), generator=gen,
                            device=device, dtype=torch.int32)
        lens = torch.ones(b, dtype=torch.int32, device=device)
        g = torch.randn((b, 128), generator=gen, device=device)
        x = dict(table=table, ids=ids, lens=lens)
        fwd = lambda: emod.embedding_bag_fwd_cuda(table, ids, lens, "sum")
        fwd_plain = lambda: emod.embedding_bag_fwd_plain(table, ids, lens,
                                                         "sum")
        coo = lambda: emod.embedding_bag_coo_rows_cuda(g, ids, lens,
                                                       DLRM_CAP, "sum")
        coo_plain = lambda: emod.embedding_bag_coo_rows_plain(
            g, ids, lens, DLRM_CAP, "sum")
        flat = ids.reshape(-1).long()
        offsets = torch.arange(b, device=device)
        lib_fwd = lambda: F.embedding_bag(flat, table, offsets, mode="sum")
        tg = table.detach().requires_grad_(True)
        lib_out = F.embedding_bag(flat, tg, offsets, mode="sum")
        lib_bwd = lambda: torch.autograd.grad(lib_out, tg, g,
                                              retain_graph=True)
        torch.cuda.synchronize()
        if not torch.equal(lib_fwd(), fwd()):
            raise SystemExit("times: F.embedding_bag disagrees with B5 at "
                             "a dlrm shape")
        ms = {key: device_ms(fn, iters) for key, fn, iters in (
            ("fwd_plain", fwd_plain, 40), ("fwd", fwd, 200),
            ("fwd_again", fwd, 200), ("fwd_plain_again", fwd_plain, 40),
            ("coo_plain", coo_plain, 40), ("coo", coo, 200),
            ("coo_again", coo, 200), ("coo_plain_again", coo_plain, 40),
            ("lib_fwd", lib_fwd, 100), ("lib_bwd", lib_bwd, 20))}
        for which, label, lib in (("fwd", "B5 embedding_bag_fwd", "lib_fwd"),
                                  ("coo", "B6 embedding_bag_bwd_coo",
                                   "lib_bwd")):
            bound_ms, bound_by, n_bytes, ops = bound_bag(x, which)
            print(f"[times] {card}: {label} sum dlrm field B{b} L1 D128 "
                  f"V{DLRM_CAP} (one-hot), device time per call: kernel "
                  f"{ms[which]:.5f} ms (again {ms[which + '_again']:.5f}), "
                  f"plain torch {ms[which + '_plain']:.5f} ms (again "
                  f"{ms[which + '_plain_again']:.5f}); bound "
                  f"{bound_ms:.5f} ms ({bound_by}: {n_bytes} B, {ops} FLOP "
                  f"at 3.35 TB/s / 67 TFLOP/s); library {ms[lib]:.5f} ms")
        del tg, lib_out
    del table
    torch.cuda.empty_cache()


def bound_group(x, which: str) -> tuple:
    """``bound_bag`` summed over a group's fields: the least time (ms) the
    card needs for one grouped B5 or B6 call on these inputs."""
    n_bytes = ops = 0
    for j, t in enumerate(x["tables"]):
        _, _, fb, fo = bound_bag(dict(table=t, ids=x["ids"][:, j, :],
                                      lens=x["lens"][:, j]), which)
        n_bytes, ops = n_bytes + fb, ops + fo
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", n_bytes, ops)


def labelled_device_ms(key: str, fn, iters: int) -> float:
    """``device_ms``, naming the timed call if it fails."""
    try:
        return device_ms(fn, iters)
    except SystemExit as err:
        raise SystemExit(f"{key}: {err}") from None


def phase_grouped_bag_times(emod, device, card: str) -> dict:
    """The grouped B5 and B6 (sum, one-hot, D 128) for each of dlrm-mlperf's
    sides (13 fields, vocabs capped at DLRM_CAP) at its scoring (B_RO 128 /
    B_NRO 512) and training (2,048 / 8,192) batches, beside: their summed
    bound; the plain grouped version; 13 launches of the F = 1 call (the
    per-field route); 13 ``F.embedding_bag`` calls and, for B6, the
    backward of 13 ``F.embedding_bag(..., sparse=True)`` calls, whose
    gradient is the per-slot COO rows, B6's own function (the library
    yardsticks); and the host-issued time of one whole ``_field_lookup``
    under no_grad, grouped against the per-field route with its int32
    copies. Returns each side's numbers at the training batch for the
    kernels' JSON line, keyed by (side, "fwd" | "coo")."""
    import torch
    import torch.nn.functional as F
    from repro_torch.embeddings import collection
    from repro_torch.models import dlrm
    out = {}
    for side, fields in (("RO", range(13)), ("NRO", range(13, 26))):
        vocabs = dlrm_side_vocabs(side.lower())
        gen = torch.Generator(device=device).manual_seed(63)
        tables = [0.01 * torch.randn((v, 128), generator=gen, device=device)
                  for v in vocabs]
        params = {"tables": {f"t{i}": t for i, t in zip(fields, tables)}}
        for stage, b in (("score", 128 if side == "RO" else 512),
                         ("train", 2048 if side == "RO" else 8192)):
            ids = torch.stack([torch.randint(0, v, (b, 1), generator=gen,
                                             device=device,
                                             dtype=torch.int32)
                               for v in vocabs], 1)
            lens = torch.ones((b, 13), dtype=torch.int32, device=device)
            g = torch.randn((b, 13, 128), generator=gen, device=device)
            x = dict(tables=tables, ids=ids, lens=lens)
            fwd = lambda: emod.embedding_bag_grouped_fwd_cuda(tables, ids,
                                                              lens)
            fwd_plain = lambda: emod.embedding_bag_grouped_plain(tables, ids,
                                                                 lens)
            fwd_f1 = lambda: [emod.embedding_bag_fwd_cuda(
                t, ids[:, j, :], lens[:, j]) for j, t in enumerate(tables)]
            coo = lambda: emod.embedding_bag_grouped_coo_rows_cuda(
                g, ids, lens, vocabs)
            coo_plain = lambda: emod.embedding_bag_grouped_coo_rows_plain(
                g, ids, lens, vocabs)
            gs = [g[:, j, :].contiguous() for j in range(13)]
            coo_f1 = lambda: [emod.embedding_bag_coo_rows_cuda(
                gs[j], ids[:, j, :], lens[:, j], v)
                for j, v in enumerate(vocabs)]
            flat = [ids[:, j, 0].long() for j in range(13)]
            offsets = torch.arange(b, device=device)
            lib_fwd = lambda: [F.embedding_bag(flat[j], t, offsets,
                                               mode="sum")
                               for j, t in enumerate(tables)]
            tg = [t.detach().requires_grad_(True) for t in tables]
            lib_out = [F.embedding_bag(flat[j], t, offsets, mode="sum",
                                       sparse=True)
                       for j, t in enumerate(tg)]
            lib_bwd = lambda: torch.autograd.grad(lib_out, tg, gs,
                                                  retain_graph=True)
            torch.cuda.synchronize()
            if not torch.equal(torch.stack(lib_fwd(), 1), fwd()):
                raise SystemExit("times: F.embedding_bag disagrees with the "
                                 "grouped B5")
            cids, rows = coo()
            for j, sg in enumerate(lib_bwd()):
                if not (sg.is_sparse and torch.equal(sg._values(), rows[j])
                        and torch.equal(sg._indices()[0],
                                        cids[j].long())):
                    raise SystemExit("times: F.embedding_bag's sparse "
                                     "gradient disagrees with the grouped B6")
            del cids, rows
            # plain, kernel, kernel, plain; iters x launches a call stay
            # under ~1,000 (the launch queue)
            ms = {key: labelled_device_ms(key, fn, iters) for key, fn, iters in (
                ("fwd_plain", fwd_plain, 6), ("fwd", fwd, 200),
                ("fwd_again", fwd, 200), ("fwd_plain_again", fwd_plain, 6),
                ("fwd_f1", fwd_f1, 40), ("lib_fwd", lib_fwd, 10),
                ("coo_plain", coo_plain, 6), ("coo", coo, 200),
                ("coo_again", coo, 200), ("coo_plain_again", coo_plain, 6),
                ("coo_f1", coo_f1, 40))}
            # should the sparse backward synchronise the host, it has no
            # device time: its host-issued time is printed and the JSON
            # line takes no library time for B6
            try:
                ms["lib_bwd"], lib_bwd_how = device_ms(lib_bwd, 8), "device"
            except SystemExit:
                ms["lib_bwd"], lib_bwd_how = None, (
                    f"no device time: it synchronises the host; host-issued "
                    f"{call_ms(lib_bwd, 8, warmup=2):.5f} ms")
            for which, label, lib in (("fwd", "B5 embedding_bag_fwd_grouped",
                                       "lib_fwd"),
                                      ("coo", "B6 embedding_bag_bwd_coo_grouped",
                                       "lib_bwd")):
                bound_ms, bound_by, n_bytes, ops = bound_group(x, which)
                print(f"[times] {card}: {label} sum dlrm {stage} {side} side "
                      f"B{b} F13 L1 D128, device time per call: kernel "
                      f"{ms[which]:.5f} ms (again {ms[which + '_again']:.5f}"
                      f"), plain torch {ms[which + '_plain']:.5f} ms (again "
                      f"{ms[which + '_plain_again']:.5f}); 13 F=1 launches "
                      f"{ms[which + '_f1']:.5f} ms; bound {bound_ms:.5f} ms "
                      f"({bound_by}: {n_bytes} B, {ops} FLOP at 3.35 TB/s / "
                      f"67 TFLOP/s); library (13 calls"
                      + (f", sparse backward: {lib_bwd_how}) "
                         if which == "coo" else ") ")
                      + ("-" if ms[lib] is None else f"{ms[lib]:.5f} ms"))
                if stage == "train":
                    out[side, which] = dict(ms=ms[which],
                                      plain_ms=ms[which + "_plain"],
                                      bound_ms=bound_ms, bound_by=bound_by,
                                      library_ms=ms[lib])
            with torch.no_grad():
                new = lambda: dlrm._field_lookup(params, ids, lens, fields)
                old = lambda: torch.stack([collection.bag_lookup_dense(
                    t, ids[:, j, :].contiguous(), lens[:, j].contiguous())
                    for j, t in enumerate(tables)], dim=1)
                if not torch.equal(new(), old()):
                    raise SystemExit("times: the grouped and per-field "
                                     "_field_lookup disagree")
                print(f"[times] {card}: dlrm _field_lookup {stage} {side} "
                      f"side B{b}, host-issued call: grouped "
                      f"{call_ms(new, 100):.5f} ms, per-field route (13 "
                      f"bags, each after int32 copies of its ids and "
                      f"lengths, then a stack) {call_ms(old, 20):.5f} ms")
            del tg, lib_out, gs
        del tables, params
        torch.cuda.empty_cache()
    return out


DOT_SHAPES = {   # (B, F, D): dlrm-mlperf scoring and training, the
                 # scenario's reduced DLRM, ragged and edge shapes
    "score B512 F26 D128": (512, 26, 128),
    "train B8192 F26 D128": (8192, 26, 128),
    "scenario B512 F4 D16": (512, 4, 16),
    "B1 F26 D128": (1, 26, 128),
    "B37 F26 D128": (37, 26, 128),
    "B37 F13 D24": (37, 13, 24),
    "F1 D128": (64, 1, 128),
    "F8 D64": (64, 8, 64),
    "F40 D128": (16, 40, 128),
    "F63 D256 (4 row blocks, the widest)": (8, 63, 256),
    # the tiles' row-block edges: F1 16, 17, 32 and 33
    "F1 16 D128": (300, 15, 128),
    "F1 17 D128": (300, 16, 128),
    "F1 32 D64": (300, 31, 64),
    "F1 33 D64": (300, 32, 64),
    "D13 (4-byte loads)": (300, 26, 13),
    "B1003 (a k split of 2, not a multiple of the samples a block)":
        (1003, 26, 128),
}


def dot_inputs(shape, seed, device, dtype=None):
    """dense_out (B, D) and sparse_embs (B, F, D) ~ N(0, 1) from numpy."""
    import numpy as np
    import torch
    b, f, d = shape
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    dense, sparse = t(rng.normal(size=(b, d))), t(rng.normal(size=(b, f, d)))
    if dtype is not None:
        dense, sparse = dense.to(dtype), sparse.to(dtype)
    return dense, sparse


def unaligned(x):
    """A contiguous copy of ``x`` one element off 16-byte alignment."""
    import torch
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def phase_dot_kernels(dmod, device) -> float:
    """B7 against its plain version through dispatch's auto backend, with
    and without the diagonal, at the DOT_SHAPES and on inputs one element
    off 16-byte alignment, two calls equal bit for bit; bf16 against the
    plain version on the same bf16 inputs; the backward of
    ``DotInteractionFn`` against autograd of the plain version; the raw
    wrapper's refusals. Returns the largest |kernel - plain| of the fp32
    outputs."""
    import torch
    split = {n: (dmod.warps_per_sample(n, 26, 128),
                 dmod.samples_per_block(n, 26, 128))
             for n in (8192, 1003, 512, 37)}
    print(f"[dot kernels] (warps a sample, samples a block) at F 26, D 128: "
          f"{split}")
    if [ks for ks, _ in split.values()] != [1, 2, 4, 4] or \
            1003 % split[1003][1] == 0:
        raise SystemExit("B7's DOT_SHAPES no longer reach every k split and "
                         "a partial block")
    worst = 0.0
    cases = [(name, dot_inputs(shape, 70 + i, device))
             for i, (name, shape) in enumerate(DOT_SHAPES.items())]
    cases.append(("B37 F26 D128, inputs 4 bytes off 16-byte alignment",
                  tuple(unaligned(x) for x in dot_inputs(
                      DOT_SHAPES["B37 F26 D128"], 69, device))))
    for name, (dense, sparse) in cases:
        d = dense.shape[1]
        for si in (False, True):
            before = dmod.launch_count
            got = dmod.dot_interaction(dense, sparse, self_interaction=si)
            again = dmod.dot_interaction(dense, sparse, self_interaction=si)
            if dmod.launch_count != before + 2:
                raise SystemExit("dispatch auto did not launch B7 on a CUDA "
                                 "tensor")
            plain = dmod.dot_interaction_plain(dense, sparse, si)
            torch.cuda.synchronize()
            err = (got - plain).abs()
            worst = max(worst, float(err.max()))
            ok = got.shape == plain.shape and bool(torch.all(
                err <= DOT_ATOL + DOT_RTOL * plain.abs()))
            dense_copy = torch.equal(got[:, :d], dense)
            finite = bool(torch.isfinite(got).all())
            same = torch.equal(got, again)
            print(f"[dot kernels] {name} self={si}: out {tuple(got.shape)} "
                  f"max|B7-plain| {float(err.max()):.3e} ok={ok} "
                  f"dense_copy_exact={dense_copy} finite={finite} "
                  f"bitwise_repeat={same}")
            if not (ok and dense_copy and finite and same):
                raise SystemExit(f"B7 disagrees with its plain version at "
                                 f"{name} self={si}")

    # bf16: fp32 accumulation, one rounding of each pair; the plain version
    # rounds its fp32 Gram matrix once too, so the two differ by at most
    # about one bf16 rounding of values of size ~sqrt(D)
    for name, off in (("score B512 F26 D128", False),
                      ("B37 F13 D24", False), ("B37 F26 D128", True),
                      ("F63 D256 (4 row blocks, the widest)", False)):
        dense, sparse = dot_inputs(DOT_SHAPES[name], 80, device,
                                   torch.bfloat16)
        if off:
            dense, sparse = unaligned(dense), unaligned(sparse)
            name += ", inputs 2 bytes off 16-byte alignment"
        got = dmod.dot_interaction(dense, sparse)
        want = dmod.dot_interaction_plain(dense, sparse)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        ok = got.dtype == torch.bfloat16 and torch.allclose(
            got.float(), want.float(), atol=BF16_ATOL, rtol=BF16_RTOL)
        print(f"[dot kernels] bf16 {name}: max|B7-plain| {err:.3e} (max|plain| "
              f"{float(want.float().abs().max()):.3e}) ok={ok}")
        if not ok:
            raise SystemExit(f"bf16 B7 disagrees with its plain version at "
                             f"{name}")

    # the backward: DotInteractionFn (B7 forward, plain torch backward) vs
    # autograd of the plain version; two calls give the same bits
    for name, si in (("score B512 F26 D128", False),
                     ("train B8192 F26 D128", False), ("B37 F13 D24", True)):
        dense, sparse = dot_inputs(DOT_SHAPES[name], 90, device)
        g = torch.randn(dmod.dot_interaction_plain(dense, sparse, si).shape,
                        generator=torch.Generator(device=device).manual_seed(1),
                        device=device)
        grads = []
        for fn in (dmod.dot_interaction, dmod.dot_interaction,
                   lambda a, s, self_interaction:
                       dmod.dot_interaction_plain(a, s, self_interaction)):
            a = dense.clone().requires_grad_(True)
            s = sparse.clone().requires_grad_(True)
            before = dmod.launch_count
            out = fn(a, s, self_interaction=si)
            grads.append(torch.autograd.grad(out, (a, s), g))
            grads[-1] += (dmod.launch_count - before,)
        torch.cuda.synchronize()
        (kd, ks, n1), (kd2, ks2, n2), (pd, ps, n3) = grads
        derr = max(float((kd - pd).abs().max()), float((ks - ps).abs().max()))
        ok = torch.allclose(kd, pd, atol=LOGIT_TOL, rtol=LOGIT_TOL) and \
            torch.allclose(ks, ps, atol=LOGIT_TOL, rtol=LOGIT_TOL)
        same = torch.equal(kd, kd2) and torch.equal(ks, ks2)
        print(f"[dot kernels] backward {name} self={si}: max|Fn-plain| "
              f"{derr:.3e} ok={ok} bitwise_repeat={same}; B7 launches "
              f"{(n1, n2, n3)}")
        if not (ok and same and (n1, n2, n3) == (1, 1, 0)):
            raise SystemExit(f"the DotInteractionFn backward disagrees with "
                             f"autograd of the plain version at {name}")

    # the raw wrapper builds its output outside autograd: refused under
    # grad; a shape it does not take raises; neither launches
    dense, sparse = dot_inputs((4, 3, 8), 91, device)
    wide = dot_inputs((4, 64, 8), 92, device)
    before = dmod.launch_count
    for call, err_type in (
            (lambda: dmod.dot_interaction_cuda(
                dense.clone().requires_grad_(True), sparse), RuntimeError),
            (lambda: dmod.dot_interaction_cuda(*wide), ValueError)):
        try:
            call()
        except err_type as err:
            print(f"[dot kernels] raw wrapper refused: {err}")
        else:
            raise SystemExit("the raw B7 wrapper ran on an input it must "
                             "refuse")
    if dmod.launch_count != before:
        raise SystemExit("a refused raw B7 call launched its kernel")
    return worst


def dlrm_config(cap: int):
    """dlrm-mlperf at its published widths, each vocabulary capped at
    ``cap`` rows (then padded as the model pads)."""
    from repro_torch.models.dlrm import MLPERF_VOCABS, DLRMConfig
    return DLRMConfig(vocabs=tuple(min(v, cap) for v in MLPERF_VOCABS))


def dlrm_merges(cfg, b_ro: int, b_nro: int) -> int:
    """The segmented merges one dlrm training step launches, from the
    configuration alone: B6's densify (``SparseRows.to_dense``) of each
    field of at least 64 rows (on sparse rows its gathered N + 1 rows)
    whose side's batch holds more than 3,072 ids."""
    from repro_torch.embeddings.sparse import (FIXED_ORDER_MAX_IDS,
                                               ONE_HOT_MAX_ROWS)
    return sum(
        cfg.padded_vocab(v) >= ONE_HOT_MAX_ROWS
        and (b_ro if i < cfg.n_ro_fields else b_nro) * cfg.multi_hot
        > FIXED_ORDER_MAX_IDS for i, v in enumerate(cfg.vocabs))


def hstu_counts(kmod, pmod, bmod) -> tuple:
    """Launches of B1, B2, B3 and B4 since their last reset."""
    return (kmod.launch_count, bmod.dq_launch_count, bmod.dkv_launch_count,
            pmod.launch_count)


def dlrm_roo_args(b):
    return (b["ro_dense"], b["ro_ids"], b["ro_len"], b["nro_ids"],
            b["nro_len"], b["seg"])


def dlrm_spec(seed: int, b_ro: int, b_nro: int):
    """The dlrm-mlperf scenario with these data seed and batch sizes: what
    ``synthetic_dlrm_batches`` reads its draws' seed and shapes from."""
    from repro_torch.configs.registry import scenario
    return scenario("dlrm-mlperf", {"data.seed": seed, "batcher.b_ro": b_ro,
                                    "batcher.b_nro": b_nro})


def dlrm_setup(cfg, b_ro, b_nro, device, init_device, seed=1, n_batches=8,
               dtype=None):
    """dlrm-mlperf training: the scenario's optimizer and BCE loss on
    ``synthetic_dlrm_batches`` (made on the host, copied per step); params
    from a generator on ``init_device`` (in ``dtype``: fp32 by default)."""
    import torch
    from repro_torch.models.dlrm import dlrm_forward_roo, dlrm_init
    from repro_torch.scenario.build import synthetic_dlrm_batches
    from repro_torch.train.metrics import bce

    def init():
        return dlrm_init(torch.Generator(device=init_device).manual_seed(0),
                         cfg, dtype=dtype or torch.float32, device=device)
    return dict(
        cfg=cfg, batches=synthetic_dlrm_batches(
            dlrm_spec(seed, b_ro, b_nro), cfg, n_batches, device="cpu"),
        loss=lambda p, b, gen: bce(dlrm_forward_roo(p, cfg,
                                                    *dlrm_roo_args(b)),
                                   b["y"]),
        opt=mixed_optimizer(), init=init)


def dlrm_table_gib(cfg) -> float:
    return sum(t.vocab for t in cfg.tables().tables) * cfg.embed_dim * 4 \
        / 2 ** 30


def dlrm_describe(cfg) -> str:
    n_rows = sum(t.vocab for t in cfg.tables().tables)
    return (f"dlrm-mlperf dense {cfg.n_dense} fields {cfg.n_sparse} "
            f"(RO {cfg.n_ro_fields}) D {cfg.embed_dim} bot {cfg.bot_mlp} top "
            f"{(cfg.top_in_dim(),) + cfg.top_mlp[1:]} multi_hot "
            f"{cfg.multi_hot}; tables capped at {max(cfg.vocabs)} rows: "
            f"{n_rows} rows, {n_rows * cfg.embed_dim * 4 / 1e9:.2f} GB fp32")


def phase_dlrm_score(dmod, emod, hstu_mods, device, card: str) -> dict:
    """dlrm-mlperf scoring at the dry-run's serve_p99 shape (B_RO 128
    requests, B_NRO 512 impressions) over 16 synthetic batches through B5
    (one grouped launch for each side's 13 bags) and B7 (one interaction)
    per forward: launch counts, scores
    vs the plain dot and bag backends on the card, ROO vs impression-level
    logits, rates and peak memory."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.models.dlrm import (dlrm_forward_impression,
                                         dlrm_forward_roo, dlrm_init)
    from repro_torch.scenario.build import synthetic_dlrm_batches
    cfg = dlrm_config(DLRM_CAP)
    n_batches, b_ro, b_nro = 16, 128, 512
    torch.cuda.reset_peak_memory_stats()
    params = dlrm_init(torch.Generator(device=device).manual_seed(0), cfg,
                       device=device)
    batches = synthetic_dlrm_batches(dlrm_spec(0, b_ro, b_nro), cfg,
                                     n_batches, device=device)
    score = lambda b: dlrm_forward_roo(params, cfg, *dlrm_roo_args(b))
    print(f"[dlrm score] {dlrm_describe(cfg)}; {n_batches} batches of "
          f"{b_ro} requests / {b_nro} impressions")
    with torch.no_grad():
        score(batches[0])                                     # warm-up
        torch.cuda.synchronize()
        for m in (dmod, emod) + hstu_mods:
            m.reset_launch_count()
        t0 = time.perf_counter()
        logits = [score(b) for b in batches]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(b7=dmod.launch_count, b5=emod.fwd_launch_count,
                        b6=emod.coo_launch_count,
                        hstu=hstu_counts(*hstu_mods))
        print(f"[dlrm score] {n_batches} ROO forwards in {wall * 1e3:.1f} ms: "
              f"{n_batches * b_nro / wall:.1f} impressions/s, "
              f"{n_batches * b_ro / wall:.1f} requests/s; launches B7 "
              f"{launches['b7']} B5 {launches['b5']} B6 {launches['b6']} "
              f"B1-B4 {launches['hstu']}")
        if launches["b7"] != n_batches or launches["b5"] != 2 * n_batches \
                or launches["b6"] or any(launches["hstu"]):
            raise SystemExit("dlrm score: launches are not B7 1 and B5 2 "
                             "(one grouped launch a side) per forward, B1-B4 "
                             "and B6 0")
        if any(x.shape != (b_nro,) or not bool(torch.isfinite(x).all())
               for x in logits):
            raise SystemExit("dlrm score: logits of the wrong shape or not "
                             "finite")

        with dispatch.use_dot_backend("torch"), \
                dispatch.use_emb_backend("torch"):
            plain = [score(b) for b in batches]
        torch.cuda.synchronize()
        if (dmod.launch_count, emod.fwd_launch_count) != (launches["b7"],
                                                          launches["b5"]):
            raise SystemExit("dlrm score: the plain backends launched a "
                             "kernel")
        diff = max(float((a - p).abs().max()) for a, p in zip(logits, plain))
        ok = all(torch.allclose(a, p, atol=LOGIT_TOL, rtol=LOGIT_TOL)
                 for a, p in zip(logits, plain))
        print(f"[dlrm score] max|kernels - plain backends| over "
              f"{n_batches * b_nro} logits {diff:.3e} ok={ok}")
        if not ok:
            raise SystemExit("dlrm score: logits disagree with the plain "
                             "backends")

        b = batches[0]
        seg = b["seg"].long()
        before = (dmod.launch_count, emod.fwd_launch_count)
        imp = dlrm_forward_impression(
            params, cfg, b["ro_dense"][seg],
            torch.cat([b["ro_ids"][seg], b["nro_ids"]], 1),
            torch.cat([b["ro_len"][seg], b["nro_len"]], 1))
        torch.cuda.synchronize()
        d_imp = float((imp - logits[0]).abs().max())
        ok = torch.allclose(imp, logits[0], atol=LOGIT_TOL, rtol=LOGIT_TOL)
        grew = (dmod.launch_count - before[0],
                emod.fwd_launch_count - before[1])
        print(f"[dlrm score] ROO vs impression-level logits on one batch: "
              f"max|diff| {d_imp:.3e} ok={ok}; launches B7, B5 {grew}")
        if not ok or grew != (1, 1):
            raise SystemExit("dlrm score: ROO and impression-level logits "
                             "disagree, or the impression-level forward did "
                             "not launch B7 once and B5 once (one group of "
                             "26 fields)")
    peak = torch.cuda.max_memory_allocated()
    print(f"[dlrm score] {card}: {n_batches * b_nro / wall:.1f} "
          f"impressions/s, {n_batches * b_ro / wall:.1f} requests/s; peak "
          f"memory {peak / 2 ** 30:.2f} GiB")
    del params, batches, logits, plain
    torch.cuda.empty_cache()
    return dict(launches=launches["b7"],
                impressions_per_s=n_batches * b_nro / wall,
                requests_per_s=n_batches * b_ro / wall)


def shadowed(setup, shadow):
    """``setup`` with its loss also computed at every step by ``shadow(p,
    batch)`` on the same params and batch, outside autograd; returns the
    new setup and the list the shadow's losses go to."""
    import torch
    out = []

    def loss(p, b, gen):
        with torch.no_grad():
            out.append(shadow(p, b).detach())
        return setup["loss"](p, b, gen)
    return dict(setup, loss=loss), out


def trajectory_diff(what, losses, other) -> None:
    """Print how two free-running runs' per-step losses drift apart."""
    import torch
    diff = (losses - other).abs()
    over = ~torch.isclose(losses, other, atol=1e-6, rtol=LOSS_TOL)
    first = int(over.nonzero()[0, 0]) + 1 if bool(over.any()) else None
    print(f"[dlrm train] free-running per-step losses vs {what}: max|diff| "
          f"{float(diff.max()):.3e}; first step past rtol {LOSS_TOL}: "
          f"{first}; per step {[float(f'{x:.3g}') for x in diff]}")


def phase_dlrm_train(dmod, emod, smod, hstu_mods, device, card: str
                     ) -> dict:
    """dlrm-mlperf training, 20 steps at the dry-run's train_batch per card
    (B_RO 2,048 / B_NRO 8,192) with dense table gradients, through B5, B6
    and B7: launch counts, no skipped step; at every step the loss of the
    plain dot and bag backends on the card on the same params and batch,
    and, at a 2**14-row cap, the CPU's; a second run equal bit for bit; the
    gradient of every leaf vs the plain backends; steps/s, impressions/s,
    a per-step breakdown and peak memory.

    Each step's loss is held against the plain backends on that step's own
    params: two free-running runs that differ only in summation order
    drift apart from step 3 on (the scenario's Adam and row-wise Adagrad
    rates turn 1-ulp differences into 1e-4 by step 20), so their per-step
    losses are printed, not gated. The Trainer's kill-and-restart contract
    is checked by the hstu-gr and roo-lsr phases; here a 7 GB checkpoint
    would dominate the phase, so it is left out."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.train.loop import value_and_grad
    from repro_torch.tree import flatten_with_path, leaves, tree_map
    cfg = dlrm_config(DLRM_CAP)
    steps, b_ro, b_nro = 20, 2048, 8192
    setup = dlrm_setup(cfg, b_ro, b_nro, device, device)
    print(f"[dlrm train] {dlrm_describe(cfg)}; {len(setup['batches'])} "
          f"batches of {b_ro} requests / {b_nro} impressions; {steps} steps")

    def counts():
        return (dmod.launch_count, emod.fwd_launch_count,
                emod.coo_launch_count, smod.launch_count) \
            + hstu_counts(*hstu_mods)

    def plain_loss(p, b):
        with dispatch.use_dot_backend("torch"), \
                dispatch.use_emb_backend("torch"):
            return setup["loss"](p, b, None)

    merges = steps * dlrm_merges(cfg, b_ro, b_nro)
    for m in (dmod, emod, smod) + hstu_mods:
        m.reset_launch_count()
    traced, plain_losses = shadowed(setup, plain_loss)
    trainer, state, losses = run_trainer(traced, device, steps)
    torch.cuda.synchronize()
    got = counts()
    print(f"[dlrm train] launches B7 {got[0]} B5 {got[1]} B6 {got[2]} "
          f"segment merge {got[3]} B1-B4 {got[4:]}; skipped steps "
          f"{trainer.skipped_steps}; history {trainer.history}")
    if got[:4] != (steps, 2 * steps, 2 * steps, merges) or any(got[4:]):
        raise SystemExit(f"dlrm train: launches are not B7 = steps, B5 = B6 "
                         f"= 2 x steps (one grouped launch a side), segment "
                         f"merge {merges} (dlrm_merges a step), B1-B4 0")
    if int(state["step"]) != steps or len(losses) != steps \
            or not bool(torch.isfinite(losses).all()) \
            or trainer.skipped_steps \
            or any(row["skipped"] for row in trainer.history):
        raise SystemExit("dlrm train: wrong step count, a skipped step or a "
                         "non-finite loss")
    plain_losses = torch.stack(plain_losses).cpu()
    diff = float((losses - plain_losses).abs().max())
    ok = torch.allclose(losses, plain_losses, atol=1e-6, rtol=LOSS_TOL)
    print(f"[dlrm train] per-step losses vs the plain backends on the same "
          f"params and batch: max|diff| {diff:.3e} ok={ok}")
    print(f"[dlrm train] losses {[round(float(v), 6) for v in losses]}")
    if not ok:
        raise SystemExit("dlrm train: losses disagree with the plain "
                         "backends")

    # every leaf's gradient, kernels vs plain backends, at the first and
    # the last step's params
    batch = batch_to(setup["batches"][steps % len(setup["batches"])], device)
    vag = value_and_grad(setup["loss"])
    for when, params in (("at init", setup["init"]()),
                         (f"after {steps} steps", state["params"])):
        _, g_kernel = vag(params, batch, None)
        _, g_plain = value_and_grad(lambda p, b, gen: plain_loss(p, b))(
            params, batch, None)
        torch.cuda.synchronize()
        worst = max((float((a - b).abs().max()), path) for (path, a), b in
                    zip(flatten_with_path(g_kernel), leaves(g_plain)))
        ok = all(torch.allclose(a, b, atol=LOGIT_TOL, rtol=LOGIT_TOL)
                 for a, b in zip(leaves(g_kernel), leaves(g_plain)))
        print(f"[dlrm train] gradients {when}, kernels vs plain backends: "
              f"max|diff| {worst[0]:.3e} (at {'/'.join(worst[1])}) ok={ok}")
        if not ok:
            raise SystemExit(f"dlrm train: gradients {when} disagree with "
                             f"the plain backends")
        del params, g_kernel, g_plain
    del state

    _, _, again = run_trainer(setup, device, steps)
    same = torch.equal(losses, again)
    print(f"[dlrm train] a second run: per-step losses equal bit for bit "
          f"{same}")
    if not same:
        raise SystemExit("dlrm train: two runs of the kernel path differ")
    before = counts()
    dispatch.set_default_dot_backend("torch")
    dispatch.set_default_emb_backend("torch")
    try:
        _, _, free_plain = run_trainer(setup, device, steps)
    finally:
        dispatch.set_default_dot_backend(None)
        dispatch.set_default_emb_backend(None)
    after = counts()
    print(f"[dlrm train] the plain-backend run: segment merge "
          f"{after[3] - before[3]}")
    # the plain bags' gathers densify through SparseRows.to_dense too
    if after[:3] + after[4:] != before[:3] + before[4:] \
            or after[3] - before[3] != merges:
        raise SystemExit(f"dlrm train: the plain-backend run launched a "
                         f"backend kernel, or not the segmented merge "
                         f"{merges} times")
    trajectory_diff("the plain backends on the card", losses, free_plain)

    # the same widths with every table capped at 2**14 rows: at each step
    # the CPU computes the loss on the card's params and batch
    small = dlrm_config(DLRM_CPU_CAP)
    cpu_setup = dlrm_setup(small, 64, 256, "cpu", "cpu")
    cpu_steps = 10
    traced, cpu_losses = shadowed(
        dlrm_setup(small, 64, 256, device, "cpu"),
        lambda p, b: cpu_setup["loss"](
            tree_map(lambda x: x.detach().cpu(), p), batch_to(b, "cpu"), None))
    b7 = dmod.launch_count
    _, _, card_small = run_trainer(traced, device, cpu_steps)
    cpu_losses = torch.stack(cpu_losses)
    diff = float((card_small - cpu_losses).abs().max())
    ok = torch.allclose(card_small, cpu_losses, atol=1e-6, rtol=LOSS_TOL)
    print(f"[dlrm train] {dlrm_describe(small)}; 64 requests / 256 "
          f"impressions, {cpu_steps} steps: per-step losses vs the CPU on the "
          f"same params and batch max|diff| {diff:.3e} ok={ok}; B7 launches "
          f"{dmod.launch_count - b7}")
    if not ok or dmod.launch_count - b7 != cpu_steps:
        raise SystemExit("dlrm train: the capped card run disagrees with "
                         "the CPU, or did not launch B7 once a step")
    _, _, free_cpu = run_trainer(cpu_setup, "cpu", cpu_steps)
    trajectory_diff("a free-running CPU run (2**14 cap)", card_small,
                    free_cpu)

    run_trainer(setup, device, steps, halt_after_skips=0)        # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, state, _ = run_trainer(setup, device, steps, halt_after_skips=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    print(f"[dlrm train] {card}: {steps} steps in {wall * 1e3:.1f} ms "
          f"({steps / wall:.2f} steps/s, {steps * b_nro / wall:.1f} "
          f"impressions/s, {steps * b_ro / wall:.1f} requests/s; "
          f"Trainer.run incl. init); peak memory {peak / 2 ** 30:.2f} GiB")
    breakdown = step_breakdown(setup, device, state)
    for rnd, parts in enumerate(breakdown):
        print(f"[dlrm train] {card}: breakdown {rnd + 1} (ms per step, card "
              f"synchronised after each stage): "
              + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))
    del state
    torch.cuda.empty_cache()
    return dict(launches=got[0], bag_launches=got[1:3], merges=got[3],
                steps_per_s=steps / wall,
                impressions_per_s=steps * b_nro / wall, peak=peak,
                breakdown=breakdown)


def dlrm_sparse_setup(cfg, b_ro, b_nro, device, init_device, dtype=None):
    """``dlrm_setup`` on sparse rows: the batches' ids declared per table
    by ``dlrm_table_ids``."""
    from repro_torch.models.dlrm import dlrm_table_ids
    setup = dlrm_setup(cfg, b_ro, b_nro, device, init_device, dtype=dtype)
    return dict(setup, table_ids=lambda b: dlrm_table_ids(
        cfg, b["ro_ids"], b["nro_ids"]))


def record_groups(emod, fn) -> list:
    """The (tables, ids, lengths) of every grouped B5 launch ``fn()``
    makes: the operands the main path hands the kernel."""
    seen = []
    launch = emod.embedding_bag_grouped_fwd_cuda

    def recording(tables, ids, lengths, pooling="sum"):
        seen.append(([t.detach() for t in tables], ids, lengths))
        return launch(tables, ids, lengths, pooling)

    emod.embedding_bag_grouped_fwd_cuda = recording
    try:
        fn()
    finally:
        emod.embedding_bag_grouped_fwd_cuda = launch
    return seen


def phase_dlrm_sparse_train(dmod, emod, smod, hstu_mods, device, card: str,
                            dense: dict) -> dict:
    """dlrm-mlperf training on sparse rows: ``phase_dlrm_train``'s capped
    config, batches and optimizer, the gradient from
    ``make_sparse_value_and_grad`` (``dlrm_table_ids``), 20 steps. Every
    table of at least 64 rows gets a ``SparseRows`` and none a (V, D)
    gradient; the bags still run B5 and B6 over the gathered rows and the
    three dense tiny tables of a side as one group (B5 = B6 = 2 a step),
    B7 once a step; at every step the loss of the dense tables through the
    plain backends on the same params and batch, and at a 2**14-row cap
    the CPU's; the densified gradients vs the dense path's at init and
    after 20 steps; a second run bit for bit; steps/s, the breakdown and
    peak memory beside the dense phase's. Returns the grouped B5 operands
    of one step for the times."""
    import torch
    from repro_torch.embeddings.sparse import sparse_forward
    from repro_torch.kernels import dispatch
    from repro_torch.tree import tree_map
    tag = "dlrm sparse train"
    cfg = dlrm_config(DLRM_CAP)
    steps, b_ro, b_nro = 20, 2048, 8192
    setup = dlrm_sparse_setup(cfg, b_ro, b_nro, device, device)
    print(f"[{tag}] {dlrm_describe(cfg)}; {len(setup['batches'])} batches "
          f"of {b_ro} requests / {b_nro} impressions; {steps} steps")

    def counts():
        return (dmod.launch_count, emod.fwd_launch_count,
                emod.coo_launch_count, smod.launch_count) \
            + hstu_counts(*hstu_mods)

    def plain_loss(p, b):
        with dispatch.use_dot_backend("torch"), \
                dispatch.use_emb_backend("torch"):
            return setup["loss"](p, b, None).detach()

    shadow_losses = []
    merges = steps * dlrm_merges(cfg, b_ro, b_nro)
    for m in (dmod, emod, smod) + hstu_mods:
        m.reset_launch_count()
    trainer, state, losses = run_trainer(dict(
        setup, before_step=lambda p, b: shadow_losses.append(
            plain_loss(p, b))), device, steps)
    torch.cuda.synchronize()
    got = counts()
    print(f"[{tag}] launches B7 {got[0]} B5 {got[1]} B6 {got[2]} segment "
          f"merge {got[3]} B1-B4 {got[4:]}; skipped steps "
          f"{trainer.skipped_steps}; history {trainer.history}")
    if got[:4] != (steps, 2 * steps, 2 * steps, merges) or any(got[4:]):
        raise SystemExit(f"{tag}: launches are not B7 = steps, B5 = B6 = "
                         f"2 x steps (one grouped launch a side), segment "
                         f"merge {merges} (dlrm_merges a step), B1-B4 0")
    if int(state["step"]) != steps or len(losses) != steps \
            or not bool(torch.isfinite(losses).all()) \
            or trainer.skipped_steps:
        raise SystemExit(f"{tag}: wrong step count, a skipped step or a "
                         f"non-finite loss")
    plain = torch.stack(shadow_losses).cpu()
    diff = float((losses - plain).abs().max())
    ok = torch.allclose(losses, plain, atol=1e-6, rtol=LOSS_TOL)
    print(f"[{tag}] per-step losses vs the dense tables through the plain "
          f"backends on the same params and batch: max|diff| {diff:.3e} "
          f"ok={ok}")
    print(f"[{tag}] losses {[round(float(v), 6) for v in losses]}")
    if not ok:
        raise SystemExit(f"{tag}: losses disagree with the dense tables "
                         f"through the plain backends")

    batch = batch_to(setup["batches"][steps % len(setup["batches"])], device)
    for when, params in (("at init", setup["init"]()),
                         (f"after {steps} steps", state["params"])):
        worst, paths = sparse_vs_dense_grads(tag, setup, params, batch)
        print(f"[{tag}] {len(paths[0])} sparse tables, dense {paths[1]}; "
              f"gradients {when}, sparse (densified) vs the dense path: "
              f"max|diff| {worst[0]:.3e} (at {'/'.join(worst[1])})")
        del params
    groups = record_groups(emod, lambda: sparse_forward(
        setup["loss"], setup["table_ids"], state["params"], batch, None))
    _, state_again, again = run_trainer(setup, device, steps)
    same_run(tag, losses, state, again, state_again)
    del state, state_again
    torch.cuda.empty_cache()

    small = dlrm_config(DLRM_CPU_CAP)
    cpu_setup = dlrm_setup(small, 64, 256, "cpu", "cpu")
    cpu_steps, cpu_losses = 10, []

    def cpu_loss(p, b):
        with dispatch.use_dot_backend("torch"), \
                dispatch.use_emb_backend("torch"):    # what the CPU runs
            cpu_losses.append(cpu_setup["loss"](
                tree_map(lambda x: x.cpu(), p), batch_to(b, "cpu"), None))
    traced = dict(dlrm_sparse_setup(small, 64, 256, device, "cpu"),
                  before_step=cpu_loss)
    b7 = dmod.launch_count
    _, _, card_small = run_trainer(traced, device, cpu_steps)
    cpu_losses = torch.stack(cpu_losses)
    diff = float((card_small - cpu_losses).abs().max())
    ok = torch.allclose(card_small, cpu_losses, atol=1e-6, rtol=LOSS_TOL)
    print(f"[{tag}] {dlrm_describe(small)}; 64 requests / 256 impressions, "
          f"{cpu_steps} steps: per-step losses vs the CPU (dense tables) on "
          f"the same params and batch max|diff| {diff:.3e} ok={ok}; B7 "
          f"launches {dmod.launch_count - b7}")
    if not ok or dmod.launch_count - b7 != cpu_steps:
        raise SystemExit(f"{tag}: the capped card run disagrees with the "
                         f"CPU, or did not launch B7 once a step")

    run_trainer(setup, device, steps, halt_after_skips=0)        # warm-up
    torch.cuda.synchronize()
    peaks = {}
    t0 = time.perf_counter()
    _, state, _ = run_trainer(setup, device, steps, halt_after_skips=0,
                              peaks=peaks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # the Trainer owns its state: init_state copies the fresh tables while
    # init()'s tree is alive, so its peak holds them twice; the steps' peak
    # is read after it
    print(f"[{tag}] {card}: peak memory during Trainer.init_state (the "
          f"state's copy of init()'s {dlrm_table_gib(cfg):.2f} GiB of "
          f"tables) {peaks['init'] / 2 ** 30:.2f} GiB")
    print(f"[{tag}] {card}: peak memory over the {steps} steps after "
          f"init_state {peaks['steps'] / 2 ** 30:.2f} GiB")
    if peaks["steps"] > SPARSE_STEPS_PEAK_GIB * 2 ** 30:
        raise SystemExit(f"{tag}: the steps' peak memory "
                         f"{peaks['steps'] / 2 ** 30:.2f} GiB is past "
                         f"{SPARSE_STEPS_PEAK_GIB} GiB: a full-table copy "
                         f"survived init")
    out = dict(launches=got[0], bag_launches=got[1:3], merges=got[3],
               steps_per_s=steps / wall,
               impressions_per_s=steps * b_nro / wall,
               peak=peaks["steps"], init_peak=peaks["init"],
               breakdown=step_breakdown(setup, device, state), groups=groups)
    print(f"[{tag}] {card}: {steps} steps in {wall * 1e3:.1f} ms "
          f"({steps / wall:.2f} steps/s, {steps * b_nro / wall:.1f} "
          f"impressions/s, {steps * b_ro / wall:.1f} requests/s; "
          f"Trainer.run incl. init)")
    print_beside(tag, card, out, dense)
    del state
    torch.cuda.empty_cache()
    return out


def phase_densify_times(device, card: str) -> None:
    """The sparse path's fixed-order sums at dlrm's shapes, each twice bit
    for bit and against a float64 scatter: ``SparseRows.to_dense`` of 8,192
    ids (dlrm's NRO batch) into 4, 14 and 36 rows (its tiny NRO tables:
    the one-hot product) beside the sorted ``index_put_`` those tables
    took before, and the gathered rows' densify of 8,192 ids into a
    108-row table (its NRO field t24: positions into an 8,193-row
    buffer), beside the same ``index_put_``."""
    import torch
    from repro_torch.embeddings.sparse import SparseRows, gather_table
    gen = torch.Generator(device=device).manual_seed(65)
    n, d = 8192, 128
    rows = torch.randn((n, d), generator=gen, device=device)

    def sorted_put(ids, n_rows):
        out = rows.new_zeros((n_rows + 1, d))
        return out.index_put_((ids.long(),), rows, accumulate=True)[:n_rows]

    cases = []
    for v in (4, 14, 36):
        ids = torch.randint(0, v, (n,), generator=gen, device=device,
                            dtype=torch.int32)
        cases.append((f"tiny-vocab merge, {n} ids into {v} rows",
                      SparseRows(ids, rows, v), ids, v))
    ids = torch.randint(0, 108, (n,), generator=gen, device=device,
                        dtype=torch.int32)
    pos, _ = gather_table(torch.zeros((108, d), device=device),
                          ids).positions(ids)
    cases.append((f"gathered-rows densify, {n} ids into a 108-row table "
                  f"({n + 1}-row buffer)", SparseRows(pos, rows, n + 1),
                  pos, n + 1))
    for label, coo, ids, n_rows in cases:
        got = coo.to_dense()
        want = torch.zeros((n_rows + 1, d), dtype=torch.float64,
                           device=device).index_add_(0, ids.long(),
                                                     rows.double())[:n_rows]
        err = float((got.double() - want).abs().max())
        # fp32 sums of up to 2,048 N(0, 1) rows: 1e-5 of the largest sum
        if not torch.equal(got, coo.to_dense()) \
                or err > 1e-5 * max(1.0, float(want.abs().max())):
            raise SystemExit(f"densify times: {label}: two calls differ, "
                             f"or max|diff| {err:.3e} from float64")
        # a sort's launches x iters stay under the launch queue (~1,000)
        ms = device_ms(coo.to_dense, 10)
        old = device_ms(lambda: sorted_put(ids, n_rows), 10)
        print(f"[times] {card}: {label}: SparseRows.to_dense {ms:.5f} ms "
              f"(max|diff| from float64 {err:.3e}, bitwise on repeat), the "
              f"sorted index_put_ {old:.5f} ms")


MERGE_SHAPES = (   # (label, ids, table rows): the dlrm training cell's
                   # sparse-row merges (fp32, D 128, into the N + 1
                   # gathered rows)
    ("impression side, a 108-row table", 65_536, 108),
    ("impression side, a 10 M-row table", 65_536, 9_995_264),
    ("request side, a 10 M-row table", 16_384, 9_971_200),
)
MERGE_LAWS = ("zipf 1.05", "uniform")


def merge_ids(law: str, n: int, vocab: int, seed: int, device):
    """n ids over 0..vocab-1: a bounded Zipf 1.05 law (the benchmark's
    inverse, ranks scattered affinely) or uniform."""
    import numpy as np
    import torch
    u = np.random.default_rng(seed).random(n)
    if law == "uniform":
        ids = np.minimum((u * vocab).astype(np.int64), vocab - 1)
    else:
        s = 1.05
        h = ((vocab + 1.0) ** (1.0 - s) - 1.0) / (1.0 - s)
        x = (1.0 + (1.0 - s) * u * h) ** (1.0 / (1.0 - s))
        ranks = np.clip(np.floor(x).astype(np.int64) - 1, 0, vocab - 1)
        ids = (7919 * ranks + 13) % vocab
    return torch.from_numpy(ids).to(device)


def merge_registers(log: str) -> dict:
    """{(pass, fp32 | bf16, VEC): (registers, spill bytes)} of the
    segmented merge's templates."""
    import re

    def key(name):
        k = re.search(r"segment_merge_(chunks|spans)_kernelI"
                      r"(f|13__nv_bfloat16)Li(\d+)E", name)
        return ((k.group(1), "fp32" if k.group(2) == "f" else "bf16",
                 int(k.group(3))) if k else None)
    return ptxas_registers(log, key)


def phase_segment_merge(smod, device, card: str) -> dict:
    """The segmented merge (``SparseRows.to_dense``'s ``segment`` route) at
    the dlrm training cell's shapes (:data:`MERGE_SHAPES`), under Zipf 1.05
    and uniform ids: positions into a gathered table's N + 1 rows, fp32 D
    128. Each case: three calls bit for bit, the kernel equal to the plain
    version bit for bit and within 1e-5 of a float64 scatter. Times: the
    route whole (the sort, the zero fill and the two passes), the sort and
    the zero fill alone, ``index_put_(accumulate=True)`` on the same
    operands (``library_ms``, the route it replaced), the plain version
    (timed from the host: it reads counts back), and the byte bound: the
    ids and rows read once, the (N + 1, D) output written once."""
    import torch
    from repro_torch.embeddings.sparse import SparseRows, gather_table
    gen = torch.Generator(device=device).manual_seed(35)
    d, out = 128, {}
    for label, n, vocab in MERGE_SHAPES:
        rows = torch.randn((n, d), generator=gen, device=device)
        for law in MERGE_LAWS:
            ids = merge_ids(law, n, vocab, n + vocab, device)
            pos, _ = gather_table(torch.zeros((vocab, 1), device=device),
                                  ids).positions(ids)
            coo = SparseRows(pos, rows, n + 1)
            smod.reset_launch_count()
            got = [coo.to_dense() for _ in range(3)]
            want = torch.zeros((n + 1, d), dtype=torch.float64,
                               device=device).index_add_(0, pos.long(),
                                                         rows.double())
            err = float((got[0].double() - want).abs().max())
            scale = max(1.0, float(want.abs().max()))
            plain = smod.segment_merge_plain(pos, rows, n + 1)
            if smod.launch_count != 3 or not all(
                    torch.equal(got[0], g) for g in got[1:] + [plain]) \
                    or err > 1e-5 * scale:
                raise SystemExit(f"segment merge: {label} {law}: launches "
                                 f"{smod.launch_count}, not bitwise on "
                                 f"repeat or against plain, or max|diff| "
                                 f"{err:.3e} from float64 (scale {scale})")
            longest = int(torch.bincount(pos.long()).max())

            def put():
                o = rows.new_zeros((n + 2, d))
                return o.index_put_((pos.long(),), rows, accumulate=True)
            # a sort's launches x iters stay under the launch queue
            ms = device_ms(coo.to_dense, 20)
            sort_ms = device_ms(lambda: torch.sort(pos, stable=True), 20)
            zero_ms = device_ms(lambda: rows.new_zeros((n + 1, d)), 20)
            lib_ms = device_ms(put, 20)
            plain_ms = call_ms(lambda: smod.segment_merge_plain(
                pos, rows, n + 1), 2, warmup=1)
            n_bytes = 4 * n + 4 * n * d + 4 * (n + 1) * d
            bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
            out[label, law] = dict(
                ms=ms, sort_ms=sort_ms, zero_ms=zero_ms, library_ms=lib_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
                bytes=n_bytes, max_abs_err=err, longest_run=longest)
            print(f"[times] {card}: segment merge, {label}, {n} {law} ids "
                  f"(longest run {longest}): to_dense {ms:.5f} ms (sort "
                  f"{sort_ms:.5f}, zero fill {zero_ms:.5f}), index_put_ "
                  f"{lib_ms:.5f} ms ({lib_ms / ms:.1f}x), plain "
                  f"{plain_ms:.3f} ms, bound {bound_ms:.5f} ms ({n_bytes} "
                  f"B; {ms / bound_ms:.1f}x); max|diff| from float64 "
                  f"{err:.3e}, bitwise on repeat and against plain")
    return out


def phase_sparse_bag_times(emod, device, card: str, groups) -> dict:
    """The grouped B5 and B6 at the sparse dlrm path's shapes: the
    operands one sparse training step hands B5 (per side, 13 fields: the
    gathered rows + a zero row of each table of at least 64 rows, the
    three dense tiny tables, ids as positions), held against their plain
    versions (B5 within BAG_TOL, B6 bit for bit) and timed beside their
    summed bound, the plain version and 13 ``F.embedding_bag`` calls (B6:
    the backward of 13 ``sparse=True`` calls). Returns the numbers for the
    kernels' JSON line, keyed by (side, "fwd" | "coo")."""
    import torch
    import torch.nn.functional as F
    out = {}
    for side, (tables, ids, lens) in zip(("RO", "NRO"), groups):
        b, f, _ = ids.shape
        vocabs = [t.shape[0] for t in tables]
        g = torch.randn((b, f, tables[0].shape[1]), device=device,
                        generator=torch.Generator(device=device)
                        .manual_seed(66))
        fwd = lambda: emod.embedding_bag_grouped_fwd_cuda(tables, ids, lens)
        fwd_plain = lambda: emod.embedding_bag_grouped_plain(tables, ids,
                                                             lens)
        coo = lambda: emod.embedding_bag_grouped_coo_rows_cuda(g, ids, lens,
                                                               vocabs)
        coo_plain = lambda: emod.embedding_bag_grouped_coo_rows_plain(
            g, ids, lens, vocabs)
        err = float((fwd() - fwd_plain()).abs().max())
        if err > BAG_TOL or not all(torch.equal(a, p) for a, p in
                                    zip(coo(), coo_plain())):
            raise SystemExit(f"sparse bag times: {side} side: B5 off plain "
                             f"by {err:.3e} or B6 not bit for bit plain")
        flat = [ids[:, j, 0].long() for j in range(f)]
        offsets = torch.arange(b, device=device)
        lib_fwd = lambda: [F.embedding_bag(flat[j], t, offsets, mode="sum")
                           for j, t in enumerate(tables)]
        tg = [t.detach().requires_grad_(True) for t in tables]
        lib_out = [F.embedding_bag(flat[j], t, offsets, mode="sum",
                                   sparse=True) for j, t in enumerate(tg)]
        gs = [g[:, j, :].contiguous() for j in range(f)]
        lib_bwd = lambda: torch.autograd.grad(lib_out, tg, gs,
                                              retain_graph=True)
        ms = {key: labelled_device_ms(key, fn, iters) for key, fn, iters in (
            ("fwd_plain", fwd_plain, 6), ("fwd", fwd, 200),
            ("coo", coo, 200), ("coo_plain", coo_plain, 6),
            ("lib_fwd", lib_fwd, 10))}
        try:
            ms["lib_coo"] = device_ms(lib_bwd, 8)
        except SystemExit:
            ms["lib_coo"] = None        # it synchronises the host
        x = dict(tables=tables, ids=ids, lens=lens)
        for which, label in (("fwd", "B5 embedding_bag_fwd_grouped"),
                             ("coo", "B6 embedding_bag_bwd_coo_grouped")):
            bound_ms, bound_by, n_bytes, ops = bound_group(x, which)
            lib = ms["lib_" + which]
            print(f"[times] {card}: {label} sum, sparse dlrm training "
                  f"{side} side B{b} F{f} L1 D{tables[0].shape[1]} over "
                  f"tables of {vocabs} rows, device time per call: kernel "
                  f"{ms[which]:.5f} ms, plain torch "
                  f"{ms[which + '_plain']:.5f} ms; bound {bound_ms:.5f} ms "
                  f"({bound_by}: {n_bytes} B, {ops} FLOP); library ({f} "
                  f"calls) " + ("-" if lib is None else f"{lib:.5f} ms")
                  + f"; max|B5 - plain| {err:.3e}")
            out[side, which] = dict(ms=ms[which],
                                    plain_ms=ms[which + "_plain"],
                                    bound_ms=bound_ms, bound_by=bound_by,
                                    library_ms=lib, max_abs_err=(
                                        err if which == "fwd" else 0.0))
        del tg, lib_out
    return out


def bound_dot(dense, sparse, self_interaction=False) -> tuple:
    """Least time (ms) the card needs for one B7 call on these inputs:
    dense_out and sparse_embs read once and the (B, D + P) output written
    once, vs 2·D FLOPs for each of the B·P kept pairs."""
    from repro_torch.kernels.dot_interaction import n_pairs
    b, f, d = sparse.shape
    esz = sparse.element_size()
    p = n_pairs(f + 1, self_interaction)
    n_bytes = esz * (b * d + b * f * d + b * (d + p))
    ops = 2 * b * p * d
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", n_bytes, ops)


def dot_yardstick(dmod, dense, sparse):
    """B7's library yardstick, two calls: ``torch.bmm(T, Tᵀ)`` and the tril
    ``index_select``, on T = [dense; sparse] concatenated beforehand (the
    copy is not timed); checked against the kernel's pair columns."""
    import torch
    f1 = sparse.shape[1] + 1
    t = torch.cat([dense[:, None, :], sparse], dim=1)
    i, j = torch.tril_indices(f1, f1, offset=-1, device=dense.device)
    flat = i * f1 + j
    lib = lambda: torch.bmm(t, t.transpose(1, 2)).flatten(1).index_select(
        1, flat)
    torch.cuda.synchronize()
    if not torch.allclose(lib(), dmod.dot_interaction_cuda(
            dense, sparse)[:, dense.shape[1]:], atol=DOT_ATOL, rtol=DOT_RTOL):
        raise SystemExit("times: bmm + index_select disagrees with B7")
    return lib


def phase_dot_times(dmod, device, card: str) -> dict:
    """B7 at the dlrm-mlperf scoring (B 512) and training (B 8,192) shapes
    (F 26, D 128, fp32) beside its plain version and its bound. No single
    PyTorch call computes this function; the yardstick is two calls,
    ``torch.bmm(T, Tᵀ)`` and the tril ``index_select``, on T = [dense;
    sparse] already concatenated (and without the dense copy)."""
    import torch
    out = {}
    for key, name in (("score", "score B512 F26 D128"),
                      ("train", "train B8192 F26 D128")):
        dense, sparse = dot_inputs(DOT_SHAPES[name], 100, device)
        kernel = lambda: dmod.dot_interaction_cuda(dense, sparse)
        plain = lambda: dmod.dot_interaction_plain(dense, sparse)
        lib = dot_yardstick(dmod, dense, sparse)
        # plain, kernel, kernel, plain
        ms = {k: device_ms(fn, iters) for k, fn, iters in (
            ("plain", plain, 40), ("kernel", kernel, 200),
            ("again", kernel, 200), ("plain_again", plain, 40),
            ("library", lib, 100))}
        bound_ms, bound_by, n_bytes, ops = bound_dot(dense, sparse)
        print(f"[times] {card}: B7 dot_interaction_fwd {name} fp32, device "
              f"time per call: kernel {ms['kernel']:.5f} ms (again "
              f"{ms['again']:.5f}), plain torch {ms['plain']:.5f} ms (again "
              f"{ms['plain_again']:.5f}); bound {bound_ms:.5f} ms "
              f"({bound_by}: {n_bytes} B, {ops} FLOP at 3.35 TB/s / 67 "
              f"TFLOP/s); library yardstick (two calls: torch.bmm + tril "
              f"index_select) {ms['library']:.5f} ms; host-issued calls: "
              f"kernel {call_ms(kernel, 200):.5f} ms, plain "
              f"{call_ms(plain, 50):.5f} ms")
        out[key] = dict(ms=ms["kernel"], plain_ms=ms["plain"],
                        bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=ms["library"])
    # for the record: DotInteractionFn's plain backward (torch.bmm on the
    # scattered triangle) at the training shape, the other half of its step
    from types import SimpleNamespace
    dense, sparse = dot_inputs(DOT_SHAPES["train B8192 F26 D128"], 101,
                               device)
    ctx = SimpleNamespace(saved_tensors=(dense, sparse),
                          self_interaction=False)
    width = dense.shape[1] + dmod.n_pairs(sparse.shape[1] + 1)
    g = torch.randn((dense.shape[0], width),
                    generator=torch.Generator(device=device).manual_seed(2),
                    device=device)
    bwd = lambda: dmod.DotInteractionFn.backward(ctx, g)
    print(f"[times] {card}: DotInteractionFn plain backward (scatter into "
          f"the triangle, torch.bmm, casts) train B8192 F26 D128 fp32, "
          f"device time per call {device_ms(bwd, 8):.5f} ms, host-issued "
          f"{call_ms(bwd, 8):.5f} ms")
    return out



# ---------------------------------------------------------------------------
# the other recsys archs: two-tower (roo-esr, roo-retrieval), mind, dien,
# bert4rec
# ---------------------------------------------------------------------------

SCENARIO_ITEMS = 50000        # the scenario's ModelSpec: n_items, hist_len
SCENARIO_HIST = 64


def plain_backends():
    """Scoped plain torch attention (torch-dense) and embedding-bag
    backends: what a shadow loss runs on the card."""
    import contextlib
    from repro_torch.kernels import dispatch
    stack = contextlib.ExitStack()
    stack.enter_context(dispatch.use_backend("torch-dense"))
    stack.enter_context(dispatch.use_emb_backend("torch"))
    return stack


def shared_init(init):
    """An init that makes its tree once and hands the same tree to every
    caller: a second Trainer run from it shows that a run leaves the
    caller's tree as it was (the Trainer owns its state)."""
    tree = []

    def once():
        if not tree:
            tree.append(init())
        return tree[0]
    return once


def tt_setup(device, kind="esr", hstu=True, dtype=None):
    """roo-esr / roo-retrieval at ``esr_config`` / ``retrieval_config``
    width in ``"hstu"`` or ``"mlp"`` user-tower mode (seeded random
    params, made once), the scenario's optimizer, ESR's NE metric, the
    train batches, ``two_tower_table_ids`` for sparse rows, and the
    serving halves (retrieval scores: the reference scenario's
    ``_fanout_scores``); params in ``dtype`` (fp32 by default)."""
    import torch
    from repro_torch.configs.roo_models import esr_config, retrieval_config
    from repro_torch.models import two_tower as tt
    from repro_torch.train.metrics import make_ne_metrics
    cfg = (esr_config if kind == "esr" else retrieval_config)(hstu)
    if kind == "esr":
        loss = lambda p, b, gen: tt.esr_loss_roo(p, cfg, b)
        ne = make_ne_metrics(lambda p, b: (tt.esr_logits_roo(p, cfg, b),
                                           b.labels[:, 0],
                                           b.impression_mask()))
        from_user = lambda p, b, u: tt.esr_logits_from_user(p, cfg, b, u)
    else:
        loss = lambda p, b, gen: tt.retrieval_loss_roo(p, cfg, b)
        ne = None
        from_user = lambda p, b, u: tt.retrieval_scores_from_user(p, cfg,
                                                                  b, u)
    user_fn = lambda p, b: tt.user_tower(p, cfg, b)
    return dict(
        cfg=cfg, batches=train_batches(cfg.n_items, cfg.hist_len), loss=loss,
        opt=mixed_optimizer(), ne=ne,
        init=shared_init(lambda: tt.two_tower_init(
            torch.Generator().manual_seed(0), cfg,
            dtype=dtype or torch.float32, device=device)),
        sparse_ids=lambda b: tt.two_tower_table_ids(cfg, b),
        score=lambda p, b: from_user(p, b, user_fn(p, b)), user_fn=user_fn,
        score_from_user=from_user,
        describe=(f"{kind} user tower {cfg.user_tower_mode}"
                  + (f" (HSTU d_model {cfg.hstu.d_model}, {cfg.hstu.n_heads}"
                     f" heads, d_qk = d_v = {cfg.hstu.d_qk}, "
                     f"{cfg.hstu.n_layers} layers)" if hstu else
                     " (mean bag)")
                  + f", user MLP {cfg.user_mlp}, item MLP {cfg.item_mlp}"
                  + (f", ESR head {cfg.esr_mlp}" if cfg.esr_head else "")
                  + f", items {cfg.n_items}, D {cfg.embed_dim}, hist "
                  f"{cfg.hist_len}"))


def recsys_setup(device, name):
    """mind / dien / bert4rec at the reference scenario's registered shapes
    (``MINDConfig``, ``DIENConfig(seq_len=64)``, ``BERT4RecConfig(
    seq_len=65)``, 50,000 items), otherwise as :func:`tt_setup`.
    BERT4Rec's loss draws its cloze mask from the step's generator; it
    declares no tables for sparse rows."""
    import torch
    from repro_torch.models import bert4rec, din_dien, mind
    from repro_torch.train.metrics import make_ne_metrics
    ne = sparse_ids = None
    if name == "mind":
        cfg = mind.MINDConfig(n_items=SCENARIO_ITEMS)
        init = mind.mind_init
        loss = lambda p, b, gen: mind.mind_loss(p, cfg, b)
        score = lambda p, b: mind.score_candidates_roo(p, cfg, b)
        sparse_ids = lambda b: mind.mind_table_ids(cfg, b)
    elif name == "dien":
        cfg = din_dien.DIENConfig(n_items=SCENARIO_ITEMS, seq_len=64)
        init = din_dien.dien_init
        loss = lambda p, b, gen: din_dien.dien_loss(p, cfg, b)
        score = lambda p, b: din_dien.dien_logits_roo(p, cfg, b)
        sparse_ids = lambda b: din_dien.dien_table_ids(cfg, b)
        ne = make_ne_metrics(lambda p, b: (score(p, b), b.labels[:, 0],
                                           b.impression_mask()))
    else:
        cfg = bert4rec.BERT4RecConfig(n_items=SCENARIO_ITEMS, seq_len=65)
        init = bert4rec.bert4rec_init
        loss = lambda p, b, gen: bert4rec.bert4rec_loss(p, cfg, b, gen)
        score = lambda p, b: bert4rec.score_candidates_roo(p, cfg, b)
    return dict(
        cfg=cfg, batches=train_batches(SCENARIO_ITEMS, SCENARIO_HIST),
        loss=loss, opt=mixed_optimizer(), ne=ne, sparse_ids=sparse_ids,
        init=shared_init(lambda: init(torch.Generator().manual_seed(0), cfg,
                                      device=device)),
        score=score, describe=f"{name} {cfg}")


def all_counts(mods) -> dict:
    """Launches of every kernel since the last reset."""
    emod, kmod, pmod, bmod, dmod = mods
    return dict(b1=kmod.launch_count, b2=bmod.dq_launch_count,
                b3=bmod.dkv_launch_count, b4=pmod.launch_count,
                b5=emod.fwd_launch_count, b6=emod.coo_launch_count,
                b7=dmod.launch_count)


def reset_counts(mods) -> None:
    for mod in mods:
        mod.reset_launch_count()


def expected_train_launches(route: str, n_layers: int, steps: int,
                            n_metric: int) -> dict:
    """A run's launches: the hstu user tower B1 = n_layers x (steps + NE
    forwards) and B2 = B3 = n_layers x steps; the mean bag B5 = steps + NE
    forwards and B6 = steps; plain torch archs none."""
    want = dict.fromkeys(("b1", "b2", "b3", "b4", "b5", "b6", "b7"), 0)
    if route == "hstu":
        want.update(b1=n_layers * (steps + n_metric), b2=n_layers * steps,
                    b3=n_layers * steps)
    elif route == "bag":
        want.update(b5=steps + n_metric, b6=steps)
    return want


def phase_arch_train(tag, make_setup, route, mods, device, card,
                     sparse=True, steps=20, tol=None, profile=True) -> dict:
    """One arch's Trainer, ``steps`` steps dense and (``sparse``) on sparse
    rows, from one shared init tree: the launch counts of ``route``
    (``expected_train_launches``), no skipped step, each step's loss
    against the plain backends on the card and against the CPU on the same
    params, batch and generator state; on sparse rows the gradient rule
    and the densified gradients vs the dense path's after the run; a
    second run from the same tree bit for bit; steps/s of a third run.
    The last mode run (sparse where there is one) also gets a per-stage
    breakdown and the card's busy share (``busy_share``) unless
    ``profile`` is false. Losses are held at atol 1e-6 / rtol LOSS_TOL, or
    at ``tol`` (atol and rtol) where given. Returns per mode the launches
    and rates."""
    import numpy as np
    import torch
    from repro_torch.tree import tree_map
    setup, cpu = make_setup(device), make_setup("cpu")
    n_layers = (setup["cfg"].hstu.n_layers if route == "hstu" else 0)
    out = {}
    print(f"[{tag}] {setup['describe']}; {len(setup['batches'])} batches "
          f"of 32 requests / 192 impressions; {steps} steps")
    modes = ("dense", "sparse") if sparse else ("dense",)
    for mode in modes:
        shadows = {"plain": [], "cpu": []}

        def shadow(p, b, gen):
            with plain_backends():
                shadows["plain"].append(setup["loss"](p, b, clone_gen(gen)))
            with plain_backends():      # what the CPU's auto runs too
                shadows["cpu"].append(cpu["loss"](
                    tree_map(lambda x: x.cpu(), p), batch_to(b, "cpu"), gen))
        run = dict(setup, **({"table_ids": setup["sparse_ids"]}
                             if mode == "sparse" else {}))
        reset_counts(mods)
        trainer, state, losses = run_trainer(dict(run, shadow=shadow),
                                             device, steps)
        torch.cuda.synchronize()
        got = all_counts(mods)
        n_metric = sum(1 for row in trainer.history if "ne" in row)
        want = expected_train_launches(route, n_layers, steps, n_metric)
        print(f"[{tag}] {mode}: launches {got}; {n_metric} NE forwards; "
              f"history {trainer.history}")
        if got != want:
            raise SystemExit(f"{tag} {mode}: launches {got} are not {want}")
        if int(state["step"]) != steps or len(losses) != steps \
                or not bool(torch.isfinite(losses).all()) \
                or trainer.skipped_steps:
            raise SystemExit(f"{tag} {mode}: wrong step count, a skipped "
                             f"step or a non-finite loss")
        for what, key in (("the plain backends on the card", "plain"),
                          ("the CPU", "cpu")):
            other = torch.stack(shadows[key]).cpu()
            diff = float((losses - other).abs().max())
            ok = torch.allclose(losses, other, atol=1e-6, rtol=LOSS_TOL) \
                if tol is None else torch.allclose(losses.float(),
                                                   other.float(), atol=tol,
                                                   rtol=tol)
            print(f"[{tag}] {mode}: per-step losses vs {what} on the same "
                  f"params and batch: max|diff| {diff:.3e} ok={ok}")
            if not ok:
                raise SystemExit(f"{tag} {mode}: losses disagree with {what}")
        print(f"[{tag}] {mode}: losses "
              f"{[round(float(v), 6) for v in losses]}")
        if mode == "sparse":
            batch = setup["batches"][steps % len(setup["batches"])].to(device)
            worst, paths = sparse_vs_dense_grads(tag, run, state["params"],
                                                 batch)
            print(f"[{tag}] sparse tables {paths[0]}, dense {paths[1]}; "
                  f"gradients after {steps} steps, sparse (densified) vs "
                  f"dense path: max|diff| {worst[0]:.3e} (at "
                  f"{'/'.join(worst[1])})")
        # from the same init tree again: the first run left it as it was
        _, state_again, again = run_trainer(run, device, steps)
        same_run(f"{tag} {mode}", losses, state, again, state_again)
        del state, state_again
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, state, _ = run_trainer(run, device, steps, halt_after_skips=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        req_per_batch = float(np.mean([
            int(b.request_mask().sum()) for b in setup["batches"][:steps]]))
        out[mode] = dict(launches=got, steps_per_s=steps / wall,
                         requests_per_s=steps * req_per_batch / wall)
        print(f"[{tag}] {mode} {card}: {steps} steps in {wall * 1e3:.1f} ms "
              f"({steps / wall:.2f} steps/s, "
              f"{steps * req_per_batch / wall:.1f} requests/s; Trainer.run "
              f"incl. init and {n_metric} NE forwards)")
        if mode != modes[-1] or not profile:
            continue
        (parts,) = step_breakdown(run, device, state, steps=10, rounds=1)
        busy = busy_share(lambda: run_trainer(run, device, 10,
                                              halt_after_skips=0))
        out[mode].update(breakdown=parts, busy=busy)
        print(f"[{tag}] {mode} {card}: breakdown (ms per step, card "
              f"synchronised after each stage): "
              + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
              + f"; {busy_text(busy)}")
    return out


def busy_share(fn) -> dict:
    """The card's busy share over ``fn()``: the summed durations of the
    device activities (kernels, copies; one stream, so they do not
    overlap) in a ``torch.profiler`` trace of the card alone, over the
    wall time (host clock, ended by a synchronize) of an unprofiled run of
    the same ``fn`` just before. Both wall times are kept, so the
    profiler's own cost is on record; ``busy`` is None when the trace
    shows no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    wall = timed()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        profiled_wall = timed()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + 1e-6 * e.time_range.elapsed_us())
    dev_s = sum(by_name.values())
    return dict(busy=dev_s / wall if dev_s > 0 else None, device_s=dev_s,
                wall_s=wall, profiled_wall_s=profiled_wall,
                top=sorted(by_name.items(), key=lambda kv: -kv[1]))


def top_text(b: dict, n: int = 6) -> str:
    """The trace's ``n`` largest device activities by summed time, each
    with its share of the traced device time."""
    if not b["device_s"]:
        return "no device time in the trace"
    return "; ".join(f"{name[:60]} {1e3 * t:.1f} ms "
                     f"({100 * t / b['device_s']:.1f} %)"
                     for name, t in b["top"][:n])


def busy_text(b: dict, what: str = "a 10-step run") -> str:
    if b["busy"] is None:
        return "card busy not measured (no device time in the trace)"
    return (f"card busy {100 * b['busy']:.1f} % of {what}: device "
            f"{b['device_s'] * 1e3:.1f} ms (traced, card only) over "
            f"{b['wall_s'] * 1e3:.1f} ms unprofiled wall "
            f"({b['profiled_wall_s'] * 1e3:.1f} ms wall while traced)")


def phase_arch_serve(tag, setup, route, mods, device, card,
                     cache=False, tol=LOGIT_TOL) -> dict:
    """One arch's stateless ``ROOServer`` over the simulated stream (16
    batches of 64 x 512): no failed batch, scores aligned and finite,
    launches (hstu tower: B1 = n_layers x batches; the history bag: B5 =
    batches; none elsewhere) and scores within ``tol`` (1e-4) of the
    plain backends on the card and of a CPU server; with ``cache`` the
    user-tower cache over the stream twice (pass 1: B1 = n_layers x, or
    B5 = 1 x, computed batches; pass 2 all full-cache, no launch, the same
    scores). Returns the launches and rates."""
    import numpy as np
    from repro_torch.interop import params_from_numpy, params_to_numpy
    from repro_torch.kernels import dispatch
    from repro_torch.serve.serving import ROOServer, ServeConfig
    cfg, score, params = setup["cfg"], setup["score"], setup["init"]()
    n_layers = cfg.hstu.n_layers if route == "hstu" else 0
    requests = scenario_requests()
    serve_cfg = ServeConfig(b_ro=64, b_nro=512, hist_len=SCENARIO_HIST)
    print(f"[{tag}] {setup['describe']}; {len(requests)} requests, "
          f"{sum(r.num_impressions for r in requests)} impressions")
    ROOServer(params, score, serve_cfg, device=device).score_requests(
        requests[:80])                                  # warm-up
    server = ROOServer(params, score, serve_cfg, device=device)
    reset_counts(mods)
    scores, wall = serve_waves(server, [requests])
    st = server.stats
    got = all_counts(mods)
    print(f"[{tag}] {len(requests)} requests in {wall * 1e3:.1f} ms "
          f"({len(requests) / wall:.1f} requests/s), {st.n_batches} batches "
          f"{st.buckets.snapshot()['counts']}; launches {got}")
    if st.n_failed_batches or len(scores) != len(requests) or any(
            s.shape != (r.num_impressions,) + setup.get("score_shape", ())
            or not np.isfinite(s).all()
            for r, s in zip(requests, scores)):
        raise SystemExit(f"{tag}: a failed batch, or scores misaligned or "
                         f"not finite")
    want = dict.fromkeys(got, 0)
    key, per_batch = ("b5", 1) if route == "bag" else ("b1", n_layers)
    want[key] = per_batch * st.n_batches
    if got != want:
        raise SystemExit(f"{tag}: launches {got} are not {want}")
    dispatch.set_default_backend("torch-dense")
    dispatch.set_default_emb_backend("torch")
    try:
        plain = ROOServer(params, score, serve_cfg,
                          device=device).score_requests(requests)
    finally:
        dispatch.set_default_backend(None)
        dispatch.set_default_emb_backend(None)
    if all_counts(mods) != got:
        raise SystemExit(f"{tag}: the plain-backend server launched a "
                         f"kernel")
    d_plain = max_diff_ok(scores, plain, f"{tag} vs the plain backends",
                          tol)
    cpu_params = params_from_numpy(params_to_numpy(params), "cpu")
    cpu = ROOServer(cpu_params, score, serve_cfg,
                    device="cpu").score_requests(requests[:48])
    d_cpu = max_diff_ok(scores[:48], cpu, f"{tag} vs a CPU server", tol)
    print(f"[{tag}] max|card - plain backends| over scores {d_plain:.3e}; "
          f"max|card - CPU| over 48 requests {d_cpu:.3e}")
    out = dict(launches=got, requests_per_s=len(requests) / wall,
               n_batches=st.n_batches, max_abs_err=max(d_plain, d_cpu))
    if not cache:
        return out
    cached = ROOServer(
        params, score, ServeConfig(b_ro=64, b_nro=512,
                                   hist_len=SCENARIO_HIST,
                                   cache_user_tower=True),
        user_fn=setup["user_fn"], score_from_user=setup["score_from_user"],
        device=device)
    reset_counts(mods)
    first, first_s = serve_waves(cached, [requests])
    cs = cached.stats
    batches_1, full_1, n_1 = (cs.n_batches, cs.n_full_cache_batches,
                              all_counts(mods)[key])
    second, second_s = serve_waves(cached, [requests])
    batches_2 = cs.n_batches - batches_1
    full_2 = cs.n_full_cache_batches - full_1
    n_2 = all_counts(mods)[key] - n_1
    name = key.upper()
    print(f"[{tag} cache] pass 1: {first_s * 1e3:.1f} ms "
          f"({len(requests) / first_s:.1f} requests/s), {batches_1} "
          f"batches, {full_1} full-cache, {name} {n_1}; pass 2: "
          f"{second_s * 1e3:.1f} ms ({len(requests) / second_s:.1f} "
          f"requests/s), {batches_2} batches, {full_2} full-cache, {name} "
          f"{n_2}")
    if full_2 != batches_2 or batches_2 == 0 or n_2 \
            or n_1 != per_batch * (batches_1 - full_1) \
            or cs.n_failed_batches:
        raise SystemExit(f"{tag} cache: the second pass was not all "
                         f"full-cache with 0 {name} launches, or pass 1 "
                         f"launched {name} other than {per_batch} x "
                         f"computed batches")
    d_pass = max_diff_ok(second, first, f"{tag} cache pass 2 vs pass 1",
                         tol)
    d_stateless = max_diff_ok(first, scores, f"{tag} cache vs stateless",
                              tol)
    print(f"[{tag} cache] max|pass 2 - pass 1| {d_pass:.3e}, max|cache "
          f"path - stateless| {d_stateless:.3e}")
    return dict(out, cached_requests_per_s=len(requests) / second_s)


@functools.lru_cache(maxsize=None)
def scenario_requests() -> list:
    """The 1,000-request serving stream at the scenario's n_items and
    hist_len (made once)."""
    import types
    return make_requests(types.SimpleNamespace(n_items=SCENARIO_ITEMS,
                                               hist_len=SCENARIO_HIST), 1000)


def phase_tt_bag(emod, device, card) -> dict:
    """The embedding-bag kernels at the two-tower ``"mlp"`` user tower's
    mean bag (B_RO 32 bags of up to 64 history ids, D 64), on the operands
    the main path hands B5, recorded from one step: the dense 50,000-row
    item table and, on sparse rows, its gathered rows + a zero row (ids as
    positions). B5 against plain within BAG_TOL, B6 bit for bit plain, and
    each timed beside plain, its bound and one PyTorch call
    (``F.embedding_bag`` mean; B6: the backward of a ``sparse=True``
    call). Returns the numbers for the kernels' JSON line by (table,
    "fwd" | "coo")."""
    import torch
    import torch.nn.functional as F
    from repro_torch.embeddings.sparse import sparse_forward
    from repro_torch.train.loop import value_and_grad
    setup = tt_setup(device, "esr", hstu=False)
    params = setup["init"]()
    batch = setup["batches"][0].to(device)
    groups = {
        "dense table": record_groups(emod, lambda: value_and_grad(
            setup["loss"])(params, batch, None))[0],
        "gathered rows": record_groups(emod, lambda: sparse_forward(
            setup["loss"], setup["sparse_ids"], params, batch, None))[0]}
    out = {}
    for name, (tables, ids, lens) in groups.items():
        b, f, l = ids.shape
        vocabs = [t.shape[0] for t in tables]
        g = torch.randn((b, f, tables[0].shape[1]), device=device,
                        generator=torch.Generator(device=device)
                        .manual_seed(67))
        fwd = lambda: emod.embedding_bag_grouped_fwd_cuda(tables, ids, lens,
                                                          "mean")
        fwd_plain = lambda: emod.embedding_bag_grouped_plain(tables, ids,
                                                             lens, "mean")
        coo = lambda: emod.embedding_bag_grouped_coo_rows_cuda(
            g, ids, lens, vocabs, "mean")
        coo_plain = lambda: emod.embedding_bag_grouped_coo_rows_plain(
            g, ids, lens, vocabs, "mean")
        err = float((fwd() - fwd_plain()).abs().max())
        same = all(torch.equal(a, p) for a, p in zip(coo(), coo_plain()))
        again = torch.equal(fwd(), fwd())
        print(f"[tt bag] {name}: B5 mean B{b} F{f} L{l} over {vocabs} rows: "
              f"max|B5 - plain| {err:.3e}; B6 bit for bit plain {same}; B5 "
              f"twice bit for bit {again}")
        if err > BAG_TOL or not same or not again:
            raise SystemExit(f"tt bag: {name}: B5 off plain by {err:.3e}, "
                             f"B6 not plain, or B5 not bitwise on repeat")
        lens_c = lens[:, 0].clamp(0, l)
        valid = torch.arange(l, device=device)[None, :] < lens_c[:, None]
        flat = ids[:, 0, :].long().clamp(0, vocabs[0] - 1)[valid]
        offsets = (torch.cumsum(lens_c, 0) - lens_c).long()
        lib_fwd = lambda: F.embedding_bag(flat, tables[0], offsets,
                                          mode="mean")
        tg = tables[0].detach().requires_grad_(True)
        lib_out = F.embedding_bag(flat, tg, offsets, mode="mean",
                                  sparse=True)
        g0 = g[:, 0, :].contiguous()
        lib_bwd = lambda: torch.autograd.grad(lib_out, tg, g0,
                                              retain_graph=True)
        ms = {key: labelled_device_ms(key, fn, iters) for key, fn, iters in (
            ("fwd_plain", fwd_plain, 40), ("fwd", fwd, 200),
            ("coo", coo, 200), ("coo_plain", coo_plain, 40),
            ("lib_fwd", lib_fwd, 100))}
        try:
            ms["lib_coo"] = device_ms(lib_bwd, 20)
        except SystemExit:
            ms["lib_coo"] = None        # it synchronises the host
        x = dict(tables=tables, ids=ids, lens=lens)
        for which, label in (("fwd", "B5 embedding_bag_fwd_grouped"),
                             ("coo", "B6 embedding_bag_bwd_coo_grouped")):
            bound_ms, bound_by, n_bytes, ops = bound_group(x, which)
            lib = ms["lib_" + which]
            print(f"[times] {card}: {label} mean, two-tower mlp tower "
                  f"({name}) B{b} L{l} D{tables[0].shape[1]} V{vocabs[0]}, "
                  f"device time per call: kernel {ms[which]:.5f} ms, plain "
                  f"torch {ms[which + '_plain']:.5f} ms; bound "
                  f"{bound_ms:.5f} ms ({bound_by}: {n_bytes} B, {ops} "
                  f"FLOP); library " + ("-" if lib is None else
                                        f"{lib:.5f} ms"))
            out[name, which] = dict(
                ms=ms[which], plain_ms=ms[which + "_plain"],
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib,
                max_abs_err=err if which == "fwd" else 0.0)
        del tg, lib_out
    return out


# ---------------------------------------------------------------------------
# the scenario layer's entry points: train_from_scenario,
# ScoringEngine.from_scenario, the launcher, obs and fault injection
# ---------------------------------------------------------------------------

SCENARIO_STEPS = 20
# every registered scenario, and roo-lsr's userarch variant: the scenario
# path's route to the bag kernels outside dlrm (the default variant,
# userarch_hstu, encodes the history with HSTU)
SCENARIO_RUNS = (("roo-lsr", None), ("roo-lsr", "userarch"),
                 ("roo-esr", None), ("roo-retrieval", None),
                 ("hstu-gr", None), ("dien", None), ("mind", None),
                 ("bert4rec", None), ("dlrm-mlperf", None))
PLAIN_KNOBS = {"knobs.attn_backend": "torch-dense",
               "knobs.emb_backend": "torch"}
ENGINE_SPANS = ("engine.flush", "engine.bucket", "engine.score",
                "engine.admit", "engine.reassemble")
TRAIN_SPANS = ("train.step", "train.data", "train.compute", "train.log",
               "train.checkpoint")
KERNEL_NAMES = ("hstu_fwd_kernel", "hstu_bwd_dq_kernel",
                "hstu_bwd_dkv_kernel")


@contextlib.contextmanager
def spec_scope(dot_backend=None):
    """A spec's ``apply()`` installs its knobs as process defaults (the
    backends, the fault plan, the obs mode); every port knob's state is
    put back when the block ends. ``dot_backend`` scopes B7's ladder,
    which has no spec field."""
    import repro_torch.embeddings.collection  # noqa: F401 (its knob)
    import repro_torch.obs.log  # noqa: F401 (its knob)
    import repro_torch.reliability.faults  # noqa: F401 (its knob)
    from repro_torch.kernels import dispatch
    from repro_torch.scenario import knobs
    saved = {name: k.snapshot() for name, k in knobs.REGISTRY.items()}
    try:
        with dispatch.use_dot_backend(dot_backend):
            yield
    finally:
        for name, state in saved.items():
            knobs.REGISTRY[name].restore(state)


def build_dir() -> Path:
    """The checkout's ``build/`` (gitignored): checkpoints, traces and
    telemetry of the scenario phases go under it."""
    path = ROOT / "build"
    path.mkdir(exist_ok=True)
    return path


def scenario_spec(arch, variant=None, extra=None):
    """The registered scenario at full width, 20 steps logged every step
    (each step's loss, and NE where the arch has it), one checkpoint."""
    from repro_torch.configs.registry import scenario
    over = {"train.steps": SCENARIO_STEPS, "train.log_every": 1,
            "train.ckpt_every": SCENARIO_STEPS}
    if variant:
        over["model.variant"] = variant
    over.update(extra or {})
    return scenario(arch, over)


def scenario_tag(spec) -> str:
    return spec.model.arch + (f" {spec.model.variant}"
                              if spec.model.variant else "")


def scenario_route(spec) -> tuple:
    """(route, HSTU layers) of a spec's model, read from the port's
    configs: "hstu" (B1-B3) for hstu-gr, the two-tower "hstu" user tower
    and roo-lsr's userarch_hstu history encoder; "bag" (B5/B6) for
    roo-lsr's baseline / userarch history bag; "dlrm" (B5/B6 a side, B7);
    "none" for mind, dien and bert4rec."""
    from repro_torch.configs import roo_models as rm
    from repro_torch.models.lsr import _hstu_cfg
    arch = spec.model.arch
    if arch == "dlrm-mlperf":
        return "dlrm", 0
    if arch == "roo-lsr":
        cfg = rm.lsr_config(spec.model.variant or "userarch_hstu")
        if cfg.mode == "userarch_hstu":
            return "hstu", _hstu_cfg(cfg).n_layers
        if cfg.mode in ("baseline", "userarch"):
            return "bag", 0
        raise SystemExit(f"scenario: no launch rule for lsr {cfg.mode}")
    if arch in ("roo-esr", "roo-retrieval"):
        cfg = rm.esr_config() if arch == "roo-esr" else rm.retrieval_config()
        return ("hstu", cfg.hstu.n_layers) if cfg.user_tower_mode == "hstu" \
            else ("bag", 0)
    if arch == "hstu-gr":
        return "hstu", rm.gr_config(spec.model.hist_len,
                                    spec.model.m_targets).hstu.n_layers
    return "none", 0


def scenario_train_launches(spec, steps: int, n_metric: int) -> dict:
    """A scenario run's launches: ``expected_train_launches`` for the HSTU
    and bag routes; dlrm's ROO forward launches B5 once a side and B7 once,
    its backward B6 once a side."""
    route, n_layers = scenario_route(spec)
    if route != "dlrm":
        return expected_train_launches(route, n_layers, steps, n_metric)
    want = expected_train_launches("none", 0, steps, n_metric)
    want.update(b5=2 * (steps + n_metric), b6=2 * steps,
                b7=steps + n_metric)
    return want


def scenario_serve_launches(spec, n_scored: int) -> dict:
    """Launches of ``n_scored`` batches through the model's forward: B1 a
    layer (HSTU), B5 once (the history bag)."""
    route, n_layers = scenario_route(spec)
    want = expected_train_launches("none", 0, 0, 0)
    if route == "hstu":
        want["b1"] = n_layers * n_scored
    elif route == "bag":
        want["b5"] = n_scored
    return want


def train_run(spec, mods, device, ckpt_dir=None, dot_backend=None,
              telemetry_path=None, shard_dir=None, prints=False):
    """One ``train_from_scenario`` run (knobs put back after): the
    trainer, its state, each logged step's loss and the launches."""
    import torch
    from repro_torch.scenario.build import train_from_scenario
    reset_counts(mods)
    with spec_scope(dot_backend):
        trainer, state = train_from_scenario(
            spec, ckpt_dir=ckpt_dir, prints=prints, device=device,
            telemetry_path=telemetry_path, shard_dir=shard_dir)
        torch.cuda.synchronize()
    losses = torch.tensor([row["loss"] for row in trainer.history],
                          dtype=torch.float64)
    return trainer, state, losses, all_counts(mods)


def shadow_run(spec, device, shard_dir=None):
    """The spec's run again, through ``_train_from_scenario``'s ``bundle``
    seam with ``build_model``'s bundle (the same params) whose loss is
    shadowed at each step by the same loss on the plain backends, on the
    same params, batch and generator state, outside autograd. Returns the
    trainer, the state, each step's loss (logged) and the shadow's."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.scenario import build
    from repro_torch.tree import tree_map
    shadows = []
    with spec_scope():
        spec.validate()
        build.refuse_unported(spec, training=True)
        spec.apply()
        bundle = build.build_model(spec, torch.Generator().manual_seed(0),
                                   device=device)
        loss = bundle.loss_fn

        def shadowed(p, b, gen):
            with torch.no_grad(), plain_backends(), \
                    dispatch.use_dot_backend("torch"):
                shadows.append(loss(tree_map(lambda x: x.detach(), p), b,
                                    clone_gen(gen)).detach())
            return loss(p, b, gen)
        trainer, state = build._train_from_scenario(
            spec, ckpt_dir=None, rng_seed=0, prints=False, device=device,
            shard_dir=shard_dir, bundle=bundle._replace(loss_fn=shadowed))
        torch.cuda.synchronize()
    losses = torch.tensor([row["loss"] for row in trainer.history],
                          dtype=torch.float64)
    return trainer, state, losses, torch.stack(shadows).double().cpu()


def phase_scenario_train(mods, device, card: str) -> dict:
    """Each registered scenario (and roo-lsr ``userarch``) trained through
    ``train_from_scenario`` at full width for 20 steps, logged every step:
    the launches its route implies, no skipped step, finite losses, the
    checkpoint meta's scenario name and hash. Then: the run again with
    each step's loss shadowed by the same loss on the plain backends
    (torch-dense attention, torch bags, B7's scoped torch rung) on the
    same params (``shadow_run``): losses and final params bit for bit the
    first run's, the plain losses within rtol 1e-5; the same spec on the
    plain backends (no launch) for 2 steps: its first loss, on the same
    init params and batch, within rtol 1e-5 (from there the runs part, as
    free-running trajectories do: printed, not gated); a third run logged
    at steps 10 and 20 (its steps/s the rate), bit for bit in those
    losses and the final params; and for the archs that declare tables
    the ``train.sparse_emb`` twin, its launches and its first step's loss
    equal to the dense run's. Returns per run the launches, the rate and
    the trained params (for the serving phase)."""
    import tempfile
    import torch
    out = {}
    for arch, variant in SCENARIO_RUNS:
        spec = scenario_spec(arch, variant)
        tag = f"scenario train {scenario_tag(spec)}"
        with tempfile.TemporaryDirectory(dir=str(build_dir())) as tmp:
            trainer, state, losses, got = train_run(spec, mods, device,
                                                    ckpt_dir=tmp)
            meta = json.loads((Path(tmp) / f"step_{SCENARIO_STEPS:012d}"
                               / "meta.json").read_text())
        n_metric = sum(1 for row in trainer.history if "ne" in row)
        want = scenario_train_launches(spec, SCENARIO_STEPS, n_metric)
        print(f"[{tag}] spec {spec.content_hash()}: {spec.model}, batcher "
              f"{spec.batcher.b_ro} / {spec.batcher.b_nro}, data "
              f"{spec.data.source} {spec.data.n_requests} requests; "
              f"launches {got}; {n_metric} NE forwards; checkpoint meta "
              f"{meta.get('scenario')} {meta.get('scenario_hash')}; losses "
              f"{[round(float(v), 6) for v in losses]}")
        if got != want:
            raise SystemExit(f"{tag}: launches {got} are not {want}")
        if int(state["step"]) != SCENARIO_STEPS \
                or len(losses) != SCENARIO_STEPS \
                or not bool(torch.isfinite(losses).all()) \
                or trainer.skipped_steps:
            raise SystemExit(f"{tag}: wrong step count, a skipped step or a "
                             f"non-finite loss")
        if meta.get("scenario") != spec.name \
                or meta.get("scenario_hash") != spec.content_hash():
            raise SystemExit(f"{tag}: checkpoint meta {meta} does not carry "
                             f"the spec's name and hash")

        _, twin_state, twin, shadow = shadow_run(spec, device)
        same_run(f"{tag} with a plain-backend shadow", losses, state, twin,
                 twin_state)
        diff = float((losses - shadow).abs().max())
        ok = torch.allclose(losses, shadow, atol=1e-6, rtol=LOSS_TOL)
        print(f"[{tag}] each step's loss vs the plain backends on the same "
              f"params: max|diff| {diff:.3e} ok={ok}")
        if not ok:
            raise SystemExit(f"{tag}: the losses disagree with the plain "
                             f"backends")
        del twin_state

        _, _, plain, plain_got = train_run(
            spec.with_overrides(dict(PLAIN_KNOBS, **{"train.steps": 2})),
            mods, device, dot_backend="torch")
        first = abs(float(plain[0]) - float(losses[0]))
        print(f"[{tag}] the spec on the plain backends: launches "
              f"{plain_got}; first loss vs the kernels' {first:.3e} (same "
              f"init params and batch), second "
              f"{abs(float(plain[1]) - float(losses[1])):.3e} "
              f"(after one step of each: not gated)")
        if any(plain_got.values()) or not torch.allclose(
                plain[:1], losses[:1], atol=1e-6, rtol=LOSS_TOL):
            raise SystemExit(f"{tag}: the plain-backend spec launched a "
                             f"kernel, or its first loss disagrees")

        rate_spec = spec.with_overrides({"train.log_every": 10})
        again, state_again, logged, _ = train_run(rate_spec, mods, device)
        same_run(f"{tag} logged at steps 10 and 20", losses[[9, 19]], state,
                 logged, state_again)
        rate = again.history[-1]["steps_per_s"]
        print(f"[{tag}] {card}: {rate:.2f} steps/s (the third run, "
              f"Trainer.run's own clock: the 20 steps and 2 logging reads, "
              f"NE included)")
        out[arch, variant] = dict(launches=got, steps_per_s=rate,
                                  params=state["params"], spec=spec)
        del state_again

        if arch == "bert4rec":         # the cloze head is dense by design
            continue
        sparse = spec.with_overrides({"train.sparse_emb": True})
        s_trainer, _, s_losses, s_got = train_run(sparse, mods, device)
        s_want = scenario_train_launches(
            sparse, SCENARIO_STEPS,
            sum(1 for row in s_trainer.history if "ne" in row))
        print(f"[{tag}] train.sparse_emb: launches {s_got}; first step's "
              f"loss {float(s_losses[0])!r} vs dense {float(losses[0])!r}; "
              f"last {float(s_losses[-1]):.6f} vs dense "
              f"{float(losses[-1]):.6f}")
        if s_got != s_want or float(s_losses[0]) != float(losses[0]) \
                or not bool(torch.isfinite(s_losses).all()) \
                or s_trainer.skipped_steps:
            raise SystemExit(f"{tag}: sparse twin: launches {s_got} (want "
                             f"{s_want}), or its first loss is not the "
                             f"dense run's, or a loss is not finite")
        out[arch, variant]["sparse_launches"] = s_got
    return out


def serve_pass(engine, requests, mods):
    """One pass of ``requests`` through ``engine``: scores, wall seconds,
    the launches and the batches scored in it."""
    n0 = engine.stats.n_batches
    reset_counts(mods)
    scores, wall = serve_waves(engine, [requests])
    return scores, wall, all_counts(mods), engine.stats.n_batches - n0


def check_served(tag, requests, scores, engine) -> None:
    import numpy as np
    if engine.stats.n_failed_batches or len(scores) != len(requests) or any(
            s.shape[0] != r.num_impressions or not np.isfinite(s).all()
            for r, s in zip(requests, scores)):
        raise SystemExit(f"{tag}: a failed batch, or scores misaligned or "
                         f"not finite")


def phase_scenario_serve(mods, device, card: str, trained: dict) -> dict:
    """Each servable scenario through ``ScoringEngine.from_scenario`` on its
    trained params over the spec's own ``build_samples`` stream (800
    requests): the launches of its route a scored batch, aligned finite
    scores within 1e-4 of the same spec on the plain backends (no
    launch); ``serve.cache_user_tower`` where the adapter splits (pass 2
    all full-cache, no launch; scores vs stateless); for hstu-gr
    ``serve.incremental`` (B4 = layers x incremental batches, B1 0; scores
    vs stateless). Returns requests/s per run and the launches."""
    from repro_torch.scenario.build import build_samples
    from repro_torch.serve.engine import ScoringEngine
    out = {}
    for (arch, variant), run in trained.items():
        if arch == "dlrm-mlperf":
            continue
        spec = run["spec"]
        tag = f"scenario serve {scenario_tag(spec)}"
        requests = build_samples(spec)
        route, n_layers = scenario_route(spec)
        with spec_scope():
            ScoringEngine.from_scenario(spec, params=run["params"],
                                        device=device).score_requests(
                requests[:80])                            # warm-up
            engine = ScoringEngine.from_scenario(spec, params=run["params"],
                                                 device=device)
            scores, wall, got, n = serve_pass(engine, requests, mods)
        check_served(tag, requests, scores, engine)
        want = scenario_serve_launches(spec, n)
        print(f"[{tag}] {len(requests)} requests in {wall * 1e3:.1f} ms "
              f"({len(requests) / wall:.1f} requests/s, {card}), {n} "
              f"batches {engine.stats.buckets.snapshot()['counts']}; "
              f"launches {got}")
        if got != want:
            raise SystemExit(f"{tag}: launches {got} are not {want}")
        with spec_scope("torch"):
            plain_engine = ScoringEngine.from_scenario(
                spec.with_overrides(PLAIN_KNOBS), params=run["params"],
                device=device)
            plain, _, plain_got, _ = serve_pass(plain_engine, requests, mods)
        d_plain = max_diff_ok(scores, plain, f"{tag} vs the plain backends")
        if any(plain_got.values()):
            raise SystemExit(f"{tag}: the plain-backend engine launched "
                             f"{plain_got}")
        row = dict(requests_per_s=len(requests) / wall, launches=got)
        msg = f"max|card - plain backends| {d_plain:.3e}"
        if engine.adapter.supports_user_cache:
            with spec_scope():
                cached = ScoringEngine.from_scenario(
                    spec.with_overrides({"serve.cache_user_tower": True}),
                    params=run["params"], device=device)
                first, _, got_1, n_1 = serve_pass(cached, requests, mods)
                full_1 = cached.stats.n_full_cache_batches
                second, wall_2, got_2, n_2 = serve_pass(cached, requests,
                                                        mods)
            full_2 = cached.stats.n_full_cache_batches - full_1
            d_cache = max_diff_ok(second, scores, f"{tag} cache vs stateless")
            max_diff_ok(first, scores, f"{tag} cache pass 1 vs stateless")
            # the towers' cache holds the encoded user side, hstu-gr's the
            # embedded history only: its encoder (B1) runs on every batch
            encodes = arch == "hstu-gr"
            want_1 = scenario_serve_launches(spec, n_1 if encodes
                                             else n_1 - full_1)
            want_2 = scenario_serve_launches(spec, n_2 if encodes else 0)
            if got_1 != want_1 or full_2 != n_2 or got_2 != want_2:
                raise SystemExit(f"{tag}: cache pass 1 launched {got_1} "
                                 f"(want {want_1}), or pass 2 was not all "
                                 f"full-cache ({full_2} / {n_2}) with "
                                 f"{want_2} launches ({got_2})")
            row["cached_requests_per_s"] = len(requests) / wall_2
            msg += (f"; cache: pass 2 {full_2} / {n_2} full-cache, "
                    f"{len(requests) / wall_2:.1f} requests/s, max|cache - "
                    f"stateless| {d_cache:.3e}")
        if engine.adapter.supports_incremental:
            with spec_scope():
                inc = ScoringEngine.from_scenario(
                    spec.with_overrides({"serve.incremental": True}),
                    params=run["params"], device=device)
                inc_scores, inc_wall, inc_got, _ = serve_pass(inc, requests,
                                                              mods)
            n_inc = inc.stats.n_incremental_batches
            d_inc = max_diff_ok(inc_scores, scores,
                                f"{tag} incremental vs stateless")
            inc_want = scenario_serve_launches(spec, 0)
            inc_want["b4"] = n_layers * n_inc
            hits = inc.state_store.stats.hits
            if inc_got != inc_want or not n_inc or not hits:
                raise SystemExit(f"{tag}: incremental launches {inc_got} "
                                 f"are not {inc_want}, or no state hit")
            row.update(incremental_requests_per_s=len(requests) / inc_wall,
                       b4=inc_got["b4"])
            msg += (f"; incremental: {n_inc} batches, {hits} state hits, "
                    f"launches {inc_got}, {len(requests) / inc_wall:.1f} "
                    f"requests/s, max|incremental - stateless| {d_inc:.3e}")
        print(f"[{tag}] {msg}")
        out[arch, variant] = row
    return out


def launcher(argv, env, out_path):
    """Start ``python -m repro_torch.launch.train`` with ``argv`` (on the
    card: no --device), its output to ``out_path``."""
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *argv],
        cwd=str(ROOT), env=env, stdout=open(out_path, "w"),
        stderr=subprocess.STDOUT)


def npz_payload(path):
    import numpy as np
    with np.load(path) as data:
        return {k: (data[k].dtype.str, data[k].shape, data[k].tobytes())
                for k in data.files}


def phase_launcher(card: str) -> None:
    """``python -m repro_torch.launch.train`` as a subprocess on the card
    (its default device) for roo-lsr and dlrm-mlperf: ``--arch X --steps
    20`` against ``--config`` of its own ``--dump-config`` (written in this
    process: it touches no card), the four runs started together; the checkpoints' arrays bit for bit, equal meta
    digests and scenario hashes, and each run's printed line naming
    device=cuda."""
    import os
    import shutil
    import tempfile
    from repro_torch.launch.train import main as dump_config
    env = dict(os.environ, PYTHONPATH=str(SRC))
    tmp = Path(tempfile.mkdtemp(prefix="launcher_", dir=str(build_dir())))
    procs = {}
    try:
        for arch in ("roo-lsr", "dlrm-mlperf"):
            flags = ["--arch", arch, "--steps", str(SCENARIO_STEPS), "--set",
                     f"train.ckpt_every={SCENARIO_STEPS}"]
            cfg = tmp / f"{arch}.json"
            dump_config(flags + ["--dump-config", str(cfg)])
            for how, argv in (("flags", flags),
                              ("config", ["--config", str(cfg)])):
                ckpt = tmp / f"{arch}_{how}"
                procs[arch, how] = (launcher(
                    argv + ["--ckpt-dir", str(ckpt)], env,
                    tmp / f"{arch}_{how}.log"), ckpt)
        for (arch, how), (proc, _) in procs.items():
            if proc.wait(timeout=600):
                raise SystemExit(f"launcher: {arch} {how} exited "
                                 f"{proc.returncode}: "
                                 + (tmp / f"{arch}_{how}.log").read_text())
        for arch in ("roo-lsr", "dlrm-mlperf"):
            step = f"step_{SCENARIO_STEPS:012d}"
            runs = {how: procs[arch, how][1] / step
                    for how in ("flags", "config")}
            metas = {how: json.loads((d / "meta.json").read_text())
                     for how, d in runs.items()}
            lines = {how: [line for line in (
                tmp / f"{arch}_{how}.log").read_text().splitlines()
                if "train-done" in line][-1] for how in runs}
            same = (npz_payload(runs["flags"] / "arrays.npz")
                    == npz_payload(runs["config"] / "arrays.npz"))
            meta_same = (metas["flags"]["digests"]
                         == metas["config"]["digests"]
                         and metas["flags"]["scenario_hash"]
                         == metas["config"]["scenario_hash"])
            print(f"[launcher] {arch} {card}: flags: {lines['flags']}")
            print(f"[launcher] {arch} {card}: config: {lines['config']}")
            print(f"[launcher] {arch}: checkpoints bit for bit {same}, meta "
                  f"digests and scenario hash equal {meta_same}")
            if not same or not meta_same or any(
                    "device=cuda" not in line for line in lines.values()):
                raise SystemExit(f"launcher: {arch}: the flag and --config "
                                 f"runs differ, or did not run on the card")
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def phase_obs(mods, device, card: str) -> dict:
    """obs on the card, hstu-gr: one serve-and-train run under
    ``obs.mode=trace`` with a telemetry file; the Chrome trace holds the
    ``engine.*`` and ``train.*`` spans, ``repro_torch.obs.report``
    summarizes the JSONL, and ``device_trace`` around five steps holds
    CUDA kernel events of B1-B3. Then one stream served with obs off, in
    metrics and in trace mode, twice each in turns: requests/s of each."""
    import io
    import shutil
    import tempfile
    from repro_torch.obs import export as obs_export
    from repro_torch.obs import report
    from repro_torch.obs import trace as obs_trace
    from repro_torch.scenario.build import build_samples
    from repro_torch.serve.engine import ScoringEngine
    spec = scenario_spec("hstu-gr", extra={"obs.mode": "trace",
                                           "train.log_every": 5,
                                           "train.ckpt_every": 10,
                                           "train.steps": 10})
    requests = build_samples(spec)[:200]
    tmp = Path(tempfile.mkdtemp(prefix="obs_", dir=str(build_dir())))
    try:
        tel = tmp / "telemetry.jsonl"
        obs_trace.get_tracer().clear()
        emitter = obs_export.TelemetryEmitter(
            str(tel), scenario_hash=spec.content_hash())
        with spec_scope():
            obs_export.install(emitter)
            try:
                engine = ScoringEngine.from_scenario(spec, device=device)
                engine.score_requests(requests)
            finally:
                obs_export.install(None)
                emitter.close(final_source="serve.final")
            trainer, _, _, _ = train_run(spec, mods, device,
                                         ckpt_dir=str(tmp / "ckpt"),
                                         telemetry_path=str(tel))
        n_events = obs_trace.get_tracer().save(str(tmp / "trace.json"))
        names = {e["name"] for e in json.loads(
            (tmp / "trace.json").read_text())["traceEvents"]}
        missing = [n for n in ENGINE_SPANS + TRAIN_SPANS if n not in names]
        summary = io.StringIO()
        report.summarize(report.load_lines(str(tel)), out=summary)
        text = summary.getvalue()
        sources = [x["source"] for x in report.load_lines(str(tel))]
        print(f"[obs] trace: {n_events} events, spans "
              f"{sorted(n for n in names if '.' in n)}; telemetry lines "
              f"{sources}")
        print("[obs] report:\n" + "\n".join(
            "    " + line for line in text.splitlines()))
        if missing or "span.train.step" not in text \
                or "span.engine.score" not in text \
                or "serve.flush" not in sources or "train.log" not in sources:
            raise SystemExit(f"obs: spans {missing} missing from the trace, "
                             f"or the report / telemetry lacks the engine "
                             f"or the trainer")

        five = spec.with_overrides({"obs.mode": "off", "train.steps": 5,
                                    "train.log_every": 5})
        with obs_trace.device_trace(str(tmp / "device")) as path:
            train_run(five, mods, device)
        if path is None:
            raise SystemExit("obs: device_trace did not start the profiler")
        events = json.loads(Path(path).read_text())["traceEvents"]
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        found = {k: sum(k in n for n in kernels) for k in KERNEL_NAMES}
        print(f"[obs] device_trace over 5 steps: {len(kernels)} kernel "
              f"events; the port's kernels {found}")
        if not all(found.values()):
            raise SystemExit(f"obs: the device trace lacks a port kernel "
                             f"({found})")
    finally:
        obs_trace.get_tracer().clear()
        shutil.rmtree(tmp, ignore_errors=True)

    rates = {}
    for mode in ("off", "metrics", "trace", "trace", "metrics", "off"):
        run = spec.with_overrides({"obs.mode": mode})
        with spec_scope():
            engine = ScoringEngine.from_scenario(run, device=device)
            engine.score_requests(requests)                    # warm-up
            _, wall = serve_waves(engine, [requests])
        rates.setdefault(mode, []).append(len(requests) / wall)
        obs_trace.get_tracer().clear()
    print(f"[obs] {card}: hstu-gr, {len(requests)} requests, requests/s by "
          f"obs mode (in the order off, metrics, trace, trace, metrics, "
          f"off; each engine warmed up on the stream first): "
          + ", ".join(f"{m} " + " / ".join(f"{r:.1f}" for r in v)
                      for m, v in rates.items()))
    return rates


def phase_faults(mods, device, card: str) -> None:
    """Fault injection on the card. A served hstu-gr stream under
    ``seed=7;engine.score:error@0.25`` (breaker off, trace on): the
    batches whose ``engine.score`` visit fires (replayed from a fresh plan
    on the same string) are exactly those whose requests resolve to
    ``ScoreError``, and every other score equals the fault-free run's bit
    for bit. A training run under ``train.batch:nan@0.2x2`` with
    ``train.halt_after_skips=5`` (roo-lsr) skips exactly 2 steps and ends
    finite."""
    import numpy as np
    import torch
    from repro_torch.obs import trace as obs_trace
    from repro_torch.reliability import FaultPlan
    from repro_torch.scenario.build import build_samples
    from repro_torch.serve.engine import ScoreError, ScoringEngine
    from repro_torch.tree import leaves
    text = "seed=7;engine.score:error@0.25"
    spec = scenario_spec("hstu-gr", extra={"serve.breaker_threshold": 0,
                                           "obs.mode": "trace"})
    requests = build_samples(spec)
    params = None
    runs = {}
    for name, over in (("clean", {}), ("faulty", {"knobs.faults": text})):
        obs_trace.get_tracer().clear()
        with spec_scope():
            engine = ScoringEngine.from_scenario(
                spec.with_overrides(over), params=params, device=device)
            params = engine.params
            runs[name] = (engine.score_requests(requests),
                          obs_trace.get_tracer().events(), engine.stats)
    obs_trace.get_tracer().clear()
    scores, events, stats = runs["faulty"]
    admits = [e["args"]["trace_id"] for e in events
              if e["name"] == "engine.admit"]
    index = {tid: i for i, tid in enumerate(admits)}
    batches = [[index[t] for t in e["args"]["trace_ids"]]
               for e in events if e["name"] == "engine.score"]
    replay = FaultPlan.parse(text)
    fired = [replay.fire("engine.score") is not None for _ in batches]
    want_failed = sorted(i for b, f in zip(batches, fired) if f for i in b)
    failed = sorted(i for i, s in enumerate(scores)
                    if isinstance(s, ScoreError))
    clean = runs["clean"][0]
    same = all(np.array_equal(s, clean[i]) for i, s in enumerate(scores)
               if not isinstance(s, ScoreError))
    print(f"[faults] served {len(requests)} requests in {len(batches)} "
          f"batches under {text!r}: {sum(fired)} fired visits, "
          f"{stats.n_failed_batches} failed batches, {len(failed)} requests "
          f"resolved to ScoreError (the fired batches' requests: "
          f"{failed == want_failed}); every other score bit for bit the "
          f"fault-free run's {same}")
    if failed != want_failed or not failed or not same \
            or stats.n_failed_batches != sum(fired):
        raise SystemExit("faults: the failed requests are not exactly the "
                         "fired batches', or a surviving score changed")

    # roo-lsr: its loss reads ro_dense, the batch's first float leaf
    nan_plan = "train.batch:nan@0.2x2"
    nan = scenario_spec("roo-lsr", extra={
        "knobs.faults": nan_plan, "train.halt_after_skips": 5,
        "train.log_every": 10})
    replay = FaultPlan.parse(nan_plan)
    fires = [i + 1 for i in range(SCENARIO_STEPS)
             if replay.fire("train.batch") is not None]
    trainer, state, _, _ = train_run(nan, mods, device)
    finite = all(bool(torch.isfinite(p).all())
                 for p in leaves(state["params"]))
    print(f"[faults] roo-lsr training under {nan_plan!r} (fires at steps "
          f"{fires}): skipped_steps {trainer.skipped_steps}, params finite "
          f"{finite}, history {trainer.history}")
    if trainer.skipped_steps != 2 or not finite \
            or int(state["step"]) != SCENARIO_STEPS:
        raise SystemExit("faults: the poisoned run did not skip exactly 2 "
                         "steps and end finite")


DISK_STEPS = 60               # two epoch boundaries of the ~25-batch stream
DISK_CKPT_EVERY = 20
DISK_KILL = 30                # the killed run's last step; its last commit: 20
DISK_RUNS = (("hstu-gr", None), ("roo-lsr", "userarch"))
PIPELINE_SPANS = ("pipeline.read", "pipeline.decode", "pipeline.pack",
                  "pipeline.device_put", "train.data", "train.step")


def disk_spec(arch, variant=None, extra=None):
    """The registered scenario at full width on ``data.source="disk"``:
    the DataSpec default stream (800 requests from 200 users, 256 a
    shard: 4 shards), 60 steps logged every step, a checkpoint every
    20."""
    over = {"data.source": "disk", "train.steps": DISK_STEPS,
            "train.ckpt_every": DISK_CKPT_EVERY}
    over.update(extra or {})
    return scenario_spec(arch, variant, over)


def logged_losses(trainer):
    import torch
    return torch.tensor([row["loss"] for row in trainer.history],
                        dtype=torch.float64)


def params_equal(a, b) -> bool:
    import torch
    from repro_torch.tree import leaves
    return all(torch.equal(x, y) for x, y in zip(leaves(a["params"]),
                                                 leaves(b["params"])))


def shard_files(shard_dir) -> dict:
    """name -> (bytes, mtime) of each file of a shard directory."""
    return {p.name: (p.read_bytes(), p.stat().st_mtime_ns)
            for p in sorted(Path(shard_dir).iterdir()) if p.is_file()}


def prefetch_threads() -> list:
    import threading
    return [t.name for t in threading.enumerate()
            if t.name.startswith("roo-prefetch-") and t.is_alive()]


def disk_arch(arch, variant, mods, device, root: Path) -> dict:
    """One arch trained from shards through ``train_from_scenario``: the
    shards built, then reused (their files untouched) and refused for a
    spec of other data; the launches of its route; prefetch off bit for
    bit the prefetching run; a run killed after step 30 (last commit at
    20) and resumed with a fresh loader ending bit for bit at the
    uninterrupted run's losses and params; each step's loss against the
    plain backends on the same params."""
    import torch
    from repro_torch.scenario.build import train_from_scenario
    from repro_torch.scenario.spec import ScenarioValidationError
    spec = disk_spec(arch, variant)
    tag = f"disk {scenario_tag(spec)}"
    shards = str(root / "shards")
    full = root / "full"
    trainer, state, losses, got = train_run(
        spec, mods, device, ckpt_dir=str(full), shard_dir=shards)
    built = shard_files(shards)
    manifest = json.loads(built["manifest.json"][0])
    n_metric = sum(1 for row in trainer.history if "ne" in row)
    want = scenario_train_launches(spec, DISK_STEPS, n_metric)
    cursors = sorted(p.name for p in (full / "cursors").iterdir())
    n_req = sum(s["n_requests"] for s in manifest["shards"])
    print(f"[{tag}] spec {spec.content_hash()}: {len(manifest['shards'])} "
          f"shards of {[s['n_requests'] for s in manifest['shards']]} "
          f"requests ({n_req} joined of {spec.data.n_requests} simulated), "
          f"{sum(s['n_bytes'] for s in manifest['shards'])} B; "
          f"{DISK_STEPS} steps; launches {got}; {n_metric} NE forwards; "
          f"cursors {cursors}; losses at 1, 20, 40, 60 "
          f"{[round(float(losses[i]), 6) for i in (0, 19, 39, 59)]}")
    if got != want:
        raise SystemExit(f"{tag}: launches {got} are not {want}")
    if int(state["step"]) != DISK_STEPS or len(losses) != DISK_STEPS \
            or not bool(torch.isfinite(losses).all()) \
            or trainer.skipped_steps or n_req != spec.data.n_requests:
        raise SystemExit(f"{tag}: wrong step count, a skipped step, a "
                         f"non-finite loss or a lost request")
    if cursors != [f"cursor_{s:012d}.json" for s in (20, 40, 60)]:
        raise SystemExit(f"{tag}: the cursors saved are {cursors}")

    off = spec.with_overrides({"data.prefetch": False})
    _, off_state, off_losses, off_got = train_run(off, mods, device,
                                                  shard_dir=shards)
    reused = shard_files(shards) == built
    print(f"[{tag}] prefetch off: launches {off_got}; the shards reused "
          f"with every file untouched {reused}")
    same_run(f"{tag} prefetch off vs on", losses, state, off_losses,
             off_state)
    if off_got != want or not reused:
        raise SystemExit(f"{tag}: the prefetch-off run launched otherwise, "
                         f"or the shards were rebuilt")

    other = spec.with_overrides({"data.seed": 1})
    try:
        with spec_scope():
            train_from_scenario(other, shard_dir=shards, prints=False,
                                device=device)
        refused = ""
    except ScenarioValidationError as e:
        refused = str(e).splitlines()[0]
    print(f"[{tag}] a spec with data.seed 1 on the same directory: "
          f"{refused or 'NOT refused'}")
    if "different settings" not in refused:
        raise SystemExit(f"{tag}: shards of other data were not refused")

    kill = root / "kill"
    train_run(spec.with_overrides({"train.steps": DISK_KILL}), mods, device,
              ckpt_dir=str(kill), shard_dir=shards)
    saved = sorted(p.name for p in kill.iterdir() if p.name != "cursors")
    saved_cursors = sorted(p.name for p in (kill / "cursors").iterdir())
    resumed, res_state, res_losses, _ = train_run(
        spec, mods, device, ckpt_dir=str(kill), shard_dir=shards)
    same = (torch.equal(res_losses, losses[DISK_CKPT_EVERY:])
            and params_equal(state, res_state))
    print(f"[{tag}] killed after step {DISK_KILL} (checkpoints {saved}, "
          f"cursors {saved_cursors}), resumed with a fresh loader: steps "
          f"{resumed.history[0]['step']}-{resumed.history[-1]['step']}'s "
          f"losses and the final params bit for bit the uninterrupted "
          f"run's {same}")
    if saved != [f"step_{DISK_CKPT_EVERY:012d}"] \
            or saved_cursors != [f"cursor_{DISK_CKPT_EVERY:012d}.json"] \
            or int(res_state["step"]) != DISK_STEPS or not same:
        raise SystemExit(f"{tag}: the resumed run does not end at the "
                         f"uninterrupted run's losses and params")

    _, twin_state, twin, shadow = shadow_run(spec, device, shard_dir=shards)
    same_run(f"{tag} with a plain-backend shadow", losses, state, twin,
             twin_state)
    diff = float((losses - shadow).abs().max())
    ok = torch.allclose(losses, shadow, atol=1e-6, rtol=LOSS_TOL)
    print(f"[{tag}] each step's loss vs the plain backends on the same "
          f"params: max|diff| {diff:.3e} ok={ok}")
    if not ok or prefetch_threads():
        raise SystemExit(f"{tag}: the losses disagree with the plain "
                         f"backends, or a prefetch thread outlived its run")
    return dict(spec=spec, launches=got, losses=losses, state=state,
                shards=shards, manifest=manifest)


def disk_faults(mods, device, root: Path, run: dict) -> None:
    """The disk pipeline's four fault sites on the card (hstu-gr): seeded
    ``prefetch.io`` errors retried with the run bit for bit the fault-free
    one; a ``prefetch.stall`` restarting exactly one producer under a
    1.5 s watchdog, the stream bit for bit the synchronous one; a byte
    flipped in one shard file on disk, and a ``shard.read`` corruption,
    each quarantining exactly its shard while the run finishes; a
    ``shard.write`` kill leaving a torn ``.tmp`` that the next build
    sweeps, its shards then byte for byte the clean build's."""
    import contextlib
    import io
    import shutil
    import torch
    from repro_torch.pipeline import PrefetchLoader, ShardDataset
    from repro_torch.reliability import FaultPlan, InjectedFault, use_plan
    from repro_torch.scenario.build import build_batcher_cfg
    from repro_torch.tree import leaves
    spec, shards = run["spec"], run["shards"]

    text = "seed=5;prefetch.io:error@0.5x3"
    plan = FaultPlan.parse(text)
    with use_plan(plan):
        _, io_state, io_losses, _ = train_run(spec, mods, device,
                                              shard_dir=shards)
    print(f"[disk faults] {text!r}: {plan.stats.fires} fires in "
          f"{plan.stats.visits} visits")
    same_run("disk faults prefetch.io retried", run["losses"], run["state"],
             io_losses, io_state)
    if plan.stats.fires.get("prefetch.io") != 3:
        raise SystemExit("disk faults: prefetch.io did not fire 3 times")

    def stream(**kw):
        with PrefetchLoader(ShardDataset(shards, build_batcher_cfg(spec)),
                            epochs=1, device=device, **kw) as loader:
            return list(loader.batches()), loader.stats.snapshot()
    clean, _ = stream(prefetch=False)
    text = "seed=5;prefetch.stall:stall@0.2x1"
    plan = FaultPlan.parse(text)
    t0 = time.perf_counter()
    with use_plan(plan):
        stalled, stats = stream(prefetch=True, stall_timeout_s=1.5)
    wall = time.perf_counter() - t0
    same = len(stalled) == len(clean) and all(
        c1.to_json() == c2.to_json() and all(
            torch.equal(x, y) for x, y in zip(leaves(b1), leaves(b2)))
        for (b1, c1), (b2, c2) in zip(stalled, clean))
    print(f"[disk faults] {text!r}, watchdog 1.5 s: {plan.stats.fires} "
          f"fires, loader {stats}, {len(stalled)} batches in {wall:.2f} s, "
          f"bit for bit the synchronous stream {same}; prefetch threads "
          f"alive after close {prefetch_threads()}")
    if stats["producer_restarts"] != 1 or not same or prefetch_threads():
        raise SystemExit("disk faults: the stall did not restart exactly one "
                         "producer with the stream bit for bit, or a thread "
                         "outlived the loader")

    def quarantined(shard_dir, plan=None, tag=""):
        log = io.StringIO()
        with use_plan(plan), contextlib.redirect_stdout(log):
            trainer, state, losses, _ = train_run(
                spec.with_overrides({"train.log_every": 20}), mods, device,
                shard_dir=shard_dir, prints=True)
        lines = [x for x in log.getvalue().splitlines()
                 if "shards-quarantined" in x]
        finite = bool(torch.isfinite(losses).all())
        print(f"[disk faults] {tag}: {int(state['step'])} steps, losses "
              f"finite {finite}; log {lines}")
        if int(state["step"]) != DISK_STEPS or not finite or len(lines) != 1:
            raise SystemExit(f"disk faults: {tag}: the run did not finish, "
                             f"or quarantined nothing")
        return lines[0]
    flip = root / "flipped"
    flip.mkdir()
    for name in ("manifest.json", *(s["filename"]
                                    for s in run["manifest"]["shards"])):
        shutil.copy(Path(shards) / name, flip / name)
    victim = run["manifest"]["shards"][1]["filename"]
    blob = bytearray((flip / victim).read_bytes())
    blob[len(blob) - 16] ^= 0xFF
    (flip / victim).write_bytes(bytes(blob))
    line = quarantined(str(flip), tag=f"one byte flipped in {victim} on "
                                      f"disk")
    if f"files=['{victim}'" not in line or any(
            s["filename"] in line for s in run["manifest"]["shards"]
            if s["filename"] != victim):
        raise SystemExit(f"disk faults: not exactly {victim} quarantined")
    text = "seed=5;shard.read:corrupt@1x1"
    line = quarantined(shards, FaultPlan.parse(text), tag=repr(text))
    first = run["manifest"]["shards"][0]["filename"]
    if f"n=1 files=['{first}']" not in line:
        raise SystemExit(f"disk faults: {text!r} did not quarantine exactly "
                         f"{first} once")

    torn = root / "torn"
    short = spec.with_overrides({"train.steps": 5})
    plan = FaultPlan.parse("shard.write:torn@1x1")
    try:
        with use_plan(plan):
            train_run(short, mods, device, shard_dir=str(torn))
        killed = False
    except InjectedFault:
        killed = True
    left = sorted(p.name for p in torn.iterdir())
    _, state, _, _ = train_run(short, mods, device, shard_dir=str(torn))
    after = shard_files(torn)
    clean = shard_files(shards)
    same = sorted(after) == sorted(clean) and all(
        after[k][0] == clean[k][0] for k in after if k.endswith(".roos"))
    print(f"[disk faults] 'shard.write:torn@1x1': writer killed {killed}, "
          f"left {left}; the next build swept it: files {sorted(after)}, "
          f"byte for byte the clean build's {same}; "
          f"{int(state['step'])} steps")
    if not killed or left != ["shard_000000.roos.tmp"] or not same \
            or any(k.endswith(".tmp") for k in after):
        raise SystemExit("disk faults: the torn write was not left behind "
                         "and swept")


def disk_rates(mods, device, card: str) -> dict:
    """Steps/s (the Trainer's clock, logged at 20, 40 and 60) of each
    DISK_RUNS arch from the memory source, from disk with prefetch and
    from disk without it, in turns (memory, prefetch, sync, sync,
    prefetch, memory), with the peak memory of each run; then one
    prefetching and one synchronous run under ``obs.mode=trace``: the
    mean ms of the pipeline's spans and of ``train.data`` (the step's wait
    for its batch), and the queue-depth gauge."""
    import shutil
    import tempfile
    import torch
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import trace as obs_trace
    out = {}
    for arch, variant in DISK_RUNS:
        tag = f"disk {arch}{' ' + variant if variant else ''}"
        shards = tempfile.mkdtemp(prefix="roo_rates_")
        specs = {
            "memory": scenario_spec(arch, variant, {
                "train.steps": DISK_STEPS, "train.log_every": 20}),
            "prefetch": disk_spec(arch, variant, {"train.log_every": 20}),
            "sync": disk_spec(arch, variant, {"train.log_every": 20,
                                              "data.prefetch": False})}
        train_run(specs["prefetch"], mods, device, shard_dir=shards)  # build
        rates, peaks = {}, {}
        for how in ("memory", "prefetch", "sync", "sync", "prefetch",
                    "memory"):
            torch.cuda.reset_peak_memory_stats()
            trainer, _, _, _ = train_run(specs[how], mods, device,
                                         shard_dir=shards)
            rates.setdefault(how, []).append(
                trainer.history[-1]["steps_per_s"])
            peaks.setdefault(how, []).append(torch.cuda.max_memory_allocated())
        spans = {}
        for how in ("sync", "prefetch"):
            obs_trace.get_tracer().clear()
            train_run(specs[how].with_overrides({"obs.mode": "trace"}), mods,
                      device, shard_dir=shards)
            events = obs_trace.get_tracer().events()
            spans[how] = {name: [e["dur"] / 1e3 for e in events
                                 if e["name"] == name]
                          for name in PIPELINE_SPANS}
        # set at each batch the prefetching consumer takes (the last run)
        depth = obs_metrics.gauge("pipeline.queue_depth").value()
        obs_trace.get_tracer().clear()
        print(f"[{tag}] {card}: steps/s (Trainer.run's clock over "
              f"{DISK_STEPS} steps, in the order memory, prefetch, sync, "
              f"sync, prefetch, memory): "
              + "; ".join(f"{how} " + " / ".join(f"{r:.2f}" for r in v)
                          for how, v in rates.items())
              + "; peak memory GiB "
              + "; ".join(f"{how} " + " / ".join(f"{p / 2 ** 30:.3f}"
                                                 for p in v)
                          for how, v in peaks.items()))
        for how, sp in spans.items():
            print(f"[{tag}] {card}: {how}, obs.mode=trace: mean ms (count) "
                  + ", ".join(
                      f"{name} {sum(v) / max(len(v), 1):.3f} ({len(v)})"
                      for name, v in sp.items())
                  + (f"; pipeline.queue_depth gauge at the last batch "
                     f"{depth}" if how == "prefetch" else ""))
        out[arch, variant] = dict(rates=rates, peaks=peaks, spans=spans,
                                  queue_depth=depth)
        shutil.rmtree(shards, ignore_errors=True)
    return out


def disk_storage(spec) -> dict:
    """The stream's storage on the host: the ROO and impression-level
    table bytes (the byte accounting of ``data/storage.py``), Table 4's
    ratio from ``sample_volume_increase``, and the shard codec's real
    bytes under both schemas."""
    from repro_torch.core.joiner import expand_roo_samples
    from repro_torch.data import storage
    from repro_torch.data.events import EventSimulator
    from repro_torch.pipeline import OnlineJoinConfig, WatermarkJoiner
    from repro_torch.scenario.build import build_stream_cfg
    samples = WatermarkJoiner(OnlineJoinConfig(
        label_wait_s=spec.data.label_wait_s)).join(
        EventSimulator(build_stream_cfg(spec)).stream())
    imps = expand_roo_samples(samples)
    roo = storage.encode_roo_table(samples)["total"]
    imp = storage.encode_impression_table(imps)["total"]
    ratio = storage.sample_volume_increase(imps, samples)
    roo_shard = len(storage.encode_roo_shard(samples))
    imp_shard = len(storage.encode_impression_shard(imps))
    print(f"[disk storage] {len(samples)} requests, {len(imps)} impressions "
          f"(host bytes, zlib): ROO table {roo} B, impression table {imp} B; "
          f"{ratio}; shard codec: ROO {roo_shard} B, impression "
          f"{imp_shard} B ({imp_shard / roo_shard:.3f}x)")
    if len(samples) != spec.data.n_requests or roo >= imp:
        raise SystemExit("disk storage: requests lost in the join, or the "
                         "ROO table is not the smaller")
    return dict(roo=roo, imp=imp, ratio=ratio)


def phase_disk(mods, device, card: str) -> dict:
    """``data.source="disk"`` on the card: hstu-gr (B1-B3) and roo-lsr
    ``userarch`` (B5/B6) trained from shards in a ``tempfile.mkdtemp()``
    directory (``disk_arch``), the four fault sites (``disk_faults``), the
    rates of the three sources (``disk_rates``) and the stream's storage
    (``disk_storage``). Every prefetch thread is joined at the end."""
    import shutil
    import tempfile
    root = Path(tempfile.mkdtemp(prefix="roo_disk_"))
    try:
        out = {}
        for arch, variant in DISK_RUNS:
            sub = root / arch
            sub.mkdir()
            out[arch, variant] = disk_arch(arch, variant, mods, device, sub)
        disk_faults(mods, device, root, out["hstu-gr", None])
        out["rates"] = disk_rates(mods, device, card)
        out["storage"] = disk_storage(out["hstu-gr", None]["spec"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if prefetch_threads():
        raise SystemExit(f"disk: prefetch threads {prefetch_threads()} "
                         f"outlived the phase")
    return out


def record_dot(dmod, fn) -> list:
    """The (dense, sparse) operands of every B7 launch ``fn()`` makes."""
    seen = []
    launch = dmod.dot_interaction_cuda

    def recording(dense, sparse, *a, **k):
        seen.append((dense.detach(), sparse.detach()))
        return launch(dense, sparse, *a, **k)

    dmod.dot_interaction_cuda = recording
    try:
        fn()
    finally:
        dmod.dot_interaction_cuda = launch
    return seen


def phase_scenario_times(emod, dmod, device, card: str, trained) -> dict:
    """B5 / B6 (each side's group) and B7 at the operands the dlrm-mlperf
    scenario's training step hands them (recorded from one step on the
    trained params: 2 fields a side, multi-hot 2, D 16, B 8 / 32), held
    against their plain versions (B5 within BAG_TOL, B6 bit for bit, B7 at
    DOT_ATOL / DOT_RTOL) and timed beside the bound, the plain version and
    one library call a field (``F.embedding_bag``; B6: the backward of
    ``sparse=True`` calls; B7: none, as ``phase_dot_times`` says). Returns
    the numbers for the kernels' JSON line by (side, "fwd" | "coo") and
    "dot"."""
    import torch
    import torch.nn.functional as F
    from repro_torch.scenario.build import build_model, synthetic_dlrm_batches
    from repro_torch.train.loop import value_and_grad
    run = trained["dlrm-mlperf", None]
    spec = run["spec"]
    bundle = build_model(spec, torch.Generator().manual_seed(0),
                         device=device)
    batch = synthetic_dlrm_batches(spec, bundle.cfg, n_batches=1,
                                   device=device)[0]
    step = lambda: value_and_grad(bundle.loss_fn)(run["params"], batch, None)
    dots = []
    groups = record_groups(emod, lambda: dots.extend(record_dot(dmod, step)))
    out = {}
    for side, (tables, ids, lens) in zip(("RO", "NRO"), groups):
        b, f, l = ids.shape
        vocabs = [t.shape[0] for t in tables]
        g = torch.randn((b, f, tables[0].shape[1]), device=device,
                        generator=torch.Generator(device=device)
                        .manual_seed(68))
        fwd = lambda: emod.embedding_bag_grouped_fwd_cuda(tables, ids, lens)
        fwd_plain = lambda: emod.embedding_bag_grouped_plain(tables, ids,
                                                             lens)
        coo = lambda: emod.embedding_bag_grouped_coo_rows_cuda(g, ids, lens,
                                                               vocabs)
        coo_plain = lambda: emod.embedding_bag_grouped_coo_rows_plain(
            g, ids, lens, vocabs)
        err = float((fwd() - fwd_plain()).abs().max())
        if err > BAG_TOL or not all(torch.equal(a, p) for a, p in
                                    zip(coo(), coo_plain())):
            raise SystemExit(f"scenario times: {side} side: B5 off plain "
                             f"by {err:.3e} or B6 not bit for bit plain")
        offsets = [(torch.cumsum(lens[:, j], 0) - lens[:, j]).long()
                   for j in range(f)]
        valid = [torch.arange(l, device=device)[None, :] < lens[:, j, None]
                 for j in range(f)]
        flat = [ids[:, j, :].long()[valid[j]] for j in range(f)]
        lib_fwd = lambda: [F.embedding_bag(flat[j], t, offsets[j],
                                           mode="sum")
                           for j, t in enumerate(tables)]
        tg = [t.detach().requires_grad_(True) for t in tables]
        lib_out = [F.embedding_bag(flat[j], t, offsets[j], mode="sum",
                                   sparse=True) for j, t in enumerate(tg)]
        gs = [g[:, j, :].contiguous() for j in range(f)]
        lib_bwd = lambda: torch.autograd.grad(lib_out, tg, gs,
                                              retain_graph=True)
        ms = {key: labelled_device_ms(key, fn, iters) for key, fn, iters in (
            ("fwd_plain", fwd_plain, 20), ("fwd", fwd, 200),
            ("coo", coo, 200), ("coo_plain", coo_plain, 20),
            ("lib_fwd", lib_fwd, 50))}
        try:
            ms["lib_coo"] = device_ms(lib_bwd, 20)
        except SystemExit:
            ms["lib_coo"] = None        # it synchronises the host
        x = dict(tables=tables, ids=ids, lens=lens)
        for which, label in (("fwd", "B5 embedding_bag_fwd_grouped"),
                             ("coo", "B6 embedding_bag_bwd_coo_grouped")):
            bound_ms, bound_by, n_bytes, ops = bound_group(x, which)
            lib = ms["lib_" + which]
            print(f"[times] {card}: {label} sum, scenario dlrm-mlperf "
                  f"training {side} side B{b} F{f} L{l} "
                  f"D{tables[0].shape[1]} over tables of {vocabs} rows, "
                  f"device time per call: kernel {ms[which]:.5f} ms, plain "
                  f"torch {ms[which + '_plain']:.5f} ms; bound "
                  f"{bound_ms:.3e} ms ({bound_by}: {n_bytes} B, {ops} "
                  f"FLOP); library ({f} calls) "
                  + ("-" if lib is None else f"{lib:.5f} ms")
                  + f"; max|B5 - plain| {err:.3e}")
            out[side, which] = dict(ms=ms[which],
                                    plain_ms=ms[which + "_plain"],
                                    bound_ms=bound_ms, bound_by=bound_by,
                                    library_ms=lib, max_abs_err=(
                                        err if which == "fwd" else 0.0))
        del tg, lib_out
    dense, sparse = dots[0]
    kernel = lambda: dmod.dot_interaction_cuda(dense, sparse)
    plain = lambda: dmod.dot_interaction_plain(dense, sparse)
    err = float((kernel() - plain()).abs().max())
    if not torch.allclose(kernel(), plain(), atol=DOT_ATOL, rtol=DOT_RTOL):
        raise SystemExit(f"scenario times: B7 off plain by {err:.3e}")
    lib = dot_yardstick(dmod, dense, sparse)
    ms = {k: device_ms(fn, iters) for k, fn, iters in (
        ("plain", plain, 40), ("kernel", kernel, 200), ("library", lib, 100))}
    bound_ms, bound_by, n_bytes, ops = bound_dot(dense, sparse)
    print(f"[times] {card}: B7 dot_interaction_fwd scenario dlrm-mlperf "
          f"training B{sparse.shape[0]} F{sparse.shape[1]} "
          f"D{sparse.shape[2]} fp32, device time per call: kernel "
          f"{ms['kernel']:.5f} ms, plain torch {ms['plain']:.5f} ms; bound "
          f"{bound_ms:.3e} ms ({bound_by}: {n_bytes} B, {ops} FLOP); "
          f"max|B7 - plain| {err:.3e}; library yardstick (two calls: "
          f"torch.bmm + tril index_select) {ms['library']:.5f} ms")
    out["dot"] = dict(ms=ms["kernel"], plain_ms=ms["plain"],
                      bound_ms=bound_ms, bound_by=bound_by,
                      library_ms=ms["library"], max_abs_err=err)
    return out


# ---------------------------------------------------------------------------
# 20. SPMD training over a device mesh (A9)
# ---------------------------------------------------------------------------

SPMD_COLLECTIVES = ("all_reduce", "all_reduce async_op",
                    "all_gather_into_tensor", "reduce_scatter_tensor")
SPMD_DLRM_BATCHES = 4         # dlrm scoring batches under the 1x2 plan
SPMD_DLRM_IMPRESSIONS = 512   # the impression-level forward's batch
SPMD_SLICE = (512, 26, 64)    # B7 on one model rank's D slice (B, F, D/2)


def spmd_probe(rank: int) -> dict:
    """Each collective the port's SPMD path issues, once over the world on
    CUDA tensors of the card (gloo): what it returned. A wrong value
    raises here; the caller fails the phase on a missing one."""
    import torch
    import torch.distributed as dist
    x = torch.full((4, 8), float(rank + 1), device="cuda")
    got = {}
    y = x.clone()
    dist.all_reduce(y)
    got["all_reduce"] = float(y[0, 0])
    y = x.clone()
    dist.all_reduce(y, async_op=True).wait()
    got["all_reduce async_op"] = float(y[0, 0])
    o = torch.empty((8, 8), device="cuda")
    dist.all_gather_into_tensor(o, x)
    got["all_gather_into_tensor"] = float(o[4, 0])
    o = torch.empty((2, 8), device="cuda")
    dist.reduce_scatter_tensor(o, x)
    got["reduce_scatter_tensor"] = float(o[0, 0])
    want = {"all_reduce": 3.0, "all_reduce async_op": 3.0,
            "all_gather_into_tensor": 2.0, "reduce_scatter_tensor": 3.0}
    if got != want:
        raise RuntimeError(f"gloo collectives on CUDA tensors: {got}, "
                           f"want {want}")
    return got


def spmd_rank(rank: int, out_dir: str) -> None:
    """One of the two gloo ranks sharing the card (mesh 1 x 2): the probe,
    hstu-gr and roo-lsr ``userarch_hstu`` 20 steps each through
    ``train_from_scenario(train.mesh="1x2")``, hstu-gr again under int8 +
    error feedback, and the dlrm-mlperf scoring forward under the 1 x 2
    plan at its published widths (each rank's B5 / B7 launches). Writes
    its results as JSON; the parent checks them."""
    import torch
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.distributed.sharding import plan_for_mesh
    from repro_torch.interop import params_onto_plan
    from repro_torch.kernels import dot_interaction as dmod
    from repro_torch.kernels import embedding_bag as emod
    from repro_torch.kernels import hstu_attention as kmod
    from repro_torch.kernels import hstu_attention_bwd as bmod
    from repro_torch.kernels import hstu_attention_prefix as pmod
    from repro_torch.launch.mesh import make_mesh_from_spec
    from repro_torch.distributed import spmd
    from repro_torch.models.dlrm import (dlrm_forward_impression,
                                         dlrm_forward_roo, dlrm_init)
    from repro_torch.scenario.build import synthetic_dlrm_batches
    mods = (emod, kmod, pmod, bmod, dmod)
    res = {"probe": spmd_probe(rank)}
    for key, arch, variant, extra in (
            ("gr", "hstu-gr", None, {}),
            ("lsr", "roo-lsr", "userarch_hstu", {}),
            ("gr_int8", "hstu-gr", None, {"knobs.comms_compress": "int8"})):
        spec = scenario_spec(arch, variant, dict(extra, **{
            "train.mesh": "1x2"}))
        t0 = time.perf_counter()
        trainer, state, losses, counts = train_run(spec, mods, "cuda")
        res[key] = dict(losses=losses.tolist(), counts=counts,
                        rows=int(state["params"]["item_emb"].shape[0]),
                        seconds=time.perf_counter() - t0,
                        skipped=trainer.skipped_steps)
    # dlrm-mlperf scoring under the plan: the unsharded forward on the
    # same params first, then the tables cut to this rank's row blocks
    cfg = dlrm_config(DLRM_CAP)
    plan = plan_for_mesh(make_mesh_from_spec("1x2"))
    batches = synthetic_dlrm_batches(dlrm_spec(0, 128, 512), cfg,
                                     SPMD_DLRM_BATCHES, device="cuda")
    with torch.no_grad():
        params = dlrm_init(torch.Generator("cuda").manual_seed(0), cfg,
                           device="cuda")
        want = [dlrm_forward_roo(params, cfg, *dlrm_roo_args(b))
                for b in batches]
        # the impression-level forward (C4) on the first batch: every
        # request's fields fanned out to its impressions
        b0 = batches[0]
        seg = b0["seg"].long()
        imp_args = (b0["ro_dense"][seg],
                    torch.cat([b0["ro_ids"][seg], b0["nro_ids"]], 1),
                    torch.cat([b0["ro_len"][seg], b0["nro_len"]], 1))
        want_imp = dlrm_forward_impression(params, cfg, *imp_args)
        local, specs = params_onto_plan(params, plan, "cuda")
        dense_block = list(local["top_mlp"]["layers"][0]["w"].shape)
        local = spmd.gather_dense(local, specs, plan)
        del params
        torch.cuda.empty_cache()
        reset_counts(mods)
        got = [dlrm_forward_roo(local, cfg, *dlrm_roo_args(b), plan=plan)
               for b in batches]
        torch.cuda.synchronize()
        roo_counts = all_counts(mods)
        reset_counts(mods)
        got_imp = dlrm_forward_impression(local, cfg, *imp_args, plan=plan)
        torch.cuda.synchronize()
    res["dlrm_impression"] = dict(
        counts=all_counts(mods), dense_block=dense_block,
        max_abs_err=float((got_imp - want_imp).abs().max()),
        finite=bool(torch.isfinite(got_imp).all()))
    reset_counts(mods)
    res["dlrm"] = dict(
        counts=roo_counts,
        max_abs_err=max(float((g - w).abs().max())
                        for g, w in zip(got, want)),
        finite=all(bool(torch.isfinite(g).all()) for g in got),
        sharded=[name for name in sorted(local["tables"])
                 if local["tables"][name].shape[0]
                 < cfg.tables().table(name).vocab])
    with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(res, f)


def spmd_slice_times(dmod, device, card: str) -> dict:
    """B7 at one model rank's D slice of the dlrm scoring shape beside the
    whole width (same call), its plain version, its bound and the
    bmm + index_select yardstick."""
    import torch
    # the reduced dlrm scenario's slice (D 16 over 2 ranks) too
    dense, sparse = dot_inputs((32, 4, 8), 99, device)
    err = float((dmod.dot_interaction_cuda(dense, sparse)
                 - dmod.dot_interaction_plain(dense, sparse)).abs().max())
    print(f"[spmd] B7 at the reduced dlrm scenario's D-8 slice (32, 4, 8): "
          f"max |kernel - plain| {err:.3e}")
    if err > DOT_ATOL:
        raise SystemExit("spmd: B7 at D 8 off its plain version")
    out = {}
    for key, shape in (("slice", SPMD_SLICE), ("full", (512, 26, 128))):
        dense, sparse = dot_inputs(shape, 100, device)
        f1 = sparse.shape[1] + 1
        t = torch.cat([dense[:, None, :], sparse], dim=1)
        i, j = torch.tril_indices(f1, f1, offset=-1, device=device)
        flat = i * f1 + j
        kernel = lambda: dmod.dot_interaction_cuda(dense, sparse)
        plain = lambda: dmod.dot_interaction_plain(dense, sparse)
        lib = lambda: torch.bmm(t, t.transpose(1, 2)).flatten(1).index_select(
            1, flat)
        err = float((kernel() - plain()).abs().max())
        if err > DOT_ATOL + DOT_RTOL * float(plain().abs().max()):
            raise SystemExit(f"spmd: B7 at {shape} off its plain version by "
                             f"{err}")
        ms = {k: device_ms(fn, iters) for k, fn, iters in (
            ("plain", plain, 40), ("kernel", kernel, 200),
            ("again", kernel, 200), ("library", lib, 100))}
        bound_ms, bound_by, n_bytes, ops = bound_dot(dense, sparse)
        print(f"[spmd] {card}: B7 (B, F, D) = {shape} fp32, device time per "
              f"call: kernel {ms['kernel']:.5f} ms (again {ms['again']:.5f}),"
              f" plain {ms['plain']:.5f} ms, bound {bound_ms:.5f} ms "
              f"({bound_by}: {n_bytes} B, {ops} FLOP), bmm + index_select "
              f"{ms['library']:.5f} ms; max |kernel - plain| {err:.3e}")
        out[key] = dict(ms=ms["kernel"], plain_ms=ms["plain"],
                        bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=ms["library"], max_abs_err=err)
    return out


SPMD_LM_RUNS = (("phi3-medium-14b", 2, 1, 1024),   # arch, layers, batch,
                ("granite-moe-3b-a800m", 4, 2, 512))  # sequence
SPMD_LM_DECODE = (2, 256, 320, 8)   # batch, prompt, s_max, steps
SPMD_LM_RTOL = 1e-5       # the plan's loss vs no plan, f32 compute
SPMD_LM_GRAD_TOL = 1e-4   # |grad - no plan| / max |no-plan grad|, a leaf
SPMD_LM_DECODE_TOL = 1e-4  # decode's logits vs no plan, x their rms


def spmd_lm(mods, device, card: str) -> dict:
    """The LM under a 1 x 1 NCCL plan (the world of one phase 20's hstu-gr
    run made): phi3 at 2 and granite at 4 layers, full width, f32 compute,
    on the same params as without a plan. Both layer routes: the loss
    within SPMD_LM_RTOL and every gradient leaf within SPMD_LM_GRAD_TOL of
    its largest no-plan entry; then prefill + steps of decode with a
    ``CacheSpec`` against no plan: the prefill's caches within one bf16
    rounding step at their scale, its logits and each step's (both from the plan's cache)
    within SPMD_LM_DECODE_TOL of the logits' rms. None of B1-B7
    launches."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.distributed import spmd
    from repro_torch.distributed.sharding import plan_for_mesh
    from repro_torch.launch.mesh import make_mesh_from_spec
    from repro_torch.models.lm import decode
    from repro_torch.models.lm.transformer import (lm_grad_axes, lm_init,
                                                   lm_loss, lm_param_specs)
    from repro_torch.train.loop import value_and_grad
    from repro_torch.tree import leaves
    plan = plan_for_mesh(make_mesh_from_spec("1x1", backend="nccl"))
    out = {}
    for arch, layers, b, s in SPMD_LM_RUNS:
        t0 = time.perf_counter()
        reset_counts(mods)
        cfg = dataclasses.replace(get_arch(arch).CONFIG, n_layers=layers,
                                  compute_dtype="float32")
        params = lm_init(torch.Generator(device=device).manual_seed(0), cfg,
                         device=device)
        specs = spmd.state_shardings(params, plan,
                                     param_specs=lm_param_specs(cfg, plan))
        gen = torch.Generator(device=device).manual_seed(3)
        toks = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                             device=device)
        want, want_g = value_and_grad(
            lambda p, bt, g: lm_loss(p, cfg, toks, toks))(params, None, None)
        want_g = leaves(want_g)
        errs = {}
        for spmd_layer in (False, True):
            c = dataclasses.replace(cfg, use_spmd_layer=spmd_layer)
            loss, grads = value_and_grad(
                lambda p, bt, g: lm_loss(p, c, toks, toks, plan))(
                    params, None, None)
            grads = leaves(spmd.reduce_grads(grads, specs, plan,
                                             lm_grad_axes(c, plan)))
            rel = abs(float(loss) - float(want)) / abs(float(want))
            gerr = max(float((g - w).abs().max() / w.abs().max().clamp(
                min=1e-30)) for g, w in zip(grads, want_g))
            errs[spmd_layer] = (float(loss), rel, gerr)
            del grads
            if rel > SPMD_LM_RTOL or gerr > SPMD_LM_GRAD_TOL:
                raise SystemExit(f"spmd lm {arch} (use_spmd_layer "
                                 f"{spmd_layer}): loss {float(loss)} vs "
                                 f"{float(want)} (rel {rel:.3e}), grads "
                                 f"{gerr:.3e}")
        del want_g
        torch.cuda.empty_cache()
        db, prompt, s_max, steps = SPMD_LM_DECODE
        cs = decode.CacheSpec(("data",), "model")
        dtoks = torch.randint(0, cfg.vocab, (db, prompt + steps),
                              generator=gen, device=device)
        dec, cache_err = [], 0.0
        with torch.no_grad():
            w, wc = decode.prefill(params, cfg, dtoks[:, :prompt],
                                   s_max=s_max)
            g_, gc = decode.prefill(params, cfg, dtoks[:, :prompt], plan=plan,
                                    s_max=s_max, cs=cs)
            # the caches within one bf16 rounding step at their scale: two
            # GEMM shapes round some entries to neighbouring bf16 values
            for n in ("k", "v"):
                a, b_ = gc[n].float(), wc[n].float()
                cache_err = max(cache_err, float((a - b_).abs().max()
                                                 / b_.abs().max()))
            for i in range(steps + 1):
                dec.append(float((g_ - w).abs().max())
                           / float(w.pow(2).mean().sqrt()))
                if i == steps:
                    break
                # each step from the same cache: the plan's (a 1x1 block is
                # the whole cache), so a K / V entry the two prefills round
                # to neighbouring bf16 values does not count against it
                t = dtoks[:, prompt + i:prompt + i + 1]
                w, _ = decode.serve_step(params, cfg, gc, t)
                g_, gc = decode.serve_step(params, cfg, gc, t, plan=plan,
                                           cs=cs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        print(f"[spmd lm] {arch} {card}: {layers} layers at full width, f32 "
              f"compute, {b} x {s} tokens under a 1x1 NCCL plan vs no plan "
              f"on the same params: loss {float(want):.6f}; (loss, rel diff,"
              f" max grad diff / max |grad|) GSPMD route {errs[False]}, "
              f"explicit route {errs[True]} (bounds {SPMD_LM_RTOL}, "
              f"{SPMD_LM_GRAD_TOL}); decode {db} x {prompt} + {steps} steps "
              f"with {cs}: the caches' max |diff| / max |entry| {cache_err:.3e} "
              f"(one bf16 step is {2 ** -7}), max |logits - no plan| / rms, the "
              f"prefill then each step on the same cache "
              f"{[float(f'{e:.3e}') for e in dec]} (bound "
              f"{SPMD_LM_DECODE_TOL}); {secs:.1f} s")
        if max(dec) > SPMD_LM_DECODE_TOL or cache_err > 2 ** -7 \
                or not bool(torch.isfinite(g_).all()):
            raise SystemExit(f"spmd lm {arch}: decode under the plan off")
        no_launches(mods, f"spmd lm {arch}")
        del params, w, wc, g_, gc
        torch.cuda.empty_cache()
        out[arch] = dict(errs=errs, decode=dec, seconds=secs)
    return out


def phase_spmd(mods, device, card: str) -> dict:
    """Phase 20: SPMD training over a mesh. NCCL at world 1 (mesh 1 x 1)
    in this process through ``train_from_scenario`` and, in a subprocess,
    through ``--mesh 1x1``: hstu-gr at its published widths, 20 steps,
    losses within rtol 1e-5 of the same params without a mesh, the same
    B1-B3 launches, the item table's seq-lookup exchange in
    ``distributed.comms``; the LM under the same NCCL world's 1 x 1 plan
    (``spmd_lm``). Then two gloo ranks share the card (mesh 1 x 2,
    ``spmd_rank``): the collectives probed on CUDA tensors, hstu-gr and
    roo-lsr ``userarch_hstu`` within rtol 2e-4 of the world-1 runs with
    each rank's table a V/2 row block and each dense leaf its TP block,
    int8 + error feedback within the reference's bounds, the dlrm-mlperf
    scoring forward and its impression-level forward under the plan within
    1e-4 of the unsharded ones (B7 on the D-64 slice). Returns the
    launches and B7's slice times for the kernels line."""
    import os
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import comms
    from repro_torch.launch.hostdevices import spawn
    emod, kmod, pmod, bmod, dmod = mods
    tmp = Path(tempfile.mkdtemp(prefix="spmd_", dir=str(build_dir())))
    launch = None
    try:
        gr, lsr = scenario_spec("hstu-gr"), scenario_spec("roo-lsr",
                                                          "userarch_hstu")
        mesh_spec = scenario_spec("hstu-gr", extra={"train.mesh": "1x1"})
        lsr_tr, _, lsr_base, _ = train_run(lsr, mods, device)
        # in turns: no mesh, 1x1, 1x1, no mesh (the rates' spread)
        base_tr, _, base, base_counts = train_run(gr, mods, device)
        comms.STATS.reset()
        mesh_tr, mesh_state, meshed, mesh_counts = train_run(mesh_spec, mods,
                                                             device)
        again = [train_run(spec, mods, device)[0]
                 for spec in (mesh_spec, gr)]
        sites = comms.STATS.snapshot()["sites"]
        seq = sites.get(f"lookup:seq:V{SCENARIO_ITEMS}xB32x"
                        f"L{SCENARIO_HIST}xD64")
        rel = float(((meshed - base).abs() / base.abs()).max())
        rates = {"no mesh": [tr.history[-1]["steps_per_s"]
                             for tr in (base_tr, again[1])],
                 "1x1": [tr.history[-1]["steps_per_s"]
                         for tr in (mesh_tr, again[0])]}
        print(f"[spmd] {card}: hstu-gr 20 steps, NCCL world 1 (mesh 1x1) vs "
              f"no mesh: max rel loss diff {rel:.3e}; launches {mesh_counts} "
              f"vs {base_counts}; item_emb rows "
              f"{mesh_state['params']['item_emb'].shape[0]}; steps/s in "
              f"turns (no mesh, 1x1, 1x1, no mesh) {rates['no mesh'][0]:.2f},"
              f" {rates['1x1'][0]:.2f}, {rates['1x1'][1]:.2f}, "
              f"{rates['no mesh'][1]:.2f} (the plan route costs "
              f"{sum(rates['no mesh']) / sum(rates['1x1']):.3f}x); exchange "
              f"sites {sorted(sites)}; seq site {seq}")
        if rel > 1e-5 or any(mesh_counts[k] != base_counts[k]
                             for k in ("b1", "b2", "b3")) or seq is None \
                or seq["f32_bytes"] != 32 * SCENARIO_HIST * 64 * 4 \
                or mesh_tr.skipped_steps:
            raise SystemExit("spmd: the 1x1 mesh run is off the no-mesh run "
                             "or its exchange record")
        lm_runs = spmd_lm(mods, device, card)
        if dist.is_initialized():
            dist.destroy_process_group()
        torch.cuda.empty_cache()
        # --mesh 1x1 through the launcher, beside the gloo ranks
        launch = launcher(["--arch", "hstu-gr", "--steps",
                           str(SCENARIO_STEPS), "--mesh", "1x1", "--set",
                           "train.log_every=1"],
                          dict(os.environ, PYTHONPATH=str(SRC)),
                          tmp / "launcher.log")
        # two gloo ranks on the card
        t0 = time.perf_counter()
        spawn(spmd_rank, 2, args=(str(tmp),), backend="gloo",
              timeout_s=900)
        print(f"[spmd] {card}: 2 gloo ranks on one card (mesh 1x2): "
              f"{time.perf_counter() - t0:.1f} s for the spawn, the probe, "
              f"3 x 20 steps and the dlrm forward")
        ranks = [json.loads((tmp / f"rank{r}.json").read_text())
                 for r in range(2)]
        print(f"[spmd] gloo collectives on CUDA tensors: "
              f"{sorted(ranks[0]['probe'])} all take them")
        for r, res in enumerate(ranks):
            for key, want in (("gr", base), ("lsr", lsr_base)):
                got = torch.tensor(res[key]["losses"], dtype=torch.float64)
                d = float(((got - want).abs()
                           / (2e-4 * want.abs() + 1e-6)).max())
                print(f"[spmd] rank {r} {key} 1x2 (gloo-on-one-card, "
                      f"{res[key]['seconds']:.1f} s): launches "
                      f"{res[key]['counts']}; item_emb rows "
                      f"{res[key]['rows']}; losses vs world 1: worst "
                      f"{d:.3f} of rtol 2e-4 + atol 1e-6")
                if d > 1 or res[key]["rows"] != SCENARIO_ITEMS // 2 or \
                        res[key]["skipped"]:
                    raise SystemExit(f"spmd: rank {r} {key} off")
            for k in ("b1", "b2", "b3"):
                if res["gr"]["counts"][k] != base_counts[k]:
                    raise SystemExit(f"spmd: rank {r} gr {k} launches")
            none = torch.tensor(res["gr"]["losses"], dtype=torch.float64)
            int8 = torch.tensor(res["gr_int8"]["losses"],
                                dtype=torch.float64)
            early = float(((int8[:10] - none[:10]).abs()
                           / (5e-2 * none[:10].abs() + 5e-3)).max())
            mean = abs(float(int8.mean() - none.mean())) / float(none.mean())
            print(f"[spmd] rank {r} hstu-gr int8 + EF vs none: first 10 "
                  f"steps worst {early:.3f} of rtol 5e-2 + atol 5e-3, mean "
                  f"{mean:.3e} (bound 2e-2)")
            if early > 1 or mean > 2e-2:
                raise SystemExit(f"spmd: rank {r} int8 + EF out of bounds")
            dl = res["dlrm"]
            print(f"[spmd] rank {r} dlrm-mlperf scoring under the 1x2 plan "
                  f"({SPMD_DLRM_BATCHES} batches of 128 / 512, 2**21 cap): "
                  f"max |scores - unsharded| {dl['max_abs_err']:.3e}, "
                  f"launches {dl['counts']}, row-sharded tables "
                  f"{len(dl['sharded'])} of 26")
            if not dl["finite"] or dl["max_abs_err"] > LOGIT_TOL or \
                    dl["counts"]["b7"] != SPMD_DLRM_BATCHES or \
                    dl["counts"]["b5"] != 2 * SPMD_DLRM_BATCHES:
                raise SystemExit(f"spmd: rank {r} dlrm forward off")
            di = res["dlrm_impression"]
            print(f"[spmd] rank {r} dlrm-mlperf impression-level forward "
                  f"under the 1x2 plan (one batch's {SPMD_DLRM_IMPRESSIONS}"
                  f" impressions): max |scores - unsharded| "
                  f"{di['max_abs_err']:.3e} (bound {LOGIT_TOL}), launches "
                  f"{di['counts']}; the top MLP's first weight held as its TP "
                  f"block "
                  f"{di['dense_block']}")
            if not di["finite"] or di["max_abs_err"] > LOGIT_TOL or \
                    di["counts"]["b7"] != 1 or di["counts"]["b5"] < 1:
                raise SystemExit(f"spmd: rank {r} dlrm impression-level "
                                 f"forward off")
        if launch.wait(timeout=900):
            raise SystemExit("spmd: --mesh 1x1 exited "
                             + (tmp / "launcher.log").read_text())
        line = [x for x in (tmp / "launcher.log").read_text().splitlines()
                if "train-done" in x][-1]
        print(f"[spmd] {card}: --mesh 1x1: {line}")
        if "device=cuda" not in line or \
                f"loss={round(float(meshed[-1]), 4)}" not in line:
            raise SystemExit("spmd: --mesh 1x1 did not finish as the "
                             "in-process 1x1 run")
        times = spmd_slice_times(dmod, device, card)
    finally:
        if launch is not None and launch.poll() is None:
            launch.kill()
            launch.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(mesh_counts=mesh_counts, times=times, lm=lm_runs,
                dlrm_b7=ranks[0]["dlrm"]["counts"]["b7"])


# ---------------------------------------------------------------------------
# phase 21: the LM and MACE families, and kernels/ops.py
# ---------------------------------------------------------------------------

LM_RUNS = (("phi3-medium-14b", 2, 1),          # (arch, layers kept, batch)
           ("granite-moe-3b-a800m", 4, 2))
LM_SEQ = 4096                 # lm_cells' train_4k sequence
LM_STEPS = 5
LM_CHUNK = 1024               # the "flash" option: full_attn_max_seq = q_chunk
DECODE = (4, 1024, 1152, 64)  # batch, prompt, s_max, decode steps
DECODE_CHECKED = 4            # steps held against the full forward
LM_BF16_TOL = 2e-2            # bf16 compute: the reference's bf16 tolerance
DECODE_F32_TOL = 1e-3         # decode vs its full forward at f32 compute,
                              # x the logits' rms (other GEMM shapes: ~1e-4)
CHUNK_RTOL = 1e-5             # chunked vs unchunked loss on the same params
BF16_FLOP_PER_S = 989e12      # H100 SXM dense bf16, published
MACE_MOLECULE = (128, 30, 64, 16)   # mace_cells' molecule: graphs, nodes and
                                    # edges a graph, d_feat
MACE_STEPS = 10
MACE_CPU_TOL = 1e-4           # card vs CPU forward, f32
MACE_HOIST_TOL = 1e-5         # hoist_gathers on vs off
MACE_INVARIANCE_TOL = 2e-4    # the reference's bound (test_models_smoke.py)
SMOKE_STEPS = 10
SMOKE_ARCHS = ("starcoder2-15b", "deepseek-coder-33b", "phi3-medium-14b",
               "qwen3-moe-235b-a22b", "granite-moe-3b-a800m", "mace")
OPS_CALLS = 4                 # "always" calls a route in the counted drive


def gib(n_bytes) -> str:
    return f"{n_bytes / 2 ** 30:.2f} GiB"


def detached(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.detach(), tree)


def no_launches(mods, what: str) -> None:
    counts = all_counts(mods)
    if any(counts.values()):
        raise SystemExit(f"{what} launched a kernel of B1-B7: {counts}")


def timed_trainer_run(loss, lr, params, batches, steps, device,
                      log_every=1) -> dict:
    """One Trainer run of ``steps`` from (a copy of) ``params`` over the
    list ``batches``: its logged losses, final params, wall seconds (the
    card synchronized at both ends) and the card's peak memory."""
    import torch
    from repro_torch.train.loop import Trainer, TrainLoopConfig
    from repro_torch.train.optim import adam
    trainer = Trainer(loss, adam(lr), TrainLoopConfig(
        total_steps=steps, log_every=log_every), lambda: params,
        device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = trainer.run(lambda start: iter(batches[start:]), 0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(losses=[row["loss"] for row in trainer.history],
                params=state["params"], wall=wall,
                peak=torch.cuda.max_memory_allocated())


def same_params(a, b) -> bool:
    """Every leaf of ``a`` equal to ``b``'s bit for bit (``b``'s moved to
    ``a``'s device)."""
    import torch
    from repro_torch.tree import leaves
    return all(torch.equal(x, y.to(x.device))
               for x, y in zip(leaves(a), leaves(b)))


def lm_flops(cfg, b: int, s: int) -> float:
    """Model FLOPs of one training step: 6 · n_active_params · tokens, plus
    the attention's two products, 2 · 2 · S² · H · dh a sequence and layer
    forward over the whole S × S the reference computes, x3 with the
    backward. Recomputation under checkpointing is not counted."""
    return (6.0 * cfg.n_active_params() * b * s
            + 12.0 * cfg.n_layers * b * s * s * cfg.n_heads * cfg.d_head)


def cached_forward_logits(params, cfg, toks, prompt: int):
    """The logits at the last position of ``toks`` as ``prefill`` over the
    first ``prompt`` tokens and ``serve_step`` over the rest compute them,
    in one forward: the prompt's rows attend over K and V as computed (the
    prefill's full forward), the later rows over K and V rounded to bf16
    (what they read from the cache). Whatever the compute dtype, the
    function decode computes; at bf16 the plain full forward."""
    import torch
    from repro_torch.embeddings.sparse import gather_rows
    from repro_torch.models.lm import transformer as lm
    b, s = toks.shape
    x = gather_rows(params["embed"], toks).to(cfg.cdtype)
    pos = torch.arange(s, dtype=torch.int32, device=toks.device)[None]
    pos = pos.expand(b, s)
    for lyr in lm.layer_params(params, cfg.cdtype):
        q, k, v = lm._qkv(lm._rmsnorm(x, lyr["attn_norm"]), lyr, cfg, pos)
        kr, vr = (t.to(torch.bfloat16).to(cfg.cdtype) for t in (k, v))
        attn = torch.cat([
            lm._attention(q[:, :prompt], k[:, :prompt], v[:, :prompt],
                          pos[:, :prompt], pos[:, :prompt], cfg),
            lm._attention(q[:, prompt:], kr, vr, pos[:, prompt:], pos,
                          cfg)], dim=1)
        x = lm._ffn(x + attn.reshape(b, s, -1) @ lyr["wo"], lyr, cfg)
    hidden = lm._rmsnorm(x[:, -1:], params["final_norm"])
    return lm.lm_logits(params, cfg, hidden)[:, 0]


def lm_decode(params, cfg, device, card: str, tag: str) -> dict:
    """``prefill`` DECODE's batch x prompt into s_max, then its steps of
    ``serve_step``, timed. Then, at a capacity that drops no token (an MoE
    step of B tokens has another capacity than a forward over B x S), the
    first DECODE_CHECKED steps' logits against a forward over the extended
    sequence's last position: at f32 compute against
    ``cached_forward_logits`` (the same function with the cache's bf16
    K/V), max |diff| within DECODE_F32_TOL of the logits' rms; and at the
    published bf16 compute against ``lm_forward`` + ``lm_logits``, the
    mean |diff| within LM_BF16_TOL of the logits' rms. The two runs sum in
    other orders: cuBLAS takes other kernels for 4 rows than for 4,100, so
    the f32 run parts by ~1e-4 of the rms at its worst logit, and in bf16
    a one-ulp difference spreads through the next GEMMs' roundings, so
    single logits part by up to ~3 % of their rms, as two bf16 runs of the
    full forward in other GEMM shapes would. An MoE's bf16 run is printed, not gated: there such a
    difference also routes a near-tied token to another expert, a jump
    (granite: mean |diff| 2.2 % of the rms, max 0.30, by step 4), as the
    reference's jitted and op-by-op bf16 runs route otherwise on the CPU;
    its f32 run, where ties that close do not occur, is gated."""
    import dataclasses
    import torch
    from repro_torch.models.lm.decode import prefill, serve_step
    from repro_torch.models.lm.transformer import lm_forward, lm_logits
    b, prompt, s_max, steps = DECODE
    gen = torch.Generator(device=device).manual_seed(7)
    toks = torch.randint(0, cfg.vocab, (b, prompt + steps), generator=gen,
                         device=device)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, cfg, toks[:, :prompt], s_max=s_max)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(steps):
            logits, cache = serve_step(params, cfg, cache,
                                       toks[:, prompt + i:prompt + i + 1])
        torch.cuda.synchronize()
        t_decode = time.perf_counter() - t0
        if int(cache["pos"]) != prompt + steps or not bool(
                torch.isfinite(logits).all()):
            raise SystemExit(f"{tag} decode: pos {int(cache['pos'])} or "
                             f"non-finite logits")
        cache_bytes = sum(cache[n].numel() * cache[n].element_size()
                          for n in ("k", "v"))
        del cache, logits
        ccfg = cfg
        if cfg.moe is not None:
            ccfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe,
                capacity_factor=cfg.moe.n_experts_padded / cfg.moe.top_k))
        errs = {}
        for cdt in ("float32", "bfloat16"):
            c = dataclasses.replace(ccfg, compute_dtype=cdt)
            logits, cache = prefill(params, c, toks[:, :prompt],
                                    s_max=s_max)
            for i in range(DECODE_CHECKED):
                pos = prompt + i
                logits, cache = serve_step(params, c, cache,
                                           toks[:, pos:pos + 1])
                if cdt == "float32":
                    want = cached_forward_logits(params, c,
                                                 toks[:, :pos + 1], prompt)
                else:
                    want = lm_logits(params, c, lm_forward(
                        params, c, toks[:, :pos + 1]))[:, -1]
                d = (logits - want).abs()
                rms = want.pow(2).mean().sqrt()
                if cdt == "float32":
                    ok = bool(d.max() <= DECODE_F32_TOL * rms)
                else:       # an MoE's bf16 run: printed (docstring)
                    ok = cfg.moe is not None or bool(
                        d.mean() <= LM_BF16_TOL * rms)
                errs.setdefault(cdt, []).append(
                    (float(d.max()), float(d.mean()),
                     float(want.pow(2).mean().sqrt())))
                if not ok:
                    raise SystemExit(f"{tag} decode ({cdt}): step {i + 1}'s "
                                     f"logits off the full forward's: "
                                     f"{errs[cdt][-1]}")
            del cache, logits
    rate = b * steps / t_decode

    def fmt(rows):
        return ", ".join(f"{mx:.3e} / {mean:.3e}" for mx, mean, _ in rows)
    print(f"[lm decode] {tag} {card}: prefill {b} x {prompt} into s_max "
          f"{s_max} {t_prefill * 1e3:.1f} ms, then {steps} serve_steps "
          f"{t_decode * 1e3:.1f} ms: {rate:.1f} decode tokens/s; the bf16 "
          f"cache {cache_bytes} B. The first {DECODE_CHECKED} steps' logits "
          f"against a forward, max / mean |diff| a step: f32 compute vs "
          f"the forward over the cache's bf16 K/V {fmt(errs['float32'])} "
          f"(max within {DECODE_F32_TOL} x the logits' rms); bf16 compute "
          f"vs lm_forward + "
          f"lm_logits {fmt(errs['bfloat16'])} ("
          + ("printed: MoE routing" if cfg.moe is not None else
             f"mean within {LM_BF16_TOL} x the logits' rms")
          + f", {errs['bfloat16'][0][2]:.3f})"
          + ("" if cfg.moe is None else
             f"; checked at capacity_factor {ccfg.moe.capacity_factor} (no "
             f"token dropped), timed at {cfg.moe.capacity_factor}"))
    return dict(tokens_per_s=rate, cache_bytes=cache_bytes, errs=errs)


def phase_lm(mods, device, card: str) -> dict:
    """The LM family at full width, cut in depth (LM_RUNS): LM_STEPS
    training steps at the train_4k sequence through the port's Trainer and
    adam, twice from one init tree (bit for bit), and once more with
    full_attn_max_seq = q_chunk = LM_CHUNK (each step's loss against the
    unchunked loss on the same params within CHUNK_RTOL); steps/s,
    tokens/s, peak memory and the model-FLOP rate; then decode
    (``lm_decode``). None of B1-B7 launches."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.lm.transformer import lm_init, lm_loss
    from repro_torch.tree import leaves, tree_map
    out = {}
    for arch, layers, b in LM_RUNS:
        reset_counts(mods)
        full_cfg = get_arch(arch).CONFIG
        cfg = dataclasses.replace(full_cfg, n_layers=layers)
        chunked = dataclasses.replace(cfg, full_attn_max_seq=LM_CHUNK,
                                      q_chunk=LM_CHUNK)
        params = lm_init(torch.Generator(device=device).manual_seed(0), cfg,
                         device=device)
        n_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
        print(f"[lm] {arch} reduced: {layers} of {full_cfg.n_layers} layers "
              f"(every width the published config's: d {cfg.d_model}, "
              f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV, d_head "
              f"{cfg.d_head}, d_ff {cfg.d_ff}"
              + (f", {cfg.moe.n_experts} experts padded to "
                 f"{cfg.moe.n_experts_padded}, top-{cfg.moe.top_k}, "
                 f"d_ff_expert {cfg.moe.d_ff_expert}" if cfg.moe else "")
              + f", vocab {cfg.vocab}); {cfg.n_params():,} params "
              f"({cfg.n_active_params():,} active a token), {n_bytes:,} B "
              f"allocated ({cfg.param_dtype}); batch {b} x {LM_SEQ}, "
              f"{LM_STEPS} steps; random weights from seed 0")
        gen = torch.Generator(device=device).manual_seed(1)
        batches = [{"tokens": torch.randint(0, cfg.vocab, (b, LM_SEQ),
                                            generator=gen, device=device)}
                   for _ in range(LM_STEPS)]

        def loss_of(c, shadow=None):
            def loss(p, batch, g):
                if shadow is not None:
                    with torch.no_grad():
                        shadow[1].append(float(lm_loss(
                            detached(p), shadow[0], batch["tokens"],
                            batch["tokens"])))
                return lm_loss(p, c, batch["tokens"], batch["tokens"])
            return loss
        first = timed_trainer_run(loss_of(cfg), 3e-4, params, batches,
                                  LM_STEPS, device)
        # the first run's params wait on the host for the second's
        first_params = tree_map(lambda t: t.cpu(), first.pop("params"))
        second = timed_trainer_run(loss_of(cfg), 3e-4, params, batches,
                                   LM_STEPS, device)
        bitwise = (first["losses"] == second["losses"]
                   and same_params(first_params, second.pop("params")))
        del first_params
        shadows = []
        chunk = timed_trainer_run(loss_of(chunked, (cfg, shadows)), 3e-4,
                                  params, batches, LM_STEPS, device)
        chunk.pop("params")
        torch.cuda.empty_cache()
        losses = torch.tensor(first["losses"], dtype=torch.float64)
        rel = [abs(a - s) / abs(s) for a, s in zip(chunk["losses"],
                                                   shadows)]
        drift = [abs(a - s) / abs(s) for a, s in zip(chunk["losses"],
                                                     first["losses"])]
        print(f"[lm] {arch} {card}: losses {first['losses']} (second run "
              f"{second['losses']}); bit for bit (losses and every param) "
              f"{bitwise}; q-chunked ({LM_CHUNK}) per-step loss vs the "
              f"unchunked loss on the same params, relative "
              f"{[float(f'{r:.3e}') for r in rel]} (bound {CHUNK_RTOL}); "
              f"free-running chunked vs unchunked relative "
              f"{[float(f'{r:.3e}') for r in drift]}")
        if not bool(torch.isfinite(losses).all()) or not bitwise:
            raise SystemExit(f"lm {arch}: non-finite losses or a second run "
                             f"that is not bit for bit")
        if max(rel) > CHUNK_RTOL or drift[0] > CHUNK_RTOL:
            raise SystemExit(f"lm {arch}: the q-chunked loss is off the "
                             f"unchunked one by {max(rel):.3e} (relative)")
        prof = busy_share(lambda: timed_trainer_run(
            loss_of(cfg), 3e-4, params, batches[:2], 2, device))
        print(f"[lm] {arch} {card}: {busy_text(prof, 'a 2-step run')}; "
              f"device time by kernel: {top_text(prof)}")
        steps_per_s = LM_STEPS / second["wall"]
        flops = lm_flops(cfg, b, LM_SEQ)
        share = flops * steps_per_s / BF16_FLOP_PER_S
        print(f"[lm] {arch} {card}: {steps_per_s:.3f} steps/s "
              f"({second['wall']:.3f} s for {LM_STEPS} steps; the first "
              f"run {first['wall']:.3f} s), {steps_per_s * b * LM_SEQ:.1f} "
              f"tokens/s, peak memory {gib(second['peak'])}; model FLOPs "
              f"{flops:.4e} a step (6 x {cfg.n_active_params():,} x "
              f"{b * LM_SEQ} + attention): {flops * steps_per_s / 1e12:.2f} "
              f"TFLOP/s, {100 * share:.2f} % of the card's dense bf16 peak "
              f"(989 TFLOP/s)")
        no_launches(mods, f"lm {arch} training")
        dec = lm_decode(params, cfg, device, card, arch)
        no_launches(mods, f"lm {arch} decode")
        del params, batches
        torch.cuda.empty_cache()
        out[arch] = dict(steps_per_s=steps_per_s, busy=prof["busy"],
                         tokens_per_s=steps_per_s * b * LM_SEQ,
                         peak=second["peak"], mfu=share,
                         decode_tokens_per_s=dec["tokens_per_s"])
    return out


def molecule_batch(device, seed=5):
    """mace_cells' molecule shape: MACE_MOLECULE's graphs of 30 nodes and
    64 edges (both ends in the graph) as one block-diagonal batch,
    positions ~ N(0, 1.5²) a coordinate, features and energy targets
    ~ N(0, 1), from numpy."""
    import numpy as np
    import torch
    graphs, per, edges, d_feat = MACE_MOLECULE
    rng = np.random.default_rng(seed)
    n, e = graphs * per, graphs * edges
    base = np.repeat(np.arange(graphs) * per, edges)
    edge_index = np.stack([rng.integers(0, per, e) + base,
                           rng.integers(0, per, e) + base], axis=1)
    t = lambda a: torch.from_numpy(a).to(device)
    return dict(
        node_feat=t(rng.normal(size=(n, d_feat)).astype(np.float32)),
        positions=t((1.5 * rng.normal(size=(n, 3))).astype(np.float32)),
        edge_index=t(edge_index.astype(np.int32)),
        edge_mask=torch.ones((e,), dtype=torch.bool, device=device),
        graph_ids=t(np.repeat(np.arange(graphs), per).astype(np.int32)),
        targets=t(rng.normal(size=(graphs,)).astype(np.float32)))


def phase_mace(mods, device, card: str) -> dict:
    """MACE (the published config: channels 128, l_max 2, correlation 3)
    at mace_cells' molecule shape: MACE_STEPS dense training steps twice
    from one init tree (bit for bit), the energy under a random rotation
    plus a translation, the card's forward against the CPU's on the same
    params, ``hoist_gathers`` on against off; steps/s and peak memory. None
    of B1-B7 launches."""
    import numpy as np
    import torch
    from repro_torch.models.gnn.irreps import random_rotation
    from repro_torch.models.gnn.mace import (MACEConfig, mace_forward,
                                             mace_init)
    from repro_torch.tree import tree_map
    reset_counts(mods)
    graphs, per, edges, d_feat = MACE_MOLECULE
    cfg = MACEConfig(n_feat_in=d_feat, n_out=1)
    params = mace_init(torch.Generator(device=device).manual_seed(3), cfg,
                       device=device)
    batch = molecule_batch(device)

    def forward(p, b, **kw):
        b = {k: v for k, v in b.items() if k != "targets"}
        return mace_forward(p, cfg, **b, n_graphs=graphs, **kw)

    def loss(p, b, g):
        return torch.mean((forward(p, b)["energy"][:, 0] - b["targets"])
                          ** 2)
    runs = [timed_trainer_run(loss, 1e-3, params, [batch] * MACE_STEPS,
                              MACE_STEPS, device) for _ in range(2)]
    prof = busy_share(lambda: timed_trainer_run(
        loss, 1e-3, params, [batch] * MACE_STEPS, MACE_STEPS, device))
    bitwise = (runs[0]["losses"] == runs[1]["losses"]
               and same_params(runs[0]["params"], runs[1]["params"]))
    with torch.no_grad():
        out = forward(params, batch)
        hoisted = forward(params, batch, hoist_gathers=True)
        rot = torch.from_numpy(random_rotation(11).astype(np.float32)).to(
            device)
        moved = dict(batch, positions=batch["positions"] @ rot.T
                     + torch.tensor([2.0, -1.0, 0.5], device=device))
        turned = forward(params, moved)
        cpu = forward(tree_map(lambda t: t.cpu(), params),
                      tree_map(lambda t: t.cpu(), batch))
    errs = {"invariance": float((turned["energy"] - out["energy"]).abs()
                                .max()),
            "cpu": float((cpu["energy"] - out["energy"].cpu()).abs().max()),
            "hoist": float((hoisted["energy"] - out["energy"]).abs().max())}
    steps_per_s = MACE_STEPS / runs[1]["wall"]
    print(f"[mace] {card}: molecule shape ({graphs} graphs x {per} nodes / "
          f"{edges} edges, d_feat {d_feat}; channels {cfg.channels}, l_max "
          f"{cfg.l_max}, correlation {cfg.correlation}, {cfg.n_layers} "
          f"layers: nothing cut); losses {runs[0]['losses']} (second run "
          f"bit for bit: {bitwise}); energy max|diff| under rotation + "
          f"translation {errs['invariance']:.3e} (bound "
          f"{MACE_INVARIANCE_TOL}), card vs CPU {errs['cpu']:.3e} (bound "
          f"{MACE_CPU_TOL}), hoist_gathers on vs off {errs['hoist']:.3e} "
          f"(bound {MACE_HOIST_TOL}); {steps_per_s:.2f} steps/s "
          f"({runs[1]['wall']:.3f} s for {MACE_STEPS}; first run "
          f"{runs[0]['wall']:.3f} s), peak memory {gib(runs[1]['peak'])}; "
          f"{busy_text(prof)}; device time by kernel: {top_text(prof)}")
    finite = all(np.isfinite(r["losses"]).all() for r in runs)
    if not (finite and bitwise):
        raise SystemExit("mace: non-finite losses or a second run that is "
                         "not bit for bit")
    if not (torch.allclose(turned["energy"], out["energy"],
                           atol=MACE_INVARIANCE_TOL,
                           rtol=MACE_INVARIANCE_TOL)
            and torch.allclose(cpu["energy"], out["energy"].cpu(),
                               atol=MACE_CPU_TOL, rtol=MACE_CPU_TOL)
            and torch.allclose(hoisted["energy"], out["energy"],
                               atol=MACE_HOIST_TOL, rtol=MACE_HOIST_TOL)):
        raise SystemExit(f"mace: a check failed: {errs}")
    no_launches(mods, "mace")
    del runs
    torch.cuda.empty_cache()
    return dict(steps_per_s=steps_per_s, errs=errs, busy=prof["busy"])


def phase_lm_smoke(mods, device, card: str) -> None:
    """The five LM archs' and MACE's smoke configs: SMOKE_STEPS steps
    through ``python -m repro_torch.launch.train --arch X`` on the card
    (its default device; the six processes started together), each ending
    with its done line on cuda; in this process meanwhile the launcher's
    same runs (``launch.train.lm_smoke`` / ``mace_smoke``) with each step's
    loss held against the CPU's on the same params and batch (atol = rtol
    LM_BF16_TOL for the bf16 LMs, MACE_CPU_TOL for MACE's f32)."""
    import itertools
    import os
    import shutil
    import tempfile
    import torch
    from repro_torch.launch.train import lm_smoke, mace_smoke
    from repro_torch.tree import tree_map
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    kind = torch.device(device).type
    tmp = Path(tempfile.mkdtemp(prefix="lm_smoke_", dir=str(build_dir())))
    procs = {}
    try:
        for arch in SMOKE_ARCHS:       # on the card: the default device
            procs[arch] = launcher(
                ["--arch", arch, "--steps", str(SMOKE_STEPS)]
                + ([] if kind == "cuda" else ["--device", kind]), env,
                tmp / f"{arch}.log")
        reset_counts(mods)
        for arch in SMOKE_ARCHS:
            make = (lambda d: mace_smoke(d)) if arch == "mace" else (
                lambda d, a=arch: lm_smoke(a, d))
            run, cpu = make(device), make("cpu")
            shadows = []

            def loss(p, b, g, run=run, cpu=cpu, shadows=shadows):
                with torch.no_grad():
                    shadows.append(float(cpu["loss"](
                        tree_map(lambda t: t.detach().cpu(), p),
                        tree_map(lambda t: t.cpu(), b), None)))
                return run["loss"](p, b, g)
            batches = list(itertools.islice(run["batches"](0),
                                            SMOKE_STEPS))
            res = timed_trainer_run(loss, run["lr"], run["params"], batches,
                                    SMOKE_STEPS, device)
            tol = MACE_CPU_TOL if arch == "mace" else LM_BF16_TOL
            diff = [abs(a - s) for a, s in zip(res["losses"], shadows)]
            print(f"[lm smoke] {arch} {card}: {SMOKE_STEPS} steps, card "
                  f"losses {[float(f'{x:.5g}') for x in res['losses']]}; "
                  f"each vs the CPU's on the same params max|diff| "
                  f"{max(diff):.3e} (atol = rtol {tol})")
            if not all(abs(a - s) <= tol + tol * abs(s)
                       for a, s in zip(res["losses"], shadows)):
                raise SystemExit(f"lm smoke {arch}: the card's losses are "
                                 f"off the CPU's")
        no_launches(mods, "the LM and MACE smoke configs")
        for arch, proc in procs.items():
            log_text = (tmp / f"{arch}.log")
            if proc.wait(timeout=600):
                raise SystemExit(f"launcher --arch {arch} exited "
                                 f"{proc.returncode}: "
                                 + log_text.read_text())
            done = "mace-smoke-done" if arch == "mace" else "lm-smoke-done"
            lines = [x for x in log_text.read_text().splitlines()
                     if done in x]
            print(f"[lm smoke] launcher {arch} {card}: "
                  + (lines[-1] if lines else "no done line"))
            if not lines or f"device={kind}" not in lines[-1] or \
                    f"step={SMOKE_STEPS}" not in lines[-1]:
                raise SystemExit(f"launcher --arch {arch}: no done line on "
                                 f"{kind}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def phase_ops(mods, device, card: str) -> dict:
    """``kernels/ops.py``'s three routes on the card: ``use_pallas=
    "always"`` against ``"never"`` at phase 3's B1 serving shape, B5 at
    dlrm-mlperf's scoring shape (one one-hot field of DLRM_CAP rows, B 512,
    D 128, sum) and B7 at its scoring shape (B 512, F 26, D 128), within
    the kernels' tolerances; each "always" or "auto" call launches its
    kernel exactly once and no other, "never" none; the counted drive
    (OPS_CALLS "always" calls and one "auto" a route) is the JSON's
    launches. Then each route's times beside the plain one's, its bound
    and, for B5, ``F.embedding_bag``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    emod, kmod, pmod, bmod, dmod = mods
    x = attention_inputs((64, 2, 80, 32, 32, 64, 64), seed=90, device=device)
    gen = torch.Generator(device=device).manual_seed(91)
    table = 0.02 * torch.randn((DLRM_CAP, 128), generator=gen, device=device)
    ids = torch.randint(0, DLRM_CAP, (512, 1), generator=gen, device=device,
                        dtype=torch.int32)
    lens = torch.ones(512, dtype=torch.int32, device=device)
    dense, sparse = dot_inputs(DOT_SHAPES["score B512 F26 D128"], 92, device)
    routes = {
        "b1": (lambda u: ops.hstu_attention(
            x["q"], x["k"], x["v"], x["rab"], x["hl"], x["tc"],
            n_hist=x["n_hist"], max_rel_pos=x["max_rel"], use_pallas=u),
            ATOL, RTOL),
        "b5": (lambda u: ops.embedding_bag(table, ids, lens, pooling="sum",
                                           use_pallas=u), BAG_TOL, 0.0),
        "b7": (lambda u: ops.dot_interaction(dense, sparse, use_pallas=u),
               DOT_ATOL, DOT_RTOL)}
    reset_counts(mods)
    errs = {}
    for key, (fn, atol, rtol) in routes.items():
        before = all_counts(mods)
        want = fn("never")
        if all_counts(mods) != before:
            raise SystemExit(f"ops {key}: use_pallas='never' launched")
        for use in ["always"] * OPS_CALLS + ["auto"]:
            before = all_counts(mods)
            got = fn(use)
            after = all_counts(mods)
            rose = {k: after[k] - before[k] for k in after}
            if rose != {k: int(k == key) for k in after}:
                raise SystemExit(f"ops {key} {use}: launches {rose}")
            errs[key] = max(errs.get(key, 0.0),
                            float((got - want).abs().max()))
            if not torch.allclose(got, want, atol=atol, rtol=rtol):
                raise SystemExit(f"ops {key} {use}: off 'never' by "
                                 f"{errs[key]:.3e}")
    launches = all_counts(mods)
    print(f"[ops] {card}: use_pallas='always' / 'auto' vs 'never' max|diff| "
          + ", ".join(f"{k.upper()} {v:.3e}" for k, v in errs.items())
          + f"; launches in the drive {launches}")
    flat = ids.reshape(-1).long()
    offsets = torch.arange(512, device=device)
    lib = lambda: F.embedding_bag(flat, table, offsets, mode="sum")
    out = {}
    for key, bound_fn, library, label in (
            ("b1", lambda: bound(x), None,
             "B1 hstu_attention B64 H2 S80 D32 rab"),
            ("b5", lambda: bound_bag(dict(table=table, ids=ids, lens=lens),
                                     "fwd"), lib,
             f"B5 embedding_bag sum B512 L1 D128 V{DLRM_CAP}"),
            ("b7", lambda: bound_dot(dense, sparse),
             dot_yardstick(dmod, dense, sparse),
             "B7 dot_interaction B512 F26 D128")):
        fn = routes[key][0]
        always, never = (lambda: fn("always")), (lambda: fn("never"))
        # plain, kernel, kernel, plain
        ms = {k: device_ms(f, iters) for k, f, iters in (
            ("plain", never, 20), ("kernel", always, 200),
            ("again", always, 200), ("plain_again", never, 20))}
        library_ms = device_ms(library, 100) if library else None
        bound_ms, bound_by, n_bytes, n_ops = bound_fn()
        print(f"[ops times] {card}: {label} through ops (use_pallas), "
              f"device time per call: 'always' {ms['kernel']:.5f} ms (again "
              f"{ms['again']:.5f}), 'never' {ms['plain']:.5f} ms (again "
              f"{ms['plain_again']:.5f}); bound {bound_ms:.5f} ms "
              f"({bound_by}: {n_bytes} B, {n_ops} FLOP at 3.35 TB/s / 67 "
              f"TFLOP/s); library "
              + (f"{library_ms:.5f} ms ("
                 + ("F.embedding_bag" if key == "b5" else
                    "yardstick, two calls: torch.bmm + tril index_select")
                 + ")" if library_ms else "none"))
        out[key] = dict(launches=launches[key], max_abs_err=errs[key],
                        ms=ms["kernel"], plain_ms=ms["plain"],
                        bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=library_ms)
    del table
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 23. the examples on the card (examples/torch_*.py)
# ---------------------------------------------------------------------------

EXAMPLES = ("torch_storage_analysis", "torch_quickstart", "torch_serve_roo",
            "torch_train_lsr_e2e", "torch_pipeline_e2e")
EXAMPLE_SERVE_TOL = 1e-4      # serve_roo's scores, card vs CPU (atol, rtol)
DENSE_MASK_TOL = 1e-5         # the dense-mask branch vs the MaskSpec route
BASELINE_STEPS = 10           # the impression-level baseline's timed steps


def load_example(name: str):
    """A fresh module object of ``examples/<name>.py``."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def expected_example_launches(name: str, out: dict) -> dict:
    """The launches the code gives for one example's run, from what the
    run returned: every HSTU layer's forward is one B1 and its backward
    one B2 and one B3 (``HSTUAttentionFn``); no example reaches B4-B7."""
    want = dict.fromkeys(("b1", "b2", "b3", "b4", "b5", "b6", "b7"), 0)
    if name == "torch_quickstart":          # + the held-out and served fwd
        n, steps = out["n_layers"], out["steps"]
        want.update(b1=n * (steps + 2), b2=n * steps, b3=n * steps)
    elif name == "torch_train_lsr_e2e":     # + NE on the held-out batches
        n, steps = out["n_layers"], out["steps"]
        want.update(b1=n * (steps + out["n_test_batches"]), b2=n * steps,
                    b3=n * steps)
    elif name == "torch_serve_roo":         # batches the cache did not serve
        st = out["stats"]
        want.update(b1=out["lsr_layers"] * (st["n_batches"]
                                            - st["n_full_cache_batches"])
                    + out["retrieval_layers"])
    elif name == "torch_pipeline_e2e":      # full run + killed + resumed
        n = out["n_layers"]
        steps = out["steps"] + out["kill_at"] + out["resumed_steps"]
        want.update(b1=n * steps, b2=n * steps, b3=n * steps)
    return want


@contextlib.contextmanager
def recording_hstu(kmod, bmod):
    """Record the operands of the first B1 call and of the first B2 + B3
    backward (copies) while the block runs; the kernels run and count as
    ever."""
    import torch
    rec = {}
    fwd, bwd = kmod.hstu_attention_cuda, bmod.hstu_attention_bwd_cuda

    def copy(args):
        return tuple(a.detach().clone() if torch.is_tensor(a) else a
                     for a in args)

    def fwd_rec(*args):
        rec.setdefault("fwd", copy(args))
        return fwd(*args)

    def bwd_rec(*args):
        rec.setdefault("bwd", copy(args))
        return bwd(*args)

    kmod.hstu_attention_cuda, bmod.hstu_attention_bwd_cuda = fwd_rec, bwd_rec
    try:
        yield rec
    finally:
        kmod.hstu_attention_cuda, bmod.hstu_attention_bwd_cuda = fwd, bwd


def example_kernel_times(kmod, bmod, rec: dict, tag: str, card: str) -> dict:
    """B1 (and B2 / B3 where the run trained) at the operands the run
    recorded: against the plain version, device times, bounds."""
    import torch
    out = {}
    args = rec["fwd"]
    q, k, v, rab, n_hist, hl, tc, max_rel = args
    x = dict(q=q, k=k, v=v, rab=rab, hl=hl, tc=tc, n_hist=n_hist,
             max_rel=max_rel)
    kernel = lambda: kmod.hstu_attention_cuda(*args)
    plain = lambda: kmod.hstu_attention_plain(*args)
    got, want = kernel(), plain()
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, atol=ATOL, rtol=RTOL):
        raise SystemExit(f"examples: B1 off plain by {err:.3e} at {tag}'s "
                         f"operands")
    ms = {key: device_ms(fn, iters) for key, fn, iters in (
        ("plain", plain, 20), ("kernel", kernel, 200))}
    bound_ms, bound_by, n_bytes, ops = bound(x)
    b, h, s, d = q.shape
    print(f"[examples times] {card}: B1 hstu_attention_fwd at {tag}'s "
          f"operands B{b} H{h} S{s} D{d} (hist {int(hl.max())} max, "
          f"targets {int(tc.max())} max), device time per call: kernel "
          f"{ms['kernel']:.5f} ms, plain torch {ms['plain']:.5f} ms; bound "
          f"{bound_ms:.5f} ms ({bound_by}: {n_bytes} B, {ops} FLOP); "
          f"max|B1 - plain| {err:.3e}")
    out["b1"] = dict(ms=ms["kernel"], plain_ms=ms["plain"],
                     bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                     max_abs_err=err)
    if "bwd" not in rec:
        return out
    args = rec["bwd"]
    q, k, v, rab, n_hist, hl, tc, max_rel, g = args
    x = dict(q=q, k=k, v=v, rab=rab, hl=hl, tc=tc, n_hist=n_hist)
    dq, drab = bmod.hstu_attention_bwd_dq_cuda(*args)
    dk, dv = bmod.hstu_attention_bwd_dkv_cuda(*args)
    pdq, pdk, pdv, pdrab = bmod.hstu_attention_bwd_plain(*args)
    errs = {"b2": max(float((dq - pdq).abs().max()),
                      float((drab - pdrab).abs().max())),
            "b3": max(float((dk - pdk).abs().max()),
                      float((dv - pdv).abs().max()))}
    if not (all(torch.allclose(a, b, atol=ATOL, rtol=RTOL)
                for a, b in ((dq, pdq), (dk, pdk), (dv, pdv)))
            and torch.allclose(drab, pdrab, atol=LOGIT_TOL, rtol=LOGIT_TOL)):
        raise SystemExit(f"examples: B2 / B3 off plain by {errs} at {tag}'s "
                         f"operands")
    b2 = lambda: bmod.hstu_attention_bwd_dq_cuda(*args)
    b3 = lambda: bmod.hstu_attention_bwd_dkv_cuda(*args)
    plain = lambda: bmod.hstu_attention_bwd_plain(*args)
    ms = {key: device_ms(fn, iters) for key, fn, iters in (
        ("plain", plain, 8), ("b2", b2, 200), ("b3", b3, 200))}
    for key, which, label in (("b2", "dq", "B2 hstu_attention_bwd_dq"),
                              ("b3", "dkv", "B3 hstu_attention_bwd_dkv")):
        bound_ms, bound_by, n_bytes, ops = bound_bwd(x, which)
        print(f"[examples times] {card}: {label} at {tag}'s operands, "
              f"device time per call: kernel {ms[key]:.5f} ms, plain torch "
              f"backward {ms['plain']:.5f} ms; bound {bound_ms:.5f} ms "
              f"({bound_by}: {n_bytes} B, {ops} FLOP); max|kernel - plain| "
              f"{errs[key]:.3e}")
        out[key] = dict(ms=ms[key], plain_ms=ms["plain"], bound_ms=bound_ms,
                        bound_by=bound_by, library_ms=None,
                        max_abs_err=errs[key])
    return out


def example_dense_mask(kmod, device, card: str) -> float:
    """The dense-mask branch of ``hstu_apply`` (plain torch on the card)
    against the MaskSpec route (B1), at the examples' HSTU widths, for a
    (B, S, S) ``roo_batch_mask`` and an (S, S) ``roo_sequence_mask``."""
    import torch
    from repro_torch.core import hstu
    from repro_torch.core.masks import (roo_batch_mask, roo_sequence_mask,
                                        roo_spec)
    cfg = hstu.HSTUConfig(d_model=64, n_heads=2, d_qk=32, d_v=32,
                          n_layers=2, max_rel_pos=64)
    gen = torch.Generator().manual_seed(23)
    params = hstu.hstu_init(gen, cfg, device=device)
    for layer in params["layers"]:          # a bias that moves the scores
        layer["rab"] = 0.5 * torch.randn(tuple(layer["rab"].shape),
                                         generator=gen).to(device)
    b, n_hist, m = 32, 48, 16
    x = torch.randn((b, n_hist + m, cfg.d_model), generator=gen).to(device)
    hl = torch.randint(0, n_hist + 1, (b,), generator=gen,
                       dtype=torch.int32)
    tc = torch.randint(0, m + 1, (b,), generator=gen, dtype=torch.int32)
    hl[0], tc[0] = n_hist, m
    hl, tc = hl.to(device), tc.to(device)
    full_hl = torch.full_like(hl, n_hist)
    full_tc = torch.full_like(tc, m)
    worst = 0.0
    with torch.no_grad():
        for what, mask, spec in (
                ("(B, S, S) roo_batch_mask", roo_batch_mask(hl, tc, n_hist, m),
                 roo_spec(hl, tc, n_hist)),
                ("(S, S) roo_sequence_mask",
                 roo_sequence_mask(n_hist, m, device),
                 roo_spec(full_hl, full_tc, n_hist))):
            before = kmod.launch_count
            dense = hstu.hstu_apply(params, cfg, x, mask)
            if kmod.launch_count != before:
                raise SystemExit("examples: the dense-mask branch launched B1")
            got = hstu.hstu_apply(params, cfg, x, spec)
            if kmod.launch_count - before != cfg.n_layers:
                raise SystemExit("examples: the MaskSpec route did not launch "
                                 "B1 once a layer")
            err = float((dense - got).abs().max())
            worst = max(worst, err)
            if not torch.allclose(dense, got, atol=DENSE_MASK_TOL,
                                  rtol=DENSE_MASK_TOL):
                raise SystemExit(f"examples: dense-mask branch {what} off the "
                                 f"MaskSpec route by {err:.3e}")
            print(f"[examples] {card}: hstu_apply B{b} S{n_hist + m} "
                  f"d{cfg.d_model} x {cfg.n_layers} layers, dense {what} "
                  f"(plain torch) vs the MaskSpec route (B1): max|diff| "
                  f"{err:.3e} (tol {DENSE_MASK_TOL:g})")
    return worst


def example_baseline(quick, device, card: str) -> dict:
    """The paper's impression-level baseline beside ROO at the quickstart's
    stream, config and optimizer: ``impression_batches`` with B_RO = B_NRO
    = the quickstart's B_NRO against the quickstart's ROO batches, the same
    impression slots a step; a warm-up step, then ``BASELINE_STEPS``
    timed steps each."""
    import math
    import torch
    from repro_torch.configs import roo_models as rm
    from repro_torch.core.joiner import (ImpressionLevelJoiner,
                                         RequestLevelJoiner)
    from repro_torch.data.batcher import (BatcherConfig, ROOBatcher,
                                          impression_batches)
    from repro_torch.data.events import EventSimulator, EventStreamConfig
    from repro_torch.models.lsr import lsr_init, lsr_loss
    from repro_torch.train.loop import value_and_grad
    from repro_torch.train.optim import adam
    events = list(EventSimulator(EventStreamConfig(
        n_requests=quick.N_REQUESTS, hist_init_max=quick.HIST_INIT_MAX,
        seed=quick.SEED)).stream())
    bcfg = BatcherConfig(b_ro=quick.B_RO, b_nro=quick.B_NRO,
                         hist_len=quick.HIST_LEN)
    runs = {"roo": list(ROOBatcher(bcfg, device=device).batches(
                RequestLevelJoiner().join(events))),
            "impression": list(impression_batches(
                ImpressionLevelJoiner().join(events), quick.B_NRO, bcfg,
                device=device))}
    cfg = rm.lsr_config("userarch_hstu")
    vag = value_and_grad(lambda p, b, g: lsr_loss(p, cfg, b))
    out = {}
    for tag, batches in runs.items():
        params = lsr_init(torch.Generator().manual_seed(quick.SEED), cfg,
                          device=device)
        opt = adam(1e-3)
        state = opt.init(params)
        loss, grads = vag(params, batches[0], None)      # warm-up
        params, state = opt.update(grads, state, params)
        order = [batches[i % len(batches)] for i in range(BASELINE_STEPS)]
        n_imp = sum(int(b.num_valid_impressions()) for b in order)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = []
        for batch in order:
            loss, grads = vag(params, batch, None)
            params, state = opt.update(grads, state, params)
            losses.append(loss)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        losses = [float(x) for x in losses]
        if not all(math.isfinite(x) for x in losses):
            raise SystemExit(f"examples: {tag} baseline losses {losses}")
        out[tag] = dict(steps_per_s=BASELINE_STEPS / dt,
                        impressions_per_s=n_imp / dt,
                        impressions_a_step=n_imp / BASELINE_STEPS,
                        b_ro=batches[0].b_ro, b_nro=batches[0].b_nro,
                        n_batches=len(batches))
    r, i = out["roo"], out["impression"]
    print(f"[examples] {card}: impression-level baseline (impression_batches"
          f", B_RO = B_NRO = {i['b_nro']}) {i['steps_per_s']:.2f} steps/s, "
          f"{i['impressions_per_s']:.1f} impressions/s "
          f"({i['impressions_a_step']:.1f} a step) vs the quickstart's ROO "
          f"batches (B_RO {r['b_ro']}, B_NRO {r['b_nro']}) "
          f"{r['steps_per_s']:.2f} steps/s, {r['impressions_per_s']:.1f} "
          f"impressions/s ({r['impressions_a_step']:.1f} a step): "
          f"{i['steps_per_s'] / r['steps_per_s']:.3f}x the ROO steps/s at "
          f"{i['b_nro']} impression slots a step, "
          f"{i['impressions_per_s'] / r['impressions_per_s']:.3f}x its "
          f"impressions/s")
    return out


def phase_examples(mods, device, card: str) -> dict:
    """Phase 23 (module note): each example's ``main`` in process on the
    card at the reference's sizes, its launches gated against the code's
    counts, then the dense-mask branch, the impression-level baseline and
    the kernel times at the recorded operands."""
    import math
    import shutil

    import numpy as np
    import torch
    emod, kmod, pmod, bmod, dmod = mods
    t_phase = time.perf_counter()
    root = build_dir() / "chip_smoke_examples"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    runs, times = {}, {}
    for name in EXAMPLES:
        ex = load_example(name)
        argv = ["--device", "cuda"]
        if name == "torch_train_lsr_e2e":
            argv += ["--ckpt-dir", str(root / "ckpt")]
        t0 = time.perf_counter()
        with spec_scope():
            reset_counts(mods)
            with recording_hstu(kmod, bmod) as rec:
                out = ex.main(argv)
            counts = all_counts(mods)
        wall = time.perf_counter() - t0
        want = expected_example_launches(name, out)
        if counts != want:
            raise SystemExit(f"examples: {name} launched {counts}, the code "
                             f"gives {want}")
        print(f"[examples] {card}: {name} {wall:.1f} s, launches {counts} "
              f"(as the code gives)")
        runs[name] = dict(out=out, launches=counts, wall_s=wall)
        if rec:
            times[name] = example_kernel_times(kmod, bmod, rec, name, card)
        if name == "torch_quickstart":
            quick = ex
    # results
    q = runs["torch_quickstart"]["out"]
    tr = runs["torch_train_lsr_e2e"]["out"]
    pipe = runs["torch_pipeline_e2e"]["out"]
    for tag, vals in (("quickstart", q["epoch_losses"] + [q["ne"]]),
                      ("train_lsr_e2e", tr["losses"] + [tr["ne"]]),
                      ("pipeline_e2e", pipe["losses"])):
        if not all(math.isfinite(v) for v in vals):
            raise SystemExit(f"examples: {tag} has non-finite losses / NE "
                             f"{vals}")
    if not pipe["same"] or tr["start_step"] != 0 \
            or tr["final_step"] != tr["steps"]:
        raise SystemExit("examples: the pipeline's resume or the training "
                         "run from a fresh directory did not hold")
    serve = runs["torch_serve_roo"]["out"]
    with spec_scope():
        cpu = load_example("torch_serve_roo").main(["--device", "cpu"])
    serve_err = 0.0
    for key in ("scores", "repeat_scores", "online"):
        for got, want in zip(serve[key], cpu[key]):
            serve_err = max(serve_err, float(np.abs(got - want).max()))
            np.testing.assert_allclose(got, want, atol=EXAMPLE_SERVE_TOL,
                                       rtol=EXAMPLE_SERVE_TOL)
    user_err = float((serve["user_repr"] - cpu["user_repr"]).abs().max())
    if not torch.allclose(serve["user_repr"], cpu["user_repr"],
                          atol=EXAMPLE_SERVE_TOL, rtol=EXAMPLE_SERVE_TOL):
        raise SystemExit(f"examples: serve_roo's retrieval user repr off the "
                         f"CPU by {user_err:.3e}")
    print(f"[examples] {card}: serve_roo card vs CPU: scores max|diff| "
          f"{serve_err:.3e}, retrieval user repr {user_err:.3e} (tol "
          f"{EXAMPLE_SERVE_TOL:g}); first pass "
          f"{serve['requests_per_s']:.1f} requests/s, cache pass "
          f"{serve['repeat_requests_per_s']:.1f} requests/s, 1-vs-1M "
          f"retrieval {serve['retrieval_ms']:.3f} ms")
    print(f"[examples] {card}: quickstart {q['steps_per_s']:.2f} steps/s "
          f"({q['steps']} steps), held-out NE {q['ne']:.4f}; train_lsr_e2e "
          f"{tr['n_params'] / 1e6:.1f}M params, {tr['steps_per_s']:.2f} "
          f"steps/s over {tr['steps']} steps (3 checkpoints included), "
          f"held-out NE {tr['ne']:.4f}; pipeline_e2e resume bit for bit "
          f"after {pipe['kill_at']} + {pipe['resumed_steps']} steps")
    dense_err = example_dense_mask(kmod, device, card)
    baseline = example_baseline(quick, device, card)
    wall = time.perf_counter() - t_phase
    print(f"[examples] {card}: phase 23 {wall:.1f} s")
    shutil.rmtree(root, ignore_errors=True)
    return dict(runs=runs, times=times, dense_err=dense_err,
                baseline=baseline, serve_err=serve_err, wall_s=wall)


# phase 22: the dry run's processes (all started together: one a core of
# the card's host) and the card's checks of its estimates
DRYRUN_SHARDS = (("16x16", 3), ("2x16x16", 3), ("1x1", 2))
DRYRUN_TIMEOUT_S = 600
DRYRUN_CARD_GIB = 60
DRYRUN_PEAK_TOL = 0.20
DRYRUN_STEPS = 3
DRYRUN_MUST = (("mace", "molecule"), ("mind", "serve_p99"),
               ("bert4rec", "serve_p99"), ("dien", "serve_p99"))


def phase_dryrun(mods, device, card: str) -> dict:
    """Phase 22 (module note). Returns the card runs by cell."""
    import os
    import statistics
    import torch
    import torch.distributed as dist
    from repro_torch.launch.dryrun import run_on_card
    out_dir = ROOT / "chiprun_out" / "dryrun"
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    procs = []
    for mesh, n in DRYRUN_SHARDS:
        for k in range(n):
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--all", "--shard", f"{k}/{n}", "--out",
                   str(out_dir / mesh)]
            cmd += (["--multi-pod"] if mesh == "2x16x16" else
                    ["--mesh", mesh] if mesh == "1x1" else [])
            procs.append((mesh, subprocess.Popen(
                cmd, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)))
    ok = {mesh: [] for mesh, _ in DRYRUN_SHARDS}
    failed = []
    for mesh, p in procs:
        stdout, stderr = p.communicate(timeout=DRYRUN_TIMEOUT_S)
        ok[mesh] += [ln for ln in stdout.splitlines() if ln.startswith("OK")]
        if p.returncode != 0:
            failed.append((mesh, p.returncode, stdout[-2000:]
                           + stderr[-2000:]))
    wall = time.perf_counter() - t0
    print(f"[dryrun] {card}: {len(procs)} processes in {wall:.1f} s; OK "
          f"lines " + ", ".join(f"{m} {len(v)}" for m, v in ok.items()))
    if failed or any(len(v) != 40 for v in ok.values()):
        raise SystemExit(f"dryrun: a process failed or a mesh has not 40 "
                         f"OK lines: {failed}")

    def result(mesh, arch, shape):
        tag = f"{arch}__{shape}__{'pod2' if mesh == '2x16x16' else 'pod1'}"
        tag += "__1x1" if mesh == "1x1" else ""
        return json.loads((out_dir / mesh / f"{tag}.json").read_text())

    from repro_torch.configs.registry import all_cells
    cells = all_cells()
    for mesh in ("16x16", "2x16x16"):
        print(f"[dryrun {mesh}] {card}: dominant roofline term (H100 "
              f"constants, meta analysis) " + ", ".join(
                  f"{a}/{s} {result(mesh, a, s)['roofline']['dominant']}"
                  for a, s in cells))
    est = {(a, s): result("1x1", a, s) for a, s in cells}
    pick = [c for c in cells if est[c]["memory_analysis"]["peak_bytes"]
            < DRYRUN_CARD_GIB * 2 ** 30]
    if any(c not in pick for c in DRYRUN_MUST):
        raise SystemExit(f"dryrun: a required cell's 1x1 estimate is over "
                         f"{DRYRUN_CARD_GIB} GiB: {pick}")
    plain = {"REPRO_TORCH_HSTU_BACKEND": "torch-chunked",
             "REPRO_TORCH_EMB_BACKEND": "torch",
             "REPRO_TORCH_DOT_BACKEND": "torch"}
    os.environ.update(plain)
    print(f"[dryrun card] {card}: plain backends {plain}; cells under "
          f"{DRYRUN_CARD_GIB} GiB at 1x1: {[f'{a}/{s}' for a, s in pick]}")
    runs, bad = {}, []
    for arch, shape in pick:
        e = est[arch, shape]
        reset_counts(mods)
        r = run_on_card(arch, shape, device, steps=DRYRUN_STEPS, seed=0)
        counts = all_counts(mods)
        want_f = e["cost_analysis"]["flops"]
        want_p = e["memory_analysis"]["peak_bytes"]
        ratio = r["peak_bytes"] / want_p
        roof = max(e["roofline"][k]
                   for k in ("compute_s", "memory_s", "collective_s"))
        step_s = statistics.median(r["step_s"])
        print(f"[dryrun card {arch}/{shape}] {card}: FLOPs {r['flops']:.6e} "
              f"(dry run {want_f:.6e}, equal: {r['flops'] == want_f}); "
              f"peak {gib(r['peak_bytes'])} vs estimate {gib(want_p)} "
              f"(ratio {ratio:.3f}; arguments {gib(r['argument_bytes'])} vs "
              f"{gib(e['memory_analysis']['argument_bytes'])}); step "
              f"{1e3 * step_s:.3f} ms (steps {[round(1e3 * t, 3) for t in r['step_s']]}) "
              f"vs the roofline's largest term {1e3 * roof:.3f} ms "
              f"({e['roofline']['dominant']}; {step_s / roof:.1f}x); "
              f"launches {counts}")
        runs[arch, shape] = dict(r, ratio=ratio, roof=roof, counts=counts)
        if r["flops"] != want_f or abs(ratio - 1) > DRYRUN_PEAK_TOL \
                or any(counts.values()):
            bad.append(f"{arch}/{shape}")
    for k in plain:
        os.environ.pop(k, None)
    if dist.is_initialized():
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    if bad:
        raise SystemExit(f"dryrun: the card is off the estimate for {bad}")
    return dict(wall=wall, runs=runs)


BF16_TOL = 2e-2               # bf16 kernels vs the fp32 oracle on the same
                              # bf16 values, atol and rtol (the reference's
                              # bf16 kernel tolerance, tests/test_kernels.py)
BF16_SCORE_TOL = 2e-2         # bf16 hstu-gr scores, card vs CPU and
                              # incremental vs stateless (atol and rtol):
                              # ~4 bf16 ulps at |score| 3
BF16_LOSS_RTOL = 5e-3         # a bf16 step's loss vs the plain backends on
                              # the same params: ~1 bf16 ulp of a logit
BF16_B1_SHAPES = {   # (B, H, S, Dqk, Dv, n_hist, max_rel)
    "serve B64 S80": (64, 2, 80, 32, 32, 64, 64),
    "train B32 S80": (32, 2, 80, 32, 32, 64, 64),
    "D64 S80": (8, 2, 80, 64, 64, 64, 64),
    "wide D128 S160": (3, 2, 160, 128, 128, 140, 128),
    "short S17 D18/13": (7, 3, 17, 18, 13, 12, 8),   # one-element copies
    "causal B32 S64": (32, 2, 64, 32, 32, 64, 64),
}
BF16_B4_SHAPES = {   # (B, H, n_hist, n_new, m, Dqk, Dv, max_rel, scale_len)
    "serve n_new=1": (64, 2, 64, 1, 16, 32, 32, 64, 80),
    "serve n_new=8": (64, 2, 64, 8, 16, 32, 32, 64, 80),
    "serve n_new=64": (64, 2, 64, 64, 16, 32, 32, 64, 80),
    "D64": (8, 2, 64, 8, 16, 64, 64, 64, 80),
    "wide D128": (3, 2, 140, 20, 20, 128, 128, 128, 160),
    "short D18/13": (5, 3, 30, 7, 4, 18, 13, 8, 34),
}


def as_bf16(x) -> dict:
    """``attention_inputs`` / ``prefix_inputs`` with q, k, v and rab rounded
    to bf16 (the same dict otherwise)."""
    import torch
    return {key: (val.to(torch.bfloat16) if key in ("q", "k", "v", "rab")
                  else val) for key, val in x.items()}


def bf16_close(got, want) -> tuple:
    """(max |got - want|, ok): a bf16 result against fp32 ``want`` within
    BF16_TOL x max(1, max |want|) + BF16_TOL |want|."""
    import torch
    err = (got.float() - want).abs()
    scale = max(1.0, float(want.abs().max())) if want.numel() else 1.0
    ok = bool(torch.all(err <= BF16_TOL * scale + BF16_TOL * want.abs()))
    return (float(err.max()) if err.numel() else 0.0), ok


def phase_bf16_kernels(kmod, pmod, bmod, device) -> dict:
    """The bf16 variants of B1-B4 on the card through dispatch's auto
    backend: each against the fp32 oracle on the same bf16 values and bit
    for bit against the fp32 kernel on those values, rounded to bf16;
    masked rows exactly 0, two calls bit for bit. Returns the largest
    |kernel - oracle| of each kernel's outputs."""
    import torch
    from repro_torch.core.masks import prefix_spec, roo_spec
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.ref import as_f32
    bf16 = torch.bfloat16
    worst = dict(b1=0.0, b4=0.0, dq=0.0, dkv=0.0)
    for i, (name, shape) in enumerate(BF16_B1_SHAPES.items()):
        x = as_bf16(attention_inputs(shape, seed=40 + i, device=device))
        if name.startswith("causal"):
            x["tc"].zero_()
        spec = roo_spec(x["hl"], x["tc"], x["n_hist"])
        for use_rab in (True, False):
            rab = x["rab"] if use_rab else None
            args = (x["n_hist"], x["hl"], x["tc"], x["max_rel"])
            before = kmod.launch_count
            got = dispatch.hstu_attention(x["q"], x["k"], x["v"], rab, spec,
                                          max_rel_pos=x["max_rel"])
            if kmod.launch_count != before + 1 or got.dtype != bf16:
                raise SystemExit(f"bf16 {name}: dispatch did not launch the "
                                 f"kernel once, or the output is not bf16")
            ops = as_f32(x["q"], x["k"], x["v"], rab)
            oracle = kmod.hstu_attention_plain(*ops, *args)
            f32_kernel = kmod.hstu_attention_cuda(*ops, *args)
            again = dispatch.hstu_attention(x["q"], x["k"], x["v"], rab,
                                            spec, max_rel_pos=x["max_rel"])
            torch.cuda.synchronize()
            err, ok = bf16_close(got, oracle)
            worst["b1"] = max(worst["b1"], err)
            bits = torch.equal(got, f32_kernel.to(bf16))
            dead = ~spec.dense(x["q"].shape[2]).any(-1)
            zero = bool(torch.all(got.transpose(1, 2)[dead] == 0))
            finite = bool(torch.isfinite(got.float()).all())
            same = torch.equal(got, again)
            print(f"[bf16 kernels] B1 {name} rab={use_rab}: max|kernel - "
                  f"fp32 oracle| = {err:.3e} ok={ok} bitwise_fp32_kernel="
                  f"{bits} masked_rows_zero={zero} finite={finite} "
                  f"repeat_bitwise={same}")
            if not (ok and bits and zero and finite and same):
                raise SystemExit(f"bf16 B1 disagrees at {name} "
                                 f"rab={use_rab}")
    for i, (name, shape) in enumerate(BF16_B4_SHAPES.items()):
        x = as_bf16(prefix_inputs(shape, seed=50 + i, device=device))
        spec = prefix_spec(x["pfx"], x["nc"], x["tc"], x["n_hist"],
                           x["n_new"])
        for use_rab in (True, False):
            rab = x["rab"] if use_rab else None
            args = (x["n_hist"], x["n_new"], x["pfx"], x["nc"], x["tc"],
                    x["scale_len"], x["max_rel"])
            before = pmod.launch_count
            got = dispatch.hstu_attention_prefix(
                x["q"], x["k"], x["v"], rab, spec, scale_len=x["scale_len"],
                max_rel_pos=x["max_rel"])
            if pmod.launch_count != before + 1 or got.dtype != bf16:
                raise SystemExit(f"bf16 prefix {name}: dispatch did not "
                                 f"launch the kernel once, or not bf16")
            ops = as_f32(x["q"], x["k"], x["v"], rab)
            oracle = pmod.hstu_attention_prefix_plain(*ops, *args)
            f32_kernel = pmod.hstu_attention_prefix_cuda(*ops, *args)
            torch.cuda.synchronize()
            err, ok = bf16_close(got, oracle)
            worst["b4"] = max(worst["b4"], err)
            bits = torch.equal(got, f32_kernel.to(bf16))
            dead = ~spec.dense(got.shape[2], x["k"].shape[2]).any(-1)
            zero = bool(torch.all(got.transpose(1, 2)[dead] == 0))
            finite = bool(torch.isfinite(got.float()).all())
            print(f"[bf16 kernels] B4 {name} rab={use_rab}: max|kernel - "
                  f"fp32 oracle| = {err:.3e} ok={ok} bitwise_fp32_kernel="
                  f"{bits} masked_rows_zero={zero} finite={finite}")
            if not (ok and bits and zero and finite):
                raise SystemExit(f"bf16 B4 disagrees at {name} "
                                 f"rab={use_rab}")
    # prefix 0 and n_new == n_hist: B4 is B1, bit for bit, in bf16 too
    x = as_bf16(attention_inputs((64, 2, 80, 32, 32, 64, 64), seed=7,
                                 device=device))
    spec = prefix_spec(torch.zeros_like(x["hl"]), x["hl"], x["tc"], 64, 64)
    b4 = dispatch.hstu_attention_prefix(x["q"], x["k"], x["v"], x["rab"],
                                        spec, scale_len=80,
                                        max_rel_pos=x["max_rel"])
    b1 = kmod.hstu_attention_cuda(x["q"], x["k"], x["v"], x["rab"], 64,
                                  x["hl"], x["tc"], x["max_rel"])
    torch.cuda.synchronize()
    print(f"[bf16 kernels] B4 prefix 0, n_new = n_hist vs B1: bitwise="
          f"{torch.equal(b4, b1)}")
    if not torch.equal(b4, b1):
        raise SystemExit("bf16 B4's full-recompute case is not B1's bits")

    for i, name in enumerate(("train B32 S80", "D64 S80", "wide D128 S160",
                              "short S17 D18/13", "causal B32 S64")):
        x = as_bf16(attention_inputs(BF16_B1_SHAPES[name], seed=60 + i,
                                     device=device))
        if name.startswith("causal"):
            x["tc"].zero_()
        g = torch.randn(x["v"].shape, generator=torch.Generator(
            device=device).manual_seed(i), device=device).to(bf16)
        spec = roo_spec(x["hl"], x["tc"], x["n_hist"])
        for use_rab in (True, False):
            leaves = [x["q"], x["k"], x["v"]] + ([x["rab"]] if use_rab
                                                 else [])
            args = [t.detach().requires_grad_(True) for t in leaves]
            rab = args[3] if use_rab else None
            before = (kmod.launch_count, bmod.dq_launch_count,
                      bmod.dkv_launch_count)
            out = dispatch.hstu_attention(args[0], args[1], args[2], rab,
                                          spec, max_rel_pos=x["max_rel"])
            grads = torch.autograd.grad(out, args, g)
            after = (kmod.launch_count, bmod.dq_launch_count,
                     bmod.dkv_launch_count)
            if tuple(a - b for a, b in zip(after, before)) != (1, 1, 1) \
                    or any(t.dtype != bf16 for t in grads):
                raise SystemExit(f"bf16 {name}: autograd did not launch B1, "
                                 f"B2 and B3 once each, or not bf16")
            rab_in = x["rab"] if use_rab else None
            lens = (x["n_hist"], x["hl"], x["tc"], x["max_rel"])
            oracle = bmod.hstu_attention_bwd_plain(
                *as_f32(x["q"], x["k"], x["v"], rab_in), *lens, g.float())
            f32_kernels = bmod.hstu_attention_bwd_cuda(
                *as_f32(x["q"], x["k"], x["v"], rab_in), *lens, g.float())
            torch.cuda.synchronize()
            errs, oks, bits = {}, [], []
            for key, got, want, f32k in zip(("dq", "dk", "dv", "drab"),
                                            grads, oracle, f32_kernels):
                errs[key], ok = bf16_close(got, want)
                oks.append(ok)
                bits.append(torch.equal(got, f32k.to(bf16)))
                which = "dq" if key in ("dq", "drab") else "dkv"
                worst[which] = max(worst[which], errs[key])
            print(f"[bf16 kernels] B2/B3 {name} rab={use_rab}: max|kernel - "
                  f"fp32 oracle| " + " ".join(f"{k} {v:.3e}"
                                              for k, v in errs.items())
                  + f" ok={all(oks)} bitwise_fp32_kernels={all(bits)}")
            if not (all(oks) and all(bits)):
                raise SystemExit(f"bf16 B2/B3 disagree at {name} "
                                 f"rab={use_rab}")
    return worst


def cuda_kernels(fn) -> list:
    """Names of the device activities (kernels, copies) of one ``fn()``,
    from a ``torch.profiler`` trace of the card."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def phase_bf16_profile(kmod, pmod, bmod, device) -> None:
    """One bf16 attention call is one launch of its bf16 kernel and nothing
    else on the card: no cast of q, k, v or the output (B1, B4; B2 + B3
    after B1 under autograd, plus drab's partial sum and its rounding to
    rab's dtype when there is a rab), counted from a profiler trace."""
    import torch
    from repro_torch.core.masks import prefix_spec, roo_spec
    from repro_torch.kernels import dispatch
    x = as_bf16(attention_inputs((64, 2, 80, 32, 32, 64, 64), seed=0,
                                 device=device))
    spec = roo_spec(x["hl"], x["tc"], x["n_hist"])
    p = as_bf16(prefix_inputs((64, 2, 64, 8, 16, 32, 32, 64, 80), seed=11,
                              device=device))
    pspec = prefix_spec(p["pfx"], p["nc"], p["tc"], p["n_hist"],
                        p["n_new"])
    g = x["v"].clone()

    def fwd():
        with torch.no_grad():
            dispatch.hstu_attention(x["q"], x["k"], x["v"], x["rab"], spec,
                                    max_rel_pos=x["max_rel"])

    def prefix():
        dispatch.hstu_attention_prefix(p["q"], p["k"], p["v"], p["rab"],
                                       pspec, scale_len=p["scale_len"],
                                       max_rel_pos=p["max_rel"])

    def train(use_rab):
        def run():
            leaves = [t.detach().requires_grad_(True)
                      for t in (x["q"], x["k"], x["v"], x["rab"])]
            out = dispatch.hstu_attention(
                *leaves[:3], leaves[3] if use_rab else None, spec,
                max_rel_pos=x["max_rel"])
            torch.autograd.grad(out, leaves[:4] if use_rab else leaves[:3],
                                g)
        return run

    fwd(), prefix(), train(True)()                      # warm-up
    cases = (("B1 forward", fwd, ("hstu_fwd_kernel",), 0),
             ("B4 forward", prefix, ("hstu_prefix_fwd_kernel",), 0),
             ("B1 + B2 + B3, no rab", train(False),
              ("hstu_fwd_kernel", "hstu_bwd_dq_kernel",
               "hstu_bwd_dkv_kernel"), 0),
             ("B1 + B2 + B3, rab", train(True),
              ("hstu_fwd_kernel", "hstu_bwd_dq_kernel",
               "hstu_bwd_dkv_kernel"), 2))
    for what, fn, kernels, n_drab in cases:
        names = cuda_kernels(fn)
        hstu = [n for n in names if "hstu_" in n]
        rest = [n for n in names if "hstu_" not in n]
        print(f"[bf16 profile] {what}: {len(names)} device activities: "
              + "; ".join(n[:90] for n in names))
        if sorted(k for n in hstu for k in kernels if k + "<" in n) \
                != sorted(kernels) or len(hstu) != len(kernels) \
                or not all("__nv_bfloat16" in n for n in hstu) \
                or len(rest) != n_drab:
            raise SystemExit(f"bf16 profile, {what}: not one bf16 launch of "
                             f"each kernel and {n_drab} drab kernels")


def phase_bf16_serve(kmod, pmod, device, card: str) -> dict:
    """bf16 hstu-gr through the serving entry points: ROOServer stateless
    and with the user-tower cache, the incremental engine on the repeat
    waves; launches, scores against CPU servers on the same params and
    incremental against stateless; requests/s."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.roo_models import gr_config
    from repro_torch.models.gr import (gr_history_repr, gr_init,
                                       gr_ranking_logits,
                                       gr_ranking_logits_from_history,
                                       gr_state_init)
    from repro_torch.serve.engine import BF16_BITS, ScoreError
    from repro_torch.serve.serving import ROOServer, ServeConfig
    from repro_torch.tree import tree_map
    bf16 = torch.bfloat16
    cfg = gr_config()
    n_layers = cfg.hstu.n_layers
    params = gr_init(torch.Generator().manual_seed(0), cfg, dtype=bf16,
                     device=device)
    cpu_params = tree_map(lambda t: t.to("cpu"), params)
    score = lambda p, b: gr_ranking_logits(p, cfg, b)
    requests = make_requests(cfg, 1000)
    serve_cfg = ServeConfig(b_ro=64, b_nro=512, hist_len=cfg.hist_len)

    def check(tag, got, reqs):
        if len(got) != len(reqs) or any(
                isinstance(s, ScoreError) or s.dtype != np.float32
                or s.shape != (r.num_impressions, cfg.n_tasks)
                or not np.isfinite(s).all() for r, s in zip(reqs, got)):
            raise SystemExit(f"bf16 {tag}: a ScoreError, or scores not "
                             f"float32, misaligned or not finite")

    def close(tag, got, want):
        diff = max(float(np.abs(a - b).max(initial=0.0))
                   for a, b in zip(got, want))
        ok = all(np.allclose(a, b, atol=BF16_SCORE_TOL, rtol=BF16_SCORE_TOL)
                 for a, b in zip(got, want))
        print(f"[bf16 serve] {tag}: max|diff| {diff:.3e} ok={ok}")
        if not ok:
            raise SystemExit(f"bf16 serve: {tag} disagree")
        return diff

    ROOServer(params, score, serve_cfg, device=device).score_requests(
        requests[:80])                                  # warm-up
    server = ROOServer(params, score, serve_cfg, device=device)
    kmod.reset_launch_count()
    pmod.reset_launch_count()
    scores, wall = serve_waves(server, [requests])
    st = server.stats
    launches = kmod.launch_count
    print(f"[bf16 serve] stateless: {len(requests)} requests in "
          f"{wall * 1e3:.1f} ms ({len(requests) / wall:.1f} requests/s), "
          f"{st.n_batches} batches, B1 launches {launches}, B4 "
          f"{pmod.launch_count}, failed batches {st.n_failed_batches}")
    check("stateless", scores, requests)
    if launches != n_layers * st.n_batches or pmod.launch_count \
            or st.n_failed_batches:
        raise SystemExit("bf16 serve: B1 launches != n_layers x batches, "
                         "B4 launched, or a batch failed")
    cpu = ROOServer(cpu_params, score, serve_cfg,
                    device="cpu").score_requests(requests[:48])
    close("card vs a CPU server, 48 requests", scores[:48], cpu)

    cached = ROOServer(
        params, score, ServeConfig(b_ro=64, b_nro=512, hist_len=cfg.hist_len,
                                   cache_user_tower=True),
        user_fn=lambda p, b: gr_history_repr(p, cfg, b),
        score_from_user=lambda p, b, u:
            gr_ranking_logits_from_history(p, cfg, b, u), device=device)
    kmod.reset_launch_count()
    first, first_s = serve_waves(cached, [requests])
    n1 = cached.stats.n_batches
    second, second_s = serve_waves(cached, [requests])
    cs = cached.stats
    full_2 = cs.n_full_cache_batches
    row = next(iter(cached.cache._data.values()))
    print(f"[bf16 serve] cache: pass 1 {len(requests) / first_s:.1f} "
          f"requests/s, pass 2 {len(requests) / second_s:.1f} requests/s, "
          f"{full_2} of {cs.n_batches - n1} pass-2 batches full-cache, B1 "
          f"launches {kmod.launch_count}; a cached row {row.dtype} "
          f"{row.nbytes} B")
    check("cache", second, requests)
    if full_2 != cs.n_batches - n1 or full_2 == 0 or cs.n_failed_batches \
            or kmod.launch_count != n_layers * cs.n_batches \
            or row.dtype != BF16_BITS:
        raise SystemExit("bf16 cache: pass 2 not all full-cache, a failed "
                         "batch, B1 launches off, or rows not bf16 bits")
    if not all(np.array_equal(a, b) for a, b in zip(first, second)):
        raise SystemExit("bf16 cache: pass 2 differs from pass 1")
    close("cache pass 1 vs stateless", first, scores)
    close("cache vs a CPU server, 48 requests", second[:48], cpu)

    inc_serve = dict(cfg=cfg, params=params, score=score)
    waves = repeat_waves(cfg)
    n_req = sum(len(w) for w in waves)
    stateless = ROOServer(params, score, serve_cfg, device=device)
    want, stateless_s = serve_waves(stateless, waves)

    def engine():
        e = incremental_engine(inc_serve, device)
        e.adapter = dataclasses.replace(
            e.adapter, init_user_state=lambda: gr_state_init(
                cfg, dtype=bf16, device=device))
        return e
    serve_waves(engine(), waves)                        # warm-up
    eng = engine()
    kmod.reset_launch_count()
    pmod.reset_launch_count()
    got, inc_s = serve_waves(eng, waves)
    ss, st = eng.state_store.stats, eng.stats
    state = next(iter(eng.state_store._data.values())).state
    state_bytes = sum(leaf.nbytes for leaf in state)
    print(f"[bf16 serve] incremental: {len(waves)} waves x {len(waves[0])} "
          f"users, {st.n_batches} batches, hits {ss.hits}, launches B4 "
          f"{pmod.launch_count} B1 {kmod.launch_count}; {n_req / inc_s:.1f} "
          f"requests/s (stateless {n_req / stateless_s:.1f}); a user's K/V "
          f"state {state_bytes} B ({state.k.dtype} k {state.k.shape})")
    for w in got:
        if isinstance(w, ScoreError):
            raise SystemExit(f"bf16 incremental: {w}")
    if ss.hits != len(waves[0]) * (len(waves) - 1) or st.n_failed_batches \
            or pmod.launch_count != n_layers * st.n_batches \
            or kmod.launch_count or state.k.dtype != BF16_BITS \
            or state.k.nbytes != 2 * state.k.size:
        raise SystemExit("bf16 incremental: hits, failed batches, launches "
                         "or the state's dtype off")
    close("incremental vs stateless (card)", got, want)
    cpu_waves = ROOServer(cpu_params, score, serve_cfg,
                          device="cpu").score_requests(waves[-1])
    close("incremental vs a CPU server, the last wave",
          got[-len(waves[-1]):], cpu_waves)
    return dict(launches=launches, b4=pmod.launch_count,
                requests_per_s=len(requests) / wall,
                cached_requests_per_s=len(requests) / second_s,
                incremental_requests_per_s=n_req / inc_s,
                stateless_waves_requests_per_s=n_req / stateless_s,
                state_bytes=state_bytes)


def phase_bf16_train(kmod, pmod, bmod, device, card: str) -> dict:
    """20 bf16 hstu-gr Trainer steps (the scenario's optimizer) through
    B1-B3: launches, each step's loss against torch-dense on the card and
    torch-chunked on the CPU on the same params and batch, steps/s."""
    import numpy as np
    import torch
    from repro_torch.models.gr import gr_init, gr_ranking_loss
    from repro_torch.tree import tree_map
    bf16 = torch.bfloat16
    setup = train_setup(device)
    cfg, steps = setup["cfg"], 20
    n_layers = cfg.hstu.n_layers
    setup["init"] = lambda: gr_init(torch.Generator().manual_seed(0), cfg,
                                    dtype=bf16, device=device)
    dense = train_setup(device, "torch-dense")["cfg"]
    cpu = train_setup("cpu", "torch-chunked")["cfg"]
    traced, plain_losses = shadowed(
        setup, lambda p, b: gr_ranking_loss(p, dense, b))
    traced, cpu_losses = shadowed(
        traced, lambda p, b: gr_ranking_loss(
            tree_map(lambda t: t.detach().cpu(), p), cpu, b.to("cpu")))
    for mod in (kmod, pmod, bmod):
        mod.reset_launch_count()
    trainer, state, losses = run_trainer(traced, device, steps)
    torch.cuda.synchronize()
    launches = dict(b1=kmod.launch_count, b2=bmod.dq_launch_count,
                    b3=bmod.dkv_launch_count, b4=pmod.launch_count)
    n_metric = sum(1 for row in trainer.history if "ne" in row)
    leaf = state["params"]["hstu"]["layers"][0]["w_uvqk"]
    print(f"[bf16 train] {steps} steps, params {leaf.dtype}: launches "
          f"B1 {launches['b1']} B2 {launches['b2']} B3 {launches['b3']} B4 "
          f"{launches['b4']}; {n_metric} NE forwards; losses "
          f"{[round(float(v), 5) for v in losses]}")
    if launches["b2"] != n_layers * steps or launches["b3"] != launches["b2"] \
            or launches["b1"] != n_layers * (steps + n_metric) \
            or launches["b4"] or leaf.dtype != bf16:
        raise SystemExit("bf16 train: launch counts are not B2 = B3 = "
                         "n_layers x steps, B1 = n_layers x (steps + NE), "
                         "or the params are not bf16")
    if int(state["step"]) != steps or len(losses) != steps \
            or not bool(torch.isfinite(losses).all()) \
            or trainer.skipped_steps:
        raise SystemExit("bf16 train: wrong step count, a skipped step or "
                         "a non-finite loss")
    for what, other in (("torch-dense on the card", plain_losses),
                        ("torch-chunked on the CPU", cpu_losses)):
        other = torch.stack(other).float().cpu()
        diff = float((losses.float() - other).abs().max())
        ok = torch.allclose(losses.float(), other, atol=0.0,
                            rtol=BF16_LOSS_RTOL)
        print(f"[bf16 train] per-step losses vs {what} on the same params "
              f"and batch: max|diff| {diff:.3e} ok={ok}")
        if not ok:
            raise SystemExit(f"bf16 train: losses disagree with {what}")
    run_trainer(setup, device, steps, halt_after_skips=0)        # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_trainer(setup, device, steps, halt_after_skips=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    req_per_batch = float(np.mean([
        int(b.request_mask().sum()) for b in setup["batches"][:steps]]))
    print(f"[bf16 train] {card}: {steps} steps in {wall * 1e3:.1f} ms "
          f"({steps / wall:.2f} steps/s, {steps * req_per_batch / wall:.1f} "
          f"requests/s)")
    return dict(launches=launches, steps_per_s=steps / wall,
                requests_per_s=steps * req_per_batch / wall)


def phase_bf16_towers(kmod, pmod, bmod, device) -> None:
    """The other user towers that reach the HSTU kernels, with bf16 params
    (their inits' ``dtype=``): roo-lsr ``userarch_hstu`` and roo-esr's
    ``"hstu"`` tower at their configs' widths, one training batch: the
    loss and its gradients (B1, B2, B3 n_layers times each) and the
    scores (B1 n_layers times more) against the CPU on the same params."""
    import torch
    from repro_torch.configs.roo_models import esr_config, lsr_config
    from repro_torch.models import lsr
    from repro_torch.models import two_tower as tt
    from repro_torch.train.loop import value_and_grad
    from repro_torch.tree import leaves, tree_map
    bf16 = torch.bfloat16
    lcfg, ecfg = lsr_config("userarch_hstu"), esr_config(True)
    cases = {"roo-lsr userarch_hstu": (lcfg, lsr.lsr_init, lsr.lsr_loss,
                                       lsr.lsr_logits_roo),
             "roo-esr hstu user tower": (ecfg, tt.two_tower_init,
                                         tt.esr_loss_roo, tt.esr_logits_roo)}
    for tag, (cfg, init, loss_fn, score_fn) in cases.items():
        params = init(torch.Generator().manual_seed(0), cfg, dtype=bf16,
                      device=device)
        n_layers = len(params["hstu"]["layers"])
        cpu_params = tree_map(lambda t: t.to("cpu"), params)
        batch = train_batches(cfg.n_items, cfg.hist_len)[0]
        for mod in (kmod, pmod, bmod):
            mod.reset_launch_count()
        loss, grads = value_and_grad(lambda p, b, g: loss_fn(p, cfg, b))(
            params, batch.to(device), None)
        with torch.no_grad():
            scores = score_fn(params, cfg, batch.to(device))
        torch.cuda.synchronize()
        got = (kmod.launch_count, bmod.dq_launch_count,
               bmod.dkv_launch_count, pmod.launch_count)
        with torch.no_grad():
            cpu_loss = loss_fn(cpu_params, cfg, batch)
            cpu_scores = score_fn(cpu_params, cfg, batch)
        d_loss = abs(float(loss) - float(cpu_loss))
        d_scores = float((scores.float().cpu() - cpu_scores.float()).abs()
                         .max())
        ok = (d_loss <= BF16_LOSS_RTOL * abs(float(cpu_loss))
              and torch.allclose(scores.float().cpu(), cpu_scores.float(),
                                 atol=BF16_SCORE_TOL, rtol=BF16_SCORE_TOL)
              and all(bool(torch.isfinite(g.float()).all())
                      for g in leaves(grads)))
        print(f"[bf16 towers] {tag}: launches B1 {got[0]} B2 {got[1]} B3 "
              f"{got[2]} B4 {got[3]}; loss {float(loss):.6f} vs CPU "
              f"{float(cpu_loss):.6f}, scores ({scores.dtype}) max|card - "
              f"CPU| {d_scores:.3e}, grads finite; ok={ok}")
        if got != (2 * n_layers, n_layers, n_layers, 0) or not ok:
            raise SystemExit(f"bf16 {tag}: launches off, or the loss, the "
                             f"scores or the gradients disagree")


def phase_bf16_times(kmod, pmod, bmod, device, card: str) -> dict:
    """bf16 and fp32 kernel times in turns at the same shapes (fp32,
    bf16, bf16, fp32), the bf16 variant beside its plain version on the
    same bf16 operands and its bound at 2-byte operands: B1 at the serving
    (B 64) and training (B 32) shapes, B4 at n_new 1, 8 and 64, B2 / B3 at
    the training shape."""
    import torch
    out = {}

    def turns(tag, f32_fn, bf16_fn, plain_fn, plain_iters, xb, bound_fn):
        f32_ms = device_ms(f32_fn, iters=200)
        ms = device_ms(bf16_fn, iters=200)
        ms_again = device_ms(bf16_fn, iters=200)
        f32_again = device_ms(f32_fn, iters=200)
        plain_ms = device_ms(plain_fn, iters=plain_iters)
        bound_ms, bound_by, n_bytes, ops = bound_fn(xb)
        print(f"[bf16 times] {card}: {tag}, device time per call: bf16 "
              f"kernel {ms:.5f} ms (again {ms_again:.5f}), fp32 kernel "
              f"{f32_ms:.5f} ms (again {f32_again:.5f}), plain torch on the "
              f"bf16 operands {plain_ms:.5f} ms; bf16 bound {bound_ms:.5f} "
              f"ms ({bound_by}: {n_bytes} B, {ops} FLOP at 3.35 TB/s / 989 "
              f"TFLOP/s); {ms / bound_ms:.1f}x the bound; library: none")
        return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, f32_ms=f32_ms)

    for key, b in (("serve", 64), ("train", 32)):
        x = attention_inputs((b, 2, 80, 32, 32, 64, 64), seed=0,
                             device=device)
        xb = as_bf16(x)
        args = lambda y: (y["q"], y["k"], y["v"], y["rab"], y["n_hist"],
                          y["hl"], y["tc"], y["max_rel"])
        out[key] = turns(
            f"hstu_attention_fwd B{b} H2 S80 D32 rab",
            lambda: kmod.hstu_attention_cuda(*args(x)),
            lambda: kmod.hstu_attention_cuda(*args(xb)),
            lambda: kmod.hstu_attention_plain(*args(xb)), 20, xb, bound)
        if key == "train":
            g = torch.randn(x["v"].shape, generator=torch.Generator(
                device=device).manual_seed(0), device=device)
            gb = g.to(torch.bfloat16)
            for which, fn in (("dq", bmod.hstu_attention_bwd_dq_cuda),
                              ("dkv", bmod.hstu_attention_bwd_dkv_cuda)):
                out[which] = turns(
                    f"hstu_attention_bwd_{which} B32 H2 S80 D32 rab",
                    lambda: fn(*args(x), g), lambda: fn(*args(xb), gb),
                    lambda: bmod.hstu_attention_bwd_plain(*args(xb), gb), 8,
                    xb, lambda y, w=which: bound_bwd(y, w))
    for n_new in (1, 8, 64):
        x = prefix_inputs((64, 2, 64, n_new, 16, 32, 32, 64, 80), seed=11,
                          device=device)
        xb = as_bf16(x)
        args = lambda y: (y["q"], y["k"], y["v"], y["rab"], y["n_hist"],
                          y["n_new"], y["pfx"], y["nc"], y["tc"],
                          y["scale_len"], y["max_rel"])
        out["b4", n_new] = turns(
            f"hstu_attention_prefix_fwd B64 H2 n_hist64 n_new{n_new} m16 "
            f"D32 rab", lambda: pmod.hstu_attention_prefix_cuda(*args(x)),
            lambda: pmod.hstu_attention_prefix_cuda(*args(xb)),
            lambda: pmod.hstu_attention_prefix_plain(*args(xb)), 8, xb,
            bound_prefix)
    return out


def phase_bf16(kmod, pmod, bmod, device, card: str, f32: dict) -> dict:
    """Phase 24: hstu-gr with bf16 params and the bf16 kernels (module
    note); ``f32`` holds the fp32 phases' rates to print beside."""
    worst = phase_bf16_kernels(kmod, pmod, bmod, device)
    phase_bf16_profile(kmod, pmod, bmod, device)
    serve = phase_bf16_serve(kmod, pmod, device, card)
    train = phase_bf16_train(kmod, pmod, bmod, device, card)
    phase_bf16_towers(kmod, pmod, bmod, device)
    times = phase_bf16_times(kmod, pmod, bmod, device, card)
    print(f"[bf16] {card}: serving {serve['requests_per_s']:.1f} requests/s "
          f"(fp32 {f32['serve']['requests_per_s']:.1f}), incremental "
          f"{serve['incremental_requests_per_s']:.1f} (fp32 "
          f"{f32['inc']['requests_per_s']:.1f}), training "
          f"{train['steps_per_s']:.2f} steps/s (fp32 "
          f"{f32['train']['steps_per_s']:.2f})")
    return dict(worst=worst, serve=serve, train=train, times=times)


# ---------------------------------------------------------------------------
# phase 25: bf16 bags and bf16 state
# ---------------------------------------------------------------------------

BF16_BAG_TOL = 2e-2           # bf16 bag models' logits, scores and losses vs
                              # the plain backends and the CPU (atol and
                              # rtol: the reference's bf16 tolerance)


@contextlib.contextmanager
def operand_dtypes(emod, dmod):
    """While the block runs, records the dtype of each B5 launch's tables,
    each B6 launch's g and each B7 launch's two operands (``seen["b5" |
    "b6" | "b7"]``): the raw wrappers, which the autograd Functions look up
    at call time, wrapped; the launch counts are the wrappers' own."""
    seen = {"b5": [], "b6": [], "b7": []}
    fwd = emod.embedding_bag_grouped_fwd_cuda
    coo = emod.embedding_bag_grouped_coo_rows_cuda
    dot = dmod.dot_interaction_cuda

    def fwd_seen(tables, *args, **kw):
        seen["b5"].append(tables[0].dtype)
        return fwd(tables, *args, **kw)

    def coo_seen(g, *args, **kw):
        seen["b6"].append(g.dtype)
        return coo(g, *args, **kw)

    def dot_seen(dense, sparse, *args, **kw):
        seen["b7"].append((dense.dtype, sparse.dtype))
        return dot(dense, sparse, *args, **kw)
    emod.embedding_bag_grouped_fwd_cuda = fwd_seen
    emod.embedding_bag_grouped_coo_rows_cuda = coo_seen
    dmod.dot_interaction_cuda = dot_seen
    try:
        yield seen
    finally:
        emod.embedding_bag_grouped_fwd_cuda = fwd
        emod.embedding_bag_grouped_coo_rows_cuda = coo
        dmod.dot_interaction_cuda = dot


def check_operand_dtypes(tag: str, seen: dict) -> None:
    """Every recorded B5 / B6 launch in bf16, every B7 launch on two fp32
    operands (a bf16 dlrm's interaction promotes, as the reference's)."""
    import torch
    bags = seen["b5"] + seen["b6"]
    print(f"[{tag}] operand dtypes: B5 {sorted(set(map(str, seen['b5'])))} "
          f"x {len(seen['b5'])}, B6 {sorted(set(map(str, seen['b6'])))} x "
          f"{len(seen['b6'])}, B7 {sorted(set(map(str, seen['b7'])))} x "
          f"{len(seen['b7'])}")
    if any(d != torch.bfloat16 for d in bags) or any(
            pair != (torch.float32, torch.float32) for pair in seen["b7"]):
        raise SystemExit(f"{tag}: a bag kernel launched on other than bf16 "
                         f"operands, or B7 on other than two fp32 ones")


def bag_close(tag: str, got, want) -> float:
    """max |got - want| of two tensors (or lists of them) in fp32; fails
    beyond BF16_BAG_TOL (atol and rtol)."""
    import torch
    pairs = list(zip(got, want)) if isinstance(got, list) else [(got, want)]
    diff = max(float((a.float() - b.float()).abs().max()) for a, b in pairs)
    ok = all(a.shape == b.shape and torch.allclose(
        a.float(), b.float(), atol=BF16_BAG_TOL, rtol=BF16_BAG_TOL)
        for a, b in pairs)
    print(f"[{tag}] max|diff| {diff:.3e} ok={ok}")
    if not ok:
        raise SystemExit(f"{tag}: disagrees beyond {BF16_BAG_TOL}")
    return diff


def phase_bf16_dlrm_score(dmod, emod, hstu_mods, device, card: str,
                          f32: dict) -> dict:
    """dlrm-mlperf scoring with bf16 tables (phase 25a): 16 batches at
    serve_p99 (128 / 512) through B5 in bf16 (one grouped launch a side)
    and B7 in fp32 (the bottom MLP's output is fp32, so the interaction
    promotes, as the reference's concatenation does); logits vs the plain
    backends on the card and, at DLRM_CPU_CAP, the CPU; the
    impression-level forward (B7 once, on fp32 operands: C10) vs ROO;
    impressions/s beside the fp32 phase's."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.models.dlrm import (dlrm_forward_impression,
                                         dlrm_forward_roo, dlrm_init)
    from repro_torch.scenario.build import synthetic_dlrm_batches
    from repro_torch.tree import tree_map
    tag, bf16 = "bf16 dlrm score", torch.bfloat16
    cfg = dlrm_config(DLRM_CAP)
    n_batches, b_ro, b_nro = 16, 128, 512
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = dlrm_init(torch.Generator(device=device).manual_seed(0), cfg,
                       dtype=bf16, device=device)
    table_bytes = sum(t.numel() * t.element_size()
                      for t in params["tables"].values())
    batches = synthetic_dlrm_batches(dlrm_spec(0, b_ro, b_nro), cfg,
                                     n_batches, device=device)
    score = lambda b: dlrm_forward_roo(params, cfg, *dlrm_roo_args(b))
    print(f"[{tag}] {dlrm_describe(cfg)}; in bf16 {table_bytes} B of tables "
          f"({table_bytes / 1e9:.2f} GB); {n_batches} batches of {b_ro} "
          f"requests / {b_nro} impressions")
    with torch.no_grad(), operand_dtypes(emod, dmod) as seen:
        score(batches[0])                                     # warm-up
        torch.cuda.synchronize()
        reset_counts((dmod, emod) + hstu_mods)
        t0 = time.perf_counter()
        logits = [score(b) for b in batches]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(b7=dmod.launch_count, b5=emod.fwd_launch_count,
                        b6=emod.coo_launch_count,
                        hstu=hstu_counts(*hstu_mods))
        print(f"[{tag}] {n_batches} ROO forwards in {wall * 1e3:.1f} ms: "
              f"{n_batches * b_nro / wall:.1f} impressions/s (fp32 phase "
              f"{f32['impressions_per_s']:.1f}); launches {launches}; logits "
              f"{logits[0].dtype}")
        if launches["b7"] != n_batches or launches["b5"] != 2 * n_batches \
                or launches["b6"] or any(launches["hstu"]):
            raise SystemExit(f"{tag}: launches are not B7 1 and B5 2 a "
                             f"forward, B1-B4 and B6 0")
        if any(x.shape != (b_nro,) or not bool(torch.isfinite(x).all())
               for x in logits):
            raise SystemExit(f"{tag}: logits of the wrong shape or not "
                             f"finite")
        with dispatch.use_dot_backend("torch"), \
                dispatch.use_emb_backend("torch"):
            plain = [score(b) for b in batches]
        torch.cuda.synchronize()
        if (dmod.launch_count, emod.fwd_launch_count) != (launches["b7"],
                                                          launches["b5"]):
            raise SystemExit(f"{tag}: the plain backends launched a kernel")
        worst = bag_close(f"{tag} kernels vs plain backends over "
                           f"{n_batches * b_nro} logits", logits, plain)

        b = batches[0]
        seg = b["seg"].long()
        before = (dmod.launch_count, emod.fwd_launch_count)
        imp = dlrm_forward_impression(
            params, cfg, b["ro_dense"][seg],
            torch.cat([b["ro_ids"][seg], b["nro_ids"]], 1),
            torch.cat([b["ro_len"][seg], b["nro_len"]], 1))
        torch.cuda.synchronize()
        grew = (dmod.launch_count - before[0],
                emod.fwd_launch_count - before[1])
        print(f"[{tag}] the impression-level forward launched B7, B5 {grew}; "
              f"B7's operands {seen['b7'][-1]}")
        if grew != (1, 1):
            raise SystemExit(f"{tag}: the impression-level forward did not "
                             f"launch B7 once and B5 once")
        bag_close(f"{tag} impression-level vs ROO logits", imp, logits[0])
    check_operand_dtypes(tag, seen)
    peak = torch.cuda.max_memory_allocated()
    del params, batches, logits, plain
    torch.cuda.empty_cache()

    # the same widths at a 2**14-row cap: the card against the CPU
    small = dlrm_config(DLRM_CPU_CAP)
    sp = dlrm_init(torch.Generator(device=device).manual_seed(0), small,
                   dtype=bf16, device=device)
    sb = synthetic_dlrm_batches(dlrm_spec(0, b_ro, b_nro), small, 2,
                                device=device)
    cpu_p = tree_map(lambda t: t.cpu(), sp)
    with torch.no_grad():
        card_l = [dlrm_forward_roo(sp, small, *dlrm_roo_args(x)) for x in sb]
        cpu_l = [dlrm_forward_roo(cpu_p, small, *dlrm_roo_args(
            batch_to(x, "cpu"))) for x in sb]
    worst = max(worst, bag_close(
        f"{tag} card vs CPU at a {DLRM_CPU_CAP}-row cap, 2 batches",
        [x.cpu() for x in card_l], cpu_l))
    print(f"[{tag}] {card}: {n_batches * b_nro / wall:.1f} impressions/s, "
          f"{n_batches * b_ro / wall:.1f} requests/s (fp32 phase "
          f"{f32['impressions_per_s']:.1f} / {f32['requests_per_s']:.1f}); "
          f"peak memory {peak / 2 ** 30:.2f} GiB")
    return dict(launches=launches, impressions_per_s=n_batches * b_nro / wall,
                peak=peak, max_abs_err=worst)


def phase_bf16_dlrm_train(dmod, emod, hstu_mods, device, card: str,
                          f32: dict, sparse: bool) -> dict:
    """dlrm-mlperf training with bf16 tables (phase 25b, and 25c on sparse
    rows): 20 steps of 2,048 / 8,192 with the scenario's mixed optimizer;
    B5 2, B6 2 and B7 1 a step, the bags in bf16 and B7 on fp32 operands;
    no skipped step; each step's loss within BF16_BAG_TOL of the plain
    backends on that step's own params; the tables bf16 at the end (on
    sparse rows after their in-place row updates, only some rows moved);
    steps/s, peak memory and a per-step breakdown beside the fp32
    phase's."""
    import torch
    from repro_torch.kernels import dispatch
    tag = f"bf16 dlrm {'sparse ' if sparse else ''}train"
    bf16 = torch.bfloat16
    cfg = dlrm_config(DLRM_CAP)
    steps, b_ro, b_nro = 20, 2048, 8192
    make = dlrm_sparse_setup if sparse else dlrm_setup
    setup = make(cfg, b_ro, b_nro, device, device, dtype=bf16)
    plain = []

    def shadow(p, b, gen):
        with dispatch.use_dot_backend("torch"), \
                dispatch.use_emb_backend("torch"):
            plain.append(setup["loss"](p, b, None).detach())
    reset_counts((dmod, emod) + hstu_mods)
    with operand_dtypes(emod, dmod) as seen:
        trainer, state, losses = run_trainer(dict(setup, shadow=shadow),
                                             device, steps)
    torch.cuda.synchronize()
    got = (dmod.launch_count, emod.fwd_launch_count,
           emod.coo_launch_count) + hstu_counts(*hstu_mods)
    print(f"[{tag}] {dlrm_describe(cfg)}; {steps} steps of {b_ro} / {b_nro}"
          f": launches B7 {got[0]} B5 {got[1]} B6 {got[2]} B1-B4 "
          f"{got[3:]}; skipped {trainer.skipped_steps}")
    if got[:3] != (steps, 2 * steps, 2 * steps) or any(got[3:]):
        raise SystemExit(f"{tag}: launches are not B7 = steps, B5 = B6 = "
                         f"2 x steps, B1-B4 0")
    if int(state["step"]) != steps or len(losses) != steps \
            or not bool(torch.isfinite(losses).all()) \
            or trainer.skipped_steps:
        raise SystemExit(f"{tag}: wrong step count, a skipped step or a "
                         f"non-finite loss")
    check_operand_dtypes(tag, seen)
    worst = bag_close(f"{tag} per-step losses vs the plain backends on the "
                       f"same params and batch", losses,
                       torch.stack(plain).cpu())
    print(f"[{tag}] losses {[round(float(v), 5) for v in losses]}")
    tables = state["params"]["tables"]
    if any(t.dtype != bf16 for t in tables.values()):
        raise SystemExit(f"{tag}: a table is no longer bf16")
    if sparse:
        # the rows of t0 the steps moved, against the rows their batches
        # name (field 0 is t0's)
        t0 = setup["init"]()["tables"]["t0"]
        named = torch.zeros(t0.shape[0], dtype=torch.bool, device=device)
        for i in range(steps):
            ids = setup["batches"][i % len(setup["batches"])]["ro_ids"]
            named[ids[:, 0].reshape(-1).long().clamp(0, t0.shape[0] - 1)
                  .to(device)] = True
        moved = (tables["t0"] != t0).any(1)
        print(f"[{tag}] rows of t0 ({t0.shape[0]} rows) moved in place: "
              f"{int(moved.sum())}, named by the steps' batches "
              f"{int(named.sum())}")
        if not bool(moved.any()) or bool((moved & ~named).any()):
            raise SystemExit(f"{tag}: the sparse steps moved no row of t0, "
                             f"or a row no batch named")
        del t0, named, moved
    del state, tables
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, state, _ = run_trainer(setup, device, steps, halt_after_skips=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    print(f"[{tag}] {card}: {steps} steps in {wall * 1e3:.1f} ms "
          f"({steps / wall:.2f} steps/s, {steps * b_nro / wall:.1f} "
          f"impressions/s; Trainer.run incl. init); peak memory "
          f"{peak / 2 ** 30:.2f} GiB; the fp32 phase {f32['steps_per_s']:.2f} "
          f"steps/s, {f32['peak'] / 2 ** 30:.2f} GiB")
    (parts,) = step_breakdown(setup, device, state, steps=10, rounds=1)
    print(f"[{tag}] {card}: breakdown (ms per step, card synchronised after "
          f"each stage): " + ", ".join(f"{k} {v:.3f}"
                                       for k, v in parts.items()))
    del state
    torch.cuda.empty_cache()
    return dict(launches=dict(b7=got[0], b5=got[1], b6=got[2]),
                steps_per_s=steps / wall, peak=peak, max_abs_err=worst,
                breakdown=parts)


def lsr_setup(device, mode: str, dtype=None):
    """roo-lsr at lsr_config width in ``mode`` for ``phase_arch_serve`` /
    ``phase_arch_train``: :func:`lsr_train_setup` plus the serving halves
    (the user-tower cache's split), ``lsr_table_ids``, and params in
    ``dtype`` (fp32 by default) made once."""
    import torch
    from repro_torch.models import lsr
    setup = lsr_train_setup(device, mode)
    cfg = setup["cfg"]
    return dict(
        setup, init=shared_init(lambda: lsr.lsr_init(
            torch.Generator().manual_seed(0), cfg,
            dtype=dtype or torch.float32, device=device)),
        sparse_ids=lambda b: lsr.lsr_table_ids(cfg, b),
        score=lambda p, b: lsr.lsr_logits_roo(p, cfg, b),
        score_shape=(cfg.n_tasks,),
        user_fn=lambda p, b: lsr.lsr_user_repr(p, cfg, b),
        score_from_user=lambda p, b, u: lsr.lsr_logits_from_user(p, cfg, b,
                                                                 u),
        describe=(f"roo-lsr mode={cfg.mode} items={cfg.n_items} "
                  f"embed_dim={cfg.embed_dim} hist={cfg.hist_len}, params "
                  f"{dtype or torch.float32}"))


def phase_bf16_bag_models(mods, device, card: str, f32: dict) -> dict:
    """roo-lsr ``userarch`` and ``baseline`` with bf16 params (phase 25d):
    the stateless server and the user-tower cache over the 1,000 requests
    (B5 = batches; pass 2 all full-cache), then 20 Trainer steps (B5 =
    steps + NE forwards, B6 = steps), then the two-tower ``"mlp"`` user
    tower (roo-esr) in bf16 for 20 steps; each against the plain backends
    on the card and the CPU at BF16_BAG_TOL, a second run bit for bit, the
    bags in bf16 and no B7."""
    import torch
    emod, dmod = mods[0], mods[4]
    bf16 = torch.bfloat16
    out = {}
    with operand_dtypes(emod, dmod) as seen:
        for mode in ("userarch", "baseline"):
            out[mode, "serve"] = phase_arch_serve(
                f"bf16 lsr {mode} serve", lsr_setup(device, mode, bf16),
                "bag", mods, device, card, cache=True, tol=BF16_BAG_TOL)
            out[mode, "train"] = phase_arch_train(
                f"bf16 lsr {mode} train",
                lambda d, m=mode: lsr_setup(d, m, bf16), "bag", mods, device,
                card, sparse=False, tol=BF16_BAG_TOL, profile=False)["dense"]
        out["mlp"] = phase_arch_train(
            "bf16 esr mlp train",
            lambda d: tt_setup(d, "esr", hstu=False, dtype=bf16), "bag",
            mods, device, card, sparse=False, tol=BF16_BAG_TOL,
            profile=False)["dense"]
    if seen["b7"] or not seen["b5"] or not seen["b6"]:
        raise SystemExit("bf16 bag models: B7 launched, or B5 / B6 did not")
    check_operand_dtypes("bf16 bag models", seen)
    print(f"[bf16 bag models] {card}: lsr userarch serving "
          f"{out['userarch', 'serve']['requests_per_s']:.1f} requests/s "
          f"(fp32 phase {f32['lsr_serve']['requests_per_s']:.1f}), training "
          f"{out['userarch', 'train']['steps_per_s']:.2f} steps/s (fp32 "
          f"{f32['lsr_train']['steps_per_s']:.2f}); baseline serving "
          f"{out['baseline', 'serve']['requests_per_s']:.1f}, training "
          f"{out['baseline', 'train']['steps_per_s']:.2f}; esr mlp training "
          f"{out['mlp']['steps_per_s']:.2f} steps/s (fp32 "
          f"{f32['esr_mlp']['steps_per_s']:.2f})")
    return out


def dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def phase_bf16_state(kmod, pmod, bmod, device, card: str) -> dict:
    """bf16 state on the card (phase 25e): a bf16 hstu-gr Trainer with a
    checkpoint every 4 steps, stopped after step 12 and restarted, against
    an uninterrupted run: losses, params, optimizer state and step bit for
    bit, params still bf16; the checkpoint's bytes beside an fp32 state's;
    ``params_to_numpy`` of the bf16 tree and back, bit for bit."""
    import shutil
    import torch
    from repro_torch.host import BF16_BITS
    from repro_torch.interop import params_from_numpy, params_to_numpy
    from repro_torch.models.gr import gr_init
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.tree import leaves
    tag, bf16, steps, kill = "bf16 state", torch.bfloat16, 20, 12
    setup = train_setup(device)
    cfg = setup["cfg"]
    n_layers = cfg.hstu.n_layers
    setup["init"] = lambda: gr_init(torch.Generator().manual_seed(0), cfg,
                                    dtype=bf16, device=device)
    ckpt_dir = ROOT / "build" / "chip_smoke_bf16_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    reset_counts((kmod, pmod, bmod))
    whole_t, whole, losses = run_trainer(setup, device, steps)
    first_t, _, first = run_trainer(setup, device, steps,
                                    ckpt_dir=str(ckpt_dir), stop_after=kill)
    mgr = CheckpointManager(str(ckpt_dir))
    saved = mgr.latest_step()
    ck_bytes = dir_bytes(mgr._path(saved))
    rest_t, resumed, rest = run_trainer(setup, device, steps,
                                        ckpt_dir=str(ckpt_dir))
    torch.cuda.synchronize()
    n_ne = sum(1 for t in (whole_t, first_t, rest_t) for row in t.history
               if "ne" in row)
    got = hstu_counts(kmod, pmod, bmod)
    n_steps = steps + kill + (steps - kill)
    print(f"[{tag}] {steps} bf16 hstu-gr steps, and {kill} + a restart from "
          f"step {saved} to {steps}: launches B1-B4 {got}; {n_ne} NE "
          f"forwards")
    if got != (n_layers * (n_steps + n_ne), n_layers * n_steps,
               n_layers * n_steps, 0) or saved != kill:
        raise SystemExit(f"{tag}: launches are not B2 = B3 = n_layers x "
                         f"steps run, B1 = n_layers x (steps + NE), B4 0, "
                         f"or the last checkpoint is not step {kill}")
    same_losses = torch.equal(torch.cat([first, rest]), losses)
    pairs = list(zip(leaves({k: resumed[k] for k in ("params", "opt",
                                                      "step")}),
                     leaves({k: whole[k] for k in ("params", "opt",
                                                   "step")})))
    same_state = all(a.dtype == b.dtype and torch.equal(
        a.view(torch.int16) if a.dtype == bf16 else a,
        b.view(torch.int16) if b.dtype == bf16 else b) for a, b in pairs)
    n_bf16 = sum(a.dtype == bf16 for a, _ in pairs)
    print(f"[{tag}] kill at step {kill} + restart vs uninterrupted: "
          f"losses bit for bit {same_losses}, params / opt / step bit for "
          f"bit {same_state} ({len(pairs)} leaves, {n_bf16} bf16)")
    if not (same_losses and same_state) or n_bf16 == 0:
        raise SystemExit(f"{tag}: the restarted bf16 run is not the "
                         f"uninterrupted run bit for bit")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    f32_params = gr_init(torch.Generator().manual_seed(0), cfg,
                         device=device)
    f32_state = {"params": f32_params, "opt": setup["opt"].init(f32_params),
                 "step": torch.zeros((), dtype=torch.int32),
                 "rng": torch.tensor(0, dtype=torch.int64)}
    CheckpointManager(str(ckpt_dir)).save(saved, f32_state)
    f32_bytes = dir_bytes(ckpt_dir / f"step_{saved:012d}")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(f"[{tag}] checkpoint of step {saved}: bf16 state {ck_bytes} B, "
          f"the fp32 state of the same model {f32_bytes} B "
          f"({ck_bytes / f32_bytes:.3f}x)")

    host = params_to_numpy(whole["params"])
    back = params_from_numpy(host, device)
    n_bits = sum(a.dtype == BF16_BITS for a in leaves(host))
    same = all(a.dtype == b.dtype and torch.equal(
        a.view(torch.int16) if a.dtype == bf16 else a,
        b.view(torch.int16) if b.dtype == bf16 else b)
        for a, b in zip(leaves(back), leaves(whole["params"])))
    print(f"[{tag}] params_to_numpy / params_from_numpy of the bf16 tree: "
          f"{n_bits} leaves as BF16_BITS, back on the card bit for bit "
          f"{same}")
    if not same or n_bits == 0:
        raise SystemExit(f"{tag}: the bf16 tree does not cross to numpy and "
                         f"back bit for bit")
    return dict(launches=dict(b1=got[0], b2=got[1], b3=got[2]),
                ckpt_bytes=ck_bytes, f32_ckpt_bytes=f32_bytes)


def bf16_bag_case(emod, tables, ids, lens, g, pooling, vocabs, grouped):
    """The calls phase_bf16_bag_times times for one case: B5 and B6 on the
    bf16 operands and on the same values in fp32, the plain versions on
    the bf16 operands, and the library calls on the bf16 tables (F
    ``F.embedding_bag`` calls; for B6 the backward of ``sparse=True``
    ones, the per-slot COO rows)."""
    import torch
    import torch.nn.functional as F
    f32 = [t.float() for t in tables]
    g32 = g.float()
    if grouped:
        fwd = lambda ts: emod.embedding_bag_grouped_fwd_cuda(ts, ids, lens,
                                                             pooling)
        coo = lambda gg: emod.embedding_bag_grouped_coo_rows_cuda(
            gg, ids, lens, vocabs, pooling)
        fwd_plain = lambda: emod.embedding_bag_grouped_plain(tables, ids,
                                                             lens, pooling)
        coo_plain = lambda: emod.embedding_bag_grouped_coo_rows_plain(
            g, ids, lens, vocabs, pooling)
        views = [(ids[:, j, :], lens[:, j], g[:, j, :].contiguous())
                 for j in range(len(tables))]
    else:
        fwd = lambda ts: emod.embedding_bag_fwd_cuda(ts[0], ids, lens,
                                                     pooling)
        coo = lambda gg: emod.embedding_bag_coo_rows_cuda(
            gg, ids, lens, vocabs[0], pooling)
        fwd_plain = lambda: emod.embedding_bag_fwd_plain(tables[0], ids,
                                                         lens, pooling)
        coo_plain = lambda: emod.embedding_bag_coo_rows_plain(
            g, ids, lens, vocabs[0], pooling)
        views = [(ids, lens, g)]
    flat, offsets = [], []
    for (i, n, _), v in zip(views, vocabs):
        n = n.clamp(0, i.shape[1])
        valid = torch.arange(i.shape[1], device=i.device)[None, :] < n[:, None]
        flat.append(i.clamp(0, v - 1)[valid].long())
        offsets.append((torch.cumsum(n, 0) - n).long())
    lib_fwd = lambda: [F.embedding_bag(fl, t, off, mode=pooling)
                       for fl, t, off in zip(flat, tables, offsets)]
    tg = [t.detach().requires_grad_(True) for t in tables]
    lib_out = [F.embedding_bag(fl, t, off, mode=pooling, sparse=True)
               for fl, t, off in zip(flat, tg, offsets)]
    lib_bwd = lambda: torch.autograd.grad(lib_out, tg,
                                          [gv for _, _, gv in views],
                                          retain_graph=True)
    return dict(fwd=lambda: fwd(tables), fwd_f32=lambda: fwd(f32),
                fwd_plain=fwd_plain, coo=lambda: coo(g),
                coo_f32=lambda: coo(g32), coo_plain=coo_plain,
                lib_fwd=lib_fwd, lib_bwd=lib_bwd, keep=(tg, lib_out))


def phase_bf16_bag_times(emod, device, card: str) -> dict:
    """B5 and B6 in bf16 (phase 25f) at dlrm-mlperf's scoring and training
    shapes (each side's 13 one-hot fields, D 128, sum, vocabs capped at
    DLRM_CAP) and at lsr's (L 64, D 64, mean, 50,000 rows, F 1) training
    B 32, serving B 64 and impression-level B 192,
    beside the fp32 kernel on the same values, the plain version and the
    library calls on the same bf16 tables, and the bound at 2-byte rows;
    max |kernel - plain| on the bf16 operands. Returns the numbers by
    (case, "fwd" | "coo")."""
    import torch
    bf16 = torch.bfloat16
    out = {}
    cases = []
    for key, shape, seed in (("lsr", "train B32 L64 D64", 60),
                             ("lsr B64", "serve B64 L64 D64", 65),
                             ("lsr B192", "impression B192 L64 D64", 66)):
        x = bag_inputs(BAG_SHAPES[shape], seed, device, dtype=bf16)
        cases.append((key, f"lsr {shape.split()[1]} L64 D64 V50000 mean",
                      [x["table"]], x["ids"], x["lens"], x["g"], "mean",
                      [x["v"]], False))
    for side in ("RO", "NRO"):
        vocabs = dlrm_side_vocabs(side.lower())
        gen = torch.Generator(device=device).manual_seed(63)
        tables = [(0.01 * torch.randn((v, 128), generator=gen,
                                      device=device)).to(bf16)
                  for v in vocabs]
        for stage, b in (("score", 128 if side == "RO" else 512),
                         ("train", 2048 if side == "RO" else 8192)):
            ids = torch.stack([torch.randint(0, v, (b, 1), generator=gen,
                                             device=device,
                                             dtype=torch.int32)
                               for v in vocabs], 1)
            lens = torch.ones((b, 13), dtype=torch.int32, device=device)
            g = torch.randn((b, 13, 128), generator=gen,
                            device=device).to(bf16)
            cases.append((f"{side} {stage}", f"dlrm {stage} {side} side B{b} "
                          f"F13 L1 D128 sum", tables, ids, lens, g, "sum",
                          vocabs, True))
    for key, label, tables, ids, lens, g, pooling, vocabs, grouped in cases:
        c = bf16_bag_case(emod, tables, ids, lens, g, pooling, vocabs,
                          grouped)
        with torch.no_grad():
            got, plain = c["fwd"](), c["fwd_plain"]()
            lib = c["lib_fwd"]()
            err_fwd = float((got.float() - plain.float()).abs().max())
            lib = torch.stack(lib, 1) if grouped else lib[0]
            err_lib = float((got.float() - lib.float()).abs().max())
            (cids, rows), (pids, prows) = c["coo"](), c["coo_plain"]()
            err_coo = float((rows.float() - prows.float()).abs().max())
        torch.cuda.synchronize()
        if got.dtype != bf16 or rows.dtype != bf16 \
                or not torch.equal(cids, pids) \
                or not all(torch.allclose(a.float(), b.float(),
                                          atol=BF16_ATOL, rtol=BF16_RTOL)
                           for a, b in ((got, plain), (got, lib),
                                        (rows, prows))):
            raise SystemExit(f"bf16 bag times {label}: B5 / B6 disagree with "
                             f"their plain versions or the library, or are "
                             f"not bf16 (B5 {err_fwd:.3e}, library "
                             f"{err_lib:.3e}, B6 rows {err_coo:.3e})")
        ms = {k: labelled_device_ms(f"{label} {k}", c[k], iters)
              for k, iters in (("fwd_plain", 6), ("fwd", 200),
                               ("fwd_f32", 200), ("lib_fwd", 10),
                               ("coo_plain", 6), ("coo", 200),
                               ("coo_f32", 200))}
        try:
            ms["lib_bwd"], how = device_ms(c["lib_bwd"], 8), "device"
        except SystemExit:
            ms["lib_bwd"], how = None, (
                f"no device time: it synchronises the host; host-issued "
                f"{call_ms(c['lib_bwd'], 8, warmup=2):.5f} ms")
        x = dict(tables=tables, ids=ids if grouped else ids[:, None, :],
                 lens=lens if grouped else lens[:, None])
        for which, name, lib_key in (("fwd", "B5", "lib_fwd"),
                                     ("coo", "B6", "lib_bwd")):
            bound_ms, bound_by, n_bytes, ops = bound_group(x, which)
            print(f"[bf16 bag times] {card}: {name} bf16 {label}, device "
                  f"time per call: kernel {ms[which]:.5f} ms, the fp32 "
                  f"kernel on the same values {ms[which + '_f32']:.5f} ms "
                  f"({ms[which] / ms[which + '_f32']:.2f}x), plain torch "
                  f"{ms[which + '_plain']:.5f} ms; bound {bound_ms:.5f} ms "
                  f"({bound_by}: {n_bytes} B at 2-byte rows, {ops} FLOP); "
                  f"library ({len(tables)} call(s)"
                  + (f", sparse backward: {how}) " if which == "coo" else ") ")
                  + ("-" if ms[lib_key] is None else f"{ms[lib_key]:.5f} ms")
                  + f"; max|kernel - plain| "
                  f"{err_fwd if which == 'fwd' else err_coo:.3e}")
            out[key, which] = dict(
                ms=ms[which], plain_ms=ms[which + "_plain"],
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=ms[lib_key], f32_ms=ms[which + "_f32"],
                max_abs_err=err_fwd if which == "fwd" else err_coo)
        del c
    torch.cuda.empty_cache()
    return out


def phase_bf16_densify(device, card: str) -> dict:
    """``SparseRows.to_dense`` on bf16 rows, route by route (phase 25): the
    one-hot float64 product (8,192 ids into 4 rows, rounded once to bf16),
    aten's embedding backward (2,048 ids into 50,000 rows) and the sorted
    ``index_put_`` (8,192 ids into 108 rows, and into a DLRM_CAP-row
    table). Two calls must give the same bits; each is printed against the
    exact sum rounded once to bf16 (an fp64 ``index_add_`` of bf16 values,
    exact at these sizes), not gated: the aten routes add in fp32."""
    import torch
    from repro_torch.embeddings.sparse import SparseRows
    bf16 = torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(64)
    out = {}
    for route, n, v in (("one-hot product", 8192, 4),
                        ("aten embedding backward", 2048, 50000),
                        ("sorted index_put_", 8192, 108),
                        ("sorted index_put_", 8192, DLRM_CAP)):
        ids = torch.randint(0, v, (n,), generator=gen, device=device,
                            dtype=torch.int32)
        rows = torch.randn((n, 128), generator=gen, device=device).to(bf16)
        a = SparseRows(ids, rows, v).to_dense()
        b = SparseRows(ids, rows, v).to_dense()
        exact = torch.zeros((v, 128), dtype=torch.float64,
                            device=device).index_add_(
            0, ids.long(), rows.double()).to(bf16)
        same = a.dtype == bf16 and torch.equal(a.view(torch.int16),
                                               b.view(torch.int16))
        off = int((a.view(torch.int16) != exact.view(torch.int16)).sum())
        worst = float((a.float() - exact.float()).abs().max())
        print(f"[bf16 densify] {card}: {route}, {n} ids into {v} rows of "
              f"128, bf16: two calls bit for bit {same}; vs the exact sum "
              f"rounded once {off} of {v * 128} elements differ, max|diff| "
              f"{worst:.3e}")
        if not same:
            raise SystemExit(f"bf16 densify: the {route} route over {v} rows "
                             f"is not bf16 or not bitwise on repeat")
        out[route, v] = dict(same=same, off=off, max_abs=worst)
        del a, b, exact
    torch.cuda.empty_cache()
    return out


def phase_bf16_bags(mods, device, card: str, f32: dict) -> dict:
    """Phase 25: the bag models with bf16 tables and bf16 state at rest
    (module note); ``f32`` holds the fp32 phases' results to print
    beside."""
    import torch
    emod, kmod, pmod, bmod, dmod = mods
    hstu_mods = (kmod, pmod, bmod)
    t0 = time.perf_counter()
    score = phase_bf16_dlrm_score(dmod, emod, hstu_mods, device, card,
                                  f32["dlrm_score"])
    train = phase_bf16_dlrm_train(dmod, emod, hstu_mods, device, card,
                                  f32["dlrm_train"], sparse=False)
    sparse = phase_bf16_dlrm_train(dmod, emod, hstu_mods, device, card,
                                   f32["dlrm_sparse"], sparse=True)
    models = phase_bf16_bag_models(mods, device, card, f32)
    state = phase_bf16_state(kmod, pmod, bmod, device, card)
    densify = phase_bf16_densify(device, card)
    times = phase_bf16_bag_times(emod, device, card)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"[bf16 bags] {card}: phase 25 in {wall:.1f} s")
    return dict(score=score, train=train, sparse=sparse, models=models,
                state=state, densify=densify, times=times, wall_s=wall)


def bf16_bag_entries(bags16, dot_times, worst_dot, bf_times,
                     bf_worst) -> list:
    """The kernels JSON line's entries for phase 25's main paths: B5 / B6
    in bf16 in dlrm (a side's launches beside that side's bf16 times),
    roo-lsr and the "mlp" tower (lsr's shape), B7 in fp32 inside bf16 dlrm
    (the fp32 times at the same shapes) and B1-B3 in bf16 in the
    kill-and-restart run (phase 24's bf16 times)."""
    times, models = bags16["times"], bags16["models"]
    bag = dict(route="cuda",
               source="src/repro_torch/kernels/csrc/embedding_bag.cu")
    kernels = (("embedding_bag_fwd_grouped", 48, "b5", "fwd"),
               ("embedding_bag_bwd_coo_grouped", 74, "b6", "coo"))
    dlrm = (("scoring", "score", bags16["score"]),
            ("training", "train", bags16["train"]),
            ("sparse training; times at the dense step's operands", "train",
             bags16["sparse"]))
    lsr = (("roo-lsr userarch serving", models["userarch", "serve"], 64),
           ("roo-lsr baseline serving", models["baseline", "serve"], 64),
           ("roo-lsr userarch training", models["userarch", "train"], 32),
           ("roo-lsr baseline training", models["baseline", "train"], 32),
           ("roo-esr mlp user tower training", models["mlp"], 32))
    out = []
    for name, line, key, which in kernels:
        replaces = f"src/repro/kernels/embedding_bag.py:{line}"
        for what, stage, run in dlrm:
            if key == "b6" and stage == "score":
                continue                   # scoring launches no B6
            for side in ("RO", "NRO"):
                # one grouped launch a side a forward / backward
                out.append(dict(
                    bag, name=f"{name} (bf16 dlrm {what}, {side} side)",
                    replaces=replaces, launches=run["launches"][key] // 2,
                    **{k: v for k, v in times[f"{side} {stage}",
                                              which].items()
                       if k != "f32_ms"}))
        for what, run, b in lsr:
            if key == "b6" and "training" not in what:
                continue
            out.append(dict(
                bag, name=f"{name} (bf16 {what}; times at lsr's B {b}, L 64, "
                          f"D 64 mean bag over 50,000 rows)",
                replaces=replaces, launches=run["launches"][key],
                **{k: v for k, v in times["lsr" if b == 32 else f"lsr B{b}",
                                          which].items()
                   if k != "f32_ms"}))
    for what, stage, run in dlrm:
        out.append(dict(
            name=f"dot_interaction_fwd (bf16 dlrm {what}: fp32 operands, as "
                 f"the reference promotes)", route="cuda",
            source="src/repro_torch/kernels/csrc/dot_interaction.cu",
            replaces="src/repro/kernels/dot_interaction.py:22",
            launches=run["launches"]["b7"], max_abs_err=worst_dot,
            **dot_times[stage]))
    for name, src, line, key, which, times_key in (
            ("hstu_attention_fwd", "hstu_attention_fwd.cu", 80, "b1", "b1",
             "train"),
            ("hstu_attention_bwd_dq", "hstu_attention_bwd.cu", 108, "b2",
             "dq", "dq"),
            ("hstu_attention_bwd_dkv", "hstu_attention_bwd.cu", 170, "b3",
             "dkv", "dkv")):
        out.append(dict(
            name=f"{name} (bf16 hstu-gr kill and restart from a bf16 "
                 f"checkpoint)", route="cuda",
            source=f"src/repro_torch/kernels/csrc/{src}",
            replaces=f"src/repro/kernels/hstu_attention.py:{line}",
            launches=bags16["state"]["launches"][key],
            max_abs_err=bf_worst[which],
            **{k: v for k, v in bf_times[times_key].items()
               if k != "f32_ms"}, library_ms=None))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs the card", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no {SRC / 'repro_torch'}; run from the repo",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products summed in f32 all the way, as the reference's dots
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    device = torch.device("cuda", 0)

    card = card_line()
    print(f"[device] {card} | {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    from repro_torch.kernels import dot_interaction as dmod
    from repro_torch.kernels import embedding_bag as emod
    from repro_torch.kernels import hstu_attention as kmod
    from repro_torch.kernels import hstu_attention_bwd as bmod
    from repro_torch.kernels import hstu_attention_prefix as pmod
    from repro_torch.kernels import segment_merge as smod
    phase_build([kmod, pmod, bmod, emod, dmod, smod])
    worst = phase_kernels(kmod, device)
    worst_esr = phase_kernels(kmod, device, ESR_B1_SHAPES)
    worst_prefix = phase_prefix_kernels(kmod, pmod, device)
    worst_bwd = phase_bwd_kernels(kmod, pmod, bmod, device)
    # B1-B3 at gr-train-long's shape, the cell's main-path attention
    gr_long = phase_gr_long_kernels(kmod, bmod, device, card)
    worst_bag = phase_bag_kernels(emod, device)
    worst_grouped = phase_grouped_bag_kernels(emod, device)
    worst_dot = phase_dot_kernels(dmod, device)
    pmod.reset_launch_count()
    emod.reset_launch_count()
    dmod.reset_launch_count()
    serve = phase_serve(kmod, device)
    if pmod.launch_count or emod.fwd_launch_count:
        raise SystemExit("the stateless hstu-gr server launched the prefix "
                         "or the bag kernel")
    inc = phase_incremental(kmod, pmod, device, serve)
    phase_cache(kmod, pmod, device, serve)
    train = phase_train(kmod, pmod, bmod, device, card)
    if emod.fwd_launch_count or emod.coo_launch_count:
        raise SystemExit("hstu-gr launched a bag kernel")
    # hstu-gr in bf16 (phase 24), beside the fp32 phases above: the bf16
    # variants of B1-B4, serving and training
    bf16 = phase_bf16(kmod, pmod, bmod, device, card,
                      dict(serve=serve, inc=inc, train=train))
    lsr_serve = phase_lsr_serve(emod, kmod, device)
    lsr_train = phase_lsr_train(emod, kmod, pmod, bmod, device, card)
    lsr_sparse = phase_lsr_sparse_train(emod, kmod, pmod, bmod, device, card,
                                        lsr_train)
    phase_lsr_hstu_train(emod, kmod, pmod, bmod, device)
    if dmod.launch_count:
        raise SystemExit("hstu-gr or roo-lsr launched the dot-interaction "
                         "kernel")
    mods = (emod, kmod, pmod, bmod, dmod)
    gr_long_launches = phase_gr_long_step(mods, smod, device)
    esr_serve = phase_arch_serve("esr serve", tt_setup(device, "esr"),
                                 "hstu", mods, device, card, cache=True)
    esr_train = phase_arch_train("esr train", lambda d: tt_setup(d, "esr"),
                                 "hstu", mods, device, card)
    esr_mlp_train = phase_arch_train(
        "esr mlp train", lambda d: tt_setup(d, "esr", hstu=False), "bag",
        mods, device, card)
    retrieval_serve = phase_arch_serve(
        "retrieval serve", tt_setup(device, "retrieval"), "hstu", mods,
        device, card)
    retrieval_train = phase_arch_train(
        "retrieval train", lambda d: tt_setup(d, "retrieval"), "hstu", mods,
        device, card)
    archs = {}
    for name in ("mind", "dien", "bert4rec"):
        archs[name] = (
            phase_arch_serve(f"{name} serve", recsys_setup(device, name),
                             "none", mods, device, card),
            phase_arch_train(f"{name} train",
                             lambda d, n=name: recsys_setup(d, n), "none",
                             mods, device, card,
                             sparse=name != "bert4rec"))
    dlrm_score = phase_dlrm_score(dmod, emod, (kmod, pmod, bmod), device,
                                  card)
    dlrm_train = phase_dlrm_train(dmod, emod, smod, (kmod, pmod, bmod),
                                  device, card)
    dlrm_sparse = phase_dlrm_sparse_train(dmod, emod, smod,
                                          (kmod, pmod, bmod), device, card,
                                          dlrm_train)
    # the bag models with bf16 tables and bf16 state at rest (phase 25),
    # beside the fp32 phases above
    bags16 = phase_bf16_bags(mods, device, card, dict(
        dlrm_score=dlrm_score, dlrm_train=dlrm_train,
        dlrm_sparse=dlrm_sparse, lsr_serve=lsr_serve, lsr_train=lsr_train,
        esr_mlp=esr_mlp_train["dense"]))
    times = phase_times(kmod, device, card)
    ptimes = phase_prefix_times(pmod, device, card)
    btimes = phase_bwd_times(bmod, device, card)
    bag_times = phase_bag_times(emod, device, card)
    phase_dlrm_bag_times(emod, device, card)
    grouped_times = phase_grouped_bag_times(emod, device, card)
    dot_times = phase_dot_times(dmod, device, card)
    phase_densify_times(device, card)
    merge_times = phase_segment_merge(smod, device, card)
    sparse_bag_times = phase_sparse_bag_times(emod, device, card,
                                              dlrm_sparse["groups"])
    tt_bag_times = phase_tt_bag(emod, device, card)
    # the scenario layer's entry points (each run's counts reset before it)
    scen_train = phase_scenario_train(mods, device, card)
    scen_serve = phase_scenario_serve(mods, device, card, scen_train)
    phase_launcher(card)
    obs_rates = phase_obs(mods, device, card)
    phase_faults(mods, device, card)
    disk = phase_disk(mods, device, card)
    scen_times = phase_scenario_times(emod, dmod, device, card, scen_train)
    spmd_run = phase_spmd(mods, device, card)
    # the LM and MACE families, and kernels/ops.py's routes
    lm = phase_lm(mods, device, card)
    mace_run = phase_mace(mods, device, card)
    phase_lm_smoke(mods, device, card)
    ops_run = phase_ops(mods, device, card)
    # the dry-run cells (A10b): the meta analysis and the card against it
    dry = phase_dryrun(mods, device, card)
    # the examples on the card (A12 and the examples)
    examples = phase_examples(mods, device, card)
    print(f"[serve] {card}: {serve['requests_per_s']:.1f} requests/s")
    print(f"[incremental] {card}: repeat traffic {inc['requests_per_s']:.1f} "
          f"requests/s incremental, {inc['stateless_requests_per_s']:.1f} "
          f"stateless")
    print(f"[train] {card}: {train['steps_per_s']:.2f} steps/s, "
          f"{train['requests_per_s']:.1f} requests/s")
    print(f"[lsr serve] {card}: {lsr_serve['requests_per_s']:.1f} "
          f"requests/s stateless, {lsr_serve['cached_requests_per_s']:.1f} "
          f"with the user-tower cache (second pass)")
    print(f"[lsr train] {card}: {lsr_train['steps_per_s']:.2f} steps/s, "
          f"{lsr_train['requests_per_s']:.1f} requests/s")
    print(f"[dlrm score] {card}: {dlrm_score['impressions_per_s']:.1f} "
          f"impressions/s, {dlrm_score['requests_per_s']:.1f} requests/s")
    print(f"[dlrm train] {card}: {dlrm_train['steps_per_s']:.2f} steps/s, "
          f"{dlrm_train['impressions_per_s']:.1f} impressions/s")
    print(f"[lsr sparse train] {card}: {lsr_sparse['steps_per_s']:.2f} "
          f"steps/s, {lsr_sparse['requests_per_s']:.1f} requests/s")
    print(f"[dlrm sparse train] {card}: {dlrm_sparse['steps_per_s']:.2f} "
          f"steps/s, {dlrm_sparse['impressions_per_s']:.1f} impressions/s; "
          f"peak memory {dlrm_sparse['peak'] / 2 ** 30:.2f} GiB over the "
          f"steps, {dlrm_sparse['init_peak'] / 2 ** 30:.2f} GiB during "
          f"Trainer.init_state (dense {dlrm_train['peak'] / 2 ** 30:.2f})")
    for tag, srv in (("esr serve", esr_serve),
                     ("retrieval serve", retrieval_serve)) + tuple(
            (f"{n} serve", a[0]) for n, a in archs.items()):
        print(f"[{tag}] {card}: {srv['requests_per_s']:.1f} requests/s "
              f"stateless" + (f", {srv['cached_requests_per_s']:.1f} with "
                              f"the user-tower cache (second pass)"
                              if "cached_requests_per_s" in srv else ""))
    for tag, run in (("esr train", esr_train),
                     ("esr mlp train", esr_mlp_train),
                     ("retrieval train", retrieval_train)) + tuple(
            (f"{n} train", a[1]) for n, a in archs.items()):
        print(f"[{tag}] {card}: " + "; ".join(
            f"{mode} {r['steps_per_s']:.2f} steps/s, "
            f"{r['requests_per_s']:.1f} requests/s"
            + (f", {busy_text(r['busy'])}" if "busy" in r else "")
            for mode, r in run.items()))

    for (arch, variant), run in scen_train.items():
        srv = scen_serve.get((arch, variant), {})
        print(f"[scenario {arch}{' ' + variant if variant else ''}] {card}: "
              f"training {run['steps_per_s']:.2f} steps/s"
              + "".join(f", {what} {srv[key]:.1f} requests/s"
                        for what, key in (
                            ("serving", "requests_per_s"),
                            ("cache pass 2", "cached_requests_per_s"),
                            ("incremental", "incremental_requests_per_s"))
                        if key in srv))
    print(f"[obs] {card}: hstu-gr serving requests/s by obs mode "
          + ", ".join(f"{m} " + " / ".join(f"{r:.1f}" for r in v)
                      for m, v in obs_rates.items()))
    for (arch, variant), run in disk["rates"].items():
        print(f"[disk {arch}{' ' + variant if variant else ''}] {card}: "
              f"training steps/s " + ", ".join(
                  f"{how} " + " / ".join(f"{r:.2f}" for r in v)
                  for how, v in run["rates"].items()))

    for arch, run in lm.items():
        print(f"[lm {arch}] {card}: training {run['steps_per_s']:.3f} "
              f"steps/s, {run['tokens_per_s']:.1f} tokens/s, "
              f"{100 * run['mfu']:.2f} % of the dense bf16 peak, peak "
              f"memory {gib(run['peak'])}; decode "
              f"{run['decode_tokens_per_s']:.1f} tokens/s")
    print(f"[mace molecule] {card}: training "
          f"{mace_run['steps_per_s']:.2f} steps/s")
    print(f"[dryrun] {card}: {dry['wall']:.1f} s for the 120 meta analyses; "
          + ", ".join(f"{a}/{s} step {1e3 * min(r['step_s']):.3f} ms vs "
                      f"roofline {1e3 * r['roof']:.3f} ms"
                      for (a, s), r in dry["runs"].items()))

    ex_runs = examples["runs"]
    print(f"[examples] {card}: " + ", ".join(
        f"{name} {run['wall_s']:.1f} s" for name, run in ex_runs.items())
        + f"; phase 23 {examples['wall_s']:.1f} s")

    gr_train = scen_train["hstu-gr", None]["launches"]
    scen_dlrm = scen_train["dlrm-mlperf", None]["launches"]
    disk_gr = disk["hstu-gr", None]["launches"]
    disk_lsr = disk["roo-lsr", "userarch"]["launches"]
    bf_run, bf_times, bf_worst = bf16["serve"], bf16["times"], bf16["worst"]
    bf_train = bf16["train"]["launches"]
    print(json.dumps({"kernels": [{
        "name": "hstu_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hstu_attention_fwd.cu",
        "replaces": "src/repro/kernels/hstu_attention.py:80",
        "launches": serve["launches"], "max_abs_err": worst,
        **times["serve"], "library_ms": None}, {
        "name": "hstu_attention_fwd (roo-esr serving: causal user tower)",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hstu_attention_fwd.cu",
        "replaces": "src/repro/kernels/hstu_attention.py:80",
        "launches": esr_serve["launches"]["b1"], "max_abs_err": worst_esr,
        **times["esr serve"], "library_ms": None}, {
        "name": "hstu_attention_prefix_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hstu_attention_prefix_fwd.cu",
        "replaces": "src/repro/kernels/hstu_attention.py:392",
        "launches": inc["launches"], "max_abs_err": worst_prefix,
        "ms": ptimes["ms"], "plain_ms": ptimes["plain_ms"],
        "bound_ms": ptimes["bound_ms"], "bound_by": ptimes["bound_by"],
        "library_ms": None}] + [{
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hstu_attention_bwd.cu",
        "replaces": f"src/repro/kernels/hstu_attention.py:{line}",
        "launches": train["launches"][key], "max_abs_err": worst_bwd[which],
        **btimes[which], "library_ms": None}
        for name, line, key, which in (
            ("hstu_attention_bwd_dq", 108, "b2", "dq"),
            ("hstu_attention_bwd_dkv", 170, "b3", "dkv"))] + [{
        "name": f"{name} (roo-esr training: causal user tower)",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hstu_attention_bwd.cu",
        "replaces": f"src/repro/kernels/hstu_attention.py:{line}",
        "launches": esr_train["dense"]["launches"][key],
        "max_abs_err": worst_bwd[which], **btimes[True, which],
        "library_ms": None}
        for name, line, key, which in (
            ("hstu_attention_bwd_dq", 108, "b2", "dq"),
            ("hstu_attention_bwd_dkv", 170, "b3", "dkv"))] + [{
        "name": f"{name} (roo-esr mlp user tower, {mode}: {table})",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
        "replaces": f"src/repro/kernels/embedding_bag.py:{line}",
        "launches": esr_mlp_train[mode]["launches"][key],
        **tt_bag_times[table, which]}
        for name, line, key, which in (
            ("embedding_bag_fwd_grouped", 48, "b5", "fwd"),
            ("embedding_bag_bwd_coo_grouped", 74, "b6", "coo"))
        for mode, table in (("dense", "dense table"),
                            ("sparse", "gathered rows"))] + [{
        "name": f"{name} (dlrm training, {side} side)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
        "replaces": f"src/repro/kernels/embedding_bag.py:{line}",
        "launches": launches // 2,
        "max_abs_err": max(worst_bag[which], worst_grouped[which]),
        **grouped_times[side, which]}
        # dlrm training launches each grouped kernel once a side a step
        # (phase_dlrm_train asserts B5 = B6 = 2 x steps): half the count
        # a side, beside that side's times
        for name, line, launches, which in (
            ("embedding_bag_fwd_grouped", 48,
             dlrm_train["bag_launches"][0], "fwd"),
            ("embedding_bag_bwd_coo_grouped", 74,
             dlrm_train["bag_launches"][1], "coo"))
        for side in ("RO", "NRO")] + [{
        "name": f"{name} (dlrm sparse training, {side} side: gathered rows)",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
        "replaces": f"src/repro/kernels/embedding_bag.py:{line}",
        "launches": launches // 2, **sparse_bag_times[side, which]}
        # the sparse dlrm step also launches each grouped kernel once a side
        for name, line, launches, which in (
            ("embedding_bag_fwd_grouped", 48,
             dlrm_sparse["bag_launches"][0], "fwd"),
            ("embedding_bag_bwd_coo_grouped", 74,
             dlrm_sparse["bag_launches"][1], "coo"))
        for side in ("RO", "NRO")] + [{
        "name": f"dot_interaction_fwd (dlrm {what})", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dot_interaction.cu",
        "replaces": "src/repro/kernels/dot_interaction.py:22",
        "launches": run["launches"], "max_abs_err": worst_dot,
        **dot_times[key]}
        for what, key, run in (("scoring", "score", dlrm_score),
                               ("training", "train", dlrm_train),
                               ("sparse training", "train", dlrm_sparse))]
        + [{
        "name": "hstu_attention_fwd (scenario hstu-gr training)",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hstu_attention_fwd.cu",
        "replaces": "src/repro/kernels/hstu_attention.py:80",
        "launches": gr_train["b1"], "max_abs_err": worst,
        **times["train"], "library_ms": None}] + [{
        "name": f"{name} (scenario hstu-gr training)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hstu_attention_bwd.cu",
        "replaces": f"src/repro/kernels/hstu_attention.py:{line}",
        "launches": gr_train[key], "max_abs_err": worst_bwd[which],
        **btimes[which], "library_ms": None}
        for name, line, key, which in (
            ("hstu_attention_bwd_dq", 108, "b2", "dq"),
            ("hstu_attention_bwd_dkv", 170, "b3", "dkv"))] + [{
        "name": "hstu_attention_prefix_fwd (scenario hstu-gr incremental "
                "serving; times at n_new 8)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hstu_attention_prefix_fwd.cu",
        "replaces": "src/repro/kernels/hstu_attention.py:392",
        "launches": scen_serve["hstu-gr", None]["b4"],
        "max_abs_err": worst_prefix, "ms": ptimes["ms"],
        "plain_ms": ptimes["plain_ms"], "bound_ms": ptimes["bound_ms"],
        "bound_by": ptimes["bound_by"], "library_ms": None}] + [{
        "name": f"{name} (scenario dlrm-mlperf training, {side} side)",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
        "replaces": f"src/repro/kernels/embedding_bag.py:{line}",
        "launches": scen_dlrm[key] // 2, **scen_times[side, which]}
        # one grouped launch a side a forward / backward
        for name, line, key, which in (
            ("embedding_bag_fwd_grouped", 48, "b5", "fwd"),
            ("embedding_bag_bwd_coo_grouped", 74, "b6", "coo"))
        for side in ("RO", "NRO")] + [{
        "name": "dot_interaction_fwd (scenario dlrm-mlperf training)",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dot_interaction.cu",
        "replaces": "src/repro/kernels/dot_interaction.py:22",
        "launches": scen_dlrm["b7"], **scen_times["dot"]}] + [{
        "name": "hstu_attention_fwd (hstu-gr training from disk shards)",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hstu_attention_fwd.cu",
        "replaces": "src/repro/kernels/hstu_attention.py:80",
        "launches": disk_gr["b1"], "max_abs_err": worst,
        **times["train"], "library_ms": None}] + [{
        "name": f"{name} (hstu-gr training from disk shards)",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hstu_attention_bwd.cu",
        "replaces": f"src/repro/kernels/hstu_attention.py:{line}",
        "launches": disk_gr[key], "max_abs_err": worst_bwd[which],
        **btimes[which], "library_ms": None}
        for name, line, key, which in (
            ("hstu_attention_bwd_dq", 108, "b2", "dq"),
            ("hstu_attention_bwd_dkv", 170, "b3", "dkv"))] + [{
        "name": f"{name} (roo-lsr userarch training from disk shards)",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
        "replaces": f"src/repro/kernels/embedding_bag.py:{line}",
        "launches": disk_lsr[key], "max_abs_err": worst_bag[which],
        **bag_times[which]}
        for name, line, key, which in (
            ("embedding_bag_fwd_grouped", 48, "b5", "fwd"),
            ("embedding_bag_bwd_coo_grouped", 74, "b6", "coo"))] + [{
        "name": "hstu_attention_fwd (hstu-gr training under a 1x1 NCCL "
                "mesh)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hstu_attention_fwd.cu",
        "replaces": "src/repro/kernels/hstu_attention.py:80",
        "launches": spmd_run["mesh_counts"]["b1"], "max_abs_err": worst,
        **times["train"], "library_ms": None}] + [{
        "name": f"{name} (hstu-gr training under a 1x1 NCCL mesh)",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hstu_attention_bwd.cu",
        "replaces": f"src/repro/kernels/hstu_attention.py:{line}",
        "launches": spmd_run["mesh_counts"][key],
        "max_abs_err": worst_bwd[which], **btimes[which], "library_ms": None}
        for name, line, key, which in (
            ("hstu_attention_bwd_dq", 108, "b2", "dq"),
            ("hstu_attention_bwd_dkv", 170, "b3", "dkv"))] + [{
        "name": "dot_interaction_fwd (dlrm scoring under a 1x2 plan: one "
                "model rank's D-64 slice)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dot_interaction.cu",
        "replaces": "src/repro/kernels/dot_interaction.py:22",
        "launches": spmd_run["dlrm_b7"],
        **spmd_run["times"]["slice"]}] + [{
        "name": f"{name} (kernels/ops.py use_pallas='always', {what})",
        "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{src}",
        "replaces": f"src/repro/kernels/{ref}", **ops_run[key]}
        for key, name, src, ref, what in (
            ("b1", "hstu_attention_fwd", "hstu_attention_fwd.cu",
             "hstu_attention.py:80", "hstu-gr serving shape"),
            ("b5", "embedding_bag_fwd_grouped", "embedding_bag.cu",
             "embedding_bag.py:48", "a dlrm scoring field"),
            ("b7", "dot_interaction_fwd", "dot_interaction.cu",
             "dot_interaction.py:22", "dlrm scoring shape"))] + [{
        "name": f"{kname} (examples/{name}.py)", "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{src}",
        "replaces": f"src/repro/kernels/hstu_attention.py:{line}",
        "launches": ex_runs[name]["launches"][key],
        **examples["times"][name][key]}
        for name in examples["times"]
        for key, kname, src, line in (
            ("b1", "hstu_attention_fwd", "hstu_attention_fwd.cu", 80),
            ("b2", "hstu_attention_bwd_dq", "hstu_attention_bwd.cu", 108),
            ("b3", "hstu_attention_bwd_dkv", "hstu_attention_bwd.cu", 170))
        if key in examples["times"][name]] + [{
        "name": f"hstu_attention_fwd (bf16 hstu-gr {what})", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hstu_attention_fwd.cu",
        "replaces": "src/repro/kernels/hstu_attention.py:80",
        "launches": launches, "max_abs_err": bf_worst["b1"],
        **{k: v for k, v in bf_times[key].items() if k != "f32_ms"},
        "library_ms": None}
        for what, key, launches in (("serving", "serve", bf_run["launches"]),
                                    ("training", "train", bf_train["b1"]))]
        + [{
        "name": "hstu_attention_prefix_fwd (bf16 hstu-gr incremental "
                "serving; times at n_new 8)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hstu_attention_prefix_fwd.cu",
        "replaces": "src/repro/kernels/hstu_attention.py:392",
        "launches": bf_run["b4"], "max_abs_err": bf_worst["b4"],
        **{k: v for k, v in bf_times["b4", 8].items() if k != "f32_ms"},
        "library_ms": None}] + [{
        "name": f"{name} (bf16 hstu-gr training)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hstu_attention_bwd.cu",
        "replaces": f"src/repro/kernels/hstu_attention.py:{line}",
        "launches": bf_train[key], "max_abs_err": bf_worst[which],
        **{k: v for k, v in bf_times[which].items() if k != "f32_ms"},
        "library_ms": None}
        for name, line, key, which in (
            ("hstu_attention_bwd_dq", 108, "b2", "dq"),
            ("hstu_attention_bwd_dkv", 170, "b3", "dkv"))]
        + bf16_bag_entries(bags16, dot_times, worst_dot, bf_times,
                           bf_worst) + [{
        "name": f"segment_merge ({label}, {law} ids)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/segment_merge.cu",
        "replaces": None, "launches": dlrm_sparse["merges"],
        **merge_times[label, law]}
        # the cell's merges are the sparse dlrm path's: its 20 steps'
        # launches (phase_dlrm_sparse_train asserts dlrm_merges a step)
        for label, _, _ in MERGE_SHAPES for law in MERGE_LAWS]
        + gr_long_entries(gr_long, gr_long_launches)}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
