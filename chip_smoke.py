"""End-to-end check of paddle_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero
before the result lines:

1. device: CUDA device name, count and ``nvidia-smi`` name/power limit
   (no CUDA device: exit 2);
2. build: every ``paddle_tpu_torch/csrc/*.cu`` compiled by nvcc, all in
   parallel, with the compiler's register and spill report; a spill in
   any kernel on the shared wgmma forward mainloop (the flash forward,
   the window kernels' chunk regime), on the int8 verify code ring or in
   the int8 matmul (both regimes) fails the phase;
3. kernels: each serving kernel against its plain PyTorch version on the
   card at the serving path's shapes (bf16 queries; int8 caches made by
   ``quantize_kv``, the plain version fed the same codes), with the
   stated tolerance, then timed (CUDA events) beside the plain version,
   one PyTorch library call computing the same function (a yardstick the
   port never calls) and the least time the card could take.  The flash
   forward at prefill buckets, ragged S across its 128-row tile, GQA,
   D=64, fp16, key masks (one row left with no key: exact zeros) and the
   training shape, each call twice (bitwise equal), timed at B=1 and B=4
   (S=2048) in turns with SDPA.  Dense
   decode (bf16 and int8) and paged decode (bf16 and int8) also at GQA,
   G = 16, D=64, length 0 or 1, exact block multiples, null-block tails,
   shuffled blocks and an inactive slot.  The four window kernels
   (dense and paged, bf16 and int8) at the verify window (W=5, lengths
   0, 1, 63-65 and S - W, B=1 and B=8), a 512-token chunk, W x G of 20
   and 1024, G = 16, D=64 (fp16 q too) and blocks of 16, 48 and 128,
   each call twice (bitwise equal), timed in turns with SDPA at the
   verify shape (B=8 and B=1) and the chunk shape.  The int8 matmul at M in {8, 512, 4096}
   over gpt3-1.3b's four projections and at edge widths (K, N) of (128,
   128), (8192, 2048), (256, 384) at M in {8, 512} (its f32, bf16 and
   fp16 outputs must EQUAL the plain version's: exact int32 sums, the
   same f32 rescale; the regime and split of each shape printed), timed beside
   ``torch._int_mm`` + rescale (at M=8 on codes padded to 32 rows); the
   decode megakernel in its four instantiations (dense and paged, bf16
   and int8 caches) at gpt3-1.3b widths, B=8, with edge lengths, G = 16,
   D=64 and blocks of 16, timed at 8 x 2048 beside the port's composed
   layer step, with each product's split over the SMs printed.  The int8
   matmul is timed on the device clock (torch.profiler), the megakernel
   from CUDA-graph replays, the host's launch gaps outlasting both.
   kernels-f8: the e4m3 forms (rows 5f, 7f, 8bf, 9bf at the int8 rows'
   cases and timing shapes, TOL_OUT per row, library SDPA over the
   dequantized bf16 cache; row 10f at the twelve gpt3-1.3b shapes and the
   edge widths, within TOL_QMM_F8 of each row's max |y|, its 16-bit
   outputs its f32 output rounded, two calls and a CUDA-graph replay at
   M = 8 and 512 bitwise equal to eager, timed beside
   ``torch._scaled_mm`` with row and column scales);
4. train-kernels: the flash backward kernels (dq, dk/dv) the same way at
   the training shape (B=4, S=2048, H=16, D=128, causal), ragged S, GQA
   (G = 16 at S=2048), D=64, fp16 and a key mask with a fully masked
   row, each run twice (results must be bitwise equal), with the delta
   the dq kernel writes against the plain delta; each kernel timed, and
   the whole backward call in turns with the library's backward; the
   fused cross-entropy at the training shape against full f32 logits,
   and its time; dropout-kernels: ``csrc/philox.cuh``'s Philox4x32-10
   words against ``curand_Philox4x32_10`` and ``ops/_philox.py``, the
   keep bits of whole calls dumped by ``csrc/philox_check.cu`` against
   the plain ``keep_mask``; rows 1-3's dropout forms at p = DROP_P
   against their plain versions on the same (seed, offset) pair at the
   training shape (bf16, fp16) and edge shapes (ragged S, key masks, GQA,
   G = 16, D=64) at the rows' tolerances, each twice (bitwise equal);
   every kernel's keep bits read out exactly (one-hot operands, q = 0)
   and equal to the plain bits; each form timed at the training shape in
   turns with its p = 0 kernel, beside its plain version and SDPA with
   ``dropout_p``;
5. serve: gpt3-1.3b in bf16 (random weights from a seed, full width and
   depth) behind ``InferenceEngine(batch_slots=8)``, 16 requests of 32
   new tokens; checks token counts, finite cache contents, one host sync
   per decode step, and that every prefill/decode layer launched the
   kernels (launch counts reset just before each serve run, read just
   after);
6. serve-paged: the same model behind ``kv_layout='paged'``
   (``kv_block_size=128``, radix prefix cache), 16 requests of 32 new
   tokens, 8 of them sharing one 1024-token prefix: prefix hits, launches
   of the paged kernel per decode step and of the flash kernel per cold
   prefill, one host sync per decode step, a leak-free pool after the
   prefix flush;
7. serve-pressure: 8 slots over a 40-block pool, prompts of about 1000
   tokens and 64 new tokens, so decode needs a ninth block while the
   pool is dry: preemptions, every request complete, leak-free;
8. serve-int8: the dense and the paged engine with ``kv_dtype='int8'``
   (launches of the int8 kernels, host syncs, cache bytes);
9. serve-chunked: ``prefill_chunk=512`` on the dense bf16 engine (the
   serve prompts) and the paged int8 engine with the radix cache (the
   serve-paged prompts): one host sync per decode step and none per
   chunk tick but a graduating one, one window launch per layer per
   chunk tick, leak-free, greedy streams against the monolithic engine
   (a divergence must sit at a near-tie of the plain engine's logits);
10. serve-spec: ``spec_k=4`` behind dense int8, paged bf16 and paged
   int8 targets with a gpt3-125m draft (random weights) and a dense bf16
   target
   drafting for itself, 8 prompts of 32-1024 tokens, 64 new tokens: one
   host sync per tick, the verify and catch-up window launches per
   tick, K+1 tokens a tick for the self-draft, greedy streams against
   the plain engine;
11. teacher-forced: prefill + decode steps reproduce ``model.forward``
   over the same tokens within the stated tolerance, on the dense cache,
   the paged cache cold and over a cached prefix (hit path), and the
   int8 and fp8 dense and paged caches (fp8 within TOL_TEACHER_FP8);
   chunked prefill (dense and paged) and a K+1 verify window (against the
   forward and 5 decode steps) the same way; the hit prefill timed
   against the cold one;
12. serve-mega: ``enable_decode_megakernel()`` on the dense and paged,
   bf16 and int8 engines, each beside its composed engine: one
   megakernel launch per layer per decode step and no decode attention
   launch, one host sync per decode step, leak-free pools, greedy streams
   against the composed engine's; serve-quant: ``enable_quantize('int8')``
   beside the bf16 engine: four int8 matmul launches per layer per
   prefill and decode step, tokens/s and greedy agreement with bf16;
   teacher-forced megakernel steps (dense, paged, bf16, int8) and the
   int8-compute model against its own forward; serve-fp8:
   ``kv_dtype='fp8'`` on the dense engine (beside the dense int8 engine:
   tokens/s, equal cache bytes), the paged one with prefix hits, chunked
   (512, paged) and speculative (K = 4, a gpt3-125m draft) engines
   against the plain fp8 engines' greedy streams, and the megakernel
   asked for (the composed step: row 11 launches 0 times), each with the
   e4m3 kernels' launches only and one host sync a decode step or tick;
   serve-quant-fp8: ``enable_quantize('fp8')`` over fp8 caches, dense
   and paged (row 10f four times a layer a step), tokens/s beside
   serve-quant's int8 compute and bf16;
13. serve-lifecycle: a dense bf16 engine after ``warmup`` over its
   prompts' buckets: a 2 s deadline cuts a 10 000-token request, two
   ``deadline_s=0.0`` requests queued behind 8 busy slots come back
   empty, the rest whole; ``drain()`` after two steps (in-flight slots
   finish, the queue comes back in FIFO order); SIGTERM under a
   ``PreemptionGuard`` (``run()`` returns, the never-admitted requests
   in ``undelivered``); ``drain(timeout_s=0.0)`` force-retires live
   slots; each part one host read per decode step and admission and
   launches as in serve; serve-loadtest: ``run_loadtest`` (open-loop
   Poisson arrivals) on warmed engines, each window's report (tokens/s,
   offered and achieved rps, TTFT and ITL p50/p99, occupancy, prefix
   hit rate, preemptions, timed-out requests) printed beside the card's
   name and power limit: A paged bf16 with the prefix cache, 32
   requests at 2 rps (all tokens, no timeout, prefix hits, leak-free
   after ``drain()``), B the same engine, 16 requests at 200 rps with
   ``deadline_s=0.0`` (all time out empty), C 16 requests without a
   shared prefix at 2 rps on a dense engine with ``prefill_chunk=512``
   beside a monolithic one (ITL p99 of both, no prefill stall when
   chunked); serve-disagg: ``DisaggServingEngine`` (8 slots, blocks of
   128, prefix cache) on serve-paged's prompts with 32 new tokens, bf16,
   int8, and int8 with ``spec_k=4`` and a gpt3-125m draft, each against
   its non-disaggregated engine (greedy streams, every request one
   worker prefill and one handoff, the decode engine's own prefill never
   timed, one host read a decode step or spec tick and admission,
   prefix hits, leak-free after ``drain()``, launches by layer and
   step); serve-fleet: two paged bf16 replicas (8 slots, blocks of 128,
   seeds 21 and 22) behind ``Router``, ``MultiTenantWorkload(seed=5, 8
   tenants, skew 1.2, 512-token prefixes)``, ``warm_fleet``, then
   ``run_fleet_loadtest`` windows (FLEET_WINDOW, 12, requests at 2 rps
   under ``prefix``, 6 through the RPC shim, 12 under ``round_robin``
   on fresh replicas; every planned token, no timeout, router hits under
   ``prefix``, launches exact under the replicas' driver threads, both
   pools leak-free after ``Router.drain()``), each window's report with
   its fleet columns beside the card's name and power limit;
   serve-telemetry: the dense and the paged bf16 engine after
   ``warmup()``, serve's 16 prompts with 32 greedy new tokens, telemetry
   off and then on (tracer, metrics, flight recorder, a 120 s watchdog,
   ``PADDLE_TPU_PROFILE=8:12``), each run under a capture over decode
   ticks 8-11: the same streams, host reads, ``host_sync_count()`` delta
   and blocking CUDA calls per tick on and off, the request tracks, the
   layout's decode kernel by name in the capture, the registry against
   ``stats()``, the ledger against the tensors' bytes, a forced
   flight-recorder bundle; tokens/s on and off in turns;
   warmup-check: a child process (``--warmup-check``) builds
   gpt3-1.3b at 2 layers, warms a dense and a paged engine and serves 8
   requests through each with the tracer, metrics and watchdog armed: no
   CUDA library may load or build after the warmups;
14. profile: device time against wall time of steady decode steps
   (torch.profiler), the top kernels by device time, for the dense bf16
   engine, a chunked step, a spec tick and a megakernel decode step
   (dense bf16; the other cache forms and int8 compute were cut to keep
   the script within its budget);
15. train-parity: gpt3-1.3b width at 2 layers, f32 masters with bf16 AMP,
   one 2 x 512 batch through ``SpmdTrainer``: every parameter gradient
   of the kernel path against the same step with the plain attention
   swapped in by this script; train-qat: one such step with
   ``strategy.qat`` (the int8 matmul under autograd, finite gradients);
   train-qat-fp8: ``qat_configs={'quantize': 'fp8'}``, one such step
   against the same step with row 10f's plain version swapped in
   (gradients within TOL_GRAD_FP8), then full width and depth, 4 x 2048,
   Adam, a warm-up and 3 steps (finite falling losses, no host sync, row
   10f four times a layer a step);
16. train: gpt3-1.3b at full width and depth, f32 masters, bf16 AMP,
   fused cross-entropy, Adam, batch 4 x 2048, fed by
   ``DevicePrefetcher``: 2 warm-up and 6 measured steps on one repeated
   batch (finite and falling loss, no host sync, 24 launches of each
   flash kernel per step, f32 masters; step ms, tokens/s, MFU, peak
   memory), one profiled step (device busy share, top kernels), then 2
   steps without and 2 with ``enable_recompute()`` from one saved state
   (equal losses, 48 forward launches per step, lower peak);
16b. train-dropout: the train model with ``attn_dropout = dropout =
   DROP_P``, 3-step runs at p = 0 and p in turns: finite falling losses,
   each dropout form 24 times a step and no p = 0 flash kernel, no host
   sync, step ms, MFU and peak against p = 0 (the peak growing by at most
   1.5 x the hidden dropouts' masks), then full recompute equal to none
   under one generator seed;
17. train-fp16 (the training slice's main path): the same model and
   batch with fp16 AMP and dynamic loss scaling (scale 32768 at first):
   2 warm-up and 6 measured steps with no host sync, 24 launches of each
   flash kernel a step (fp16), finite loss on each step kept, falling;
   step ms, tokens/s, MFU and peak beside the bf16 step's; then 2 layers
   with ``PADDLE_FAULT_NAN_STEP``: the poisoned step skipped, the
   optimizer's t held, the scale halved after two overflows in a row;
18. train-recompute-policies: full width and depth, bf16, 2 steps each
   from one held state without recompute and under 'full',
   'dots_no_batch', 'dots', 'everything' (equal losses, ordered peaks,
   step ms and peak GB each);
19. train-merge: ``k_steps=2`` over the two 2 x 2048 halves of a 4 x
   2048 batch against one 4 x 2048 step (parameter changes within 5e-2,
   no host sync);
20. train-anomaly: 'skip' at full depth with ``PADDLE_FAULT_NAN_STEP=3``
   (one skipped step, no host sync until ``stats``, peak against the
   raise run), 'rollback' at 2 layers on a data-keyed blow-up (one
   rollback, one host sync a step, the snapshot's bytes and cost), and
   ``FLAGS_check_nan_inf`` at 2 layers (raises naming the gradients);
21. train-checkpoint: 1 layer at full width (the depth cut for disk and
   time): ``save(manifest=True)``, a fresh trainer ``load``s it and
   continues bitwise, ``CheckpointManager(keep_last=2)`` over 3
   asynchronous saves; bytes and seconds;
22. train-telemetry: train's bf16 trainer built twice, telemetry off
   and on, 3 steps each after a warm-up (no host sync; the on trainer's
   ``h2d``, ``dispatch`` and ``sync`` spans, ``train_steps_total``, a
   capture over steps 2-3 naming the flash forward and both backward
   kernels), step ms in turns; a 2-layer rollback run's bundle;
23. serve-decoding (after profile): the decoding API over gpt3-1.3b's
   KV cache.  Two prompts of 256 and 768 tokens sharing their last token
   (the ``bos_id``), each slot prefilled without it: ``beam_search``
   (4 beams, 32 steps) over a bf16, an int8 and an fp8 cache of 8 slots
   sized prompt + 32 (the flash kernel once a layer a prefill, the
   cache's decode kernel once a layer a step, one host read a step after
   the first; every beam's score against its tokens' log-probabilities
   under one no-cache forward, within TOL_BEAM_SCORE, and against its
   tokens replayed through the decode step over a fresh cache, within
   TOL_BEAM_REPLAY), ``greedy_search``
   over the bf16 cache (equal to the search with one beam, and to the
   engine's greedy streams but at a near-tie), ``viterbi_decode`` at
   B=8, T=256, N=64 against a float64 numpy Viterbi (equal paths),
   ``dynamic_decode`` over a tanh cell at V = 50304 (each beam rescored
   in f64 on the host); steps per second of each;
24. serve-moe: GPT-MoE at gpt3-1.3b widths, every second FFN a top-2
   layer of 8 experts at capacity factor 2.0 (random bf16 weights, seed
   1234), the engines at SERVE_MOE_LAYERS = 8 layers (1.45 B params; a
   depth cut for the budget) and the teacher-forced checks at the full
   24 (4.13 B; at 8, bf16 routes two of the checked tokens across a
   top-2 boundary, which the check cannot tell from a fault: ROADMAP
   Queue 3; ``--moe-hit-routing``): serve's 16 prompts
   (serve-paged's for the paged engines) with 32 new tokens through 8
   slots on the dense, paged, int8 dense and paged, chunked (512) and
   speculative (K = 4, a gpt3-125m draft) engines and with
   ``enable_decode_megakernel()`` asked for (no megakernel launch: the
   composed step runs).  Each: launches as in serve, one host read per
   decode step or spec tick and admission (serve-moe: as many as the
   dense serve phase on the same prompts), load + dropped = assigned,
   the ``moe_experts`` ledger line = MoE layers x 8 x (2 H F + F + H)
   x 2 bytes; tokens/s against serve's; a ``run_loadtest`` window (16
   requests at 2 rps, paged bf16) with its ``moe_*`` columns;
   the teacher-forced checks (every cache path and window, bf16 and
   int8, within TOL_TEACHER / TOL_TEACHER_INT8) at capacity factor E /
   k, where routing is per token (``teacher_moe``); a profiled decode step
   split into attention kernels, expert products, gating / dispatch /
   combine and the rest;
25. train-optimizers: Adagrad, RMSProp (centered), Adadelta, Adamax,
   Lamb, Lars, LookAhead(Adam) and ModelAverage, with L1 / L2
   regularizers and global-norm clip where they take them: one update
   each at gpt3-1.3b width, 2 layers, on one 2 x 512 step's gradients,
   of the last block's and the final norm's tensors,
   against the same update on f64 CPU copies (TOL_OPT_UPDATE per
   parameter and accumulator, no host read); then Lamb and
   LookAhead(Adam) with an EMA of the masters at full depth, 4 x 2048,
   bf16 AMP: a warm-up and 3 steps (finite falling losses, no host sync
   or read, each flash kernel once a layer a step), step ms beside
   Adam's;
26. train-moe: the same model at 12 layers (6 MoE; 24 do not fit
   with Adam's state, reckoned first), f32 masters, bf16 AMP, fused CE,
   Adam, 4 x 2048: 2 warm-up and 4 measured steps (finite losses with
   the aux term > 0, 12 launches of each flash kernel a step, no host
   sync; step ms, tokens/s, peak; no MFU: ``flops_per_token`` counts no
   experts), one profiled step, then one step without and one under
   'full' recompute at learning rate 0 (losses within TOL_RECOMPUTE, a
   lower peak);
27. transformer-kernels (after dropout-kernels): rows 1-3 and their
   dropout forms at Transformer-base's attention shape (B=16, S=256,
   H=Hkv=8, D=64, non-causal, bf16) against their plain versions within
   TOL_TB per row, each twice (bitwise equal), timed beside the plain
   versions and SDPA (the rows' ``transformer_base`` record entries);
28. train-transformer (the layer API's main path, after train-moe):
   ``set_device('gpu')``, ``seed(1234)``, Transformer-base built from
   Paddle layers (``nn.Transformer()`` at its defaults, one
   Embedding(37000, 512) shared by source and target, sinusoidal
   positions, Linear(512, 37000)), ``hapi.Model`` with Adam(0.9, 0.98,
   1e-9) on NoamDecay(512, 4000) from its peak, label-smoothed
   cross-entropy and Accuracy; ``fit`` over 2 epochs of 10 batches of
   16 x 256 + 16 x 256 tokens (a copy task, seed 1234) inside
   ``auto_cast(dtype='bfloat16')``, ``evaluate`` on 4, ``predict`` on
   2, ``save`` / ``load`` into a fresh Model (equal evaluation); finite
   falling loss, rows 1-3 (dropout forms) exactly 12 launches a step,
   6 attention-composite calls a forward; step ms, target tokens/s and
   peak beside the card;
29. train-transformer-trainer: the same network through
   ``prepare(strategy=...)`` with ``strategy.amp`` (``SpmdTrainer``) for
   10 steps, the same launch and composite counts.  Every other path
   must read 0 composite calls;
29a. jit-transformer: the same network through ``paddle.jit.to_static``
   for train-transformer's 20 fit steps: losses equal to the fit's, rows
   1-3 (dropout forms) 12 launches a step, one capture per key, fresh
   dropout bits on every call, the captured graph on the
   ``paddle_tpu::flash_fwd`` op with no library attention; ``jit.save``
   at ``InputSpec([None, 256], 'int64')`` x 2 and
   ``inference.load_predictor`` on the card at B = 16 and 1 against the
   eager forward (row 1 12 launches a call);
29b. capi: ``libpd_inference.so`` and ``pd_capi_demo`` built with ``cc``;
   ``PD_PredictorRun`` bitwise equal to the predictor, the demo binary's
   checksum equal to Python's, ``PD_NewTrainer`` NULL on the inference
   artifact (it has no ``.pdtrain``), with its reason;
30. workers: the DataLoader's fork workers over shared-memory rings on
   four batches of FakeData, bitwise equal to ``num_workers=0``'s; under
   ``PADDLE_FAULT_WORKER_KILL="1:1"`` the same batches with one restart,
   and a ``RuntimeError`` naming worker 1 without restarts; no child or
   ring left;
31. train-resnet: ResNet-50 (B=128, 224 x 224, 1000 classes) through
   ``Model.fit`` under ``auto_cast`` bf16, fed by
   ``DataLoader(num_workers=W, shm_ring_capacity=RN_RING)`` (W from the
   cores and ``/dev/shm``; the phase fails unless every epoch's frames
   came from W fork workers), then evaluate, predict, summary, flops,
   save / load; images/s over the step and the fit's wall, step and
   period ms, fork, pop, unpickle and H2D ms;
32. train-resnet-trainer: the same through ``SpmdTrainer``, fed the same
   way;
33. detect: every op of ``vision.ops`` at published detection shapes
   (Faster R-CNN's RPN NMS and RoI heads, SSD300's priors, DCNv2's c5,
   YOLOv3's three heads) on the card against the CPU, with each op's ms.
   Rows 1-11 launch 0 times on phases 30-33;
34. tensor-ops: every public function of ``paddle_tpu_torch.tensor`` and
   ``paddle_tpu_torch.linalg`` on the card against the same call on the
   CPU (``[64, 256]`` f32 and bf16, batched ``4 x 64 x 64`` f32 for the
   linear algebra; TOL_OPS_*), one line a module with the ops that read
   the host;
35. train-ctr: Wide & Deep at PaddleRec's widths (one 1 000 001 x 9
   table shared by 26 slots, ``Embedding(sparse=True)``, lazy Adam, batch
   512) fed by ``InMemoryDataset``, 60 eager steps: row-sparse table
   gradients, ``opt.step()`` free of host syncs, untouched rows bitwise
   unchanged, 5-step twins (sparse against dense SGD and Adam, card
   against CPU) within TOL_CTR_TWIN;
35a. static-ctr: the same Wide & Deep written in static mode
   (``static.data``, ``static.nn.sparse_embedding``, ``static.nn.fc``,
   ``Adam(0.001).minimize``), 60 ``Executor.run`` steps on train-ctr's
   batches: falling loss, 3 steps against a CPU replay of the same
   program within TOL_STATIC_REPLAY, ``save_inference_model`` ->
   ``load_inference_model`` against ``clone(for_test=True)`` within
   TOL_STATIC_INFER;
35b. rnn-layers: ``nn.LSTM``, ``nn.GRU`` and ``nn.SimpleRNN`` at 2
   layers x 512 on ``[128, 50, 512]``, forward and bidirectional, on the
   card against the CPU from the same weights in f32 (cuDNN's TF32 on)
   and under ``auto_cast`` bf16, and ``nn.LSTM`` against a stack of
   ``RNN(LSTMCell)``; an LSTM's parameters in one buffer a layer;
35c. train-seq2seq: the attention seq2seq at PaddleNLP's IWSLT'15 widths
   (``seq2seq_model``) through ``Model.fit`` over ``text.WMT16``'s
   synthetic pairs, 20 steps: a falling loss, step and period ms,
   tokens/s, peak; one forward on the card against the CPU;
35d. beam-seq2seq: its decoder under ``nn.BeamSearchDecoder`` at beam 10
   with ``nn.dynamic_decode(max_step_num=50)`` on 128 sources, trained
   and at its initial weights: ms and host reads a step, each beam's
   score against a teacher-forced rescoring, the top beams against the
   CPU search;
35e. c-trainer: ``SpmdTrainer.export_train_step`` on Transformer-base
   at 2 + 2 layers (C_LAYERS; bf16 AMP) stepped from C through
   ``PD_NewTrainer`` / ``PD_TrainerStep``: at dropout 0 against a live
   trainer of the same depth, at 0.1 a falling loss, rows 1-3 (dropout
   forms at 0.1) 4 launches a step each; ``pd_capi_train_demo`` prints
   CAPI-TRAIN-OK;
36. sparse-scale: lazy sparse Adam against dense at 1 M and 10 M x 64
   rows; the sparse step must be the faster at 10 M.  Rows 1-11 launch
   0 times on phases 34-36, 35a-35d.
37. cost-model: the registry's analytic costs (``exec_registry.analyze``)
   of train's gpt3-1.3b step and serve's prefill and decode step kinds;
   the train step's profile MFU against the train phase's (after the LM
   head's share of the flops, TOL_COST_MFU); the doctor's roofline
   verdict over train's stats with its ``remat_policy`` action;
   ``cost_stats`` of jit-transformer's ``to_static`` capture reporting
   rows 1-3's flops;
38. autotune-train: ``AutotuneController`` over ``SpmdTrainer`` at
   gpt3-1.3b widths, AT_LAYERS layers, 4 x 2048, axes ``remat_policy`` and
   ``prefetch_depth``: the trial log, no compile in a measured window or
   outside the trials, commits with provenance, a fresh trainer reading
   ``tuned_remat_policy``; rows 1-3 in every trial;
39. autotune-live: ``LiveRetuner`` on a dense and a paged gpt3-1.3b
   engine (8 slots, every bucket warmed): a real TTFT breach schedules one
   episode, held while work is queued, run on the quiesced engine with no
   compile; a subset of the warmed list; no second episode inside the
   cooldown; requests after it complete, an unchanged bucket's tokens
   equal; a new engine boots with the list the episode left;
40. qmm-sweep: ``autotune_qmm_sweep`` for gpt3-1.3b's four int8 products
   at M = 512 (each plan's ms beside the default's and ``torch._int_mm``
   + rescale's; the winner bitwise equal to the default plan), then a
   ``quantize='int8'`` engine reading the winners (row 10's launches);
41. faults: child processes over a 1-layer trainer: a SIGTERM-step
   preemption saved and resumed bitwise, a truncated checkpoint commit
   (exit 137) walked past on resume, a hung engine tick leaving a
   watchdog stall bundle;
42. report: ``python -m paddle_tpu_torch.observability.report`` over this
   run's snapshot (with ``--tuning``) and the stall bundle, exit 0.
The tuning table of a run is a temporary file (``PADDLE_TPU_TUNING_CACHE``
set before the first phase, removed at the end); phases 37-42 come last,
since they write it.

Each phase's seconds are printed on a line of their own
(``[phase-seconds]``).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.

Two measurements from which bounds above are set run apart:
``python3 chip_smoke.py --fp8-teacher-error`` (the plain fp8 path's
teacher error, for TOL_TEACHER_FP8) and ``python3 chip_smoke.py
--beam-fault`` (serve-decoding's beam searches with wrong cache regathers
planted, which must fail TOL_BEAM_SCORE).  ``python3 chip_smoke.py
--moe-hit-routing`` records the MoE routing of the paged-hit teacher
check at 8 layers against the forward's (why that depth fails it).
``python3 chip_smoke.py --autotune-phases`` runs phases 37-42 alone
(with serve, train and one Transformer-base capture for cost-model's
stashes).
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM dense peaks (NVIDIA data sheet): bf16 tensor-core rate and
# HBM3 bandwidth, the denominators of bound_ms
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES = 3.35e12

# tolerances, stated before measuring, held per output row (one query
# row of one head: a softmax over its own keys) so that long rows, whose
# outputs are small, are held to their own scale.  bf16 rounds each
# output to 8 significant bits (relative 2^-8) and the flash kernel also
# rounds p to bf16 before the p.v product, so a row's error is about
# 2^-8 of its largest element; the plain versions run in f32 on the same
# bf16 inputs
TOL_OUT = 1e-2      # x max|reference row|, per row
TOL_LSE = 1e-3      # x max(1, |reference lse|), per row, f32 on both sides
# the decode kernels over int8 caches (dense and paged) are held to
# TOL_OUT as well: they dequantize code x scale in f32, and so does the
# plain version fed the same codes and the f32 q; what is left is the
# output's bf16 rounding and the order of the f32 sums
# the window kernels over int8 caches dequantize code x scale to bf16
# before the products (as the TPU kernel does), so their plain version
# runs in f32 over the same bf16-rounded values: TOL_OUT again
# prefill + decode vs one forward, both bf16 end to end through 24
# layers: different kernels and matmul shapes round differently
TOL_TEACHER = 5e-2  # x max|forward logits| of each position
# the int8 cache adds its quantization: each stored k/v vector keeps 8
# bits relative to its own largest element (half a code step, 2^-8 of
# amax, where bf16 rounds each element to 2^-9 of itself), so small
# elements lose more; twice the bf16 limit, the JAX package's int8
# decode smoke holds int8 to 5% of the logit scale against its own fp
# decode, and the forward here is a third path
TOL_TEACHER_INT8 = 1e-1  # x max|forward logits| of each position
# the fp8 (e4m3) cache keeps 3 mantissa bits of each element (relative
# 2^-4 of itself, where int8 keeps 2^-8 of the vector's amax).  Measured
# without the e4m3 kernels (``python3 chip_smoke.py --fp8-teacher-error``:
# the fp8 teacher checks with rows 5f, 7f, 8bf and 9bf's plain versions
# swapped in, gpt3-1.3b at full depth, weight seeds 1234, 1 and 2, on one
# H100 80GB HBM3 at 700 W) the worst position of any check was
# FP8_TEACHER_WORST (the chunked prefill, seed 2); the bound is twice
# that, rounded up to two significant digits
FP8_TEACHER_WORST = 3.1915e-2
TOL_TEACHER_FP8 = 0.064  # x max|forward logits| of each position
# serve-decoding: a beam's score (its summed log-probabilities) against
# the same tokens' log-probabilities under one no-cache forward of prompt
# + beam, as a share of the sum over its positions of each position's
# max |forward logit|.  Measured on gpt3-1.3b at full depth (one H100
# 80GB HBM3 at 700 W) the worst beam of the bf16, int8 and fp8 caches
# read BEAM_SCORE_WORST, 3.3228e-4 and 2.0925e-4; the bound is ten times
# the worst, rounded up to two significant digits, for all three cache
# forms.  ``python3 chip_smoke.py --beam-fault`` plants wrong cache
# regathers and shows that the check fails them at this bound
BEAM_SCORE_WORST = 8.2808e-4
TOL_BEAM_SCORE = 8.3e-3
# The same score against the beam's tokens replayed one step at a time
# through the same decode step over a fresh cache of the same slots
# (``beam_replay_check``): the same kernels at the same shapes, so only a
# beam that read another slot's history moves it.  The right searches
# read exactly 0 with all three cache forms (``--beam-fault``, same card);
# the smallest planted fault that changed a final beam's history read
# 2.7895e-6 (the int8 cache not regathered), so the bound sits below it
TOL_BEAM_REPLAY = 1e-6
# viterbi_decode at B=8, T=256, N=64 against a float64 numpy Viterbi:
# potentials and transitions are multiples of 1/64 below 4 in magnitude,
# so every partial sum is exact in f32 and the paths must be equal (ties
# fall to the first index on both sides); scores within 1e-5 relative
TOL_VITERBI = 1e-5
# dynamic_decode (f32 cell, V = 50304): each beam's score against the
# same tokens rescored on the host in f64 through the same cell (no TF32
# on either side): f32 rounding of 16 steps of 256-wide products and
# 50304-wide log-softmaxes, relative to |score|
TOL_DYNAMIC = 1e-4
# train-optimizers: one update of every new rule on the card (f32)
# against the same update on f64 CPU copies of the same parameters and
# gradients: f32 rounding of the update, of the norms (Lamb, Lars, the
# clip) over up to 103 M elements and of beta ** t; per parameter,
# max |card - cpu| / max |cpu|
TOL_OPT_UPDATE = 1e-5
# flash backward: p and ds are rounded to bf16 in series before their
# products and each gradient to bf16 at the end, against the plain
# version in f32 on the same bf16 inputs (and the kernel's own o, lse):
# a few 2^-8 of each row's largest element.  A row that cancels to zero
# in exact arithmetic (causal query 0 attends one key; a softmax over one
# key has no gradient) keeps only f32 rounding of dp - delta on both
# sides, so a row's scale is at least BWD_FLOOR x the tensor's max
TOL_BWD = 2e-2      # x max|reference row|, per row of dq, dk and dv
BWD_FLOOR = 1e-3
# delta = rowsum(do * o): products of two 16-bit values are exact in
# f32, so kernel and plain version differ only in the order of D f32
# additions, at most (D - 1) x 2^-24 x sum|do o| (7.6e-6 at D = 128)
TOL_DELTA = 1e-5    # x sum_d |do o| of the row
# fused cross-entropy: logits from bf16 operands are exact in TF32, so
# the loss is f32 rounding; d_logits keep TF32's 10 mantissa bits
# (2^-11 per element) in the backward products
TOL_CE_LOSS = 1e-4  # x max(1, |reference loss|), per row
TOL_CE_GRAD = 1e-2  # x max|reference gradient|, per tensor
# train-parity: bf16 AMP through two layers; the kernels round p, ds and
# o to bf16 where the plain attention keeps f32, and every later bf16
# product rounds on top
TOL_GRAD = 5e-2     # x max|plain gradient|, per parameter
# fp8 QAT parity: an e4m3 activation code on a rounding boundary moves by
# one e4m3 step (2^-3 relative, 32x a bf16 step) when its input differs
# in the last bit, so the fp8 step's gradients depend on the order of the
# product's f32 sums: two plain orders (f32 and f64 sums) of one 2-layer
# step differed by up to 2.5e-2 per parameter (median 1.3e-2), and the
# kernel (tensor-core partial sums of 128 products) by 4.3e-2 from the
# f64 order (measured on one H100 80GB HBM3 at 700 W).  Twice
# TOL_GRAD, as the int8 cache's teacher bound is twice the bf16 one
TOL_GRAD_FP8 = 1e-1  # x max|plain gradient|, per parameter
# recompute runs the same kernels on the same inputs again
TOL_RECOMPUTE = 1e-3  # x |loss without recompute|, per step


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
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


def device_ms(fn, iters=20, warmup=3):
    """Device time per call of ``fn``: the summed time of the kernels it
    launched (torch.profiler), without the host's launch gaps, which
    outlast kernels of a few tens of microseconds.  A profiling session
    that records no device time (seen now and then after many sessions in
    one process) is repeated, up to three sessions; None when none
    records any."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / iters / 1e3
    return None


def bound(flops, nbytes, peak=PEAK_BF16_FLOPS):
    """(bound_ms, bound_by): the larger of operations over their type's
    peak (bf16 unless given) and bytes over the memory rate."""
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[device] {name} count={count} torch={torch.__version__} "
        f"cuda={torch.version.cuda}")
    log(smi)
    return name, count, smi


# the sources whose kernels run on the shared wgmma forward mainloop
# (hopper_attn_fwd.cuh: every attn_fwd_kernel instantiation) and, in the
# window sources, on the verify ring (verify_kernel); a spill in one of
# those kernels fails the build phase
FWD_SOURCES = ("flash_fwd.cu", "window_attention.cu", "window_attention_q.cu",
               "paged_window_attention.cu", "paged_window_attention_q.cu",
               "window_attention_f8.cu", "paged_window_attention_f8.cu")


def ptxas_kernels(log_text):
    """[(mangled entry function, registers, spill line)] from the
    ``-Xptxas=-v`` report of one source."""
    out, fn, spill = [], None, ""
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            fn, spill = line.split("'")[1], ""
        elif "spill stores" in line:
            spill = line.strip()
        elif fn and "Used" in line and "registers" in line:
            words = line.split()
            out.append((fn, int(words[words.index("registers,") - 1]
                                if "registers," in words else
                                words[words.index("registers") - 1]), spill))
            fn = None
    return out


def phase_build():
    from paddle_tpu_torch.ops import _build
    t0 = time.perf_counter()
    secs = _build.build()
    log(f"[build] {len(secs)} sources in {time.perf_counter() - t0:.2f} s "
        f"(parallel nvcc): " +
        ", ".join(f"{k} {v:.2f} s" for k, v in secs.items()))
    spilled = []
    for src in secs:
        kernels = ptxas_kernels(_build.build_log(src))
        regs = [r for _, r, _ in kernels]
        spills = [sp for _, _, sp in kernels
                  if sp and "0 bytes spill stores, 0 bytes spill loads" not in sp]
        log(f"[build] {src}: {len(regs)} kernel instantiations, registers "
            f"per thread {min(regs, default=0)}-{max(regs, default=0)}, "
            f"spills: {spills or 'none'}")
        if src in ("quantized_matmul.cu", "quantized_matmul_f8.cu"):
            kind = "e4m3" if "f8" in src else "int8"
            checked = [(f"{kind} wgmma tiles", "prefill_kernel",
                        " (setmaxnreg raises the two-warpgroup consumers')"),
                       (f"{kind} split-K stream", "decode_kernel", "")]
        elif src in FWD_SOURCES:
            checked = [("wgmma forward mainloop", "attn_fwd_kernel",
                        " (setmaxnreg raises the consumers')")]
            if "window" in src:
                checked.append(("verify ring", "verify_kernel", ""))
        else:
            continue
        for what, kname, note in checked:
            found = [(r, sp) for fn, r, sp in kernels if kname in fn]
            bad = [sp for _, sp in found
                   if "0 bytes spill stores, 0 bytes spill loads" not in sp]
            log(f"[build] {src} {what}: {len(found)} instantiations, "
                f"registers at launch {sorted({r for r, _ in found})}{note}, "
                f"spills: {bad or 'none'}"
                f"{'' if kernels else ' (no report: built by an earlier process)'}")
            spilled += [f"{src} {kname}: {sp}" for sp in bad]
    if spilled:
        raise SystemExit(f"build phase failed: a kernel on the forward "
                         f"mainloop, the verify ring or the int8 or e4m3 "
                         f"matmul spills registers: {spilled}")


def _rand(shape, gen, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def row_errors(got, ref, tol=TOL_OUT, floor=0.0):
    """Rows along the last axis: (max abs error, worst row's error over
    that row's max |ref|, whether every row is within ``tol`` of its own
    scale).  A row's scale is at least ``floor`` x the tensor's max |ref|;
    with no floor a row whose reference is all zeros must come out
    exactly 0."""
    err = (got.float() - ref).abs().amax(-1)
    scale = ref.abs().amax(-1).clamp_min(floor * ref.abs().max())
    ok = bool((err <= tol * scale).all().item())
    worst = (err / scale.clamp_min(1e-30)).max().item()
    return err.max().item(), worst, ok


def check_flash(gen, b, s, h, hkv, d, causal=True, mask=False,
                dtype=torch.bfloat16):
    """The forward kernel against its plain version: o per row within
    TOL_OUT, lse per row within TOL_LSE, and two calls bitwise equal.
    With ``mask`` the last batch row's key 0 is masked, so under causal
    its query 0 sees no key and must come out exactly 0."""
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    q = _rand((b, s, h, d), gen, dtype)
    k = _rand((b, s, hkv, d), gen, dtype)
    v = _rand((b, s, hkv, d), gen, dtype)
    kv_mask = None
    if mask:
        kv_mask = (torch.rand((b, s), generator=gen, device="cuda") > 0.3
                   ).float()
        kv_mask[-1, 0] = 0.0
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, kv_mask=kv_mask)
    o2, lse2 = fa.flash_attention_fwd(q, k, v, causal=causal,
                                      kv_mask=kv_mask)
    ro, rlse = fa._flash_plain(q.float(), k.float(), v.float(), causal,
                               kv_mask)
    torch.cuda.synchronize()
    err_o, worst_o, ok_o = row_errors(o, ro)
    dl = (lse - rlse).abs()
    err_l = dl.max().item()
    worst_l = (dl / rlse.abs().clamp_min(1.0)).max().item()
    same = torch.equal(o, o2) and torch.equal(lse, lse2)
    empty_ok = not (mask and causal) or o[-1, 0].abs().max().item() == 0.0
    ok = (ok_o and worst_l <= TOL_LSE and torch.isfinite(o).all().item()
          and same and empty_ok)
    log(f"[kernels] flash B={b} S={s} H={h} Hkv={hkv} D={d} causal={causal} "
        f"mask={mask} {str(dtype)[6:]}: max|o-plain|={err_o:.3e} worst row "
        f"|o-plain|/max|plain row|={worst_o:.3e} (tol {TOL_OUT}) "
        f"max|lse-plain|={err_l:.3e} worst row {worst_l:.3e} "
        f"(tol {TOL_LSE}) deterministic={same}"
        f"{' masked row exact 0=' + str(empty_ok) if mask and causal else ''} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"flash kernel disagrees with its plain version "
                         f"at B={b} S={s} H={h} Hkv={hkv} D={d}")
    return q, k, v, err_o, worst_o


def _quantize(x, quantized=True):
    """bf16 values -> (codes, f32 scales) as a quantized cache stores
    them (``quantize_kv``): int8 codes, or e4m3 codes where ``quantized``
    is ``'fp8'``."""
    qm = importlib.import_module("paddle_tpu_torch.ops.quantized_matmul")
    return qm.quantize_kv(x, "fp8" if quantized == "fp8" else "int8")


def _tag(quantized):
    """A kernel name's suffix for a cache kind (False, None or an engine's
    'dense': 16-bit; True or 'int8': int8; 'fp8': e4m3): '', '_q', '_f8'."""
    if quantized == "fp8":
        return "_f8"
    return "_q" if quantized is True or quantized == "int8" else ""


def _kv_for_plain(k, v):
    """What the plain versions take beside an f32 q: int8 or e4m3 codes as
    they are (dequantized in f32 inside), bf16 caches widened to f32."""
    return (k, v) if k.dtype in (torch.int8, torch.float8_e4m3fn) \
        else (k.float(), v.float())


def check_decode(gen, lengths, cap, h, hkv, d, quantized=False):
    da = importlib.import_module("paddle_tpu_torch.ops.decode_attention")
    b = len(lengths)
    q = _rand((b, h, d), gen)
    kc = _rand((b, cap, hkv, d), gen)
    vc = _rand((b, cap, hkv, d), gen)
    ks = vs = None
    if quantized:
        (kc, ks), (vc, vs) = (_quantize(x, quantized) for x in (kc, vc))
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    o = da.decode_attention(q, kc, vc, lens, ks, vs)
    ro = da._decode_plain(q.float(), *_kv_for_plain(kc, vc), lens, ks, vs)
    torch.cuda.synchronize()
    err, worst, ok_rows = row_errors(o, ro)
    zero_ok = all(o[i].abs().max().item() == 0.0
                  for i, n in enumerate(lengths) if n == 0)
    ok = ok_rows and zero_ok and torch.isfinite(o).all().item()
    log(f"[kernels] decode{_tag(quantized)} B={b} cap={cap} H={h} "
        f"Hkv={hkv} D={d} lengths={lengths}: max|o-plain|={err:.3e} worst "
        f"(slot, head) |o-plain|/max|plain row|={worst:.3e} (tol {TOL_OUT}) "
        f"zeros_for_len0={zero_ok} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"decode kernel (codes={quantized}) disagrees with "
                         f"its plain version at B={b} H={h} Hkv={hkv} D={d}")
    return (q, kc, vc, lens, ks, vs), err, worst


def paged_inputs(gen, lengths, bs, h, hkv, d, quantized, mb=None,
                 spare=3, inactive=False):
    """q, pools and tables for slots of ``lengths``: each slot's blocks
    drawn from a shuffled pool without repeats, entries past its extent
    the null block 0 (a table ``mb`` wider than the longest slot gives
    null-block tails); ``inactive`` appends a slot whose table row is all
    0 at length 1, as the engine leaves an empty slot."""
    need = [-(-n // bs) for n in lengths]
    mb = mb or max(need)
    nb = 1 + sum(need) + spare
    b = len(lengths) + int(inactive)
    q = _rand((b, h, d), gen)
    k = _rand((nb, bs, hkv, d), gen)
    v = _rand((nb, bs, hkv, d), gen)
    perm = (1 + torch.randperm(nb - 1, generator=gen, device="cuda")).tolist()
    tables = torch.zeros((b, mb), dtype=torch.int32)
    for i, n in enumerate(need):
        tables[i, :n] = torch.tensor(perm[:n])
        perm = perm[n:]
    tables = tables.cuda()
    lens = torch.tensor(list(lengths) + [1] * int(inactive),
                        dtype=torch.int32, device="cuda")
    ks = vs = None
    if quantized:
        (k, ks), (v, vs) = (_quantize(x, quantized) for x in (k, v))
    return q, k, v, tables, lens, ks, vs


def check_paged(gen, lengths, bs, h, hkv, d, quantized=False, **kw):
    da = importlib.import_module("paddle_tpu_torch.ops.decode_attention")
    q, k, v, tables, lens, ks, vs = paged_inputs(gen, lengths, bs, h, hkv, d,
                                                 quantized, **kw)
    o = da.paged_decode_attention(q, k, v, tables, lens, ks, vs)
    ro = da._paged_plain(q.float(), *_kv_for_plain(k, v), tables, lens, ks,
                         vs)
    torch.cuda.synchronize()
    err, worst, ok_rows = row_errors(o, ro)
    ok = ok_rows and torch.isfinite(o).all().item()
    log(f"[kernels] paged{_tag(quantized)} bs={bs} B={q.shape[0]} "
        f"MB={tables.shape[1]} NB={k.shape[0]} H={h} Hkv={hkv} D={d} "
        f"lengths={lens.tolist()}: max|o-plain|={err:.3e} worst (slot, head) "
        f"|o-plain|/max|plain row|={worst:.3e} (tol {TOL_OUT}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"paged decode kernel (codes={quantized}) disagrees "
                         f"with its plain version at bs={bs} H={h} Hkv={hkv} "
                         f"D={d} lengths={lengths}")
    return (q, k, v, tables, lens, ks, vs), err, worst


def time_decode_row(key, line, tensors, paged, errs, worst, lib_args):
    """Time one decode kernel at the serving shape beside its plain
    version and the library yardstick (SDPA over the equivalent dense
    bf16 K/V, gathered and dequantized before the clock), and its bound:
    K/V (codes and scales) read once, q read and o written once."""
    da = importlib.import_module("paddle_tpu_torch.ops.decode_attention")
    F = torch.nn.functional
    if paged:
        q, k, v, tables, lens, ks, vs = tensors

        def kernel():
            return da.paged_decode_attention(q, k, v, tables, lens, ks, vs)

        def plain():
            return da._paged_plain(q, k, v, tables, lens, ks, vs)
        extra = 4 * tables.numel()
    else:
        q, k, v, lens, ks, vs = tensors

        def kernel():
            return da.decode_attention(q, k, v, lens, ks, vs)

        def plain():
            return da._decode_plain(q, k, v, lens, ks, vs)
        extra = 0
    # tens of microseconds a call: the best of three windows of 200
    # calls, so that one disturbed window (one read 2.6x the others in a
    # run of this script) does not stand for the kernel
    t_kernel = min(cuda_ms(kernel, iters=200, warmup=10) for _ in range(3))
    t_plain = cuda_ms(plain, iters=5)
    t_lib = min(cuda_ms(lambda: F.scaled_dot_product_attention(*lib_args),
                        iters=200, warmup=10) for _ in range(3))
    b, h, d = q.shape
    hkv = k.shape[-2]
    npos = int(lens.sum().item())
    per_value = 1 if ks is not None else 2
    nbytes = (2 * per_value * npos * hkv * d
              + (2 * 4 * npos * hkv if ks is not None else 0)
              + 2 * 2 * q.numel() + 4 * b + extra)
    b_ms, b_by = bound(4 * h * d * npos, nbytes)
    log(f"[kernels] {key} timing B={b} lengths={b}x{npos // b} H={h} D={d}: "
        f"kernel_ms={t_kernel:.4f} plain_ms={t_plain:.4f} "
        f"library_ms={t_lib:.4f} (SDPA over dense bf16 K/V) "
        f"bound_ms={b_ms:.4f} ({b_by}, {nbytes / 1e6:.2f} MB)")
    return dict(
        name=key, route="cuda", source=f"paddle_tpu_torch/csrc/{key}.cu",
        replaces=f"paddle_tpu/ops/decode_attention.py:{line}",
        max_abs_err=max(errs), max_row_rel_err=max(worst), row_tol=TOL_OUT,
        ms=t_kernel, plain_ms=t_plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=t_lib)


def sdpa_args(q, k, v, lens):
    """Arguments of the library yardstick: dense bf16 K/V ``[B, S, Hkv,
    D]`` expanded to the query heads, a length mask."""
    h, hkv = q.shape[1], k.shape[2]
    kt, vt = (x.repeat_interleave(h // hkv, dim=2).transpose(1, 2)
              .contiguous() for x in (k, v))
    keep = (torch.arange(k.shape[1], device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    return q[:, :, None].contiguous(), kt, vt, keep


def phase_kernels():
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    F = torch.nn.functional
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    records = {}

    # flash: gpt3-1.3b prefill shapes (B=1, H=16, D=128) at buckets and
    # ragged lengths across a 128-row tile, GQA, D=64, fp16, key masks
    # (one leaving a causal row with no key), full attention, and the
    # training shape (B=4, S=2048) in bf16 and in fp16 (train-fp16's)
    worst, errs = [], []
    for args, kw in (((2, 130, 16, 16, 128), {}),
                     ((1, 256, 16, 4, 128), {}),
                     ((2, 192, 8, 8, 64), {}),
                     ((2, 200, 16, 4, 128), dict(causal=False, mask=True)),
                     ((2, 333, 16, 4, 128), dict(mask=True)),
                     ((2, 130, 8, 2, 64), dict(mask=True,
                                               dtype=torch.float16)),
                     ((2, 200, 16, 16, 128), dict(dtype=torch.float16)),
                     ((4, 2048, 16, 16, 128), {}),
                     ((4, 2048, 16, 16, 128), dict(dtype=torch.float16))):
        *_, e, w = check_flash(gen, *args, **kw)
        errs.append(e)
        worst.append(w)
    for s in (16, 48, 128, 2048):
        q, k, v, e, w = check_flash(gen, 1, s, 16, 16, 128)
        errs.append(e)
        worst.append(w)

    def flash_row(q, k, v):
        """(kernel, plain, library ms, bound ms, bound_by) at causal;
        kernel and library timed in turns, best of two windows each."""
        b, s, h, d = q.shape
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        ts, tl = [], []
        for _ in range(2):
            ts.append(cuda_ms(lambda: fa.flash_attention_fwd(
                q, k, v, causal=True), iters=50))
            tl += [cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), iters=50) for _ in range(2)]
            ts.append(cuda_ms(lambda: fa.flash_attention_fwd(
                q, k, v, causal=True), iters=50))
        t_plain = cuda_ms(lambda: fa._flash_plain(q, k, v, True), iters=3,
                          warmup=1)
        flops = 4 * b * h * d * (s * (s + 1) // 2)
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * b * h * s
        b_ms, b_by = bound(flops, nbytes)
        log(f"[kernels] flash timing B={b} S={s} H={h} D={d} causal: "
            f"kernel_ms={min(ts):.4f} plain_ms={t_plain:.4f} "
            f"library_ms={min(tl):.4f} (SDPA) bound_ms={b_ms:.4f} ({b_by}, "
            f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB) share of bound "
            f"{b_ms / min(ts):.3f}, x SDPA {min(ts) / min(tl):.3f}")
        return min(ts), t_plain, min(tl), b_ms, b_by

    t_kernel, t_plain, t_lib, b_ms, b_by = flash_row(q, k, v)
    records["flash_fwd"] = dict(
        name="flash_fwd", route="cuda",
        source="paddle_tpu_torch/csrc/flash_fwd.cu",
        replaces="paddle_tpu/ops/flash_attention.py:72",
        max_abs_err=max(errs), max_row_rel_err=max(worst), row_tol=TOL_OUT,
        ms=t_kernel, plain_ms=t_plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=t_lib)
    for s2 in (128, 512):
        q2, k2, v2 = (x[:, :s2].contiguous() for x in (q, k, v))
        t2 = cuda_ms(lambda: fa.flash_attention_fwd(q2, k2, v2, causal=True))
        log(f"[kernels] flash timing S={s2}: kernel_ms={t2:.4f}")
    q, k, v = (_rand((4, 2048, 16, 128), gen) for _ in range(3))
    t4, p4, l4, b4, by4 = flash_row(q, k, v)
    records["flash_fwd"].update(
        train_ms=t4, train_plain_ms=p4, train_library_ms=l4,
        train_bound_ms=b4, train_bound_by=by4,
        note="ms, plain_ms, bound_ms and library_ms at the prefill shape "
             "(B=1, S=2048, H=16, D=128, causal); train_* at the training "
             "shape (B=4, S=2048)")
    del q, k, v

    decode_rows(gen, records, (("decode_attention", 126, False),
                               ("decode_attention_q", 190, True)))
    paged_rows(gen, records, (("paged_decode_attention", 364, False),
                              ("paged_decode_attention_q", 469, True)))
    return records


# dense decode cases (rows 4, 5, 5f): batch_slots=8 over the 2048-token
# cache, boundary lengths, GQA, G = 16 (16 query heads over one kv head),
# D=64; then the timing shape, 8 full slots
MIXED = [0, 1, 127, 128, 1000, 2048, 64, 1537]
FULL = [2048] * 8
DENSE_CASES = [(MIXED, 2048, 16, 16, 128), (MIXED, 2048, 16, 4, 128),
               ([1, 300, 2048], 2048, 16, 1, 128),
               ([0, 5, 300, 512], 512, 8, 8, 64),
               (FULL, 2048, 16, 16, 128)]
# paged decode cases (rows 6, 7, 7f): block size 128 as the engine
# serves, and 16 / 32 for the layout's edges; shuffled blocks, a length of
# one, exact block multiples, ragged and null-block tails, an inactive
# slot, GQA, G = 16, D=64; then the timing shape, 8 full slots of 16
# blocks in a pool of 129
PAGED_CASES = [
    dict(lengths=[1, 128, 1000, 2048, 256, 1537, 64], bs=128, h=16, hkv=16,
         d=128, mb=16, inactive=True),
    dict(lengths=[1, 300, 2048, 129], bs=128, h=16, hkv=4, d=128,
         inactive=True),
    dict(lengths=[5, 2048, 700], bs=128, h=16, hkv=1, d=128),
    dict(lengths=[1, 16, 100, 512, 31], bs=16, h=8, hkv=8, d=64, mb=40,
         inactive=True),
    dict(lengths=[64, 33, 480], bs=32, h=16, hkv=4, d=128),
    dict(lengths=FULL, bs=128, h=16, hkv=16, d=128, spare=0),
]


def decode_rows(gen, records, rows):
    """Each dense decode kernel of ``rows`` ((key, line of the JAX
    function it computes, cache kind)) at every DENSE_CASES case, then
    timed at the last."""
    for key, line, quantized in rows:
        errs, worst = [], []
        for case in DENSE_CASES:
            tensors, err, w = check_decode(gen, *case, quantized=quantized)
            errs.append(err)
            worst.append(w)
        q, kc, vc, lens, ks, vs = tensors
        dense_k = kc if ks is None else _dequant(kc, ks)
        dense_v = vc if vs is None else _dequant(vc, vs)
        records[key] = time_decode_row(key, line, tensors, False, errs, worst,
                                       sdpa_args(q, dense_k, dense_v, lens))
        del tensors, q, kc, vc, dense_k, dense_v


def paged_rows(gen, records, rows):
    """Each paged decode kernel of ``rows`` at every PAGED_CASES case,
    then timed at the last."""
    for key, line, quantized in rows:
        errs, worst = [], []
        for case in PAGED_CASES:
            tensors, err, w = check_paged(gen, quantized=quantized, **case)
            errs.append(err)
            worst.append(w)
        q, k, v, tables, lens, ks, vs = tensors
        # the library yardstick reads the same positions as a dense cache
        b, mb = tables.shape
        bs = k.shape[1]
        idx = tables.long()
        dense_k = k[idx].reshape(b, mb * bs, k.shape[2], k.shape[3])
        dense_v = v[idx].reshape(b, mb * bs, v.shape[2], v.shape[3])
        if ks is not None:
            dense_k = _dequant(dense_k, ks[idx].reshape(b, mb * bs, -1))
            dense_v = _dequant(dense_v, vs[idx].reshape(b, mb * bs, -1))
        records[key] = time_decode_row(key, line, tensors, True, errs, worst,
                                       sdpa_args(q, dense_k, dense_v, lens))
        del tensors, q, k, v, dense_k, dense_v


def window_inputs(gen, lengths, w, h, hkv, d, quantized, bs=None, cap=2048,
                  spare=2, dtype=torch.bfloat16):
    """q ``[B, W, H, D]`` (``dtype``) and a cache whose slots hold
    ``lengths`` tokens before the window: dense ``[B, cap, Hkv, D]``, or
    (``bs``) a shuffled block pool with tables of ``cap / bs`` entries,
    each slot's blocks covering ``min(len + W, cap)`` positions and
    null-block tails past them.  int8 caches are ``quantize_kv`` codes
    with f32 scales; 16-bit caches take q's dtype.
    Returns ``(q, k, v, tables or None, lens, ks, vs)``."""
    b = len(lengths)
    q = _rand((b, w, h, d), gen, dtype)
    tables = None
    if bs is None:
        k = _rand((b, cap, hkv, d), gen, dtype)
        v = _rand((b, cap, hkv, d), gen, dtype)
    else:
        need = [-(-min(n + w, cap) // bs) for n in lengths]
        nb = 1 + sum(need) + spare
        k = _rand((nb, bs, hkv, d), gen, dtype)
        v = _rand((nb, bs, hkv, d), gen, dtype)
        perm = (1 + torch.randperm(nb - 1, generator=gen,
                                   device="cuda")).tolist()
        tables = torch.zeros((b, cap // bs), dtype=torch.int32)
        for i, n in enumerate(need):
            tables[i, :n] = torch.tensor(perm[:n])
            perm = perm[n:]
        tables = tables.cuda()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    ks = vs = None
    if quantized:
        (k, ks), (v, vs) = (_quantize(x, quantized) for x in (k, v))
    return q, k, v, tables, lens, ks, vs


def _window_call(tensors, plain=False):
    da = importlib.import_module("paddle_tpu_torch.ops.decode_attention")
    q, k, v, tables, lens, ks, vs = tensors
    if plain:
        # the plain version in f32 over the values the window kernels
        # attend: int8 codes dequantized to q's dtype, as the TPU kernel
        # and the JAX composite dequantize them
        if ks is not None:
            k, v = _dequant(k, ks, q.dtype), _dequant(v, vs, q.dtype)
            ks = vs = None
        q, k, v = q.float(), k.float(), v.float()
    if tables is None:
        fn = da._window_plain if plain else da.decode_attention_window
        return fn(q, k, v, lens, ks, vs)
    fn = da._paged_window_plain if plain else da.paged_decode_attention_window
    return fn(q, k, v, tables, lens, ks, vs)


def check_window(gen, lengths, w, h, hkv, d, quantized=False, bs=None,
                 cap=2048, dtype=torch.bfloat16):
    """One window kernel against its plain version, every output row
    (one query of one head) within TOL_OUT of its own max |plain|, two
    calls bitwise equal."""
    tensors = window_inputs(gen, lengths, w, h, hkv, d, quantized, bs, cap,
                            dtype=dtype)
    o = _window_call(tensors)
    again = _window_call(tensors)
    ro = _window_call(tensors, plain=True)
    torch.cuda.synchronize()
    err, worst, ok_rows = row_errors(o, ro)
    same = torch.equal(o, again)
    ok = ok_rows and same and torch.isfinite(o).all().item()
    log(f"[kernels] {'paged_' if bs else ''}window{_tag(quantized)}"
        f"{f' bs={bs}' if bs else ''} B={len(lengths)} W={w} H={h} Hkv={hkv} "
        f"D={d} {str(dtype).split('.')[-1]} cap={cap} lengths={lengths}: "
        f"max|o-plain|={err:.3e} worst row "
        f"|o-plain|/max|plain row|={worst:.3e} (tol {TOL_OUT}) "
        f"deterministic={same} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"window kernel (paged={bool(bs)}, codes={quantized})"
                         f" disagrees with its plain version at W={w} H={h} "
                         f"Hkv={hkv} D={d} bs={bs} lengths={lengths}")
    return err, worst


# the window kernels' cases: the verify window (K = 4), a 512-token chunk
# ending at the cache's end (S - W), G = 16, the gpt3-125m draft's heads
# (D = 64, H = 12), lengths 0 and 1, mid values and the last window that
# fits (S - W); W * G = 20 (the chunk kernel with one mostly padded tile)
# and 1024 (G = 16: many w a tile); ``bs``: the paged kernels' block
# sizes (128 as the engine serves; 16 and 48 split 128-key tiles over
# several blocks, 48 unevenly, over a 1536-position cap).  The verify
# edges: lengths around a 64-key tile (63, 64, 65) at B=8 and B=1 (one
# kv head a slot split over a cluster of CTAs for the int8 kernels), fp16
# q at D=64, blocks of 16 and 48 on a 1536-position cap up to S - W.
# Every paged case's tables end in null-block entries past the live ones.
WINDOW_CASES = [
    dict(lengths=[0, 1, 127, 700, 1000, 1536, 2000, 2043], w=5, h=16, hkv=16,
         d=128, bs=(128, 16)),
    dict(lengths=[0, 1, 64, 100, 511, 1000, 1500, 1536], w=512, h=16, hkv=16,
         d=128, bs=(128, 16)),
    dict(lengths=[0, 300, 2043], w=5, h=16, hkv=1, d=128, bs=(128, 16)),
    dict(lengths=[3, 1000], w=1, h=16, hkv=1, d=128, bs=(128, 16)),
    dict(lengths=[0, 37, 1200], w=64, h=16, hkv=1, d=128, bs=(128, 16)),
    dict(lengths=[0, 1, 700, 2043], w=5, h=12, hkv=12, d=64),
    dict(lengths=[0, 200, 1536], w=512, h=12, hkv=12, d=64),
    dict(lengths=[0, 300, 2043], w=5, h=16, hkv=4, d=128, bs=(128, 16)),
    dict(lengths=[0, 37, 500, 1472], w=64, h=16, hkv=4, d=128, cap=1536,
         bs=(48,)),
    dict(lengths=[0, 1, 63, 64, 65, 700, 1500, 2043], w=5, h=16, hkv=16,
         d=128, bs=(128, 16)),
    dict(lengths=[2043], w=5, h=16, hkv=16, d=128, bs=(128, 16)),
    dict(lengths=[0], w=5, h=16, hkv=16, d=128, bs=(128,)),
    dict(lengths=[65], w=5, h=16, hkv=16, d=128, bs=(16,)),
    dict(lengths=[0, 1, 700, 2043], w=5, h=12, hkv=12, d=64,
         dtype=torch.float16, bs=(128, 16)),
    dict(lengths=[0, 1, 63, 64, 65, 1531], w=5, h=16, hkv=16, d=128,
         cap=1536, bs=(16, 48)),
]
VERIFY_W, CHUNK_W = 5, 512


def capture(fn, iters):
    """A CUDA graph of ``iters`` calls of ``fn`` (after warm-up calls on a
    side stream, as graph capture wants)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def replay_ms(graph, iters):
    """Milliseconds per call of one replay of a graph of ``iters`` calls
    (CUDA events): the device's time without the host's launch gaps."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(fns, iters, rounds=3):
    """Best of ``rounds`` timing windows of each function, each window one
    replay of a CUDA graph of ``iters`` calls, taken in turns whose order
    alternates (a, b, b, a, a, b): ms per call."""
    graphs = [capture(fn, iters) for fn in fns]
    times = [[] for _ in fns]
    for rnd in range(rounds):
        order = range(len(fns)) if rnd % 2 == 0 else range(len(fns))[::-1]
        for i in order:
            times[i].append(replay_ms(graphs[i], iters))
    return [min(x) for x in times]


def time_window(key, line, bs, quantized, gen, errs, worst):
    """Time one window kernel at the verify shape (B=8, W=5, every slot
    at S - W = 2043 cached tokens: bytes bound), the same at B=1, and the
    chunk shape (B=8, W=512, every slot at 1536: operations bound) in
    turns with the library yardstick (SDPA with a boolean staircase mask
    over the dense bf16 K/V, gathered and dequantized before the clock),
    both replayed from CUDA graphs (a verify kernel is shorter than the
    host's launch gap); beside them the plain version (not at B=1) and
    the wrapper called back to back from the host (``call_ms``)."""
    F = torch.nn.functional
    rec = dict(name=key, route="cuda",
               source=f"paddle_tpu_torch/csrc/{key}.cu",
               replaces=f"paddle_tpu/ops/decode_attention.py:{line}",
               max_abs_err=max(errs), max_row_rel_err=max(worst),
               row_tol=TOL_OUT)
    for shape, w, n0, b, iters in (
            ("verify", VERIFY_W, 2048 - VERIFY_W, 8, 200),
            ("verify_b1", VERIFY_W, 2048 - VERIFY_W, 1, 200),
            ("chunk", CHUNK_W, 1536, 8, 50)):
        tensors = window_inputs(gen, [n0] * b, w, 16, 16, 128, quantized, bs,
                                spare=0)
        q, k, v, tables, lens, ks, vs = tensors
        t_plain = None if b == 1 else cuda_ms(
            lambda: _window_call(tensors, plain=True), iters=3, warmup=1)
        if tables is not None:
            idx = tables.long()
            k = k[idx].reshape(b, -1, 16, 128)
            v = v[idx].reshape(b, -1, 16, 128)
            if ks is not None:
                ks, vs = (x[idx].reshape(b, -1, 16) for x in (ks, vs))
        if ks is not None:
            k, v = _dequant(k, ks), _dequant(v, vs)
        s = k.shape[1]
        kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))
        qt = q.transpose(1, 2).contiguous()
        keep = (torch.arange(s, device="cuda")[None, None, :]
                < (lens[:, None, None] + torch.arange(w, device="cuda")[
                    None, :, None] + 1))[:, None]
        t_kernel, t_lib = in_turns(
            [lambda: _window_call(tensors),
             lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                    attn_mask=keep)], iters)
        t_call = cuda_ms(lambda: _window_call(tensors), iters=iters, warmup=5)
        npos = sum(min(n0 + w, 2048) for _ in range(b))
        per_value = 1 if quantized else 2
        nbytes = (2 * per_value * npos * 16 * 128
                  + (2 * 4 * npos * 16 if quantized else 0)
                  + 2 * 2 * q.numel() + 4 * b
                  + (4 * tables.numel() if tables is not None else 0))
        flops = 4 * b * 16 * 128 * sum(n0 + i + 1 for i in range(w))
        b_ms, b_by = bound(flops, nbytes)
        log(f"[kernels] {key} timing {shape} B={b} W={w} lengths={b}x{n0} "
            f"H=16 D=128{f' bs={bs}' if bs else ''}: kernel_ms={t_kernel:.4f} "
            f"plain_ms={t_plain if t_plain is None else round(t_plain, 4)} "
            f"library_ms={t_lib:.4f} (SDPA, staircase mask, dense bf16 K/V, "
            f"in turns, CUDA graphs) bound_ms={b_ms:.4f} ({b_by}, "
            f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB) share of bound "
            f"{b_ms / t_kernel:.3f}; "
            f"the wrapper back to back from the host {t_call:.4f} ms")
        vals = dict(ms=t_kernel, plain_ms=t_plain, bound_ms=b_ms,
                    bound_by=b_by, library_ms=t_lib, call_ms=t_call)
        if shape == "verify":
            rec.update(vals)
        else:
            rec.update({f"{shape}_{k2}": v2 for k2, v2 in vals.items()
                        if v2 is not None})
        del tensors, q, k, v, kt, vt, qt, keep
    rec["note"] = ("ms, plain_ms, bound_ms and library_ms at the verify "
                   "shape (B=8, W=5, 8 x 2043 cached tokens); verify_b1_* "
                   "the same at B=1; chunk_* at the chunk shape (B=8, "
                   "W=512, 8 x 1536 cached tokens); kernel and library "
                   "timed in turns from CUDA graph replays, best of three "
                   "windows; call_ms: the wrapper back to back from the host")
    return rec


WINDOW_ROWS = (("window_attention", 628, False, False),
               ("window_attention_q", 668, False, True),
               ("paged_window_attention", 836, True, False),
               ("paged_window_attention_q", 883, True, True))


def phase_window_kernels(records, rows=WINDOW_ROWS):
    """The window kernels of ``rows`` ((key, line of the JAX function,
    paged, cache kind); default rows 8a, 8b, 9a, 9b) against their plain
    versions at every case of WINDOW_CASES, dense and paged (each case's
    block sizes), each call twice (bitwise equal), then timed."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    for key, line, paged, quantized in rows:
        errs, worst = [], []
        for case in WINDOW_CASES:
            case = dict(case)
            sizes = case.pop("bs", (128,))
            for bs in sizes if paged else (None,):
                e, w = check_window(gen, quantized=quantized, bs=bs, **case)
                errs.append(e)
                worst.append(w)
        records[key] = time_window(key, line, 128 if paged else None,
                                   quantized, gen, errs, worst)
        gc.collect()
        torch.cuda.empty_cache()


def _dequant(codes, scale, dtype=torch.bfloat16):
    qm = importlib.import_module("paddle_tpu_torch.ops.quantized_matmul")
    return qm.dequantize_kv(codes, scale, dtype)


def check_bwd(gen, b, s, h, hkv, d, causal=True, mask=False,
              dtype=torch.bfloat16, do_scale=1.0, tol=TOL_BWD):
    """The dq and dk/dv kernels against the plain backward on the same
    inputs and the forward kernel's own o and lse, per row, and the dq
    kernel's delta against the plain delta per row; each kernel runs
    twice and must give bitwise-equal results (no atomics).  The upstream
    gradient ``do`` is standard normal times ``do_scale``.  Returns the
    inputs and ``{kernel: (max abs error, worst row ratio)}``."""
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    q = _rand((b, s, h, d), gen, dtype)
    k = _rand((b, s, hkv, d), gen, dtype)
    v = _rand((b, s, hkv, d), gen, dtype)
    do = (torch.randn((b, s, h, d), generator=gen, device="cuda")
          * do_scale).to(dtype)
    kv_mask = None
    if mask:
        kv_mask = (torch.rand((b, s), generator=gen, device="cuda") > 0.3
                   ).float()
        kv_mask[-1, 0] = 0.0     # causal query 0 of the last row: no key
    o, lse = fa._flash_cuda(q, k, v, causal, kv_mask)
    got = fa._flash_bwd_cuda(q, k, v, o, lse, do, causal, kv_mask)
    again = fa._flash_bwd_cuda(q, k, v, o, lse, do, causal, kv_mask)
    ref = fa._flash_bwd_plain(q.float(), k.float(), v.float(), o.float(),
                              lse, do.float(), causal, kv_mask)
    ref_delta = fa._flash_bwd_delta_plain(o.float(), do.float())
    delta_scale = fa._flash_bwd_delta_plain(o.float().abs(),
                                            do.float().abs())
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    res = {n: row_errors(g, r, tol, BWD_FLOOR)
           for n, g, r in zip(("dq", "dk", "dv"), got, ref)}
    d_err = (got[3] - ref_delta).abs()
    d_ratio = (d_err / delta_scale.clamp_min(1e-30)).max().item()
    delta_ok = bool((d_err <= TOL_DELTA * delta_scale).all())
    finite = all(torch.isfinite(g).all().item() for g in got)
    ok = same and finite and delta_ok and all(r[2] for r in res.values())
    log(f"[train-kernels] flash bwd B={b} S={s} H={h} Hkv={hkv} D={d} "
        f"causal={causal} mask={mask} {str(dtype)[6:]} do x {do_scale:g}: "
        + " ".join(
            f"max|{n}-plain|={r[0]:.3e} worst row {r[1]:.3e}"
            for n, r in res.items()) +
        f" (tol {tol} per row); max|delta-plain|="
        f"{d_err.max().item():.3e} worst row {d_ratio:.3e} (tol "
        f"{TOL_DELTA} x rowsum|do o|) deterministic={same} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"flash backward kernels disagree with the plain "
                         f"version at B={b} S={s} H={h} Hkv={hkv} D={d} "
                         f"{dtype}")
    errs = {"flash_bwd_dq": res["dq"][:2],
            "flash_bwd_dkv": (max(res["dk"][0], res["dv"][0]),
                              max(res["dk"][1], res["dv"][1])),
            "delta": (d_err.max().item(), d_ratio)}
    return (q, k, v, o, lse, do), errs


def phase_train_kernels(records):
    """The backward kernels at the training shape and the edge shapes,
    then timed at the training shape: each kernel alone, and the whole
    backward call (delta included) in turns with the library's."""
    from paddle_tpu_torch.ops import _build
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    F = torch.nn.functional
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    worst = {"flash_bwd_dq": [], "flash_bwd_dkv": [], "delta": []}
    fp16 = torch.float16
    cases = [(1, 48, 16, 16, 128, True, False),
             (2, 200, 16, 16, 128, True, False),
             (2, 256, 16, 4, 128, True, False),
             (2, 192, 8, 8, 64, True, False),
             (2, 200, 16, 4, 128, True, True),
             (2, 130, 4, 2, 64, False, True),
             (2, 333, 16, 16, 128, True, True),        # ragged: 333 % 128
             (2, 200, 16, 4, 128, True, False, fp16),
             (2, 256, 8, 8, 64, False, True, fp16),
             (1, 2048, 16, 1, 128, True, False),       # G = 16
             (1, 2048, 16, 16, 128, True, False),
             # train-fp16's shape: do as drawn, then an upstream gradient
             # of std 2^-6 times the default loss scale 2^15 (|do| up to
             # ~2.5e3, in fp16 range), the scaled backward the step runs
             (4, 2048, 16, 16, 128, True, False, fp16),
             (4, 2048, 16, 16, 128, True, False, fp16, 2.0 ** 15 / 2 ** 6),
             (4, 2048, 16, 16, 128, True, False)]     # the training shape
    for case in cases:
        tensors, errs = check_bwd(gen, *case[:5], causal=case[5],
                                  mask=case[6], dtype=case[7]
                                  if len(case) > 7 else torch.bfloat16,
                                  do_scale=case[8] if len(case) > 8 else 1.0)
        for key, e in errs.items():
            worst[key].append(e)
    q, k, v, o, lse, do = tensors
    b, s, h, d = q.shape
    hkv = k.shape[2]
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    delta = torch.empty((b, h, s), dtype=torch.float32, device="cuda")
    qkv = [_build.ptr(x) for x in (q, k, v)]
    dims = (b, s, h, hkv, d, 1, _build.DTYPE_CODES[q.dtype],
            _build.stream_ptr(q))
    t_dq = cuda_ms(lambda: fa.FLASH_BWD_DQ(
        *qkv, _build.ptr(o), _build.ptr(do), _build.ptr(lse), _build.ptr(None),
        _build.ptr(dq), _build.ptr(delta), *dims))
    t_dkv = cuda_ms(lambda: fa.FLASH_BWD_DKV(
        *qkv, _build.ptr(do), _build.ptr(lse), _build.ptr(delta),
        _build.ptr(None), _build.ptr(dk), _build.ptr(dv), *dims))
    t_fwd = cuda_ms(lambda: fa._flash_cuda(q, k, v, True, None))
    t_plain = cuda_ms(lambda: fa._flash_bwd_plain(q, k, v, o, lse, do, True),
                      iters=3, warmup=1)
    # yardstick: the library's attention backward (dq, dk and dv in one
    # call, its delta pass included) = forward + autograd.grad minus the
    # forward alone; timed in turns with the port's whole backward call
    # (call, library, library, call), best of three windows
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def lib_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    def lib_ms():
        return cuda_ms(lambda: torch.autograd.grad(
            lib_fwd(), (qt, kt, vt), dot)) - cuda_ms(lib_fwd)

    def call_ms():
        return cuda_ms(lambda: fa._flash_bwd_cuda(q, k, v, o, lse, do, True,
                                                  None))

    calls, libs = [], []
    for _ in range(3):
        calls.append(call_ms())
        libs += [lib_ms(), lib_ms()]
        calls.append(call_ms())
    t_call, t_lib = min(calls), min(libs)
    pairs = b * h * (s * (s + 1) // 2)          # causal (query, key) pairs
    row_bytes = b * h * s * 4                   # one f32 value a row
    dq_flops = 3 * 2 * d * pairs
    dq_bytes = 2 * (4 * q.numel() + 2 * k.numel()) + 2 * row_bytes
    dkv_flops = 4 * 2 * d * pairs
    dkv_bytes = 2 * (2 * q.numel() + 4 * k.numel()) + 2 * row_bytes
    least_ms, _ = bound(5 * 2 * d * pairs, 0)
    for key, t, flops, nbytes, line in (
            ("flash_bwd_dq", t_dq, dq_flops, dq_bytes, 133),
            ("flash_bwd_dkv", t_dkv, dkv_flops, dkv_bytes, 183)):
        b_ms, b_by = bound(flops, nbytes)
        log(f"[train-kernels] {key} timing B={b} S={s} H={h} D={d} causal: "
            f"kernel_ms={t:.4f} bound_ms={b_ms:.4f} ({b_by}, "
            f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB) share of "
            f"bound {b_ms / t:.3f}")
        records[key] = dict(
            name=key, route="cuda",
            source=f"paddle_tpu_torch/csrc/{key}.cu",
            replaces=f"paddle_tpu/ops/flash_attention.py:{line}",
            max_abs_err=max(e[0] for e in worst[key]),
            max_row_rel_err=max(e[1] for e in worst[key]), row_tol=TOL_BWD,
            ms=t, plain_ms=t_plain, bound_ms=b_ms, bound_by=b_by,
            library_ms=t_lib, call_ms=t_call,
            note="plain_ms, library_ms and call_ms each compute dq, dk and "
                 "dv together: the plain backward, "
                 "scaled_dot_product_attention's backward (forward + "
                 "autograd.grad minus the forward) and the port's whole "
                 "backward call (both kernels, delta included); the bound "
                 "counts this kernel's products (dq 3, dk/dv 4), the "
                 f"function's least work is 5 products, {least_ms:.4f} ms")
    records["flash_bwd_dq"].update(
        delta_max_abs_err=max(e[0] for e in worst["delta"]),
        delta_max_row_rel_err=max(e[1] for e in worst["delta"]),
        delta_row_tol=TOL_DELTA)
    fwd_ms, _ = bound(2 * 2 * d * pairs, 2 * 4 * q.numel() + 4 * b * h * s)
    log(f"[train-kernels] backward at the training shape: dq + dk/dv "
        f"{t_dq + t_dkv:.4f} ms, whole call (delta included) {t_call:.4f} "
        f"ms (windows {[round(x, 4) for x in calls]}), library backward "
        f"{t_lib:.4f} ms (windows {[round(x, 4) for x in libs]}), plain "
        f"{t_plain:.4f} ms; bound of the 7 products "
        f"{bound(dq_flops + dkv_flops, 0)[0]:.4f} ms, of the function's "
        f"least work (5 products) {least_ms:.4f} ms; forward kernel "
        f"{t_fwd:.4f} ms (bound {fwd_ms:.4f} ms)")
    phase_fused_ce(gen)


# attention dropout: rows 1-3's dropout forms at DROP_P, Paddle's GPT
# pretraining attention-probs dropout
DROP_P = 0.1


def check_dropout(gen, b, s, h, hkv, d, causal=True, mask=False,
                  dtype=torch.bfloat16, bwd_tol=TOL_BWD):
    """The three dropout forms against their plain versions fed the same
    (seed, offset) pair: o per row within TOL_OUT and lse within TOL_LSE
    (row 1), dq, dk, dv per row within TOL_BWD (rows 2-3, BWD_FLOOR) and
    delta within TOL_DELTA, each kernel called twice (bitwise equal).
    Returns ``{record key: (max abs error, worst row ratio)}``."""
    from paddle_tpu_torch.core import random as prandom
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    q = _rand((b, s, h, d), gen, dtype)
    k = _rand((b, s, hkv, d), gen, dtype)
    v = _rand((b, s, hkv, d), gen, dtype)
    do = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
    kv_mask = None
    if mask:
        kv_mask = (torch.rand((b, s), generator=gen, device="cuda") > 0.3
                   ).float()
        kv_mask[-1, 0] = 0.0
    pair = prandom.philox_pair("cuda", gen)
    o, lse = fa._flash_cuda(q, k, v, causal, kv_mask, DROP_P, pair)
    o2, lse2 = fa._flash_cuda(q, k, v, causal, kv_mask, DROP_P, pair)
    got = fa._flash_bwd_cuda(q, k, v, o, lse, do, causal, kv_mask, DROP_P,
                             pair)
    again = fa._flash_bwd_cuda(q, k, v, o, lse, do, causal, kv_mask, DROP_P,
                               pair)
    qf, kf, vf = q.float(), k.float(), v.float()
    ro, rlse = fa._flash_plain(qf, kf, vf, causal, kv_mask, DROP_P, pair)
    ref = fa._flash_bwd_plain(qf, kf, vf, o.float(), lse, do.float(), causal,
                              kv_mask, DROP_P, pair)
    ref_delta = fa._flash_bwd_delta_plain(o.float(), do.float())
    delta_scale = fa._flash_bwd_delta_plain(o.float().abs(),
                                            do.float().abs())
    torch.cuda.synchronize()
    err_o, worst_o, ok_o = row_errors(o, ro)
    worst_l = ((lse - rlse).abs() / rlse.abs().clamp_min(1.0)).max().item()
    res = {n: row_errors(g, r, bwd_tol, BWD_FLOOR)
           for n, g, r in zip(("dq", "dk", "dv"), got, ref)}
    d_err = (got[3] - ref_delta).abs()
    d_ratio = (d_err / delta_scale.clamp_min(1e-30)).max().item()
    same = (torch.equal(o, o2) and torch.equal(lse, lse2)
            and all(torch.equal(x, y) for x, y in zip(got, again)))
    finite = all(torch.isfinite(t).all().item() for t in (o, *got))
    ok = (ok_o and worst_l <= TOL_LSE and all(r[2] for r in res.values())
          and bool((d_err <= TOL_DELTA * delta_scale).all()) and same
          and finite)
    log(f"[dropout-kernels] p={DROP_P} B={b} S={s} H={h} Hkv={hkv} D={d} "
        f"causal={causal} mask={mask} {str(dtype)[6:]}: max|o-plain|="
        f"{err_o:.3e} worst row {worst_o:.3e} (tol {TOL_OUT}); lse worst row "
        f"{worst_l:.3e} (tol {TOL_LSE}); " + " ".join(
            f"max|{n}-plain|={r[0]:.3e} worst row {r[1]:.3e}"
            for n, r in res.items()) +
        f" (tol {bwd_tol}); delta worst row {d_ratio:.3e} (tol {TOL_DELTA}); "
        f"deterministic={same} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"flash dropout kernels disagree with their plain "
                         f"versions at B={b} S={s} H={h} Hkv={hkv} D={d} "
                         f"{dtype}")
    return {"flash_fwd_dropout": (err_o, worst_o),
            "flash_bwd_dq_dropout": res["dq"][:2],
            "flash_bwd_dkv_dropout": (max(res["dk"][0], res["dv"][0]),
                                      max(res["dk"][1], res["dv"][1]))}


def check_keep_readout(gen, b, s, h, hkv, d, dtype=torch.bfloat16):
    """Each dropout kernel's keep bits, read out exactly and held to the
    plain version's bit for bit (a few wrong bits would hide inside a
    tolerance).  q = 0 makes p uniform over the visible keys; keys are
    read a window of D at a time (a key mask shows only the window, or do
    is non-zero only on the window's queries and one query head a kv
    head), with one-hot rows so that each output element is one
    element's p, kept or exactly 0:
    - forward: v_j = e_(j - w0): o[i, d] = z(i, w0 + d) / (n (1 - p));
    - dq: k_j = e_(j - w0), v = do = e_0, o = 0 (delta = 0):
      dq[i, d] = scale z(i, w0 + d) p / (1 - p);
    - dk/dv: do_i = e_(i - w0) on one head g of each group, o = 0:
      dv[j, d] = z(w0 + d, j) / (S (1 - p)).
    Returns the number of bits compared."""
    from paddle_tpu_torch.core import random as prandom
    from paddle_tpu_torch.ops import _philox
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    g_size = h // hkv
    pair = prandom.philox_pair("cuda", gen)
    want = _philox.keep_mask(pair, b, h, s, s, DROP_P)      # [B, H, S, S]
    eye = torch.eye(d, device="cuda", dtype=dtype)
    zq = torch.zeros((b, s, h, d), device="cuda", dtype=dtype)
    e0 = torch.zeros((b, s, h, d), device="cuda", dtype=dtype)
    e0[..., 0] = 1
    k_rand = _rand((b, s, hkv, d), gen, dtype)
    fwd_bits = torch.zeros_like(want)
    dq_bits = torch.zeros_like(want)
    dkv_bits = torch.zeros_like(want)
    _, lse_all = fa._flash_cuda(zq, k_rand, k_rand, False, None)
    for w0 in range(0, s, d):
        n = min(d, s - w0)
        onehot = torch.zeros((b, s, hkv, d), device="cuda", dtype=dtype)
        onehot[:, w0:w0 + n] = eye[:n][None, :, None, :]
        window = torch.zeros((b, s), device="cuda")
        window[:, w0:w0 + n] = 1.0
        o, lse = fa._flash_cuda(zq, k_rand, onehot, False, window, DROP_P,
                                pair)
        fwd_bits[..., w0:w0 + n] = (o[..., :n] != 0).permute(0, 2, 1, 3)
        v_e0 = e0[:, :, :hkv].contiguous()
        dq = fa._flash_bwd_cuda(zq, onehot, v_e0, torch.zeros_like(zq), lse,
                                e0, False, window, DROP_P, pair)[0]
        dq_bits[..., w0:w0 + n] = (dq[..., :n] != 0).permute(0, 2, 1, 3)
        for g in range(g_size):
            do = torch.zeros_like(zq)
            for hk in range(hkv):
                do[:, w0:w0 + n, hk * g_size + g] = eye[:n][None]
            dv = fa._flash_bwd_cuda(zq, k_rand, k_rand, torch.zeros_like(zq),
                                    lse_all, do, False, None, DROP_P,
                                    pair)[2]
            # dv [B, S(keys), Hkv, D]: element d is query w0 + d of head
            # hk * G + g
            read = (dv[..., :n] != 0).permute(0, 2, 3, 1)  # [B, Hkv, n, S]
            dkv_bits[:, g::g_size, w0:w0 + n, :] = read
    torch.cuda.synchronize()
    bad = {name: int((got != want).sum().item())
           for name, got in (("forward", fwd_bits), ("dq", dq_bits),
                             ("dk/dv", dkv_bits))}
    rate = want.float().mean().item()
    ok = not any(bad.values())
    log(f"[dropout-kernels] keep bits read out of each kernel B={b} S={s} "
        f"H={h} Hkv={hkv} D={d} {str(dtype)[6:]}: {want.numel()} bits a "
        f"kernel, wrong bits {bad}, kept share {rate:.5f} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"dropout kernel keep bits differ from the plain "
                         f"version's: {bad}")
    return want.numel()


def phase_dropout_bits():
    """philox.cuh on the card: raw words against ``curand_Philox4x32_10``
    (curand_kernel.h) and against ``ops/_philox.py``, at Random123's
    known-answer counters and 4096 random ones; the check entry's keep
    bits of whole attention calls against ``keep_mask``."""
    from paddle_tpu_torch.core import random as prandom
    from paddle_tpu_torch.ops import _philox
    rng = np.random.RandomState(17)
    kat = np.array([[0] * 6, [0xFFFFFFFF] * 6,
                    [0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344,
                     0xa4093822, 0x299f31d0]], dtype=np.uint64)
    rand = rng.randint(0, 1 << 32, size=(4096, 6), dtype=np.uint64)
    inputs = np.concatenate([kat, rand]).astype(np.uint32)
    words = _philox.philox_words_cuda(
        torch.from_numpy(inputs.view(np.int32)).cuda())
    torch.cuda.synchronize()
    card = words.cpu().numpy().view(np.uint32)
    plain = np.stack([w.numpy() for w in _philox.philox4x32_10(
        *(torch.from_numpy(inputs[:, c].astype(np.int64)) for c in range(6)))],
        1).astype(np.uint32)
    same_curand = bool((card[:, :4] == card[:, 4:]).all())
    same_plain = bool((card[:, :4] == plain).all())
    kat_ok = [f"{x:08x}" for x in card[0, :4]] == [
        "6627e8d5", "e169c58d", "bc57ac4c", "9b00dbd8"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    dumps = []
    for b, h, s, sk in ((1, 4, 333, 333), (2, 16, 2048, 2048)):
        pair = prandom.philox_pair("cuda", gen)
        got = _philox.keep_bits_cuda(pair, b, h, s, sk, DROP_P)
        want = _philox.keep_mask(pair, b, h, s, sk, DROP_P)
        dumps.append((b, h, s, int((got != want).sum().item()),
                      got.float().mean().item()))
    ok = same_curand and same_plain and kat_ok and not any(
        x[3] for x in dumps)
    log(f"[dropout-bits] philox.cuh words of {len(inputs)} counters: equal "
        f"to curand_Philox4x32_10 {same_curand}, to ops/_philox.py "
        f"{same_plain}, counter 0 key 0 -> "
        f"{' '.join(f'{x:08x}' for x in card[0, :4])} ({kat_ok}); keep "
        f"bits dumped by philox_check.cu against keep_mask (B, H, S, wrong, "
        f"kept share): {dumps} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("dropout bits on the card differ")


def flash_entry_calls(q, k, v, do, causal, p, pair):
    """Zero-argument calls of rows 1-3 at q's shape with dropout ``p``
    (0: the forms without it) and the (seed, offset) ``pair``: ``fwd``,
    and ``dq`` and ``dkv`` by their C entries on that forward's o and
    lse; ``plain_fwd`` and ``plain_bwd``, the plain versions (the
    backward's computes dq, dk and dv together); ``lib_fwd`` and
    ``lib_bwd``, SDPA at ``dropout_p=p`` and its forward + backward."""
    from paddle_tpu_torch.ops import _build
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    F = torch.nn.functional
    b, s, h, d = q.shape
    o, lse = fa._flash_cuda(q, k, v, causal, None, p, pair)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    delta = torch.empty((b, h, s), dtype=torch.float32, device="cuda")
    qkv = [_build.ptr(x) for x in (q, k, v)]
    dims = (b, s, h, k.shape[2], d, int(causal), _build.DTYPE_CODES[q.dtype])
    st = _build.stream_ptr(q)
    tail = (*fa._drop_args(p, pair), st) if p else (st,)
    dq_k = fa.FLASH_BWD_DQ_DROPOUT if p else fa.FLASH_BWD_DQ
    dkv_k = fa.FLASH_BWD_DKV_DROPOUT if p else fa.FLASH_BWD_DKV
    dq_args = (*qkv, _build.ptr(o), _build.ptr(do), _build.ptr(lse),
               _build.ptr(None), _build.ptr(dq), _build.ptr(delta), *dims,
               *tail)
    dkv_args = (*qkv, _build.ptr(do), _build.ptr(lse), _build.ptr(delta),
                _build.ptr(None), _build.ptr(dk), _build.ptr(dv), *dims,
                *tail)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def lib_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              dropout_p=p)

    return dict(
        fwd=lambda: fa._flash_cuda(q, k, v, causal, None, p, pair),
        dq=lambda: dq_k(*dq_args), dkv=lambda: dkv_k(*dkv_args),
        plain_fwd=lambda: fa._flash_plain(q, k, v, causal, None, p, pair),
        plain_bwd=lambda: fa._flash_bwd_plain(q, k, v, o, lse, do, causal,
                                              None, p, pair),
        lib_fwd=lib_fwd,
        lib_bwd=lambda: torch.autograd.grad(lib_fwd(), (qt, kt, vt), dot))


def phase_dropout_kernels(records):
    """Rows 1-3's dropout forms: the bit checks, then each form against
    its plain version at the training shape and edge shapes (bf16 and
    fp16), the keep bits read out of each kernel exactly, then timed at
    the training shape in turns with the p = 0 kernels, beside the plain
    versions and SDPA with dropout_p (other bits: only a time)."""
    from paddle_tpu_torch.core import random as prandom
    phase_dropout_bits()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    fp16 = torch.float16
    worst = {}
    for args, kw in (((1, 48, 16, 16, 128), {}),
                     ((2, 333, 16, 4, 128), dict(mask=True)),
                     ((2, 200, 8, 2, 64), dict(causal=False, mask=True)),
                     ((2, 256, 8, 8, 64), dict(dtype=fp16)),
                     ((1, 2048, 16, 1, 128), {}),             # G = 16
                     ((4, 2048, 16, 16, 128), dict(dtype=fp16)),
                     ((4, 2048, 16, 16, 128), {})):          # training shape
        for key, e in check_dropout(gen, *args, **kw).items():
            worst.setdefault(key, []).append(e)
    n_bits = sum(check_keep_readout(gen, *args, **kw) for args, kw in (
        ((2, 333, 4, 2, 128), {}), ((1, 200, 4, 1, 64), dict(dtype=fp16)),
        ((2, 2048, 16, 16, 128), {})))
    log(f"[dropout-kernels] {n_bits} keep bits a kernel read out, all equal "
        f"to the plain version's")

    b, s, h, d = 4, 2048, 16, 128
    q, k, v, do = (_rand((b, s, h, d), gen) for _ in range(4))
    pair = prandom.philox_pair("cuda", gen)
    c0 = flash_entry_calls(q, k, v, do, True, 0.0, pair)
    cp = flash_entry_calls(q, k, v, do, True, DROP_P, pair)

    def turns(plain_fn, drop_fn, iters=50):
        """(p = 0 ms, dropout ms): plain, drop, drop, plain, twice; best
        window of each."""
        a, z = [], []
        for _ in range(2):
            a.append(cuda_ms(plain_fn, iters=iters))
            z += [cuda_ms(drop_fn, iters=iters) for _ in range(2)]
            a.append(cuda_ms(plain_fn, iters=iters))
        return min(a), min(z)

    fwd0, fwdp = turns(c0["fwd"], cp["fwd"])
    dq0, dqp = turns(c0["dq"], cp["dq"])
    dkv0, dkvp = turns(c0["dkv"], cp["dkv"])
    t_plain_f = cuda_ms(cp["plain_fwd"], iters=3, warmup=1)
    t_plain_b = cuda_ms(cp["plain_bwd"], iters=3, warmup=1)
    lib_f = min(cuda_ms(cp["lib_fwd"], iters=50) for _ in range(2))
    lib_b = min(cuda_ms(cp["lib_bwd"]) - cuda_ms(cp["lib_fwd"])
                for _ in range(2))
    pairs = b * h * (s * (s + 1) // 2)
    calls = pairs // 8                       # Philox calls a pass
    row_bytes = b * h * s * 4
    rows = (("flash_fwd_dropout", "flash_fwd", fwdp, fwd0, 4 * d * pairs,
             2 * (2 * q.numel() + k.numel() + v.numel()) + row_bytes + 16,
             t_plain_f, lib_f, 72),
            ("flash_bwd_dq_dropout", "flash_bwd_dq", dqp, dq0,
             3 * 2 * d * pairs,
             2 * (4 * q.numel() + 2 * k.numel()) + 2 * row_bytes + 16,
             t_plain_b, lib_b, 133),
            ("flash_bwd_dkv_dropout", "flash_bwd_dkv", dkvp, dkv0,
             4 * 2 * d * pairs,
             2 * (2 * q.numel() + 4 * k.numel()) + 2 * row_bytes + 16,
             t_plain_b, lib_b, 183))
    for key, src, t, t0, flops, nbytes, t_plain, t_lib, line in rows:
        b_ms, b_by = bound(flops, nbytes)
        log(f"[dropout-kernels] {key} timing B={b} S={s} H={h} D={d} causal "
            f"p={DROP_P}: kernel_ms={t:.4f} (p = 0 in turns {t0:.4f}, "
            f"+{t - t0:.4f} ms for {calls / 1e6:.1f} M Philox calls) "
            f"bound_ms={b_ms:.4f} ({b_by}; share {b_ms / t:.3f}) plain_ms="
            f"{t_plain:.4f} library_ms={t_lib:.4f} (SDPA dropout_p={DROP_P}"
            f"{'' if key == 'flash_fwd_dropout' else ' backward'})")
        records[key] = dict(
            name=key, route="cuda",
            source=f"paddle_tpu_torch/csrc/{src}.cu",
            replaces=f"paddle_tpu/ops/flash_attention.py:{line}",
            max_abs_err=max(e[0] for e in worst[key]),
            max_row_rel_err=max(e[1] for e in worst[key]),
            row_tol=TOL_OUT if key == "flash_fwd_dropout" else TOL_BWD,
            ms=t, plain_ms=t_plain, bound_ms=b_ms, bound_by=b_by,
            library_ms=t_lib, p0_ms=t0, drop_p=DROP_P,
            philox_calls=calls, keep_bits_read=n_bits,
            note=f"{src}'s dropout form (its C entry {key}); the TPU "
                 f"kernel takes no dropout, the JAX package drops in its "
                 f"composite (nn/functional/attention.py:40-42); p0_ms is "
                 f"the p = 0 kernel in turns; library_ms is SDPA with "
                 f"dropout_p={DROP_P} (other bits, a time only)"
                 + ("" if key == "flash_fwd_dropout" else
                    "; plain_ms and library_ms compute dq, dk and dv "
                    "together"))


def phase_fused_ce(gen):
    """The blocked cross-entropy of the train step (N = 4 x 2048 rows,
    hidden 2048, vocab 50304, bf16 operands as under AMP) against the
    full f32 logits, and its time."""
    tce = importlib.import_module("paddle_tpu_torch.ops.fused_cross_entropy")
    n, hd, vocab = 4 * 2048, 2048, 50304
    hidden = _rand((n, hd), gen)
    weight = (torch.randn((vocab, hd), generator=gen, device="cuda")
              * 0.02).bfloat16()
    labels = torch.randint(0, vocab, (n,), generator=gen, device="cuda")
    labels[::7] = -100
    g = torch.rand(n, generator=gen, device="cuda")
    h1, w1 = hidden.clone().requires_grad_(), weight.clone().requires_grad_()
    loss = tce.fused_linear_cross_entropy(h1, w1, labels, reduction="none")
    (loss * g).sum().backward()
    # reference: full logits in f32 (no TF32), autograd
    h2 = hidden.float().requires_grad_()
    w2 = weight.float().requires_grad_()
    ref = torch.nn.functional.cross_entropy(h2 @ w2.t(), labels,
                                            ignore_index=-100,
                                            reduction="none")
    (ref * g).sum().backward()
    torch.cuda.synchronize()
    loss_err = ((loss - ref).abs() / ref.abs().clamp_min(1.0)).max().item()
    gerr = [((a.grad.float() - r.grad).abs().max() / r.grad.abs().max()
             ).item() for a, r in ((h1, h2), (w1, w2))]
    ok = loss_err <= TOL_CE_LOSS and max(gerr) <= TOL_CE_GRAD
    del h2, w2, ref
    fwd_ms = cuda_ms(lambda: tce.fused_linear_cross_entropy(hidden, weight,
                                                            labels),
                     iters=5, warmup=1)

    def fwd_bwd():
        tce.fused_linear_cross_entropy(h1, w1, labels).backward()

    both_ms = cuda_ms(fwd_bwd, iters=5, warmup=1)
    log(f"[train-kernels] fused CE N={n} H={hd} V={vocab} bf16 operands, "
        f"TF32 products: loss worst row {loss_err:.3e} (tol {TOL_CE_LOSS}), "
        f"d(hidden) {gerr[0]:.3e}, d(weight) {gerr[1]:.3e} of max "
        f"(tol {TOL_CE_GRAD}); forward_ms={fwd_ms:.3f} "
        f"forward+backward_ms={both_ms:.3f} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("fused cross-entropy disagrees with full logits")


# ---- int8 matmul (row 10) and decode megakernel (row 11) ------------------

# the four block projections of gpt3-1.3b as (K, N): qkv, out, up, down
QMM_SHAPES = [(2048, 6144), (2048, 2048), (2048, 8192), (8192, 2048)]


def qmm_operands(gen, m, k, n, mode="int8"):
    """int8 (or ``mode`` 'fp8': e4m3) operands as ``quantized_matmul``
    makes them on the card from bf16 x ``[M, K]`` and w ``[K, N]``:
    row-scaled codes of x, the weight codes transposed ``[N, K]`` with one
    scale per column."""
    qm = importlib.import_module("paddle_tpu_torch.ops.quantized_matmul")
    x = _rand((m, k), gen)
    w = (torch.randn((k, n), generator=gen, device="cuda") * 0.02).bfloat16()
    qx, sx = qm.quantize_channel(x, axis=1, dtype=mode)
    qw_t, sw_t = qm.quantize_channel(w.t(), axis=1, dtype=mode)
    return qx.contiguous(), qw_t.contiguous(), sx, sw_t.reshape(1, n)


# edge widths: one strip pair, the N = 384 edge, and the long down product
# (which splits K at M = 512), each at decode and at a prefill bucket
QMM_EDGE_SHAPES = [(128, 128), (8192, 2048), (256, 384)]


def qmm_exact(qm, qx, qw_t, sx, sw, what):
    """The kernel's f32, bf16 and fp16 outputs must EQUAL the plain
    version's; returns the largest difference (0.0)."""
    ref32 = qm._qmm_plain(qx, qw_t.t(), sx, sw, torch.float32)
    err = 0.0
    for out in (torch.float32, torch.bfloat16, torch.float16):
        got = qm._qmm_cuda(qx, qw_t, sx, sw, out)
        torch.cuda.synchronize()
        want = ref32.to(out)
        err = max(err, (got.float() - want.float()).abs().max().item())
        if not torch.equal(got, want):
            raise SystemExit(f"quantized_matmul kernel differs from the "
                             f"plain version at {what} ({out}): max|diff| "
                             f"{err:.3e}")
    return err


def qmm_plan_text(qm, m, k, n, f8=False):
    plan = qm._qmm_plan(m, n, k, torch.cuda.get_device_properties(0)
                        .multi_processor_count,
                        bn=128 if f8 and m > 16 else None)
    if plan["regime"] == "decode":
        return (f"decode regime: {plan['blocks']} blocks, up to "
                f"{plan['pieces']} pieces a strip")
    return (f"prefill regime: {plan['blocks']} blocks, tiles of "
            f"{64 if m <= 64 else 128} x {plan['bn']}, {plan['splits']} "
            f"k split{'s' if plan['splits'] > 1 else ''}")


def phase_qmm_kernels(records):
    """Row 10 at M in {8, 512, 4096} (decode, a prefill bucket, a chunk
    tick's 8 x 512 rows) over the four projections, and the edge widths
    ``QMM_EDGE_SHAPES`` at M in {8, 512}: the kernel's f32, bf16 and fp16
    outputs must EQUAL the plain version's (exact int32 sums, the same f32
    rescale), with the regime and split each shape took.  The twelve
    projection shapes are then timed beside the plain version,
    ``torch._int_mm`` + the same rescale (a yardstick the port never
    calls; cuBLASLt takes M > 16 only, so at M=8 the codes are padded to
    32 rows and the product cut back) and the bound: the larger of 2 M N
    K over the int8 peak and M K + K N + 4 (M + N) + 2 M N bytes over the
    memory rate.  Device ms from torch.profiler (the call's kernels);
    call_ms from CUDA events around back-to-back calls (host wrapper
    included)."""
    qm = importlib.import_module("paddle_tpu_torch.ops.quantized_matmul")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    for m in (8, 512):
        for k, n in QMM_EDGE_SHAPES:
            qx, qw_t, sx, sw = qmm_operands(gen, m, k, n)
            qmm_exact(qm, qx, qw_t, sx, sw, f"M={m} K={k} N={n}")
            log(f"[kernels] quantized_matmul edge M={m} K={k} N={n}: kernel "
                f"== plain exactly (f32, bf16, fp16 out); "
                f"{qmm_plan_text(qm, m, k, n)}")
    shapes = []
    for m in (8, 512, 4096):
        for k, n in QMM_SHAPES:
            qx, qw_t, sx, sw = qmm_operands(gen, m, k, n)
            err = qmm_exact(qm, qx, qw_t, sx, sw, f"M={m} K={k} N={n}")
            t_kernel = device_ms(lambda: qm._qmm_cuda(
                qx, qw_t, sx, sw, torch.bfloat16), iters=50)
            t_call = min(cuda_ms(lambda: qm._qmm_cuda(
                qx, qw_t, sx, sw, torch.bfloat16), iters=100, warmup=5)
                for _ in range(3))
            t_plain = device_ms(lambda: qm._qmm_plain(
                qx, qw_t.t(), sx, sw, torch.bfloat16), iters=3, warmup=1)
            # cuBLASLt's int8 product takes M > 16 only: at decode the
            # activation codes are padded to 32 rows and the product cut
            # back, the same function
            qx_lib = qx if m > 16 else torch.cat(
                [qx, qx.new_zeros((32 - m, k))])

            def lib():
                return (torch._int_mm(qx_lib, qw_t.t())[:m].float() * sx
                        * sw).to(torch.bfloat16)
            lib_exact = torch.equal(
                lib(), qm._qmm_cuda(qx, qw_t, sx, sw, torch.bfloat16))
            t_lib = device_ms(lib, iters=50)
            ops = 2 * m * n * k
            nbytes = m * k + k * n + 4 * (m + n) + 2 * m * n
            b_ms, b_by = bound(ops, nbytes, PEAK_INT8_OPS)
            plan = qmm_plan_text(qm, m, k, n)
            log(f"[kernels] quantized_matmul M={m} K={k} N={n}: kernel == "
                f"plain exactly (f32, bf16, fp16 out); {plan}; device ms: "
                f"kernel_ms={t_kernel:.4f} plain_ms={t_plain:.4f} library_ms="
                f"{t_lib:.4f} (torch._int_mm"
                f"{' on the codes padded to 32 rows' if m <= 16 else ''} + "
                f"rescale, equal: {lib_exact}) share of bound "
                f"{b_ms / t_kernel:.3f}"
                + f" bound_ms={b_ms:.4f} ({b_by}, {ops / 1e9:.2f} GOP, "
                f"{nbytes / 1e6:.2f} MB); call_ms={t_call:.4f} (a call back "
                f"to back with its host wrapper, CUDA events)")
            shapes.append(dict(m=m, k=k, n=n, ms=t_kernel, plain_ms=t_plain,
                               library_ms=t_lib, bound_ms=b_ms, bound_by=b_by,
                               call_ms=t_call, max_abs_err=err, plan=plan))
            del qx, qw_t, sx, sw
    head = shapes[0]                     # decode's qkv product, M=8
    records["quantized_matmul"] = dict(
        name="quantized_matmul", route="cuda",
        source="paddle_tpu_torch/csrc/quantized_matmul.cu",
        replaces="paddle_tpu/ops/quantized_matmul.py:181",
        max_abs_err=max(sh["max_abs_err"] for sh in shapes),
        max_row_rel_err=0.0, row_tol=0.0,
        **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms")},
        shapes=shapes,
        note="device time per call (torch.profiler: the calls' kernels, "
             "without the host's launch gaps; call_ms: CUDA events around "
             "back-to-back calls, host wrapper included); ms, plain_ms, "
             "bound_ms, library_ms at the decode qkv product (M=8, K=2048, "
             "N=6144), where torch._int_mm takes no M <= 16: library_ms "
             "pads the codes to 32 rows; shapes holds all twelve; the "
             "kernel must equal the plain version exactly (max_abs_err 0) "
             "in f32, bf16 and fp16, at the edge widths too")


# kernels-f8: the e4m3 forms of rows 5, 7, 8b, 9b and 10.  None has a
# TPU kernel: the JAX package's fp8 paths ride its composites, whose
# lines the records name
F8_WINDOW_ROWS = (("window_attention_f8", 746, False, "fp8"),
                  ("paged_window_attention_f8", 984, True, "fp8"))
PEAK_FP8_FLOPS = 1979e12
# the e4m3 matmul sums its exact f32 products in f32, 128 at a time on the
# tensor cores and then in registers, where the plain version sums them in
# cuBLAS's f32 order: f32 rounding of sums of up to 8192 terms, each row
# held to its own largest |y| (its 16-bit outputs must be its own f32
# output rounded)
TOL_QMM_F8 = 1e-3   # x max|plain y| of each row, f32 output


def qmm_f8_check(qm, qx, qw_t, sx, sw, what):
    """Row 10f against the plain version: f32 output within TOL_QMM_F8 of
    each row's max |y|, two calls bitwise equal, bf16 and fp16 outputs
    the f32 output rounded.  Returns (max |diff|, worst row ratio)."""
    ref = qm._qmm_plain(qx, qw_t.t(), sx, sw, torch.float32)
    got = qm._qmm_cuda(qx, qw_t, sx, sw, torch.float32)
    again = qm._qmm_cuda(qx, qw_t, sx, sw, torch.float32)
    rounded = all(torch.equal(qm._qmm_cuda(qx, qw_t, sx, sw, out),
                              got.to(out))
                  for out in (torch.bfloat16, torch.float16))
    torch.cuda.synchronize()
    err = (got - ref).abs().amax(-1)
    worst = (err / ref.abs().amax(-1).clamp_min(1e-30)).max().item()
    ok = (worst <= TOL_QMM_F8 and torch.equal(got, again) and rounded
          and bool(torch.isfinite(got).all().item()))
    if not ok:
        raise SystemExit(f"quantized_matmul_f8 kernel disagrees with the "
                         f"plain version at {what}: worst row "
                         f"{worst:.3e} (tol {TOL_QMM_F8}), repeatable="
                         f"{torch.equal(got, again)}, 16-bit outputs the "
                         f"f32 output rounded={rounded}")
    return err.max().item(), worst


def qmm_f8_graph(qm, qx, qw_t, sx, sw, what):
    """A CUDA-graph replay of row 10f equals the eager call bit for bit
    (the split sums added in piece order)."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        eager = qm._qmm_cuda(qx, qw_t, sx, sw, torch.bfloat16)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            out = qm._qmm_cuda(qx, qw_t, sx, sw, torch.bfloat16)
    torch.cuda.current_stream().wait_stream(stream)
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(out, eager):
            raise SystemExit(f"quantized_matmul_f8 graph replay differs "
                             f"from eager at {what}")
    log(f"[kernels-f8] quantized_matmul_f8 {what}: 3 graph replays equal "
        f"to eager bit for bit")


def scaled_mm_lib(qx, qw_t, sx, sw, m):
    """The library yardstick of row 10f (the port never calls it):
    ``torch._scaled_mm`` with row and column scales into bf16; cuBLASLt
    wants M a multiple of 16, so decode rows are padded with zero codes
    (scale 1) and the product cut back.  None (with the reason logged)
    where this PyTorch has no row-wise e4m3 scaling."""
    pad = -m % 16
    a, sa = qx, sx
    if pad:
        a = torch.zeros((m + pad, qx.shape[1]), dtype=qx.dtype,
                        device=qx.device)
        a[:m] = qx
        sa = torch.ones((m + pad, 1), dtype=sx.dtype, device=sx.device)
        sa[:m] = sx

    def lib():
        return torch._scaled_mm(a, qw_t.t(), scale_a=sa, scale_b=sw,
                                out_dtype=torch.bfloat16)[:m]
    try:
        lib()
    except RuntimeError as err:
        log(f"[kernels-f8] torch._scaled_mm with row-wise scales refused "
            f"here: {str(err).splitlines()[0]}")
        return None
    return lib


def phase_qmm_f8(records):
    """Row 10f at the twelve gpt3-1.3b shapes (M in {8, 512, 4096} over
    the four projections) and the edge widths at M in {8, 512}, through
    ``qmm_f8_check``; graph replays at M = 8 (a strip split over blocks)
    and M = 512 (split-K); the twelve shapes timed on the device clock
    beside the plain version and ``torch._scaled_mm``; bound: the larger
    of 2 M N K over the e4m3 peak and M K + K N + 4 (M + N) + 2 M N bytes
    over the memory rate."""
    qm = importlib.import_module("paddle_tpu_torch.ops.quantized_matmul")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    errs, worst = [], []
    for m in (8, 512):
        for k, n in QMM_EDGE_SHAPES:
            ops = qmm_operands(gen, m, k, n, "fp8")
            e, w = qmm_f8_check(qm, *ops, f"M={m} K={k} N={n}")
            errs.append(e)
            worst.append(w)
            log(f"[kernels-f8] quantized_matmul_f8 edge M={m} K={k} N={n}: "
                f"worst row {w:.3e} (tol {TOL_QMM_F8}); "
                f"{qmm_plan_text(qm, m, k, n, f8=True)}")
    for m in (8, 512):
        qmm_f8_graph(qm, *qmm_operands(gen, m, 8192, 2048, "fp8"),
                     f"M={m} K=8192 N=2048 "
                     f"({qmm_plan_text(qm, m, 8192, 2048, f8=True)})")
    shapes = []
    for m in (8, 512, 4096):
        for k, n in QMM_SHAPES:
            qx, qw_t, sx, sw = qmm_operands(gen, m, k, n, "fp8")
            e, w = qmm_f8_check(qm, qx, qw_t, sx, sw, f"M={m} K={k} N={n}")
            errs.append(e)
            worst.append(w)
            t_kernel = device_ms(lambda: qm._qmm_cuda(
                qx, qw_t, sx, sw, torch.bfloat16), iters=50)
            t_plain = device_ms(lambda: qm._qmm_plain(
                qx, qw_t.t(), sx, sw, torch.bfloat16), iters=3, warmup=1)
            lib = scaled_mm_lib(qx, qw_t, sx, sw, m)
            t_lib = lib_diff = None
            if lib is not None:
                t_lib = device_ms(lib, iters=50)
                ref = qm._qmm_cuda(qx, qw_t, sx, sw, torch.float32)
                lib_diff = ((lib().float() - ref).abs().max()
                            / ref.abs().max()).item()
            ops = 2 * m * n * k
            nbytes = m * k + k * n + 4 * (m + n) + 2 * m * n
            b_ms, b_by = bound(ops, nbytes, PEAK_FP8_FLOPS)
            plan = qmm_plan_text(qm, m, k, n, f8=True)
            log(f"[kernels-f8] quantized_matmul_f8 M={m} K={k} N={n}: worst "
                f"row {w:.3e} (tol {TOL_QMM_F8}); {plan}; device ms: "
                f"kernel_ms={t_kernel:.4f} plain_ms={t_plain:.4f} "
                f"library_ms={t_lib if t_lib is None else round(t_lib, 4)} "
                f"(torch._scaled_mm, row/column scales"
                f"{', codes padded to 16 rows' if m % 16 else ''}; max|diff| "
                f"to the kernel / max|y| {lib_diff}) bound_ms={b_ms:.4f} "
                f"({b_by}, {ops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB) "
                f"share of bound {b_ms / t_kernel:.3f}")
            shapes.append(dict(m=m, k=k, n=n, ms=t_kernel, plain_ms=t_plain,
                               library_ms=t_lib, bound_ms=b_ms, bound_by=b_by,
                               max_abs_err=e, max_row_rel_err=w, plan=plan))
            del qx, qw_t, sx, sw
    head = shapes[0]
    records["quantized_matmul_f8"] = dict(
        name="quantized_matmul_f8", route="cuda",
        source="paddle_tpu_torch/csrc/quantized_matmul_f8.cu",
        replaces="paddle_tpu/ops/quantized_matmul.py:153",
        max_abs_err=max(errs), max_row_rel_err=max(worst),
        row_tol=TOL_QMM_F8,
        **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms")},
        shapes=shapes,
        note="no TPU kernel: the JAX package's fp8 compute is its "
             "composite _qmm_composite (replaces names it); device time "
             "per call (torch.profiler); ms, plain_ms, bound_ms, "
             "library_ms at the decode qkv product (M=8, K=2048, N=6144); "
             "shapes holds all twelve; errors of the f32 output against "
             "the plain version, per row")


def retime_5f(gen, records):
    """Rows 5 (int8) and 5f (e4m3) again at their timing shape (8 full
    slots of 2048 positions, 16 heads of 128), as CUDA-graph replays of
    200 calls in turns (``in_turns``, 5 rounds, best of each), each with
    its share of its bound (both read one byte a cached value).  Kept as
    ``in_turns_ms`` beside each row's own timing."""
    da = importlib.import_module("paddle_tpu_torch.ops.decode_attention")
    args = [check_decode(gen, FULL, 2048, 16, 16, 128, quantized)[0]
            for quantized in (True, "fp8")]
    times = in_turns([lambda a=a: da.decode_attention(*a) for a in args],
                     200, rounds=5)
    for key, t in zip(("decode_attention_q", "decode_attention_f8"), times):
        rec = records[key]
        rec["in_turns_ms"] = t
        log(f"[kernels-f8] {key} in turns with the other: {t:.4f} ms "
            f"(own timing {rec['ms']:.4f} ms), {rec['bound_ms'] / t:.4f} of "
            f"its bound {rec['bound_ms']:.4f} ms")
    del args


def phase_f8_kernels(records):
    """kernels-f8: rows 5f and 7f (dense and paged decode over e4m3
    caches) at the cases of rows 5 and 7, rows 8bf and 9bf (the window
    kernels over e4m3 caches) at every WINDOW_CASES case, each held to
    TOL_OUT per row against its plain version fed the same codes and
    timed as its int8 row (library: SDPA over the dequantized bf16
    cache), and row 10f (``phase_qmm_f8``).  The JAX functions named in
    ``replaces`` are the composites JAX runs for fp8."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    decode_rows(gen, records, (("decode_attention_f8", 268, "fp8"),))
    retime_5f(gen, records)
    paged_rows(gen, records, (("paged_decode_attention_f8", 451, "fp8"),))
    phase_window_kernels(records, F8_WINDOW_ROWS)
    for key in ("decode_attention_f8", "paged_decode_attention_f8",
                "window_attention_f8", "paged_window_attention_f8"):
        records[key]["note"] = (records[key].get("note", "") + "; " if
                                records[key].get("note") else "") + (
            "no TPU kernel: replaces names the JAX composite that JAX runs "
            "for fp8 caches")
    phase_qmm_f8(records)
    gc.collect()
    torch.cuda.empty_cache()


def mega_block(gen, heads, hkv, d=None, h=2048, f=8192):
    """One GPTBlock at gpt3-1.3b widths (or the given heads, kv heads)
    with random weights (normal 0.02) and random biases and LayerNorm
    parameters, so that every term of the layer step is exercised."""
    from paddle_tpu_torch.models import GPTConfig
    from paddle_tpu_torch.models.gpt import GPTBlock
    cfg = GPTConfig(hidden_size=h, num_layers=24, num_heads=heads,
                    num_kv_heads=hkv, ffn_hidden_size=f, max_seq_len=2048)
    blk = GPTBlock(cfg, device="cuda", dtype=torch.bfloat16, generator=gen)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            if p.dim() == 1:
                base = 1.0 if name.endswith("weight") else 0.0
                p.copy_(base + 0.05 * torch.randn(p.shape, generator=gen,
                                                  device="cuda"))
    return blk.eval()


def mega_inputs(gen, blk, lengths, quantized, bs=None, cap=2048,
                spare=2):
    """x ``[B, H]`` and the cache of one layer holding ``lengths`` tokens
    per slot before the new one: dense ``[B, cap, Hkv, D]``, or (``bs``)
    a shuffled pool read through tables of ``cap / bs`` entries, a slot of
    length 0 on the null block."""
    cfg = blk.attn.cfg
    hkv, d = cfg.num_kv_heads, cfg.head_dim
    x = _rand((len(lengths), cfg.hidden_size), gen)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    if bs is None:
        k = _rand((len(lengths), cap, hkv, d), gen)
        v = _rand((len(lengths), cap, hkv, d), gen)
        ks = vs = None
        if quantized:
            (k, ks), (v, vs) = _quantize(k), _quantize(v)
        return x, k, v, None, lens, ks, vs
    _, k, v, tables, _, ks, vs = paged_inputs(
        gen, lengths, bs, cfg.num_heads, hkv, d, quantized, mb=cap // bs,
        spare=spare)
    return x, k, v, tables, lens, ks, vs


def _mega_call(blk, tensors, plain=False):
    mk = importlib.import_module("paddle_tpu_torch.ops.decode_megakernel")
    x, k, v, tables, lens, ks, vs = tensors
    w = blk._megakernel_weights()
    if plain:        # f32 in, so the outputs keep f32 (no final rounding)
        return mk._mega_plain(x.float(), w, k, v, lens, ks, vs, tables,
                              eps=blk.ln_1.epsilon)
    if tables is None:
        return mk.decode_layer_step(x, w, k, v, lens, ks, vs,
                                    eps=blk.ln_1.epsilon)
    return mk.decode_layer_step_paged(x, w, k, v, tables, lens, ks, vs,
                                      eps=blk.ln_1.epsilon)


def check_mega(gen, blk, lengths, quantized, bs=None, cap=2048):
    """The megakernel against ``_mega_plain`` on the same bf16 inputs:
    each x_out row (one slot) and each new k/v row (one slot, kv head)
    within TOL_OUT of its own largest |value|."""
    tensors = mega_inputs(gen, blk, lengths, quantized, bs, cap)
    got = _mega_call(blk, tensors)
    ref = _mega_call(blk, tensors, plain=True)
    torch.cuda.synchronize()
    res = [row_errors(g, r) for g, r in zip(got, ref)]
    ok = all(r[2] for r in res) and all(torch.isfinite(g).all().item()
                                        for g in got)
    cfg = blk.attn.cfg
    log(f"[kernels] megakernel {'paged' if bs else 'dense'}"
        f"{' int8' if quantized else ''} B={len(lengths)} H={cfg.hidden_size}"
        f" heads={cfg.num_heads} Hkv={cfg.num_kv_heads} D={cfg.head_dim}"
        f"{f' bs={bs}' if bs else f' cap={cap}'} lengths={lengths}: " +
        " ".join(f"{n} max|diff|={r[0]:.3e} worst row {r[1]:.3e}"
                 for n, r in zip(("x_out", "k_new", "v_new"), res)) +
        f" (tol {TOL_OUT} per row) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"decode megakernel disagrees with its plain "
                         f"version (paged={bs is not None}, int8={quantized})")
    return tensors, max(r[0] for r in res), max(r[1] for r in res)


def time_mega(key, blk, tensors, errs, worst):
    """One megakernel at the serving shape (B=8, 8 x 2048 attended
    positions: 2047 cached + the new one) beside its plain version and the
    port's composed layer step on the same inputs (``GPTBlock.
    forward_decode(_paged)``: the cache write, the decode kernel and some
    forty other launches; no single library call computes the layer), and
    its bound: the layer's weights and the cached k/v (codes and scales)
    read once, x, x_out and the new k/v once."""
    x, k, v, tables, lens, ks, vs = tensors
    cfg = blk.attn.cfg
    # one replay of a CUDA graph of 20 launches a window, best of three
    # (a profiler session can drop kernel events)
    t_kernel = in_turns([lambda: _mega_call(blk, tensors)], 20)[0]
    t_call = min(cuda_ms(lambda: _mega_call(blk, tensors), iters=20,
                         warmup=3) for _ in range(3))
    t_plain = device_ms(lambda: _mega_call(blk, tensors, plain=True),
                        iters=3, warmup=1)

    def composed():
        with torch.no_grad():
            if tables is None:
                return blk.forward_decode(x[:, None], k, v, lens, ks, vs)
            return blk.forward_decode_paged(x[:, None], k, v, tables, lens,
                                            ks, vs)
    t_comp = device_ms(composed)
    t_comp_call = cuda_ms(composed, iters=20, warmup=3)
    b, hkv, d = x.shape[0], cfg.num_kv_heads, cfg.head_dim
    npos = int((torch.clamp(lens, max=2047) if tables is None
                else lens).sum().item())
    w_bytes = sum(t.numel() * t.element_size()
                  for t in blk._megakernel_weights())
    kv_bytes = 2 * npos * hkv * d * (1 if ks is not None else 2) + \
        (2 * 4 * npos * hkv if ks is not None else 0)
    nbytes = (w_bytes + kv_bytes + 2 * 2 * x.numel() + 2 * 2 * b * hkv * d
              + 4 * b + (4 * tables.numel() if tables is not None else 0))
    mat = sum(t.numel() for t in blk._megakernel_weights() if t.dim() == 2)
    flops = 2 * b * mat + 4 * cfg.num_heads * d * (npos + b)
    b_ms, b_by = bound(flops, nbytes)
    log(f"[kernels] {key} timing B={b} lengths={b}x{npos // b} H="
        f"{cfg.hidden_size} D={d}: device ms: kernel_ms={t_kernel:.4f} "
        f"plain_ms={t_plain:.4f} composed_layer_step_ms={t_comp:.4f} (the "
        f"port's GPTBlock.forward_decode"
        f"{'_paged' if tables is not None else ''}) bound_ms={b_ms:.4f} "
        f"({b_by}, {nbytes / 1e6:.2f} MB: weights {w_bytes / 1e6:.2f}, cache "
        f"{kv_bytes / 1e6:.2f}); calls back to back with their host code "
        f"(CUDA events): kernel {t_call:.4f} ms, composed {t_comp_call:.4f} "
        f"ms")
    return dict(
        name=key, route="cuda", source=f"paddle_tpu_torch/csrc/{key}.cu",
        replaces="paddle_tpu/ops/decode_megakernel.py:197",
        max_abs_err=max(errs), max_row_rel_err=max(worst), row_tol=TOL_OUT,
        ms=t_kernel, plain_ms=t_plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, composed_ms=t_comp, call_ms=t_call,
        composed_call_ms=t_comp_call,
        note="one layer's decode step at B=8, 8 x 2048 attended positions; "
             "ms: CUDA-graph replays of 20 launches, best of three windows; "
             "no single PyTorch call computes it (library_ms null); "
             "composed_ms is the port's composed layer step on the same "
             "inputs (torch.profiler device time); *call_ms: CUDA events "
             "around back-to-back calls, host code included")


def log_partition(blk, slots=(1, 8, 16)):
    """Each product's split over the grid (``_partition``: pieces, tiles
    and bytes a block) and the attention items at each slot count."""
    mk = importlib.import_module("paddle_tpu_torch.ops.decode_megakernel")
    cfg = blk.attn.cfg
    h, f = cfg.hidden_size, cfg.ffn_hidden_size
    kvd = cfg.num_kv_heads * cfg.head_dim
    grid = torch.cuda.get_device_properties(0).multi_processor_count
    for what, (kk, n) in (("qkv", (h, h + 2 * kvd)), ("out", (h, h)),
                          ("up", (h, f)), ("down", (f, h))):
        runs = mk._partition(kk, n, grid)
        tiles = [sum((k1 - k0) // 64 for _, k0, k1 in r) for r in runs]
        log(f"[kernels] megakernel partition {what} ({kk} x {n}) over "
            f"{grid} blocks: {sum(len(r) for r in runs)} pieces "
            f"(at most {max(len(r) for r in runs)} a block, "
            f"{mk._part(kk, n, grid).parts} partials a chunk at most), "
            f"{min(tiles)}-{max(tiles)} tiles = "
            f"{min(tiles) * 8192 / 1e3:.1f}-{max(tiles) * 8192 / 1e3:.1f} KB "
            f"a block")
    rt = -(-cfg.num_heads // cfg.num_kv_heads // 16)
    for b in slots:
        pairs = b * cfg.num_kv_heads * rt
        np_ = max(1, min(mk._MAX_PARTS, grid // pairs))
        log(f"[kernels] megakernel attention at B={b}: {pairs} (slot, kv "
            f"head, 16-head tile) pairs x {np_} position parts = "
            f"{pairs * np_} items over {grid} blocks")


def phase_mega_kernels(records):
    """Row 11 in its four instantiations at gpt3-1.3b widths (B=8): edge
    lengths (0, 1, a block edge and one past, cap - 1 and cap for the
    dense cache, a slot of length 0 on the null block of the paged one),
    blocks of 128 and 16, G = 16 (16 heads over one kv head) and D=64,
    then each timed at 8 x 2048."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    mha = mega_block(gen, 16, 16)
    g16 = mega_block(gen, 16, 1)
    d64 = mega_block(gen, 32, 32)
    dense_lens = [0, 1, 127, 128, 2047, 2048, 1000, 129]
    paged_lens = [0, 1, 128, 2047, 256, 1537, 64, 129]
    for key, paged, quantized in (
            ("decode_megakernel", False, False),
            ("decode_megakernel_q", False, True),
            ("paged_decode_megakernel", True, False),
            ("paged_decode_megakernel_q", True, True)):
        errs, worst = [], []
        cases = [(mha, dense_lens if not paged else paged_lens, 128),
                 (g16, [5, 300, 2047, 0, 17, 1024, 64, 1], 128),
                 (d64, [2047, 0, 31, 700, 128, 5, 1999, 16], 128)]
        if paged:
            cases.append((mha, [16, 0, 15, 300, 2047, 33, 1, 512], 16))
        for blk, lengths, bs in cases:
            _, e, w = check_mega(gen, blk, lengths, quantized,
                                 bs if paged else None)
            errs.append(e)
            worst.append(w)
        tensors, e, w = check_mega(gen, mha, [2047] * 8, quantized,
                                   128 if paged else None)
        if key == "decode_megakernel":
            log_partition(mha)
        records[key] = time_mega(key, mha, tensors, errs + [e], worst + [w])
        del tensors
        gc.collect()
        torch.cuda.empty_cache()


def build_model(seed=1234):
    from paddle_tpu_torch.core import random as prandom
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_configs
    cfg = gpt_configs()["gpt3-1.3b"]
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                           generator=prandom.seed(seed, "cuda"))
    model.eval()
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    log(f"[serve] gpt3-1.3b: {n / 1e9:.3f} B params bf16, hidden "
        f"{cfg.hidden_size}, {cfg.num_layers} layers, {cfg.num_heads} heads, "
        f"max_seq_len {cfg.max_seq_len}, init {time.perf_counter() - t0:.2f} s")
    return model


def cache_bytes(cache):
    return sum(t.numel() * t.element_size()
               for t in (cache.k, cache.v, cache.k_scale, cache.v_scale)
               if t is not None)


def drive(tag, eng, prompts, new_tokens, sample_every=5):
    """Queue ``prompts`` (every ``sample_every``-th one sampled at
    temperature 0.8, top-p 0.9; the rest greedy), reset the peak-memory
    counter and run the engine dry through ``measured`` (launch counts
    reset just before, read just after, host reads counted).  Checks
    every request's token count and finite cache contents besides
    ``measured``'s host-sync and launch checks.  Returns ``(launches by
    kernel, stats, problems)``."""
    rids = {}
    for i, p in enumerate(prompts):
        sampled = sample_every and i % sample_every == sample_every - 1
        rid = eng.add_request(p, max_new_tokens=new_tokens,
                              temperature=0.8 if sampled else 0.0,
                              top_p=0.9 if sampled else 1.0)
        rids[rid] = len(p)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results, launches, _, problems = measured(tag, eng, eng.run)
    wall = time.perf_counter() - t0
    # read before the finiteness check below, whose temporaries are as
    # large as the cache
    peak = torch.cuda.max_memory_allocated()
    st = eng.stats()
    counts = [len(results[r]) for r in rids]
    cache = eng.cache
    finite = all(bool(torch.isfinite(t).all().item())
                 for t in (cache.k, cache.v, cache.k_scale, cache.v_scale)
                 if t is not None and t.is_floating_point())
    tokens = sum(counts)
    TOKENS_PER_S[tag] = tokens / wall
    log(f"[{tag}] {len(prompts)} requests, prompt lengths "
        f"{sorted(rids.values())}, buckets used "
        f"{sorted(st['prefill_ms_by_bucket'])}")
    log(f"[{tag}] tokens={tokens} wall_s={wall:.3f} "
        f"tokens_per_s={tokens / wall:.1f} prefills={st['prefills']} "
        f"prefill_tokens={st['prefill_tokens']} "
        f"decode_steps={st['decode_steps']} "
        f"mean_decode_step_ms={st['decode_ms'] / st['decode_steps']:.3f} "
        f"decode_tokens_per_s={st['decode_tokens_per_sec']:.1f}")
    for bk, v in st["prefill_ms_by_bucket"].items():
        log(f"[{tag}] prefill bucket {bk}: n={v['count']} "
            f"mean_ms={v['mean_ms']:.3f}")
    log(f"[{tag}] kv_layout={st['kv_layout']} kv_dtype={st['kv_dtype']} "
        f"cache_bytes={cache_bytes(cache)} max_memory_allocated={peak} bytes")
    if counts != [new_tokens] * len(prompts):
        problems.append(f"token counts {counts} != {new_tokens} each")
    if not finite:
        problems.append("non-finite values in the KV cache")
    return launches, st, problems


# tokens/s of each drive() run and host reads of each measured() run, by
# tag: serve-moe holds its own against the dense serve phase's
TOKENS_PER_S = {}
HOST_READS = {}
# the cost model's readings stashed by serve, train and jit-transformer
# for the cost-model phase
COST = {}
# {"dir": this run's temporary directory (the tuning table, the faults'
# checkpoints and bundles, the report's snapshot)}
TUNING = {}


class HostReads:
    """Counts every device-to-host read the engine makes (``cpu``,
    ``item``, ``tolist``, ``numpy`` of any tensor) while active
    (``device_only``: of tensors on the card only)."""

    NAMES = ("cpu", "item", "tolist", "numpy")

    def __init__(self, device_only=False):
        self.n = 0
        self._orig = {}
        self.device_only = device_only

    def __enter__(self):
        for name in self.NAMES:
            orig = self._orig[name] = getattr(torch.Tensor, name)

            def counted(t, *a, _orig=orig, **k):
                if not self.device_only or t.device.type != "cpu":
                    self.n += 1
                return _orig(t, *a, **k)
            setattr(torch.Tensor, name, counted)
        return self

    def __exit__(self, *exc):
        for name, orig in self._orig.items():
            setattr(torch.Tensor, name, orig)
        return False


def measured(tag, eng, fn, extra_reads=0):
    """Run ``fn()`` with every launch count at 0 and every host read
    counted; returns ``(result, launches, counter deltas, problems)``.
    Checks one host read per decode step and per admission (per
    graduating chunk tick when chunked; ``extra_reads`` more for reads
    ``fn`` makes outside the steps) and, per layer, one launch of the
    decode kernel of the engine's cache in every decode step, one flash
    launch in every prefill without a cached prefix (one window launch in
    every chunk tick when chunked) and no other launch."""
    layers = eng.model.cfg.num_layers
    before = dict(eng._timings)
    hits0 = eng._prefix.hit_queries if eng._prefix is not None else 0
    torch.cuda.synchronize()
    zero_launches()
    with HostReads() as reads:
        out = fn()
    torch.cuda.synchronize()
    HOST_READS[tag] = reads.n
    launches = read_launches()
    d = {k: v - before[k] for k, v in eng._timings.items()}
    hits = (eng._prefix.hit_queries if eng._prefix is not None else 0) - hits0
    st = eng.stats()
    want = {decode_key(st): layers * d["decode_steps"]}
    if eng._chunked:
        want[window_key(st)] = layers * d["chunk_ticks"]
    else:
        want["flash_fwd"] = layers * (d["prefills"] - hits)
    problems = [f"{key} launches {n} != {want.get(key, 0)}"
                for key, n in launches.items() if n != want.get(key, 0)]
    syncs = d["decode_host_syncs"] + d["prefill_host_syncs"]
    if not (d["decode_host_syncs"] == d["decode_steps"]
            and reads.n == syncs + extra_reads):
        problems.append(f"{reads.n} host reads, {d['decode_host_syncs']} "
                        f"decode syncs over {d['decode_steps']} decode "
                        f"steps, {d['prefill_host_syncs']} prefill syncs")
    if eng._chunked and d["prefill_host_syncs"] != d["chunk_graduation_ticks"]:
        problems.append("a chunk tick synced without graduating a slot")
    log(f"[{tag}] decode_steps={d['decode_steps']} prefills={d['prefills']} "
        f"chunk_ticks={d['chunk_ticks']} host reads={reads.n} (decode "
        f"{d['decode_host_syncs']}, prefill {d['prefill_host_syncs']}); "
        f"launches {{{', '.join(f'{k}: {n}' for k, n in launches.items() if n)}}}")
    return out, launches, d, problems


def finish(tag, problems):
    if problems:
        raise SystemExit(f"{tag} phase failed: " + "; ".join(problems))
    log(f"[{tag}] ok")


def random_prompts(rng, vocab, lengths):
    return [rng.randint(0, vocab, size=int(n)) for n in lengths]


def phase_serve(model):
    from paddle_tpu_torch.inference import InferenceEngine
    cfg = model.cfg
    # warm the libraries (cuBLAS handles, allocator) off the record
    scratch = model.init_kv_cache(1)
    model.prefill(torch.zeros((1, 64), dtype=torch.long, device="cuda"),
                  scratch, 0, 64)
    model.decode_step(torch.zeros(1, dtype=torch.long, device="cuda"),
                      scratch, torch.ones(1, dtype=torch.int32, device="cuda"))
    del scratch
    torch.cuda.synchronize()

    eng = InferenceEngine(model, batch_slots=8, top_k=50, seed=7,
                          device="cuda")
    launches, _, problems = drive("serve", eng, serve_prompts(cfg.vocab_size),
                                  32)
    finish("serve", problems)
    # the cost model's reading of this engine's step kinds (cost-model
    # prints and checks it)
    from paddle_tpu_torch.observability import exec_registry
    exec_registry.analyze_all(eng._exec_component)
    COST["serve"] = exec_registry.profile(eng._exec_component)
    return launches


def phase_serve_paged(model):
    """Paged bf16 serving with the radix prefix cache: 8 of the 16
    requests share one 1024-token prefix (8 full blocks) followed by 32 to
    512 tokens of their own, interleaved with 8 random prompts of 32 to
    1536 tokens."""
    from paddle_tpu_torch.inference import InferenceEngine
    prompts = paged_prompts(model.cfg.vocab_size)
    eng = InferenceEngine(model, batch_slots=8, kv_layout="paged",
                          kv_block_size=128, prefix_cache=True, top_k=50,
                          seed=17, device="cuda")
    launches, st, problems = drive("serve-paged", eng, prompts, 32)
    log(f"[serve-paged] prefix_queries={st['prefix_queries']} "
        f"prefix_hit_queries={st['prefix_hit_queries']} "
        f"prefix_hit_blocks={st['prefix_hit_blocks']} "
        f"block_occupancy={st['block_occupancy']:.4f} "
        f"kv_blocks_total={st['kv_blocks_total']}")
    if st["prefix_hit_queries"] < 7:
        problems.append(f"{st['prefix_hit_queries']} prefix hits < 7")
    eng.check_leak_free()
    log(f"[serve-paged] pool leak-free after the prefix flush: "
        f"{eng._alloc.num_free}/{eng._alloc.capacity} blocks free")
    finish("serve-paged", problems)
    return launches


def phase_serve_pressure(model):
    """A pool too small for its slots: 40 blocks of 128 for 8 slots,
    prompts of 960 to 1020 tokens (8 blocks each at admission) and 64 new
    tokens, so decode crosses into a ninth block while the pool is dry
    and the scheduler must preempt."""
    from paddle_tpu_torch.inference import InferenceEngine
    rng = np.random.RandomState(23)
    prompts = random_prompts(rng, model.cfg.vocab_size,
                             rng.randint(960, 1021, size=8))
    eng = InferenceEngine(model, batch_slots=8, kv_layout="paged",
                          kv_block_size=128, kv_num_blocks=40, seed=23,
                          device="cuda")
    launches, st, problems = drive("serve-pressure", eng, prompts, 64,
                                   sample_every=0)
    log(f"[serve-pressure] preemptions={st['preemptions']} "
        f"memory_capped_retirements={st['memory_capped_retirements']} "
        f"block_occupancy={st['block_occupancy']:.4f} "
        f"prefix_hit_queries={st['prefix_hit_queries']}")
    if st["preemptions"] < 1:
        problems.append("no preemption under a dry pool")
    eng.check_leak_free()
    finish("serve-pressure", problems)
    return launches


def phase_serve_int8(model):
    """The dense and the paged engine over int8 caches: 8 requests of 32
    new tokens each (the paged one with 4 sharing a 512-token prefix)."""
    from paddle_tpu_torch.inference import InferenceEngine
    vocab = model.cfg.vocab_size
    out = {}
    for layout in ("dense", "paged"):
        rng = np.random.RandomState(29)
        prompts = random_prompts(rng, vocab, rng.randint(32, 1537, size=8))
        if layout == "paged":
            prefix = rng.randint(0, vocab, size=512)
            for i in range(0, 8, 2):
                prompts[i] = np.concatenate([prefix, prompts[i][:300]])
        eng = InferenceEngine(model, batch_slots=8, kv_layout=layout,
                              kv_dtype="int8", top_k=50, seed=29,
                              device="cuda")
        tag = f"serve-int8-{layout}"
        launches, st, problems = drive(tag, eng, prompts, 32)
        if layout == "paged":
            log(f"[{tag}] prefix_hit_queries={st['prefix_hit_queries']}")
            eng.check_leak_free()
        finish(tag, problems)
        out[tag] = launches
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return out


def run_engine(tag, eng, prompts, new_tokens, sampled=()):
    """Queue ``prompts`` (those at the indices in ``sampled`` at
    temperature 0.8, top-p 0.9; the rest greedy), reset every launch
    count, run the engine dry and read the counts back.  Returns
    ``(streams in prompt order, launches by kernel, stats, wall s)``;
    logs tokens/s, host syncs and launches."""
    rids = [eng.add_request(p, max_new_tokens=new_tokens,
                            temperature=0.8 if i in sampled else 0.0,
                            top_p=0.9 if i in sampled else 1.0)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    results = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    st = eng.stats()
    streams = [results[r].tolist() for r in rids]
    tokens = sum(len(x) for x in streams)
    log(f"[{tag}] {len(prompts)} requests of {new_tokens} new tokens, prompt "
        f"lengths {sorted(len(p) for p in prompts)}: tokens={tokens} "
        f"wall_s={wall:.3f} tokens_per_s={tokens / wall:.1f} "
        f"decode_steps={st['decode_steps']} decode_ms={st['decode_ms']:.1f} "
        f"prefill_ms={st['prefill_ms']:.1f} prefill_tokens="
        f"{st['prefill_tokens']} host_syncs decode={st['decode_host_syncs']} "
        f"prefill={st['prefill_host_syncs']} (per token "
        f"{st['host_syncs'] / max(tokens, 1):.4f})")
    log(f"[{tag}] launches {{{', '.join(f'{k}: {n}' for k, n in launches.items() if n)}}}")
    return streams, launches, st, wall


def compare_greedy(tag, model, prompts, got, want, tol):
    """Greedy streams of a chunked or speculative engine against the
    plain engine's of the same cache form.  bf16 kernels that round
    differently can flip a near-tie, so at each request's first
    divergence the plain stream's top-2 logit gap there (one no-cache
    forward over the prompt and the plain tokens before it) is held to
    ``tol`` x that position's max |logit|: a divergence at a clear
    margin is a fault.  Returns the problems."""
    same = sum(g == w for g, w in zip(got, want))
    agree = sum(a == b for g, w in zip(got, want) for a, b in zip(g, w))
    total = sum(len(w) for w in want)
    problems = []
    gaps = []
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        t = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b),
                 min(len(g), len(w)))
        if t >= min(len(g), len(w)):
            problems.append(f"request {i}: lengths {len(g)} vs {len(w)} "
                            f"with equal tokens")
            continue
        ids = torch.tensor(np.concatenate(
            [prompts[i], np.asarray(w[:t], dtype=np.int64)])[None],
            device="cuda")
        with torch.no_grad():
            last = model(ids)[0, -1].float()
        top2 = torch.topk(last, 2).values
        gap = ((top2[0] - top2[1]) / last.abs().max()).item()
        gaps.append((i, t, gap))
        if gap > tol:
            problems.append(f"request {i} diverges at token {t} where the "
                            f"plain engine's top-2 gap is {gap:.3e} of its "
                            f"max |logit| (tol {tol})")
    log(f"[{tag}] greedy streams vs the plain engine: {same}/{len(want)} "
        f"identical, token agreement {agree}/{total}; first divergences "
        f"(request, token, top-2 gap / max|logit|): "
        f"{[(i, t, round(gp, 5)) for i, t, gp in gaps]}")
    return problems


def window_key(st):
    key = ("paged_window_attention" if st["kv_layout"] == "paged"
           else "window_attention")
    return key + _tag(st["kv_dtype"])


def decode_key(st):
    key = ("paged_decode_attention" if st["kv_layout"] == "paged"
           else "decode_attention")
    return key + _tag(st["kv_dtype"])


def phase_serve_chunked(model):
    """Chunked prefill (``prefill_chunk=512``) on two engines: dense bf16
    over the serve phase's 16 prompts of 32-1536 tokens, and paged int8
    with the radix cache (blocks of 128) over serve-paged's prompts (8
    sharing a 1024-token prefix); 32 new tokens, greedy, 8 slots.
    Checks every stream's length, one host sync per decode step and none
    per chunk tick but those that graduate a slot, one window launch per
    layer per chunk tick and no flash launch, a leak-free pool, and the
    greedy streams against the monolithic engine of the same cache
    form."""
    from paddle_tpu_torch.inference import InferenceEngine
    vocab, layers = model.cfg.vocab_size, model.cfg.num_layers
    out = {}
    for tag, prompts, kw in (
            ("serve-chunked-dense", serve_prompts(vocab), {}),
            ("serve-chunked-paged-int8", paged_prompts(vocab),
             dict(kv_layout="paged", kv_block_size=128, kv_dtype="int8"))):
        want, _, _, _ = run_engine(f"{tag} (monolithic)", InferenceEngine(
            model, batch_slots=8, device="cuda", **kw), prompts, 32)
        eng = InferenceEngine(model, batch_slots=8, prefill_chunk=512,
                              device="cuda", **kw)
        got, launches, st, _ = run_engine(tag, eng, prompts, 32)
        log(f"[{tag}] chunk_ticks={st['chunk_ticks']} graduation ticks="
            f"{st['chunk_graduation_ticks']} decode steps during chunk ticks="
            f"{st['decode_steps_with_chunk']} prefill_stall_ms="
            f"{st['prefill_stall_ms']} prefills={st['prefills']}"
            + (f" prefix_hit_queries={st['prefix_hit_queries']}"
               if "prefix_hit_queries" in st else ""))
        problems = compare_greedy(
            tag, model, prompts, got, want,
            TOL_TEACHER_INT8 if "int8" in tag else TOL_TEACHER)
        if [len(x) for x in got] != [32] * len(prompts):
            problems.append(f"stream lengths {[len(x) for x in got]}")
        if st["decode_host_syncs"] != st["decode_steps"]:
            problems.append("not one host sync per decode step")
        if st["prefill_host_syncs"] != st["chunk_graduation_ticks"]:
            problems.append(f"{st['prefill_host_syncs']} prefill syncs over "
                            f"{st['chunk_graduation_ticks']} graduating "
                            f"chunk ticks")
        wkey, dkey = window_key(st), decode_key(st)
        want_l = {wkey: layers * st["chunk_ticks"],
                  dkey: layers * st["decode_steps"]}
        for key, n in launches.items():
            if n != want_l.get(key, 0):
                problems.append(f"{key} launches {n} != {want_l.get(key, 0)}")
        if st["prefill_stall_ms"] != 0 or st["decode_steps_with_chunk"] < 1:
            problems.append("a monolithic stall, or no decode during chunks")
        if kw:
            eng.check_leak_free()
            log(f"[{tag}] pool leak-free after the prefix flush")
        finish(tag, problems)
        out[tag] = launches
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return out


def build_draft():
    from paddle_tpu_torch.core import random as prandom
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_configs
    draft = GPTForCausalLM(gpt_configs()["gpt3-125m"], device="cuda",
                           dtype=torch.bfloat16,
                           generator=prandom.seed(1234, "cuda"))
    draft.eval()
    return draft


def phase_serve_spec(model):
    """Speculative decoding (``spec_k=4``) behind gpt3-1.3b: dense int8,
    paged bf16 and paged int8 (blocks of 128) with a gpt3-125m draft of
    random weights (it proposes badly, so the reject path runs), and
    dense bf16 with the target as its own draft (every proposal
    accepted); 8 prompts of 32-1024
    tokens, 64 new tokens, greedy (the paged engine also serves 2 sampled
    requests).  Checks one host sync per tick, the window launches per
    tick (the target's verify and the draft's catch-up, one per layer
    each) and the draft's decode launches, K+1 tokens a tick for the
    self-draft, and the greedy streams against the plain engine of the
    same cache form."""
    from paddle_tpu_torch.inference import InferenceEngine
    cfg = model.cfg
    k, new = 4, 64
    draft = build_draft()
    rng = np.random.RandomState(31)
    plens = rng.randint(32, 1025, size=8)
    plens[:2] = [32, 1024]
    prompts = random_prompts(rng, cfg.vocab_size, plens)
    out = {}
    for tag, kw, drf, sampled in (
            ("serve-spec-dense-int8", dict(kv_dtype="int8"), draft, ()),
            ("serve-spec-paged", dict(kv_layout="paged", kv_block_size=128),
             draft, (3, 7)),
            ("serve-spec-paged-int8", dict(kv_layout="paged", kv_block_size=128,
                                           kv_dtype="int8"), draft, ()),
            ("serve-spec-self", {}, model, ())):
        want, _, _, _ = run_engine(f"{tag} (plain)", InferenceEngine(
            model, batch_slots=8, device="cuda", **kw), prompts, new)
        eng = InferenceEngine(model, batch_slots=8, spec_k=k,
                              draft_model=drf, device="cuda", **kw)
        got, launches, st, wall = run_engine(tag, eng, prompts, new,
                                             sampled=sampled)
        ticks = st["spec_ticks"]
        log(f"[{tag}] spec_ticks={ticks} accepted_tokens_per_tick="
            f"{st['accepted_tokens_per_tick']:.4f} acceptance_rate="
            f"{st['spec_acceptance_rate']:.4f} mean_tick_ms="
            f"{st['decode_ms'] / max(ticks, 1):.3f} host syncs per generated "
            f"token {st['host_syncs'] / (new * len(prompts)):.4f}")
        greedy = [i for i in range(len(prompts)) if i not in sampled]
        problems = compare_greedy(
            tag, model, [prompts[i] for i in greedy],
            [got[i] for i in greedy], [want[i] for i in greedy],
            TOL_TEACHER_INT8 if "int8" in tag else TOL_TEACHER)
        if [len(x) for x in got] != [new] * len(prompts):
            problems.append(f"stream lengths {[len(x) for x in got]}")
        if not st["decode_host_syncs"] == st["decode_steps"] == ticks > 0:
            problems.append("not one host sync per spec tick")
        d_layers = drf.cfg.num_layers
        t_key = window_key(st)
        want_l = {t_key: cfg.num_layers * ticks}
        want_l["window_attention"] = want_l.get("window_attention", 0) + \
            d_layers * ticks
        want_l["decode_attention"] = d_layers * (k - 1) * ticks
        want_l["flash_fwd"] = (cfg.num_layers + d_layers) * st["prefills"]
        for key, n in launches.items():
            if n != want_l.get(key, 0):
                problems.append(f"{key} launches {n} != {want_l.get(key, 0)}")
        if drf is model:
            per_req = -(-(new - 1) // (k + 1))
            if st["spec_slot_ticks"] != per_req * len(prompts) or \
                    st["spec_tokens_committed"] != (new - 1) * len(prompts):
                problems.append(
                    f"self-draft: {st['spec_tokens_committed']} tokens over "
                    f"{st['spec_slot_ticks']} slot ticks, want "
                    f"{(new - 1) * len(prompts)} over "
                    f"{per_req * len(prompts)} (K+1 a tick)")
        if st["kv_layout"] == "paged":
            eng.check_leak_free()
        finish(tag, problems)
        out[tag] = launches
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return out


def serve_prompts(vocab):
    """The serve phase's 16 prompts of 32-1536 tokens."""
    rng = np.random.RandomState(7)
    plens = rng.randint(32, 1537, size=16)
    plens[:4] = [32, 100, 700, 1536]        # at least four buckets
    return random_prompts(rng, vocab, plens)


def paged_prompts(vocab):
    """serve-paged's 16 prompts: 8 share a 1024-token prefix."""
    rng = np.random.RandomState(17)
    prefix = rng.randint(0, vocab, size=1024)
    shared = [np.concatenate([prefix, p]) for p in random_prompts(
        rng, vocab, rng.randint(32, 513, size=8))]
    other = random_prompts(rng, vocab, rng.randint(32, 1537, size=8))
    return [p for pair in zip(shared, other) for p in pair]


def int8_prompts(vocab, paged):
    """serve-int8's 8 prompts (the paged engine's with 4 sharing a
    512-token prefix)."""
    rng = np.random.RandomState(29)
    prompts = random_prompts(rng, vocab, rng.randint(32, 1537, size=8))
    if paged:
        prefix = rng.randint(0, vocab, size=512)
        for i in range(0, 8, 2):
            prompts[i] = np.concatenate([prefix, prompts[i][:300]])
    return prompts


def phase_serve_mega(model):
    """``enable_decode_megakernel()`` on the dense bf16, dense int8, paged
    bf16 and paged int8 engines (serve's and serve-int8's prompts, 32 new
    tokens, greedy), each beside the composed engine of the same cache
    form: one megakernel launch per layer per decode step and no decode
    attention launch, one host sync per decode step, a leak-free pool,
    and greedy streams equal to the composed engine's or diverging only
    at a near-tie of its logits."""
    from paddle_tpu_torch.inference import InferenceEngine
    vocab, layers = model.cfg.vocab_size, model.cfg.num_layers
    out = {}
    for tag, kw in (
            ("serve-mega-dense", {}),
            ("serve-mega-dense-int8", dict(kv_dtype="int8")),
            ("serve-mega-paged", dict(kv_layout="paged", kv_block_size=128)),
            ("serve-mega-paged-int8", dict(kv_layout="paged",
                                           kv_block_size=128,
                                           kv_dtype="int8"))):
        paged, int8 = "paged" in tag, "int8" in tag
        prompts = int8_prompts(vocab, paged) if int8 else \
            serve_prompts(vocab)
        model.enable_decode_megakernel(False)
        want, _, st_c, wall_c = run_engine(
            f"{tag} (composed)", InferenceEngine(model, batch_slots=8,
                                                 device="cuda", **kw),
            prompts, 32)
        model.enable_decode_megakernel(True)
        eng = InferenceEngine(model, batch_slots=8, device="cuda", **kw)
        got, launches, st, wall = run_engine(tag, eng, prompts, 32)
        tokens = sum(len(x) for x in got)
        log(f"[{tag}] tokens/s {tokens / wall:.1f} against the composed "
            f"engine's {tokens / wall_c:.1f}; mean decode step "
            f"{st['decode_ms'] / st['decode_steps']:.3f} ms against "
            f"{st_c['decode_ms'] / st_c['decode_steps']:.3f} ms; "
            f"stats decode_megakernel={st['decode_megakernel']}")
        problems = compare_greedy(tag, model, prompts, got, want,
                                  TOL_TEACHER_INT8 if int8 else TOL_TEACHER)
        if [len(x) for x in got] != [32] * len(prompts):
            problems.append(f"stream lengths {[len(x) for x in got]}")
        if st["decode_megakernel"] is not True:
            problems.append("stats do not report the megakernel")
        if st["decode_host_syncs"] != st["decode_steps"]:
            problems.append("not one host sync per decode step")
        key = ("paged_" if paged else "") + "decode_megakernel" + \
            ("_q" if int8 else "")
        cold = st["prefills"] - st.get("prefix_hit_queries", 0)
        want_l = {key: layers * st["decode_steps"], "flash_fwd": layers * cold}
        for k2, n in launches.items():
            if n != want_l.get(k2, 0):
                problems.append(f"{k2} launches {n} != {want_l.get(k2, 0)}")
        if paged:
            eng.check_leak_free()
            log(f"[{tag}] pool leak-free after the prefix flush")
        finish(tag, problems)
        out[tag] = launches
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    model.enable_decode_megakernel(False)
    return out


def phase_serve_quant(model):
    """``enable_quantize('int8')`` behind the dense bf16 engine with
    serve's prompts, 32 new tokens, greedy, beside the bf16 engine: four
    int8 matmul launches per layer per prefill and per decode step, the
    decode and flash kernels as usual, one host sync per decode step;
    tokens/s of both, and the share of greedy tokens equal to the bf16
    model's (a number, not a check: quantization changes the model)."""
    from paddle_tpu_torch.inference import InferenceEngine
    layers = model.cfg.num_layers
    prompts = serve_prompts(model.cfg.vocab_size)
    want, _, st_b, wall_b = run_engine(
        "serve-quant (bf16)", InferenceEngine(model, batch_slots=8,
                                              device="cuda"), prompts, 32)
    model.enable_quantize("int8")
    try:
        eng = InferenceEngine(model, batch_slots=8, device="cuda")
        got, launches, st, wall = run_engine("serve-quant", eng, prompts, 32)
    finally:
        model.enable_quantize(None)
    tokens = sum(len(x) for x in got)
    TOKENS_PER_S["serve-quant (bf16)"] = tokens / wall_b
    TOKENS_PER_S["serve-quant"] = tokens / wall
    same = sum(g == w for g, w in zip(got, want))
    agree = sum(a == b for g, w in zip(got, want) for a, b in zip(g, w))
    first = [next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), None)
             for g, w in zip(got, want)]
    log(f"[serve-quant] int8 compute: tokens/s {tokens / wall:.1f} against "
        f"bf16 {tokens / wall_b:.1f}; mean decode step "
        f"{st['decode_ms'] / st['decode_steps']:.3f} ms against "
        f"{st_b['decode_ms'] / st_b['decode_steps']:.3f} ms; greedy top-1 "
        f"agreement with the bf16 model {agree}/{tokens} "
        f"({agree / tokens:.4f}), {same}/{len(want)} streams identical, "
        f"first divergence per request {first}")
    problems = []
    if [len(x) for x in got] != [32] * len(prompts):
        problems.append(f"stream lengths {[len(x) for x in got]}")
    if st["decode_host_syncs"] != st["decode_steps"]:
        problems.append("not one host sync per decode step")
    want_l = {"quantized_matmul": 4 * layers * (st["prefills"]
                                                + st["decode_steps"]),
              "decode_attention": layers * st["decode_steps"],
              "flash_fwd": layers * st["prefills"]}
    for key, n in launches.items():
        if n != want_l.get(key, 0):
            problems.append(f"{key} launches {n} != {want_l.get(key, 0)}")
    finish("serve-quant", problems)
    return launches


def check_launches(tag, launches, want, problems):
    """Every kernel's launches equal ``want`` (0 where it names none)."""
    for key, n in launches.items():
        if n != want.get(key, 0):
            problems.append(f"{tag}: {key} launches {n} != {want.get(key, 0)}")


def phase_serve_fp8(model):
    """serve-fp8: ``kv_dtype='fp8'`` behind gpt3-1.3b, 8 slots, 32 new
    greedy tokens: the dense engine (serve's 16 prompts of 32-1536 tokens)
    beside the dense int8 engine in the same call (tokens/s, cache bytes:
    equal, one byte a code); the paged engine with the radix cache
    (serve-paged's prompts: prefix hits); ``prefill_chunk=512`` on the
    paged engine and ``spec_k=4`` with a gpt3-125m draft on the dense one,
    each against the plain fp8 engine of its layout; and
    ``enable_decode_megakernel()`` over the dense fp8 cache, which keeps
    the composed step as in the JAX package (row 11 launches 0 times).
    Each: every request's tokens, one host sync per decode step or spec
    tick and per admission (chunked: per graduating tick), the e4m3
    kernels' launches per layer and no int8 attention launch, leak-free
    pools, greedy streams equal to the plain engine's but at a near-tie
    (``TOL_TEACHER_FP8``)."""
    from paddle_tpu_torch.inference import InferenceEngine
    vocab, layers = model.cfg.vocab_size, model.cfg.num_layers
    dense_p, paged_p = serve_prompts(vocab), paged_prompts(vocab)
    paged_kw = dict(kv_layout="paged", kv_block_size=128)
    out, problems = {}, []

    def syncs_ok(tag, st, chunked=False):
        prefill = st["chunk_graduation_ticks"] if chunked else st["prefills"]
        if not (st["decode_host_syncs"] == st["decode_steps"]
                and st["prefill_host_syncs"] == prefill):
            problems.append(f"{tag}: {st['decode_host_syncs']} decode syncs "
                            f"over {st['decode_steps']} steps, "
                            f"{st['prefill_host_syncs']} prefill syncs")

    def lengths_ok(tag, got, n):
        if [len(x) for x in got] != [32] * n:
            problems.append(f"{tag}: stream lengths {[len(x) for x in got]}")

    # the plain engines: dense fp8 beside dense int8, then paged fp8
    want = {}
    walls = {}
    for tag, kw, prompts in (("serve-fp8-dense", {}, dense_p),
                             ("serve-fp8-int8-dense", {}, dense_p),
                             ("serve-fp8-paged", paged_kw, paged_p)):
        kv = "int8" if "int8" in tag else "fp8"
        eng = InferenceEngine(model, batch_slots=8, kv_dtype=kv,
                              device="cuda", **kw)
        got, launches, st, walls[tag] = run_engine(tag, eng, prompts, 32)
        lengths_ok(tag, got, len(prompts))
        syncs_ok(tag, st)
        hits = st.get("prefix_hit_queries", 0)
        check_launches(tag, launches, {
            decode_key(st): layers * st["decode_steps"],
            "flash_fwd": layers * (st["prefills"] - hits)}, problems)
        log(f"[{tag}] kv_dtype={st['kv_dtype']} cache_bytes="
            f"{cache_bytes(eng.cache)} prefix_hit_queries={hits}")
        if kw:
            if hits < 1:
                problems.append(f"{tag}: no prefix hit")
            eng.check_leak_free()
        if kv == "fp8":
            want[tag] = got
            out[tag] = launches
        walls[tag] = (walls[tag], sum(len(x) for x in got),
                      cache_bytes(eng.cache))
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    (w8, n8, b8), (wi, ni, bi) = walls["serve-fp8-dense"], \
        walls["serve-fp8-int8-dense"]
    log(f"[serve-fp8] dense tokens/s fp8 {n8 / w8:.1f} against int8 "
        f"{ni / wi:.1f} in the same call (ratio {(n8 / w8) / (ni / wi):.3f});"
        f" cache bytes fp8 {b8} int8 {bi}")
    if b8 != bi:
        problems.append(f"fp8 cache bytes {b8} != int8's {bi}")

    # chunked (paged) and speculative (dense) fp8 engines
    draft = build_draft()
    for tag, kw, prompts, base in (
            ("serve-fp8-chunked-paged", dict(prefill_chunk=512, **paged_kw),
             paged_p, "serve-fp8-paged"),
            ("serve-fp8-spec", dict(spec_k=4, draft_model=draft), dense_p,
             "serve-fp8-dense")):
        eng = InferenceEngine(model, batch_slots=8, kv_dtype="fp8",
                              device="cuda", **kw)
        got, launches, st, _ = run_engine(tag, eng, prompts, 32)
        lengths_ok(tag, got, len(prompts))
        problems += compare_greedy(tag, model, prompts, got, want[base],
                                   TOL_TEACHER_FP8)
        if "spec" in tag:
            ticks, dl = st["spec_ticks"], draft.cfg.num_layers
            if not st["decode_host_syncs"] == st["decode_steps"] == ticks > 0:
                problems.append(f"{tag}: not one host sync per spec tick")
            check_launches(tag, launches, {
                window_key(st): layers * ticks,
                "window_attention": dl * ticks,
                "decode_attention": dl * 3 * ticks,
                "flash_fwd": (layers + dl) * st["prefills"]}, problems)
            log(f"[{tag}] spec_ticks={ticks} accepted_tokens_per_tick="
                f"{st['accepted_tokens_per_tick']:.4f}")
        else:
            syncs_ok(tag, st, chunked=True)
            check_launches(tag, launches, {
                window_key(st): layers * st["chunk_ticks"],
                decode_key(st): layers * st["decode_steps"]}, problems)
            eng.check_leak_free()
        out[tag] = launches
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    del draft

    # the megakernel asked for over an fp8 cache: the composed step
    tag = "serve-fp8-mega"
    model.enable_decode_megakernel(True)
    try:
        eng = InferenceEngine(model, batch_slots=8, kv_dtype="fp8",
                              device="cuda")
        got, launches, st, _ = run_engine(tag, eng, dense_p, 32)
    finally:
        model.enable_decode_megakernel(False)
    lengths_ok(tag, got, len(dense_p))
    syncs_ok(tag, st)
    problems += compare_greedy(tag, model, dense_p, got,
                               want["serve-fp8-dense"], TOL_TEACHER_FP8)
    check_launches(tag, launches, {
        "decode_attention_f8": layers * st["decode_steps"],
        "flash_fwd": layers * st["prefills"]}, problems)
    out[tag] = launches
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    finish("serve-fp8", problems)
    return out


def phase_serve_quant_fp8(model):
    """serve-quant-fp8: ``enable_quantize('fp8')`` over an fp8 cache,
    dense and paged (serve's prompts, 32 new greedy tokens, 8 slots):
    row 10f four times a layer a prefill and a decode step, the e4m3
    attention kernels, one host sync a decode step and an admission;
    tokens/s beside serve-quant's int8-compute and bf16 engines (same
    call, same prompts)."""
    from paddle_tpu_torch.inference import InferenceEngine
    layers = model.cfg.num_layers
    prompts = serve_prompts(model.cfg.vocab_size)
    problems, out = [], {}
    model.enable_quantize("fp8")
    try:
        for layout in ("dense", "paged"):
            tag = f"serve-quant-fp8-{layout}"
            eng = InferenceEngine(model, batch_slots=8, kv_dtype="fp8",
                                  kv_layout=layout, device="cuda")
            got, launches, st, wall = run_engine(tag, eng, prompts, 32)
            tokens = sum(len(x) for x in got)
            TOKENS_PER_S[tag] = tokens / wall
            if [len(x) for x in got] != [32] * len(prompts):
                problems.append(f"{tag}: stream lengths")
            if not (st["decode_host_syncs"] == st["decode_steps"]
                    and st["prefill_host_syncs"] == st["prefills"]):
                problems.append(f"{tag}: host syncs")
            hits = st.get("prefix_hit_queries", 0)
            check_launches(tag, launches, {
                "quantized_matmul_f8": 4 * layers * (st["prefills"]
                                                     + st["decode_steps"]),
                decode_key(st): layers * st["decode_steps"],
                "flash_fwd": layers * (st["prefills"] - hits)}, problems)
            if layout == "paged":
                eng.check_leak_free()
            out = {k: out.get(k, 0) + n for k, n in launches.items()}
            del eng
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        model.enable_quantize(None)
    bf16 = TOKENS_PER_S.get("serve-quant (bf16)", float("nan"))
    int8 = TOKENS_PER_S.get("serve-quant", float("nan"))
    for layout in ("dense", "paged"):
        fp8 = TOKENS_PER_S[f"serve-quant-fp8-{layout}"]
        log(f"[serve-quant-fp8] {layout}: fp8 compute + fp8 cache tokens/s "
            f"{fp8:.1f}; serve-quant's int8 compute {int8:.1f}, bf16 "
            f"{bf16:.1f} (fp8 / bf16 {fp8 / bf16:.3f}, int8 / bf16 "
            f"{int8 / bf16:.3f})")
    finish("serve-quant-fp8", problems)
    return out


def phase_train_qat_fp8():
    """train-qat-fp8: ``strategy.qat`` with ``qat_configs={'quantize':
    'fp8'}``.  Parity: gpt3-1.3b width at 2 layers, bf16 AMP, one 2 x 512
    step at learning rate 0 through row 10f against the same step with
    its plain version swapped in here (the wrapper's CUDA path pointed at
    ``_qmm_plain``): losses within 1e-2, every gradient within
    TOL_GRAD_FP8; the plain version with f64 sums is printed beside both
    as the floor that the order of the sums sets.
    Then full width and depth, 4 x 2048, bf16 AMP, Adam, one warm-up and
    3 measured steps: finite falling losses, no host sync, row 10f four
    times a layer a step in the forward and rows 1-3 once."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import async_dispatch
    qm = importlib.import_module("paddle_tpu_torch.ops.quantized_matmul")
    fp8 = {"quantize": "fp8"}
    cfg = full_cfg(2)
    model, trainer = make_trainer(cfg, 99, topt.SGD(learning_rate=0.0),
                                  qat=True, qat_configs=fp8)
    ids, labels = token_batch(np.random.RandomState(21), cfg.vocab_size, 2,
                              512)

    def step():
        zero_launches()
        loss = float(trainer.train_step(ids, labels))
        grads = {n: p.grad.detach().clone()
                 for n, p in model.named_parameters()}
        return loss, grads, read_launches()["quantized_matmul_f8"]

    loss_k, grads_k, n_k = step()
    saved = qm._qmm_cuda
    try:
        qm._qmm_cuda = lambda qx, qw_t, sx, sw, out: qm._qmm_plain(
            qx, qw_t.t(), sx, sw, out)
        loss_p, grads_p, n_p = step()
        qm._qmm_cuda = lambda qx, qw_t, sx, sw, out: (torch.matmul(
            qx.double(), qw_t.t().double()).float() * sx * sw).to(out)
        loss_64, grads_64, _ = step()
    finally:
        qm._qmm_cuda = saved

    def ratios(got, ref):
        return {n: ((got[n] - ref[n]).abs().max()
                    / ref[n].abs().max().clamp_min(1e-30)).item()
                for n in got}
    r_k, r_floor = ratios(grads_k, grads_p), ratios(grads_64, grads_p)
    r_k64 = ratios(grads_k, grads_64)
    worst = max(r_k, key=r_k.get)
    ok = (model.cfg.quantize == "fp8" and n_k == 4 * cfg.num_layers
          and n_p == 0 and np.isfinite(loss_k)
          and abs(loss_k - loss_p) <= 1e-2
          and all(r <= TOL_GRAD_FP8 for r in r_k.values()))
    log(f"[train-qat-fp8] parity: {cfg.num_layers} layers, bf16 AMP, 2 x 512: "
        f"loss kernel {loss_k:.6f} plain {loss_p:.6f} plain with f64 sums "
        f"{loss_64:.6f}; gradient max|diff|/max|plain| kernel: worst "
        f"{r_k[worst]:.3e} ({worst}), median "
        f"{float(np.median(list(r_k.values()))):.3e} (tol {TOL_GRAD_FP8}); "
        f"f64 sums (the floor): worst {max(r_floor.values()):.3e}, median "
        f"{float(np.median(list(r_floor.values()))):.3e}; kernel against "
        f"f64 sums: worst {max(r_k64.values()):.3e}; row 10f launches {n_k} "
        f"(plain steps {n_p}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("train-qat-fp8 parity failed")
    del model, trainer, grads_k, grads_p, grads_64
    del_all()

    cfg = full_cfg()
    model, trainer = make_trainer(cfg, 4321, topt.Adam(learning_rate=1e-4),
                                  qat=True, qat_configs=fp8)
    b, s, n_meas = 4, 2048, 3
    batch = token_batch(np.random.RandomState(0), cfg.vocab_size, b, s)
    ids, labels = (torch.from_numpy(x).cuda() for x in batch)
    losses = [float(trainer.train_step(ids, labels))]      # warm-up
    torch.cuda.synchronize()
    zero_launches()
    async_dispatch.reset_host_sync_count()
    t0 = time.perf_counter()
    results = [trainer.train_step(ids, labels) for _ in range(n_meas)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    syncs = async_dispatch.host_sync_count()
    launches = read_launches()
    losses += [float(r) for r in results]
    layers = cfg.num_layers
    problems = []
    if not (all(np.isfinite(losses)) and losses[-1] < losses[1]):
        problems.append(f"losses not finite and falling: {losses}")
    if syncs:
        problems.append(f"{syncs} host syncs in the measured steps")
    check_launches("train-qat-fp8", launches, {
        "quantized_matmul_f8": 4 * layers * n_meas,
        **{k: layers * n_meas for k in FLASH}}, problems)
    log(f"[train-qat-fp8] gpt3-1.3b, {layers} layers, strategy.qat fp8, bf16 "
        f"AMP, Adam, {b} x {s}: losses {[round(x, 4) for x in losses]} "
        f"(first a warm-up); step_ms={wall * 1e3 / n_meas:.3f} host_syncs="
        f"{syncs}; launches "
        f"{{{', '.join(f'{k}: {n}' for k, n in launches.items() if n)}}}")
    finish("train-qat-fp8", problems)
    del model, trainer
    del_all()
    return launches


def add_launches(total, launches):
    for key, n in launches.items():
        total[key] = total.get(key, 0) + n


def phase_serve_lifecycle(model):
    """The request lifecycle on a dense bf16 engine with 8 slots after
    ``warmup`` over the buckets its prompts use: (1) deadlines: serve's 16
    prompts, the 32-token one with 10 000 new tokens and a 2 s deadline,
    two more with ``deadline_s=0.0`` queued behind the 8 busy slots, the
    rest 32 new tokens; (2) drain after two steps of 12 more requests:
    the in-flight slots finish, the other 4 come back in FIFO order; (3)
    SIGTERM under a ``PreemptionGuard`` after one step: ``run()`` returns
    with the never-admitted requests in ``undelivered``; (4)
    ``drain(timeout_s=0.0)`` force-retires live slots with partial output.
    Each part: one host read per decode step and admission, launches as
    ``drive`` counts them."""
    import signal
    from paddle_tpu_torch.distributed import PreemptionGuard
    from paddle_tpu_torch.inference import InferenceEngine
    tag = "serve-lifecycle"
    vocab = model.cfg.vocab_size
    prompts = serve_prompts(vocab)
    eng = InferenceEngine(model, batch_slots=8, seed=7, device="cuda")
    buckets = sorted({eng._bucket_for(len(p)) for p in prompts})
    t0 = time.perf_counter()
    eng.warmup(buckets)
    log(f"[{tag}] warmup over buckets {buckets}: "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    total = {}

    # (1) deadlines
    def deadlines():
        rids = []
        for i, p in enumerate(prompts):
            kw = dict(max_new_tokens=32)
            if i == 0:
                kw = dict(max_new_tokens=10_000, deadline_s=2.0)
            elif i in (8, 9):
                kw["deadline_s"] = 0.0
            rids.append(eng.add_request(p, **kw))
        eng.run()
        return rids
    rids, launches, d, problems = measured(f"{tag} deadlines", eng,
                                           deadlines)
    add_launches(total, launches)
    recs = [eng.request_stats[r] for r in rids]
    long, queued = recs[0], [recs[8], recs[9]]
    rest = [r for i, r in enumerate(recs) if i not in (0, 8, 9)]
    log(f"[{tag}] deadlines: long request timed_out={long['timed_out']} "
        f"tokens={long['tokens']} ttft_ms={long['ttft_ms']}; queued "
        f"{[(r['timed_out'], r['tokens'], r['ttft_ms']) for r in queued]}; "
        f"deadline_retirements={d['deadline_retirements']}; others' tokens "
        f"{[r['tokens'] for r in rest]}")
    if not (long["timed_out"] and 0 < long["tokens"] < 10_000):
        problems.append(f"long request {long['timed_out']} "
                        f"{long['tokens']} tokens")
    if any(not r["timed_out"] or r["tokens"] or r["ttft_ms"] is not None
           for r in queued):
        problems.append("a queued request did not expire empty")
    if d["deadline_retirements"] != 3:
        problems.append(f"deadline_retirements {d['deadline_retirements']}")
    if any(r["timed_out"] or r["tokens"] != 32 for r in rest):
        problems.append("a request without a deadline came back short")

    # (2) drain
    rng = np.random.RandomState(31)
    more = random_prompts(rng, vocab, rng.randint(32, 1537, size=12))

    def drain():
        ids = [eng.add_request(p, max_new_tokens=32) for p in more]
        eng.step()
        eng.step()
        return ids, eng.drain()
    (ids, leftover), launches, _, bad = measured(f"{tag} drain", eng, drain)
    add_launches(total, launches)
    problems += bad
    done = [len(eng.results[r]) for r in ids[:8]]
    log(f"[{tag}] drain: in-flight tokens {done}; leftover "
        f"{[r.rid for r in leftover]} (queued {ids[8:]})")
    if done != [32] * 8 or [r.rid for r in leftover] != ids[8:]:
        problems.append("drain did not finish the slots or keep FIFO order")

    # (3) the guard
    def guarded():
        ids = [eng.add_request(p, max_new_tokens=32) for p in more]
        with PreemptionGuard() as g:
            eng.attach_preemption_guard(g)
            eng.step()
            os.kill(os.getpid(), signal.SIGTERM)
            eng.run()
        eng.attach_preemption_guard(None)
        return ids, g.preempted
    (ids, fired), launches, _, bad = measured(f"{tag} guard", eng, guarded)
    add_launches(total, launches)
    problems += bad
    undelivered = [r.rid for r in eng.undelivered]
    done = [len(eng.results[r]) for r in ids[:8]]
    log(f"[{tag}] guard: fired={fired}, in-flight tokens {done}, undelivered "
        f"{undelivered} (never admitted {ids[8:]})")
    if not fired or undelivered != ids[8:] or done != [32] * 8:
        problems.append("the guard's drain")

    # (4) drain with a timeout
    def forced():
        ids = [eng.add_request(p, max_new_tokens=1000) for p in more[:3]]
        eng.step()
        eng.step()
        return ids, eng.drain(timeout_s=0.0)
    (ids, leftover), launches, d, bad = measured(f"{tag} drain-timeout",
                                                 eng, forced)
    add_launches(total, launches)
    problems += bad
    recs = [eng.request_stats[r] for r in ids]
    log(f"[{tag}] drain(timeout_s=0.0): drain_forced_retirements="
        f"{d['drain_forced_retirements']}, records "
        f"{[(r['timed_out'], r['tokens']) for r in recs]}")
    if (leftover or d["drain_forced_retirements"] != 3
            or any(not r["timed_out"] or not 0 < r["tokens"] < 1000
                   for r in recs)):
        problems.append("drain(timeout_s=0.0) did not force-retire")
    finish(tag, problems)
    return total


def report_line(tag, rep, smi):
    keys = ("tokens_per_sec", "offered_rps", "achieved_rps", "ttft_ms_p50",
            "ttft_ms_p99", "itl_ms_p50", "itl_ms_p99", "slot_occupancy",
            "block_occupancy", "prefix_hit_rate", "preemptions",
            "timed_out_requests", "num_requests", "tokens_generated",
            "wall_s", "deadline_s")
    log(f"[{tag}] report " + json.dumps({k: rep.get(k) for k in keys})
        + f" (card: {smi})")


def loadtest_workload(vocab, **over):
    from paddle_tpu_torch.inference import SharedPrefixWorkload
    kw = dict(seed=11, shared_frac=0.5, prefix_len=1024, tail_len=(32, 512),
              max_new=(16, 64))
    kw.update(over)
    return SharedPrefixWorkload(vocab, **kw)


def planned_tokens(vocab, n, **over):
    wl = loadtest_workload(vocab, **over)
    return sum(wl.sample()[1] for _ in range(n))


# serve-loadtest's request counts of windows A and C (48 and 24 before
# the autotune phases took their seconds; 2 rps, so each is its count / 2
# seconds of wall)
LOADTEST_A, LOADTEST_C = 32, 16


def phase_serve_loadtest(model, smi):
    """Open-loop Poisson load through ``run_loadtest`` on warmed engines.
    A: a paged bf16 engine (blocks of 128, prefix cache, 8 slots),
    ``SharedPrefixWorkload(50304, seed=11, shared_frac=0.5,
    prefix_len=1024, tail_len=(32, 512), max_new=(16, 64))``, LOADTEST_A
    requests at 2 rps with a 120 s deadline: every request returns its tokens,
    none times out, prefix hits, a leak-free pool after ``drain()``.  B:
    the same engine, 16 requests at 200 rps with ``deadline_s=0.0``: all
    16 time out in the queue, no token.  C: the workload without a
    prefix, LOADTEST_C requests at 2 rps, on a dense bf16 engine with
    ``prefill_chunk=512`` beside a monolithic one: ITL p99 of both, no
    prefill stall when chunked.  Each window's report on its own line."""
    from paddle_tpu_torch.inference import InferenceEngine, run_loadtest
    tag = "serve-loadtest"
    vocab = model.cfg.vocab_size
    total = {}
    problems = []
    eng = InferenceEngine(model, batch_slots=8, kv_layout="paged",
                          kv_block_size=128, prefix_cache=True, seed=11,
                          device="cuda")
    t0 = time.perf_counter()
    eng.warmup(eng.buckets)
    log(f"[{tag}] paged warmup over {eng.buckets}: "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")

    rep, launches, _, bad = measured(f"{tag} A", eng, lambda: run_loadtest(
        eng, LOADTEST_A, 2.0, workload=loadtest_workload(vocab),
        deadline_s=120.0))
    add_launches(total, launches)
    problems += bad
    report_line(f"{tag} A", rep, smi)
    want = planned_tokens(vocab, LOADTEST_A)
    if rep["tokens_generated"] != want or \
            rep["num_requests"] != LOADTEST_A:
        problems.append(f"A: {rep['tokens_generated']} tokens of {want}")
    if rep["timed_out_requests"] or not rep["prefix_hit_rate"] > 0:
        problems.append("A: timed out requests or no prefix hit")
    eng.drain()          # checks the pool leak-free
    log(f"[{tag}] A: pool leak-free after drain()")

    rep, launches, _, bad = measured(f"{tag} B", eng, lambda: run_loadtest(
        eng, 16, 200.0, workload=loadtest_workload(vocab), deadline_s=0.0))
    add_launches(total, launches)
    problems += bad
    report_line(f"{tag} B", rep, smi)
    if rep["timed_out_requests"] != 16 or rep["tokens_generated"]:
        problems.append("B: not every request expired empty")
    eng.drain()
    log(f"[{tag}] B: pool leak-free after drain()")
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    itl = {}
    for name, kw in (("C chunked", dict(prefill_chunk=512)),
                     ("C monolithic", {})):
        eng = InferenceEngine(model, batch_slots=8, seed=13, device="cuda",
                              **kw)
        eng.warmup(eng.buckets)
        rep, launches, _, bad = measured(
            f"{tag} {name}", eng, lambda: run_loadtest(
                eng, LOADTEST_C, 2.0, workload=loadtest_workload(
                    vocab, shared_frac=0.0, prefix_len=0), deadline_s=120.0))
        add_launches(total, launches)
        problems += bad
        report_line(f"{tag} {name}", rep, smi)
        st = eng.stats()
        itl[name] = (rep["itl_ms_p99"], st["prefill_stall_ms"])
        want = planned_tokens(vocab, LOADTEST_C, shared_frac=0.0,
                              prefix_len=0)
        if rep["tokens_generated"] != want or rep["timed_out_requests"]:
            problems.append(f"{name}: {rep['tokens_generated']} tokens of "
                            f"{want}, {rep['timed_out_requests']} timed out")
        if kw and st["prefill_stall_ms"] != 0:
            problems.append(f"{name}: prefill_stall_ms "
                            f"{st['prefill_stall_ms']}")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[{tag}] C: itl_ms_p99 chunked {itl['C chunked'][0]} against "
        f"monolithic {itl['C monolithic'][0]} (prefill_stall_ms "
        f"{itl['C chunked'][1]} against {itl['C monolithic'][1]}; "
        f"card: {smi})")
    finish(tag, problems)
    return total


def prefill_calls(eng, family):
    """The prefills ``eng`` timed under ``family`` (its step-kind entries:
    the first call is the entry's compile time, the rest its calls)."""
    from paddle_tpu_torch.observability import exec_registry
    return sum(e.calls + (e.compile_ms is not None)
               for e in exec_registry.registry().entries(eng._exec_component)
               if e.key[0] == family)


def phase_serve_disagg(model):
    """serve-disagg: ``DisaggServingEngine(model, batch_slots=8,
    kv_block_size=128, prefix_cache=True)`` on serve-paged's 16 prompts
    (8 share a 1024-token prefix) with 32 greedy new tokens: (a) bf16,
    (b) int8, (b') int8 with ``spec_k=4`` and the gpt3-125m draft, each
    against the non-disaggregated paged engine of the same form.  Checks
    the greedy streams (``compare_greedy``), ``handoffs`` ==
    ``prefill_worker_prefills`` == 16, every prefill timed under the
    worker's ``disagg`` key and none under the decode engine's own
    ``prefill_paged``, one host read a decode step or spec tick and
    admission, prefix hits, a leak-free pool after ``drain()``, and each
    kernel's launches: the target's decode (row 6 / 7) or verify window
    (row 9b) once a layer a step, flash (row 1) once a layer a prefill
    without a cached prefix, the draft's own kernels as in
    serve-spec."""
    from paddle_tpu_torch.inference import DisaggServingEngine, InferenceEngine
    cfg = model.cfg
    layers = cfg.num_layers
    prompts = paged_prompts(cfg.vocab_size)
    new, k = 32, 4
    draft = None
    out = {}
    for tag, kv_dtype, spec in (("serve-disagg", None, False),
                                ("serve-disagg-int8", "int8", False),
                                ("serve-disagg-spec-int8", "int8", True)):
        kw = dict(batch_slots=8, kv_block_size=128, prefix_cache=True,
                  kv_dtype=kv_dtype, device="cuda")
        if spec:
            draft = build_draft()
            kw.update(spec_k=k, draft_model=draft)
        want, _, _, _ = run_engine(f"{tag} (plain)", InferenceEngine(
            model, kv_layout="paged", **kw), prompts, new)
        del_all()
        dis = DisaggServingEngine(model, **kw)
        rids = [dis.add_request(p, max_new_tokens=new) for p in prompts]
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        with HostReads() as reads:
            results = dis.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        st = dis.stats()
        got = [results[r].tolist() for r in rids]
        tokens = sum(len(x) for x in got)
        hits = st["prefix_hit_queries"]
        steps = st["decode_steps"]
        log(f"[{tag}] {len(prompts)} requests: tokens={tokens} "
            f"wall_s={wall:.3f} tokens_per_s={tokens / wall:.1f} "
            f"decode_steps={steps} mean_step_ms={st['decode_ms'] / steps:.3f}"
            f" prefill_ms={st['prefill_ms']:.1f} handoffs={st['handoffs']} "
            f"worker_prefills={st['prefill_worker_prefills']} prefix hits="
            f"{hits} host reads={reads.n} (decode {st['decode_host_syncs']}, "
            f"prefill {st['prefill_host_syncs']})")
        log(f"[{tag}] launches {{{', '.join(f'{n}: {c}' for n, c in launches.items() if c)}}}")
        problems = compare_greedy(tag, model, prompts, got, want,
                                  TOL_TEACHER_INT8 if kv_dtype
                                  else TOL_TEACHER)
        if [len(x) for x in got] != [new] * len(prompts):
            problems.append(f"stream lengths {[len(x) for x in got]}")
        if not (st["handoffs"] == st["prefill_worker_prefills"]
                == st["prefills"] == len(prompts)):
            problems.append(f"handoffs {st['handoffs']}, worker prefills "
                            f"{st['prefill_worker_prefills']}, admissions "
                            f"{st['prefills']} for {len(prompts)} requests")
        own, worker = (prefill_calls(dis.decode, "prefill_paged"),
                       prefill_calls(dis.decode, "disagg"))
        log(f"[{tag}] prefills timed: decode engine's own {own}, "
            f"worker's {worker}")
        if own or worker != len(prompts):
            problems.append(f"prefills: {own} by the decode engine, "
                            f"{worker} by the worker")
        if not (st["decode_host_syncs"] == steps > 0
                and reads.n == st["decode_host_syncs"]
                + st["prefill_host_syncs"]):
            problems.append(f"{reads.n} host reads over {steps} decode steps"
                            f" and {st['prefill_host_syncs']} admissions")
        if not hits > 0:
            problems.append("no prefix hit")
        want_l = {"flash_fwd": layers * (st["prefills"] - hits)}
        if spec:
            d_layers = draft.cfg.num_layers
            ticks = st["spec_ticks"]
            want_l[window_key(st)] = layers * ticks
            want_l["window_attention"] = d_layers * ticks
            want_l["decode_attention"] = d_layers * (k - 1) * ticks
            want_l["flash_fwd"] += d_layers * st["prefills"]
            log(f"[{tag}] spec_ticks={ticks} accepted_tokens_per_tick="
                f"{st['accepted_tokens_per_tick']:.4f}")
        else:
            want_l[decode_key(st)] = layers * steps
        check_launches(tag, launches, want_l, problems)
        dis.drain()                  # checks the pool leak-free
        dis.check_leak_free()
        log(f"[{tag}] pool leak-free after drain()")
        finish(tag, problems)
        out[tag] = launches
        del dis
        del_all()
    return out


# requests of each serve-fleet window under a policy (cut from 48 to
# keep the script within its budget; the RPC window takes half as many)
FLEET_WINDOW = 12
FLEET_WORKLOAD = dict(seed=5, num_tenants=8, skew=1.2, prefix_len=512,
                      tail_len=(32, 256), max_new=(16, 32))


def fleet_report_line(tag, rep, smi):
    keys = ("policy", "rpc", "tokens_per_sec", "offered_rps", "achieved_rps",
            "ttft_ms_p50", "ttft_ms_p99", "itl_ms_p50", "itl_ms_p99",
            "requests_per_replica", "replica_occupancy", "router_hit_rate",
            "prefix_queries", "prefix_hit_rate", "accepted_tokens_per_tick",
            "preemptions", "timed_out_requests", "num_requests",
            "tokens_generated", "decode_steps", "tenants_seen", "wall_s",
            "deadline_s")
    log(f"[{tag}] report " + json.dumps({k: rep.get(k) for k in keys})
        + f" mean decode tick ms per replica "
        f"{rep['straggler']['per_replica_ms']} (card: {smi})")


def phase_serve_fleet(model, smi):
    """serve-fleet: two paged bf16 replicas of the model (8 slots, blocks
    of 128, prefix cache, seeds 21 and 22, warmed over every bucket)
    behind ``Router``; ``MultiTenantWorkload(50304, seed=5,
    num_tenants=8, skew=1.2, prefix_len=512, tail_len=(32, 256),
    max_new=(16, 32))``, ``warm_fleet``, then ``run_fleet_loadtest``
    windows with ``deadline_s=120``: FLEET_WINDOW requests at 2 rps under
    ``prefix``, half as many at 2 rps through the RPC shim (``rpc=True``,
    same replicas), and FLEET_WINDOW at 2 rps under ``round_robin`` on
    fresh replicas.
    Each window: every planned token, no timeout, router hits under
    ``prefix``, and with launch counts zeroed before it and read after,
    flash once a layer a prefill without a cached prefix and the paged
    decode kernel once a layer a decode step, summed over the replicas
    that two driver threads stepped, and one host read a step and
    admission.  Both replicas leak-free after ``Router.drain()``.
    Nothing is gated on timing."""
    from paddle_tpu_torch.inference import (InferenceEngine,
                                            MultiTenantWorkload, Router,
                                            run_fleet_loadtest, warm_fleet)
    tag = "serve-fleet"
    vocab = model.cfg.vocab_size
    layers = model.cfg.num_layers
    total, problems, summary = {}, [], {}

    def planned(n):
        wl = MultiTenantWorkload(vocab, **FLEET_WORKLOAD)
        return sum(wl.sample()[2] for _ in range(n))

    def window(name, router, n, rpc=False):
        reps = router.replicas
        before = [(dict(r._timings), r._prefix.hit_queries) for r in reps]
        torch.cuda.synchronize()
        zero_launches()
        with HostReads() as reads:
            rep = run_fleet_loadtest(
                router, n, 2.0, workload=MultiTenantWorkload(
                    vocab, **FLEET_WORKLOAD), deadline_s=120.0, rpc=rpc)
        torch.cuda.synchronize()
        launches = read_launches()
        add_launches(total, launches)
        fleet_report_line(f"{tag} {name}", rep, smi)
        d = [{key: r._timings[key] - t0[key] for key in
              ("decode_steps", "prefills", "decode_host_syncs",
               "prefill_host_syncs")} | {"hits": r._prefix.hit_queries - h0}
             for r, (t0, h0) in zip(reps, before)]
        want = {"flash_fwd": layers * sum(x["prefills"] - x["hits"]
                                          for x in d),
                "paged_decode_attention": layers * sum(x["decode_steps"]
                                                       for x in d)}
        check_launches(f"{tag} {name}", launches, want, problems)
        syncs = sum(x["decode_host_syncs"] + x["prefill_host_syncs"]
                    for x in d)
        log(f"[{tag} {name}] per replica {d}; host reads {reads.n}; "
            f"launches {{{', '.join(f'{k}: {c}' for k, c in launches.items() if c)}}}")
        if reads.n != syncs or any(x["decode_host_syncs"]
                                   != x["decode_steps"] for x in d):
            problems.append(f"{name}: {reads.n} host reads, {syncs} syncs")
        want_tokens = planned(n)
        if rep["num_requests"] != n or rep["tokens_generated"] != want_tokens:
            problems.append(f"{name}: {rep['num_requests']} requests, "
                            f"{rep['tokens_generated']} tokens of "
                            f"{want_tokens}")
        if rep["timed_out_requests"]:
            problems.append(f"{name}: {rep['timed_out_requests']} timed out")
        if router.policy == "prefix" and not rep["router_hit_rate"] > 0:
            problems.append(f"{name}: router hit rate 0 under prefix")
        summary[name] = (rep["router_hit_rate"], rep["prefix_hit_rate"],
                         rep["ttft_ms_p50"], rep["ttft_ms_p99"],
                         rep["itl_ms_p99"])
        return rep

    def fleet(policy):
        reps = [InferenceEngine(model, batch_slots=8, kv_layout="paged",
                                kv_block_size=128, prefix_cache=True,
                                seed=seed, device="cuda")
                for seed in (21, 22)]
        for r in reps:
            r.warmup(r.buckets)
        router = Router(reps, policy=policy)
        t0 = time.perf_counter()
        warm_fleet(router, MultiTenantWorkload(vocab, **FLEET_WORKLOAD))
        log(f"[{tag}] {policy}: warm_fleet {time.perf_counter() - t0:.2f} s,"
            f" routed {router.stats()['routed_per_replica']}")
        return router

    def contention(router):
        """Where a fleet step's time goes on one card: 8 fresh 200-token
        prompts with 32 new tokens on replica 0 alone, then 8 on each
        replica stepped in turn from one thread (``Router.run``), then 8
        on each from a thread of its own; mean decode step ms per replica
        and the wall of each run."""
        import threading
        rng = np.random.RandomState(41)
        out = {}
        for name, reps, threaded in (("alone", router.replicas[:1], False),
                                     ("one thread", router.replicas, False),
                                     ("two threads", router.replicas, True)):
            before = [(r._timings["decode_ms"], r._timings["decode_steps"])
                      for r in reps]
            for r in reps:
                for p in random_prompts(rng, vocab, [200] * 8):
                    r.add_request(p, max_new_tokens=32)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if threaded:
                ths = [threading.Thread(target=r.run) for r in reps]
                for th in ths:
                    th.start()
                for th in ths:
                    th.join()
            else:
                Router(reps).run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            out[name] = ([round((r._timings["decode_ms"] - ms)
                                / (r._timings["decode_steps"] - n), 3)
                          for r, (ms, n) in zip(reps, before)],
                         round(wall, 3))
            for r in reps:
                r.results.clear()
                r.request_stats.clear()
        log(f"[{tag}] contention probe (mean decode step ms per replica, "
            f"wall s) {out} (card: {smi})")

    def drained(name, router):
        if router.drain():
            problems.append(f"{name}: drain left queued requests")
        log(f"[{tag} {name}] both pools leak-free after Router.drain()")

    router = fleet("prefix")
    window("prefix", router, FLEET_WINDOW)
    window("prefix rpc", router, FLEET_WINDOW // 2, rpc=True)
    contention(router)
    drained("prefix", router)
    del router
    del_all()
    router = fleet("round_robin")
    window("round_robin", router, FLEET_WINDOW)
    drained("round_robin", router)
    del router
    del_all()
    log(f"[{tag}] (router hit rate, prefix hit rate, TTFT p50, TTFT p99, "
        f"ITL p99 ms) by window: {summary} (card: {smi})")
    finish(tag, problems)
    return total


TELEMETRY_ENV = {
    True: {"PADDLE_TPU_METRICS": "1", "PADDLE_TPU_FLIGHTREC": "1",
           "PADDLE_TPU_WATCHDOG_S": "120"},
    False: {"PADDLE_TPU_METRICS": "0", "PADDLE_TPU_FLIGHTREC": "0",
            "PADDLE_TPU_WATCHDOG_S": ""},
}


@contextlib.contextmanager
def telemetry(on):
    """Telemetry on (the metrics registry, the flight recorder, a 120 s
    stall watchdog, the span tracer armed) or off (all four off) for the
    block; the previous settings come back after it."""
    from paddle_tpu_torch.observability import spans
    env = TELEMETRY_ENV[on]
    old = {k: os.environ.get(k) for k in env}
    tr = spans.tracer()
    was = tr.active
    os.environ.update(env)
    tr.active = on
    try:
        yield
    finally:
        tr.active = was
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def count_window_prefills(eng):
    """Note the engine's prefill count when its capture window opens and
    closes (``{"_start": n, "_stop": m}``)."""
    w, seen = eng._profile, {}
    for name in ("_start", "_stop"):
        def wrapped(orig=getattr(w, name), name=name):
            seen[name] = eng._timings["prefills"]
            orig()
        setattr(w, name, wrapped)
    return seen


BLOCKING_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")


def read_capture(path, steps):
    """A torch.profiler Chrome trace (the one a capture window wrote):
    device kernel names, kernel ms and wall ms (first event to last) per
    step, the busy share, and per step the blocking runtime calls and
    the device-to-pageable copies."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    wall = (max(e["ts"] + e["dur"] for e in events)
            - min(e["ts"] for e in events)) / 1e3
    busy = sum(e["dur"] for e in kernels) / 1e3
    return {
        "names": sorted({e["name"] for e in kernels}),
        "kernel_ms": busy / steps, "wall_ms": wall / steps,
        "busy_share": busy / wall,
        "blocking": sum(e.get("cat") == "cuda_runtime"
                        and e["name"] in BLOCKING_CALLS
                        for e in events) / steps,
        "pageable": sum(e.get("cat") == "gpu_memcpy" and "Pageable"
                        in e["name"] for e in events) / steps,
    }


def has_kernel(names, *parts):
    return any(all(p in n for p in parts) for n in names)


def timed_run(eng, prompts, new_tokens):
    """One greedy run of ``prompts`` on a warmed engine (the radix cache
    flushed first); returns tokens/s and the streams."""
    eng.flush_prefix_cache()
    rids = [eng.add_request(p, max_new_tokens=new_tokens) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    streams = [out.pop(r).tolist() for r in rids]
    return sum(map(len, streams)) / wall, streams


# rounds of off, on, on, off in serve-telemetry's tokens/s turns (cut from
# three to keep the script within its budget)
TEL_ROUNDS = 1


def phase_serve_telemetry(model, smi):
    """Telemetry on the serving path: gpt3-1.3b (full width and depth),
    8 slots, serve's 16 prompts with 32 new greedy tokens, a dense and a
    paged (blocks of 128) bf16 engine after ``warmup()``, each run with
    telemetry off and then on (tracer, metrics, flight recorder, a 120 s
    watchdog and ``PADDLE_TPU_PROFILE=8:12:<dir>``: a capture over decode
    ticks 8-11).  The off run carries the same capture window, as the
    measuring instrument only.  Checks: identical greedy streams, one
    host read per decode step and admission and the same
    ``host_sync_count()`` delta on and off; the same blocking CUDA
    runtime calls and device-to-pageable copies per tick in both
    captures; the tracer's export validates with one track per request
    (queued, prefill, decode); the capture holds the layout's decode
    kernel (and the flash forward where an admission fell in the
    window); the registry's tick, token and prefill counters equal
    ``stats()``; the ledger's params and KV-cache bytes equal the
    tensors'; ``stats()["doctor"]`` is a list; a forced flight-recorder
    dump loads back with the decode ticks in its ring.  Then tokens/s on
    and off in turns (TEL_ROUNDS rounds of off, on, on, off), beside the
    card."""
    import shutil
    from paddle_tpu_torch.distributed import async_dispatch
    from paddle_tpu_torch.inference import InferenceEngine
    from paddle_tpu_torch.observability import ProfileWindow, flightrec, spans
    tag = "serve-telemetry"
    prompts = serve_prompts(model.cfg.vocab_size)
    new = 32
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_telemetry")
    shutil.rmtree(root, ignore_errors=True)
    paths, problems, ratios = {}, [], {}
    tr = spans.tracer()
    try:
        for layout in ("dense", "paged"):
            kw = dict(kv_layout="paged", kv_block_size=128) \
                if layout == "paged" else {}
            runs = {}
            engines = {}
            for on in (False, True):
                side = "on" if on else "off"
                logdir = os.path.join(root, f"{layout}-{side}")
                with telemetry(on):
                    os.environ["PADDLE_TPU_PROFILE"] = f"8:12:{logdir}"
                    try:
                        eng = InferenceEngine(model, batch_slots=8, seed=7,
                                              device="cuda", **kw)
                    finally:
                        del os.environ["PADDLE_TPU_PROFILE"]
                    eng.warmup(eng.buckets)
                    engines[on] = eng
                    if not (isinstance(eng._profile, ProfileWindow)
                            and (eng._profile.start, eng._profile.stop)
                            == (8, 12)):
                        problems.append(f"{layout} {side}: no capture "
                                        f"window from PADDLE_TPU_PROFILE")
                    window = count_window_prefills(eng)
                    tr.clear()
                    flightrec.recorder().ring.clear()
                    rids = [eng.add_request(p, max_new_tokens=new)
                            for p in prompts]
                    s0 = async_dispatch.host_sync_count()
                    out, launches, d, bad = measured(
                        f"{tag} {layout} {side}", eng, eng.run)
                    syncs = async_dispatch.host_sync_count() - s0
                    problems += bad
                    paths[f"{tag}-{layout}-{side}"] = launches
                    st = eng.stats()
                    cap = read_capture(eng._profile.trace_path, 4)
                    runs[on] = dict(streams=[out[r].tolist() for r in rids],
                                    syncs=syncs, d=d, st=st, cap=cap,
                                    window=dict(window))
                    log(f"[{tag}] {layout} {side}: capture "
                        f"{eng._profile.trace_path}: per decode tick "
                        f"{cap['kernel_ms']:.3f} ms of device kernels in "
                        f"{cap['wall_ms']:.3f} ms (busy share "
                        f"{cap['busy_share']:.3f}), {cap['blocking']:.2f} "
                        f"blocking runtime calls and {cap['pageable']:.2f} "
                        f"device-to-pageable copies; {len(cap['names'])} "
                        f"kernel names; host_sync_count delta {syncs} over "
                        f"{d['decode_steps']} decode steps and "
                        f"{d['prefills']} admissions; prefills at the "
                        f"window's open/close {window} (card: {smi})")
                    if on:
                        problems += check_serve_telemetry(
                            tag, layout, eng, st, d, cap, window, rids,
                            root)
            off, on_ = runs[False], runs[True]
            if on_["streams"] != off["streams"]:
                problems.append(f"{layout}: streams differ on and off")
            for name, r in (("off", off), ("on", on_)):
                if r["d"]["decode_host_syncs"] != r["d"]["decode_steps"]:
                    problems.append(f"{layout} {name}: decode syncs "
                                    f"{r['d']['decode_host_syncs']} over "
                                    f"{r['d']['decode_steps']} steps")
            if on_["syncs"] != off["syncs"]:
                problems.append(f"{layout}: host_sync_count delta "
                                f"{on_['syncs']} on, {off['syncs']} off")
            keys = ("blocking", "pageable")
            if [on_["cap"][k] for k in keys] != [off["cap"][k] for k in keys] \
                    or not off["cap"]["blocking"] >= 1:
                problems.append(f"{layout}: blocking calls per tick on "
                                f"{[on_['cap'][k] for k in keys]}, off "
                                f"{[off['cap'][k] for k in keys]}")
            # tokens/s in turns on the warmed engines: TEL_ROUNDS rounds
            # of off, on, on, off
            tps = {False: [], True: []}
            for on in (False, True, True, False) * TEL_ROUNDS:
                with telemetry(on):
                    rate, streams = timed_run(engines[on], prompts, new)
                tps[on].append(rate)
                if streams != off["streams"]:
                    problems.append(f"{layout}: a timed run's streams "
                                    f"differ")
            ratios[layout] = np.median(tps[True]) / np.median(tps[False])
            log(f"[{tag}] {layout}: tokens/s in turns (median) off "
                f"{[round(x, 1) for x in tps[False]]}, on "
                f"{[round(x, 1) for x in tps[True]]}: on/off "
                f"{ratios[layout]:.4f} (card: {smi})")
            for eng in engines.values():
                if eng.watchdog is not None:
                    eng.watchdog.disarm()
            del engines, eng
            del_all()
    finally:
        tr.stop()
        tr.clear()
        shutil.rmtree(root, ignore_errors=True)
    finish(tag, problems)
    return paths


def check_serve_telemetry(tag, layout, eng, st, d, cap, window, rids, root):
    """The telemetry-on run's own checks (see phase_serve_telemetry)."""
    from paddle_tpu_torch.observability import (flightrec, spans,
                                                validate_chrome_trace)
    problems = []
    doc = spans.tracer().chrome_trace()
    n = validate_chrome_trace(doc)
    tracks = {}
    for e in doc["traceEvents"]:
        if e.get("pid") == spans.PID_REQUESTS and e["ph"] in ("X", "i"):
            tracks.setdefault(e["tid"], []).append(e["name"])
    if sorted(tracks) != sorted(rids) or any(
            t[:3] != ["queued", "prefill", "decode"]
            for t in tracks.values()):
        problems.append(f"{layout}: request tracks {tracks}")
    ticks = sum(e["name"] == "decode_tick" for e in doc["traceEvents"])
    paged = layout == "paged"
    decode = has_kernel(cap["names"], "decode_attn::decode_kernel",
                        "true>" if paged else "false>")
    flash = has_kernel(cap["names"], "attn_fwd_kernel")
    admitted = window["_stop"] - window["_start"]
    if not decode or (admitted and not flash):
        problems.append(f"{layout}: capture kernels {cap['names']}")
    registry = (eng._m_ticks.value, eng._m_tokens.value,
                eng._m_prefills.value)
    want = (st["decode_steps"], st["tokens_generated"], st["prefills"])
    if registry != want or ticks != d["decode_steps"]:
        problems.append(f"{layout}: registry {registry} != stats {want}, "
                        f"{ticks} decode_tick spans")
    mine = {t["category"]: t["bytes"] for t in st["hbm"]["tracked"]
            if t["name"] == eng.telemetry_label}
    params = sum(p.numel() * p.element_size()
                 for p in eng.model.parameters())
    if (mine.get("params"), mine.get("kv_cache")) != \
            (params, cache_bytes(eng.cache)):
        problems.append(f"{layout}: ledger {mine}")
    if not isinstance(st["doctor"], list) or eng.watchdog is None \
            or eng.watchdog.stalls:
        problems.append(f"{layout}: doctor {st['doctor']!r}, watchdog "
                        f"{eng.watchdog}")
    path = flightrec.dump("smoke", directory=root)
    ring = [e["kind"] for e in
            flightrec.load_bundle(path)["bundle"]["ring"]]
    if ring.count("decode_tick") != min(d["decode_steps"], 256):
        problems.append(f"{layout}: bundle ring {ring[:8]}...")
    log(f"[{tag}] {layout} on: {n} trace events, {len(tracks)} request "
        f"tracks, {ticks} decode_tick spans; registry ticks/tokens/prefills "
        f"{registry}; ledger params {mine.get('params')} kv_cache "
        f"{mine.get('kv_cache')} bytes (capacity "
        f"{st['hbm']['capacity_bytes']}); doctor {st['doctor']}; bundle "
        f"{path} with {len(ring)} ring entries; decode kernel in the "
        f"capture {decode}, flash forward {flash} ({admitted} admissions "
        f"in the window)")
    return problems


def warmup_check():
    """In a fresh process: gpt3-1.3b at 2 layers on the card and the same
    with its second block MoE, ``warmup()`` on a dense and a paged engine
    of each, then 8 requests through each engine; fails if
    serving loaded or built any CUDA library after the warmups.  The
    parent arms the tracer, the metrics and the watchdog (no capture
    window): telemetry must load nothing either."""
    import dataclasses
    from paddle_tpu_torch.core import random as prandom
    from paddle_tpu_torch.inference import InferenceEngine
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_configs
    from paddle_tpu_torch.observability import spans
    from paddle_tpu_torch.ops import _build
    cfg = dataclasses.replace(gpt_configs()["gpt3-1.3b"], num_layers=2)
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                           generator=prandom.seed(1234, "cuda"))
    # and a 2-layer GPT-MoE (its second block MoE): warmup runs the MoE
    # layer (router, dispatch, expert products, combine) on each path
    moe = GPTForCausalLM(moe_cfg(layers=2), device="cuda",
                         dtype=torch.bfloat16,
                         generator=prandom.seed(1234, "cuda"))
    engines = [InferenceEngine(m, batch_slots=8, device="cuda", **kw)
               for m in (model, moe)
               for kw in ({}, dict(kv_layout="paged", kv_block_size=128))]
    for eng in engines:
        eng.warmup()
    libs, logs = sorted(_build._LIBS), sorted(_build._LOGS)
    builds = []
    orig = _build.build
    _build.build = lambda *a, **k: builds.append(a) or orig(*a, **k)
    try:
        rng = np.random.RandomState(41)
        prompts = random_prompts(rng, cfg.vocab_size,
                                 rng.randint(32, 1537, size=8))
        for eng in engines:
            rids = [eng.add_request(p, max_new_tokens=16) for p in prompts]
            out = eng.run()
            if [len(out[r]) for r in rids] != [16] * 8:
                raise SystemExit("warmup-check: short streams")
    finally:
        _build.build = orig
    torch.cuda.synchronize()
    after = sorted(_build._LIBS)
    log(f"[warmup-check] libraries after warmup {libs}; after serving "
        f"{after}; builds after warmup {len(builds)}; built in this process "
        f"{logs}")
    if after != libs or builds or sorted(_build._LOGS) != logs:
        raise SystemExit("warmup-check: serving loaded or built a library "
                         "after warmup")
    armed = (spans.tracer().active, len(spans.tracer()) > 0,
             [eng.watchdog is not None for eng in engines],
             [eng._m_ticks.value > 0 for eng in engines])
    log(f"[warmup-check] telemetry armed: tracer active, spans recorded, "
        f"watchdogs, registry ticks {armed}")
    if armed != (True, True, [True] * 4, [True] * 4):
        raise SystemExit("warmup-check: telemetry was not armed")
    log("[warmup-check] ok")


def phase_warmup_child():
    t0 = time.perf_counter()
    env = dict(os.environ, PADDLE_TPU_SPANS="1", PADDLE_TPU_METRICS="1",
               PADDLE_TPU_WATCHDOG_S="120")
    env.pop("PADDLE_TPU_PROFILE", None)
    proc = subprocess.run([sys.executable, __file__, "--warmup-check"],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    for line in proc.stdout.splitlines():
        log(f"  {line}")
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"warmup-check child failed (exit "
                         f"{proc.returncode})")
    log(f"[warmup-check] child ok in {time.perf_counter() - t0:.1f} s")


def _padded(ids, start, stop, bucket):
    out = torch.zeros((1, bucket), dtype=torch.long, device="cuda")
    out[:, :stop - start] = ids[:, start:stop]
    return out


# (check, worst) of every teacher-forced check run, for the fp8 error
# measurement (``--fp8-teacher-error``)
TEACHER_WORST = []


def teacher_check(what, got, ref, first, tol):
    """Logits of prefill + decode (``got [steps, V]``) against the
    forward's at positions ``first ...``, each row against its own
    largest |logit|."""
    got = torch.cat(got).float()
    want = ref[0, first:first + got.shape[0]]
    err = (got - want).abs().amax(-1)
    worst = (err / want.abs().amax(-1)).max().item()
    TEACHER_WORST.append((what, worst))
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    ok = bool(torch.isfinite(got).all().item()) and worst <= tol
    log(f"[teacher] {what}: max|diff|={err.max().item():.4e}, worst position "
        f"max|diff|/max|logit|={worst:.4e} (tol {tol}) argmax agreement "
        f"{agree:.3f} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"teacher-forced check failed: {what}")


def phase_teacher_forced(model, kv_dtypes=(None, "int8", "fp8"),
                         tol_fp8=None):
    """Prefill + decode steps against one no-cache forward over the same
    tokens: the dense cache, then the paged cache cold (flash prefill)
    and over a cached 1024-token prefix (the composite hit path), each in
    bf16, int8 and fp8 (``kv_dtypes``); then the hit prefill timed against
    the cold one."""
    from paddle_tpu_torch.inference.paged_kv import init_paged_cache
    cfg = model.cfg
    rng = np.random.RandomState(11)
    plen, steps = 200, 8
    hit_prefix, hit_len = 1024, 1100
    ids = torch.from_numpy(
        rng.randint(0, cfg.vocab_size, size=(1, hit_len + steps))).cuda()
    one = torch.ones(1, dtype=torch.int32, device="cuda")
    bs, mb = 128, cfg.max_seq_len // 128
    with torch.no_grad():
        ref = model(ids).float()                       # [1, S, V]
        for kv_dtype in kv_dtypes:
            tol = {None: TOL_TEACHER, "int8": TOL_TEACHER_INT8,
                   "fp8": tol_fp8 or TOL_TEACHER_FP8}[kv_dtype]
            name = kv_dtype or "bf16"
            cache = model.init_kv_cache(1, kv_dtype=kv_dtype)
            got = [model.prefill(_padded(ids, 0, plen, 256), cache, 0,
                                 plen)[0]]
            for t in range(plen, plen + steps - 1):
                got.append(model.decode_step(ids[:, t], cache, one)[0])
            teacher_check(f"{name} dense: prefill({plen}, bucket 256) + "
                          f"{steps - 1} decode steps vs forward",
                          got, ref, plen - 1, tol)
            del cache

            pool = init_paged_cache(model, 1 + 2 + 9 + 16, bs,
                                    kv_dtype=kv_dtype)

            def table(blocks):
                row = torch.zeros(mb, dtype=torch.int32, device="cuda")
                row[:len(blocks)] = torch.tensor(blocks, dtype=torch.int32)
                return row

            def decode_paged(row, start, n):
                out = []
                for t in range(start, start + n):
                    out.append(model.decode_step_paged(
                        ids[:, t], pool, row[None],
                        torch.tensor([t], dtype=torch.int32,
                                     device="cuda"))[0])
                return out

            cold_row = table([1, 2])
            got = [model.prefill_paged(_padded(ids, 0, plen, 256), pool,
                                       cold_row, 0, plen)[0]]
            got += decode_paged(cold_row, plen, steps - 1)
            teacher_check(f"{name} paged cold: prefill_paged({plen}, bucket "
                          f"256) + {steps - 1} decode steps vs forward",
                          got, ref, plen - 1, tol)
            # slot A leaves the prefix in blocks 3..10; slot B shares them
            # and prefills its 76-token suffix over them
            model.prefill_paged(_padded(ids, 0, hit_prefix, hit_prefix), pool,
                                table(list(range(3, 11))), 0, hit_prefix)
            hit_row = table(list(range(3, 12)))
            suffix = _padded(ids, hit_prefix, hit_len, 128)
            got = [model.prefill_paged(suffix, pool, hit_row, hit_prefix,
                                       hit_len - hit_prefix)[0]]
            got += decode_paged(hit_row, hit_len, steps - 1)
            teacher_check(f"{name} paged hit: {hit_prefix} cached tokens + "
                          f"prefill_paged({hit_len - hit_prefix}, bucket 128) "
                          f"+ {steps - 1} decode steps vs forward",
                          got, ref, hit_len - 1, tol)

            # the window steps: a prompt fed in chunks of 512 (last-token
            # logits against the forward), and a K+1 = 5 verify window
            # against 5 sequential decode steps and the forward
            def chunked(prefill_chunk, extra=()):
                pos, lg = 0, None
                while pos < hit_len:
                    n = min(512, hit_len - pos)
                    lg, _ = prefill_chunk(
                        _padded(ids, pos, pos + n, 512), *extra,
                        torch.tensor([pos], dtype=torch.int32, device="cuda"),
                        torch.tensor([n], dtype=torch.int32, device="cuda"))
                    pos += n
                return lg
            cache = model.init_kv_cache(1, kv_dtype=kv_dtype)
            teacher_check(f"{name} dense chunked prefill ({hit_len} tokens, "
                          f"chunks of 512) vs forward",
                          [chunked(lambda *a: model.prefill_chunk(
                              a[0], cache, *a[1:]))], ref, hit_len - 1, tol)
            chunk_row = table(list(range(12, 21)))
            teacher_check(f"{name} paged chunked prefill ({hit_len} tokens, "
                          f"chunks of 512) vs forward",
                          [chunked(lambda *a: model.prefill_chunk_paged(
                              a[0], pool, chunk_row[None], *a[1:]))], ref,
                          hit_len - 1, tol)
            seq_cache = model.init_kv_cache(1, kv_dtype=kv_dtype)
            for c in (cache, seq_cache):
                c.lengths.zero_()
                model.prefill(_padded(ids, 0, plen, 256), c, 0, plen)
            win, _ = model.verify_step(ids[:, plen:plen + 5], cache)
            seq = torch.cat([model.decode_step(ids[:, t], seq_cache, one)[0]
                             for t in range(plen, plen + 5)]).float()
            err = (win[0].float() - seq).abs().amax(-1)
            worst = (err / seq.abs().amax(-1)).max().item()
            TEACHER_WORST.append((f"{name} verify vs decode", worst))
            log(f"[teacher] {name} dense verify window (K+1 = 5 after "
                f"{plen} tokens) vs 5 sequential decode steps: worst position "
                f"max|diff|/max|logit|={worst:.4e} (tol {tol}) "
                f"{'ok' if worst <= tol else 'FAIL'}")
            if not worst <= tol:
                raise SystemExit(f"teacher-forced check failed: {name} "
                                 f"verify window vs decode steps")
            teacher_check(f"{name} dense verify window (K+1 = 5) vs forward",
                          [win[0]], ref, plen, tol)
            win_p, _ = model.verify_step_paged(
                ids[:, plen:plen + 5], pool, cold_row[None],
                torch.tensor([plen], dtype=torch.int32, device="cuda"))
            teacher_check(f"{name} paged verify window (K+1 = 5) vs forward",
                          [win_p[0]], ref, plen, tol)
            del cache, seq_cache

            # the hit prefill against a cold prefill of the same prompt
            cold_full = table(list(range(12, 28)))
            whole = _padded(ids, 0, hit_len, 2048)

            def timed(fn, reps=5):
                fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) * 1e3 / reps
            t_cold = timed(lambda: model.prefill_paged(whole, pool, cold_full,
                                                       0, hit_len))
            t_hit = timed(lambda: model.prefill_paged(
                suffix, pool, hit_row, hit_prefix, hit_len - hit_prefix))
            log(f"[teacher] {name} paged prefill of a {hit_len}-token prompt: "
                f"cold (bucket 2048, flash) {t_cold:.3f} ms, over a cached "
                f"{hit_prefix}-token prefix (bucket 128, composite) "
                f"{t_hit:.3f} ms (host clock, mean of 5)")
            del pool


FP8_ERROR_SEEDS = (1234, 1, 2)


def fp8_teacher_error():
    """``python3 chip_smoke.py --fp8-teacher-error``: the teacher-forced
    error of an fp8 cache at full width and depth without the e4m3
    kernels.  For each weight seed of ``FP8_ERROR_SEEDS`` the fp8 teacher
    checks of ``phase_teacher_forced`` run with the four attention entry
    points swapped for their plain versions (rows 5f, 7f, 8bf and 9bf's
    math in f32 on the card's tensors) and no bound; prints the worst of
    each check and of all, from which ``TOL_TEACHER_FP8`` is set."""
    from paddle_tpu_torch import ops
    da = importlib.import_module("paddle_tpu_torch.ops.decode_attention")
    phase_device()
    phase_build()
    plain = {"decode_attention": da._decode_plain,
             "paged_decode_attention": da._paged_plain,
             "decode_attention_window": da._window_plain,
             "paged_decode_attention_window": da._paged_window_plain}
    kept = {n: getattr(ops, n) for n in plain}
    worst = {}
    try:
        for n, fn in plain.items():
            setattr(ops, n, fn)
        for seed in FP8_ERROR_SEEDS:
            model = build_model(seed)
            TEACHER_WORST.clear()
            phase_teacher_forced(model, ("fp8",), tol_fp8=float("inf"))
            worst[seed] = max(w for _, w in TEACHER_WORST)
            log(f"[fp8-teacher-error] seed {seed}: worst "
                f"{worst[seed]:.4e} ({max(TEACHER_WORST, key=lambda x: x[1])[0]})")
            del model
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        for n, fn in kept.items():
            setattr(ops, n, fn)
    log(f"[fp8-teacher-error] worst over seeds {list(worst)}: "
        f"{max(worst.values()):.4e}")


def phase_teacher_mega_quant(model):
    """Megakernel decode steps against one no-cache forward over the same
    tokens (dense and paged, bf16 and int8 caches; 5% and 10% of each
    position's logit scale, as the composed steps), and the int8-compute
    model's prefill + decode against its own int8 forward (5%)."""
    from paddle_tpu_torch.inference.paged_kv import init_paged_cache
    cfg = model.cfg
    rng = np.random.RandomState(11)
    plen, steps = 200, 8
    ids = torch.from_numpy(
        rng.randint(0, cfg.vocab_size, size=(1, plen + steps))).cuda()
    one = torch.ones(1, dtype=torch.int32, device="cuda")
    mb = cfg.max_seq_len // 128
    row = torch.zeros(mb, dtype=torch.int32, device="cuda")
    row[:2] = torch.tensor([1, 2], dtype=torch.int32)
    with torch.no_grad():
        ref = model(ids).float()
        model.enable_decode_megakernel(True)
        try:
            for kv_dtype in (None, "int8"):
                tol = TOL_TEACHER if kv_dtype is None else TOL_TEACHER_INT8
                name = "bf16" if kv_dtype is None else "int8"
                cache = model.init_kv_cache(1, kv_dtype=kv_dtype)
                got = [model.prefill(_padded(ids, 0, plen, 256), cache, 0,
                                     plen)[0]]
                for t in range(plen, plen + steps - 1):
                    got.append(model.decode_step(ids[:, t], cache, one)[0])
                teacher_check(f"{name} dense megakernel: prefill({plen}) + "
                              f"{steps - 1} fused decode steps vs forward",
                              got, ref, plen - 1, tol)
                pool = init_paged_cache(model, 4, 128, kv_dtype=kv_dtype)
                got = [model.prefill_paged(_padded(ids, 0, plen, 256), pool,
                                           row, 0, plen)[0]]
                for t in range(plen, plen + steps - 1):
                    got.append(model.decode_step_paged(
                        ids[:, t], pool, row[None],
                        torch.tensor([t], dtype=torch.int32,
                                     device="cuda"))[0])
                teacher_check(f"{name} paged megakernel: prefill_paged("
                              f"{plen}) + {steps - 1} fused decode steps vs "
                              f"forward", got, ref, plen - 1, tol)
                del cache, pool
        finally:
            model.enable_decode_megakernel(False)
        model.enable_quantize("int8")
        try:
            ref_q = model(ids).float()
            cache = model.init_kv_cache(1)
            got = [model.prefill(_padded(ids, 0, plen, 256), cache, 0,
                                 plen)[0]]
            for t in range(plen, plen + steps - 1):
                got.append(model.decode_step(ids[:, t], cache, one)[0])
            teacher_check(f"int8 compute dense: prefill({plen}) + "
                          f"{steps - 1} decode steps vs the int8 forward",
                          got, ref_q, plen - 1, TOL_TEACHER)
            agree = (ref_q[0].argmax(-1) == ref[0].argmax(-1)).float().mean()
            log(f"[teacher] int8 compute forward vs bf16 forward: top-1 "
                f"agreement {agree.item():.4f} over {ids.shape[1]} positions")
        finally:
            model.enable_quantize(None)


def viterbi_np(em, tr, lengths):
    """Viterbi over float64 numpy arrays, row by row, with the decoding
    API's conventions: tag N-2 starts and tag N-1 ends each path, and
    positions from a row's last one on keep its last tag."""
    b, t, n = em.shape
    scores, paths = np.zeros(b), np.zeros((b, t), np.int64)
    for i in range(b):
        L = int(lengths[i])
        alpha = em[i, 0] + tr[n - 2]
        back = np.zeros((L, n), np.int64)
        for j in range(1, L):
            cand = alpha[:, None] + tr
            back[j] = cand.argmax(axis=0)
            alpha = cand.max(axis=0) + em[i, j]
        final = alpha + tr[:, n - 1]
        tag = int(final.argmax())
        scores[i] = final[tag]
        paths[i, L - 1:] = tag
        for j in range(L - 1, 0, -1):
            tag = int(back[j, tag])
            paths[i, j - 1] = tag
    return scores, paths


def decoding_prompts(vocab):
    """Two prompts of 256 and 768 tokens whose last token is one shared
    id (the search's ``bos_id``)."""
    rng = np.random.RandomState(31)
    shared = int(rng.randint(0, vocab))
    return [np.concatenate([rng.randint(0, vocab, n - 1), [shared]])
            for n in (256, 768)], shared


def prefilled_cache(model, prompts, k, kv_dtype, max_len):
    """A cache of ``len(prompts) * k`` slots sized prompt + ``max_len``,
    slot ``b * k + j`` prefilled with prompt b without its last token."""
    cache = model.init_kv_cache(len(prompts) * k,
                                capacity=max(map(len, prompts)) + max_len,
                                kv_dtype=kv_dtype)
    for b, p in enumerate(prompts):
        ids = torch.from_numpy(p[:-1][None]).cuda()
        for j in range(k):
            model.prefill(ids, cache, b * k + j, len(p) - 1)
    return cache


def counted_search(tag, model, search, k, kv_dtype, prompts, max_len):
    """Prefill a fresh cache and run ``search(step_fn, cache)`` with every
    launch count at 0 and every host read counted; checks the launches
    (the flash kernel once a layer per prefill, the cache form's decode
    kernel once a layer per step, nothing else) and one host read per
    step after the first.  Returns ``(output, launches, steps, problems)``."""
    from paddle_tpu_torch.text import gpt_step_fn
    layers = model.cfg.num_layers
    torch.cuda.synchronize()
    zero_launches()
    cache = prefilled_cache(model, prompts, k, kv_dtype, max_len)
    step = gpt_step_fn(model)
    calls = []

    def counted(tokens, state):
        calls.append(1)
        return step(tokens, state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with HostReads() as reads:
        out = search(counted, cache)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    steps = len(calls)
    problems = []
    check_launches(tag, launches, {
        "decode_attention" + _tag(kv_dtype): layers * steps,
        "flash_fwd": layers * len(prompts) * k}, problems)
    early = steps < max_len
    if reads.n != steps - 1 + early:
        problems.append(f"{tag}: {reads.n} host reads over {steps} steps")
    log(f"[{tag}] {steps} steps in {wall:.3f} s: {steps / wall:.2f} steps/s "
        f"({len(prompts) * k} slots, cache {kv_dtype or 'bf16'} of "
        f"{cache.capacity} positions); host reads {reads.n}; launches "
        f"{{{', '.join(f'{n}: {v}' for n, v in launches.items() if v)}}}")
    del cache
    return out, launches, steps, problems


def beam_score_check(tag, model, prompts, seqs, scores, eos, tol):
    """Each beam's score against its tokens' log-probabilities under one
    no-cache forward of prompt + beam (up to its first EOS), within
    ``tol`` x the sum of those positions' max |logit|.  Returns the
    problems and the worst share read."""
    worst = 0.0
    problems = []
    for b, p in enumerate(prompts):
        beams = seqs[b].long()                       # [K, T]
        k, t = beams.shape
        ids = torch.cat([torch.from_numpy(p).cuda()[None].expand(k, -1),
                         beams[:, :-1]], dim=1)
        with torch.no_grad():
            logits = model(ids)[:, len(p) - 1:].float()   # [K, T, V]
        logp = torch.log_softmax(logits, dim=-1).gather(
            2, beams[..., None])[..., 0]
        is_eos = beams == eos
        first = torch.where(is_eos.any(1), is_eos.int().argmax(1),
                            torch.full_like(beams[:, 0], t - 1))
        live = torch.arange(t, device="cuda")[None] <= first[:, None]
        ref = (logp * live).sum(1)
        scale = (logits.abs().amax(-1) * live).sum(1)
        err = (scores[b] - ref).abs()
        worst = max(worst, (err / scale).max().item())
        if not bool((err <= tol * scale).all()):
            problems.append(f"{tag}: row {b} scores {scores[b].tolist()} vs "
                            f"forward {ref.tolist()}")
    log(f"[{tag}] beam scores vs one no-cache forward: worst "
        f"|diff| / sum of max|logit| {worst:.4e} (tol {tol})")
    return problems, worst


def beam_replay_check(tag, model, prompts, bos, seqs, scores, kv_dtype,
                      eos, tol):
    """Each beam's score against its own tokens fed back one step at a
    time through ``gpt_step_fn`` over a fresh cache of the search's slots
    (beam j of prompt b in slot b * K + j; no search, no regather): the
    same kernels at the same shapes over the history the beam should
    have read, its log-probabilities summed in the search's order (up to
    its first EOS).  Within ``tol`` x the sum of those positions' max
    |logit|; returns the problems and the worst share read."""
    from paddle_tpu_torch.text import gpt_step_fn
    b, k, t = seqs.shape
    beams = seqs.reshape(b * k, t).long()
    is_eos = beams == eos
    first = torch.where(is_eos.any(1), is_eos.int().argmax(1),
                        torch.full_like(beams[:, 0], t - 1))
    cache = prefilled_cache(model, prompts, k, kv_dtype, t)
    step = gpt_step_fn(model)
    tokens = torch.full((b * k,), bos, dtype=torch.int32, device="cuda")
    cum = torch.zeros(b * k, device="cuda")
    scale = torch.zeros(b * k, device="cuda")
    with torch.no_grad():
        for i in range(t):
            logits, cache = step(tokens, cache)
            logits = logits.float()
            logp = torch.log_softmax(logits, dim=-1).gather(
                1, beams[:, i:i + 1])[:, 0]
            live = i <= first
            cum = cum + torch.where(live, logp, 0.0)
            scale += torch.where(live, logits.abs().amax(-1), 0.0)
            tokens = beams[:, i].to(torch.int32)
    del cache
    err = (scores.reshape(-1) - cum).abs()
    worst = (err / scale).max().item()
    problems = []
    if not bool((err <= tol * scale).all()):
        problems.append(f"{tag}: scores {scores.tolist()} vs replay "
                        f"{cum.view(b, k).tolist()}")
    log(f"[{tag}] beam scores vs each beam replayed over a fresh cache: "
        f"worst |diff| / sum of max|logit| {worst:.4e} (tol {tol})")
    return problems, worst


BEAM_FAULTS = {
    # the cache is not regathered: each slot keeps its own history while
    # the beam's tokens follow its parents
    # (it moves a returned beam's score only where that beam's lineage
    # changed slots, which some searches' data do not do)
    "no-regather": lambda parents, k: torch.arange(
        parents.numel(), device=parents.device),
    # the right parents, but the prompts' rows swapped: each beam reads a
    # beam of the other prompt
    "swap-prompts": lambda parents, k: parents.roll(k),
    # the right parents, but reversed within each prompt's row: beam j
    # reads the history of beam k - 1 - j of its own prompt
    "reverse-beams": lambda parents, k: parents.view(-1, k).flip(1)
    .reshape(-1),
}


def beam_fault_check():
    """``python3 chip_smoke.py --beam-fault``: serve-decoding's beam
    searches (bf16, int8 and fp8 caches) run once as they are and once
    with each fault of ``BEAM_FAULTS`` planted in the cache regather;
    prints each search's worst beam-score share under the no-cache
    forward and under the replay, and at how many steps some beam's
    parent was another slot (counted on the card, no host read in the
    search).  Exits non-zero if a right search fails ``TOL_BEAM_SCORE``
    or ``TOL_BEAM_REPLAY``, or a search whose beams read the wrong prompt
    or the wrong beam passes the replay's ("no-regather" is reported and
    not judged)."""
    from paddle_tpu_torch.text import beam_search
    dec = importlib.import_module("paddle_tpu_torch.text.decoding")
    phase_device()
    phase_build()
    model = build_model()
    B, K, T = 2, 4, 32
    eos = model.cfg.vocab_size - 1
    prompts, bos = decoding_prompts(model.cfg.vocab_size)
    right = dec._regather
    wrong = []
    try:
        for kv_dtype in (None, "int8", "fp8"):
            for fault in (None, *BEAM_FAULTS):
                tag = f"beam-fault-{kv_dtype or 'bf16'}-{fault or 'none'}"
                moved = torch.zeros((), dtype=torch.int32, device="cuda")
                plant = BEAM_FAULTS.get(fault, lambda par, k: par)

                def regather(st, par, bk, plant=plant, moved=moved):
                    moved.add_((par != torch.arange(
                        bk, device=par.device)).any().int())
                    return right(st, plant(par, K), bk)
                dec._regather = regather
                (seqs, scores), _, steps, pr = counted_search(
                    tag, model,
                    lambda f, c: beam_search(f, c, B, K, T, bos, eos), K,
                    kv_dtype, prompts, T)
                dec._regather = right
                fwd = bool(beam_score_check(tag, model, prompts, seqs,
                                            scores, eos,
                                            TOL_BEAM_SCORE)[0])
                rep = bool(beam_replay_check(tag, model, prompts, bos, seqs,
                                             scores, kv_dtype, eos,
                                             TOL_BEAM_REPLAY)[0])
                log(f"[{tag}] forward check {'failed' if fwd else 'passed'}"
                    f", replay check {'failed' if rep else 'passed'}; some "
                    f"beam's parent another slot at {int(moved)} of {steps} "
                    f"steps")
                if pr or (fault is None and (fwd or rep)) or (
                        fault not in (None, "no-regather") and not rep):
                    wrong.append(tag)
    finally:
        dec._regather = right
    if wrong:
        raise SystemExit(f"beam-fault: the checks misjudged {wrong}")
    log("[beam-fault] every wrong-prompt and wrong-beam fault failed the "
        "replay check; every right search passed both checks")


def phase_serve_decoding(model):
    """The decoding API over the port's KV cache on gpt3-1.3b: beam
    search (2 prompts of 256 and 768 tokens, 4 beams, 32 steps) over a
    bf16, an int8 and an fp8 cache of 8 slots; greedy search; beam search
    with one beam against greedy; greedy against the engine's greedy
    streams; Viterbi at B=8, T=256, N=64 against a float64 numpy Viterbi;
    ``dynamic_decode`` over a callable cell at V = 50304."""
    from paddle_tpu_torch.inference import InferenceEngine
    from paddle_tpu_torch.nn import BeamSearchDecoder, dynamic_decode
    from paddle_tpu_torch.text import (beam_search, greedy_search,
                                       viterbi_decode)
    t_phase = time.perf_counter()
    cfg = model.cfg
    B, K, T = 2, 4, 32
    eos = cfg.vocab_size - 1
    prompts, bos = decoding_prompts(cfg.vocab_size)
    out, problems = {}, []
    for kv_dtype in (None, "int8", "fp8"):
        tag = f"serve-decoding-{kv_dtype or 'bf16'}"
        (seqs, scores), launches, steps, pr = counted_search(
            tag, model, lambda f, c: beam_search(f, c, B, K, T, bos, eos),
            K, kv_dtype, prompts, T)
        problems += pr
        out[tag] = launches
        if tuple(seqs.shape) != (B, K, T) or seqs.dtype != torch.int32 \
                or not bool((scores[:, :-1] >= scores[:, 1:]).all()):
            problems.append(f"{tag}: sequences {tuple(seqs.shape)} "
                            f"{seqs.dtype}, scores {scores.tolist()}")
        problems += beam_score_check(tag, model, prompts, seqs, scores, eos,
                                     TOL_BEAM_SCORE)[0]
        problems += beam_replay_check(tag, model, prompts, bos, seqs, scores,
                                      kv_dtype, eos, TOL_BEAM_REPLAY)[0]
    tag = "serve-decoding-greedy"
    greedy, out[tag], _, pr = counted_search(
        tag, model, lambda f, c: greedy_search(f, c, B, T, bos, eos), 1,
        None, prompts, T)
    problems += pr
    (beam1, _), _, _, pr = counted_search(
        "serve-decoding-beam1", model,
        lambda f, c: beam_search(f, c, B, 1, T, bos, eos), 1, None, prompts,
        T)
    problems += pr
    if not torch.equal(beam1[:, 0], greedy):
        problems.append("beam search with one beam differs from greedy")
    log(f"[{tag}] beam search with K = 1 equals greedy token for token: "
        f"{torch.equal(beam1[:, 0], greedy)}")
    eng = InferenceEngine(model, batch_slots=2, device="cuda")
    want, _, _, _ = run_engine("serve-decoding-engine", eng, prompts, T)
    got = []
    for row in greedy.tolist():
        got.append(row[:row.index(eos) + 1] if eos in row else row)
    want = [w[:len(g)] for g, w in zip(got, want)]
    problems += compare_greedy(tag, model, prompts, got, want, TOL_TEACHER)
    del eng

    # Viterbi: exact f32 sums (multiples of 1/64), so equal paths
    rng = np.random.RandomState(41)
    em = rng.randint(-255, 256, (8, 256, 64)) / 64.0
    tr = rng.randint(-255, 256, (64, 64)) / 64.0
    lengths = rng.randint(1, 257, 8)
    lengths[0] = 256
    ref_s, ref_p = viterbi_np(em, tr, lengths)
    args = (torch.from_numpy(em).float().cuda(),
            torch.from_numpy(tr).float().cuda(),
            torch.from_numpy(lengths).cuda())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vs, vp = viterbi_decode(*args)
    torch.cuda.synchronize()
    v_ms = (time.perf_counter() - t0) * 1e3
    rel = float(np.max(np.abs(vs.cpu().double().numpy() - ref_s)
                       / np.abs(ref_s)))
    same = bool((vp.cpu().numpy() == ref_p).all())
    log(f"[serve-decoding-viterbi] B=8 T=256 N=64 (lengths "
        f"{lengths.tolist()}): {v_ms:.3f} ms ({255 / v_ms * 1e3:.1f} "
        f"steps/s, host clock); paths equal to float64 numpy: {same}; "
        f"worst score relative diff {rel:.3e} (tol {TOL_VITERBI})")
    if not (same and rel <= TOL_VITERBI and vp.dtype == torch.int32):
        problems.append("viterbi_decode differs from the numpy Viterbi")

    # dynamic_decode over a tanh cell, V = 50304, checked by rescoring
    # each beam on the host in f64
    g = torch.Generator(device="cuda").manual_seed(7)
    V, H = cfg.vocab_size, 256
    w = {n: torch.randn(shape, generator=g, device="cuda") * sc
         for n, shape, sc in (("emb", (V, H), 0.5), ("w", (H, H), 1 / 16),
                              ("u", (H, H), 1 / 16), ("out", (H, V), 0.25),
                              ("h0", (2, H), 0.3))}

    def cell(x, h):
        h = torch.tanh(x @ w["w"] + h @ w["u"])
        return h, h
    dec = BeamSearchDecoder(cell, bos, eos, K,
                            embedding_fn=lambda t: w["emb"][t.long()],
                            output_fn=lambda o: o @ w["out"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids, dscores, dlen = dynamic_decode(dec, w["h0"], max_step_num=16,
                                        output_time_major=True,
                                        return_length=True)
    torch.cuda.synchronize()
    d_s = time.perf_counter() - t0
    w64 = {n: t.double().cpu() for n, t in w.items()}
    ids_c, len_c = ids.cpu(), dlen.cpu()
    worst = 0.0
    for b in range(B):
        for j in range(K):
            h, tok, total = w64["h0"][b], bos, 0.0
            for t in range(int(len_c[b, j])):
                h = torch.tanh(w64["emb"][tok] @ w64["w"] + h @ w64["u"])
                tok = int(ids_c[t, b, j])
                total += torch.log_softmax(h @ w64["out"], -1)[tok].item()
            worst = max(worst, abs(float(dscores[b, j]) - total) / abs(total))
    shape_ok = (tuple(ids.shape) == (16, B, K) and dlen.dtype == torch.int64
                and bool((dscores[:, :-1] >= dscores[:, 1:]).all()))
    log(f"[serve-decoding-dynamic] dynamic_decode, tanh cell H={H}, V={V}, "
        f"{K} beams, 16 steps: {16 / d_s:.2f} steps/s (host clock); ids "
        f"{tuple(ids.shape)} lengths {dlen.tolist()}; worst relative diff "
        f"to the f64 host rescoring {worst:.3e} (tol {TOL_DYNAMIC})")
    if not (shape_ok and worst <= TOL_DYNAMIC):
        problems.append("dynamic_decode: shapes or scores off")
    log(f"[serve-decoding] phase {time.perf_counter() - t_phase:.1f} s")
    finish("serve-decoding", problems)
    return out


def phase_profile(model):
    """Where a steady decode step's time goes, for the dense bf16 engine,
    a chunked step, a spec tick and the megakernel (the other cache
    forms and int8 compute were cut to keep the script within its
    budget):
    8 active slots with 512-token prompts; 5 steps timed on the host
    clock (each step ends in its host sync, so that is the step's real
    duration), then 5 steps under torch.profiler for the device kernel
    time per step."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.inference import InferenceEngine
    runs = [(f"{layout} {kv_dtype or 'bf16'} decode step (8 active, "
             f"~520-token slots)", dict(kv_layout=layout, kv_dtype=kv_dtype),
             512, 16)
            for layout, kv_dtype in (("dense", None),)]
    # a step of the chunked engine while slots are still prefilling: one
    # 512-token chunk tick and the decode step of the graduated slots;
    # a spec tick of the self-drafting dense engine (K = 4)
    runs += [("dense bf16 chunked step (chunk 512, 8 slots of 1024-token "
              "prompts, one chunk tick a step)", dict(prefill_chunk=512),
              1024, 16),
             ("dense bf16 spec tick (K = 4, self-draft, 8 active)",
              dict(spec_k=4, draft_model=model), 512, 80)]
    # the megakernel's decode step, beside the composed one above
    runs += [("dense bf16 megakernel decode step (8 active, ~520-token "
              "slots)", dict(mega=True), 512, 16)]
    for what, kw, plen, new in runs:
        model.enable_decode_megakernel(kw.pop("mega", False))
        model.enable_quantize("int8" if kw.pop("quant", False) else None)
        eng = InferenceEngine(model, batch_slots=8, device="cuda", **kw)
        rng = np.random.RandomState(13)
        for _ in range(8):
            eng.add_request(rng.randint(0, model.cfg.vocab_size, size=plen),
                            max_new_tokens=new)
        for _ in range(3):          # admissions, then two warm decode steps
            eng.step()
        steps = 5
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                eng.step()
        report_profile(prof, steps, wall_ms, what)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    model.enable_decode_megakernel(False)
    model.enable_quantize(None)


def report_profile(prof, steps, wall_ms, what):
    """Device kernel time per step (torch.profiler) against the step's
    wall time from unprofiled steps, and the top kernels."""
    from torch.autograd import DeviceType
    rows = sorted(
        ((e.self_device_time_total / steps / 1e3, e.count / steps, e.key)
         for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        reverse=True)
    busy_ms = sum(r[0] for r in rows)
    if busy_ms == 0:
        log(f"[profile] {what}: wall {wall_ms:.3f} ms; device time not "
            f"visible to torch.profiler, busy share not measured")
        return
    log(f"[profile] {what}: wall {wall_ms:.3f} ms, device kernels "
        f"{busy_ms:.3f} ms (busy share {busy_ms / wall_ms:.3f}, idle share "
        f"{1 - busy_ms / wall_ms:.3f}), {sum(r[1] for r in rows):.1f} kernel "
        f"launches per step")
    groups = {}
    for ms, n, key in rows:
        if any(w in key for w in ("flash_", "decode_kernel", "window_kernel",
                                  "attn_fwd_kernel", "mega_kernel",
                                  "qmm::")):
            group = "port kernels"
        elif any(w in key for w in ("nvjet", "gemm", "cutlass", "xmma")):
            group = "library matmuls"
        elif any(w in key for w in ("elementwise", "copy", "Functor")):
            group = "elementwise and casts"
        else:
            group = "other"
        groups[group] = groups.get(group, 0.0) + ms
    log("[profile]   by group: " + ", ".join(
        f"{g} {ms:.3f} ms" for g, ms in sorted(groups.items(),
                                              key=lambda x: -x[1])))
    for ms, n, key in rows[:10]:
        log(f"[profile]   {ms:.4f} ms/step  x{n:.1f}  {key[:90]}")


def make_trainer(cfg, seed, optimizer, qat=False, anomaly_policy="raise",
                 wrap_loss=None, **strategy):
    """A gpt3-1.3b-width model with f32 masters (random weights from
    ``seed``) behind ``SpmdTrainer`` with bf16 AMP, as the JAX package's
    bench.py sets it up (``qat``: with ``strategy.qat``; ``strategy``:
    more DistributedStrategy settings, e.g. ``amp_configs``;
    ``wrap_loss(criterion)``: the loss function to use instead of the
    criterion itself)."""
    from paddle_tpu_torch.core import random as prandom
    from paddle_tpu_torch.distributed import SpmdTrainer
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion)
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32,
                           generator=prandom.seed(seed, "cuda"))
    st = DistributedStrategy()
    st.amp = True
    st.qat = qat
    for key, val in strategy.items():
        setattr(st, key, val)
    crit = GPTPretrainingCriterion()
    if wrap_loss is None:
        def loss_fn(o, lab):
            return crit(o, lab)
    else:
        loss_fn = wrap_loss(crit)
    return model, SpmdTrainer(model, optimizer, loss_fn, strategy=st,
                              anomaly_policy=anomaly_policy)


def token_batch(rng, vocab, b, s):
    """Random token ids and the next-token labels (bench.py's data)."""
    ids = rng.randint(0, vocab, (b, s)).astype(np.int32)
    return ids, np.roll(ids, -1, axis=1).astype(np.int32)


def phase_train_parity():
    """Every parameter gradient of one AMP step through the kernels
    against the same step with the plain attention swapped in here (the
    package has no switch for it).  SGD at learning rate 0 leaves the
    weights as they were, so both steps start from the same state."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models import gpt_configs
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    cfg = gpt_configs()["gpt3-1.3b"]
    cfg.num_layers, cfg.fused_ce = 2, True
    model, trainer = make_trainer(cfg, 99, topt.SGD(learning_rate=0.0))
    ids, labels = token_batch(np.random.RandomState(21), cfg.vocab_size, 2,
                              512)

    def step():
        n_bwd = fa.FLASH_BWD_DQ.launches
        loss = float(trainer.train_step(ids, labels))
        grads = {n: p.grad.detach().clone()
                 for n, p in model.named_parameters()}
        return loss, grads, fa.FLASH_BWD_DQ.launches - n_bwd

    loss_k, grads_k, launched = step()
    saved = fa._fwd, fa._bwd
    fa._fwd, fa._bwd = fa._flash_plain, fa._flash_bwd_plain
    try:
        loss_p, grads_p, launched_plain = step()
    finally:
        fa._fwd, fa._bwd = saved
    ratios = {n: ((grads_k[n] - grads_p[n]).abs().max()
                  / grads_p[n].abs().max().clamp_min(1e-30)).item()
              for n in grads_k}
    worst = max(ratios, key=ratios.get)
    ok = (launched == cfg.num_layers and launched_plain == 0
          and all(r <= TOL_GRAD for r in ratios.values())
          and np.isfinite(loss_k) and abs(loss_k - loss_p) <= 1e-2)
    log(f"[train-parity] gpt3-1.3b width, {cfg.num_layers} layers, bf16 AMP, "
        f"batch 2 x 512: loss kernels {loss_k:.6f} plain {loss_p:.6f}; "
        f"{len(ratios)} gradients, worst max|diff|/max|plain| "
        f"{ratios[worst]:.3e} ({worst}), median "
        f"{float(np.median(list(ratios.values()))):.3e} (tol {TOL_GRAD}); "
        f"dq launches kernel step {launched}, plain step {launched_plain} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("train-parity failed")


def phase_train_qat():
    """One 2-layer bf16 AMP step with ``strategy.qat`` (every block linear
    through the int8 fake-quant matmul): the int8 kernel under autograd
    (4 launches per layer in the forward; the straight-through backward is
    two plain products), finite loss and gradients."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models import gpt_configs
    cfg = gpt_configs()["gpt3-1.3b"]
    cfg.num_layers, cfg.fused_ce = 2, True
    model, trainer = make_trainer(cfg, 99, topt.SGD(learning_rate=0.0),
                                  qat=True)
    ids, labels = token_batch(np.random.RandomState(21), cfg.vocab_size, 2,
                              512)
    zero_launches()
    loss = float(trainer.train_step(ids, labels))
    torch.cuda.synchronize()
    launches = read_launches()
    finite = all(bool(torch.isfinite(p.grad).all().item())
                 for p in model.parameters())
    gmax = max(p.grad.abs().max().item() for p in model.parameters())
    layers = cfg.num_layers
    ok = (np.isfinite(loss) and finite and gmax > 0
          and model.cfg.quantize == "int8"
          and launches["quantized_matmul"] == 4 * layers
          and launches["flash_fwd"] == layers
          and launches["flash_bwd_dq"] == layers)
    log(f"[train-qat] gpt3-1.3b width, {layers} layers, bf16 AMP, "
        f"strategy.qat (int8), batch 2 x 512: loss {loss:.6f}, every "
        f"gradient finite: {finite}, largest |gradient| {gmax:.3e}; launches "
        f"{{{', '.join(f'{k}: {n}' for k, n in launches.items() if n)}}} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("train-qat failed")
    return launches


def phase_train():
    """The gpt3-1.3b training step at full width and depth; returns the
    launch counts of its measured window."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import async_dispatch
    from paddle_tpu_torch.io import DevicePrefetcher
    from paddle_tpu_torch.models import gpt_configs
    from paddle_tpu_torch.ops import LAUNCHERS
    cfg = gpt_configs()["gpt3-1.3b"]
    cfg.fused_ce = True
    b, s, n_warm, n_meas = 4, 2048, 2, 6
    t0 = time.perf_counter()
    model, trainer = make_trainer(cfg, 4321, topt.Adam(learning_rate=1e-4))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[train] gpt3-1.3b: {n_params / 1e9:.3f} B params f32, bf16 AMP, "
        f"fused CE, Adam lr 1e-4, batch {b} x {s}, init "
        f"{time.perf_counter() - t0:.2f} s")
    batch = token_batch(np.random.RandomState(0), cfg.vocab_size, b, s)
    feed = DevicePrefetcher(itertools.repeat(batch, n_warm + n_meas),
                            device="cuda", timings=trainer._timings)
    results = []
    for i, (ids, labels) in enumerate(feed):
        if i == n_warm:                  # the measured window starts
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_launches()
            async_dispatch.reset_host_sync_count()
            t0 = time.perf_counter()
        results.append(trainer.train_step(ids, labels))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    syncs = async_dispatch.host_sync_count()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(r) for r in results]
    step_ms = wall * 1e3 / n_meas
    tokens_s = n_meas * b * s / wall
    mfu = cfg.flops_per_token(s) * tokens_s / PEAK_BF16_FLOPS
    masters_f32 = all(p.dtype == torch.float32 for p in model.parameters())
    log(f"[train] losses {[round(x, 4) for x in losses]} (first {n_warm} "
        f"warm-up)")
    log(f"[train] {n_meas} steps in {wall:.3f} s: step_ms={step_ms:.3f} "
        f"tokens_per_s={tokens_s:.1f} MFU={mfu:.4f} (flops_per_token "
        f"{cfg.flops_per_token(s):.4e} x tokens/s over "
        f"{PEAK_BF16_FLOPS:.3e}) max_memory_allocated={peak} bytes "
        f"host_syncs={syncs} launches {launches}")
    log(f"[train] stats {trainer.stats}")
    layers = cfg.num_layers
    problems = []
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        problems.append(f"losses not finite and falling: {losses}")
    if syncs != 0:
        problems.append(f"{syncs} host syncs in the measured steps")
    for key in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if launches[key] != layers * n_meas:
            problems.append(f"{key} launches {launches[key]} != "
                            f"{layers} x {n_meas}")
    if not masters_f32:
        problems.append("master parameters are no longer f32")
    if problems:
        raise SystemExit("train phase failed: " + "; ".join(problems))
    # the cost model's reading of this step (cost-model prints and checks
    # it): the analytic cost, the roofline digest, the doctor's verdicts
    from paddle_tpu_torch.observability import exec_registry
    exec_registry.analyze_all(trainer._exec_component)
    st = trainer.stats
    COST["train"] = {"mfu": mfu, "bench_flops": cfg.flops_per_token(s) * b * s,
                     "profile": st["exec_profile"], "doctor": st["doctor"],
                     "step_ms": step_ms}

    # one profiled step: device time against the measured step time
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.train_step(ids, labels)
        torch.cuda.synchronize()
    report_profile(prof, 1, step_ms, "train step (gpt3-1.3b, 4 x 2048)")

    # recompute: two steps from one saved state without and with it
    params = dict(model.named_parameters())
    snap_p = {n: p.detach().to("cpu", copy=True) for n, p in params.items()}
    snap_o = {k: v.to("cpu", copy=True) if torch.is_tensor(v) else v
              for k, v in trainer.optimizer.state_dict().items()}

    def two_steps():
        zero_launches()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = [trainer.train_step(ids, labels) for _ in range(2)]
        torch.cuda.synchronize()
        return ([float(r) for r in out],
                torch.cuda.max_memory_allocated() - base,
                LAUNCHERS["flash_fwd"].launches)

    plain, plain_peak, _ = two_steps()
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(snap_p[n])
    trainer.optimizer.set_state_dict(
        {k: v.to("cuda") if torch.is_tensor(v) else v
         for k, v in snap_o.items()})
    del snap_p, snap_o
    model.enable_recompute()
    rec, rec_peak, rec_fwd = two_steps()
    diff = max(abs(x - y) / abs(y) for x, y in zip(rec, plain))
    ok = (rec_fwd == 2 * layers * 2 and diff <= TOL_RECOMPUTE
          and rec_peak < plain_peak)
    log(f"[train] recompute: losses {rec} vs {plain} without (worst "
        f"relative diff {diff:.3e}, tol {TOL_RECOMPUTE}); flash_fwd launches "
        f"{rec_fwd} over 2 steps; peak above the resident state "
        f"{rec_peak} vs {plain_peak} bytes without {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("recompute check failed")
    log("[train] ok")
    return {"launches": launches, "step_ms": step_ms, "peak": peak}


def del_all():
    gc.collect()
    torch.cuda.empty_cache()


def zero_launches():
    """Every kernel's launch count and the attention composite's call
    count (``nn.functional.attention.COMPOSITE``) to 0."""
    from paddle_tpu_torch.nn.functional.attention import COMPOSITE
    from paddle_tpu_torch.ops import LAUNCHERS
    for kernel in (*LAUNCHERS.values(), COMPOSITE):
        kernel.launches = 0


def read_launches():
    """``{symbol: launches}`` of every kernel, and the composite's calls
    under ``COMPOSITE.symbol``."""
    from paddle_tpu_torch.nn.functional.attention import COMPOSITE
    from paddle_tpu_torch.ops import LAUNCHERS
    return {k.symbol: k.launches for k in (*LAUNCHERS.values(), COMPOSITE)}


FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def full_cfg(layers=None):
    """gpt3-1.3b with the fused cross-entropy (``layers``: depth cut)."""
    from paddle_tpu_torch.models import gpt_configs
    cfg = gpt_configs()["gpt3-1.3b"]
    cfg.fused_ce = True
    if layers is not None:
        cfg.num_layers = layers
    return cfg


class HeldState:
    """The trainer's parameters, optimizer accumulators and step count in
    pinned host memory, put back by ``restore()`` (every policy run of a
    phase starts from the same state)."""

    def __init__(self, trainer):
        self.trainer = trainer
        opt = trainer.optimizer
        self.live = list(trainer.model.parameters()) + [
            t for n in sorted(opt._accumulators)
            for t in opt._accumulators[n].values()]
        self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     for t in self.live]
        for h, t in zip(self.host, self.live):
            h.copy_(t.detach(), non_blocking=True)
        torch.cuda.synchronize()
        self.steps = (trainer._step_count, opt._step_count)

    def restore(self):
        with torch.no_grad():
            for t, h in zip(self.live, self.host):
                t.copy_(h, non_blocking=True)
        torch.cuda.synchronize()
        self.trainer._step_count, self.trainer.optimizer._step_count = \
            self.steps


def phase_train_fp16(bf16, smi):
    """The slice's main path: gpt3-1.3b at full width and depth with fp16
    AMP and dynamic loss scaling (the default scaler, init 32768), fused
    CE, Adam, 4 x 2048 from DevicePrefetcher: 2 warm-up and 6 measured
    steps with no host sync, 24 launches of each flash kernel a step
    (the fp16 instantiations: the compute copies are fp16), finite loss
    on every step not skipped, falling over the run; then a 2-layer run
    with PADDLE_FAULT_NAN_STEP armed: the poisoned step is skipped, the
    optimizer's t held, and two overflows in a row halve the scale."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import async_dispatch
    from paddle_tpu_torch.io import DevicePrefetcher
    cfg = full_cfg()
    b, s, n_warm, n_meas = 4, 2048, 2, 6
    model, trainer = make_trainer(cfg, 4321, topt.Adam(learning_rate=1e-4),
                                  amp_configs={"use_bf16": False})
    assert trainer.fp16_scaling and trainer.amp_dtype == torch.float16
    batch = token_batch(np.random.RandomState(0), cfg.vocab_size, b, s)
    feed = DevicePrefetcher(itertools.repeat(batch, n_warm + n_meas),
                            device="cuda", timings=trainer._timings)
    results, found = [], []
    for i, (ids, labels) in enumerate(feed):
        if i == n_warm:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_launches()
            async_dispatch.reset_host_sync_count()
            t0 = time.perf_counter()
        results.append(trainer.train_step(ids, labels))
        found.append(trainer._scaler_state["found_inf"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    syncs = async_dispatch.host_sync_count()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(r) for r in results]
    skipped = [bool(f) for f in found]
    stats = trainer.stats                 # the scaler, read once
    scale = trainer.loss_scale
    step_ms = wall * 1e3 / n_meas
    tokens_s = n_meas * b * s / wall
    mfu = cfg.flops_per_token(s) * tokens_s / PEAK_BF16_FLOPS
    log(f"[train-fp16] {smi}: gpt3-1.3b, f32 masters, fp16 AMP (init scale "
        f"32768), fused CE, Adam lr 1e-4, batch {b} x {s}: losses "
        f"{[round(x, 4) for x in losses]} (first {n_warm} warm-up), skipped "
        f"{skipped}, scale now {scale}, skipped_steps "
        f"{stats['skipped_steps']}")
    log(f"[train-fp16] {n_meas} steps in {wall:.3f} s: step_ms={step_ms:.3f} "
        f"(bf16 in this call {bf16['step_ms']:.3f}) tokens_per_s="
        f"{tokens_s:.1f} MFU={mfu:.4f} max_memory_allocated={peak} bytes "
        f"(bf16 {bf16['peak']}) host_syncs={syncs} launches {launches}")
    kept = [x for x, sk in zip(losses, skipped) if not sk]
    problems = []
    if syncs:
        problems.append(f"{syncs} host syncs in the measured steps")
    if not all(np.isfinite(kept)) or len(kept) < 2 or not kept[-1] < kept[0]:
        problems.append(f"losses of the steps kept not finite and falling: "
                        f"{kept}")
    for key in FLASH:
        if launches[key] != cfg.num_layers * n_meas:
            problems.append(f"{key} launches {launches[key]} != "
                            f"{cfg.num_layers} x {n_meas}")
    if stats["skipped_steps"] != sum(skipped):
        problems.append(f"skipped_steps {stats['skipped_steps']} != "
                        f"{sum(skipped)}")
    if problems:
        raise SystemExit("train-fp16 failed: " + "; ".join(problems))
    del model, trainer, feed, results, found
    del_all()

    # the fault: poisoned step 2, re-armed for step 3 (two in a row)
    os.environ["PADDLE_FAULT_NAN_STEP"] = "2"
    try:
        model, trainer = make_trainer(full_cfg(2), 77,
                                      topt.Adam(learning_rate=1e-4),
                                      amp_configs={"use_bf16": False,
                                                   "init_loss_scaling": 1024.0})
    finally:
        del os.environ["PADDLE_FAULT_NAN_STEP"]
    ids, labels = token_batch(np.random.RandomState(3), cfg.vocab_size, 2,
                              512)
    seen = []
    for step in range(1, 5):
        if step == 3:
            trainer._fault_nan_step = 3
        before = {n: p.detach().clone() for n, p in
                  list(model.named_parameters())[:2]}
        trainer.train_step(ids, labels)
        sc = {k: v.item() for k, v in trainer._scaler_state.items()}
        same = all(torch.equal(p, before[n]) for n, p in
                   list(model.named_parameters())[:2])
        seen.append((step, sc["found_inf"], sc["t"], sc["scale"], sc["bad"],
                     same))
    want = [(1, False, 1, 1024.0, 0, False), (2, True, 1, 1024.0, 1, True),
            (3, True, 1, 512.0, 0, True), (4, False, 2, 512.0, 0, False)]
    ok = seen == want
    log(f"[train-fp16] 2 layers, PADDLE_FAULT_NAN_STEP=2 then 3: (step, "
        f"found_inf, t, scale, bad, parameters unchanged) {seen} "
        f"{'ok' if ok else 'FAIL, want ' + str(want)}")
    if not ok:
        raise SystemExit("train-fp16 fault check failed")
    log("[train-fp16] ok")
    return {"train-fp16": launches}


def set_dropout(model, p):
    """Every dropout of a GPT at rate ``p``: the hidden Dropout layers
    and each attention's ``attn_dropout`` (one model run at p = 0 and at
    p, in turns)."""
    import dataclasses
    from paddle_tpu_torch.models.gpt import GPTAttention
    from paddle_tpu_torch.nn.layer.common import Dropout
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = p
        elif isinstance(m, GPTAttention):
            m.cfg = dataclasses.replace(m.cfg, attn_dropout=p)


def phase_train_dropout(bf16, smi):
    """gpt3-1.3b at full width and depth with Paddle's pretraining
    dropouts (``attn_dropout = dropout = DROP_P``), f32 masters, bf16 AMP,
    fused CE, Adam, 4 x 2048: runs of 3 steps at p = 0 and at DROP_P in
    turns (p = 0, p, p, p = 0) after a warm-up of each.  The dropout runs:
    finite losses falling over the phase, each of rows 1-3's dropout
    forms once a layer a step and no p = 0 flash kernel, no host sync;
    step ms, MFU and peak beside the p = 0 runs', the peak growing by no
    more than the hidden dropouts' masks (1 byte an element of 2 [B, S,
    hidden] per layer and the embeddings', saved for their backward) with
    slack: no attention mask is stored.  Then 2 steps without and 2 with
    full recompute from one held state under one generator seed: equal
    losses (the recomputed forward replays the pairs), the forward twice
    a layer a step."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import async_dispatch
    cfg = full_cfg()
    cfg.attn_dropout = cfg.dropout = DROP_P
    b, s, n = 4, 2048, 3
    model, trainer = make_trainer(cfg, 4321, topt.Adam(learning_rate=1e-4))
    ids, labels = (torch.from_numpy(x).cuda() for x in token_batch(
        np.random.RandomState(0), cfg.vocab_size, b, s))
    layers = cfg.num_layers
    masks = (2 * layers + 1) * b * s * cfg.hidden_size   # bytes, bool
    DROP = tuple(f"{k}_dropout" for k in FLASH)

    def run(p, steps):
        set_dropout(model, p)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        async_dispatch.reset_host_sync_count()
        t0 = time.perf_counter()
        out = [trainer.train_step(ids, labels) for _ in range(steps)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        syncs = async_dispatch.host_sync_count()
        launches = read_launches()
        return dict(losses=[float(r) for r in out],
                    step_ms=wall * 1e3 / steps,
                    mfu=cfg.flops_per_token(s) * steps * b * s / wall
                    / PEAK_BF16_FLOPS,
                    peak=torch.cuda.max_memory_allocated(), syncs=syncs,
                    launches=launches)

    run(DROP_P, 1)
    run(0.0, 1)
    runs = [(0.0, run(0.0, n)), (DROP_P, run(DROP_P, n)),
            (DROP_P, run(DROP_P, n)), (0.0, run(0.0, n))]
    problems = []
    total = {}
    for p, r in runs:
        log(f"[train-dropout] {smi}: p={p} {n} steps: losses "
            f"{[round(x, 4) for x in r['losses']]} step_ms={r['step_ms']:.3f} "
            f"MFU={r['mfu']:.4f} max_memory_allocated={r['peak']} bytes "
            f"host_syncs={r['syncs']} flash launches "
            f"{ {k: r['launches'][k] for k in FLASH + DROP} }")
        if r["syncs"]:
            problems.append(f"p={p}: {r['syncs']} host syncs")
        want_on, want_off = (DROP, FLASH) if p else (FLASH, DROP)
        for key in want_on:
            if r["launches"][key] != layers * n:
                problems.append(f"p={p}: {key} launches "
                                f"{r['launches'][key]} != {layers} x {n}")
        for key in want_off:
            if r["launches"][key]:
                problems.append(f"p={p}: {key} launched")
        if p:
            add_launches(total, r["launches"])
    drop_losses = runs[1][1]["losses"] + runs[2][1]["losses"]
    if not all(np.isfinite(drop_losses)) or \
            not drop_losses[-1] < drop_losses[0]:
        problems.append(f"dropout losses not finite and falling: "
                        f"{drop_losses}")
    ms0 = min(runs[0][1]["step_ms"], runs[3][1]["step_ms"])
    msp = min(runs[1][1]["step_ms"], runs[2][1]["step_ms"])
    peak0 = max(runs[0][1]["peak"], runs[3][1]["peak"])
    peakp = max(runs[1][1]["peak"], runs[2][1]["peak"])
    grow = peakp - peak0
    if grow > 1.5 * masks:
        problems.append(f"peak grew by {grow} bytes, over 1.5 x the hidden "
                        f"dropout masks' {masks}")
    log(f"[train-dropout] {smi}: step_ms p={DROP_P} {msp:.3f} vs p=0 "
        f"{ms0:.3f} (x {msp / ms0:.4f}; bf16 step of the train phase "
        f"{bf16['step_ms']:.3f}), MFU {runs[1][1]['mfu']:.4f} / "
        f"{runs[2][1]['mfu']:.4f} vs {runs[0][1]['mfu']:.4f} / "
        f"{runs[3][1]['mfu']:.4f}; peak {peakp} vs {peak0} bytes: +{grow} "
        f"(hidden dropout masks {masks} bytes)")

    # recompute: the same 2 steps without and with 'full' under one seed
    set_dropout(model, DROP_P)
    held = HeldState(trainer)

    def two_steps():
        zero_launches()
        torch.cuda.manual_seed(1234)
        out = [trainer.train_step(ids, labels) for _ in range(2)]
        torch.cuda.synchronize()
        return [float(r) for r in out], read_launches()

    plain, _ = two_steps()
    held.restore()
    model.enable_recompute()
    rec, rec_launches = two_steps()
    diff = max(abs(x - y) / abs(y) for x, y in zip(rec, plain))
    rec_ok = (diff <= TOL_RECOMPUTE
              and rec_launches["flash_fwd_dropout"] == 2 * layers * 2
              and rec_launches["flash_bwd_dq_dropout"] == 2 * layers)
    log(f"[train-dropout] recompute 'full' from one held state, one "
        f"generator seed: losses {rec} vs {plain} without (worst relative "
        f"diff {diff:.3e}, tol {TOL_RECOMPUTE}); flash_fwd_dropout launches "
        f"{rec_launches['flash_fwd_dropout']} over 2 steps "
        f"{'ok' if rec_ok else 'FAIL'}")
    if not rec_ok:
        problems.append("recompute with dropout differs")
    if problems:
        raise SystemExit("train-dropout failed: " + "; ".join(problems))
    del model, trainer, held
    log("[train-dropout] ok")
    return {"train-dropout": total}


POLICIES = (None, "full", "dots_no_batch", "dots", "everything")


def phase_train_recompute_policies(bf16, smi):
    """gpt3-1.3b at full width and depth, bf16 AMP, 4 x 2048: from one
    held state, 2 steps each without recompute and under 'full',
    'dots_no_batch', 'dots' and 'everything'.  Losses equal within the
    recompute tolerance; peaks above the resident state ordered full <=
    dots_no_batch <= dots <= everything.  'everything' runs the blocks
    without recompute (keeping every residual is no recompute), the same
    code path as none, so its peak is not checked against none's.  The
    forward kernel launched twice a layer and step under 'full',
    'dots_no_batch' and 'dots' (the backward's re-run launches it again:
    a kernel is no aten op a policy could keep)."""
    from paddle_tpu_torch import optimizer as topt
    cfg = full_cfg()
    model, trainer = make_trainer(cfg, 4321, topt.Adam(learning_rate=1e-4))
    ids, labels = token_batch(np.random.RandomState(0), cfg.vocab_size, 4,
                              2048)
    trainer.train_step(ids, labels)       # accumulators exist, warm
    torch.cuda.synchronize()
    held = HeldState(trainer)
    rows, paths = {}, {}
    for policy in POLICIES:
        held.restore()
        if policy is None:
            model.gpt._recompute = False
        else:
            model.enable_recompute(policy)
        # the allocator keeps its cached blocks between runs, so no run
        # pays for growing the pool (the peaks count allocated bytes)
        zero_launches()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = [trainer.train_step(ids, labels) for _ in range(2)]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / 2
        rows[policy] = ([float(r) for r in out],
                        torch.cuda.max_memory_allocated() - base, ms)
        paths[f"train-recompute-{policy or 'none'}"] = read_launches()
    model.gpt._recompute = False
    ref = rows[None][0]
    problems = []
    for policy, (losses, peak, ms) in rows.items():
        diff = max(abs(x - y) / abs(y) for x, y in zip(losses, ref))
        launches = paths[f"train-recompute-{policy or 'none'}"]
        fwd = launches["flash_fwd"]
        log(f"[train-recompute-policies] {smi}: {policy or 'none'}: losses "
            f"{losses} (worst relative diff {diff:.3e}, bitwise "
            f"{losses == ref}), step_ms={ms:.3f}, peak above the resident "
            f"state {peak} bytes ({peak / 1e9:.2f} GB), flash_fwd "
            f"launches {fwd}")
        if diff > TOL_RECOMPUTE:
            problems.append(f"{policy}: losses {losses} vs {ref}")
        # 'everything' keeps every residual: no recompute, no re-launch
        want = 2 * cfg.num_layers * (1 if policy in (None, "everything")
                                     else 2)
        if fwd != want or launches["flash_bwd_dq"] != 2 * cfg.num_layers:
            problems.append(f"{policy}: launches {launches}")
    peak = {p: rows[p][1] for p in POLICIES}
    if not (peak["full"] <= peak["dots_no_batch"] <= peak["dots"]
            <= peak["everything"]):
        problems.append(f"peaks out of order: {peak}")
    if problems:
        raise SystemExit("train-recompute-policies failed: "
                         + "; ".join(problems))
    log("[train-recompute-policies] ok")
    return paths


def phase_train_merge(bf16, smi):
    """gpt3-1.3b at full width and depth, bf16 AMP: gradient merge
    (k_steps=2) over the two 2 x 2048 halves of a 4 x 2048 batch against
    one 4 x 2048 step from the same parameters (SGD at learning rate 1,
    so a parameter's change is its gradient): each change within the
    train-parity tolerance of the big step's, no host sync."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import SpmdTrainer, async_dispatch
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    cfg = full_cfg()
    model, big = make_trainer(cfg, 4321, topt.SGD(learning_rate=1.0))
    st = DistributedStrategy()
    st.amp = True
    st.gradient_merge = True
    st.gradient_merge_configs = {"k_steps": 2, "avg": True}
    merged = SpmdTrainer(model, topt.SGD(learning_rate=1.0), big.loss_fn,
                         strategy=st)
    ids, labels = token_batch(np.random.RandomState(5), cfg.vocab_size, 4,
                              2048)
    params = dict(model.named_parameters())
    start = {n: p.detach().clone() for n, p in params.items()}
    zero_launches()
    async_dispatch.reset_host_sync_count()
    t0 = time.perf_counter()
    out = [merged.train_step(ids[2 * i:2 * i + 2], labels[2 * i:2 * i + 2])
           for i in range(2)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    syncs = async_dispatch.host_sync_count()
    launches = read_launches()
    moved = {n: start[n] - p.detach() for n, p in params.items()}
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(start[n])
    loss_big = float(big.train_step(ids, labels))
    ratios = {n: ((start[n] - p.detach() - moved[n]).abs().max()
                  / (start[n] - p.detach()).abs().max().clamp_min(1e-30)
                  ).item() for n, p in params.items()}
    worst = max(ratios, key=ratios.get)
    halves = [float(r) for r in out]
    ok = (syncs == 0 and all(r <= TOL_GRAD for r in ratios.values())
          and merged.optimizer._step_count == 1
          and abs(sum(halves) / 2 - loss_big) <= 1e-2
          and all(launches[k] == 2 * cfg.num_layers for k in FLASH))
    log(f"[train-merge] {smi}: gpt3-1.3b, bf16 AMP, k_steps=2 over 2 x "
        f"2048 halves: losses {halves} (mean {sum(halves) / 2:.6f}) vs "
        f"one 4 x 2048 step {loss_big:.6f}; {len(ratios)} parameter "
        f"changes, worst max|diff|/max|big| {ratios[worst]:.3e} ({worst}), "
        f"median {float(np.median(list(ratios.values()))):.3e} (tol "
        f"{TOL_GRAD}); two micro-steps {ms:.3f} ms, host_syncs={syncs}, "
        f"launches {launches} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("train-merge failed")
    return {"train-merge": launches}


SENTINEL = 50303      # the last token id: the rollback run's bad batch


def bomb_loss(crit):
    """The criterion times 3e38 on a batch whose first label is the
    sentinel: a data-keyed blow-up (the loss overflows to inf), as the
    JAX rollback test's ``_BombNet``."""
    def loss_fn(o, lab):
        blow = (lab[0, 0] == SENTINEL).float() * 3.0e38
        return crit(o, lab) * (1.0 + blow)
    return loss_fn


def phase_train_anomaly(bf16, smi):
    """skip at full depth with PADDLE_FAULT_NAN_STEP=3 (one skipped step,
    no host sync until stats is read, the peak against the raise run's);
    rollback at 2 layers on a data-keyed blow-up (one rollback, one host
    sync a step, the run equal to one that never saw the batch; the
    snapshot's bytes and its cost a step); FLAGS_check_nan_inf at 2
    layers (raises naming every poisoned gradient)."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.core import flags, errors
    from paddle_tpu_torch.distributed import async_dispatch
    cfg = full_cfg()
    ids, labels = token_batch(np.random.RandomState(0), cfg.vocab_size, 4,
                              2048)
    os.environ["PADDLE_FAULT_NAN_STEP"] = "3"
    try:
        model, trainer = make_trainer(cfg, 4321,
                                      topt.Adam(learning_rate=1e-4),
                                      anomaly_policy="skip")
    finally:
        del os.environ["PADDLE_FAULT_NAN_STEP"]
    trainer.train_step(ids, labels)
    torch.cuda.synchronize()
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    async_dispatch.reset_host_sync_count()
    t0 = time.perf_counter()
    out = [trainer.train_step(ids, labels) for _ in range(4)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 4
    syncs = async_dispatch.host_sync_count()
    peak = torch.cuda.max_memory_allocated()
    launches = read_launches()
    stats = trainer.stats
    losses = [float(r) for r in out]
    ok = (syncs == 0 and stats["skipped_steps"] == 1
          and int(trainer._anomaly_state["t"]) == 4
          and all(np.isfinite(losses))
          and all(launches[k] == 4 * cfg.num_layers for k in FLASH))
    log(f"[train-anomaly] {smi}: skip, gpt3-1.3b full depth, bf16 AMP, Adam, "
        f"4 x 2048, PADDLE_FAULT_NAN_STEP=3: losses {losses}, "
        f"skipped_steps {stats['skipped_steps']}, host syncs before stats "
        f"{syncs}, step_ms={ms:.3f} (raise run {bf16['step_ms']:.3f}), "
        f"max_memory_allocated={peak} bytes (raise run {bf16['peak']}: the "
        f"select costs {peak - bf16['peak']} bytes) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("train-anomaly skip failed")
    paths = {"train-anomaly-skip": launches}
    del model, trainer, out
    del_all()

    # rollback at 2 layers: batch 3 of 5 carries the sentinel
    small = full_cfg(2)
    rng = np.random.RandomState(9)
    batches = [token_batch(rng, small.vocab_size, 2, 512) for _ in range(5)]
    bad = (batches[2][0], batches[2][1].copy())
    bad[1][0, 0] = SENTINEL

    def run(policy, feed):
        model, tr = make_trainer(small, 11, topt.Adam(learning_rate=1e-4),
                                 anomaly_policy=policy, wrap_loss=bomb_loss)
        tr.train_step(*batches[0])          # warm
        torch.cuda.synchronize()
        async_dispatch.reset_host_sync_count()
        t0 = time.perf_counter()
        for x, y in feed:
            tr.train_step(x, y)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / len(feed)
        syncs = async_dispatch.host_sync_count()
        params = {n: p.detach().clone() for n, p in model.named_parameters()}
        return tr, ms, syncs, params

    clean, clean_ms, _, p_clean = run("raise", [b for i, b in
                                                enumerate(batches) if i != 2])
    del clean
    rb, rb_ms, rb_syncs, p_rb = run("rollback", [bad if i == 2 else b for
                                                i, b in enumerate(batches)])
    same = all(torch.equal(p_rb[n], p_clean[n]) for n in p_clean)
    diff = max(((p_rb[n] - p_clean[n]).abs().max()
                / p_clean[n].abs().max().clamp_min(1e-30)).item()
               for n in p_clean)
    ok = (rb.stats["rollback_steps"] == 1 and rb._step_count == 5
          and rb_syncs == 5 and diff <= TOL_RECOMPUTE)
    log(f"[train-anomaly] {smi}: rollback, gpt3-1.3b width, 2 layers, 2 x "
        f"512, sentinel batch 3 of 5: rollback_steps "
        f"{rb.stats['rollback_steps']}, steps counted {rb._step_count}, "
        f"host syncs {rb_syncs} for 5 steps; parameters against the run "
        f"that never saw the batch: bitwise {same}, worst relative "
        f"{diff:.3e}; snapshot {rb.snapshot_bytes} bytes, step_ms="
        f"{rb_ms:.3f} against {clean_ms:.3f} under 'raise' "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("train-anomaly rollback failed")
    del rb, p_rb, p_clean
    del_all()

    # FLAGS_check_nan_inf: every gradient poisoned on step 1
    flags.set_flags({"FLAGS_check_nan_inf": True})
    os.environ["PADDLE_FAULT_NAN_STEP"] = "1"
    try:
        model, tr = make_trainer(small, 12, topt.SGD(learning_rate=0.0))
    finally:
        del os.environ["PADDLE_FAULT_NAN_STEP"]
        flags.set_flags({"FLAGS_check_nan_inf": False})
    try:
        tr.train_step(*batches[0])
        named = None
    except errors.PreconditionNotMetError as e:
        named = str(e)
    want = [f"{n}@GRAD" for n, _ in model.named_parameters()]
    ok = named is not None and all(w in named for w in want) and \
        "'loss'" not in named
    log(f"[train-anomaly] FLAGS_check_nan_inf, 2 layers, gradients poisoned "
        f"on step 1: raised {named is not None}, names all {len(want)} "
        f"gradients and not the loss: {ok} "
        f"({(named or '')[:120]}...) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("train-anomaly nan guard failed")
    log("[train-anomaly] ok")
    return paths


def phase_train_checkpoint(bf16, smi):
    """gpt3-1.3b width at 1 layer (the depth cut only for disk and
    time), bf16 AMP, Adam: save(manifest=True) after 2 steps, a fresh
    trainer loads it and its next 2 losses equal the uninterrupted
    trainer's bitwise; a CheckpointManager(keep_last=2) over 3 async
    saves keeps the newest 2, both valid.  Bytes and seconds printed."""
    import shutil
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import CheckpointManager, checkpoint
    small = full_cfg(1)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_checkpoints")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    rng = np.random.RandomState(4)
    batches = [token_batch(rng, small.vocab_size, 2, 512) for _ in range(4)]
    try:
        _, a = make_trainer(small, 21, topt.Adam(learning_rate=1e-4))
        for bt in batches[:2]:
            a.train_step(*bt)
        path = os.path.join(root, "ck")
        t0 = time.perf_counter()
        a.save(path, extra={"phase": "train-checkpoint"}, manifest=True)
        save_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(path, f))
                     for f in os.listdir(path))
        rest_a = [float(a.train_step(*bt)) for bt in batches[2:]]
        _, b = make_trainer(small, 22, topt.Adam(learning_rate=1e-4))
        t0 = time.perf_counter()
        extra = b.load(path)
        load_s = time.perf_counter() - t0
        rest_b = [float(b.train_step(*bt)) for bt in batches[2:]]
        del b
        mgr = CheckpointManager(os.path.join(root, "managed"), keep_last=2)
        t0 = time.perf_counter()
        snap_ms = []
        for bt in batches[:3]:
            a.train_step(*bt)
            mgr.save(a)
            snap_ms.append(mgr.last_snapshot_ms)
        mgr.wait()
        mgr_s = time.perf_counter() - t0
        kept = sorted(os.listdir(os.path.join(root, "managed")))
        valid = all(checkpoint.validate_checkpoint(
            os.path.join(root, "managed", k)) for k in kept)
        ok = (rest_a == rest_b and extra == {"phase": "train-checkpoint"}
              and kept == ["ckpt-6", "ckpt-7"] and valid)
        log(f"[train-checkpoint] {smi}: gpt3-1.3b width, 1 layer, Adam: "
            f"save(manifest=True) {nbytes} bytes in {save_s:.3f} s "
            f"({nbytes / save_s / 1e9:.3f} GB/s), load {load_s:.3f} s; "
            f"next 2 losses {rest_b} resumed vs {rest_a} uninterrupted "
            f"(bitwise {rest_a == rest_b}); CheckpointManager(keep_last=2) "
            f"over 3 async saves: kept {kept}, valid {valid}, snapshots "
            f"{[round(x, 1) for x in snap_ms]} ms on the training thread, "
            f"{mgr_s:.3f} s in all, last commit {mgr.last_commit_ms:.1f} ms "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("train-checkpoint failed")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {}


def phase_train_telemetry(bf16, smi):
    """Telemetry on the training path: the bf16 trainer of ``train``
    (gpt3-1.3b, full depth, 4 x 2048, Adam) built twice from one seed,
    with telemetry off and on (tracer, metrics, flight recorder, a 120 s
    watchdog, ``PADDLE_TPU_PROFILE=2:4:<dir>``).  Each takes a warm-up
    step, then 3 steps: no host sync in either, the on trainer's
    ``h2d``, ``dispatch`` and (reading the loss) ``sync`` spans,
    ``train_steps_total`` moved by the step count, its capture over
    steps 2-3 holding the flash forward and both backward kernels by
    name; then step ms off and on in turns (off, on, on, off, 2 steps
    each).  Last, at 2 layers and 2 x 512 (the depth cut for time, as
    train-anomaly's), a rollback run leaves a ``rollback`` bundle whose
    events end in ``anomaly_rollback``, read back by the bundle
    reader."""
    import shutil
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import async_dispatch
    from paddle_tpu_torch.observability import flightrec, spans
    tag = "train-telemetry"
    cfg = full_cfg()
    ids, labels = token_batch(np.random.RandomState(0), cfg.vocab_size, 4,
                              2048)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_train_telemetry")
    shutil.rmtree(root, ignore_errors=True)
    tr = spans.tracer()
    problems, paths, trainers = [], {}, {}
    try:
        for on in (False, True):
            with telemetry(on):
                if on:
                    os.environ["PADDLE_TPU_PROFILE"] = f"2:4:{root}"
                try:
                    trainers[on] = make_trainer(
                        cfg, 4321, topt.Adam(learning_rate=1e-4))[1]
                finally:
                    os.environ.pop("PADDLE_TPU_PROFILE", None)
                trainers[on].train_step(ids, labels)          # warm-up
        for on in (False, True):
            trainer = trainers[on]
            with telemetry(on):
                tr.clear()
                steps0 = trainer._m_steps.value
                torch.cuda.synchronize()
                zero_launches()
                async_dispatch.reset_host_sync_count()
                out = [trainer.train_step(ids, labels) for _ in range(3)]
                torch.cuda.synchronize()
                syncs = async_dispatch.host_sync_count()
                launches = read_launches()
                if on:
                    trainer._profile.close()     # after steps 2 and 3
                loss = float(out[-1])
                names = {e["name"] for e in tr.chrome_trace()["traceEvents"]
                         if e["ph"] == "X"}
            side = "on" if on else "off"
            paths[f"{tag}-{side}"] = launches
            ok = (syncs == 0 and np.isfinite(loss)
                  and all(launches[k] == 3 * cfg.num_layers for k in FLASH))
            if on:
                cap = read_capture(trainer._profile.trace_path, 2)
                kernels = [has_kernel(cap["names"], k) for k in (
                    "attn_fwd_kernel", "flash_bwd_dq_kernel",
                    "flash_bwd_dkv_kernel")]
                ok = (ok and {"h2d", "dispatch", "sync"} <= names
                      and trainer._m_steps.value - steps0 == 3
                      and all(kernels) and trainer.watchdog is not None
                      and not trainer.watchdog.stalls)
                log(f"[{tag}] on: capture {trainer._profile.trace_path}: "
                    f"per step {cap['kernel_ms']:.3f} ms of device kernels "
                    f"in {cap['wall_ms']:.3f} ms (busy share "
                    f"{cap['busy_share']:.3f}); flash fwd/dq/dkv in it "
                    f"{kernels}; spans {sorted(names)}; train_steps_total "
                    f"+{trainer._m_steps.value - steps0:g}; doctor "
                    f"{trainer.stats['doctor']} (card: {smi})")
            log(f"[{tag}] {side}: 3 steps, host syncs {syncs}, last loss "
                f"{loss:.4f}, launches {launches} {'ok' if ok else 'FAIL'}")
            if not ok:
                problems.append(f"{side} run")
        ms = {False: [], True: []}
        for on in (False, True, True, False):
            with telemetry(on):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(2):
                    trainers[on].train_step(ids, labels)
                torch.cuda.synchronize()
            ms[on].append((time.perf_counter() - t0) * 1e3 / 2)
        log(f"[{tag}] step ms in turns off {[round(x, 3) for x in ms[False]]}"
            f", on {[round(x, 3) for x in ms[True]]}: on/off "
            f"{np.mean(ms[True]) / np.mean(ms[False]):.4f} (train phase "
            f"{bf16['step_ms']:.3f}; card: {smi})")
        for trainer in trainers.values():
            if trainer.watchdog is not None:
                trainer.watchdog.disarm()
        del trainers, trainer, out
        del_all()

        small = full_cfg(2)
        rng = np.random.RandomState(9)
        batches = [token_batch(rng, small.vocab_size, 2, 512)
                   for _ in range(3)]
        batches[1][1][0, 0] = SENTINEL
        os.environ["PADDLE_TPU_FLIGHTREC_DIR"] = root
        try:
            with telemetry(True):
                _, rb = make_trainer(small, 11, topt.Adam(learning_rate=1e-4),
                                     anomaly_policy="rollback",
                                     wrap_loss=bomb_loss)
                for x, y in batches:
                    rb.train_step(x, y)
        finally:
            del os.environ["PADDLE_TPU_FLIGHTREC_DIR"]
        found = flightrec.find_bundles(root, reason="rollback")
        events = [[e["kind"] for e in
                   flightrec.load_bundle(p)["bundle"]["events"]]
                  for p in found]
        ok = (rb.stats["rollback_steps"] == 1 and len(found) == 1
              and events[0][-1] == "anomaly_rollback")
        log(f"[{tag}] rollback, 2 layers, 2 x 512: bundles {found}, events "
            f"{events} {'ok' if ok else 'FAIL'}")
        if not ok:
            problems.append("rollback bundle")
    finally:
        tr.stop()
        tr.clear()
        shutil.rmtree(root, ignore_errors=True)
    finish(tag, problems)
    return paths


# ---- GPT-MoE: gpt3-1.3b widths, every other FFN a top-2 expert layer --------
MOE = dict(moe_num_experts=8, moe_top_k=2, moe_every_n_layers=2,
           moe_capacity_factor=2.0)


def new_rules():
    """Every update rule of the port's later optimizer slice, each with an
    L1 or L2 regularizer and global-norm clip where its JAX signature
    takes them."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch import regularizer as reg
    from paddle_tpu_torch.incubate import LookAhead, ModelAverage
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm

    def clip():
        return ClipGradByGlobalNorm(1.0)
    return {
        "adagrad-l1": lambda: topt.Adagrad(
            1e-2, weight_decay=reg.L1Decay(1e-4), grad_clip=clip()),
        "rmsprop-centered-l2": lambda: topt.RMSProp(
            1e-3, momentum=0.9, centered=True,
            weight_decay=reg.L2Decay(1e-4), grad_clip=clip()),
        "adadelta-l1": lambda: topt.Adadelta(
            1.0, weight_decay=reg.L1Decay(1e-4), grad_clip=clip()),
        "adamax-l2": lambda: topt.Adamax(
            1e-3, weight_decay=reg.L2Decay(1e-4), grad_clip=clip()),
        "lamb": lambda: topt.Lamb(1e-3, grad_clip=clip()),
        "lars": lambda: topt.Lars(0.1, grad_clip=clip()),
        "lookahead-adam-l2": lambda: LookAhead(topt.Adam(
            1e-3, weight_decay=reg.L2Decay(1e-4), grad_clip=clip()), k=1),
        "modelaverage": lambda: ModelAverage(0.5, min_average_window=1,
                                             max_average_window=2),
    }


def rel_diff(card, cpu):
    """max |card - cpu| / max |cpu| of one tensor (0 for equal zeros)."""
    ref = cpu.double()
    err = (card.detach().cpu().double() - ref).abs().max().item()
    return err / max(ref.abs().max().item(), 1e-30)


def phase_train_optimizers(bf16, smi):
    """train-optimizers: every new rule's update on the card against the
    same update on f64 CPU copies (gpt3-1.3b width at 2 layers, the
    gradients of one 2 x 512 bf16 AMP step, the last block's and the
    final norm's tensors); then Lamb and LookAhead(Adam)
    with an EMA of the masters at full depth, 4 x 2048, bf16 AMP: a
    warm-up and 3 measured steps (finite falling losses, no host read,
    each flash kernel once a layer a step), step ms beside Adam's."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import async_dispatch
    from paddle_tpu_torch.incubate import LookAhead
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    t_phase = time.perf_counter()
    problems = []
    zero_launches()
    cfg = full_cfg(2)
    model, trainer = make_trainer(cfg, 77, topt.SGD(learning_rate=0.0))
    ids, labels = token_batch(np.random.RandomState(23), cfg.vocab_size, 2,
                              512)
    trainer.train_step(ids, labels)
    # the f64 CPU reference took most of the phase (about 130 s over
    # every tensor): it checks the last block and the final norm (every
    # kind of tensor the rules update), not the embeddings and the first
    # block
    keep = [n for n, _ in model.named_parameters()
            if n.startswith(("gpt.blocks.1.", "gpt.ln_f."))]
    params = {n: p.detach().clone() for n, p in model.named_parameters()
              if n in keep}
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if n in keep}
    del model, trainer
    del_all()
    cpu_p = {n: t.double().cpu() for n, t in params.items()}
    cpu_g = {n: t.double().cpu() for n, t in grads.items()}
    step = torch.tensor(1, dtype=torch.int32, device="cuda")
    for name, make in new_rules().items():
        card, host = make(), make()
        p_card = {n: t.clone() for n, t in params.items()}
        p_host = {n: t.clone() for n, t in cpu_p.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with HostReads(device_only=True) as reads:
            card.apply_gradients(p_card, grads, step=step)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        host.apply_gradients(p_host, cpu_g, step=1)
        worst = {n: rel_diff(p_card[n], p_host[n]) for n in params}
        for n, accs in card._accumulators.items():
            for a, t in accs.items():
                ref = host._accumulators[n][a]
                worst[f"{n}@{a}"] = rel_diff(t, ref) \
                    if t.is_floating_point() else \
                    float(not torch.equal(t.cpu(), ref.cpu()))
        key = max(worst, key=worst.get)
        ok = worst[key] <= TOL_OPT_UPDATE and reads.n == 0
        log(f"[train-optimizers] {name}: one update of {len(params)} "
            f"parameters on the card in {ms:.3f} ms (host clock, first call) "
            f"vs f64 on the CPU: worst max|diff|/max|cpu| {worst[key]:.3e} "
            f"({key}; tol {TOL_OPT_UPDATE}); host reads {reads.n} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            problems.append(f"{name} update differs or reads back")
        del card, host, p_card, p_host
    del params, grads, cpu_p, cpu_g
    del_all()

    # full depth: Lamb and LookAhead(Adam), each with an EMA of the masters
    cfg = full_cfg()
    layers, n_meas = cfg.num_layers, 3
    ids, labels = token_batch(np.random.RandomState(0), cfg.vocab_size, 4,
                              2048)
    total = {}
    for name, make in (
            ("lamb", lambda: topt.Lamb(
                1e-3, grad_clip=ClipGradByGlobalNorm(1.0))),
            ("lookahead-adam", lambda: LookAhead(
                topt.Adam(learning_rate=1e-4), alpha=0.5, k=2))):
        model, trainer = make_trainer(cfg, 4321, make())
        ema = topt.ExponentialMovingAverage(0.999, thres_steps=True)
        state = ema.init_state(trainer.params)
        results = [trainer.train_step(ids, labels)]
        ema.update_state(trainer.params, state)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        async_dispatch.reset_host_sync_count()
        # Adam reads its host step size (a CPU scalar) back once a step
        with HostReads(device_only=True) as reads:
            t0 = time.perf_counter()
            for _ in range(n_meas):
                results.append(trainer.train_step(ids, labels))
                ema.update_state(trainer.params, state)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        syncs = async_dispatch.host_sync_count()
        launches = read_launches()
        add_launches(total, launches)
        peak = torch.cuda.max_memory_allocated()
        losses = [float(r) for r in results]
        avg = ema.averaged(trainer.params, state)
        ema_ok = int(state["t"]) == n_meas + 1 and all(
            bool(torch.isfinite(a).all()) for a in avg.values())
        del avg
        ema_ms = cuda_ms(lambda: ema.update_state(trainer.params, state),
                         iters=3, warmup=0)
        acc_bytes = sum(t.numel() * t.element_size()
                        for accs in trainer.optimizer._accumulators.values()
                        for t in accs.values())
        step_ms = wall * 1e3 / n_meas
        log(f"[train-optimizers] {name} + EMA of the masters, gpt3-1.3b, "
            f"4 x 2048, bf16 AMP: losses {[round(x, 4) for x in losses]} "
            f"(first a warm-up); step_ms={step_ms:.3f} with the EMA update "
            f"(EMA alone {ema_ms:.3f} ms; Adam's step in the train phase of "
            f"this call {bf16['step_ms']:.3f} ms); optimizer state "
            f"{acc_bytes} bytes, EMA {4 * sum(p.numel() for p in model.parameters())} "
            f"bytes, max_memory_allocated={peak} bytes; host syncs {syncs}, "
            f"host reads {reads.n}; launches "
            f"{{{', '.join(f'{k}: {v}' for k, v in launches.items() if v)}}} "
            f"({smi})")
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            problems.append(f"{name}: losses not finite and falling: {losses}")
        if syncs or reads.n:
            problems.append(f"{name}: {syncs} host syncs, {reads.n} host reads")
        if not ema_ok:
            problems.append(f"{name}: EMA step count or averages off")
        for key in FLASH:
            if launches[key] != layers * n_meas:
                problems.append(f"{name}: {key} launches {launches[key]} != "
                                f"{layers} x {n_meas}")
        del model, trainer, ema, state
        del_all()
    log(f"[train-optimizers] phase {time.perf_counter() - t_phase:.1f} s")
    finish("train-optimizers", problems)
    return {"train-optimizers": total}


def moe_cfg(layers=None, fused_ce=False):
    """gpt3-1.3b's widths (hidden 2048, 16 heads of 128, FFN 8192, vocab
    50304) with GShard's layout: every second FFN is a top-2 layer of 8
    experts at capacity factor 2.0 (``layers``: depth cut)."""
    import dataclasses
    from paddle_tpu_torch.models import gpt_configs
    cfg = dataclasses.replace(gpt_configs()["gpt3-1.3b"], fused_ce=fused_ce,
                              **MOE)
    if layers is not None:
        cfg.num_layers = layers
    return cfg


def moe_expert_bytes(cfg, itemsize):
    """The expert tensors' bytes: E x (2 H F + F + H) per MoE layer."""
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    h, f = cfg.hidden_size, cfg.ffn_hidden_size
    return n_moe * cfg.moe_num_experts * (2 * h * f + f + h) * itemsize


def check_moe_stats(tag, eng, problems):
    """The engine's expert stats: load + dropped = assigned (counts), and
    its ``moe_experts`` ledger line is the expert tensors' bytes."""
    from paddle_tpu_torch.observability import exec_registry
    st = eng.stats()
    load = st["moe_expert_load"]
    assigned, dropped = st["moe_assigned_tokens"], st["moe_dropped_tokens"]
    lines = [r["bytes"] for r in exec_registry.ledger().snapshot()["tracked"]
             if r["category"] == "moe_experts"
             and r["name"] == eng.telemetry_label]
    want = moe_expert_bytes(eng.model.cfg, 2)
    log(f"[{tag}] expert load {load} assigned {assigned} dropped {dropped} "
        f"dropped_rate {st['moe_dropped_rate']} load_skew "
        f"{st['moe_load_skew']}; moe_experts ledger line {lines} bytes "
        f"(want {want}); stats decode_megakernel {st['decode_megakernel']}")
    if load is None or sum(load) + dropped != assigned or assigned <= 0:
        problems.append(f"load {load} + dropped {dropped} != assigned "
                        f"{assigned}")
    if lines != [want]:
        problems.append(f"moe_experts ledger line {lines} != [{want}]")
    if st["decode_megakernel"]:
        problems.append("stats report the megakernel on a MoE model")
    return st


def build_moe_model(layers=None):
    from paddle_tpu_torch.core import random as prandom
    from paddle_tpu_torch.models import GPTForCausalLM
    cfg = moe_cfg(layers)
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                           generator=prandom.seed(1234, "cuda"))
    model.eval()
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    log(f"[serve-moe] gpt3-1.3b widths, {cfg.num_layers} layers ({n_moe} MoE "
        f"of {cfg.moe_num_experts} experts, top-{cfg.moe_top_k}, capacity "
        f"factor {cfg.moe_capacity_factor}): {n / 1e9:.3f} B params bf16 "
        f"({n * 2 / 1e9:.2f} GB), init {time.perf_counter() - t0:.2f} s")
    return model


class Ranges:
    """While active, ``MoELayer._fn_dense`` and the expert FFN run inside
    ``torch.profiler.record_function`` ranges (``moe_layer``,
    ``moe_experts``), so a capture can split a step's device time."""

    def __enter__(self):
        from paddle_tpu_torch.distributed import moe
        self._saved = (moe.MoELayer._fn_dense, moe.ExpertParallelFFN.forward)

        def ranged(name, fn):
            def inner(*a, **k):
                with torch.profiler.record_function(name):
                    return fn(*a, **k)
            return inner
        moe.MoELayer._fn_dense = ranged("moe_layer", self._saved[0])
        moe.ExpertParallelFFN.forward = ranged("moe_experts", self._saved[1])
        return self

    def __exit__(self, *exc):
        from paddle_tpu_torch.distributed import moe
        moe.MoELayer._fn_dense, moe.ExpertParallelFFN.forward = self._saved
        return False


def profile_moe_decode(model, smi):
    """A steady MoE decode step (8 active slots of ~520-token prompts):
    wall time of 5 steps on the host clock, 5 steps under torch.profiler
    (busy share, top kernels), then 5 more with the MoE ranges on for
    the split: attention kernels, expert products (the kernels launched
    inside ``moe_experts``), gating / dispatch / combine (the rest of
    ``moe_layer``'s kernels) and everything else.  The ranges' own
    device-side rows (the span from their first to last kernel, idle
    gaps included) are left out of every sum."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.inference import InferenceEngine
    eng = InferenceEngine(model, batch_slots=8, device="cuda")
    rng = np.random.RandomState(13)
    for _ in range(8):
        eng.add_request(rng.randint(0, model.cfg.vocab_size, size=512),
                        max_new_tokens=20)
    for _ in range(3):
        eng.step()
    steps = 5
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        for _ in range(steps):
            eng.step()
    what = "MoE dense bf16 decode step (8 active, ~520-token slots)"
    report_profile(prof, steps, wall_ms, what)
    with Ranges(), profile(activities=acts) as prof:
        for _ in range(steps):
            eng.step()
    del eng
    ranges = ("moe_layer", "moe_experts")
    events = prof.key_averages()
    kernels = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA
                  and e.key not in ranges) / steps / 1e3
    attn = sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA
               and "decode_kernel" in e.key) / steps / 1e3
    inside = {e.key: e.device_time_total / steps / 1e3 for e in events
              if e.key in ranges and e.device_type == DeviceType.CPU}
    if kernels == 0 or not inside.get("moe_layer"):
        log(f"[serve-moe] decode step split: not measured (no device time "
            f"under the ranges); wall {wall_ms:.3f} ms")
        return
    experts = inside.get("moe_experts", 0.0)
    log(f"[serve-moe] decode step split (device ms a step, of {kernels:.3f} "
        f"ms of kernels; unprofiled wall {wall_ms:.3f} ms): attention "
        f"kernels {attn:.3f}, expert products {experts:.3f}, gating/"
        f"dispatch/combine {inside['moe_layer'] - experts:.3f}, the rest "
        f"{kernels - attn - inside['moe_layer']:.3f} (card: {smi})")


# serve-moe's engines at 8 of gpt3-1.3b's 24 layers (a depth cut for
# the script's budget); its teacher-forced checks keep all 24
SERVE_MOE_LAYERS = 8


def phase_serve_moe(smi):
    """GPT-MoE serving at gpt3-1.3b widths (SERVE_MOE_LAYERS layers for
    the engines, 24 for the teacher-forced checks; every second FFN MoE):
    serve's 16 prompts (and serve-paged's, 8 sharing a 1024-token prefix)
    with 32 new tokens through 8 slots on the dense, paged, int8 dense
    and paged, chunked (512) and speculative (K = 4, gpt3-125m draft)
    engines, and with ``enable_decode_megakernel()`` asked for (the
    composed step runs: a MoE model has no fused one); a load-test window
    on the warmed paged engine; teacher-forced prefill + decode; a
    profiled decode step.  Per engine: launches as in serve, one host
    read per decode step or spec tick and admission, load + dropped =
    assigned, the ``moe_experts`` ledger line."""
    model = build_moe_model(SERVE_MOE_LAYERS)
    out = serve_moe_engines(model, smi)
    out.update(serve_moe_spec(model))
    out.update(serve_moe_loadtest(model, smi))
    profile_moe_decode(model, smi)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    model = build_moe_model()
    teacher_moe(model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def teacher_moe(model):
    """``phase_teacher_forced`` on the MoE model with every layer's
    capacity factor raised to E / k for the check.  Capacity is per
    group (a batch row's tokens in one call), so at 2.0 the forward over
    the whole sequence drops other assignments than a bucket-padded
    prefill, a chunk or a verify window does (the JAX package routes the
    same way; the CPU tests hold the drops to JAX's); at E / k no expert
    can overflow (a token's k choices are distinct experts), routing is
    per token, and every cache path must reproduce the forward."""
    cf = model.cfg.moe_num_experts / model.cfg.moe_top_k
    layers = [blk.mlp for blk in model.gpt.blocks if blk.is_moe]
    log(f"[serve-moe] teacher-forced checks at capacity factor {cf} "
        f"(routing per token, no drop):")
    for m in layers:
        m.capacity_factor = cf
    try:
        phase_teacher_forced(model, (None, "int8"))
    finally:
        for m in layers:
            m.capacity_factor = model.cfg.moe_capacity_factor


def moe_hit_routing(layers=8):
    """``python3 chip_smoke.py --moe-hit-routing``: why serve-moe's bf16
    paged-hit teacher check fails at ``layers`` layers.  The hit path of
    ``phase_teacher_forced`` (1024 cached tokens, a 76-token suffix in
    bucket 128, 7 decode steps) at capacity factor E / k, with every MoE
    layer's routing recorded, against the no-cache forward's: per checked
    position the error over its largest |logit| and the layers whose
    top-k expert set differs from the forward's; per layer the suffix and
    decode tokens so rerouted, with the forward's gap between the k-th
    and (k+1)-th gate probabilities at each, beside the median gap.  The
    CPU tests hold the hit path to the JAX package's and to the forward
    in f32 (``tests/test_torch_moe.py``)."""
    from paddle_tpu_torch.distributed import moe
    from paddle_tpu_torch.inference.paged_kv import init_paged_cache
    phase_device()
    phase_build()
    model = build_moe_model(layers)
    cfg = model.cfg
    k = cfg.moe_top_k
    for blk in model.gpt.blocks:
        if blk.is_moe:
            blk.mlp.capacity_factor = cfg.moe_num_experts / k
    rng = np.random.RandomState(11)         # phase_teacher_forced's ids
    steps, hit_prefix, hit_len = 8, 1024, 1100
    ids = torch.from_numpy(
        rng.randint(0, cfg.vocab_size, size=(1, hit_len + steps))).cuda()
    kept, calls = moe.top_k_gating, []

    def recording(logits, top_k, cap, normalize_gates=True):
        out = kept(logits, top_k, cap, normalize_gates)
        calls.append((torch.softmax(logits.float(), -1)[0], out[0][0]))
        return out
    bs, mb = 128, cfg.max_seq_len // 128
    n_moe = sum(blk.is_moe for blk in model.gpt.blocks)
    moe.top_k_gating = recording
    try:
        with torch.no_grad():
            ref = model(ids).float()[0]
            fwd = calls[:]
            pool = init_paged_cache(model, 1 + 9 + 16, bs)

            def table(blocks):
                row = torch.zeros(mb, dtype=torch.int32, device="cuda")
                row[:len(blocks)] = torch.tensor(blocks, dtype=torch.int32)
                return row
            model.prefill_paged(_padded(ids, 0, hit_prefix, hit_prefix),
                                pool, table(list(range(1, 9))), 0,
                                hit_prefix)
            row = table(list(range(1, 10)))
            calls.clear()
            got = [model.prefill_paged(_padded(ids, hit_prefix, hit_len, 128),
                                       pool, row, hit_prefix,
                                       hit_len - hit_prefix)[0]]
            for t in range(hit_len, hit_len + steps - 1):
                got.append(model.decode_step_paged(
                    ids[:, t], pool, row[None],
                    torch.tensor([t], dtype=torch.int32, device="cuda"))[0])
            hit = calls[:]
    finally:
        moe.top_k_gating = kept
    n_suffix = hit_len - hit_prefix
    # hit choices per MoE layer at positions hit_prefix .. hit_len+steps-2
    chosen = []
    for layer in range(n_moe):
        parts = [hit[layer][1][:n_suffix]] + [
            hit[n_moe * (1 + i) + layer][1] for i in range(steps - 1)]
        chosen.append(torch.cat(parts).sort(-1).values)
    first, last = hit_prefix, hit_len + steps - 1
    moved = torch.zeros(last - first, dtype=torch.int64, device="cuda")
    for layer in range(n_moe):
        probs, experts = fwd[layer]
        want = experts[first:last].sort(-1).values
        diff = (want != chosen[layer]).any(-1)
        moved += diff.long()
        top = probs[first:last].sort(-1, descending=True).values
        gap = top[:, k - 1] - top[:, k]
        where = diff.nonzero()[:, 0].tolist()
        log(f"[moe-hit-routing] MoE layer {layer}: {len(where)} of "
            f"{last - first} tokens routed to another top-{k} set than the "
            f"forward's, at positions {[first + i for i in where]}, the "
            f"forward's k-th minus (k+1)-th gate probability there "
            f"{[round(float(gap[i]), 5) for i in where]} (median over the "
            f"tokens {float(gap.median()):.4f})")
    got = torch.cat(got).float()
    for i in range(steps):
        pos = hit_len - 1 + i
        want = ref[pos]
        err = float((got[i] - want).abs().max() / want.abs().max())
        log(f"[moe-hit-routing] position {pos}: max|diff|/max|logit| "
            f"{err:.4e} (TOL_TEACHER {TOL_TEACHER}), MoE layers rerouted "
            f"at this token {int(moved[pos - first])}, argmax "
            f"{'equal' if int(got[i].argmax()) == int(want.argmax()) else 'differs'}")


def serve_moe_engines(model, smi):
    """serve-moe's closed-loop engines but the speculative one."""
    from paddle_tpu_torch.inference import InferenceEngine
    vocab = model.cfg.vocab_size
    dense_p, paged_p = serve_prompts(vocab), paged_prompts(vocab)
    out = {}
    engines = (
        ("serve-moe", dense_p, dict(top_k=50, seed=7), False),
        ("serve-moe-paged", paged_p, dict(kv_layout="paged",
                                          kv_block_size=128, top_k=50,
                                          seed=17), False),
        ("serve-moe-int8-dense", dense_p, dict(kv_dtype="int8"), False),
        ("serve-moe-int8-paged", paged_p, dict(kv_layout="paged",
                                               kv_block_size=128,
                                               kv_dtype="int8"), False),
        ("serve-moe-chunked", dense_p, dict(prefill_chunk=512), False),
        ("serve-moe-mega", dense_p, {}, True))
    for tag, prompts, kw, mega in engines:
        model.enable_decode_megakernel(mega)
        eng = InferenceEngine(model, batch_slots=8, device="cuda", **kw)
        launches, st, problems = drive(tag, eng, prompts, 32)
        check_moe_stats(tag, eng, problems)
        if mega and any(n for k, n in launches.items() if "megakernel" in k):
            problems.append("a megakernel launched on a MoE model")
        if tag == "serve-moe":
            log(f"[{tag}] tokens/s {TOKENS_PER_S[tag]:.1f} against the dense "
                f"gpt3-1.3b serve phase's {TOKENS_PER_S['serve']:.1f} (ratio "
                f"{TOKENS_PER_S[tag] / TOKENS_PER_S['serve']:.3f}); host reads "
                f"{HOST_READS[tag]} against the dense engine's "
                f"{HOST_READS['serve']} on the same prompts (card: {smi})")
            if HOST_READS[tag] != HOST_READS["serve"]:
                problems.append("host reads differ from the dense engine's")
        if "paged" in tag:
            eng.check_leak_free()
        finish(tag, problems)
        out[tag] = launches
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    model.enable_decode_megakernel(False)
    return out


def serve_moe_spec(model):
    """A dense gpt3-125m draft proposes for the MoE target (K = 4)."""
    from paddle_tpu_torch.inference import InferenceEngine
    layers = model.cfg.num_layers
    dense_p = serve_prompts(model.cfg.vocab_size)
    tag, k = "serve-moe-spec", 4
    draft = build_draft()
    eng = InferenceEngine(model, batch_slots=8, spec_k=k, draft_model=draft,
                          device="cuda")
    with HostReads() as reads:
        got, launches, st, _ = run_engine(tag, eng, dense_p, 32)
    ticks = st["spec_ticks"]
    log(f"[{tag}] spec_ticks={ticks} accepted_tokens_per_tick="
        f"{st['accepted_tokens_per_tick']:.4f} host reads {reads.n}")
    problems = []
    if [len(x) for x in got] != [32] * len(dense_p):
        problems.append(f"stream lengths {[len(x) for x in got]}")
    # + 1: run_engine's stats() reads the expert-load accumulator
    if not (st["decode_host_syncs"] == st["decode_steps"] == ticks > 0
            and reads.n == ticks + st["prefills"] + 1):
        problems.append(f"{reads.n} host reads over {ticks} ticks and "
                        f"{st['prefills']} prefills")
    d_layers = draft.cfg.num_layers
    want_l = {"window_attention": (layers + d_layers) * ticks,
              "decode_attention": d_layers * (k - 1) * ticks,
              "flash_fwd": (layers + d_layers) * st["prefills"]}
    for key, n in launches.items():
        if n != want_l.get(key, 0):
            problems.append(f"{key} launches {n} != {want_l.get(key, 0)}")
    check_moe_stats(tag, eng, problems)
    finish(tag, problems)
    del eng, draft
    gc.collect()
    torch.cuda.empty_cache()
    return {tag: launches}


def serve_moe_loadtest(model, smi):
    """One load-test window on the warmed paged MoE engine."""
    from paddle_tpu_torch.inference import InferenceEngine, run_loadtest
    vocab = model.cfg.vocab_size
    tag = "serve-moe-loadtest"
    eng = InferenceEngine(model, batch_slots=8, kv_layout="paged",
                          kv_block_size=128, seed=11, device="cuda")
    eng.warmup(eng.buckets)
    # one read of the expert-load accumulator, by the report's stats()
    # (the window starts before any traffic: nothing to read then)
    rep, launches, _, problems = measured(tag, eng, lambda: run_loadtest(
        eng, 16, 2.0, workload=loadtest_workload(vocab), deadline_s=120.0),
        extra_reads=1)
    report_line(tag, rep, smi)
    cols = {k: rep.get(k) for k in ("moe_num_experts", "ep",
                                    "moe_assigned_tokens", "moe_dropped_rate",
                                    "moe_expert_load", "moe_load_skew")}
    log(f"[{tag}] moe columns {json.dumps(cols)}")
    want = planned_tokens(vocab, 16)
    if rep["tokens_generated"] != want or rep["timed_out_requests"]:
        problems.append(f"{rep['tokens_generated']} tokens of {want}")
    # the rate is rounded to 1e-4
    if None in cols.values() or cols["ep"] != 1 or \
            abs(sum(cols["moe_expert_load"]) - cols["moe_assigned_tokens"]
                * (1 - cols["moe_dropped_rate"])) > \
            5e-5 * cols["moe_assigned_tokens"] + 1:
        problems.append(f"moe columns {cols}")
    eng.drain()
    check_moe_stats(tag, eng, problems)
    finish(tag, problems)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return {tag: launches}


def phase_train_moe(bf16, smi):
    """GPT-MoE training at gpt3-1.3b widths with the depth cut to 12
    layers (6 MoE): bf16 AMP, Adam, fused CE, 4 x 2048, 2 warm-up and 4
    measured steps: finite losses with the router's aux term in them (> 0),
    12 launches of each flash kernel a step, no host sync; step ms,
    tokens/s, peak and the busy share of one profiled step; then one step
    without and one under 'full' recompute at learning rate 0 (same
    weights): losses within TOL_RECOMPUTE, a lower peak."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import async_dispatch
    cfg = moe_cfg(layers=12, fused_ce=True)
    b, s, n_warm, n_meas = 4, 2048, 2, 4
    tag = "train-moe"
    n_full = gpt_params(moe_cfg())
    log(f"[{tag}] state bytes reckoned first (f32 master, Adam m and v, "
        f"f32 gradient, bf16 copy: 18 B a parameter, before activations): "
        f"24 layers {n_full / 1e9:.3f} B params = {n_full * 18 / 1e9:.1f} "
        f"GB; 12 layers {gpt_params(cfg) / 1e9:.3f} B = "
        f"{gpt_params(cfg) * 18 / 1e9:.1f} GB; the card holds "
        f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} GB")
    t0 = time.perf_counter()
    model, trainer = make_trainer(cfg, 4321, topt.Adam(learning_rate=1e-4))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != gpt_params(cfg):
        raise SystemExit(f"{tag}: {n_params} params, reckoned "
                         f"{gpt_params(cfg)}")
    log(f"[{tag}] {cfg.num_layers} layers, {n_params / 1e9:.3f} B params f32, "
        f"bf16 AMP, fused CE, Adam lr 1e-4, batch {b} x {s}, init "
        f"{time.perf_counter() - t0:.2f} s")
    ids, labels = (torch.from_numpy(a).cuda() for a in token_batch(
        np.random.RandomState(0), cfg.vocab_size, b, s))
    moe_layers = [blk.mlp for blk in model.gpt.blocks if blk.is_moe]
    results = []
    for i in range(n_warm + n_meas):
        if i == n_warm:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_launches()
            async_dispatch.reset_host_sync_count()
            t0 = time.perf_counter()
        results.append(trainer.train_step(ids, labels))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    syncs = async_dispatch.host_sync_count()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(r) for r in results]
    aux = sum(m.last_aux_loss.float() for m in moe_layers).item()
    step_ms = wall * 1e3 / n_meas
    log(f"[{tag}] losses {[round(x, 4) for x in losses]} (first {n_warm} "
        f"warm-up); the last step's aux term {aux:.6f} over "
        f"{len(moe_layers)} MoE layers")
    log(f"[{tag}] {n_meas} steps in {wall:.3f} s: step_ms={step_ms:.3f} "
        f"tokens_per_s={n_meas * b * s / wall:.1f} max_memory_allocated="
        f"{peak} bytes host_syncs={syncs} (dense gpt3-1.3b train step_ms "
        f"{bf16['step_ms']:.3f}; card: {smi}); no MFU: flops_per_token "
        f"counts no experts")
    problems = []
    if not all(np.isfinite(losses)) or not aux > 0:
        problems.append(f"losses {losses}, aux {aux}")
    if syncs != 0:
        problems.append(f"{syncs} host syncs in the measured steps")
    for key in FLASH:
        if launches[key] != cfg.num_layers * n_meas:
            problems.append(f"{key} launches {launches[key]} != "
                            f"{cfg.num_layers} x {n_meas}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.train_step(ids, labels)
        torch.cuda.synchronize()
    report_profile(prof, 1, step_ms, f"{tag} step (12 layers, 4 x 2048)")

    # recompute at learning rate 0: both steps run on the same weights
    trainer.optimizer.set_lr(0.0)

    def one_step():
        zero_launches()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss = float(trainer.train_step(ids, labels))
        torch.cuda.synchronize()
        return (loss, torch.cuda.max_memory_allocated() - base,
                read_launches()["flash_fwd"])

    plain, plain_peak, _ = one_step()
    model.enable_recompute("full")
    rec, rec_peak, rec_fwd = one_step()
    diff = abs(rec - plain) / abs(plain)
    ok = (rec_fwd == 2 * cfg.num_layers and diff <= TOL_RECOMPUTE
          and rec_peak < plain_peak)
    log(f"[{tag}] full recompute: loss {rec:.6f} vs {plain:.6f} without "
        f"(relative diff {diff:.3e}, tol {TOL_RECOMPUTE}); flash_fwd "
        f"launches {rec_fwd}; peak above the resident state {rec_peak} vs "
        f"{plain_peak} bytes without {'ok' if ok else 'FAIL'}")
    if not ok:
        problems.append("recompute")
    finish(tag, problems)
    del model, trainer, moe_layers
    return {tag: launches}


# ---------------------------------------------------------------------------
# Transformer-base through the layer API (nn.Transformer()'s defaults:
# d_model 512, 8 heads of 64, 6 + 6 layers, ffn 2048, dropout 0.1, relu,
# post-norm; Vaswani et al. 2017, Table 3 "base"), one shared embedding
# over WMT'14 EN-DE's 37000-token BPE vocabulary, one card's share of a
# batch: 16 x 256 source and 16 x 256 target tokens
# ---------------------------------------------------------------------------
TB_VOCAB, TB_B, TB_S, TB_HEADS, TB_D, TB_LAYERS = 37000, 16, 256, 8, 64, 6
TB_STEPS, TB_EVAL, TB_PREDICT, TB_TRAINER_STEPS = 10, 4, 2, 10
# rows 1-3 at the Transformer-base shape against their plain versions:
# the same rounding as at the other shapes (TOL_OUT), held to 1e-2 per
# row in the backward too
TOL_TB = 1e-2
# the composite's paths: every other path must read 0 composite calls
# the layer API's paths: the decoder's masked self-attention takes the
# composite (under a capture, counted when the graph is traced)
TB_PATHS = ("train-transformer", "train-transformer-trainer",
            "jit-transformer", "capi", "c-trainer")
COMPOSITE_KEY = "attention_composite"


def tb_timings(q, k, v, do, p):
    """(fwd, dq, dk/dv, plain fwd, plain bwd, SDPA fwd, SDPA bwd) ms of
    rows 1-3 at q's shape, non-causal, dropout ``p`` (0: the forms
    without it): each kernel by its C entry.  At this shape a kernel
    takes tens of microseconds, less than the host needs to launch it,
    so the kernels and SDPA are timed on the device clock
    (``device_ms``: their kernels' summed time, no launch gaps); the
    plain versions by CUDA events."""
    from paddle_tpu_torch.core import random as prandom
    calls = flash_entry_calls(q, k, v, do, False, p,
                              prandom.philox_pair("cuda"))
    calls["dq"]()

    def dev(fn, iters=50):
        t = device_ms(fn, iters=iters)
        if t is None:
            raise SystemExit("transformer-kernels: the profiler recorded "
                             "no device time")
        return t

    t_f, t_dq, t_dkv = (dev(calls[key]) for key in ("fwd", "dq", "dkv"))
    t_pf, t_pb = (cuda_ms(calls[key], iters=3, warmup=1)
                  for key in ("plain_fwd", "plain_bwd"))
    t_lf = dev(calls["lib_fwd"])
    t_lb = dev(calls["lib_bwd"]) - t_lf
    return t_f, t_dq, t_dkv, t_pf, t_pb, t_lf, t_lb


def phase_transformer_kernels(records):
    """Rows 1-3 at the Transformer-base shape (B=16, S=256, H=Hkv=8,
    D=64, non-causal, bf16): the forward, the dq and dk/dv kernels and
    their dropout forms at p = DROP_P against the plain versions within
    TOL_TB per row (each call twice, bitwise equal), then timed beside
    the plain versions and SDPA; written into the rows' records as the
    ``transformer_base`` shape entry (p = 0 on rows 1-3, p = DROP_P on
    their dropout forms)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    shape = (TB_B, TB_S, TB_HEADS, TB_HEADS, TB_D)
    *_, f_err, f_worst = check_flash(gen, *shape, causal=False)
    _, b_errs = check_bwd(gen, *shape, causal=False, tol=TOL_TB)
    d_errs = check_dropout(gen, *shape, causal=False, bwd_tol=TOL_TB)
    errs = {"flash_fwd": (f_err, f_worst), **b_errs, **d_errs}
    q, k, v, do = (_rand((TB_B, TB_S, TB_HEADS, TB_D), gen)
                   for _ in range(4))
    b, s, h, d = q.shape
    pairs = b * h * s * s
    row_bytes = b * h * s * 4
    work = {"flash_fwd": (4 * d * pairs, 2 * (2 * q.numel() + k.numel()
                                              + v.numel()) + row_bytes),
            "flash_bwd_dq": (3 * 2 * d * pairs,
                             2 * (4 * q.numel() + 2 * k.numel())
                             + 2 * row_bytes),
            "flash_bwd_dkv": (4 * 2 * d * pairs,
                              2 * (2 * q.numel() + 4 * k.numel())
                              + 2 * row_bytes)}
    for p in (0.0, DROP_P):
        t_f, t_dq, t_dkv, t_pf, t_pb, t_lf, t_lb = tb_timings(q, k, v, do, p)
        for base, t, t_plain, t_lib in (
                ("flash_fwd", t_f, t_pf, t_lf),
                ("flash_bwd_dq", t_dq, t_pb, t_lb),
                ("flash_bwd_dkv", t_dkv, t_pb, t_lb)):
            key = f"{base}_dropout" if p else base
            flops, nbytes = work[base]
            b_ms, b_by = bound(flops, nbytes + (16 if p else 0))
            log(f"[transformer-kernels] {key} B={b} S={s} H={h} D={d} "
                f"non-causal p={p} (device clock): kernel_ms={t:.4f} "
                f"bound_ms={b_ms:.4f} "
                f"({b_by}; share {b_ms / t:.3f}) plain_ms={t_plain:.4f} "
                f"library_ms={t_lib:.4f} (SDPA{' backward' if base != 'flash_fwd' else ''}"
                f"{f', dropout_p={p}' if p else ''}; x {t / t_lib:.3f})")
            err = errs[key]
            records[key]["transformer_base"] = dict(
                shape=[b, s, h, h, d], causal=False, dropout_p=p,
                max_abs_err=err[0], max_row_rel_err=err[1],
                row_tol=TOL_OUT if base == "flash_fwd" else TOL_TB, ms=t,
                plain_ms=t_plain, library_ms=t_lib, bound_ms=b_ms,
                bound_by=b_by, clock="device (torch.profiler); plain_ms "
                                     "CUDA events")


def tb_sinusoid(length, d):
    """The paper's positional encodings ``[length, d]`` (f32)."""
    pos = np.arange(length, dtype=np.float64)[:, None]
    i = np.arange(d // 2, dtype=np.float64)[None, :]
    ang = pos / np.power(10000.0, 2 * i / d)
    out = np.zeros((length, d), np.float32)
    out[:, 0::2], out[:, 1::2] = np.sin(ang), np.cos(ang)
    return torch.from_numpy(out)


def tb_network(dropout=0.1, layers=TB_LAYERS):
    """Transformer-base from the port's layers: one Embedding(37000, 512)
    shared by source and target, scaled by sqrt(512), plus sinusoidal
    positions, dropout 0.1, ``nn.Transformer()`` at its defaults, and
    Linear(512, 37000) (``dropout``: every dropout's rate; ``layers``:
    encoder and decoder depth, a cut below the default 6)."""
    from paddle_tpu_torch import nn

    class TransformerBase(nn.Layer):
        def __init__(self):
            super().__init__()
            self.d_model = 512
            self.embedding = nn.Embedding(
                TB_VOCAB, self.d_model,
                weight_attr=nn.initializer.Normal(0.0, self.d_model ** -0.5))
            self.dropout = nn.Dropout(dropout)
            self.transformer = nn.Transformer(
                num_encoder_layers=layers, num_decoder_layers=layers,
                dropout=dropout)
            self.project = nn.Linear(self.d_model, TB_VOCAB)
            self.register_buffer("position",
                                 tb_sinusoid(TB_S, self.d_model).cuda(),
                                 persistable=False)

        def embed(self, ids):
            x = self.embedding(ids) * self.d_model ** 0.5
            # the positions take the embedding's dtype (bf16 under the
            # trainer's AMP copies)
            return self.dropout(x + self.position[:ids.shape[1]].to(x.dtype))

        def forward(self, src, tgt):
            mask = self.transformer.generate_square_subsequent_mask(
                tgt.shape[1])
            return self.project(self.transformer(
                self.embed(src), self.embed(tgt), tgt_mask=mask))

    return TransformerBase()


def tb_loss():
    """``CrossEntropyLoss(soft_label=True)`` on
    ``label_smooth(one_hot(y, 37000), epsilon=0.1)``."""
    from paddle_tpu_torch import nn

    class SmoothedCrossEntropy(nn.Layer):
        def __init__(self):
            super().__init__()
            self.ce = nn.CrossEntropyLoss(soft_label=True)

        def forward(self, logits, label):
            soft = nn.functional.label_smooth(
                nn.functional.one_hot(label, TB_VOCAB), epsilon=0.1)
            return self.ce(logits, soft)

    return SmoothedCrossEntropy()


def tb_data(n, seed):
    """A copy task: the decoder reads ``[1] + src[:-1]`` and must emit
    ``src`` (token ids in [4, 37000))."""
    from paddle_tpu_torch.io import TensorDataset
    rng = np.random.RandomState(seed)
    src = rng.randint(4, TB_VOCAB, (n, TB_S)).astype(np.int64)
    tgt = np.concatenate([np.ones((n, 1), np.int64), src[:, :-1]], axis=1)
    return TensorDataset([src, tgt, src])


def tb_model(strategy=None):
    import paddle_tpu_torch as paddle
    net = tb_network()
    sched = paddle.optimizer.lr.NoamDecay(d_model=512, warmup_steps=4000,
                                          last_epoch=3999)
    opt = paddle.optimizer.Adam(learning_rate=sched, beta1=0.9, beta2=0.98,
                                epsilon=1e-9, parameters=net.parameters())
    m = paddle.Model(net)
    m.prepare(opt, tb_loss(), paddle.metric.Accuracy(), strategy=strategy)
    return m, sched


def tb_step_recorder(profile_step):
    from paddle_tpu_torch.hapi import callbacks

    class StepRecorder(callbacks.Callback):
        """Per-step loss, ``ms`` (from the step's begin callback to its
        end, after a device sync: the step's host and device work, not
        the DataLoader's fetch and collate of its batch, which run
        before the begin callback) and ``period_ms`` (from the previous
        step's end to this one's: the fetch included).  Step
        ``profile_step`` (counted over the whole fit) runs under
        torch.profiler from the previous step's end to its own, fetch
        included: ``profile`` holds the summary (``tb_step_profile``),
        ``profile_cost_s`` the seconds the callbacks spent starting,
        stopping and reading the profiler."""

        def __init__(self):
            super().__init__()
            self.losses, self.ms, self.period_ms = [], [], []
            self.profile, self._prof, self._end = None, None, None
            self.profile_cost_s = 0.0

        def on_train_batch_begin(self, step, logs=None):
            self._t0 = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(float(logs["loss"]))
            torch.cuda.synchronize()
            now = time.perf_counter()
            self.ms.append((now - self._t0) * 1e3)
            if self._end is not None:
                self.period_ms.append((now - self._end) * 1e3)
            if self._prof is not None:
                self._prof.__exit__(None, None, None)
                self.profile = tb_step_profile(self._prof,
                                               (now - self._end) * 1e3)
                self._prof = None
            if len(self.losses) == profile_step:
                from torch.profiler import ProfilerActivity, profile
                self._prof = profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA])
                self._prof.__enter__()
            self._end = time.perf_counter()
            self.profile_cost_s += self._end - now

    return StepRecorder()


def tb_step_profile(prof, wall_ms):
    """One profiled step: the device's busy ms (the union of its kernel
    and copy intervals), its idle share of the step's wall (profiler on),
    and the five largest device kernels and host ops by self time; None
    where the profiler recorded no device time."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        return None
    busy_us, cur_s, cur_e = 0.0, *spans[0]
    for a, z in spans[1:]:
        if a > cur_e:
            busy_us += cur_e - cur_s
            cur_s, cur_e = a, z
        else:
            cur_e = max(cur_e, z)
    busy_us += cur_e - cur_s
    avg = prof.key_averages()

    def top(dev, key):
        rows = sorted((e for e in avg if (e.device_type == DeviceType.CUDA)
                       == dev), key=lambda e: -getattr(e, key))[:5]
        return [(e.key[:60], round(getattr(e, key) / 1e3, 3), e.count)
                for e in rows]

    return dict(wall_ms=wall_ms, busy_ms=busy_us / 1e3,
                idle_share=1.0 - busy_us / 1e3 / wall_ms,
                device_events=len(spans),
                top_device=top(True, "self_device_time_total"),
                top_host=top(False, "self_cpu_time_total"))


def tb_process_state():
    """What earlier phases may leave behind: live threads, the caching
    allocator's allocated and reserved bytes, objects the collector
    tracks."""
    import threading
    names = sorted(t.name for t in threading.enumerate())
    return (f"{len(names)} threads {names}; allocated "
            f"{torch.cuda.memory_allocated()} reserved "
            f"{torch.cuda.memory_reserved()} bytes; "
            f"{len(gc.get_objects())} gc-tracked objects")


def tb_timing_line(rec, steps, wall, per_step=TB_B * TB_S,
                   unit="target tokens"):
    """Step ms and ``unit``/s of a fit (``per_step`` a step): every
    step's over the fit's wall (data, callbacks, the first steps and the
    profiled step included; the profiler's start, stop and reading left
    out), then the median step and period of the unprofiled steps after
    the first two, and the profiled step."""
    skip = {len(rec.losses) - 1}
    ms = [t for i, t in enumerate(rec.ms) if i >= 2 and i not in skip]
    per = [t for i, t in enumerate(rec.period_ms, start=1)
           if i >= 2 and i not in skip]
    step_ms, period_ms = float(np.median(ms)), float(np.median(per))
    prof = rec.profile
    wall -= rec.profile_cost_s
    text = (f"{steps * per_step / wall:.0f} {unit}/s over the fit's "
            f"wall ({steps} x {per_step} {unit} in {wall:.3f} s, "
            f"{rec.profile_cost_s:.3f} s of profiler start, stop and "
            f"reading left out); step "
            f"ms median {step_ms:.3f}, period ms median {period_ms:.3f} "
            f"(steps 3 on, the profiled step left out; steps "
            f"{[round(x, 2) for x in rec.ms]}, periods "
            f"{[round(x, 2) for x in rec.period_ms]}); ")
    if prof is None:
        text += "profiled step: no device time recorded (not measured)"
    else:
        text += (f"profiled last step (fetch included, profiler on): wall "
                 f"{prof['wall_ms']:.3f} ms, device busy "
                 f"{prof['busy_ms']:.3f} ms, idle share "
                 f"{prof['idle_share']:.3f} (against the median period: "
                 f"{1.0 - prof['busy_ms'] / period_ms:.3f}), "
                 f"{prof['device_events']} device events; top device "
                 f"{prof['top_device']}; top host {prof['top_host']}")
    return text


def tb_counts(tag, launches, steps, forwards, problems, backward=True,
              dropout=True):
    """Rows 1-3 launches and composite calls of one run: 12 attention
    forwards (6 encoder self, 6 decoder cross) and, in training, 12 of
    each backward kernel per step, all in the dropout forms in training;
    6 composite calls (the decoder's masked self-attention) a forward;
    no other flash form."""
    fwd = "flash_fwd_dropout" if dropout else "flash_fwd"
    want = {fwd: 2 * TB_LAYERS * forwards, COMPOSITE_KEY: TB_LAYERS * forwards}
    if backward:
        for key in ("flash_bwd_dq", "flash_bwd_dkv"):
            want[f"{key}_dropout" if dropout else key] = 2 * TB_LAYERS * steps
    for key in (*FLASH, *(f"{k}_dropout" for k in FLASH), COMPOSITE_KEY):
        if launches[key] != want.get(key, 0):
            problems.append(f"{tag}: {key} {launches[key]} != "
                            f"{want.get(key, 0)}")
    return {k: launches[k] for k in want}


def phase_train_transformer(smi):
    """The slice's main path: ``set_device('gpu')``, ``seed(1234)``,
    Transformer-base built from Paddle layers, ``Model.prepare(Adam
    (0.9, 0.98, 1e-9) on NoamDecay(512, 4000) from its peak, the smoothed
    cross-entropy, Accuracy())``, ``fit`` over 2 epochs of TB_STEPS
    batches inside ``auto_cast(dtype='bfloat16')``, then ``evaluate`` on
    TB_EVAL batches and ``predict`` on TB_PREDICT, then ``save`` and
    ``load`` into a fresh Model, whose evaluation must equal the saved
    one's.  Checks: finite losses, the mean of the last 5 below the mean
    of the first 5; rows 1-3 (dropout forms) 12 launches a step each and
    6 composite calls a forward in fit, the p = 0 forward 12 a forward in
    evaluate and predict; tokens/s over the fit's wall, step ms, one
    profiled step's device busy and idle share, and peak memory beside
    the card."""
    import shutil
    import paddle_tpu_torch as paddle
    paddle.set_device("gpu")
    paddle.seed(1234)
    problems = []
    m, sched = tb_model()
    n_params = sum(p.numel() for p in m.parameters())
    train = tb_data(TB_STEPS * TB_B, 1234)
    held = tb_data(TB_EVAL * TB_B, 1235)
    steps = 2 * TB_STEPS
    rec = tb_step_recorder(profile_step=steps - 1)
    log(f"[train-transformer] at the start: {tb_process_state()}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    with paddle.amp.auto_cast(dtype="bfloat16"):
        m.fit(train, batch_size=TB_B, epochs=2, shuffle=False, verbose=0,
              callbacks=[rec])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    fit_counts = tb_counts("fit", read_launches(), steps, steps, problems)
    total = read_launches()
    losses = rec.losses
    _TB_FIT_LOSSES[:] = losses
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    if len(losses) != steps or not np.all(np.isfinite(losses)) or \
            not last < first:
        problems.append(f"losses not finite and falling: {losses}")
    timing = tb_timing_line(rec, steps, wall)
    log(f"[train-transformer] {smi}: Transformer-base {n_params / 1e6:.2f} M "
        f"params f32, auto_cast bf16, {TB_B} x {TB_S} + {TB_B} x {TB_S} "
        f"tokens, Noam lr {sched.last_lr:.3e}: {steps} steps; losses "
        f"{[round(x, 4) for x in losses]} (first 5 mean {first:.4f}, last "
        f"5 {last:.4f}); {timing}; max_memory_allocated {peak} bytes; "
        f"launches {fit_counts}")
    zero_launches()
    with paddle.amp.auto_cast(dtype="bfloat16"):
        ev = m.evaluate(held, batch_size=TB_B, verbose=0)
    ev_counts = tb_counts("evaluate", read_launches(), 0, TB_EVAL, problems,
                          backward=False, dropout=False)
    add_launches(total, read_launches())
    zero_launches()
    with paddle.amp.auto_cast(dtype="bfloat16"):
        out = m.predict(tb_data(TB_PREDICT * TB_B, 1236), batch_size=TB_B)
    pr_counts = tb_counts("predict", read_launches(), 0, TB_PREDICT,
                          problems, backward=False, dropout=False)
    add_launches(total, read_launches())
    pred = out[0]
    if len(pred) != TB_PREDICT or pred[0].shape != (TB_B, TB_S, TB_VOCAB) \
            or not all(np.isfinite(x).all() for x in pred):
        problems.append(f"predict: {[x.shape for x in pred]}")
    ck_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "chip_smoke_transformer")
    t1 = time.perf_counter()
    m.save(os.path.join(ck_dir, "tb"))
    t_save = time.perf_counter() - t1
    fresh, _ = tb_model()
    t1 = time.perf_counter()
    fresh.load(os.path.join(ck_dir, "tb"))
    t_load = time.perf_counter() - t1
    zero_launches()
    with paddle.amp.auto_cast(dtype="bfloat16"):
        ev2 = fresh.evaluate(held, batch_size=TB_B, verbose=0)
    add_launches(total, read_launches())
    nbytes = sum(os.path.getsize(os.path.join(ck_dir, f))
                 for f in os.listdir(ck_dir))
    shutil.rmtree(ck_dir, ignore_errors=True)
    if ev2 != ev or not np.isfinite(ev["loss"]):
        problems.append(f"loaded model evaluates {ev2}, saved {ev}")
    log(f"[train-transformer] evaluate {TB_EVAL} batches: {ev} (launches "
        f"{ev_counts}); predict {TB_PREDICT} batches (launches {pr_counts}); "
        f"save {t_save:.2f} s, load {t_load:.2f} s, {nbytes} bytes "
        f"(.pdparams + .pdopt); the loaded model evaluates {ev2}")
    del m, fresh
    del_all()
    if problems:
        raise SystemExit("train-transformer failed: " + "; ".join(problems))
    log("[train-transformer] ok")
    return {"train-transformer": total}


def phase_train_transformer_trainer(smi):
    """The same network through ``prepare(strategy=...)`` with
    ``strategy.amp`` (the port's ``SpmdTrainer``: bf16 copies of the f32
    masters) for TB_TRAINER_STEPS steps: finite losses, rows 1-3's
    dropout forms 12 launches a step each, 6 composite calls a step;
    step ms, tokens/s and peak beside the card."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    paddle.seed(1234)
    strategy = DistributedStrategy()
    strategy.amp = True
    m, _ = tb_model(strategy)
    rec = tb_step_recorder(profile_step=TB_TRAINER_STEPS - 1)
    problems = []
    log(f"[train-transformer-trainer] at the start: {tb_process_state()}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    m.fit(tb_data(TB_TRAINER_STEPS * TB_B, 1234), batch_size=TB_B, epochs=1,
          shuffle=False, verbose=0, callbacks=[rec])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = read_launches()
    counts = tb_counts("trainer", launches, TB_TRAINER_STEPS,
                       TB_TRAINER_STEPS, problems)
    if not (m._trainer is not None and m._trainer.amp_enabled and
            m._trainer.amp_dtype == torch.bfloat16):
        problems.append("the trainer loop did not run bf16 AMP")
    losses = rec.losses
    if len(losses) != TB_TRAINER_STEPS or not np.all(np.isfinite(losses)):
        problems.append(f"losses {losses}")
    timing = tb_timing_line(rec, TB_TRAINER_STEPS, wall)
    log(f"[train-transformer-trainer] {smi}: Transformer-base through "
        f"SpmdTrainer (strategy.amp, bf16 copies): losses "
        f"{[round(x, 4) for x in losses]}; {timing}; "
        f"max_memory_allocated {peak} bytes; launches {counts}")
    del m
    del_all()
    if problems:
        raise SystemExit("train-transformer-trainer failed: "
                         + "; ".join(problems))
    log("[train-transformer-trainer] ok")
    return {"train-transformer-trainer": launches}


# ---------------------------------------------------------------------------
# The program path: Transformer-base through jit.to_static, jit.save and
# inference.load_predictor, served from C (libpd_inference.so), and Wide &
# Deep written in static mode (Program, Executor, save_inference_model)
# ---------------------------------------------------------------------------
# two epochs of 10 batches, as train-transformer's fit: over 10 fresh
# batches the loss of the eager fit rises too (10.5334 -> 10.5445 over
# train-transformer's first 10 steps)
JIT_STEPS, JIT_BATCHES = 20, 10
# the static program's logits against the eager layer's, and the loaded
# predictor's against the eager layer's: within this share of each row's
# max |logit| (the same kernels on the same bf16 casts; the capture may
# order an f32 sum differently)
TOL_JIT = 1e-2
# the CPU replay of the static Wide & Deep program against the card's run:
# each parameter within this share of its max |value| after 3 steps (f32
# Adam; the card's matmuls take TF32-free f32, sums in another order)
TOL_STATIC_REPLAY = 1e-4
# save_inference_model's program against clone(for_test=True) on the card
TOL_STATIC_INFER = 1e-6
_JIT_SAVED = []
# train-transformer's fit losses, which the to_static loop meets again
_TB_FIT_LOSSES = []
# the to_static losses against those fit losses, absolute: the same
# program on the same batches, weights and dropout bits (the gap read 0
# on the card); the bound leaves room for a reordered atomic sum only
TOL_JIT_FIT = 1e-4


def row_scale_error(got, ref):
    """max over rows of max|got - ref| / max|ref| (rows: the last dim)."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs().amax(-1)
    scale = ref.abs().amax(-1).clamp_min(1e-30)
    return float((err / scale).max())


def jit_counts(tag, launches, want, problems):
    """Rows 1-3 (both forms) against ``want``; other forms 0."""
    keys = (*FLASH, *(f"{k}_dropout" for k in FLASH))
    for key in keys:
        if launches[key] != want.get(key, 0):
            problems.append(f"{tag}: {key} {launches[key]} != "
                            f"{want.get(key, 0)}")
    return {k: launches[k] for k in keys if launches[k]}


def graph_targets(module):
    """The call targets of a captured program's graph, as text."""
    return {str(n.target) for n in module.graph.nodes
            if n.op == "call_function"}


def phase_jit_transformer(smi):
    """jit-transformer: Transformer-base (``tb_network``, seed 1234)
    through ``paddle.jit.to_static`` for JIT_STEPS training steps
    (JIT_BATCHES batches twice, as train-transformer's fit) under
    ``auto_cast(dtype='bfloat16')`` with the Adam + Noam of ``tb_model``:
    finite losses, the last 5's mean below the first 5's, each within
    TOL_JIT_FIT of train-transformer's fit loss (that phase runs first);
    rows 1-3 in their dropout forms 12
    launches a step each; one capture per key; the captured graph calls the
    ``paddle_tpu::flash_fwd`` op and no library attention; an eval forward
    static against eager within TOL_JIT of each row's logit scale.  Then
    ``jit.save`` with ``InputSpec([None, 256], 'int64')`` twice (f32
    weights, the bf16 casts captured in the program) and
    ``inference.load_predictor`` on the card: B = 16 and B = 1 against
    the eager eval forward within TOL_JIT, row 1 12 launches a call and
    rows 2-3 none; ms a batch."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.static import InputSpec
    t_phase = time.perf_counter()
    problems = []
    paddle.set_device("gpu")
    paddle.seed(1234)
    net = tb_network()
    sched = paddle.optimizer.lr.NoamDecay(d_model=512, warmup_steps=4000,
                                          last_epoch=3999)
    opt = paddle.optimizer.Adam(learning_rate=sched, beta1=0.9, beta2=0.98,
                                epsilon=1e-9, parameters=net.parameters())
    loss_fn = tb_loss()
    static_net = paddle.jit.to_static(net)
    data = tb_data(JIT_BATCHES * TB_B, 1234)
    src_all, tgt_all, lab_all = (torch.as_tensor(a) for a in data.tensors)
    losses, step_ms = [], []
    torch.cuda.synchronize()
    zero_launches()
    for step in range(JIT_STEPS):
        sl = slice(step % JIT_BATCHES * TB_B,
                   (step % JIT_BATCHES + 1) * TB_B)
        src, tgt, lab = (t[sl].cuda() for t in (src_all, tgt_all, lab_all))
        t0 = time.perf_counter()
        with paddle.amp.auto_cast(dtype="bfloat16"):
            loss = loss_fn(static_net(src, tgt), lab)
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        losses.append(float(loss))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    train_counts = jit_counts("to_static training", read_launches(), {
        f"{k}_dropout": 2 * TB_LAYERS * JIT_STEPS for k in FLASH}, problems)
    total = read_launches()
    COST["tb"] = tb_capture_cost(static_net, loss_fn, src, tgt, lab)
    opt.clear_grad()
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    if not (np.all(np.isfinite(losses)) and last < first):
        problems.append(f"losses not finite and falling: {losses}")
    if len(_TB_FIT_LOSSES) != len(losses):
        raise RuntimeError(f"jit-transformer compares with train-transformer's"
                           f" {len(losses)} fit losses; that phase left "
                           f"{len(_TB_FIT_LOSSES)} (run it first)")
    fit_gap = max(abs(a - b) for a, b in zip(losses, _TB_FIT_LOSSES))
    if not fit_gap <= TOL_JIT_FIT:
        problems.append(f"to_static losses vs the eager fit's: max gap "
                        f"{fit_gap:.3e} > {TOL_JIT_FIT}")
    vs_fit = (f"; max |loss - train-transformer's eager fit loss| "
              f"{fit_gap:.3e} (tol {TOL_JIT_FIT})")
    train_captures = static_net.captures
    if train_captures != 1:
        problems.append(f"{train_captures} captures for one key")
    graph = graph_targets(next(iter(static_net._cache.values())))
    if not any("paddle_tpu.flash_fwd" in t for t in graph) or \
            any("scaled_dot_product" in t or "flash_attention" in t
                for t in graph):
        problems.append(f"captured graph attention ops: "
                        f"{sorted(t for t in graph if 'attention' in t or 'flash' in t)}")
    # the dropout bits are ops of the captured graph: two calls differ
    with torch.no_grad(), paddle.amp.auto_cast(dtype="bfloat16"):
        a = static_net(src_all[:TB_B].cuda(), tgt_all[:TB_B].cuda())
        b = static_net(src_all[:TB_B].cuda(), tgt_all[:TB_B].cuda())
    fresh = not torch.equal(a, b)
    if not fresh:
        problems.append("two training-mode calls drew the same dropout bits")
    del a, b
    # eval: static against eager on the same weights
    net.eval()
    src, tgt = src_all[:TB_B].cuda(), tgt_all[:TB_B].cuda()
    zero_launches()
    with torch.no_grad(), paddle.amp.auto_cast(dtype="bfloat16"):
        got = static_net(src, tgt)
        want = net(src, tgt)
    eval_counts = jit_counts("eval forwards", read_launches(),
                             {"flash_fwd": 2 * 2 * TB_LAYERS}, problems)
    add_launches(total, read_launches())
    eval_err = row_scale_error(got, want)
    if not eval_err <= TOL_JIT:
        problems.append(f"eval static vs eager {eval_err:.3e}")
    if static_net.captures != 2:
        problems.append(f"{static_net.captures} captures for two keys")
    log(f"[jit-transformer] {smi}: Transformer-base through to_static, "
        f"auto_cast bf16, {TB_B} x {TB_S} + {TB_B} x {TB_S} tokens, "
        f"{JIT_STEPS} steps ({JIT_BATCHES} batches twice): losses "
        f"{[round(x, 4) for x in losses]} (first 5 mean {first:.4f}, last 5 "
        f"{last:.4f}{vs_fit}); step ms "
        f"median {float(np.median(step_ms[2:])):.3f} (steps 3 on; first "
        f"{step_ms[0]:.1f} with the capture); captures {train_captures} "
        f"(train) + {static_net.captures - train_captures} (eval); launches "
        f"{train_counts} (12 a step each); two training-mode calls draw "
        f"other dropout bits: {fresh}; eval static vs eager max row "
        f"error {eval_err:.3e} (tol {TOL_JIT}), launches {eval_counts}")
    # save and load
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_jit", "tb")
    t0 = time.perf_counter()
    with paddle.amp.auto_cast(dtype="bfloat16"):
        paddle.jit.save(net, path, input_spec=[InputSpec([None, TB_S],
                                                         "int64")] * 2)
    t_save = time.perf_counter() - t0
    nbytes = {ext: os.path.getsize(path + ext)
              for ext in (".pdmodel", ".pdiparams")}
    t0 = time.perf_counter()
    pred = paddle.inference.load_predictor(path)
    t_load = time.perf_counter() - t0
    loaded_graph = graph_targets(pred._exported)
    if not any("paddle_tpu.flash_fwd" in t for t in loaded_graph) or \
            any("scaled_dot_product" in t for t in loaded_graph):
        problems.append(f"loaded program's attention ops: "
                        f"{sorted(t for t in loaded_graph if 'attention' in t or 'flash' in t)}")
    errs = {}
    for b in (TB_B, 1):
        zero_launches()
        out = pred(src[:b], tgt[:b])
        counts = jit_counts(f"predictor B={b}", read_launches(),
                            {"flash_fwd": 2 * TB_LAYERS}, problems)
        add_launches(total, read_launches())
        with torch.no_grad(), paddle.amp.auto_cast(dtype="bfloat16"):
            ref = net(src[:b], tgt[:b])
        errs[b] = row_scale_error(out, ref)
        if tuple(out.shape) != (b, TB_S, TB_VOCAB) or \
                not bool(torch.isfinite(out.float()).all()) or \
                not errs[b] <= TOL_JIT:
            problems.append(f"predictor B={b}: shape {tuple(out.shape)}, "
                            f"error {errs[b]:.3e}")
    pred(src, tgt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        pred(src, tgt)
    torch.cuda.synchronize()
    pred_ms = (time.perf_counter() - t0) / 5 * 1e3
    log(f"[jit-transformer] jit.save (eval, the bf16 casts captured in the "
        f"program, f32 weights) {t_save:.2f} s, {nbytes} bytes; "
        f"load_predictor on the card {t_load:.2f} s; predictor vs eager max "
        f"row error {errs} (tol {TOL_JIT}); row 1 {counts} a call; "
        f"{pred_ms:.3f} ms a batch of {TB_B} x {TB_S} (host clock, 5 calls)")
    _JIT_SAVED[:] = [path, pred, src.cpu(), tgt.cpu()]
    del net, opt, static_net, got, want
    del_all()
    log(f"[jit-transformer] the phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    finish("jit-transformer", problems)
    return {"jit-transformer": total}


def phase_capi(smi):
    """capi: ``libpd_inference.so`` built with ``cc``; ``PD_NewPredictor``
    / ``PD_PredictorRun`` through ctypes on jit-transformer's artifact at
    B = 16 equal bitwise to ``load_predictor``'s output (row 1 12 more
    launches); the standalone ``pd_capi_demo`` binary as a subprocess:
    exit 0 and its output's checksum equal to Python's; ``PD_NewTrainer``
    on this inference artifact NULL with ``PD_GetLastError`` naming the
    missing ``.pdtrain`` (c-trainer steps a train program).  Where this
    machine lacks Python.h or a shared libpython the phase drives
    ``capi_bridge`` (what the shim calls) instead and says why."""
    import ctypes
    from paddle_tpu_torch.inference import capi_bridge
    from paddle_tpu_torch.inference.capi import build as capi_build
    t_phase = time.perf_counter()
    problems = []
    path, pred, src, tgt = _JIT_SAVED
    src, tgt = src.cuda(), tgt.cuda()
    inc, libdir, ver, ok = capi_build.embed_inputs()
    log(f"[capi] build inputs: Python.h under {inc}, libpython{ver} shared "
        f"under {libdir}: {ok}")
    zero_launches()
    want = pred(src, tgt)
    add_total = read_launches()
    want_bytes = capi_bridge._host(want).tobytes()
    if not ok:
        log("[capi] this machine lacks Python.h or a shared libpython: the "
            "shim cannot be built here, so the phase drives capi_bridge's "
            "create / run / destroy (what the shim calls)")
        h = capi_bridge.create(path)
        zero_launches()
        out = capi_bridge.run(h, [(capi_bridge._host(t).tobytes(),
                                   tuple(t.shape), "int64")
                                  for t in (src, tgt)])
        launches = read_launches()
        capi_bridge.destroy(h)
        if out[0][0] != want_bytes:
            problems.append("capi_bridge.run differs from load_predictor")
        jit_counts("capi_bridge", launches, {"flash_fwd": 2 * TB_LAYERS},
                   problems)
        finish("capi", problems)
        return {"capi": launches}
    t0 = time.perf_counter()
    lib_path = capi_build.build_library()
    exe = capi_build.build_demo()
    t_build = time.perf_counter() - t0

    class PDTensor(ctypes.Structure):
        _fields_ = [("data", ctypes.c_void_p),
                    ("shape", ctypes.c_int64 * 8),
                    ("ndim", ctypes.c_int32),
                    ("dtype", ctypes.c_char * 16)]

    lib = ctypes.CDLL(lib_path)
    lib.PD_NewPredictor.restype = ctypes.c_void_p
    lib.PD_NewPredictor.argtypes = [ctypes.c_char_p]
    lib.PD_NewTrainer.restype = ctypes.c_void_p
    lib.PD_NewTrainer.argtypes = [ctypes.c_char_p]
    lib.PD_PredictorRun.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(PDTensor), ctypes.c_int32,
        ctypes.POINTER(ctypes.POINTER(PDTensor)),
        ctypes.POINTER(ctypes.c_int32)]
    lib.PD_GetLastError.restype = ctypes.c_char_p
    lib.PD_DeletePredictor.argtypes = [ctypes.c_void_p]
    handle = lib.PD_NewPredictor(path.encode())
    if not handle:
        raise SystemExit(f"capi: PD_NewPredictor failed: "
                         f"{lib.PD_GetLastError()}")
    host = [np.ascontiguousarray(t.cpu().numpy()) for t in (src, tgt)]
    ins = (PDTensor * 2)()
    for t, a in zip(ins, host):
        t.data = a.ctypes.data_as(ctypes.c_void_p)
        t.ndim = 2
        t.shape[0], t.shape[1] = a.shape
        t.dtype = b"int64"
    outs = ctypes.POINTER(PDTensor)()
    n_outs = ctypes.c_int32()
    zero_launches()
    t0 = time.perf_counter()
    rc = lib.PD_PredictorRun(handle, ins, 2, ctypes.byref(outs),
                             ctypes.byref(n_outs))
    t_run = time.perf_counter() - t0
    launches = read_launches()
    if rc != 0:
        raise SystemExit(f"capi: PD_PredictorRun failed: "
                         f"{lib.PD_GetLastError()}")
    o = outs[0]
    shape = tuple(o.shape[i] for i in range(o.ndim))
    got = ctypes.string_at(o.data, int(np.prod(shape)) * 4)
    bitwise = got == want_bytes
    if not bitwise or shape != (TB_B, TB_S, TB_VOCAB):
        problems.append(f"PD_PredictorRun {shape} differs from "
                        f"load_predictor's output (bitwise {bitwise})")
    c_counts = jit_counts("PD_PredictorRun", launches,
                          {"flash_fwd": 2 * TB_LAYERS}, problems)
    lib.PD_TensorsFree(outs, n_outs)
    lib.PD_DeletePredictor(handle)
    # an inference artifact is no train program: the trainer entry
    # says which file it lacks
    trainer = lib.PD_NewTrainer(path.encode())
    err = lib.PD_GetLastError().decode()
    if trainer or ".pdtrain" not in err:
        problems.append(f"PD_NewTrainer: handle {trainer}, error {err!r}")
    # the standalone binary on the ramp inputs
    ramp = torch.arange(TB_B * TB_S).reshape(TB_B, TB_S) % 1000 + 4
    want_hash = capi_bridge.checksum(capi_bridge._host(pred(ramp, ramp))
                                     .tobytes())
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__))] +
        [p for p in sys.path if p])
    t0 = time.perf_counter()
    proc = subprocess.run([exe, path, "int64", f"{TB_B}x{TB_S}", "int64",
                           f"{TB_B}x{TB_S}"], env=env, capture_output=True,
                          text=True, timeout=300)
    t_demo = time.perf_counter() - t0
    line = next((ln for ln in proc.stdout.splitlines()
                 if ln.startswith("OUT 0")), "")
    demo_hash = int(line.split("checksum=")[1].split(":")[0]) if line \
        else None
    if proc.returncode != 0 or "CAPI-DEMO-OK" not in proc.stdout or \
            demo_hash != want_hash:
        problems.append(f"pd_capi_demo rc {proc.returncode}, hash "
                        f"{demo_hash} vs {want_hash}: {proc.stdout[-400:]} "
                        f"{proc.stderr[-800:]}")
    log(f"[capi] {smi}: libpd_inference.so and pd_capi_demo built in "
        f"{t_build:.2f} s; PD_PredictorRun at B={TB_B}: bitwise equal to "
        f"load_predictor {bitwise}, {t_run * 1e3:.3f} ms (host clock, "
        f"marshalling included), launches {c_counts}; PD_NewTrainer on the "
        f"inference artifact NULL: {not trainer}, PD_GetLastError {err!r}; "
        f"pd_capi_demo exit "
        f"{proc.returncode} in {t_demo:.1f} s (cold start), checksum "
        f"{demo_hash} == Python's {want_hash}: {demo_hash == want_hash}")
    _JIT_SAVED.clear()
    del pred
    del_all()
    log(f"[capi] the phase took {time.perf_counter() - t_phase:.1f} s")
    finish("capi", problems)
    add_launches(launches, add_total)
    return {"capi": launches}


def static_ctr_program(device):
    """Wide & Deep written in static mode (``static.data``,
    ``static.nn.sparse_embedding``, ``static.nn.fc``, ``Adam(CTR_LR)
    .minimize``) in a fresh Program on ``device``; returns ``(main,
    feeds, predict, loss)``."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import static
    from paddle_tpu_torch.nn import functional as F
    paddle.set_device(device)
    paddle.seed(1234)
    main = static.Program()
    with static.program_guard(main):
        dense = static.data("dense", [None, CTR_DENSE], "float32")
        sparse = static.data("sparse", [None, CTR_SLOTS], "int64")
        label = static.data("label", [None, 1], "float32")
        emb = static.nn.sparse_embedding(sparse, [CTR_VOCAB, CTR_EMB])
        deep = paddle.concat([paddle.reshape(emb, [-1, CTR_SLOTS * CTR_EMB]),
                              dense], axis=1)
        for size in CTR_FC:
            deep = static.nn.fc(deep, size, activation="relu")
        logit = static.nn.fc(deep, 1) + static.nn.fc(dense, 1)
        predict = F.sigmoid(logit)
        loss = paddle.mean(F.binary_cross_entropy_with_logits(logit, label))
        paddle.optimizer.Adam(learning_rate=CTR_LR).minimize(loss)
    return main, (dense, sparse), predict, loss


def phase_static_ctr(smi):
    """static-ctr: Wide & Deep (CTR_* widths) in static mode on the card,
    CTR_STEPS ``Executor.run`` steps on train-ctr's ``InMemoryDataset``
    batches: the last 10 losses' mean below the first 10's; after 3 steps
    every parameter against a CPU replay of the same program from the same
    start within TOL_STATIC_REPLAY of its scale; step ms and examples/s;
    ``save_inference_model(['dense', 'sparse'], [predict])`` ->
    ``load_inference_model`` -> ``Executor.run`` on the card against
    ``main.clone(for_test=True)`` within TOL_STATIC_INFER; rows 1-11 launch
    0 times."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import static
    t_phase = time.perf_counter()
    problems = []
    batches = ctr_batches(CTR_STEPS)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_static")
    paddle.enable_static()
    try:
        main, feeds, predict, loss = static_ctr_program("gpu")
        static.save(main, os.path.join(root, "start"))
        exe = static.Executor()
        losses, step_ms = [], []
        torch.cuda.synchronize()
        zero_launches()
        wall0 = time.perf_counter()
        for i, (ids, dense, label) in enumerate(batches):
            t0 = time.perf_counter()
            (lv,) = exe.run(main, feed={"dense": dense, "sparse": ids,
                                        "label": label},
                            fetch_list=[loss], return_numpy=False)
            losses.append(float(lv))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if i == 2:
                static.save(main, os.path.join(root, "step3"))
                wall0 += time.perf_counter() - t0 - step_ms[-1] / 1e3
        wall = time.perf_counter() - wall0
        launches = read_launches()
        rn_zero_counts("static-ctr", launches, problems)
        first, last = float(np.mean(losses[:10])), \
            float(np.mean(losses[-10:]))
        if not (all(np.isfinite(losses)) and last < first):
            problems.append(f"losses not finite and falling: first 10 "
                            f"{first:.4f}, last 10 {last:.4f}")
        # inference: the test clone against the saved and loaded program
        test_prog = main.clone(for_test=True)
        ids, dense, _ = batches[0]
        (want,) = exe.run(test_prog, feed={"dense": dense, "sparse": ids},
                          fetch_list=[predict], return_numpy=False)
        t0 = time.perf_counter()
        static.save_inference_model(os.path.join(root, "infer"), list(feeds),
                                    [predict], exe)
        t_save = time.perf_counter() - t0
        prog, names, n_out = static.load_inference_model(
            os.path.join(root, "infer"))
        (got,) = exe.run(prog, feed={"dense": dense, "sparse": ids},
                         return_numpy=False)
        infer_err = float((got - want).abs().max() /
                          want.abs().max().clamp_min(1e-30))
        if not infer_err <= TOL_STATIC_INFER or names != ["dense", "sparse"]:
            problems.append(f"loaded inference program {names}: "
                            f"{infer_err:.3e}")
        del main, exe, test_prog, prog
        del_all()
        # the CPU replay of the first 3 steps from the same start
        cpu_main, _, _, cpu_loss = static_ctr_program("cpu")
        static.load(cpu_main, os.path.join(root, "start"))
        cpu_exe = static.Executor(static.CPUPlace())
        for ids, dense, label in batches[:3]:
            cpu_exe.run(cpu_main, feed={"dense": dense, "sparse": ids,
                                        "label": label},
                        fetch_list=[cpu_loss])
        static.save(cpu_main, os.path.join(root, "cpu3"))
        card = static.load_program_state(os.path.join(root, "step3"))
        cpu = static.load_program_state(os.path.join(root, "cpu3"))
        replay = {k: float(np.abs(card[k] - cpu[k]).max() /
                           max(np.abs(cpu[k]).max(), 1e-30)) for k in cpu}
        worst = max(replay.values())
        if not worst <= TOL_STATIC_REPLAY or set(card) != set(cpu):
            problems.append(f"CPU replay: worst {worst:.3e}")
        del cpu_main, cpu_exe
    finally:
        paddle.disable_static()
        paddle.set_device("gpu")
    import shutil
    shutil.rmtree(root, ignore_errors=True)
    log(f"[static-ctr] {smi}: Wide & Deep in static mode ({CTR_VOCAB} x "
        f"{CTR_EMB} sparse_embedding over {CTR_SLOTS} slots, fc "
        f"{' -> '.join(map(str, CTR_FC))} -> 1 + wide fc({CTR_DENSE}, 1), "
        f"B={CTR_BATCH}, Adam {CTR_LR}), {CTR_STEPS} Executor.run steps: "
        f"loss first 10 {first:.4f}, last 10 {last:.4f}; step ms median "
        f"{float(np.median(step_ms)):.3f} (first {step_ms[0]:.1f}); "
        f"examples/s over the loop's wall {CTR_STEPS * CTR_BATCH / wall:.0f}; "
        f"3 steps against the CPU replay, worst max|diff| / max|cpu| "
        f"{worst:.3e} (tol {TOL_STATIC_REPLAY}) over {len(replay)} "
        f"parameters; save_inference_model {t_save:.2f} s, the loaded "
        f"program vs clone(for_test=True) {infer_err:.3e} (tol "
        f"{TOL_STATIC_INFER}); the phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    finish("static-ctr", problems)
    return {"static-ctr": launches}


# ---------------------------------------------------------------------------
# ResNet-50 through the layer API (BASELINE.json config 2; He et al.
# 2016: ImageNet at 224 x 224, 1000 classes, SGD with momentum 0.9,
# learning rate 0.1, weight decay 1e-4), one card's share of a batch:
# 128 images of FakeData (class prototypes plus noise, seed 1234)
# ---------------------------------------------------------------------------
RN_B, RN_SIDE, RN_CLASSES = 128, 224, 1000
RN_STEPS, RN_EVAL, RN_PREDICT, RN_TRAINER_STEPS = 10, 2, 1, 5
# H100 SXM's dense bf16 tensor-core peak (the MFU's denominator)
RN_PEAK_FLOPS = 989e12
# the trainer's first step against the eager loop's on the same weights
# and batch: bf16 copies in both, the batch norms' f32 statistics read
# activations that round to bf16 at other points (the eager loop keeps
# f32 from each norm to the next convolution and along the residual
# stream), so each running buffer agrees within bf16 steps of its scale
# (``rn_scale``)
TOL_RN_STATS = 5e-2
_RN_DATA = []
# ResNet-50's feed: DataLoader fork workers over shared-memory rings.  One
# batch is 128 x 3 x 224 x 224 f32 = 77 070 336 bytes plus its labels, and a
# ring takes frames up to half its capacity (the default 32 MiB raises), so
# each worker's ring holds 160 MiB
RN_RING = 160 << 20
RN_LOADER_TIMEOUT = 120  # s one pop may wait
# the workers check: RN_CHECK_BATCHES batches of RN_CHECK_B images over two
# workers, so worker 1 makes two batches and a kill after its first leaves
# the second to a restart (with two batches it would push its only batch
# and die with nothing left to lose)
RN_CHECK_B, RN_CHECK_BATCHES = 32, 4
_RN_WORKERS = []


def rn_data():
    """One FakeData (train, evaluate, predict batches one after another)
    built once: its 1000 class prototypes take 0.6 GB and seconds of
    host time."""
    if not _RN_DATA:
        from paddle_tpu_torch.vision.datasets import FakeData
        _RN_DATA.append(FakeData(
            size=(RN_STEPS + RN_EVAL + RN_PREDICT) * RN_B,
            image_shape=(3, RN_SIDE, RN_SIDE), num_classes=RN_CLASSES,
            seed=1234))
    return _RN_DATA[0]


def rn_split(start, batches):
    from paddle_tpu_torch.io import Subset
    return Subset(rn_data(), range(start * RN_B, (start + batches) * RN_B))


def rn_workers(smi):
    """The workers feeding ResNet-50: min(10, cores - 2), fewer where
    /dev/shm cannot hold that many rings.  Fails where the ring's library
    does not build, fork is missing or /dev/shm holds fewer than two rings:
    the phases must not fall back to threads or to this process."""
    if not _RN_WORKERS:
        import multiprocessing as mp
        import shutil
        from paddle_tpu_torch.io.shm_ring import ShmRing, available
        cores = len(os.sched_getaffinity(0))
        shm = shutil.disk_usage("/dev/shm")
        if not available():
            raise SystemExit("workers: the shared-memory ring's library did "
                             "not build (no C compiler?)")
        if "fork" not in mp.get_all_start_methods():
            raise SystemExit("workers: no fork start method")
        ring = ShmRing.needed(RN_RING)
        w = min(10, cores - 2, shm.free // ring)
        log(f"[workers] {smi}: {cores} cores (os.sched_getaffinity), "
            f"/dev/shm total {shm.total} free {shm.free} bytes, a ring "
            f"{ring} bytes: W = {w} (min(10, cores - 2) = "
            f"{min(10, cores - 2)}, /dev/shm holds {shm.free // ring})")
        if w < 2:
            raise SystemExit(f"workers: W = {w}: /dev/shm ({shm.free} bytes "
                             f"free) or the cores ({cores}) are too few")
        _RN_WORKERS.append(w)
    return _RN_WORKERS[0]


def rn_loader(start, batches, workers):
    """``DataLoader`` over ``rn_split(start, batches)`` on ``workers`` fork
    workers."""
    from paddle_tpu_torch.io import DataLoader
    return DataLoader(rn_split(start, batches), batch_size=RN_B,
                      num_workers=workers, shm_ring_capacity=RN_RING,
                      timeout=RN_LOADER_TIMEOUT)


def rn_feed_recorder(loader):
    """A callback keeping the loader's ``worker_stats`` of every epoch."""
    from paddle_tpu_torch.hapi import callbacks

    class Feed(callbacks.Callback):
        def __init__(self):
            super().__init__()
            self.epochs = []

        def on_epoch_end(self, epoch, logs=None):
            self.epochs.append(loader.worker_stats)

    return Feed()


def rn_feed_check(tag, feed, workers, epochs, batches, problems):
    """Each epoch forked ``workers`` workers and popped ``batches`` frames
    from ``min(workers, batches)`` of them, with no restart; -> the
    timing line (fork ms a worker, the consumer's pop and unpickle ms and
    the host ms of the move to the card a batch)."""
    for i, st in enumerate(feed.epochs):
        if not (st.get("mode") == "processes" and st["workers"] == workers
                and len(st["producers"]) == min(workers, batches)
                and len(set(st["pids"])) == workers
                and os.getpid() not in st["pids"]
                and st["popped"] == batches and st["restarts"] == 0):
            brief = {k: v for k, v in st.items()
                     if k not in ("pop_ms", "unpickle_ms", "h2d_ms")}
            problems.append(f"{tag}: epoch {i}'s feed did not run on "
                            f"{workers} fork workers: {brief}")
    if len(feed.epochs) != epochs:
        problems.append(f"{tag}: {len(feed.epochs)} epochs recorded")
    if problems:
        return ""
    fork = [x for st in feed.epochs for x in st["fork_ms"]]
    # the first pop of an epoch waits for the workers' first batches
    pop = [x for st in feed.epochs for x in st["pop_ms"][1:]]
    first = [round(st["pop_ms"][0], 1) for st in feed.epochs]
    unpk = [x for st in feed.epochs for x in st["unpickle_ms"]]
    h2d = [x for st in feed.epochs for x in st["h2d_ms"]]
    return (f"feed: {workers} fork workers an epoch, "
            f"{sum(st['popped'] for st in feed.epochs)} frames popped; fork "
            f"ms a worker median {np.median(fork):.2f} max {max(fork):.2f}; "
            f"the consumer a batch: pop ms median {np.median(pop):.2f} (the "
            f"first pop of each epoch {first}), unpickle ms median "
            f"{np.median(unpk):.2f}, H2D ms (host, pageable) median "
            f"{np.median(h2d):.2f}")


def rn_model(strategy=None):
    import paddle_tpu_torch as paddle
    net = paddle.vision.models.resnet50(num_classes=RN_CLASSES)
    opt = paddle.optimizer.Momentum(
        learning_rate=0.1, momentum=0.9, parameters=net.parameters(),
        weight_decay=paddle.regularizer.L2Decay(1e-4))
    m = paddle.Model(net)
    m.prepare(opt, paddle.nn.CrossEntropyLoss(),
              paddle.metric.Accuracy(topk=(1, 5)), strategy=strategy)
    return m


def rn_stats(net):
    """The batch norms' running buffers (copies)."""
    return {n: b.detach().clone() for n, b in net.named_buffers()
            if n.endswith(("_mean", "_variance"))}


def rn_stats_moved(tag, before, after, problems):
    """Every running buffer finite, and every one changed."""
    bad = [n for n, b in after.items() if not torch.isfinite(b).all()]
    still = [n for n, b in after.items() if torch.equal(b, before[n])]
    if bad or still or len(after) != 106:
        problems.append(f"{tag}: {len(after)} running buffers, non-finite "
                        f"{bad[:4]}, unmoved {still[:4]}")


def rn_scale(stats, name):
    """A running buffer's scale: its largest variance, or for a mean
    (a cancelling sum near 0) the square root of its layer's."""
    var = stats[name.replace("_mean", "_variance")].max()
    return float(var if name.endswith("_variance") else var.sqrt())


def rn_zero_counts(tag, launches, problems):
    moved = {k: n for k, n in launches.items() if n}
    if moved:
        problems.append(f"{tag}: kernel launches or composite calls {moved}")


def rn_timing_line(rec, steps, wall, flops):
    """``tb_timing_line`` in images, after images/s over the median
    step and the MFU of both rates."""
    skip = {len(rec.losses) - 1}
    ms = float(np.median([t for i, t in enumerate(rec.ms)
                          if i >= 2 and i not in skip]))
    wall_ips = steps * RN_B / (wall - rec.profile_cost_s)
    step_ips = RN_B / ms * 1e3
    mfu = [3 * flops * ips / RN_PEAK_FLOPS for ips in (wall_ips, step_ips)]
    return (f"{step_ips:.1f} images/s over the median step (MFU "
            f"{mfu[1]:.4f}; over the fit's wall {mfu[0]:.4f}; MFU = 3 x "
            f"{flops} flops an image x images/s / {RN_PEAK_FLOPS:.0f}); "
            + tb_timing_line(rec, steps, wall, RN_B, "images"))


def phase_train_resnet(smi):
    """The vision slice's main path: ``set_device('gpu')``,
    ``seed(1234)``, ``vision.models.resnet50()``, ``Model.prepare(
    Momentum(0.1, 0.9, weight_decay=L2Decay(1e-4)), CrossEntropyLoss(),
    Accuracy(topk=(1, 5)))``, ``fit`` over 2 epochs of RN_STEPS batches
    of RN_B FakeData images inside ``auto_cast(dtype='bfloat16')``, then
    ``evaluate`` on RN_EVAL batches and ``predict`` on RN_PREDICT (eval
    mode: the running statistics), ``Model.summary`` and ``flops`` at one
    224 x 224 image, ``save`` / ``load`` into a fresh Model, whose
    evaluation must equal the saved one's.  Checks: finite losses, the
    mean of the last 5 below the first 5's; every running buffer finite
    and moved; no kernel launch and no attention-composite call; images/s,
    step ms, MFU, one profiled step's device busy ms and idle share and
    the peak beside the card."""
    import io
    import shutil
    import paddle_tpu_torch as paddle
    paddle.set_device("gpu")
    paddle.seed(1234)
    problems = []
    t_data = time.perf_counter()
    rn_data()
    t_data = time.perf_counter() - t_data
    m = rn_model()
    n_params = sum(p.numel() for p in m.parameters())
    flops = paddle.flops(m.network, [1, 3, RN_SIDE, RN_SIDE])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summ = m.summary((1, 3, RN_SIDE, RN_SIDE))
    rows = buf.getvalue().count("\n")
    if summ["total_params"] != n_params or summ["trainable_params"] != n_params:
        problems.append(f"summary {summ} against {n_params} parameters")
    steps = 2 * RN_STEPS
    rec = tb_step_recorder(profile_step=steps - 1)
    before = rn_stats(m.network)
    workers = rn_workers(smi)
    loader = rn_loader(0, RN_STEPS, workers)
    feed = rn_feed_recorder(loader)
    log(f"[train-resnet] at the start: {tb_process_state()}; FakeData "
        f"{len(rn_data())} images built in {t_data:.2f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    with paddle.amp.auto_cast(dtype="bfloat16"):
        m.fit(loader, batch_size=RN_B, epochs=2, shuffle=False, verbose=0,
              callbacks=[rec, feed])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    total = read_launches()
    rn_zero_counts("fit", total, problems)
    feed_line = rn_feed_check("fit", feed, workers, 2, RN_STEPS, problems)
    rn_stats_moved("fit", before, rn_stats(m.network), problems)
    losses = rec.losses
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    if len(losses) != steps or not np.all(np.isfinite(losses)) or \
            not last < first:
        problems.append(f"losses not finite and falling: {losses}")
    log(f"[train-resnet] {smi}: ResNet-50 {n_params / 1e6:.2f} M params f32 "
        f"(summary: {summ}, {rows} lines), {flops} flops a 224 x 224 image "
        f"(port's flops), auto_cast bf16, {RN_B} images of 3 x {RN_SIDE} x "
        f"{RN_SIDE}: {steps} steps; losses {[round(x, 4) for x in losses]} "
        f"(first 5 mean {first:.4f}, last 5 {last:.4f}); "
        f"{rn_timing_line(rec, steps, wall, flops)}; {feed_line}; "
        f"max_memory_allocated {peak} bytes; kernel launches and composite "
        f"calls all 0: {not any(total.values())}")
    zero_launches()
    with paddle.amp.auto_cast(dtype="bfloat16"):
        ev = m.evaluate(rn_split(RN_STEPS, RN_EVAL), batch_size=RN_B,
                        verbose=0)
        out = m.predict(rn_split(RN_STEPS + RN_EVAL, RN_PREDICT),
                        batch_size=RN_B)
    launches = read_launches()
    rn_zero_counts("evaluate and predict", launches, problems)
    add_launches(total, launches)
    pred = out[0]
    if len(pred) != RN_PREDICT or pred[0].shape != (RN_B, RN_CLASSES) or \
            not all(np.isfinite(x).all() for x in pred):
        problems.append(f"predict: {[x.shape for x in pred]}")
    ck_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "chip_smoke_resnet")
    t1 = time.perf_counter()
    m.save(os.path.join(ck_dir, "rn"))
    t_save = time.perf_counter() - t1
    fresh = rn_model()
    t1 = time.perf_counter()
    fresh.load(os.path.join(ck_dir, "rn"))
    t_load = time.perf_counter() - t1
    same = all(torch.equal(a, b) for a, b in zip(
        m.network.state_dict().values(), fresh.network.state_dict().values()))
    zero_launches()
    with paddle.amp.auto_cast(dtype="bfloat16"):
        ev2 = fresh.evaluate(rn_split(RN_STEPS, RN_EVAL), batch_size=RN_B,
                             verbose=0)
    launches = read_launches()
    rn_zero_counts("the loaded model's evaluate", launches, problems)
    add_launches(total, launches)
    nbytes = sum(os.path.getsize(os.path.join(ck_dir, f))
                 for f in os.listdir(ck_dir))
    shutil.rmtree(ck_dir, ignore_errors=True)
    if ev2 != ev or not same or not np.isfinite(ev["loss"]):
        problems.append(f"loaded model evaluates {ev2}, saved {ev}; state "
                        f"equal {same}")
    log(f"[train-resnet] evaluate {RN_EVAL} batches: {ev}; predict "
        f"{RN_PREDICT} batch of {pred[0].shape}; save {t_save:.2f} s, load "
        f"{t_load:.2f} s, {nbytes} bytes (.pdparams + .pdopt); the loaded "
        f"model (parameters and running buffers equal: {same}) evaluates "
        f"{ev2}")
    del m, fresh
    del_all()
    if problems:
        raise SystemExit("train-resnet failed: " + "; ".join(problems))
    log("[train-resnet] ok")
    return {"train-resnet": total}


def phase_train_resnet_trainer(smi):
    """ResNet-50 through ``prepare(strategy=...)`` with ``strategy.amp``
    (the port's ``SpmdTrainer``: bf16 copies of the f32 masters, the
    running buffers updated in place) for RN_TRAINER_STEPS steps.  Its
    first step's running buffers are held to one eager ``train_batch``
    of a twin on the same weights and batch under ``auto_cast`` within
    TOL_RN_STATS; finite losses, every buffer moved, no kernel launch or
    composite call; step ms, images/s, MFU and the peak beside the
    card."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.hapi import callbacks
    problems = []
    paddle.set_device("gpu")
    paddle.seed(1234)
    strategy = DistributedStrategy()
    strategy.amp = True
    m = rn_model(strategy)
    data = rn_split(0, RN_TRAINER_STEPS)
    x = torch.stack([torch.from_numpy(data[i][0]) for i in range(RN_B)])
    y = torch.as_tensor([int(data[i][1]) for i in range(RN_B)])
    twin = rn_model()
    twin.network.set_state_dict(m.network.state_dict())
    with paddle.amp.auto_cast(dtype="bfloat16"):
        twin.train_batch([x.cuda()], [y.cuda()])
    eager = rn_stats(twin.network)
    del twin
    del_all()
    before = rn_stats(m.network)

    class FirstStep(callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            if step == 0:
                self.stats = rn_stats(m.network)

    first = FirstStep()
    rec = tb_step_recorder(profile_step=RN_TRAINER_STEPS - 1)
    flops = paddle.flops(m.network, [1, 3, RN_SIDE, RN_SIDE])
    workers = rn_workers(smi)
    loader = rn_loader(0, RN_TRAINER_STEPS, workers)
    feed = rn_feed_recorder(loader)
    log(f"[train-resnet-trainer] at the start: {tb_process_state()}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    m.fit(loader, batch_size=RN_B, epochs=1, shuffle=False, verbose=0,
          callbacks=[first, rec, feed])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = read_launches()
    rn_zero_counts("trainer", launches, problems)
    feed_line = rn_feed_check("trainer", feed, workers, 1, RN_TRAINER_STEPS,
                              problems)
    rn_stats_moved("trainer", before, rn_stats(m.network), problems)
    worst = max(float((first.stats[n] - b).abs().max() / rn_scale(eager, n))
                for n, b in eager.items())
    if not worst <= TOL_RN_STATS:
        problems.append(f"first step's running buffers {worst:.3e} from the "
                        f"eager loop's (tolerance {TOL_RN_STATS})")
    if not (m._trainer is not None and m._trainer.amp_enabled and
            m._trainer.amp_dtype == torch.bfloat16):
        problems.append("the trainer loop did not run bf16 AMP")
    losses = rec.losses
    if len(losses) != RN_TRAINER_STEPS or not np.all(np.isfinite(losses)):
        problems.append(f"losses {losses}")
    log(f"[train-resnet-trainer] {smi}: ResNet-50 through SpmdTrainer "
        f"(strategy.amp, bf16 copies): losses "
        f"{[round(x, 4) for x in losses]}; first step's running buffers "
        f"within {worst:.3e} (of each buffer's scale) of an eager "
        f"train_batch's; {rn_timing_line(rec, RN_TRAINER_STEPS, wall, flops)}"
        f"; {feed_line}; max_memory_allocated {peak} bytes; kernel launches "
        f"and composite calls all 0: {not any(launches.values())}")
    del m
    del_all()
    if problems:
        raise SystemExit("train-resnet-trainer failed: "
                         + "; ".join(problems))
    log("[train-resnet-trainer] ok")
    return {"train-resnet-trainer": launches}


def phase_workers(smi):
    """The DataLoader's fork workers on the card, before ResNet-50's fit
    takes them: RN_CHECK_BATCHES batches of RN_CHECK_B FakeData images
    from two workers over RN_RING rings, bitwise equal to
    ``num_workers=0``'s on the card; the same under
    ``PADDLE_FAULT_WORKER_KILL="1:1"`` (worker 1 exits 137 after its first
    batch, ring left open) with ``worker_restarts=1`` (one restart); with
    ``worker_restarts=0`` a ``RuntimeError`` naming worker 1 within the
    loader's timeout.  No child and no ring is left; no kernel launch."""
    import multiprocessing as mp
    import shutil
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.io import DataLoader
    paddle.set_device("gpu")
    rn_workers(smi)
    problems = []
    data = rn_split(0, RN_CHECK_B * RN_CHECK_BATCHES // RN_B)
    fr_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "chip_smoke_flightrec")
    saved = {k: os.environ.get(k) for k in ("PADDLE_FAULT_WORKER_KILL",
                                            "PADDLE_TPU_FLIGHTREC_DIR")}

    def run(workers, **kw):
        loader = DataLoader(data, batch_size=RN_CHECK_B, num_workers=workers,
                            shm_ring_capacity=RN_RING,
                            timeout=RN_LOADER_TIMEOUT, **kw)
        t0 = time.perf_counter()
        out = [(x, y) for x, y in loader]
        return loader, out, time.perf_counter() - t0

    def equal(a, b):
        return len(a) == len(b) == RN_CHECK_BATCHES and all(
            x.device.type == "cuda" and torch.equal(x, u) and
            torch.equal(y, v) for (x, y), (u, v) in zip(a, b))

    zero_launches()
    _, ref, t_ref = run(0)
    plain, got, t_w = run(2)
    st = plain.worker_stats
    if not (st["mode"] == "processes" and len(st["producers"]) == 2
            and st["popped"] == RN_CHECK_BATCHES and equal(got, ref)):
        problems.append(f"two workers: mode {st['mode']}, frames from "
                        f"{st.get('producers')}, popped {st.get('popped')}, "
                        f"batches equal {equal(got, ref)}")
    rings = list(st.get("rings", []))
    try:
        os.environ["PADDLE_FAULT_WORKER_KILL"] = "1:1"
        os.environ["PADDLE_TPU_FLIGHTREC_DIR"] = fr_dir
        revived, again, t_kill = run(2, worker_restarts=1)
        rs = revived.worker_stats
        rings += rs["rings"]
        if rs["restarts"] != 1 or not equal(again, ref):
            problems.append(f"kill with a restart: {rs['restarts']} "
                            f"restarts, batches equal {equal(again, ref)}")
        t0 = time.perf_counter()
        raised = ""
        try:
            run(2, worker_restarts=0)
        except RuntimeError as e:
            raised = str(e)
        t_raise = time.perf_counter() - t0
        if "worker 1 died" not in raised or t_raise >= RN_LOADER_TIMEOUT:
            problems.append(f"kill without restarts: raised {raised!r} "
                            f"after {t_raise:.2f} s")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        bundles = len([d for d in os.listdir(fr_dir)
                       if not d.endswith(".tmp")]) \
            if os.path.isdir(fr_dir) else 0
        shutil.rmtree(fr_dir, ignore_errors=True)
    if bundles < 2:
        problems.append(f"{bundles} flight-recorder bundles from the killed "
                        f"workers (at least 2)")
    left = [n for n in rings if os.path.exists(f"/dev/shm/{n}")]
    if mp.active_children() or left:
        problems.append(f"left behind: children {mp.active_children()}, "
                        f"rings {left}")
    launches = read_launches()
    rn_zero_counts("workers", launches, problems)
    log(f"[workers] {smi}: {RN_CHECK_BATCHES} batches of {RN_CHECK_B} images: "
        f"num_workers=0 {t_ref:.2f} s, two workers {t_w:.2f} s (fork ms "
        f"{[round(x, 2) for x in st['fork_ms']]}), bitwise equal; worker 1 "
        f"killed after its first batch: one restart, equal batches in "
        f"{t_kill:.2f} s; without restarts: {raised!r} after {t_raise:.2f} "
        f"s; {bundles} flight-recorder bundles from the killed workers; no "
        f"child or ring left; kernel launches and composite calls all 0: "
        f"{not any(launches.values())}")
    if problems:
        raise SystemExit("workers failed: " + "; ".join(problems))
    log("[workers] ok")
    return {"workers": launches}


# ---------------------------------------------------------------------------
# detect: every op of vision.ops at published shapes.  Faster R-CNN's test
# scale (800 x 1344, Ren et al. 2015): the C4 map at stride 16 is 50 x 84;
# the RPN keeps the top 1000 of 6000 proposals at IoU 0.7; the detector
# samples 512 RoIs an image at output 14 (its C5 head) and keeps 100 of
# 80 classes at score 0.05, IoU 0.5.  SSD300's six prior maps.  DCNv2's
# ResNet-50 c5 (a 25 x 42 map at that scale, 512 channels, 3 x 3, with a
# mask).  YOLOv3's three heads at 608 x 608 (its nine anchors, 80 classes,
# ignore 0.7), batch 8, 50 gt boxes an image.
# ---------------------------------------------------------------------------
DET_H, DET_W, DET_STRIDE = 800, 1344, 16
DET_PROPOSALS, DET_RPN_IOU, DET_RPN_TOP = 6000, 0.7, 1000
DET_ROIS, DET_ROI_OUT = 512, 14
DET_C4, DET_C5 = 1024, 512  # channels of the C4 map and of DCNv2's c5
# RoIs an image held against the CPU (the CPU's f32 samples and their
# backward take about 1.5 s an op at 32 RoIs an image, 4 s at 64): the
# card runs all 512 too, timed
DET_ROIS_CPU = 32
DET_YOLO_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90,
                    156, 198, 373, 326]
# f32 on both sides: the same elementwise operations (exp, log, sigmoid
# and a division by a scalar, which the card takes as a product with its
# reciprocal, within an ulp), sums in another order; x max |cpu output|
TOL_DET_F32 = 1e-5
# the f32 sampling ops (RoI align / pool, deformable convolution): a
# sample coordinate an ulp apart (about 4e-6 at coordinates near 50, the
# scalar division above) moves a bilinear weight by as much, times the
# map's difference between neighbours; x max |cpu output|
TOL_DET_SAMPLE = 1e-4
# roi_pool's gradient goes to the largest of a bin's four samples, so a
# near-tie that those ulps order differently sends a bin's gradient to
# another sample: its d x is held in the L2 norm, relative to the CPU's
TOL_DET_POOL_L2 = 1e-3
# bf16 on the card (RoI ops, deformable convolution) against f32 on the
# CPU over the same bf16-rounded inputs, x max |cpu output|
TOL_DET_BF16 = 1e-2
# NMS keep sets must be equal but where a pair's IoU lies this close to the
# threshold (card and CPU may round it to either side)
TOL_NMS_IOU = 1e-5


def det_timed(fn):
    """``fn()`` and its milliseconds on the host clock, the card drained
    before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def det_near_pairs(boxes, thr):
    """Pairs of ``boxes`` (f32, CPU) whose IoU lies within TOL_NMS_IOU of
    ``thr``."""
    from paddle_tpu_torch.vision import ops as V
    iou = V.box_iou(boxes, boxes)
    return int(((iou - thr).abs() <= TOL_NMS_IOU).triu(1).sum())


def phase_detect(smi):
    """Every op of ``vision.ops`` on the card at the published shapes
    above, held against the same port function on the CPU (f32 there):
    anchors and RPN proposals (``generate_anchors``, ``box_coder`` decode,
    ``box_clip``, ``box_area``, ``box_iou``), the RPN's ``nms``, box coding
    over 1000 x 81, ``multiclass_nms`` and ``detection_map`` on its rows,
    SSD300's ``prior_box`` maps (8732 priors), ``roi_align`` /
    ``roi_pool`` on the C4 map with the backward (bf16 on the card; the
    CPU holds DET_ROIS_CPU RoIs an image), ``deform_conv2d`` with a mask
    (and ``DeformConv2D``) with the backward (bf16), ``yolo_box`` and
    ``yolo_loss`` with its backward on the three heads (f32).  Each op's
    card ms is printed; rows 1-11 launch 0 times."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.vision import ops as V
    paddle.set_device("gpu")
    paddle.seed(1234)
    problems, worst, ms, cpu_ms = [], {}, {}, {}
    rng = np.random.RandomState(1234)
    t_phase = time.perf_counter()
    zero_launches()

    def f32(what, card, cpu, tol=TOL_DET_F32):
        """max |card - cpu| within ``tol`` x max |cpu|."""
        card, cpu = card.detach().float().cpu(), cpu.detach().float()
        if card.shape != cpu.shape:
            problems.append(f"{what}: shapes {tuple(card.shape)} "
                            f"{tuple(cpu.shape)}")
            return
        rel = float((card - cpu).abs().max() /
                    cpu.abs().max().clamp_min(1e-30))
        worst[what] = rel
        if not rel <= tol:
            problems.append(f"{what}: {rel:.3e} (tolerance {tol})")

    def bf16(what, card, cpu):
        card, cpu = card.detach().float().cpu(), cpu.detach().float()
        rel = float((card - cpu).abs().max() / cpu.abs().max().clamp_min(
            1e-30))
        worst[what] = rel
        if not (torch.isfinite(card).all() and rel <= TOL_DET_BF16):
            problems.append(f"{what}: {rel:.3e} of its scale")

    def on_cpu(fn):
        paddle.set_device("cpu")
        try:
            return fn()
        finally:
            paddle.set_device("gpu")

    # anchors on the C4 map and 6000 RPN proposals decoded from them
    fh, fw = DET_H // DET_STRIDE, DET_W // DET_STRIDE
    anchor_kw = dict(sizes=(32, 64, 128, 256, 512),
                     aspect_ratios=(0.5, 1.0, 2.0))
    anchors, ms["generate_anchors"] = det_timed(
        lambda: V.generate_anchors(fh, fw, DET_STRIDE, **anchor_kw))
    cpu_anchors = on_cpu(lambda: V.generate_anchors(fh, fw, DET_STRIDE,
                                                    **anchor_kw))
    if not (anchors.device.type == "cuda" and
            torch.equal(anchors.cpu(), cpu_anchors)):
        problems.append("generate_anchors differ")
    pick = torch.from_numpy(rng.choice(fh * fw * 15, DET_PROPOSALS,
                                       replace=False))
    sel = cpu_anchors.reshape(-1, 4)[pick]
    deltas = torch.from_numpy(rng.normal(0, 1, (DET_PROPOSALS, 4)).astype(
        np.float32))
    var = (0.1, 0.1, 0.2, 0.2)
    dec, ms["box_coder decode"] = det_timed(lambda: V.box_coder(
        sel.cuda(), deltas.cuda(), "decode_center_size", var))
    cpu_dec = V.box_coder(sel, deltas, "decode_center_size", var)
    f32("box_coder decode", dec, cpu_dec)
    props, ms["box_clip"] = det_timed(lambda: V.box_clip(dec, (DET_H, DET_W)))
    cpu_props = V.box_clip(cpu_dec, (DET_H, DET_W))
    f32("box_clip", props, cpu_props)
    props = cpu_props.cuda()   # the CPU's proposals feed both sides on
    area, ms["box_area"] = det_timed(lambda: V.box_area(props))
    f32("box_area", area, V.box_area(cpu_props))
    iou, ms["box_iou"] = det_timed(lambda: V.box_iou(props[:1000], props))
    f32("box_iou", iou, V.box_iou(cpu_props[:1000], cpu_props))
    del iou

    # the RPN's NMS
    scores = torch.from_numpy(rng.uniform(0, 1, DET_PROPOSALS).astype(
        np.float32))
    V.nms(props[:16], scores[:16].cuda(), DET_RPN_IOU)  # warm-up
    keep, ms["nms"] = det_timed(lambda: V.nms(props, scores.cuda(),
                                              DET_RPN_IOU, top_k=DET_RPN_TOP))
    cpu_keep, cpu_ms["nms"] = det_timed(lambda: V.nms(
        cpu_props, scores, DET_RPN_IOU, top_k=DET_RPN_TOP))
    near = det_near_pairs(cpu_props, DET_RPN_IOU)
    same_keep = torch.equal(keep.cpu(), cpu_keep)
    if not (same_keep or near) or len(cpu_keep) != DET_RPN_TOP:
        problems.append(f"nms: {len(keep)} / {len(cpu_keep)} kept, equal "
                        f"{same_keep}, {near} pairs near the threshold")

    # box coding over 1000 x 81 (a box a class for each RoI)
    priors = cpu_props[:1000, None, :]
    per_class = (cpu_props[:1000, None, :] + torch.from_numpy(rng.normal(
        0, 8, (1000, 81, 4)).astype(np.float32))).clamp(0, DET_W)
    per_class[..., 2:] = torch.maximum(per_class[..., 2:],
                                       per_class[..., :2] + 1)
    enc, ms["box_coder encode"] = det_timed(lambda: V.box_coder(
        priors.cuda(), per_class.cuda(), "encode_center_size", var))
    cpu_enc = V.box_coder(priors, per_class, "encode_center_size", var)
    f32("box_coder encode", enc, cpu_enc)

    # multiclass NMS over 1000 boxes x 80 classes (a softmax over 81 with
    # the background dropped, about 50 boxes a class above 0.05), and mAP
    # on its rows
    cls_scores = torch.softmax(torch.from_numpy(rng.normal(
        0, 2, (1000, 81)).astype(np.float32)), -1)[:, 1:].T.contiguous()
    mkw = dict(score_threshold=0.05, keep_top_k=100, nms_threshold=0.5)
    det, ms["multiclass_nms"] = det_timed(lambda: V.multiclass_nms(
        props[:1000], cls_scores.cuda(), **mkw))
    cpu_det, cpu_ms["multiclass_nms"] = det_timed(
        lambda: V.multiclass_nms(cpu_props[:1000], cls_scores, **mkw))
    same_det = torch.equal(det.cpu(), cpu_det)
    mnear = 0 if same_det else det_near_pairs(cpu_props[:1000], 0.5)
    if not (same_det or mnear) or tuple(cpu_det.shape) != (100, 6) or \
            det.device.type != "cuda":
        problems.append(f"multiclass_nms: {tuple(det.shape)} on "
                        f"{det.device}, equal {same_det}, {mnear} pairs near")
    gt = cpu_det[::2, 2:] + torch.from_numpy(rng.normal(0, 2, (50, 4)).astype(
        np.float32))
    gt_lab = cpu_det[::2, 0].long()
    mean_ap, ms["detection_map"] = det_timed(
        lambda: V.detection_map([det], [gt], [gt_lab]))
    cpu_map = V.detection_map([cpu_det], [gt], [gt_lab])
    if not (mean_ap == cpu_map and 0.0 < cpu_map < 1.0):
        problems.append(f"detection_map {mean_ap} against {cpu_map}")

    # SSD300's prior maps
    ssd = [(38, 30, 60, (2,), 8), (19, 60, 111, (2, 3), 16),
           (10, 111, 162, (2, 3), 32), (5, 162, 213, (2, 3), 64),
           (3, 213, 264, (2,), 100), (1, 264, 315, (2,), 300)]

    def priors_of():
        return [V.prior_box(f, f, 300, 300, (lo,), (hi,), (1.0, *ar),
                            flip=True, step=step, clip=True)
                for f, lo, hi, ar, step in ssd]

    boxes_ssd, ms["prior_box"] = det_timed(priors_of)
    cpu_ssd = on_cpu(priors_of)
    n_priors = sum(b.shape[0] * b.shape[1] * b.shape[2] for b in boxes_ssd)
    if n_priors != 8732 or not all(torch.equal(a.cpu(), b) for a, b in
                                   zip(boxes_ssd, cpu_ssd)):
        problems.append(f"prior_box: {n_priors} priors")

    # RoI align / pool on the C4 map with the backward: f32 on both sides
    # at DET_ROIS_CPU RoIs an image, then bf16 on the card at DET_ROIS (its
    # rows of the cut RoIs against the CPU's: RoIs are independent)
    x = torch.randn(2, DET_C4, fh, fw).to(torch.bfloat16).float()
    rois = cpu_props[:2 * DET_ROIS]
    num = torch.tensor([DET_ROIS, DET_ROIS])
    rows = torch.cat([torch.arange(DET_ROIS_CPU),
                      torch.arange(DET_ROIS, DET_ROIS + DET_ROIS_CPU)])
    cut, cut_num = rois[rows], torch.tensor([DET_ROIS_CPU, DET_ROIS_CPU])
    roi_kw = dict(output_size=DET_ROI_OUT, spatial_scale=1.0 / DET_STRIDE)
    for name in ("roi_align", "roi_pool"):
        op = getattr(V, name)

        def fwd_bwd(xs, boxes, n, cot):
            xs = xs.detach().requires_grad_()
            out = op(xs, boxes, n, **roi_kw)
            out.backward(cot)
            return out, xs.grad

        cot = torch.randn(2 * DET_ROIS_CPU, DET_C4, DET_ROI_OUT, DET_ROI_OUT)
        fwd_bwd(x.cuda(), cut.cuda(), cut_num.cuda(), cot.cuda())
        (out, grad), ms[f"{name} f32 fwd+bwd, {DET_ROIS_CPU} RoIs"] = \
            det_timed(lambda: fwd_bwd(x.cuda(), cut.cuda(), cut_num.cuda(),
                                      cot.cuda()))
        (cpu_out, cpu_grad), cpu_ms[f"{name} fwd+bwd"] = det_timed(
            lambda: fwd_bwd(x, cut, cut_num, cot))
        f32(f"{name} f32, {DET_ROIS_CPU} RoIs an image", out, cpu_out,
            TOL_DET_SAMPLE)
        if name == "roi_align":
            f32(f"{name} f32 d x", grad, cpu_grad, TOL_DET_SAMPLE)
        else:
            diff = grad.cpu() - cpu_grad
            l2 = float(diff.norm() / cpu_grad.norm())
            worst[f"{name} f32 d x (L2)"] = l2
            worst[f"{name} f32 d x (max)"] = float(
                diff.abs().max() / cpu_grad.abs().max())
            if not l2 <= TOL_DET_POOL_L2:
                problems.append(f"{name} d x: L2 {l2:.3e}")
        del out, grad, cot, cpu_grad
        full_cot = torch.randn(2 * DET_ROIS, DET_C4, DET_ROI_OUT,
                               DET_ROI_OUT, device="cuda",
                               dtype=torch.bfloat16)
        xb = x.cuda().to(torch.bfloat16)
        fwd_bwd(xb, rois.cuda(), num.cuda(), full_cot)
        (out, grad), ms[f"{name} bf16 fwd+bwd, {DET_ROIS} RoIs"] = \
            det_timed(lambda: fwd_bwd(xb, rois.cuda(), num.cuda(), full_cot))
        bf16(f"{name} bf16, its rows of the cut RoIs", out[rows.cuda()],
             cpu_out)
        if not (torch.isfinite(out).all() and torch.isfinite(grad).all()):
            problems.append(f"{name} at {DET_ROIS} RoIs an image: not finite")
        del out, grad, full_cot, xb, cpu_out
    del_all()

    # deformable convolution v2 at DCNv2's ResNet-50 c5 shape: f32 on both
    # sides, then bf16 on the card (offsets in f32) against the CPU's f32
    dh, dw = fh // 2, fw // 2
    layer = V.DeformConv2D(DET_C5, DET_C5, 3, padding=1)
    dargs = [torch.randn(2, DET_C5, dh, dw), torch.randn(2, 18, dh, dw),
             layer.weight.detach().cpu(), torch.rand(2, 9, dh, dw),
             torch.randn(DET_C5) * 0.1, torch.randn(2, DET_C5, dh, dw)]

    def deform(x_, off, w, m, b, cot):
        args = [t.detach().requires_grad_() for t in (x_, off, w, m, b)]
        out = V.deform_conv2d(args[0], args[1], args[2], args[4],
                              padding=1, mask=args[3])
        out.backward(cot.to(out.dtype))
        return [out] + [a.grad for a in args]

    card_args = [t.cuda() for t in dargs]
    deform(*card_args)
    got, ms["deform_conv2d f32 fwd+bwd"] = det_timed(
        lambda: deform(*card_args))
    ref, cpu_ms["deform_conv2d fwd+bwd"] = det_timed(lambda: deform(*dargs))
    for what, a, b in zip(("out", "d x", "d offset", "d weight", "d mask",
                           "d bias"), got, ref):
        f32(f"deform_conv2d f32 {what}", a, b, TOL_DET_SAMPLE)
    half = [t if i == 1 else t.to(torch.bfloat16)
            for i, t in enumerate(card_args)]
    deform(*half)
    got, ms["deform_conv2d bf16 fwd+bwd"] = det_timed(lambda: deform(*half))
    bf16("deform_conv2d bf16 out", got[0], ref[0])
    if not all(torch.isfinite(g).all() for g in got):
        problems.append("deform_conv2d bf16: not finite")
    lay_out = layer(card_args[0], card_args[1], card_args[3])
    f32("DeformConv2D", lay_out, V.deform_conv2d(
        dargs[0], dargs[1], dargs[2], layer.bias.detach().cpu(), padding=1,
        mask=dargs[3]), TOL_DET_SAMPLE)
    del got, ref, card_args, half, lay_out, layer
    del_all()

    # YOLOv3's three heads at 608 x 608
    nb, nc, ngt = 8, 80, 50
    gt_box = np.concatenate([rng.uniform(0.05, 0.95, (nb, ngt, 2)), np.clip(
        np.exp(rng.normal(-2.5, 0.8, (nb, ngt, 2))), 0.01, 0.9)], -1)
    gt_box = torch.from_numpy(gt_box.astype(np.float32))
    gt_lab = torch.from_numpy(rng.randint(0, nc, (nb, ngt)))
    img = torch.full((nb, 2), 608, dtype=torch.int32)
    heads = [(19, 32, [6, 7, 8]), (38, 16, [3, 4, 5]), (76, 8, [0, 1, 2])]
    for side, ds, mask in heads:
        xh = torch.randn(nb, 3 * (5 + nc), side, side) * 0.5
        box_kw = dict(anchors=DET_YOLO_ANCHORS[2 * mask[0]:2 * mask[-1] + 2],
                      class_num=nc, conf_thresh=0.005, downsample_ratio=ds)
        (bx, sc), ms[f"yolo_box {side}"] = det_timed(
            lambda: V.yolo_box(xh.cuda(), img.cuda(), **box_kw))
        cbx, csc = V.yolo_box(xh, img, **box_kw)
        f32(f"yolo_box {side} boxes", bx, cbx)
        f32(f"yolo_box {side} scores", sc, csc)
        loss_kw = dict(anchors=DET_YOLO_ANCHORS, anchor_mask=mask,
                       class_num=nc, ignore_thresh=0.7, downsample_ratio=ds)

        def loss(xs, gb, gl):
            xs = xs.detach().requires_grad_()
            out = V.yolo_loss(xs, gb, gl, **loss_kw)
            out.sum().backward()
            return out, xs.grad

        (lo, lg), ms[f"yolo_loss {side} fwd+bwd"] = det_timed(
            lambda: loss(xh.cuda(), gt_box.cuda(), gt_lab.cuda()))
        (clo, clg), cpu_ms[f"yolo_loss {side} fwd+bwd"] = det_timed(
            lambda: loss(xh, gt_box, gt_lab))
        f32(f"yolo_loss {side}", lo, clo)
        f32(f"yolo_loss {side} d x", lg, clg)
        if not (clo > 0).all():
            problems.append(f"yolo_loss {side}: {clo.tolist()}")

    launches = read_launches()
    rn_zero_counts("detect", launches, problems)
    took = time.perf_counter() - t_phase
    card = ", ".join(f"{k}: {v:.2f}" for k, v in ms.items())
    host = ", ".join(f"{k}: {v:.1f}" for k, v in cpu_ms.items())
    log(f"[detect] {smi}: card ms {{{card}}}; the CPU's f32 references ms "
        f"{{{host}}}")
    log(f"[detect] worst against the CPU, of each output's scale (f32 ops "
        f"within {TOL_DET_F32}, f32 sampling {TOL_DET_SAMPLE}, roi_pool's d x "
        f"{TOL_DET_POOL_L2} in L2, bf16 {TOL_DET_BF16}): "
        f"{ {k: float(f'{v:.3e}') for k, v in worst.items()} }; nms kept "
        f"{len(cpu_keep)} of {DET_PROPOSALS} (equal {same_keep}; "
        f"{near} pairs within {TOL_NMS_IOU} of IoU {DET_RPN_IOU}); "
        f"multiclass_nms {tuple(cpu_det.shape)} (equal {same_det}; "
        f"{mnear} pairs near 0.5); mAP {cpu_map:.4f}; {n_priors} SSD300 "
        f"priors; cut: the CPU holds {DET_ROIS_CPU} of {DET_ROIS} RoIs an "
        f"image; kernel launches and composite calls all 0: "
        f"{not any(launches.values())}; the phase took {took:.1f} s")
    if problems:
        raise SystemExit("detect failed: " + "; ".join(problems))
    log("[detect] ok")
    return {"detect": launches}


# ---------------------------------------------------------------------------
# tensor-ops: the op library on the card against the CPU
# ---------------------------------------------------------------------------

TOL_OPS_EW = 1e-5     # x max|CPU output|: f32 elementwise
TOL_OPS_RED = 1e-4    # f32 reductions, products and linear algebra
TOL_OPS_BF16 = 1e-2   # bf16 inputs
OPS_RANDOM_N = 200_000  # draws of each random op compared in law


def ops_inputs(dev):
    """The tensor-ops phase's inputs on ``dev``, made on the CPU from seed
    1234 (the same values on both devices): ``[64, 256]`` f32 in each
    op's domain and their bf16 copies, ints, bools, complex, batched
    ``4 x 64 x 64`` well-conditioned matrices, ragged ``[64, 32, 8]``
    sequences."""
    g = torch.Generator().manual_seed(1234)

    def n(*s):
        return torch.randn(*s, generator=g)

    def u(lo, hi, *s):
        return lo + (hi - lo) * torch.rand(*s, generator=g)

    s = (64, 256)
    d = {"x": n(*s), "y": n(*s), "pos": u(0.5, 2.0, *s),
         "unit": u(-0.9, 0.9, *s), "gt1": u(1.1, 3.0, *s),
         "prob": u(0.05, 0.95, *s), "near1": u(0.99, 1.01, *s),
         "i": torch.randint(-9, 10, s, generator=g, dtype=torch.int32),
         "ip": torch.randint(1, 20, s, generator=g, dtype=torch.int32),
         "bo": torch.rand(*s, generator=g) > 0.5,
         "bo2": torch.rand(*s, generator=g) > 0.5}
    d["nan"] = d["x"].clone()
    d["nan"].view(-1)[::7] = float("nan")
    d["inf"] = d["nan"].clone()
    d["inf"].view(-1)[1::11] = float("inf")
    # bin centres only: no value on a histogram bin edge
    d["hist"] = torch.round(d["x"] * 2).clamp(-7, 7) / 2 + 0.25
    d["ties"] = torch.round(d["x"] * 2)
    d["c"] = torch.complex(d["x"], d["y"])
    for k in ("x", "y", "pos", "unit", "gt1", "prob", "ties", "near1",
              "nan", "inf"):
        d[k + "16"] = d[k].bfloat16()
    eye = torch.eye(64)
    m = eye + 0.3 * n(4, 64, 64) / 8
    d["m"], d["m2"] = m, eye + 0.3 * n(4, 64, 64) / 8
    d["m16"], d["m216"] = d["m"].bfloat16(), d["m2"].bfloat16()
    d["spd"] = m @ m.transpose(-1, -2) + eye
    d["tri"] = torch.triu(n(4, 64, 64) / 8) + 3 * eye
    d["rhs"] = n(4, 64, 8)
    d["low"] = n(4, 64, 4) @ n(4, 4, 64)
    d["tall"] = n(128, 32)
    d["tall_b"] = n(128, 4)
    d["v3"] = n(64, 3)
    d["w3"] = n(64, 3)
    d["seq"] = n(64, 32, 8)
    d["lens"] = torch.randint(0, 33, (64,), generator=g)
    d["idx"] = torch.randint(-64, 64, (48,), generator=g)
    d["perm"] = torch.randperm(64, generator=g)[:40]
    d["col"] = torch.randint(0, 256, (64, 12), generator=g)
    d["sorted"] = torch.sort(n(512)).values
    out = {k: v.to(dev) for k, v in d.items()}
    out["dev"] = torch.device(dev)
    return out


def _ops_table():
    """``[(name, kind, call)]``: ``call(T, L, d)`` runs one op of the
    library ``T`` (``L``: the ``linalg`` namespace) on the inputs ``d``;
    ``kind`` picks the comparison (``ew``, ``red``, ``bf16``, ``exact``,
    ``law``: random draws in law, ``recon``: factorizations through their
    reconstructions, ``eig``: eigenvalues matched)."""
    t = []

    def add(name, kind, call):
        t.append((name, kind, call))

    unary = {"sqrt": "pos", "rsqrt": "pos", "square": "x", "exp": "x",
             "expm1": "x", "log": "pos", "log2": "pos", "log10": "pos",
             "log1p": "pos", "abs": "x", "ceil": "x", "floor": "x",
             "round": "x", "trunc": "x", "frac": "x", "sign": "x",
             "neg": "x", "reciprocal": "pos", "sin": "x", "cos": "x",
             "tan": "unit", "asin": "unit", "acos": "unit", "atan": "x",
             "sinh": "x", "cosh": "x", "tanh": "x", "asinh": "x",
             "acosh": "gt1", "atanh": "unit", "erf": "x", "erfinv": "unit",
             "lgamma": "pos", "digamma": "pos", "i0": "x", "i1": "x",
             "deg2rad": "x", "rad2deg": "x", "isnan": "nan", "isinf": "inf",
             "isfinite": "inf", "logit": "prob", "sigmoid": "x",
             "stanh": "x"}
    for name, k in unary.items():
        add(name, "ew", lambda T, L, d, f=name, k=k: getattr(T, f)(d[k]))
        if k not in ("nan", "inf"):
            add(name, "bf16", lambda T, L, d, f=name, k=k: getattr(T, f)(
                d[k + "16"]))
    add("tanh_", "ew", lambda T, L, d: T.tanh_(d["x"].clone()))
    binary = {"add": "y", "subtract": "y", "multiply": "y", "divide": "pos",
              "floor_divide": "pos", "remainder": "pos", "mod": "pos",
              "floor_mod": "pos", "maximum": "y", "minimum": "y",
              "fmax": "y", "fmin": "y", "atan2": "y", "heaviside": "y",
              "hypot": "y", "logaddexp": "y", "nextafter": "y",
              "copysign": "y", "elementwise_add": "y",
              "elementwise_sub": "y", "elementwise_mul": "y",
              "elementwise_div": "pos"}
    for name, k in binary.items():
        add(name, "ew", lambda T, L, d, f=name, k=k: getattr(T, f)(d["x"],
                                                                    d[k]))
        add(name, "bf16", lambda T, L, d, f=name, k=k: getattr(T, f)(
            d["x16"], d[k + "16"]))
    add("pow", "ew", lambda T, L, d: T.pow(d["pos"], d["y"]))
    add("pow", "bf16", lambda T, L, d: T.pow(d["pos16"], d["y16"]))
    for name in ("gcd", "lcm", "bitwise_and", "bitwise_or", "bitwise_xor"):
        add(name, "exact", lambda T, L, d, f=name: getattr(T, f)(d["i"],
                                                                  d["ip"]))
    add("bitwise_not", "exact", lambda T, L, d: T.bitwise_not(d["i"]))
    for name in ("equal", "not_equal", "greater_than", "greater_equal",
                 "less_than", "less_equal"):
        add(name, "exact", lambda T, L, d, f=name: getattr(T, f)(
            d["i"], d["ip"] - 10))
    for name in ("logical_and", "logical_or", "logical_xor"):
        add(name, "exact", lambda T, L, d, f=name: getattr(T, f)(d["bo"],
                                                                  d["bo2"]))
    add("logical_not", "exact", lambda T, L, d: T.logical_not(d["bo"]))
    add("equal_all", "exact", lambda T, L, d: T.equal_all(d["x"], d["x"]))
    add("allclose", "exact", lambda T, L, d: T.allclose(d["x"], d["x"] + 1e-9))
    add("isclose", "exact", lambda T, L, d: T.isclose(d["x"], d["y"],
                                                      atol=0.5))
    add("is_empty", "exact", lambda T, L, d: T.is_empty(d["x"][:0]))
    add("is_tensor", "exact", lambda T, L, d: T.is_tensor(d["x"]))
    # reductions and products
    red = [("sum", {"axis": 1}), ("mean", {}), ("max", {"axis": 0}),
           ("min", {"axis": [0, 1], "keepdim": True}), ("amax", {"axis": 1}),
           ("amin", {}), ("logsumexp", {"axis": 1}), ("cumsum", {"axis": 1}),
           ("cummax", {"axis": 1}), ("cummin", {}), ("std", {"axis": 1}),
           ("var", {"unbiased": False}), ("median", {"axis": 1}),
           ("diff", {"axis": 1}), ("logcumsumexp", {"axis": 1}),
           ("clip_by_norm", {"max_norm": 2.0}),
           ("trapezoid", {"dx": 0.5}),
           ("renorm", {"p": 2.0, "axis": 0, "max_norm": 5.0}),
           ("quantile", {"q": [0.1, 0.5], "axis": 1})]
    for name, kw in red:
        add(name, "red", lambda T, L, d, f=name, kw=kw: getattr(T, f)(
            d["x"], **kw))
    for name, kw in red:
        add(name, "bf16", lambda T, L, d, f=name, kw=kw: getattr(T, f)(
            d["x16"], **kw))
    # the other float-taking math ops on bf16 inputs
    bf = [("prod", lambda T, d: T.prod(d["near116"], axis=1)),
          ("cumprod", lambda T, d: T.cumprod(d["near116"], dim=1)),
          ("nanmedian", lambda T, d: T.nanmedian(d["nan16"], axis=1)),
          ("nanmean", lambda T, d: T.nanmean(d["nan16"], axis=0)),
          ("nansum", lambda T, d: T.nansum(d["nan16"], axis=1)),
          ("nan_to_num", lambda T, d: T.nan_to_num(d["inf16"], nan=2.0)),
          ("add_n", lambda T, d: T.add_n([d["x16"], d["y16"]])),
          ("trace", lambda T, d: T.trace(d["m16"][0])),
          ("lerp", lambda T, d: T.lerp(d["x16"], d["y16"], 0.3)),
          ("kron", lambda T, d: T.kron(d["x16"][:8, :8], d["y16"][:4, :4])),
          ("inner", lambda T, d: T.inner(d["x16"], d["y16"])),
          ("outer", lambda T, d: T.outer(d["x16"][0], d["y16"][1])),
          ("mm", lambda T, d: T.mm(d["x16"], d["y16"].T)),
          ("bmm", lambda T, d: T.bmm(d["m16"], d["m216"])),
          ("dot", lambda T, d: T.dot(d["x16"], d["y16"])),
          ("mv", lambda T, d: T.mv(d["x16"], d["y16"][0])),
          ("addmm", lambda T, d: T.addmm(d["m16"][0], d["m16"][1],
                                         d["m16"][2])),
          ("clip", lambda T, d: T.clip(d["x16"], -0.5, 0.7)),
          ("scale", lambda T, d: T.scale(d["x16"], 2.0, 0.5)),
          ("multiplex", lambda T, d: T.multiplex(
              [d["x16"], d["y16"]], d["bo"][:, :1].long())),
          ("tanh_", lambda T, d: T.tanh_(d["x16"].clone())),
          ("einsum", lambda T, d: T.einsum("bij,bjk->bik", d["m16"],
                                           d["m216"])),
          ("tensordot", lambda T, d: T.tensordot(d["m16"], d["m216"],
                                                 [[1, 2], [2, 1]]))]
    for name, call in bf:
        add(name, "bf16", lambda T, L, d, c=call: c(T, d))
    add("prod", "red", lambda T, L, d: T.prod(d["near1"], axis=1))
    add("cumprod", "red", lambda T, L, d: T.cumprod(d["near1"], dim=1))
    add("nanmedian", "red", lambda T, L, d: T.nanmedian(d["nan"], axis=1))
    add("nanmean", "red", lambda T, L, d: T.nanmean(d["nan"], axis=0))
    add("nansum", "red", lambda T, L, d: T.nansum(d["nan"]))
    add("nan_to_num", "ew", lambda T, L, d: T.nan_to_num(d["inf"], nan=2.0))
    add("all", "exact", lambda T, L, d: T.all(d["bo"], axis=1))
    add("any", "exact", lambda T, L, d: T.any(d["bo"]))
    add("count_nonzero", "exact", lambda T, L, d: T.count_nonzero(d["i"],
                                                                  axis=0))
    add("histogram", "exact", lambda T, L, d: T.histogram(d["hist"], 16, -4,
                                                          4))
    add("bincount", "exact", lambda T, L, d: T.bincount(d["ip"].reshape(-1)))
    add("add_n", "ew", lambda T, L, d: T.add_n([d["x"], d["y"], d["pos"]]))
    add("trace", "red", lambda T, L, d: T.trace(d["m"][0], offset=1))
    add("lerp", "ew", lambda T, L, d: T.lerp(d["x"], d["y"], 0.3))
    add("kron", "ew", lambda T, L, d: T.kron(d["x"][:8, :8], d["y"][:4, :4]))
    add("inner", "red", lambda T, L, d: T.inner(d["x"], d["y"]))
    add("outer", "ew", lambda T, L, d: T.outer(d["x"][0], d["y"][1]))
    add("matmul", "red", lambda T, L, d: T.matmul(d["x"], d["y"],
                                                  transpose_y=True))
    add("matmul", "bf16", lambda T, L, d: T.matmul(d["x16"], d["y16"],
                                                   transpose_y=True))
    add("mm", "red", lambda T, L, d: T.mm(d["x"], d["y"].T))
    add("bmm", "red", lambda T, L, d: T.bmm(d["m"], d["m2"]))
    add("dot", "red", lambda T, L, d: T.dot(d["x"], d["y"]))
    add("mv", "red", lambda T, L, d: T.mv(d["x"], d["y"][0]))
    add("addmm", "red", lambda T, L, d: T.addmm(d["m"][0], d["m"][1],
                                                d["m"][2], 0.5, 2.0))
    add("clip", "ew", lambda T, L, d: T.clip(d["x"], -0.5, 0.7))
    add("scale", "ew", lambda T, L, d: T.scale(d["x"], 2.0, 0.5, act="relu"))
    add("multiplex", "ew", lambda T, L, d: T.multiplex(
        [d["x"], d["y"]], d["bo"][:, :1].long()))
    add("increment", "ew", lambda T, L, d: T.increment(d["x"][:1, 0].clone(),
                                                       2.0))
    # attribute
    add("shape", "exact", lambda T, L, d: T.shape(d["x"]))
    add("rank", "exact", lambda T, L, d: T.rank(d["m"]))
    add("is_floating_point", "exact", lambda T, L, d: T.is_floating_point(
        d["x"]))
    add("is_integer", "exact", lambda T, L, d: T.is_integer(d["i"]))
    add("is_complex", "exact", lambda T, L, d: T.is_complex(d["c"]))
    for name in ("real", "imag", "conj", "angle"):
        add(name, "ew", lambda T, L, d, f=name: getattr(T, f)(d["c"]))
    add("set_printoptions", "exact", lambda T, L, d: T.set_printoptions())
    # creation
    dev = lambda d: d["dev"]  # noqa: E731
    add("zeros", "exact", lambda T, L, d: T.zeros([3, 4], device=dev(d)))
    add("ones", "exact", lambda T, L, d: T.ones(5, "int32", device=dev(d)))
    add("full", "exact", lambda T, L, d: T.full([2, 2], 7.5, device=dev(d)))
    add("empty", "exact", lambda T, L, d: T.empty([3], device=dev(d)))
    add("arange", "exact", lambda T, L, d: T.arange(1, 9, 2, device=dev(d)))
    add("linspace", "ew", lambda T, L, d: T.linspace(-1, 2, 33,
                                                     device=dev(d)))
    add("logspace", "ew", lambda T, L, d: T.logspace(0, 2, 9, 2.0,
                                                     device=dev(d)))
    add("eye", "exact", lambda T, L, d: T.eye(3, 5, device=dev(d)))
    add("tril_indices", "exact", lambda T, L, d: T.tril_indices(
        6, 5, 1, device=dev(d)))
    add("triu_indices", "exact", lambda T, L, d: T.triu_indices(
        6, 5, -1, device=dev(d)))
    for name in ("zeros_like", "ones_like", "empty_like", "clone", "numel",
                 "assign"):
        add(name, "exact", lambda T, L, d, f=name: getattr(T, f)(d["x"]))
    add("full_like", "exact", lambda T, L, d: T.full_like(d["x"], 2.5))
    add("meshgrid", "exact", lambda T, L, d: T.meshgrid(d["x"][0], d["y"][0]))
    add("diag", "exact", lambda T, L, d: T.diag(d["x"][0], 1, 9.0))
    add("diagflat", "exact", lambda T, L, d: T.diagflat(d["x"][:3, :3]))
    add("diag_embed", "exact", lambda T, L, d: T.diag_embed(d["x"][:4]))
    add("tril", "exact", lambda T, L, d: T.tril(d["m"], 1))
    add("triu", "exact", lambda T, L, d: T.triu(d["m"], -1))
    add("complex", "exact", lambda T, L, d: T.complex(d["x"], d["y"]))
    add("to_tensor", "exact", lambda T, L, d: T.to_tensor(
        np.arange(6.0), place=dev(d)))
    # manipulation
    x = lambda d: d["x"]  # noqa: E731
    man = [
        ("reshape", lambda T, d: T.reshape(x(d), [128, -1])),
        ("reshape_", lambda T, d: T.reshape_(x(d).clone(), [128, -1])),
        ("flatten", lambda T, d: T.flatten(d["m"], 1)),
        ("transpose", lambda T, d: T.transpose(d["m"], [2, 0, 1])),
        ("t", lambda T, d: T.t(x(d))),
        ("moveaxis", lambda T, d: T.moveaxis(d["m"], 0, 2)),
        ("swapaxes", lambda T, d: T.swapaxes(d["m"], 0, 1)),
        ("concat", lambda T, d: T.concat([x(d), d["y"]], axis=1)),
        ("stack", lambda T, d: T.stack([x(d), d["y"]], axis=1)),
        ("unstack", lambda T, d: T.unstack(d["m"], 0)),
        ("unbind", lambda T, d: T.unbind(d["m"], 1)[:3]),
        ("split", lambda T, d: T.split(x(d), [100, -1, 56], axis=1)),
        ("chunk", lambda T, d: T.chunk(x(d), 4, axis=0)),
        ("squeeze", lambda T, d: T.squeeze(x(d)[:1], axis=0)),
        ("unsqueeze", lambda T, d: T.unsqueeze(x(d), [0, 2])),
        ("squeeze_", lambda T, d: T.squeeze_(x(d)[:1].clone(), 0)),
        ("unsqueeze_", lambda T, d: T.unsqueeze_(x(d).clone(), [0, 3])),
        ("flip", lambda T, d: T.flip(x(d), [0, 1])),
        ("rot90", lambda T, d: T.rot90(x(d), 3)),
        ("roll", lambda T, d: T.roll(x(d), [3, -5], [0, 1])),
        ("tile", lambda T, d: T.tile(x(d)[:4], [2, 1, 3])),
        ("expand", lambda T, d: T.expand(x(d)[:1], [3, 64, -1])),
        ("expand_as", lambda T, d: T.expand_as(x(d)[:1], d["y"])),
        ("broadcast_to", lambda T, d: T.broadcast_to(x(d)[:1], [64, 256])),
        ("broadcast_tensors", lambda T, d: T.broadcast_tensors(
            [x(d)[:1], d["y"][:, :1]])),
        ("broadcast_shape", lambda T, d: T.broadcast_shape([4, 1], [3])),
        ("cast", lambda T, d: T.cast(x(d) * 4, "int32")),
        ("view", lambda T, d: T.view(x(d), [16, 1024])),
        ("view_as", lambda T, d: T.view_as(x(d)[:, :64], d["m"][0])),
        ("gather", lambda T, d: T.gather(x(d), d["idx"])),
        ("gather_nd", lambda T, d: T.gather_nd(d["m"], d["col"][:, :2] % 4)),
        ("index_select", lambda T, d: T.index_select(x(d), d["col"][0], 1)),
        ("index_sample", lambda T, d: T.index_sample(x(d), d["col"])),
        ("take_along_axis", lambda T, d: T.take_along_axis(x(d), d["col"],
                                                           1)),
        ("scatter", lambda T, d: T.scatter(x(d), d["perm"], d["y"][:40])),
        ("scatter_", lambda T, d: T.scatter_(x(d).clone(), d["perm"],
                                             d["y"][:40])),
        ("slice", lambda T, d: T.slice(d["m"], [1, 2], [-10, 3], [100, -2])),
        ("strided_slice", lambda T, d: T.strided_slice(
            d["m"], [1, 2], [0, 60], [64, 0], [3, -2])),
        ("shard_index", lambda T, d: T.shard_index(d["ip"], 20, 3, 1)),
        ("masked_fill", lambda T, d: T.masked_fill(x(d), d["bo"], 2.5)),
        ("pad", lambda T, d: T.pad(d["m"][None], [1, 2, 3, 0],
                                   mode="reflect")),
        ("repeat_interleave", lambda T, d: T.repeat_interleave(x(d), 2, 1)),
        ("as_complex", lambda T, d: T.as_complex(d["v3"][:, :2])),
        ("as_real", lambda T, d: T.as_real(d["c"])),
        ("atleast_1d", lambda T, d: T.atleast_1d(x(d)[0, 0])),
        ("atleast_2d", lambda T, d: T.atleast_2d(x(d)[0])),
        ("atleast_3d", lambda T, d: T.atleast_3d(x(d))),
        ("crop", lambda T, d: T.crop(d["m"], [2, -1, 8], [1, 3, 4])),
        ("crop_tensor", lambda T, d: T.crop_tensor(d["m"], [1, 8, 8],
                                                   [2, 0, 0])),
        ("unique", lambda T, d: T.unique(d["i"], True, True, True)),
        ("unique_consecutive", lambda T, d: T.unique_consecutive(
            torch.sort(d["i"].reshape(-1)).values, True, True)),
        ("masked_select", lambda T, d: T.masked_select(x(d), d["bo"])),
        ("argmax", lambda T, d: T.argmax(x(d), 1)),
        ("argmin", lambda T, d: T.argmin(d["ties16"], 0)),
        ("argsort", lambda T, d: T.argsort(d["ties"], 1, descending=True)),
        ("sort", lambda T, d: T.sort(d["ties16"], 1, descending=True,
                                     stable=True)),
        ("topk", lambda T, d: T.topk(d["ties"], 5)),
        ("kthvalue", lambda T, d: T.kthvalue(d["ties"], 7, 1)),
        ("mode", lambda T, d: T.mode(d["ties"], 1)),
        ("nonzero", lambda T, d: T.nonzero(d["i"] // 5)),
        ("where", lambda T, d: T.where(d["bo"], x(d), d["y"])),
        ("searchsorted", lambda T, d: T.searchsorted(d["sorted"], x(d))),
        ("bucketize", lambda T, d: T.bucketize(x(d), d["sorted"],
                                               right=True)),
    ]
    for name, call in man:
        add(name, "exact", lambda T, L, d, c=call: c(T, d))
    add("index_add", "red", lambda T, L, d: T.index_add(
        d["x"], d["idx"] % 64, 0, d["y"][:48]))
    add("index_put", "red", lambda T, L, d: T.index_put(
        d["x"], [d["perm"], d["col"][:40, 0]], d["y"][0, :40], True))
    add("put_along_axis", "red", lambda T, L, d: T.put_along_axis(
        d["x"], d["col"], d["y"][:, :12], 1, "add"))
    add("scatter_nd", "red", lambda T, L, d: T.scatter_nd(
        d["col"][:, :2] % 8, d["x"][:, 0], [8, 8]))
    add("scatter_nd_add", "red", lambda T, L, d: T.scatter_nd_add(
        d["x"], d["col"][:, :2] % 64, d["y"][:, 0]))
    add("tensordot", "red", lambda T, L, d: T.tensordot(d["m"], d["m2"],
                                                        [[1, 2], [2, 1]]))
    add("einsum", "red", lambda T, L, d: T.einsum("bij,bjk->bik", d["m"],
                                                  d["m2"]))
    # linear algebra, on batched 64 x 64 matrices
    lin = [("norm", lambda T, d: T.norm(d["m"], p="fro", axis=[1, 2])),
           ("norm", lambda T, d: T.norm(d["m"], p="nuc")),
           ("p_norm", lambda T, d: T.p_norm(d["m"], 3, axis=2)),
           ("vector_norm", lambda T, d: T.vector_norm(d["m"], 1, axis=1)),
           ("matrix_norm", lambda T, d: T.matrix_norm(d["m"])),
           ("cond", lambda T, d: T.cond(d["m"])),
           ("cholesky", lambda T, d: T.cholesky(d["spd"])),
           ("cholesky_solve", lambda T, d: T.cholesky_solve(
               d["rhs"], T.cholesky(d["spd"]))),
           ("inv", lambda T, d: T.inv(d["m"])),
           ("inverse", lambda T, d: T.inverse(d["spd"])),
           ("det", lambda T, d: T.det(d["m"])),
           ("slogdet", lambda T, d: T.slogdet(d["m"])),
           ("svdvals", lambda T, d: T.svdvals(d["m"])),
           ("eigvalsh", lambda T, d: T.eigvalsh(d["m"])),
           ("matrix_power", lambda T, d: T.matrix_power(d["m"], 3)),
           ("pinv", lambda T, d: T.pinv(d["m"])),
           ("solve", lambda T, d: T.solve(d["m"], d["rhs"])),
           ("triangular_solve", lambda T, d: T.triangular_solve(
               d["tri"], d["rhs"], transpose=True)),
           ("cross", lambda T, d: T.cross(d["v3"], d["w3"])),
           ("multi_dot", lambda T, d: T.multi_dot([d["m"][0], d["m"][1],
                                                   d["m"][2]])),
           ("corrcoef", lambda T, d: T.corrcoef(d["x"][:8])),
           ("cov", lambda T, d: T.cov(d["x"][:8], ddof=False)),
           ("householder_product", lambda T, d: T.householder_product(
               d["m"][:, :, :16], d["prob"][:4, :16])),
           ("dist", lambda T, d: T.dist(d["x"], d["y"], 3)),
           ("lstsq", lambda T, d: T.lstsq(d["tall"], d["tall_b"]))]
    for name, call in lin:
        add(name, "red", lambda T, L, d, c=call: c(T, d))
    add("matrix_rank", "exact", lambda T, L, d: T.matrix_rank(d["low"],
                                                              tol=1e-3))
    add("lu", "recon", lambda T, L, d: T.lu(d["m"]))
    add("svd", "recon", lambda T, L, d: T.svd(d["m"]))
    add("qr", "recon", lambda T, L, d: T.qr(d["m"]))
    add("eigh", "recon", lambda T, L, d: T.eigh(d["spd"]))
    add("eig", "eig", lambda T, L, d: T.eig(d["m"]))
    add("eigvals", "eig", lambda T, L, d: T.eigvals(d["m"]))
    for name in ("matmul", "bmm", "dot", "mv", "norm", "p_norm", "dist",
                 "cholesky", "inv", "matrix_power", "multi_dot", "det",
                 "slogdet", "svd", "qr", "eig", "eigh", "eigvals",
                 "eigvalsh", "matrix_rank", "pinv", "solve",
                 "triangular_solve", "lstsq", "cond", "lu",
                 "cholesky_solve", "cross", "householder_product",
                 "corrcoef", "cov", "histogram"):
        # the namespace holds the library's own functions
        add(f"linalg.{name}", "exact", lambda T, L, d, f=name: getattr(
            L, f) is getattr(T, f))
    # random draws, compared in law
    N = OPS_RANDOM_N
    rnd = [("uniform", lambda T, d: T.uniform([N], min=-2, max=3,
                                               device=dev(d))),
           ("rand", lambda T, d: T.rand([N], device=dev(d))),
           ("randn", lambda T, d: T.randn([N], device=dev(d))),
           ("standard_normal", lambda T, d: T.standard_normal(
               [N], device=dev(d))),
           ("normal", lambda T, d: T.normal(1.5, 2.0, [N], device=dev(d))),
           ("gaussian", lambda T, d: T.gaussian([N], -1.0, 0.5,
                                                device=dev(d))),
           ("randint", lambda T, d: T.randint(-3, 7, [N], device=dev(d))),
           ("randperm", lambda T, d: T.randperm(N, device=dev(d))),
           ("uniform_", lambda T, d: T.uniform_(T.zeros([N], device=dev(d)),
                                                0.0, 2.0)),
           ("normal_", lambda T, d: T.normal_(T.zeros([N], device=dev(d)),
                                              3.0, 0.25)),
           ("bernoulli", lambda T, d: T.bernoulli(T.full([N], 0.3,
                                                         device=dev(d)))),
           ("bernoulli_", lambda T, d: T.bernoulli_(T.zeros([N],
                                                            device=dev(d)),
                                                    0.7)),
           ("exponential_", lambda T, d: T.exponential_(
               T.zeros([N], device=dev(d)), 2.0)),
           ("poisson", lambda T, d: T.poisson(T.full([N], 4.0,
                                                     device=dev(d)))),
           ("binomial", lambda T, d: T.binomial(
               T.full([N], 10.0, device=dev(d)), T.full([N], 0.3,
                                                        device=dev(d)))),
           ("randint_like", lambda T, d: T.randint_like(
               T.zeros([N], device=dev(d)), 2, 5)),
           ("shuffle", lambda T, d: T.shuffle(T.arange(
               N, dtype="float32", device=dev(d)))),
           ("multinomial", lambda T, d: T.multinomial(
               d["prob"][0, :5].contiguous(), N // 10, True))]
    for name, call in rnd:
        add(name, "law", lambda T, L, d, c=call: c(T, d))
    # sequences
    for pool in ("sum", "average", "sqrt", "max", "first", "last"):
        add("sequence_pool", "red", lambda T, L, d, p=pool: T.sequence_pool(
            d["seq"], d["lens"], p))
    for name in ("sequence_softmax", "sequence_reverse",
                 "sequence_first_step", "sequence_last_step"):
        add(name, "ew", lambda T, L, d, f=name: getattr(T, f)(
            d["seq"][..., 0], d["lens"]))
    add("sequence_enumerate", "exact", lambda T, L, d: T.sequence_enumerate(
        d["seq"][..., 0], 3, -1.0))
    add("sequence_expand", "exact", lambda T, L, d: T.sequence_expand(
        d["seq"], d["lens"] % 3))
    add("sequence_concat", "exact", lambda T, L, d: T.sequence_concat(
        [d["seq"], d["seq"][:, :7]], [d["lens"], d["lens"] % 8]))
    add("sequence_slice", "exact", lambda T, L, d: T.sequence_slice(
        d["seq"], d["lens"], d["lens"] // 2, d["lens"] - d["lens"] // 2))
    add("sequence_pad", "exact", lambda T, L, d: T.sequence_pad(
        [np.ones((k, 2), np.float32) * k for k in (3, 1, 5)], -1.0,
        device=dev(d)))
    add("sequence_unpad", "exact", lambda T, L, d: T.sequence_unpad(
        d["seq"], d["lens"]))
    # TensorArray and the namespace's helpers
    add("TensorArray", "exact", lambda T, L, d: len(T.TensorArray()))
    add("create_array", "exact", lambda T, L, d: T.create_array(
        "float32", [d["x"][0]]))
    add("array_write", "exact", lambda T, L, d: T.array_write(
        d["x"][1], 1, T.create_array("float32", [d["x"][0]])))
    add("array_read", "exact", lambda T, L, d: T.array_read(
        T.array_write(d["y"][0], 0), 0))
    add("array_length", "exact", lambda T, L, d: T.array_length(
        T.create_array("float32", [d["x"][0], d["x"][1]])))
    add("Tensor", "exact", lambda T, L, d: isinstance(d["x"], T.Tensor))
    add("InvalidArgumentError", "exact", lambda T, L, d: issubclass(
        T.InvalidArgumentError, ValueError))
    add("apply", "ew", lambda T, L, d: T.apply(torch.add, d["x"], d["y"],
                                               name="add"))
    add("convert_dtype", "exact", lambda T, L, d: str(T.convert_dtype(
        "bfloat16")))
    add("default_float_dtype", "exact", lambda T, L, d: str(
        T.default_float_dtype()))
    add("next_key", "exact", lambda T, L, d: T.next_key(
        dev(d)).device.type == dev(d).type)
    return t


def _flat_outputs(out):
    """An op's outputs as a flat list of tensors and Python values."""
    if isinstance(out, (list, tuple)):
        return [v for o in out for v in _flat_outputs(o)]
    return [out]


def ops_error(kind, card, cpu):
    """Worst error of ``card`` against ``cpu`` over the outputs (a
    fraction of each output's largest magnitude; exact kinds: 0 or 1)."""
    worst = 0.0
    for a, b in zip(_flat_outputs(card), _flat_outputs(cpu), strict=True):
        if not torch.is_tensor(b):
            worst = max(worst, float(a != b))
            continue
        a = a.detach().cpu()
        b = b.detach()
        if tuple(a.shape) != tuple(b.shape):
            return float("inf")
        if kind == "exact" or not (b.is_floating_point() or b.is_complex()):
            same = torch.equal(a, b) if not b.is_floating_point() else \
                bool(((a == b) | (a.isnan() & b.isnan())).all())
            worst = max(worst, float(not same))
            continue
        a, b = a.to(torch.complex128 if b.is_complex() else torch.float64), \
            b.to(torch.complex128 if b.is_complex() else torch.float64)
        fin = torch.isfinite(b)
        if not torch.equal(fin, torch.isfinite(a)) or \
                not torch.equal(a[~fin].nan_to_num(), b[~fin].nan_to_num()):
            return float("inf")
        if fin.any():
            scale = b[fin].abs().max().clamp_min(1e-30)
            worst = max(worst, float((a[fin] - b[fin]).abs().max() / scale))
    return worst


def _recon(name, out):
    """A factorization's product, sign-free (the factors are not)."""
    if name == "lu":
        lu_, piv = out
        p, lo, up = torch.lu_unpack(lu_, piv)
        return [p @ lo @ up]
    if name == "svd":
        u, s, vh = out
        return [(u * s[..., None, :]) @ vh, s]
    if name == "qr":
        q, r = out
        return [q @ r, r.diagonal(0, -2, -1).abs()]
    w, v = out   # eigh
    return [(v * w[..., None, :]) @ v.transpose(-1, -2), w]


def _eig_error(card, cpu):
    """Each card eigenvalue's distance to the nearest CPU one and back,
    of the largest magnitude."""
    w = card[0] if isinstance(card, tuple) else card
    c = cpu[0] if isinstance(cpu, tuple) else cpu
    w = w.detach().cpu().to(torch.complex128)
    c = c.to(torch.complex128)
    dist = (w[..., :, None] - c[..., None, :]).abs()
    err = max(float(dist.min(-1).values.max()),
              float(dist.min(-2).values.max()))
    return err / float(c.abs().max())


def _law_error(card, cpu):
    """0 if the card's draws match the CPU's in law: shape, dtype, range,
    mean within 8 standard errors, std within 3%."""
    a, b = card.detach().cpu().double(), cpu.double()
    if tuple(card.shape) != tuple(cpu.shape) or card.dtype != cpu.dtype:
        return float("inf")
    sd = float(b.std())
    se = max(sd, 1e-3) / a.numel() ** 0.5
    ok = (float(a.min()) >= float(b.min()) - 4 * sd - 1e-6
          and float(a.max()) <= float(b.max()) + 4 * sd + 1e-6
          and abs(float(a.mean()) - float(b.mean())) < 8 * se
          and abs(float(a.std()) - sd) < 0.03 * max(sd, 1e-3))
    return 0.0 if ok else 1.0


OPS_BOUNDS = {"ew": TOL_OPS_EW, "red": TOL_OPS_RED, "bf16": TOL_OPS_BF16,
              "recon": TOL_OPS_RED, "eig": TOL_OPS_RED}


def ops_check(name, kind, call, card_in, cpu_in):
    """One op of ``_ops_table`` on the card and on the CPU: ``(error,
    bound, read the host)``; the card call runs under
    ``set_sync_debug_mode('warn')``, whose warnings mark a host read."""
    import warnings
    from paddle_tpu_torch import linalg as L
    from paddle_tpu_torch import tensor as T
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            card = call(T, L, card_in)
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    cpu = call(T, L, cpu_in)
    host = any("synchroniz" in str(w.message) for w in caught)
    if kind == "recon":
        err = ops_error("red", _recon(name, card), _recon(name, cpu))
    elif kind == "eig":
        err = _eig_error(card, cpu)
    elif kind == "law":
        err = _law_error(card, cpu)
    else:
        err = ops_error(kind, card, cpu)
    return err, OPS_BOUNDS.get(kind, 0.0), host


def phase_tensor_ops(smi):
    """tensor-ops: every public function of ``paddle_tpu_torch.tensor``
    and ``paddle_tpu_torch.linalg`` called on the card and on the CPU
    with the same inputs (``ops_inputs``) and compared: f32 within
    TOL_OPS_EW (elementwise) or TOL_OPS_RED (reductions, products, linear
    algebra) of each output's scale, bf16 within TOL_OPS_BF16, integers,
    booleans and indices equal; factorizations through their
    reconstructions, eigenvalues by matching, random draws in law.  Each
    call runs under ``torch.cuda.set_sync_debug_mode('warn')``: the ops
    that read the host are listed.  One line a module: the count, the
    worst error against its bound, the host-reading ops.  Fails on any op
    over its bound or any public name left uncalled; rows 1-11 launch 0
    times."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import linalg as L
    from paddle_tpu_torch import tensor as T
    t_phase = time.perf_counter()
    problems = []
    zero_launches()
    table = _ops_table()
    called = {n for n, _, _ in table}
    missing = sorted((set(T.__all__) | {f"linalg.{n}" for n in L.__all__})
                     - called)
    if missing:
        problems.append(f"public names left uncalled: {missing}")
    paddle.seed(1234)
    card_in, cpu_in = ops_inputs("cuda"), ops_inputs("cpu")
    # the process's first kernels load lazily, with a sync: not an op's
    ops_check(*table[0], card_in, cpu_in)
    by_module = {}
    mod_of = {n: m for m in ("creation", "math", "manipulation", "logic",
                             "search", "linalg", "random", "attribute",
                             "einsum", "sequence", "array")
              for n in importlib.import_module(
                  f"paddle_tpu_torch.tensor.{m}").__all__}
    for name, kind, call in table:
        key = mod_of.get(name, "linalg" if name.startswith("linalg.")
                         else "helpers")
        rec = by_module.setdefault(key, {"n": set(), "worst": 0.0,
                                         "worst_op": "", "host": set()})
        rec["n"].add(name)
        try:
            err, bound, host = ops_check(name, kind, call, card_in, cpu_in)
        except Exception as e:   # noqa: BLE001  (reported, fails the phase)
            problems.append(f"{name} ({kind}) raised {type(e).__name__}: {e}")
            continue
        if host:
            rec["host"].add(name)
        rel = err / bound if bound else err
        if rel > 1.0:
            problems.append(f"{name} ({kind}): error {err:.3e} over "
                            f"{bound:g}")
        if rel >= rec["worst"]:
            rec["worst"], rec["worst_op"] = rel, f"{name} ({kind}) {err:.3e}"
    launches = read_launches()
    rn_zero_counts("tensor-ops", launches, problems)
    for key, rec in sorted(by_module.items()):
        log(f"[tensor-ops] {key}: {len(rec['n'])} names called; worst "
            f"{rec['worst']:.3f} of its bound ({rec['worst_op']}); synced "
            f"with the host on the card: {sorted(rec['host']) or 'none'}")
    log(f"[tensor-ops] {len(table)} calls of {len(called)} names on the "
        f"card and the CPU; bounds f32 {TOL_OPS_EW} elementwise, "
        f"{TOL_OPS_RED} reductions / linalg, bf16 {TOL_OPS_BF16}, random "
        f"draws in law over {OPS_RANDOM_N}; kernel launches all 0: "
        f"{not any(launches.values())} ({smi}); the phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    finish("tensor-ops", problems)
    return {"tensor-ops": launches}


# ---------------------------------------------------------------------------
# train-ctr and sparse-scale: row-sparse embedding gradients
# ---------------------------------------------------------------------------

# Wide & Deep (Cheng et al. 2016) at PaddleRec's
# models/rank/wide_deep/config.yaml widths
CTR_VOCAB = 1_000_001     # sparse_feature_number
CTR_EMB = 9               # sparse_feature_dim
CTR_SLOTS = 26            # Criteo's categorical slots
CTR_DENSE = 13            # Criteo's integer slots (dense_input_dim)
CTR_FC = (512, 256, 128, 32)
CTR_BATCH = 512
CTR_STEPS = 60
CTR_LR = 0.001
CTR_TWIN_STEPS = 5
TOL_CTR_TWIN = 1e-4       # x max|reference parameter|, per parameter
SCALE_VOCABS = (1_000_000, 10_000_000)
SCALE_DIM, SCALE_BATCH, SCALE_STEPS = 64, 256, 5


def ctr_records(n, seed=1234):
    """Criteo-shaped synthetic records: 13 log-normal dense values and 26
    ids a record; slot s draws Zipf(1.2)-skewed ids into its own hashed
    range of the table (so a batch repeats ids); the click comes from a
    hidden logistic model over the ids and the dense values."""
    rng = np.random.RandomState(seed)
    span = CTR_VOCAB // CTR_SLOTS
    hidden = rng.randn(CTR_VOCAB) * 0.5
    w_dense = rng.randn(CTR_DENSE) * 0.3
    dense = rng.lognormal(0.0, 1.0, (n, CTR_DENSE)).astype(np.float32)
    raw = rng.zipf(1.2, (n, CTR_SLOTS)) - 1
    ids = (raw % span + np.arange(CTR_SLOTS) * span).astype(np.int64)
    logit = hidden[ids].sum(1) + np.log1p(dense) @ w_dense - 1.0
    label = (rng.rand(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    names = [f"C{s + 1}" for s in range(CTR_SLOTS)]
    recs = []
    for r in range(n):
        rec = {"label": [float(label[r])], "dense": dense[r].tolist()}
        for s, name in enumerate(names):
            rec[name] = [int(ids[r, s])]
        recs.append(rec)
    return recs, names


def ctr_batches(n_batches):
    """``n_batches`` batches of the port's ``InMemoryDataset`` (set_records,
    local_shuffle(1234), batch_generator) as ``(ids [B, 26], dense
    [B, 13], label [B, 1])`` host arrays."""
    from paddle_tpu_torch.io import InMemoryDataset
    recs, names = ctr_records(n_batches * CTR_BATCH)
    ds = InMemoryDataset(use_slots=names, dense_slots={"dense": CTR_DENSE},
                         batch_size=CTR_BATCH)
    ds.set_records(recs)
    ds.local_shuffle(seed=1234)
    out = []
    for b in ds.batch_generator(drop_last=True):
        ids = np.concatenate([b[name] for name in names], 1)
        out.append((ids, b["dense"], b["label"][:, :1]))
    return out


def ctr_model(device, sparse=True, seed=1234):
    """Wide & Deep from the port's layers: one table shared by the 26
    slots, the deep MLP over the slots' embeddings and the dense values,
    the wide Linear(13, 1) over the dense values."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn
    paddle.seed(seed)
    net = nn.Layer()
    net.emb = nn.Embedding(CTR_VOCAB, CTR_EMB, sparse=sparse, device=device)
    sizes = (CTR_SLOTS * CTR_EMB + CTR_DENSE,) + CTR_FC + (1,)
    net.deep = nn.LayerList([nn.Linear(a, b, device=device)
                             for a, b in zip(sizes[:-1], sizes[1:])])
    net.wide = nn.Linear(CTR_DENSE, 1, device=device)
    return net


def ctr_forward(net, ids, dense):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.nn import functional as F
    e = paddle.reshape(net.emb(ids), [ids.shape[0], CTR_SLOTS * CTR_EMB])
    h = paddle.concat([e, dense], axis=1)
    for i, fc in enumerate(net.deep):
        h = fc(h)
        if i < len(net.deep) - 1:
            h = F.relu(h)
    return h + net.wide(dense)


def ctr_loss(net, batch, device):
    from paddle_tpu_torch.nn import functional as F
    ids, dense, label = (torch.as_tensor(a).to(device, non_blocking=True)
                         for a in batch)
    return F.binary_cross_entropy_with_logits(ctr_forward(net, ids, dense),
                                              label)


def ctr_twin(make_opt, batches, device, sparse, start):
    """``CTR_TWIN_STEPS`` steps from the parameters ``start`` (a state
    dict); returns the final state on the CPU."""
    net = ctr_model(device, sparse=sparse)
    net.set_state_dict({k: v.to(device) for k, v in start.items()})
    opt = make_opt(net.parameters())
    for b in batches[:CTR_TWIN_STEPS]:
        ctr_loss(net, b, device).backward()
        if sparse and not net.emb.weight.grad.is_sparse:
            raise SystemExit("train-ctr: a twin's table gradient is dense")
        opt.step()
        opt.clear_grad()
    out = {k: v.detach().float().cpu() for k, v in net.state_dict().items()}
    del net, opt
    return out


def twin_error(a, b):
    return max(rel_diff(a[k], b[k]) for k in b)


def phase_train_ctr(smi):
    """train-ctr: Wide & Deep (CTR_* widths) trained eagerly on the card,
    ``Adam(learning_rate=0.001, lazy_mode=True)``, fed CTR_STEPS batches
    of CTR_BATCH synthetic Criteo-shaped records through the port's
    ``InMemoryDataset``: every step's table gradient row-sparse, every
    ``opt.step()`` under ``set_sync_debug_mode('error')`` (the backward's
    host syncs counted under 'warn'), the last 10 losses' mean below the
    first 10's, every row no batch touched bitwise equal to its start;
    5-step twins on the same batches (sparse SGD against dense SGD, sparse
    Adam with ``lazy_mode=False`` against dense Adam, the lazy run on the
    card against the port on the CPU) within TOL_CTR_TWIN; step ms,
    examples/s over the loop's wall, the update's ms, peak memory; rows
    1-11 launch 0 times."""
    import warnings
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import optimizer as topt
    t_phase = time.perf_counter()
    problems = []
    paddle.set_device("gpu")
    t0 = time.perf_counter()
    batches = ctr_batches(CTR_STEPS)
    t_data = time.perf_counter() - t0
    net = ctr_model("cuda")
    start = {k: v.detach().clone() for k, v in net.state_dict().items()}
    table0 = net.emb.weight.detach().clone()
    touched = torch.zeros(CTR_VOCAB, dtype=torch.bool, device="cuda")
    opt = topt.Adam(learning_rate=CTR_LR, parameters=net.parameters(),
                    lazy_mode=True)
    losses, step_ms, upd_ms, backward_syncs = [], [], [], 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    wall0 = time.perf_counter()
    for i, b in enumerate(batches):
        t_step = time.perf_counter()
        ids = torch.as_tensor(b[0]).to("cuda", non_blocking=True)
        touched[ids.reshape(-1)] = True
        loss = ctr_loss(net, b, "cuda")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                loss.backward()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        backward_syncs += sum("synchroniz" in str(w.message) for w in caught)
        if not net.emb.weight.grad.is_sparse:
            problems.append(f"step {i}: the table's gradient is dense")
        ev0, ev1 = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        ev0.record()
        torch.cuda.set_sync_debug_mode("error")
        try:
            opt.step()
        except RuntimeError as e:
            problems.append(f"step {i}: opt.step() synced: {e}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        ev1.record()
        opt.clear_grad()
        losses.append(loss.detach())
        upd_ms.append((ev0, ev1))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t_step) * 1e3)
    wall = time.perf_counter() - wall0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    upd = [a.elapsed_time(b) for a, b in upd_ms]
    losses = [float(v) for v in losses]
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    if not (all(np.isfinite(losses)) and last < first):
        problems.append(f"losses not finite and falling: first 10 {first:.4f}"
                        f", last 10 {last:.4f}")
    untouched = ~touched
    frozen = torch.equal(net.emb.weight.detach()[untouched],
                         table0[untouched])
    n_touched = int(touched.sum())
    if not frozen:
        problems.append("a row no batch touched moved")
    rn_zero_counts("train-ctr", launches, problems)
    log(f"[train-ctr] Wide&Deep {CTR_VOCAB} x {CTR_EMB} table (sparse=True) "
        f"shared by {CTR_SLOTS} slots, MLP {CTR_SLOTS * CTR_EMB + CTR_DENSE} "
        f"-> {' -> '.join(map(str, CTR_FC))} -> 1 + wide Linear({CTR_DENSE}, "
        f"1), B={CTR_BATCH}, lazy Adam lr {CTR_LR}, {CTR_STEPS} steps "
        f"({smi}): loss first 10 {first:.4f}, last 10 {last:.4f}; step ms "
        f"median {float(np.median(step_ms)):.3f} (first {step_ms[0]:.1f}); "
        f"examples/s over the loop's wall {CTR_STEPS * CTR_BATCH / wall:.0f} "
        f"({wall:.2f} s); the update (opt.step, device) median "
        f"{float(np.median(upd)):.3f} ms; peak {peak} bytes; "
        f"{n_touched} rows touched, the other {CTR_VOCAB - n_touched} "
        f"bitwise at their start: {frozen}; opt.step() under "
        f"set_sync_debug_mode('error'): {not any('synced' in p for p in problems)}; "
        f"backward host syncs {backward_syncs} ({backward_syncs / CTR_STEPS:.1f} "
        f"a step); data {t_data:.1f} s")
    del net, opt, table0, touched
    del_all()

    # 5-step twins on the same batches
    def sgd(ps):
        return topt.SGD(learning_rate=0.1, parameters=ps)

    def adam(lazy):
        return lambda ps: topt.Adam(learning_rate=CTR_LR, parameters=ps,
                                    lazy_mode=lazy)

    twins = {
        "sparse SGD vs dense SGD": (
            ctr_twin(sgd, batches, "cuda", True, start),
            ctr_twin(sgd, batches, "cuda", False, start)),
        "sparse Adam lazy_mode=False vs dense Adam": (
            ctr_twin(adam(False), batches, "cuda", True, start),
            ctr_twin(adam(False), batches, "cuda", False, start)),
        "lazy Adam, card vs CPU": (
            ctr_twin(adam(True), batches, "cuda", True, start),
            ctr_twin(adam(True), batches, "cpu", True,
                     {k: v.cpu() for k, v in start.items()})),
    }
    errs = {k: twin_error(a, b) for k, (a, b) in twins.items()}
    for k, e in errs.items():
        if not e <= TOL_CTR_TWIN:
            problems.append(f"twin {k}: {e:.3e} over {TOL_CTR_TWIN}")
    log(f"[train-ctr] {CTR_TWIN_STEPS}-step twins, worst max|diff| / "
        f"max|reference| over the parameters (tol {TOL_CTR_TWIN}): "
        f"{ {k: float(f'{v:.3e}') for k, v in errs.items()} }; the phase "
        f"took {time.perf_counter() - t_phase:.1f} s")
    del twins, start, batches
    del_all()
    finish("train-ctr", problems)
    return {"train-ctr": launches}


def phase_sparse_scale(smi):
    """sparse-scale: a SCALE_DIM-wide embedding of each of SCALE_VOCABS
    rows (the JAX package's million-row case, and ten times it), a batch
    of SCALE_BATCH ids, MSE against a target: SCALE_STEPS lazy sparse
    Adam steps against SCALE_STEPS dense ones (after a warm-up step each),
    wall ms a step after a device sync; fails unless the sparse step is
    the faster at the largest table."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn, optimizer as topt
    from paddle_tpu_torch.nn import functional as F
    t_phase = time.perf_counter()
    problems, rows = [], {}
    zero_launches()
    rng = np.random.RandomState(0)
    for vocab in SCALE_VOCABS:
        ids = torch.as_tensor(rng.randint(0, vocab, (SCALE_BATCH,))).cuda()
        tgt = torch.as_tensor(rng.randn(SCALE_BATCH, SCALE_DIM)
                              .astype(np.float32)).cuda()
        for sparse in (True, False):
            paddle.seed(0)
            torch.cuda.reset_peak_memory_stats()
            emb = nn.Embedding(vocab, SCALE_DIM, sparse=sparse, device="cuda")
            opt = topt.Adam(learning_rate=0.01, parameters=emb.parameters(),
                            lazy_mode=True)

            def step():
                F.mse_loss(emb(ids), tgt).backward()
                opt.step()
                opt.clear_grad()
            step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(SCALE_STEPS):
                step()
            torch.cuda.synchronize()
            rows[(vocab, sparse)] = (time.perf_counter() - t0) * 1e3 \
                / SCALE_STEPS
            rows[(vocab, sparse, "peak")] = torch.cuda.max_memory_allocated()
            del emb, opt
            del_all()
    for vocab in SCALE_VOCABS:
        log(f"[sparse-scale] {vocab} x {SCALE_DIM} f32 table, {SCALE_BATCH} "
            f"ids, Adam lazy_mode: sparse {rows[(vocab, True)]:.3f} ms a step "
            f"(peak {rows[(vocab, True, 'peak')]} bytes), dense "
            f"{rows[(vocab, False)]:.3f} ms (peak "
            f"{rows[(vocab, False, 'peak')]} bytes): "
            f"{rows[(vocab, False)] / rows[(vocab, True)]:.1f}x ({smi})")
    big = SCALE_VOCABS[-1]
    if not rows[(big, True)] < rows[(big, False)]:
        problems.append(f"the sparse step is not the faster at {big} rows")
    launches = read_launches()
    rn_zero_counts("sparse-scale", launches, problems)
    log(f"[sparse-scale] the phase took {time.perf_counter() - t_phase:.1f} s")
    finish("sparse-scale", problems)
    return {"sparse-scale": launches}


# ---------------------------------------------------------------------------
# Recurrent layers, the attention seq2seq and the C training entry
# ---------------------------------------------------------------------------
# PaddleNLP's machine-translation example (examples/machine_translation/
# seq2seq, IWSLT'15 English-Vietnamese): 2-layer LSTM encoder and decoder,
# hidden and embedding 512, batch 128, dropout 0.2, init_scale 0.1,
# max_grad_norm 5.0, Adam at 0.001, beam 10; vocabularies 17191 (en) and
# 7709 (vi).  The corpus is not in the repo: the phases feed WMT16's
# synthetic pairs (ids below 7709 fit both tables), 50 tokens a side
S2S_SRC_VOCAB, S2S_TRG_VOCAB = 17191, 7709
S2S_HIDDEN, S2S_LAYERS, S2S_B, S2S_T = 512, 2, 128, 50
S2S_DROPOUT, S2S_INIT, S2S_CLIP, S2S_LR = 0.2, 0.1, 5.0, 0.001
S2S_EPOCHS, S2S_BEAM, S2S_MAX_STEP = 10, 10, 50
S2S_BOS, S2S_EOS = 0, 1


def seq2seq_model(paddle, src_vocab=S2S_SRC_VOCAB, trg_vocab=S2S_TRG_VOCAB,
                  hidden=S2S_HIDDEN, layers=S2S_LAYERS, dropout=S2S_DROPOUT,
                  init_scale=S2S_INIT, eos_id=S2S_EOS):
    """``(model, criterion)`` of PaddleNLP's ``seq2seq_attn.py``
    (``Seq2SeqAttnModel``, ``CrossEntropyCriterion``), written with
    ``paddle``'s public API only, so that either package builds it: an
    LSTM encoder; a decoder ``nn.RNN`` over a cell that feeds the last
    attentional output back in (input feeding) through a stack of
    ``LSTMCell``s and Luong attention (``input_proj``, scores over the
    encoder outputs with padding masked, ``output_proj`` of [context,
    hidden]); embeddings and projections drawn from Uniform(-init_scale,
    init_scale).  The encoder memory reaches the cell as its ``memory``
    attribute (the JAX ``RNN`` passes no keywords to its cell).  The
    criterion sums over time the batch mean of the masked token
    cross-entropy, the mask keeping each target up to and including its
    first EOS.  ``model.beam_search(src, beam, max_step_num)`` runs
    ``nn.BeamSearchDecoder`` / ``nn.dynamic_decode`` over the cell with
    the memory tiled by ``tile_beam_merge_with_batch``."""
    nn = paddle.nn
    F = nn.functional
    uniform = nn.initializer.Uniform(-init_scale, init_scale)

    class AttentionLayer(nn.Layer):
        def __init__(self):
            super().__init__()
            self.input_proj = nn.Linear(hidden, hidden, weight_attr=uniform,
                                        bias_attr=False)
            self.output_proj = nn.Linear(2 * hidden, hidden,
                                         weight_attr=uniform,
                                         bias_attr=False)

        def forward(self, h, enc_out, enc_mask):
            mem = self.input_proj(enc_out)
            scores = paddle.matmul(paddle.unsqueeze(h, [1]), mem,
                                   transpose_y=True) + enc_mask
            ctx = paddle.squeeze(paddle.matmul(F.softmax(scores, axis=-1),
                                               mem), [1])
            return self.output_proj(paddle.concat([ctx, h], axis=1))

    class DecoderCell(nn.RNNCellBase):
        def __init__(self):
            super().__init__()
            self.hidden_size = hidden
            self.dropout = nn.Dropout(dropout)
            self.lstm_cells = nn.LayerList([
                nn.LSTMCell(2 * hidden if i == 0 else hidden, hidden)
                for i in range(layers)])
            self.attention_layer = AttentionLayer()
            self.memory = None

        def forward(self, step_input, states):
            lstm_states, input_feed = states
            enc_out, enc_mask = self.memory
            x = paddle.concat([step_input, input_feed], axis=1)
            new_states = []
            for i, cell in enumerate(self.lstm_cells):
                out, st = cell(x, lstm_states[i])
                x = self.dropout(out)
                new_states.append(st)
            out = self.attention_layer(x, enc_out, enc_mask)
            return out, [new_states, out]

    class Encoder(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embedder = nn.Embedding(src_vocab, hidden,
                                         weight_attr=uniform)
            self.lstm = nn.LSTM(hidden, hidden, num_layers=layers,
                                dropout=dropout if layers > 1 else 0.0)

        def forward(self, src):
            return self.lstm(self.embedder(src))

    class Decoder(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embedder = nn.Embedding(trg_vocab, hidden,
                                         weight_attr=uniform)
            self.lstm_attention = nn.RNN(DecoderCell())
            self.output_layer = nn.Linear(hidden, trg_vocab,
                                          weight_attr=uniform,
                                          bias_attr=False)

        def forward(self, trg, init_states, enc_out, enc_mask):
            self.lstm_attention.cell.memory = (enc_out, enc_mask)
            out, _ = self.lstm_attention(self.embedder(trg),
                                         initial_states=init_states)
            return self.output_layer(out)

    class Seq2SeqAttnModel(nn.Layer):
        def __init__(self):
            super().__init__()
            self.encoder = Encoder()
            self.decoder = Decoder()

        def initial_states(self, enc_out, state):
            h, c = state
            feed = self.decoder.lstm_attention.cell.get_initial_states(
                batch_ref=enc_out, shape=[hidden])
            return [[(h[i], c[i]) for i in range(layers)], feed]

        def padding_mask(self, src):
            keep = paddle.cast(src != eos_id, "float32")
            return paddle.unsqueeze((keep - 1.0) * 1e9, [1])

        def forward(self, src, trg):
            enc_out, state = self.encoder(src)
            return self.decoder(trg, self.initial_states(enc_out, state),
                                enc_out, self.padding_mask(src))

        def beam_search(self, src, beam_size, max_step_num, bos_id=S2S_BOS):
            enc_out, state = self.encoder(src)
            init = self.initial_states(enc_out, state)
            tile = nn.BeamSearchDecoder.tile_beam_merge_with_batch
            cell = self.decoder.lstm_attention.cell
            cell.memory = (tile(enc_out, beam_size),
                           tile(self.padding_mask(src), beam_size))
            dec = nn.BeamSearchDecoder(
                cell, bos_id, eos_id, beam_size,
                embedding_fn=self.decoder.embedder,
                output_fn=self.decoder.output_layer)
            return nn.dynamic_decode(dec, inits=init,
                                     max_step_num=max_step_num)

    class CrossEntropyCriterion(nn.Layer):
        def forward(self, predict, label):
            cost = F.cross_entropy(predict, label, reduction="none")
            is_eos = paddle.cast(label == eos_id, "float32")
            mask = paddle.cast(paddle.cumsum(is_eos, axis=1) - is_eos < 0.5,
                               "float32")
            return paddle.sum(paddle.mean(cost * mask, axis=[0]))

    return Seq2SeqAttnModel(), CrossEntropyCriterion()


# tolerances of the recurrent phases, stated before measuring.  cuDNN
# runs f32 RNNs in TF32 (torch.backends.cudnn.allow_tf32, True by
# default): each product's inputs keep 10 mantissa bits (2^-11 relative),
# so a 512-wide gate sum carries about 2^-11 x sqrt(1024) of one term;
# the recurrences through sigmoid and tanh are contractive, so over 50
# steps the error stays near one step's.  Per tensor, x max|CPU value|:
TOL_RNN_F32 = 1e-2
# under auto_cast the RNN runs in bf16 on both sides (8 mantissa bits),
# each product and state rounded where the two implementations choose
TOL_RNN_BF16 = 5e-2
# nn.LSTM (cuDNN, TF32) against a stack of RNN(LSTMCell) on the card
# (cuBLAS f32 products): the TF32 rounding alone
TOL_RNN_CELLS = 1e-2
# the seq2seq's logits on the card against the CPU from the same weights,
# per row, x max|CPU logit| of the row: the encoder LSTM in TF32, the rest
# f32 in another order of sums
TOL_S2S_FWD = 1e-2
# each beam's score against the same ids rescored by the teacher-forced
# forward on the card: the same cell ops at the same width, the encoder
# at another batch (B x beam rows), relative to |score|
TOL_S2S_BEAM = 1e-4
# the exported Transformer-base step from C against the live trainer, per
# step, relative (tests/test_capi_train.py's bound)
TOL_C_TRAINER = 1e-4
RNN_B, RNN_T, RNN_IN, RNN_H, RNN_LAYERS = 128, 50, 512, 512, 2
RNN_CPU_ROWS = 16          # batch rows held against the CPU
S2S_CPU_ROWS = 4           # source rows of the CPU forward and search
C_STEPS = 10
# c-trainer's encoder and decoder depth: Transformer-base's 6 + 6 cut to
# 2 + 2, since the export and PD_NewTrainer's load scale with the graph
# (the widths, the batch and every check stay)
C_LAYERS = 2


def rnn_twins(mode, direction, cpu_rows=RNN_CPU_ROWS):
    """``nn.<mode>(512, 512, 2 layers, direction)`` on the card and its
    CPU twin with the same weights."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn
    paddle.seed(1234)
    paddle.set_device("gpu")
    card = getattr(nn, mode)(RNN_IN, RNN_H, num_layers=RNN_LAYERS,
                             direction=direction)
    paddle.set_device("cpu")
    cpu = getattr(nn, mode)(RNN_IN, RNN_H, num_layers=RNN_LAYERS,
                            direction=direction)
    cpu.set_state_dict({k: v.detach().cpu()
                        for k, v in card.state_dict().items()})
    paddle.set_device("gpu")
    return card, cpu


def scale_error(got, ref):
    """max|got - ref| / max|ref| (f32 on the host)."""
    got, ref = got.detach().float().cpu(), ref.detach().float().cpu()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def phase_rnn_layers(smi):
    """rnn-layers: ``nn.LSTM``, ``nn.GRU`` and ``nn.SimpleRNN`` at 2 layers
    x 512 on ``[128, 50, 512]``, forward and bidirectional: outputs and
    final states on the card against the CPU twin (the first RNN_CPU_ROWS
    rows) in f32 (cuDNN's TF32 on, as by default; TOL_RNN_F32) and under
    ``auto_cast`` bf16 (TOL_RNN_BF16); ``nn.LSTM`` against a stack of
    ``RNN(LSTMCell)`` with its weights on the card (TOL_RNN_CELLS); the
    warnings cuDNN gives about weights outside one buffer counted; one
    bf16 LSTM forward profiled for its kernels' names; the parameters
    in one buffer a layer, and the ms ``auto_cast`` adds to a call to
    cast and move them into cuDNN's layout; forward and
    forward + backward ms a call; rows 1-11 launch 0 times."""
    import warnings
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn
    t_phase = time.perf_counter()
    problems = []
    zero_launches()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(RNN_B, RNN_T, RNN_IN, generator=g)
    xc = x.cuda()
    log(f"[rnn-layers] {smi}: torch.backends.cudnn.allow_tf32 = "
        f"{torch.backends.cudnn.allow_tf32}, enabled = "
        f"{torch.backends.cudnn.enabled}, cuDNN "
        f"{torch.backends.cudnn.version()}")
    rows = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for mode in ("LSTM", "GRU", "SimpleRNN"):
            for direction in ("forward", "bidirect"):
                card, cpu = rnn_twins(mode, direction)
                errs = {}
                for amp in (False, True):
                    ctx = paddle.amp.auto_cast(dtype="bfloat16") if amp \
                        else contextlib.nullcontext()
                    with torch.no_grad(), ctx:
                        out, st = card(xc)
                        ref, ref_st = cpu(x[:RNN_CPU_ROWS])
                    want = "bfloat16" if amp else "float32"
                    if str(out.dtype) != f"torch.{want}":
                        problems.append(f"{mode} {direction} amp={amp}: "
                                        f"output {out.dtype}")
                    got = [out[:RNN_CPU_ROWS]] + [
                        s[:, :RNN_CPU_ROWS] for s in
                        (st if isinstance(st, tuple) else (st,))]
                    refs = [ref] + list(ref_st if isinstance(ref_st, tuple)
                                        else (ref_st,))
                    errs[want] = max(scale_error(a, b)
                                     for a, b in zip(got, refs))
                    tol = TOL_RNN_BF16 if amp else TOL_RNN_F32
                    if not errs[want] <= tol:
                        problems.append(f"{mode} {direction} {want}: "
                                        f"{errs[want]:.3e} > {tol}")
                fwd_ms = cuda_ms(lambda: card(xc), iters=5, warmup=2)
                xg = xc.clone().requires_grad_(True)

                def fwd_bwd():
                    o, _ = card(xg)
                    o.sum().backward()
                fb_ms = cuda_ms(fwd_bwd, iters=5, warmup=2)
                card.clear_gradients()
                rows.append((mode, direction, errs, fwd_ms, fb_ms))
                log(f"[rnn-layers] {mode} {direction}: card vs CPU max "
                    f"error / max|CPU| f32 {errs['float32']:.3e} (tol "
                    f"{TOL_RNN_F32}), bf16 {errs['bfloat16']:.3e} (tol "
                    f"{TOL_RNN_BF16}); forward {fwd_ms:.3f} ms, forward + "
                    f"backward {fb_ms:.3f} ms a call (CUDA events, f32)")
                del card, cpu
        # nn.LSTM against RNN(LSTMCell) stacks with its weights
        for direction in ("forward", "bidirect"):
            card, _ = rnn_twins("LSTM", direction)
            nd = 2 if direction == "bidirect" else 1
            stack = []
            for layer in range(RNN_LAYERS):
                cells = []
                for d in range(nd):
                    sfx = f"_l{layer}" + ("_reverse" if d else "")
                    cell = nn.LSTMCell(RNN_IN if layer == 0 else
                                       RNN_H * nd, RNN_H)
                    cell.set_state_dict({
                        k: getattr(card, k + sfx).detach()
                        for k in ("weight_ih", "weight_hh", "bias_ih",
                                  "bias_hh")})
                    cells.append(cell)
                stack.append(nn.BiRNN(*cells) if nd == 2
                             else nn.RNN(cells[0]))
            with torch.no_grad():
                want, _ = card(xc)
                h = xc
                for rnn in stack:
                    h, _ = rnn(h)
            err = scale_error(h, want)
            log(f"[rnn-layers] nn.LSTM {direction} vs a stack of "
                f"RNN(LSTMCell) on the card: {err:.3e} (tol "
                f"{TOL_RNN_CELLS})")
            if not err <= TOL_RNN_CELLS:
                problems.append(f"LSTM {direction} vs cells {err:.3e}")
            del card, stack
    flat = [str(w.message)[:80] for w in caught
            if "contiguous chunk" in str(w.message)]
    log(f"[rnn-layers] warnings about weights outside one buffer: "
        f"{len(flat)} {flat[:1]}")
    # which kernels run a bf16 LSTM
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    card, _ = rnn_twins("LSTM", "bidirect")
    with torch.no_grad(), paddle.amp.auto_cast(dtype="bfloat16"):
        card(xc)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            card(xc)
            torch.cuda.synchronize()
    top = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: -e.self_device_time_total)[:4]
    top = [(e.key[:70], round(e.self_device_time_total / 1e3, 3))
           for e in top]
    log(f"[rnn-layers] bf16 LSTM bidirect forward's top kernels (device "
        f"ms): {top}")
    # the f32 parameters move into cuDNN's layout at their first f32 call
    # and stay; an auto_cast call moves its bf16 copies on every call
    # (``_RNNBase._flatten``), timed in turns against leaving them to
    # cuDNN's own copy (which warns)
    with torch.no_grad():
        card(xc)
    one = len({p.untyped_storage().data_ptr() for p in card.parameters()})

    def amp_forward():
        with torch.no_grad(), paddle.amp.auto_cast(dtype="bfloat16"):
            card(xc)
    turns = {"moved": [], "copied": []}
    for _ in range(2):
        turns["moved"].append(cuda_ms(amp_forward, iters=10, warmup=2))
        card._flatten = lambda weights, input_size: None
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            turns["copied"].append(cuda_ms(amp_forward, iters=10,
                                           warmup=2))
        del card._flatten
    log(f"[rnn-layers] {smi}: LSTM bidirect's {RNN_LAYERS} layers hold their "
        f"parameters in {one} buffers after an f32 call; a bf16 auto_cast "
        f"forward (CUDA events, ms a call, two turns each): its weight "
        f"copies moved into cuDNN's layout first "
        f"{[round(t, 4) for t in turns['moved']]}, left to cuDNN's own "
        f"copy {[round(t, 4) for t in turns['copied']]}")
    if one != RNN_LAYERS:
        problems.append(f"LSTM parameters in {one} buffers")
    del card
    launches = read_launches()
    rn_zero_counts("rnn-layers", launches, problems)
    del_all()
    log(f"[rnn-layers] the phase took {time.perf_counter() - t_phase:.1f} s")
    finish("rnn-layers", problems)
    return {"rnn-layers": launches}


# the trained seq2seq, handed from train-seq2seq to beam-seq2seq
_S2S = {}


def phase_train_seq2seq(smi):
    """train-seq2seq: the attention seq2seq (``seq2seq_model``, PaddleNLP's
    IWSLT'15 widths) through ``Model.fit`` on a ``DataLoader`` over
    ``text.WMT16(mode='train', src_dict_size=7709, seq_len=50)`` (256
    pairs: 2 batches of 128), ``Adam(0.001)`` with
    ``ClipGradByGlobalNorm(5.0)``, dropout 0.2, S2S_EPOCHS epochs: finite
    losses, the last 5's mean below the first 5's; step and period ms,
    target tokens/s, peak memory, one profiled step's kernels and idle
    share; then one eval forward on the card against the CPU twin on
    S2S_CPU_ROWS rows within TOL_S2S_FWD of each row's logit scale; rows
    1-11 launch 0 times."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn
    t_phase = time.perf_counter()
    problems = []
    paddle.set_device("gpu")
    paddle.seed(1234)
    model, crit = seq2seq_model(paddle)
    n_params = sum(p.numel() for p in model.parameters())
    init_state = {k: v.detach().clone() for k, v in
                  model.state_dict().items()}
    opt = paddle.optimizer.Adam(
        learning_rate=S2S_LR, parameters=model.parameters(),
        grad_clip=nn.ClipGradByGlobalNorm(S2S_CLIP))
    m = paddle.Model(model)
    m.prepare(opt, crit)
    data = paddle.text.WMT16(mode="train", src_dict_size=S2S_TRG_VOCAB,
                             seq_len=S2S_T)
    steps = S2S_EPOCHS * len(data) // S2S_B
    rec = tb_step_recorder(profile_step=steps - 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    m.fit(data, batch_size=S2S_B, epochs=S2S_EPOCHS, shuffle=False,
          verbose=0, callbacks=[rec])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = read_launches()
    rn_zero_counts("train-seq2seq", launches, problems)
    losses = rec.losses
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    if len(losses) != steps or not np.all(np.isfinite(losses)) or \
            not last < first:
        problems.append(f"losses not finite and falling: {losses}")
    timing = tb_timing_line(rec, steps, wall, per_step=S2S_B * S2S_T)
    log(f"[train-seq2seq] {smi}: attention seq2seq {n_params / 1e6:.2f} M "
        f"params f32 (vocab {S2S_SRC_VOCAB} / {S2S_TRG_VOCAB}, hidden "
        f"{S2S_HIDDEN}, {S2S_LAYERS} layers, dropout {S2S_DROPOUT}), "
        f"{S2S_B} x {S2S_T} + {S2S_B} x {S2S_T} tokens, Adam {S2S_LR}, "
        f"global-norm clip {S2S_CLIP}: {steps} steps; losses "
        f"{[round(x, 3) for x in losses]} (first 5 mean {first:.3f}, last "
        f"5 {last:.3f}); {timing}; max_memory_allocated {peak} bytes")
    # one forward on the card against the CPU from the same weights
    src = torch.as_tensor(data.src[:S2S_CPU_ROWS])
    trg = torch.as_tensor(data.trg[:S2S_CPU_ROWS])
    paddle.set_device("cpu")
    paddle.seed(1234)
    cpu_model, _ = seq2seq_model(paddle)
    cpu_model.set_state_dict({k: v.detach().cpu()
                              for k, v in model.state_dict().items()})
    paddle.set_device("gpu")
    model.eval()
    cpu_model.eval()
    with torch.no_grad():
        got = model(src.cuda(), trg.cuda())
        want = cpu_model(src, trg)
    err = row_scale_error(got.cpu(), want)
    log(f"[train-seq2seq] eval forward on {S2S_CPU_ROWS} rows, card vs CPU: "
        f"max row error {err:.3e} of the row's max |logit| (tol "
        f"{TOL_S2S_FWD}; cuDNN TF32 {torch.backends.cudnn.allow_tf32})")
    if not err <= TOL_S2S_FWD:
        problems.append(f"card vs CPU forward {err:.3e}")
    _S2S.update(model=model, cpu_model=cpu_model, init_state=init_state,
                src=torch.as_tensor(data.src[:S2S_B]))
    del m, opt, got, want
    del_all()
    log(f"[train-seq2seq] the phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    finish("train-seq2seq", problems)
    return {"train-seq2seq": launches}


def s2s_rescore(model, src, ids, lengths):
    """Each beam's summed log-probabilities of its ids (up to its length)
    under one teacher-forced forward of the model: ``[B, K]``."""
    b, t, k = ids.shape
    beams = ids.permute(0, 2, 1).reshape(b * k, t).long()
    trg = torch.cat([torch.full_like(beams[:, :1], S2S_BOS),
                     beams[:, :-1]], 1)
    with torch.no_grad():
        logits = model(torch.repeat_interleave(src, k, dim=0), trg)
        logp = torch.log_softmax(logits.float(), -1)
    tok = logp.gather(-1, beams[..., None])[..., 0]
    keep = torch.arange(t, device=ids.device)[None] < \
        lengths.reshape(b * k, 1)
    return (tok * keep).sum(-1).reshape(b, k)


def s2s_search(tag, model, cpu_model, src, smi, problems):
    """One beam search of ``model`` over ``src`` on the card (timed,
    steps and host reads counted), each beam's score against the
    teacher-forced rescoring (TOL_S2S_BEAM), and the top beams of the
    first S2S_CPU_ROWS sources against the same search of ``cpu_model``
    (the card's search of those rows rerun with cuDNN's TF32 off, so that
    both sides take f32 products).  Returns the kernel launches."""
    cell = model.decoder.lstm_attention.cell
    forward = cell.forward
    calls = []

    def counted(*a, **k):
        calls.append(1)
        return forward(*a, **k)
    cell.forward = counted
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad(), HostReads(device_only=True) as reads:
        ids, scores = model.beam_search(src.cuda(), S2S_BEAM, S2S_MAX_STEP)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cell.forward = forward
    launches = read_launches()
    steps = len(calls)
    eos_hit = ids == S2S_EOS
    lengths = torch.where(eos_hit.any(1), eos_hit.int().argmax(1) + 1,
                          torch.full_like(eos_hit[:, 0], ids.shape[1],
                                          dtype=torch.int64))
    rescored = s2s_rescore(model, src.cuda(), ids, lengths)
    rel = float(((scores - rescored).abs() / rescored.abs()).max())
    shape_ok = tuple(ids.shape) == (S2S_B, S2S_MAX_STEP, S2S_BEAM) and \
        bool((scores[:, :-1] >= scores[:, 1:]).all())
    if not (shape_ok and rel <= TOL_S2S_BEAM):
        problems.append(f"{tag}: beam scores vs rescoring {rel:.3e}, shapes "
                        f"{tuple(ids.shape)}")
    rows = src[:S2S_CPU_ROWS]
    with torch.no_grad(), torch.backends.cudnn.flags(allow_tf32=False):
        fids, fscores = model.beam_search(rows.cuda(), S2S_BEAM,
                                          S2S_MAX_STEP)
    with torch.no_grad():
        cids, cscores = cpu_model.beam_search(rows, S2S_BEAM, S2S_MAX_STEP)
    top_equal = torch.equal(fids[:, :, 0].cpu(), cids[:, :, 0])
    if not top_equal:
        problems.append(f"{tag}: top beams differ from the CPU search")
    top = lengths[:, 0].tolist()
    log(f"[beam-seq2seq] {tag}, {smi}: beam {S2S_BEAM} over {S2S_B} sources "
        f"({S2S_B * S2S_BEAM} rows), {steps} steps in {wall:.3f} s: "
        f"{wall / steps * 1e3:.3f} ms a step (host clock), host reads "
        f"{reads.n} ({reads.n / steps:.2f} a step); top beams' lengths "
        f"min {min(top)} median {int(np.median(top))} max {max(top)}; "
        f"scores vs teacher-forced rescoring worst {rel:.3e} (tol "
        f"{TOL_S2S_BEAM}); top beams of {S2S_CPU_ROWS} sources (TF32 off) "
        f"equal to the CPU search: {top_equal} (card scores "
        f"{[round(x, 4) for x in fscores[:, 0].tolist()]}, CPU "
        f"{[round(x, 4) for x in cscores[:, 0].tolist()]})")
    return launches


def phase_beam_seq2seq(smi):
    """beam-seq2seq: train-seq2seq's model decoding one batch of 128
    sources with ``nn.BeamSearchDecoder`` at beam S2S_BEAM and
    ``nn.dynamic_decode(max_step_num=S2S_MAX_STEP)`` over its LSTMCell
    stack (1 280 rows), checked by ``s2s_search``.  After 20 steps on
    WMT16's synthetic targets (EOS, 1 in 50 of them, is their most
    frequent id) the trained model ends its beams within a few steps; the
    same search then runs on the model's weights from before training,
    whose beams run to S2S_MAX_STEP.  Rows 1-11 launch 0 times."""
    import paddle_tpu_torch as paddle
    t_phase = time.perf_counter()
    problems = []
    model, cpu_model, src = _S2S["model"], _S2S["cpu_model"], _S2S["src"]
    model.eval()
    cpu_model.eval()
    total = {}
    add_launches(total, s2s_search("trained", model, cpu_model, src, smi,
                                   problems))
    with torch.no_grad():
        model.set_state_dict(_S2S["init_state"])
        cpu_model.set_state_dict({k: v.cpu() for k, v in
                                  _S2S["init_state"].items()})
    add_launches(total, s2s_search("at init", model, cpu_model, src, smi,
                                   problems))
    rn_zero_counts("beam-seq2seq", total, problems)
    _S2S.clear()
    del model, cpu_model
    del_all()
    paddle.set_device("gpu")
    log(f"[beam-seq2seq] the phase took {time.perf_counter() - t_phase:.1f} s")
    finish("beam-seq2seq", problems)
    return {"beam-seq2seq": total}


def c_trainer_lib():
    """``libpd_inference.so`` built with ``cc`` and bound with ctypes for
    the trainer entry."""
    import ctypes
    from paddle_tpu_torch.inference.capi import build as capi_build
    lib = ctypes.CDLL(capi_build.build_library())
    lib.PD_NewTrainer.restype = ctypes.c_void_p
    lib.PD_NewTrainer.argtypes = [ctypes.c_char_p]
    lib.PD_TrainerStep.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int32,
                                   ctypes.POINTER(ctypes.c_float)]
    lib.PD_DeleteTrainer.argtypes = [ctypes.c_void_p]
    lib.PD_GetLastError.restype = ctypes.c_char_p
    return lib


def c_batch(arrays):
    """A ctypes ``PD_Tensor`` array over host numpy arrays (kept alive by
    the caller)."""
    import ctypes

    class PDTensor(ctypes.Structure):
        _fields_ = [("data", ctypes.c_void_p),
                    ("shape", ctypes.c_int64 * 8),
                    ("ndim", ctypes.c_int32),
                    ("dtype", ctypes.c_char * 16)]
    out = (PDTensor * len(arrays))()
    for t, a in zip(out, arrays):
        t.data = a.ctypes.data_as(ctypes.c_void_p)
        t.ndim = a.ndim
        for i, n in enumerate(a.shape):
            t.shape[i] = n
        t.dtype = a.dtype.name.encode()
    return out


def tb_trainer(dropout, layers=TB_LAYERS):
    """Transformer-base (``tb_network(dropout, layers)``, seed 1234) in
    ``SpmdTrainer`` under ``strategy.amp`` (bf16 copies of the f32
    masters) with ``tb_model``'s Adam on Noam's peak rate and the smoothed
    cross-entropy."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import SpmdTrainer
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    paddle.set_device("gpu")
    paddle.seed(1234)
    net = tb_network(dropout, layers)
    sched = paddle.optimizer.lr.NoamDecay(d_model=512, warmup_steps=4000,
                                          last_epoch=3999)
    opt = paddle.optimizer.Adam(learning_rate=sched, beta1=0.9, beta2=0.98,
                                epsilon=1e-9, parameters=net.parameters())
    st = DistributedStrategy()
    st.amp = True
    return SpmdTrainer(net, opt, tb_loss(), strategy=st)


def c_train_demo(base):
    """``pd_capi_train_demo`` (built with ``cc``) started on the JAX
    demo's regression net (Linear(6, 16), ReLU, Linear(16, 1), Adam 0.02,
    MSE), exported on the card under ``base``; returns the running
    process (20 steps, CAPI-TRAIN-OK when the loss fell)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import SpmdTrainer
    from paddle_tpu_torch.inference.capi import build as capi_build
    paddle.set_device("gpu")
    paddle.seed(0)
    reg = nn.Sequential(nn.Linear(6, 16), nn.ReLU(), nn.Linear(16, 1))
    opt = paddle.optimizer.Adam(learning_rate=0.02,
                                parameters=reg.parameters())
    tr = SpmdTrainer(reg, opt, lambda o, y: nn.functional.mse_loss(o, y))
    x = np.random.RandomState(0).randn(8, 6).astype(np.float32)
    path = os.path.join(base, "reg")
    tr.export_train_step(path, x, x.sum(1, keepdims=True))
    exe = capi_build.build_demo(source="capi_train_demo.c")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__))] +
        [p for p in sys.path if p])
    env.pop("PD_INFERENCE_DEVICE", None)
    # its output to files, so that no pipe fills while nobody reads it
    with open(os.path.join(base, "demo.out"), "w") as out, \
            open(os.path.join(base, "demo.err"), "w") as err:
        return subprocess.Popen([exe, path, "6", "8"], env=env, stdout=out,
                                stderr=err)


def tb_export(dropout, path, batch):
    """``tb_trainer(dropout, C_LAYERS)``'s step exported to ``path`` on
    ``batch`` (source, target, label); returns ``(seconds, file
    sizes)``."""
    src, tgt, lab = batch
    tr = tb_trainer(dropout, C_LAYERS)
    t0 = time.perf_counter()
    tr.export_train_step(path, (src, tgt), lab)
    seconds = time.perf_counter() - t0
    del tr
    del_all()
    return seconds, {ext: os.path.getsize(path + ext)
                     for ext in (".pdtrain", ".pdtrainstate")}


def phase_c_trainer(smi):
    """c-trainer: ``SpmdTrainer.export_train_step`` on Transformer-base
    at C_LAYERS encoder and decoder layers (bf16 AMP, train-transformer's
    seed, widths and batches), stepped from C through ``PD_NewTrainer`` /
    ``PD_TrainerStep`` (``libpd_inference.so`` by ctypes).  At dropout 0:
    C_STEPS C steps on C_STEPS batches against a live trainer of the same
    depth from the same weights over the same batches within
    TOL_C_TRAINER a step, rows 1-3 2 x C_LAYERS launches a step each.  At
    the model's dropout 0.1: C_STEPS C steps (5 batches twice), the last
    5 losses' mean below the first 5's, the dropout forms 2 x C_LAYERS
    launches a step each.  The export's seconds, the files' bytes and the C step ms; and
    ``pd_capi_train_demo`` (``c_train_demo``, in its own process beside
    the rest) prints CAPI-TRAIN-OK."""
    import ctypes
    t_phase = time.perf_counter()
    problems = []
    lib = c_trainer_lib()
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_ctrainer")
    # the C demo runs in its own process beside the Transformer-base runs
    demo, t_demo0 = c_train_demo(base), time.perf_counter()
    try:
        data = tb_data(C_STEPS * TB_B, 1234)
        src_all, tgt_all, lab_all = data.tensors
        batches = [tuple(np.ascontiguousarray(a[i * TB_B:(i + 1) * TB_B])
                         for a in (src_all, tgt_all, lab_all))
                   for i in range(C_STEPS)]
        total = {}
        for dropout in (0.0, 0.1):
            tag = f"p={dropout}"
            path = os.path.join(base, f"tb_p{dropout}")
            t_export, sizes = tb_export(dropout, path, batches[0])
            t0 = time.perf_counter()
            handle = lib.PD_NewTrainer(path.encode())
            t_load = time.perf_counter() - t0
            if not handle:
                raise SystemExit(f"c-trainer: PD_NewTrainer failed: "
                                 f"{lib.PD_GetLastError()}")
            order = list(range(C_STEPS)) if dropout == 0.0 else \
                [i % 5 for i in range(C_STEPS)]
            losses, ms = [], []
            loss = ctypes.c_float()
            zero_launches()
            for i in order:
                arrays = batches[i]
                ct = c_batch(arrays)
                t0 = time.perf_counter()
                if lib.PD_TrainerStep(handle, ct, 3, ctypes.byref(loss)) != 0:
                    raise SystemExit(f"c-trainer: PD_TrainerStep failed: "
                                     f"{lib.PD_GetLastError()}")
                ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(loss.value)
            c_launches = read_launches()
            lib.PD_DeleteTrainer(handle)
            add_launches(total, c_launches)
            form = "" if dropout == 0.0 else "_dropout"
            want = {f"{k}{form}": 2 * C_LAYERS * C_STEPS for k in FLASH}
            counts = jit_counts(f"c-trainer {tag}", c_launches, want, problems)
            if not np.all(np.isfinite(losses)):
                problems.append(f"{tag}: losses {losses}")
            line = (f"[c-trainer] {smi}: Transformer-base at {C_LAYERS} + "
                    f"{C_LAYERS} layers {tag}, bf16 AMP: "
                    f"export_train_step {t_export:.1f} s, files {sizes} "
                    f"bytes; "
                    f"PD_NewTrainer {t_load:.1f} s; {C_STEPS} C steps, losses "
                    f"{[round(x, 4) for x in losses]}, step ms "
                    f"{[round(x, 2) for x in ms]} (median of steps 3 on "
                    f"{float(np.median(ms[2:])):.3f}, host clock, the loss "
                    f"read back each step); launches {counts}")
            if dropout == 0.0:
                live = tb_trainer(0.0, C_LAYERS)
                zero_launches()
                live_ms, live_losses = [], []
                for i in order:
                    src, tgt, lab = batches[i]
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    live_losses.append(float(live.train_step((src, tgt), lab)))
                    live_ms.append((time.perf_counter() - t0) * 1e3)
                add_launches(total, read_launches())
                rel = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                              live_losses))
                line += (f"; the live trainer's losses "
                         f"{[round(x, 4) for x in live_losses]}, step ms "
                         f"median {float(np.median(live_ms[2:])):.3f}; worst "
                         f"relative "
                         f"gap {rel:.3e} (tol {TOL_C_TRAINER})")
                if not rel <= TOL_C_TRAINER:
                    problems.append(f"{tag}: C vs live {rel:.3e}")
                del live
            else:
                first, last = np.mean(losses[:5]), np.mean(losses[-5:])
                line += f"; first 5 mean {first:.4f}, last 5 {last:.4f}"
                if not last < first:
                    problems.append(f"{tag}: losses do not fall: {losses}")
            log(line)
            del_all()
    finally:
        if demo.poll() is None and sys.exc_info()[0] is not None:
            demo.kill()
    demo.wait(timeout=300)
    t_demo = time.perf_counter() - t_demo0
    with open(os.path.join(base, "demo.out")) as f_out, \
            open(os.path.join(base, "demo.err")) as f_err:
        out, err = f_out.read(), f_err.read()
    ok_line = next((ln for ln in out.splitlines()
                    if "CAPI-TRAIN-OK" in ln), None)
    if demo.returncode != 0 or ok_line is None:
        problems.append(f"pd_capi_train_demo rc {demo.returncode}: "
                        f"{out[-400:]} {err[-800:]}")
    log(f"[c-trainer] pd_capi_train_demo (its own process, on the card, "
        f"beside the runs above) exit {demo.returncode} after {t_demo:.1f} "
        f"s: {ok_line}")
    import shutil
    shutil.rmtree(base, ignore_errors=True)
    del_all()
    log(f"[c-trainer] the phase took {time.perf_counter() - t_phase:.1f} s")
    finish("c-trainer", problems)
    return {"c-trainer": total}


# ---------------------------------------------------------------------------
# autotune: the cost model, the controller, the live retuner, row 10's
# plan sweep, the single-device faults and the report
# ---------------------------------------------------------------------------
# autotune-train's depth (gpt3-1.3b widths; the 24 layers cut for the
# budget: remat_policy_key carries the depth), trials (one more than the
# remat axis's four values, so that a descent that runs out of moves
# shows as converged) and steps a trial
AT_LAYERS = 6
AT_MAX_TRIALS = 5
AT_WARM, AT_MEAS = 1, 3
# the profile's MFU against the train phase's, after the flops-count
# ratio (the profile counts the LM head, bench's formula does not): the
# registry's step time is the host's per step, which trails the card's
# by a queue's depth at most
TOL_COST_MFU = 0.15
# row 10's sweep: gpt3-1.3b's four int8 products at M = 512, (n, k)
QMM_SWEEP = {"qkv": (6144, 2048), "out": (2048, 2048),
             "up": (8192, 2048), "down": (2048, 8192)}
QMM_SWEEP_M = 512
# the faults' trainer: gpt3-1.3b widths at 1 layer, 2 x 512 tokens
FAULT_STEPS = 6
FAULT_SIGTERM_STEP = 3


def tb_capture_cost(static_net, loss_fn, src, tgt, lab):
    """``profiler.cost_stats`` of a ``to_static`` capture: its graph
    walked (no run), and one bf16 training step through it on the card
    counted op by op; the gradients it leaves are the caller's to clear."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import profiler

    def step():
        with paddle.amp.auto_cast(dtype="bfloat16"):
            loss = loss_fn(static_net(src, tgt), lab)
        loss.backward()
    walk = profiler.cost_stats(static_net)
    run = profiler.cost_stats(step)
    torch.cuda.synchronize()
    return {"walk": walk, "run": run}


def phase_cost_model(smi):
    """cost-model: the registry's analytic costs (``exec_registry.
    analyze``) of gpt3-1.3b's train step (train's trainer), prefill and
    decode step kinds (serve's engine): non-None profiles; the train
    step's MFU from the profile against the train phase's (bench's
    formula) after the flops-count ratio, within TOL_COST_MFU; the
    doctor's roofline verdict over the train phase's stats with its
    ``remat_policy`` action; ``cost_stats`` of jit-transformer's
    ``to_static`` capture: rows 1-3's flops (4 B H S^2 D a call, 2 x
    TB_LAYERS calls a step each)."""
    problems = []
    train, serve, tb = COST.get("train"), COST.get("serve"), COST.get("tb")
    if train is None or serve is None or tb is None:
        raise SystemExit(f"cost-model needs the train, serve and "
                         f"jit-transformer phases first (have "
                         f"{sorted(COST)})")
    prof = train["profile"]
    if not prof or "train_step" not in prof:
        raise SystemExit(f"cost-model: no train_step profile: {prof}")
    row = prof["train_step"]
    ratio = row["flops"] / train["bench_flops"]
    want = train["mfu"] * ratio
    gap = abs(row["mfu"] / want - 1)
    log(f"[cost-model] {smi}: train step (gpt3-1.3b, 4 x 2048, bf16 AMP, "
        f"Adam): analytic {row['flops']:.4e} flops, {row['bytes_accessed']:.4e} "
        f"bytes (per-op), AI {row['arithmetic_intensity']} against the ridge "
        f"{row['ridge_ai']}: {row['bound']}-bound; temp (activations) "
        f"{row.get('temp_bytes')} bytes; profile mean step "
        f"{row['mean_ms']} ms over {row['calls']} calls, MFU "
        f"{row['mfu']:.4f}, HBM {row.get('hbm_bw_frac')}, roof "
        f"{row.get('roof_frac')}; the train phase's MFU {train['mfu']:.4f} "
        f"(bench's flops) x {ratio:.4f} (the LM head's share) = {want:.4f}: "
        f"gap {gap:.3%} (tol {TOL_COST_MFU:.0%})")
    if not gap <= TOL_COST_MFU:
        problems.append(f"profile MFU {row['mfu']:.4f} vs {want:.4f}")
    roof = [v for v in train["doctor"]
            if v["bottleneck"] == "mfu-below-target"]
    log(f"[cost-model] the doctor over the train phase's stats: "
        f"{[(v['bottleneck'], v['score'], v.get('action')) for v in train['doctor']]}")
    if not roof or (roof[0].get("action") or {}).get("param") != \
            "remat_policy":
        problems.append(f"no roofline verdict with the remat_policy action: "
                        f"{train['doctor']}")
    for kind in ("prefill", "decode", "sample"):
        r = (serve or {}).get(kind)
        if r is None:
            problems.append(f"serve profile has no {kind}")
            continue
        log(f"[cost-model] serve {kind} ({r['name']}): {r['calls']} calls, "
            f"mean {r['mean_ms']} ms, {r['flops']:.4e} flops, "
            f"{r['bytes_accessed']:.4e} bytes, AI "
            f"{r.get('arithmetic_intensity')}: {r.get('bound')}-bound, MFU "
            f"{r.get('mfu')}, HBM {r.get('hbm_bw_frac')}")
    per_call = 4 * TB_B * TB_HEADS * TB_S * TB_S * TB_D
    calls = 2 * TB_LAYERS
    want_rows = {"paddle_tpu.flash_fwd": per_call * calls,
                 "paddle_tpu.flash_bwd_dq": per_call * calls,
                 "paddle_tpu.flash_bwd_dkv": per_call * calls}
    walk, run = tb["walk"], tb["run"]
    log(f"[cost-model] Transformer-base to_static capture: graph walk "
        f"{walk.get('flops', 0):.4e} flops, {walk.get('bytes_accessed', 0):.4e} "
        f"bytes, by op {walk.get('flops_by_op')}; one training step through "
        f"it {run.get('flops', 0):.4e} flops, by op {run.get('flops_by_op')}")
    if walk.get("flops_by_op", {}).get("paddle_tpu.flash_fwd") != \
            want_rows["paddle_tpu.flash_fwd"]:
        problems.append(f"capture graph row 1 flops "
                        f"{walk.get('flops_by_op')}")
    for op, n in want_rows.items():
        if run.get("flops_by_op", {}).get(op) != n:
            problems.append(f"{op} flops {run.get('flops_by_op', {}).get(op)}"
                            f" != {n}")
    finish("cost-model", problems)


def phase_autotune_train(smi):
    """autotune-train (the ``once`` tier): ``AutotuneController(kind=
    'train', objective_key='mfu')`` over ``SpmdTrainer`` at gpt3-1.3b
    widths, AT_LAYERS layers (hidden 2048, 16 x 128 heads, vocab 50304,
    4 x 2048 tokens, bf16 AMP, fused CE, Adam), axes ``remat_policy`` and
    ``prefetch_depth`` from ``{'remat_policy': 'full', 'prefetch_depth':
    2}``, at most AT_MAX_TRIALS trials.  A trial: a fresh trainer on the
    one model, AT_WARM warm-up and AT_MEAS measured steps from a
    ``DevicePrefetcher``, MFU over the measured window (bench's
    formula), the doctor over its analyzed stats.  Checks: no compile in
    a measured window and none outside the trials, rows 1-3 launched in
    every trial, every commit in the table with its provenance, and a
    fresh ``SpmdTrainer(recompute=True)`` running the policy
    ``tuned_remat_policy`` reads (full recompute when none applies)."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.autotune import AutotuneController
    from paddle_tpu_torch.core import random as prandom
    from paddle_tpu_torch.distributed import SpmdTrainer
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.distributed.spmd import (remat_policy_key,
                                                   tuned_remat_policy)
    from paddle_tpu_torch.io import DevicePrefetcher
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion)
    from paddle_tpu_torch.observability import exec_registry
    from paddle_tpu_torch.utils import compile_counter, tuning
    problems = []
    cfg = full_cfg(AT_LAYERS)
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32,
                           generator=prandom.seed(4321, "cuda"))
    crit = GPTPretrainingCriterion()
    b, s = 4, 2048
    batch = token_batch(np.random.RandomState(0), cfg.vocab_size, b, s)
    total = {}

    def strategy(policy):
        st = DistributedStrategy()
        st.amp = True
        if policy != "off":
            st.recompute = True
            st.recompute_configs = {"policy": policy}
        return st

    def measure(config):
        policy = config["remat_policy"]
        # 'off' runs the same model without recompute (the strategy
        # turns it on, nothing turns it off)
        model.gpt._recompute = False
        tr = SpmdTrainer(model, topt.Adam(learning_rate=1e-4),
                         lambda o, lab: crit(o, lab),
                         strategy=strategy(policy))
        feed = DevicePrefetcher(itertools.repeat(batch, AT_WARM + AT_MEAS),
                                device="cuda", timings=tr._timings,
                                depth=config["prefetch_depth"])
        for i, (ids, labels) in enumerate(feed):
            if i == AT_WARM:
                torch.cuda.synchronize()
                zero_launches()
                snap = compile_counter.snapshot()
                t0 = time.perf_counter()
            out = tr.train_step(ids, labels)
        loss = float(out)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        add_launches(total, launches)
        compiles = snap.new_compiles
        exec_registry.analyze_all(tr._exec_component)
        st = tr.stats
        mfu = cfg.flops_per_token(s) * AT_MEAS * b * s / wall / \
            PEAK_BF16_FLOPS
        prof = (st["exec_profile"] or {}).get("train_step") or {}
        flash = {k: launches[k] for k in FLASH}
        log(f"[autotune-train] trial {config}: step "
            f"{wall * 1e3 / AT_MEAS:.2f} ms, MFU {mfu:.4f} (profile "
            f"{prof.get('mfu')}, {prof.get('bound')}-bound), loss "
            f"{loss:.4f}, compiles in the measured window {compiles}, rows "
            f"1-3 {flash}, doctor "
            f"{[(v['bottleneck'], (v.get('action') or {}).get('param')) for v in st['doctor']]}")
        if not all(flash.values()):
            problems.append(f"trial {config}: rows 1-3 launches {flash}")
        if not np.isfinite(loss):
            problems.append(f"trial {config}: loss {loss}")
        return {"mfu": mfu, "doctor": st["doctor"],
                "xla_compiles_measured": compiles,
                "step_ms": wall * 1e3 / AT_MEAS}

    key = remat_policy_key(cfg)
    ctl = AutotuneController(
        measure, kind="train", objective_key="mfu",
        axes=["remat_policy", "prefetch_depth"], max_trials=AT_MAX_TRIALS,
        run_id="chip-smoke-autotune-train",
        commit_keys={"remat_policy": ("remat_policy", key)}, log=log)
    base = {"remat_policy": "full", "prefetch_depth": 2}
    summary = ctl.run(dict(base))
    if summary.get("error"):
        raise SystemExit(f"autotune-train: incumbent failed: "
                         f"{summary['error']}")
    for t in summary["trials"]:
        log(f"[autotune-train] trial log: {t['axis']}={t['value']!r} "
            f"{t['outcome']}{' (' + t['reason'] + ')' if t.get('reason') else ''}"
            f" MFU {t['objective']} against {t['incumbent_objective']}, "
            f"improvement {t.get('improvement')}, compiles {t['compiles']}, "
            f"verdict {t['bottleneck']}")
    log(f"[autotune-train] {smi}: {summary['measured_trials']} trials, "
        f"accepted {summary['accepted']}, rolled back "
        f"{summary['rolled_back']}, baseline MFU {summary['baseline']:.4f} "
        f"-> {summary['best']:.4f} ({summary['improvement']:+.2%}), config "
        f"{summary['config']}, converged {summary['converged']}, "
        f"compiles_total {summary['compiles_total']}, "
        f"compiles_outside_trials {summary['compiles_outside_trials']}, "
        f"committed {summary['committed']}")
    storms = [t for t in summary["trials"]
              if t.get("reason") == "recompile-storm"]
    if storms:
        problems.append(f"compiles inside measured windows: {storms}")
    if summary["compiles_outside_trials"]:
        problems.append(f"{summary['compiles_outside_trials']} compiles "
                        f"outside the trials")
    for c in summary["committed"]:
        got = tuning.lookup(c["op"], c["key"])
        meta = tuning.provenance(c["op"], c["key"]) or {}
        log(f"[autotune-train] table {c['op']}|{'|'.join(c['key'])} = "
            f"{got!r}, provenance {meta}")
        if got != c["value"] or meta.get("source") != "autotune" or \
                meta.get("run") != "chip-smoke-autotune-train":
            problems.append(f"commit {c} reads back {got!r} {meta}")
    if summary["committed"]:
        AUTOTUNE_SOURCES.add("autotune")
    else:
        log(f"[autotune-train] converged without a commit: the incumbent "
            f"{summary['config']} stays")
    tuned = tuned_remat_policy(model)
    model.gpt._recompute = False
    st = DistributedStrategy()
    st.amp = True
    st.recompute = True
    # no policy asked for: the trainer reads the table's
    st.recompute_configs = {"policy": None}
    fresh = SpmdTrainer(model, topt.Adam(learning_rate=1e-4),
                        lambda o, lab: crit(o, lab), strategy=st)
    ran = model.gpt._recompute_policy
    log(f"[autotune-train] a fresh SpmdTrainer(recompute=True) on key "
        f"{key}: tuned_remat_policy -> {tuned!r}, the model recomputes with "
        f"policy {ran!r}")
    if ran != (tuned or "full") or not model.gpt._recompute:
        problems.append(f"fresh trainer policy {ran!r}, tuned {tuned!r}")
    del fresh, model
    del_all()
    finish("autotune-train", problems)
    return {"autotune-train": total}


def live_engine_run(tag, eng, prompts, new_tokens, monitor=None):
    """Serve ``prompts`` greedily to the end; feed each request's TTFT to
    ``monitor``; returns ``(streams, launches)``."""
    rids = [eng.add_request(p, max_new_tokens=new_tokens) for p in prompts]
    torch.cuda.synchronize()
    zero_launches()
    res = eng.run()
    torch.cuda.synchronize()
    launches = read_launches()
    if monitor is not None:
        for r in rids:
            monitor.observe(eng.request_stats[r]["ttft_ms"])
    return [res[r].tolist() for r in rids], launches


def phase_autotune_live(model, smi):
    """autotune-live (the ``live`` tier) on gpt3-1.3b: a dense and a paged
    engine (8 slots, max_seq_len 2048, blocks of 128) built under
    ``PADDLE_TPU_AUTOTUNE=live`` and warmed over their whole bucket list;
    serve's prompts with 16 new tokens, each request's TTFT into an
    ``SLOMonitor`` whose target sits below what the engine achieves, so
    its check is a real breach that schedules one episode.  Checks: the
    episode waits while a request is queued or active, runs on the next
    tick of the quiesced engine with no compile, keeps a subset of the
    warmed list; a second verdict (the same monitor, and a healthy one
    then a breach inside the cooldown) schedules nothing; requests after
    it complete; a prompt whose bucket is unchanged gives the same greedy
    tokens as before; a new engine boots with the list the episode left
    (the table's when it applied one).  Bucket times and the merged list
    printed."""
    from paddle_tpu_torch.autotune.live import LiveRetuner
    from paddle_tpu_torch.inference import InferenceEngine
    from paddle_tpu_torch.observability import exec_registry
    from paddle_tpu_torch.observability.slo import SLOMonitor
    from paddle_tpu_torch.utils import compile_counter, tuning
    problems, total = [], {}
    prompts = serve_prompts(model.cfg.vocab_size)
    # 1536 tokens: the largest bucket, which every kept list holds
    probe = prompts[3]
    os.environ["PADDLE_TPU_AUTOTUNE"] = "live"
    try:
        engines = {
            "dense": InferenceEngine(model, batch_slots=8, device="cuda"),
            "paged": InferenceEngine(model, batch_slots=8, kv_layout="paged",
                                     kv_block_size=128, device="cuda")}
    finally:
        del os.environ["PADDLE_TPU_AUTOTUNE"]
    for tag, eng in engines.items():
        r = eng._retuner
        if not isinstance(r, LiveRetuner):
            raise SystemExit(f"autotune-live {tag}: no retuner armed")
        warmed = list(eng.buckets)
        eng.warmup(warmed)
        before, _ = live_engine_run(tag, eng, [probe], 16)
        seen = SLOMonitor(ttft_p99_ms=None)
        _, launches = live_engine_run(tag, eng, prompts, 16, seen)
        add_launches(total, launches)
        achieved = seen.check()["p99_ms"]
        mon = SLOMonitor(ttft_p99_ms=achieved / 2).add_listener(r.notify_slo)
        for v in seen._window:
            mon.observe(v)
        table_before = tuning.lookup(
            "prefill_buckets", (tuning.device_kind(), eng.max_seq_len))
        verdict = mon.check()
        scheduled = r._pending
        # the quiesce gate: a queued request holds the episode back
        eng.add_request(probe, max_new_tokens=4)
        eng.step()
        held = r.episodes == 0 and r._pending
        eng.run()
        with compile_counter.assert_no_recompiles(f"{tag} live episode"):
            t0 = time.perf_counter()
            eng.step()
            episode_s = time.perf_counter() - t0
        ep = r.last_episode or {}
        again = mon.check()
        latched = not r._pending
        healthy = SLOMonitor(ttft_p99_ms=achieved * 100)
        healthy.add_listener(r.notify_slo)
        for v in seen._window:
            healthy.observe(v)
        healthy.check()
        mon.check()
        cooled = not r._pending
        after, launches = live_engine_run(tag, eng, prompts[:4], 8)
        add_launches(total, launches)
        probe_after, _ = live_engine_run(tag, eng, [probe], 16)
        same_bucket = eng._bucket_for(len(probe)) == \
            min(b for b in warmed if b >= len(probe))
        table = tuning.lookup("prefill_buckets",
                              (tuning.device_kind(), eng.max_seq_len))
        fresh = InferenceEngine(model, batch_slots=8, device="cuda",
                                **({"kv_layout": "paged",
                                    "kv_block_size": 128}
                                   if tag == "paged" else {}))
        log(f"[autotune-live] {smi}: {tag} engine, warmed {warmed}; TTFT "
            f"p99 {achieved:.2f} ms, SLO target {achieved / 2:.2f} ms: "
            f"breached {verdict['breached']}, scheduled {scheduled}, held "
            f"while queued {held}; episode {r.episodes} in "
            f"{episode_s * 1e3:.1f} ms: bucket ms "
            f"{ep.get('times_ms')}, merged {ep.get('merged')}, improvement "
            f"{ep.get('improvement')}, applied {bool(r.applied)}, list now "
            f"{eng.buckets}; second verdict scheduled nothing {latched}, "
            f"cooldown held {cooled}; table {table}; a new engine boots "
            f"with {fresh.buckets}; probe ({len(probe)} tokens) same tokens "
            f"{probe_after == before} (bucket unchanged {same_bucket})")
        if not (verdict["breached"] and scheduled):
            problems.append(f"{tag}: the breach scheduled no episode")
        if not held:
            problems.append(f"{tag}: the episode ran with work queued")
        if r.episodes != 1 or r.failures:
            problems.append(f"{tag}: episodes {r.episodes}, failures "
                            f"{r.failures}")
        if not set(eng.buckets) <= set(warmed) or \
                eng.buckets[-1] != warmed[-1]:
            problems.append(f"{tag}: list {eng.buckets} not a subset of "
                            f"{warmed} with its largest")
        if not (latched and cooled):
            problems.append(f"{tag}: a second verdict scheduled an episode")
        if [len(x) for x in after] != [8] * 4:
            problems.append(f"{tag}: after the episode {after}")
        if not same_bucket or probe_after != before:
            problems.append(f"{tag}: probe tokens changed (bucket "
                            f"unchanged {same_bucket})")
        if r.applied:
            AUTOTUNE_SOURCES.add("autotune")
            if table != eng.buckets or fresh.buckets != eng.buckets:
                problems.append(f"{tag}: table {table}, new engine "
                                f"{fresh.buckets}, live {eng.buckets}")
        elif table != table_before or \
                fresh.buckets != (sorted(table) if table else warmed):
            problems.append(f"{tag}: no apply, yet table {table} (was "
                            f"{table_before}) / new engine {fresh.buckets}")
        if tag == "paged":
            eng.check_leak_free()
        # the step kinds' costs, while the engine lives (report reads them)
        exec_registry.analyze_all(eng._exec_component)
        del fresh
    del engines
    del_all()
    finish("autotune-live", problems)
    return {"autotune-live": total}


def phase_qmm_sweep(model, smi):
    """qmm-sweep: ``autotune_qmm_sweep`` for gpt3-1.3b's four int8
    products at M = 512 (every plan of the built kernel in turns, CUDA
    graph replays timed with CUDA events, the winner recorded with
    provenance), each candidate's ms beside the default plan's and
    ``torch._int_mm`` + rescale's (graph replays too, best of 5); the
    winner's output bitwise equal to the default plan's on other inputs;
    then a ``quantize='int8'`` engine (buckets 512 and 2048) on prompts
    of 300-512 tokens reads the winners through ``get_qmm_tiles`` (every
    M = 512 product), row 10 four launches a layer a prefill and decode
    step."""
    from paddle_tpu_torch.inference import InferenceEngine
    from paddle_tpu_torch.utils import tuning
    qmm = importlib.import_module("paddle_tpu_torch.ops.quantized_matmul")
    problems, winners = [], {}
    m = QMM_SWEEP_M
    gen = torch.Generator(device="cuda")
    gen.manual_seed(99)
    for name, (n, k) in QMM_SWEEP.items():
        t0 = time.perf_counter()
        win = qmm.autotune_qmm_sweep(m, n, k)
        sweep_s = time.perf_counter() - t0
        rec = qmm.SWEEP_LOG[-1]
        winners[(n, k)] = win
        x = torch.randn(m, k, device="cuda", generator=gen)
        w = torch.randn(n, k, device="cuda", generator=gen)
        qx, sx = qmm.quantize_channel(x, axis=1, dtype="int8")
        qw_t, sw = qmm.quantize_channel(w, axis=1, dtype="int8")
        qx, qw_t, sw = qx.contiguous(), qw_t.contiguous(), sw.reshape(1, n)
        y_win = qmm._qmm_cuda(qx, qw_t, sx, sw, torch.bfloat16, tiles=win)
        y_def = qmm._qmm_cuda(qx, qw_t, sx, sw, torch.bfloat16, tiles={})
        equal = torch.equal(y_win, y_def)
        # the library timed as the sweep times the plans: graph replays
        lib_ms = in_turns([lambda: ((torch._int_mm(qx, qw_t.t()).float() *
                                     sx) * sw).to(torch.bfloat16)], 8,
                          rounds=5)[0]
        meta = tuning.provenance("qmm_tiles", (tuning.device_kind(), m, n, k,
                                               "int8"))
        base_ms = next(t for bn, sp, t in rec["ms"]
                       if {"bn": bn, "splits": sp} == rec["default"])
        log(f"[qmm-sweep] {smi}: {name} M={m} N={n} K={k}: candidates "
            f"(bn, splits, ms) {[(bn, sp, round(t, 4)) for bn, sp, t in rec['ms']]}"
            f"; default {rec['default']} {base_ms:.4f} ms, winner {win} "
            f"({rec['improvement']:+.2%}); torch._int_mm + rescale "
            f"{lib_ms:.4f} ms; winner == default bitwise {equal}; "
            f"provenance {meta}; sweep {sweep_s:.2f} s")
        if not equal:
            problems.append(f"{name}: winner output differs")
        if (meta or {}).get("source") != "sweep":
            problems.append(f"{name}: provenance {meta}")
        AUTOTUNE_SOURCES.add("sweep")
    hits = []
    real = qmm.get_qmm_tiles

    def counted(mm, n, k, dtype="int8"):
        got = real(mm, n, k, dtype)
        hits.append((mm, n, k, got))
        return got
    qmm.get_qmm_tiles = counted
    model.enable_quantize("int8")
    try:
        # prefills at the swept M exactly (the live phase may have tuned
        # the default bucket list)
        eng = InferenceEngine(model, batch_slots=8, device="cuda",
                              prefill_buckets=[m, model.cfg.max_seq_len])
        rng = np.random.RandomState(31)
        prompts = random_prompts(rng, model.cfg.vocab_size,
                                 [300, 400, 480, 512])
        streams, launches, st, wall = run_engine("qmm-sweep", eng, prompts, 8)
    finally:
        qmm.get_qmm_tiles = real
        model.enable_quantize(None)
    layers = model.cfg.num_layers
    at_m = [(n, k, got) for mm, n, k, got in hits if mm == m]
    read_winner = sum(got == winners.get((n, k)) for n, k, got in at_m)
    want = {"quantized_matmul": 4 * layers * (st["prefills"] +
                                              st["decode_steps"]),
            "decode_attention": layers * st["decode_steps"],
            "flash_fwd": layers * st["prefills"]}
    log(f"[qmm-sweep] int8 engine: {st['prefills']} prefills at bucket 512, "
        f"{st['decode_steps']} decode steps, tokens/s "
        f"{sum(len(x) for x in streams) / wall:.1f}; get_qmm_tiles calls "
        f"{len(hits)}, at M={m} {len(at_m)}, of them the sweep's winner "
        f"{read_winner}")
    check_launches("qmm-sweep", launches, want, problems)
    if not at_m or read_winner != len(at_m) or \
            len(at_m) != 4 * layers * st["prefills"]:
        problems.append(f"the engine read {read_winner} winners in "
                        f"{len(at_m)} M={m} products")
    if [len(x) for x in streams] != [8] * len(prompts):
        problems.append(f"streams {[len(x) for x in streams]}")
    del eng
    del_all()
    finish("qmm-sweep", problems)
    return {"qmm-sweep": launches}


def fault_trainer():
    """The faults' trainer: gpt3-1.3b widths at 1 layer, f32 masters,
    bf16 AMP, Adam, seed 4321; and its batches (2 x 512, seed 0)."""
    from paddle_tpu_torch import optimizer as topt
    cfg = full_cfg(1)
    _, trainer = make_trainer(cfg, 4321, topt.Adam(learning_rate=1e-4))
    rng = np.random.RandomState(0)
    return trainer, [token_batch(rng, cfg.vocab_size, 2, 512)
                     for _ in range(FAULT_STEPS)]


def param_digest(trainer):
    import hashlib
    h = hashlib.sha256()
    for name, p in sorted(trainer.model.named_parameters()):
        h.update(name.encode())
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def fault_child(kind, base):
    """A child of the faults phase (``--fault-child kind base``):
    ``sigterm`` trains under a ``PreemptionGuard`` and saves on the
    signal; ``hang-truncate`` serves a 1-layer engine whose tick hangs
    (the watchdog's stall bundle), then trains with manifest checkpoints
    until the truncated commit exits 137."""
    from paddle_tpu_torch.distributed import checkpoint
    from paddle_tpu_torch.distributed.resilience import (CheckpointManager,
                                                         PreemptionGuard)
    t0 = time.perf_counter()
    if kind == "sigterm":
        trainer, batches = fault_trainer()
        mgr = CheckpointManager(os.path.join(base, "sigterm"),
                                async_save=False)
        with PreemptionGuard() as guard:
            for ids, labels in batches:
                trainer.train_step(ids, labels)
                if guard.preempted:
                    mgr.save(trainer)
                    print(f"FAULT-CHILD sigterm saved at step "
                          f"{trainer._step_count} after "
                          f"{time.perf_counter() - t0:.1f} s", flush=True)
                    return
        raise SystemExit("no SIGTERM arrived")
    if kind == "hang-truncate":
        from paddle_tpu_torch.core import random as prandom
        from paddle_tpu_torch.inference import InferenceEngine
        from paddle_tpu_torch.models import GPTForCausalLM
        cfg = full_cfg(1)
        model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                               generator=prandom.seed(7, "cuda")).eval()
        eng = InferenceEngine(model, batch_slots=2, prefill_buckets=[64],
                              device="cuda").warmup()
        # the watchdog arms at the first tick: only the hang stalls it
        eng.generate(np.arange(1, 33), max_new_tokens=6)
        print(f"FAULT-CHILD hang served, {eng.watchdog.stalls} stall(s), "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        eng.watchdog.disarm()
        del os.environ["PADDLE_TPU_WATCHDOG_S"]
        del eng, model
        trainer, batches = fault_trainer()
        d = os.path.join(base, "truncate")
        for step, (ids, labels) in enumerate(batches, 1):
            trainer.train_step(ids, labels)
            checkpoint.save_trainer(trainer, os.path.join(d, f"ckpt-{step}"),
                                    manifest=True)
            print(f"FAULT-CHILD committed ckpt-{step} at "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        raise SystemExit("no truncated commit")
    raise SystemExit(f"unknown fault child {kind!r}")


def fault_resume(base):
    """The faults phase's checks in its own process: the run resumed from
    the SIGTERM child's checkpoint against an uninterrupted one
    (bitwise), and the walk past the truncated checkpoint."""
    from paddle_tpu_torch.distributed import checkpoint
    from paddle_tpu_torch.distributed.resilience import CheckpointManager
    trainer, batches = fault_trainer()
    for ids, labels in batches:
        trainer.train_step(ids, labels)
    want = param_digest(trainer)
    del trainer
    resumed, _ = fault_trainer()
    CheckpointManager(os.path.join(base, "sigterm"),
                      async_save=False).restore_latest(resumed)
    start = resumed._step_count
    for ids, labels in batches[start:]:
        resumed.train_step(ids, labels)
    got = param_digest(resumed)
    del resumed
    d = os.path.join(base, "truncate")
    latest = checkpoint.latest_checkpoint(d)
    valid = {os.path.basename(p): checkpoint.validate_checkpoint(p)
             for _, p in checkpoint.checkpoint_candidates(d)}
    walked, _ = fault_trainer()
    CheckpointManager(d, async_save=False).restore_latest(walked)
    out = {"resumed_from": start, "bitwise": got == want,
           "latest": os.path.basename(latest or ""), "valid": valid,
           "walked_to_step": walked._step_count}
    del walked
    del_all()
    return out


def phase_faults(smi):
    """faults: two child processes, side by side, over a 1-layer trainer
    at gpt3-1.3b widths (``fault_child``): ``PADDLE_FAULT_SIGTERM_STEP``
    leads to a ``PreemptionGuard`` save, and the run resumed from it here
    (``fault_resume``) ends bitwise equal to an uninterrupted one;
    ``PADDLE_FAULT_CKPT_TRUNCATE=2`` makes the other child exit 137 with
    ckpt-2 cut, and the resume walks back to ckpt-1;
    ``PADDLE_FAULT_HANG`` in that child's engine tick loop under a 0.5 s
    watchdog leaves a ``stall`` bundle."""
    from paddle_tpu_torch.observability import flightrec
    problems = []
    base = os.path.join(TUNING["dir"], "faults")
    frdir = os.path.join(base, "flightrec")
    os.makedirs(frdir, exist_ok=True)
    script = os.path.abspath(__file__)

    def child(kind, **env):
        e = dict(os.environ, PADDLE_TPU_FLIGHTREC_DIR=frdir, **env)
        return subprocess.Popen([sys.executable, script, "--fault-child",
                                 kind, base], env=e, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    procs = {"sigterm": child("sigterm",
                              PADDLE_FAULT_SIGTERM_STEP=str(FAULT_SIGTERM_STEP)),
             "hang-truncate": child("hang-truncate",
                                    PADDLE_FAULT_HANG="3:2",
                                    PADDLE_TPU_WATCHDOG_S="0.5",
                                    PADDLE_FAULT_CKPT_TRUNCATE="2")}
    outs = {}
    for kind, p in procs.items():
        out, _ = p.communicate(timeout=600)
        outs[kind] = (p.returncode, out)
        log(f"[faults] child {kind}: exit {p.returncode}; "
            f"{[ln for ln in out.splitlines() if 'FAULT-CHILD' in ln]}")
    if outs["sigterm"][0] != 0:
        problems.append(f"sigterm child exit {outs['sigterm'][0]}: "
                        f"{outs['sigterm'][1][-1500:]}")
    if outs["hang-truncate"][0] != 137:
        problems.append(f"hang-truncate child exit "
                        f"{outs['hang-truncate'][0]} (want 137): "
                        f"{outs['hang-truncate'][1][-1500:]}")
    got = fault_resume(base)
    bundles = flightrec.find_bundles(frdir)
    stalls = [b for b in bundles if b.endswith("-stall") and
              str((flightrec.load_bundle(b)["bundle"].get("stall") or {})
                  .get("label", "")).startswith("decode")]
    cut = [b for b in bundles if b.endswith("-ckpt_truncate")]
    log(f"[faults] {smi}: resume {got}; bundles "
        f"{[os.path.basename(b) for b in bundles]}")
    if got["resumed_from"] != FAULT_SIGTERM_STEP or not got["bitwise"]:
        problems.append(f"SIGTERM resume {got}")
    if got["latest"] != "ckpt-1" or got["valid"] != {"ckpt-2": False,
                                                     "ckpt-1": True} or \
            got["walked_to_step"] != 1:
        problems.append(f"truncated checkpoint walk {got}")
    if not stalls or not cut:
        problems.append(f"bundles: stall {stalls}, truncate {cut}")
    else:
        info = flightrec.load_bundle(stalls[0])["bundle"]
        log(f"[faults] stall bundle reason {info.get('reason')}, stall "
            f"{info.get('stall')}")
    FAULT_BUNDLES.extend(stalls)
    finish("faults", problems)


FAULT_BUNDLES = []
# the provenance sources this run committed to the tuning table
AUTOTUNE_SOURCES = set()


def phase_report(smi):
    """report: ``python -m paddle_tpu_torch.observability.report`` over a
    snapshot this run wrote (the registry with analyzed step kinds), the
    stall bundle of faults, and the tuning table with ``--tuning``: each
    exits 0 and prints the executables, doctor and tuning tables, the last
    with provenance."""
    import paddle_tpu_torch.observability as obs
    from paddle_tpu_torch.observability import exec_registry
    problems = []
    exec_registry.analyze_all()
    snap = os.path.join(TUNING["dir"], "snapshot.jsonl")
    obs.write_snapshot(snap)
    if not FAULT_BUNDLES:
        raise SystemExit("report: faults left no stall bundle to render")
    runs = {"snapshot": ["--snapshot", snap, "--tuning"],
            "bundle": ["--bundle", FAULT_BUNDLES[0]]}
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [here] + [p for p in sys.path if p]))
    procs = {tag: subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.observability.report",
         *args], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=here, env=env) for tag, args in runs.items()}
    for tag, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        lines = out.splitlines()
        # the rows of step kinds whose engine or trainer is gone (no
        # cost to show) are counted, not echoed
        shown = [ln for ln in lines
                 if not ln.rstrip().endswith("!owner released")]
        log(f"[report] {tag}: exit {proc.returncode}, {len(out)} chars, "
            f"{len(lines) - len(shown)} rows of released owners not echoed")
        for ln in shown:
            log(f"[report] | {ln}")
        want = ["executables on h100", "doctor"]
        if tag == "snapshot":
            # the table's rows with the provenance this run committed
            want += ["tuning table (", *sorted(AUTOTUNE_SOURCES)]
        missing = [w for w in want if w not in out]
        if proc.returncode != 0 or missing:
            problems.append(f"{tag}: exit {proc.returncode}, missing "
                            f"{missing}: {err[-800:]}")
    finish("report", problems)



def autotune_phases():
    """``python3 chip_smoke.py --autotune-phases``: phases 37-42 alone, in
    about two minutes of command time.  It builds the six sources they
    launch (rows 1-4, 6, 10), runs serve and train for the stashes
    cost-model reads and one ``to_static`` Transformer-base step for its
    capture, then cost-model, autotune-train, autotune-live, qmm-sweep,
    faults and report under a temporary tuning table."""
    import shutil
    import tempfile
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops import _build
    TUNING["dir"] = tempfile.mkdtemp(prefix="chip_smoke_tuning_")
    os.environ["PADDLE_TPU_TUNING_CACHE"] = os.path.join(TUNING["dir"],
                                                         "tuning.json")
    try:
        _, _, smi = phase_device()
        t0 = time.perf_counter()
        _build.build(["flash_fwd.cu", "flash_bwd_dq.cu", "flash_bwd_dkv.cu",
                      "decode_attention.cu", "paged_decode_attention.cu",
                      "quantized_matmul.cu"])
        model = build_model()
        timed_phase("serve", phase_serve, model)
        del model
        del_all()
        timed_phase("train", phase_train)
        del_all()
        paddle.set_device("gpu")
        paddle.seed(1234)
        static_net = paddle.jit.to_static(tb_network())
        src, tgt, lab = (torch.as_tensor(a).cuda()
                         for a in tb_data(TB_B, 1234).tensors)
        with paddle.amp.auto_cast(dtype="bfloat16"):
            tb_loss()(static_net(src, tgt), lab)
        COST["tb"] = tb_capture_cost(static_net, tb_loss(), src, tgt, lab)
        del static_net
        del_all()
        paths = {}
        timed_phase("cost-model", phase_cost_model, smi)
        paths.update(timed_phase("autotune-train", phase_autotune_train, smi))
        model = build_model()
        paths.update(timed_phase("autotune-live", phase_autotune_live, model,
                                 smi))
        paths.update(timed_phase("qmm-sweep", phase_qmm_sweep, model, smi))
        del model
        del_all()
        timed_phase("faults", phase_faults, smi)
        timed_phase("report", phase_report, smi)
        log(f"[autotune-phases] launches by path "
            f"{ {p: {k: n for k, n in v.items() if n} for p, v in paths.items()} }"
            f"; {time.perf_counter() - t0:.1f} s after the device check")
    finally:
        shutil.rmtree(TUNING["dir"], ignore_errors=True)


def gpt_params(cfg):
    """Parameters of a GPT(-MoE) config: embeddings, blocks (an expert
    layer holds E FFNs and a router), final norm."""
    h, f, v = cfg.hidden_size, cfg.ffn_hidden_size, cfg.vocab_size
    kv = cfg.num_kv_heads * cfg.head_dim
    attn = h * (h + 2 * kv) + (h + 2 * kv) + h * h + h + 4 * h
    mlp = 2 * h * f + f + h
    n = v * h + cfg.max_seq_len * h + 2 * h
    for i in range(cfg.num_layers):
        n += attn + (cfg.moe_num_experts * mlp + h * cfg.moe_num_experts
                     if cfg.is_moe_layer(i) else mlp)
    return n


def timed_phase(tag, fn, *args):
    """``fn(*args)`` with its seconds on a line of their own."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[phase-seconds] {tag}: {time.perf_counter() - t0:.1f} s")
    return out


def main():
    # the tuning table of this run: a temporary file (every phase sees an
    # empty table; no run leaves one for the next to boot from)
    import shutil
    import tempfile
    TUNING["dir"] = tempfile.mkdtemp(prefix="chip_smoke_tuning_")
    os.environ["PADDLE_TPU_TUNING_CACHE"] = os.path.join(TUNING["dir"],
                                                         "tuning.json")
    try:
        run_phases()
    finally:
        shutil.rmtree(TUNING["dir"], ignore_errors=True)


def run_phases():
    name, count, smi = phase_device()
    t0 = time.perf_counter()
    timed_phase("build", phase_build)
    records = timed_phase("kernels", phase_kernels)
    for tag, phase in (("window-kernels", phase_window_kernels),
                       ("qmm-kernels", phase_qmm_kernels),
                       ("f8-kernels", phase_f8_kernels),
                       ("mega-kernels", phase_mega_kernels),
                       ("train-kernels", phase_train_kernels),
                       ("dropout-kernels", phase_dropout_kernels),
                       ("transformer-kernels", phase_transformer_kernels)):
        timed_phase(tag, phase, records)
    model = build_model()
    paths = {}
    for tag, phase in (("serve", phase_serve),
                       ("serve-paged", phase_serve_paged),
                       ("serve-pressure", phase_serve_pressure)):
        paths[tag] = timed_phase(tag, phase, model)
        gc.collect()
        torch.cuda.empty_cache()
    for tag, phase in (("serve-int8", phase_serve_int8),
                       ("serve-chunked", phase_serve_chunked),
                       ("serve-spec", phase_serve_spec),
                       ("serve-mega", phase_serve_mega)):
        paths.update(timed_phase(tag, phase, model))
    paths["serve-quant"] = timed_phase("serve-quant", phase_serve_quant,
                                       model)
    gc.collect()
    torch.cuda.empty_cache()
    paths.update(timed_phase("serve-fp8", phase_serve_fp8, model))
    paths["serve-quant-fp8"] = timed_phase("serve-quant-fp8",
                                           phase_serve_quant_fp8, model)
    gc.collect()
    torch.cuda.empty_cache()
    paths["serve-lifecycle"] = timed_phase("serve-lifecycle",
                                           phase_serve_lifecycle, model)
    gc.collect()
    torch.cuda.empty_cache()
    paths["serve-loadtest"] = timed_phase("serve-loadtest",
                                          phase_serve_loadtest, model, smi)
    gc.collect()
    torch.cuda.empty_cache()
    paths.update(timed_phase("serve-disagg", phase_serve_disagg, model))
    del_all()
    paths["serve-fleet"] = timed_phase("serve-fleet", phase_serve_fleet,
                                       model, smi)
    del_all()
    paths.update(timed_phase("serve-telemetry", phase_serve_telemetry, model,
                             smi))
    timed_phase("warmup-child", phase_warmup_child)
    timed_phase("teacher-forced", phase_teacher_forced, model)
    timed_phase("teacher-mega-quant", phase_teacher_mega_quant, model)
    timed_phase("profile", phase_profile, model)
    paths.update(timed_phase("serve-decoding", phase_serve_decoding, model))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    paths.update(timed_phase("serve-moe", phase_serve_moe, smi))
    timed_phase("train-parity", phase_train_parity)
    gc.collect()
    torch.cuda.empty_cache()
    paths["train-qat"] = timed_phase("train-qat", phase_train_qat)
    gc.collect()
    torch.cuda.empty_cache()
    paths["train-qat-fp8"] = timed_phase("train-qat-fp8", phase_train_qat_fp8)
    bf16 = timed_phase("train", phase_train)
    paths["train"] = bf16["launches"]
    for tag, phase in (("train-dropout", phase_train_dropout),
                       ("train-fp16", phase_train_fp16),
                       ("train-recompute-policies",
                        phase_train_recompute_policies),
                       ("train-merge", phase_train_merge),
                       ("train-anomaly", phase_train_anomaly),
                       ("train-checkpoint", phase_train_checkpoint),
                       ("train-telemetry", phase_train_telemetry),
                       ("train-optimizers", phase_train_optimizers),
                       ("train-moe", phase_train_moe)):
        del_all()
        paths.update(timed_phase(tag, phase, bf16, smi))
    for tag, phase in (("train-transformer", phase_train_transformer),
                       ("train-transformer-trainer",
                        phase_train_transformer_trainer),
                       ("jit-transformer", phase_jit_transformer),
                       ("capi", phase_capi),
                       ("workers", phase_workers),
                       ("train-resnet", phase_train_resnet),
                       ("train-resnet-trainer", phase_train_resnet_trainer),
                       ("detect", phase_detect),
                       ("tensor-ops", phase_tensor_ops),
                       ("train-ctr", phase_train_ctr),
                       ("static-ctr", phase_static_ctr),
                       ("rnn-layers", phase_rnn_layers),
                       ("train-seq2seq", phase_train_seq2seq),
                       ("beam-seq2seq", phase_beam_seq2seq),
                       ("c-trainer", phase_c_trainer),
                       ("sparse-scale", phase_sparse_scale)):
        del_all()
        paths.update(timed_phase(tag, phase, smi))
    _RN_DATA.clear()
    # autotune: these phases write the tuning table, so they come last
    del_all()
    timed_phase("cost-model", phase_cost_model, smi)
    paths.update(timed_phase("autotune-train", phase_autotune_train, smi))
    model = build_model()
    paths.update(timed_phase("autotune-live", phase_autotune_live, model,
                             smi))
    paths.update(timed_phase("qmm-sweep", phase_qmm_sweep, model, smi))
    del model
    del_all()
    timed_phase("faults", phase_faults, smi)
    timed_phase("report", phase_report, smi)
    # only the layer API's masked attention takes the composite: every
    # GPT path reads 0 composite calls
    composite = {p: n.get(COMPOSITE_KEY, 0) for p, n in paths.items()}
    stray = {p: c for p, c in composite.items() if c and p not in TB_PATHS}
    log(f"[done] attention composite calls by path: "
        f"{ {p: c for p, c in composite.items() if c} } (every other path "
        f"0: {not stray})")
    if stray:
        raise SystemExit(f"paths outside the layer API took the attention "
                         f"composite: {stray}")
    for key, rec in records.items():
        by_path = {p: n[key] for p, n in paths.items() if n[key]}
        rec["launches"] = sum(by_path.values())
        rec["launches_by_path"] = by_path
        if not by_path:
            raise SystemExit(f"{key} was launched on no path")
    # the fp8 cache keeps the megakernel engine on the composed step
    for key in ("decode_megakernel", "decode_megakernel_q",
                "paged_decode_megakernel", "paged_decode_megakernel_q"):
        records[key]["serve_fp8_mega_launches"] = paths["serve-fp8-mega"][key]
    log(f"[done] {time.perf_counter() - t0:.1f} s after the device check")
    keys = ["name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "max_row_rel_err", "row_tol",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"kernels": [
        {**{k: r[k] for k in keys}, **{k: v for k, v in r.items()
                                       if k not in keys}}
        for r in records.values()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))


if __name__ == "__main__":
    if sys.argv[1:] == ["--warmup-check"]:
        warmup_check()
    elif sys.argv[1:] == ["--fp8-teacher-error"]:
        fp8_teacher_error()
    elif sys.argv[1:] == ["--beam-fault"]:
        beam_fault_check()
    elif sys.argv[1:] == ["--moe-hit-routing"]:
        moe_hit_routing()
    elif sys.argv[1:] == ["--autotune-phases"]:
        autotune_phases()
    elif sys.argv[1:2] == ["--fault-child"] and len(sys.argv) == 4:
        fault_child(sys.argv[2], sys.argv[3])
    else:
        main()
