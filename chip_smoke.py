#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (mxnet_tpu_torch) on one
NVIDIA GPU (written for an H100, sm_90a).

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits nonzero:

1. device       — the card (torch and nvidia-smi).
2. build        — nvcc builds every kernel of csrc/ for sm_90a, in
                  parallel (one nvcc per source, started from a thread
                  while this process does the host work of later phases:
                  graph shapes, the zoo's parameters, the op cases' CPU
                  halves); then one line with
                  ptxas's registers and spills of every sm90
                  instantiation (gemm_sm90<...>, flash_fwd_sm90<D>).
3. kernels      — each kernel's wrapper on card tensors at every shape its
                  main path gives it (shapes read from the fused graphs at
                  32 rows), held against its plain PyTorch version with
                  TF32 off, timed on the device with CUDA events (median
                  of 20 after 5, L2 evicted before each launch) beside its
                  plain version, its bound, the nearest single PyTorch call
                  (library_ms) and its host cost per call.  fused_bn_relu:
                  float32 max abs error <= 1e-6, bfloat16 within one ulp.
                  fused_scale_bias_dot / fused_scale_bias_conv3x3: f32 and
                  bf16, |got - plain| <= rtol * (|A| . |W|) elementwise,
                  the product of the magnitudes (so the bound grows with
                  K), rtol 1e-4 (f32) and 2e-2 (bf16); plus a ragged
                  off-path dot and an odd-H stride-2 conv.  The GEMM and
                  conv kernels' bf16 path shapes must take the sm90 route
                  (TMA + wgmma, csrc/hopper_gemm.cuh, the conv's A through
                  TMA's im2col mode; f32 the simt one); each such case is
                  also run on the wmma route (the first design), checked
                  by the same rule and timed in turns with the sm90 launch
                  (wmma_ms), and each route's launch is timed on the host.
                  The conv takes w as the HWIO view of an OIHW weight, as
                  the path does; off the path on sm90: odd H and W at
                  stride 2 with F = 40 and M = 168, 7 x 9 images, a
                  positive bias at both strides, and a NaN input pixel
                  (exactly the outputs whose window covers it NaN).
                  fused_scale_bias_dot takes w as
                  the transposed view of the (N, K) 1x1 weight, as the
                  path does; off the path on sm90: K = 72 with a positive
                  bias and NaN past K in scale and bias (padding zeroed
                  after the prologue), M = 1001, the N = 72 tile at
                  BN = 64, a NaN row of x (exactly that output row NaN),
                  and w contiguous against the view (the same bits).
3b. lm-kernels  — the same for the transformer LM's kernels, at the shapes
                  of its aggressive training graph at 16 x 512 tokens, bf16
                  and f32: flash_attention ([128, 512, 64] causal; O
                  within 1e-4 (f32) / 2e-2 (bf16) of P . |V| elementwise,
                  lse within 1e-4 * (1 + |lse|); library_ms is
                  F.scaled_dot_product_attention; the bf16 path case on
                  the sm90 route (TMA + wgmma), the mma route (the first
                  design) checked and timed in turns, mma_ms) and
                  fused_dot_epilogue
                  ((8192, 512, 2048) with bias and relu; the GEMM rule
                  above, |A|.|W| + |bias|; library_ms is torch.addmm),
                  plus off-path cases: ragged causal attention with
                  tq < tk, non-causal, D = 128, Tq = 300 against Tk = 700
                  causal and not, one head (all sm90 in bf16), D = 40
                  (mma); a ragged dot with bias,
                  relu and clip (wmma route), one with no bias (sm90, the
                  N = 72 tile at BN = 64); on sm90 M = 1001, no bias with
                  a clip, and a NaN row through bias, relu and clip.
3c. bucket-kernels — the same two kernels at the bucketed path's shapes, in
                  float32 (its dtype; the simt routes), read from each
                  bucket's aggressive training graph at 16 rows:
                  flash_attention [128, T, 64] causal with Tq = Tk = T and
                  fused_dot_epilogue (16 T, 512, 2048) with bias and relu,
                  for T in 128, 200, 320, 512 (200 and 320 leave ragged
                  128-row tiles); the tolerances above, library_ms SDPA
                  (is_causal) and torch.addmm.
3d. rtc-kernels — kernel #6: mx.rtc.Rtc's CUDA-source form, NVRTC-compiled
                  for sm_90a and launched through the CUDA driver API
                  (csrc/rtc.cu), on card tensors, each case against its
                  plain PyTorch version and timed as above (plus the first
                  push's NVRTC seconds): the reference MXNet's GPU test
                  (expf(5x) through shared memory, within 2 ulp),
                  tests/test_rtc.py's axpy and square as CUDA bodies
                  (exact; a second shape compiles nothing, float16 a
                  second module), the softmax head of path 4 forward
                  (one read of each row; within rtol 1e-5 of
                  torch.softmax in float64; library_ms is torch.softmax)
                  and backward (128-bit; y - onehot(label), exact;
                  library_ms is torch.scatter_add of -1 at the labels)
                  at (32, 1000) and, off the path, at the LM head's
                  (8192, 32000), each held with the body it replaced (three
                  passes; scalar) to the same check and timed in turns
                  with it (old_body_ms) and with an empty body of the
                  same launch (floor_ms); host us of a push and of the
                  library call; a body with a syntax error raises with
                  NVRTC's log.
Main paths 1, 2, 3 and 5 run captured (whole-step capture: one CUDA
graph per bucket and batch signature, replayed), the default.  Beside
each, in the same call, the same steps run eagerly under NaiveEngine
from the same numpy state (EAGER_STEPS of them for train and lm-train,
the same requests and the same epoch for serve and bucket-train), and
the phase's line carries both: step ms (forward p50/p99 for serve; per
bucket for bucket-train), launches per step by kernel and route (they
must be equal), the parameters after those steps (held to
train-parity's bound), each graph's capture host ms and replays (the
graphs held), and peak allocated and reserved device memory.

4. serve       — main path 1: ModelServer serves full-width ResNet-50 v2
                  (1000 classes, 3x224x224, random weights from a numpy
                  seed, MXTPU_FUSE=aggressive, pow2 buckets up to 32
                  rows, each captured when the model loads): after one
                  warm-up request per bucket, 64 requests of 1-8 rows
                  from 4 client threads.  Launch counts are zeroed just
                  before and read just after; fused_bn_relu must launch
                  17 times per forward.
4b. fleet       — the serving fleet on one card: ModelServer serves the
                  serve phase's ResNet-50 v2 (f32, TF32 off, cuDNN
                  deterministic, pow2 buckets to 32 rows captured by every
                  replica before it serves) from 1, 2 and 4 replicas, each
                  its own Predictor on its own CUDA stream: 192 requests
                  of 1-8 rows from 16 client threads per count (images/s,
                  p50/p99, graphs held = replicas x buckets, reserved
                  memory, fused_bn_relu by replica: 17 per forward, every
                  flush on its replica's stream); at 2 replicas 25%
                  interactive 1-row and 75% batch 8-row requests (p99 by
                  lane), then 64 8-row requests with a deadline of half a
                  flush (the dropped ones counted and never executed);
                  at 2 replicas the count's traffic runs again under
                  torch.profiler: the card's busy share is the union of
                  its kernel intervals over that run's wall (at 1 and
                  4 replicas it is modelled from each bucket's replay
                  time); under
                  traffic scale_up 2 -> 3, reload_model to a second
                  parameter set and scale_down; under traffic, at 2
                  replicas, MXTPU_FAULTS wedges serve.execute.r1 and the
                  supervisor quarantines r1, replays its flush once and
                  attaches a captured replacement (detect->repair ms);
                  then two more reloads at one replica (reserved memory
                  flat).  Each request's rows carry tags, so every flush
                  of the changes and the wedge is rebuilt row for row
                  and run through one one-replica Predictor holding the
                  parameter set that served it: every response bit for
                  bit (and, for information, 16 responses alone at their
                  own bucket: the f32 difference between buckets).
                  fused_bn_relu runs at every bucket's shapes here (the
                  warm-ups, and the flushes of 1-32 rows): each of those
                  shapes, read from the graph, is held against
                  fused_bn_relu_plain (max abs err 1e-6, f32).
4c. autoscale   — the fleet's control and attribution planes: the same
                  model from one replica under
                  ModelServer.autoscale(slo_p99_ms=30, interval_s=0.25,
                  max_replicas=3, brownout=True, up_after=2,
                  down_after=3, down_frac=0.6) with servewatch on (slow
                  threshold = the SLO) and a flight recorder in a temp
                  dir.  A tick's p99 is read on quarter-decade histogram
                  edges (10, 17.8 ms) from ~17 requests, so a clear test
                  under 18 ms is one under the 17.8 ms edge; the default
                  0.5 (15 ms) would ask every request to end under 10
                  ms, 1.4x the light stage's p50.  Heavy load
                  (until brownout level 1 lands, 8-11 s on an H100, at
                  most 16 s; 16 clients, 75% batch 8-row / 25% interactive
                  1-row; a shed client backs off 20 ms), the same load
                  for 2 s more from level 1 (the brownout stage), then
                  light (2 interactive 1-row clients, 20 ms apart, 6 s
                  and on until the fleet is back at one replica; its
                  ticks are reported: how many, how many clear, the
                  longest clear run, their p99s).  The decision
                  log must show scale_up to 3, brownout level >= 1
                  (batch sheds counted), the ladder back to level 0 and
                  scale_down to 1, in that order; after every decision
                  (and its actuation) the graphs held = replicas x
                  buckets of the configured cap.  Reported: the log
                  (action, reason, windowed p99, replicas, max_batch,
                  level, ms since the start), ms from the first breach
                  window to the new replica's first flush, images/s and
                  p99 by lane and sheds per stage (a request belongs to
                  the stage it ended in; the brownout stage also split
                  by the ladder's level when each request ended),
                  fused_bn_relu by replica (17 a
                  forward, plus each capture's eager warm-up).  Every
                  delivered request's six servewatch spans sum to its
                  e2e span exactly; the median execute span at 32 rows
                  is at least a 32-row replay alone; the dumped trace
                  passes tools/check_trace.py (a subprocess); every
                  line of render_prometheus() parses, and an exemplar of
                  serving_e2e_secs names a request whose postmortem was
                  committed; postmortems committed and dropped, and each
                  dump's ms.  Every response against the one-replica
                  oracle (fleet's, its parameters copied back), bit for
                  bit at its bucket.  Then fleet's
                  2-replica traffic (192 requests of 1-8 rows, 16
                  clients) with servewatch off, then on: images/s, p99
                  and postmortem ms; a drain commits through the flight
                  recorder.
5. parity       — 4 rows through a served Predictor captured with TF32
                  off (a graph keeps the library kernels chosen when it
                  was recorded) and through a CPU Predictor: rtol 1e-3,
                  same top-1.
6. train        — main path 2: Module(resnet-50 v2, 1000 classes,
                  3x224x224, context=gpu(0), compute_dtype=bfloat16).fit
                  over an NDArrayIter of 10 batches of 32 random images and
                  labels, SGD lr 0.05 momentum 0.9 wd 1e-4,
                  MXTPU_FUSE=aggressive.  Counts zeroed just before fit and
                  read just after: per step 36 fused_scale_bias_dot and
                  16 fused_scale_bias_conv3x3 (all on the sm90 route) and
                  as
                  many fused_bn_relu as the training graph has _bn_relu
                  nodes.  Loss and parameters
                  finite, parameters moved; step ms (median after 2
                  warm-up steps), images/s, peak device memory.
7. train-parity — one fused step of the full-width model at 2 rows,
                  float32, TF32 off, on the card and on the CPU from the
                  same numpy parameters: updated parameters rtol 1e-3,
                  atol 1e-5, except isolated relu-kink flips (at most 1e-4
                  of the elements, none beyond 1e-3; see the phase).
8. lm-train     — main path 3, the JAX package's transformer-LM bench leg
                  (bench.py:958-994) through the port's
                  parallel.make_train_step: V=32000, E=512, 8 heads, 6
                  layers, T=512, 16 rows, bf16 compute over f32 masters,
                  SGD lr 0.01 momentum 0.9, MXTPU_FUSE=aggressive, N(0,
                  0.02²) weights from numpy RandomState(0), 10 steps.
                  Counts zeroed just before and read just after: 6
                  flash_attention and 6 fused_dot_epilogue (all on the
                  sm90 routes) per step.
                  Output and parameters finite, parameters moved;
                  cross-entropy of the first and last step (ln 32000 =
                  10.37), step ms (median after 2 warm-up steps),
                  tokens/s, peak device memory.
9. lm-parity    — one f32 step of the full-width LM at 2 x 512 tokens,
                  TF32 off, on the card and on the CPU from the same numpy
                  parameters, under train-parity's bound.
9b. bucket-train — main path 5: BucketingModule(transformer_lm
                  .sym_gen_bucketing(...), default_bucket_key=512,
                  context=gpu(0)).fit over a BucketSentenceIter of random
                  sentences of 64-512 tokens (a numpy seed; padding -1, so
                  Embedding's wrapped ids and SoftmaxOutput's zero one-hot
                  rows run on the card), buckets 128, 200, 320, 512, 16
                  rows, the LM of lm-train in float32 with TF32 off, SGD lr
                  0.01 momentum 0.9; one warm-up and 3 measured batches per
                  bucket.  Counts zeroed just before fit and read just
                  after: 6 flash_attention and 6 fused_dot_epilogue per
                  step, all simt.  Every bucket module's parameters,
                  gradients and optimizer state are the default bucket's
                  (same data_ptr, same objects); per bucket the median step
                  ms, padded and unpadded tokens/s and launches per step by
                  route; peak memory; then a fit with every bucket declared
                  under MXTPU_PRECOMPILE_BUCKETS, one batch per bucket: the
                  host ms of each bucket's first batch with the knob off and
                  on.
9c. bucket-parity — one fit step of bucket 200 at 4 rows (with padding),
                  float32, TF32 off, on the card and on the CPU from the
                  same numpy parameters, under train-parity's bound.
9d. sp          — main path 6: parallel.make_sp_train_step on a one-rank
                  NCCL group (init_process_group over a localhost TCP
                  store, a DeviceMesh with one 'seq' dimension), the LM of
                  lm-train at T=512 and 16 rows, 5 bf16 steps in each of
                  attn_mode 'ring' (plain PyTorch: no kernel launch) and
                  'ulysses' (all_to_all_single around flash_attention: 6
                  launches per step, all sm90); then one f32 step of each
                  mode against make_train_step on the same parameters and
                  batch, both on the card, under train-parity's bound.
                  Four ranks need four cards; their behaviour is held on
                  the CPU (tests/test_torch_sp.py, gloo).
10. imperative  — a fixed script of nd.* calls (one op of each family of
                  the imperative layer, NDArray arithmetic, indexing,
                  in-place updates, nd.Custom on the Sqr op of
                  tests/test_operator_custom.py) under `with mx.gpu(0):`
                  and on cpu() from the same numpy inputs: rtol 1e-5,
                  exact for integer, indexing and data-movement ops;
                  mx.random moments and seed determinism on each.
11. custom-train — main path 4: the train phase's model, data and
                  optimizer in float32, with SoftmaxOutput replaced by a
                  Custom head (op_type 'softmax_rtc', user code in this
                  file) whose operator pushes two Rtc kernels on the card.
                  The step is captured in segments (one forward graph,
                  the user's forward and backward between the replays,
                  one backward-and-update graph), with cuDNN
                  deterministic; then the same steps under NaiveEngine.
                  Counts zeroed just before each fit and read just after:
                  2 Rtc launches per step and the training graph's counts
                  of the other kernels (fused_scale_bias_dot and
                  fused_scale_bias_conv3x3 on the simt route), the user's
                  forward and backward once a step; parameters bit for
                  bit captured against NaiveEngine.  Loss and parameters
                  finite, parameters moved; step ms both ways, images/s,
                  peak device memory, each stage's ms; and the step ms of
                  one more captured run under the cuDNN setting of the
                  other phases (not deterministic), run first.
12. custom-parity — one f32 step of that model at 2 rows on the card (Rtc
                  head) and on the CPU (nd.* head, the same Custom op's
                  CPU operator), under train-parity's bound.
12b. optim-train — the training lifecycle, optimizers: the train phase's
                  model cut in depth to one bottleneck unit per stage
                  (OPTIM_UNITS; every width kept), its data and bf16
                  compute, OPTIM_STEPS (2) captured
                  steps under each of SGD with momentum, NAG, Adam,
                  AdaGrad and centered RMSProp (counts zeroed just before,
                  read just after: 12 + 4 sm90 and 2 fused_bn_relu per
                  step, as read from its graph), then the same steps from the same state under
                  NaiveEngine (launches per step by kernel and route
                  equal, parameters within train-parity's bound), then in
                  float32 (TF32 off) captured and through the Updater loop
                  (MXTPU_FUSED_FIT=0: forward_backward, then the
                  ops/optim.py update ops), held to the same bound; per
                  optimizer the step ms of each run, capture ms, peak
                  memory and the number of state tensors.
12c. checkpoint-resume — SGD with momentum, bf16, 2 epochs of 4 batches with
                  fit(checkpoint_prefix=...) and module_checkpoint(...,
                  save_optimizer_states=True) (launches per step as in
                  train); Module.load(prefix, 1, load_optimizer_states=
                  True, context=gpu(0)).fit(begin_epoch=1) against the
                  uninterrupted run's epoch-2 parameters, and
                  fit(auto_resume=True) from a prefix holding epoch 1
                  against Module.load without states (both restart the
                  momentum), each within train-parity's bound; ms to write
                  and read the .params (25.5 M f32) and .states files,
                  the resumed fit's first-step host ms (it captures),
                  checkpoint.commits and checkpoint.resumes.
12d. feedforward — FeedForward.create on the ResNet symbol (ctx=gpu(0),
                  float32 with TF32 off, 4 shuffled batches of 32), predict
                  and score on
                  64 images (17 fused_bn_relu per forward, counts zeroed
                  just before), save, FeedForward.load and predict again:
                  the predictions equal.  Then with TF32 on: the loaded
                  model held at the trained model's predict batch
                  (numpy_batch_size 32) predicts bit-identically; at its
                  own default (one 64-row batch) within FF_TF32_ATOL
                  (cuDNN's TF32 algorithm depends on the batch shape).
12e. lm-adam    — the LM of lm-train through Module.fit (bf16, Adam lr
                  1e-3, a device-folded Perplexity(ignore_label=None)), 5
                  steps captured (counts zeroed just before, read just
                  after: 6 flash_attention and 6 fused_dot_epilogue per
                  step, sm90) and under NaiveEngine: launches equal,
                  perplexity within 2e-2, parameters within
                  train-parity's bound; step ms, tokens/s.
12f. mirror-train — MXNET_BACKWARD_DO_MIRROR: the train phase's captured
                  ResNet fit step (bf16, 32 rows) and lm-train's captured
                  LM step, each MIRROR_STEPS (3) steps with the mirror
                  off, under 'dots' and under 'nothing' from the same
                  state, cuDNN deterministic: per run the step ms, peak
                  allocated and reserved memory, launches per step by
                  kernel and route (#1/#4, #3/#5 between once and twice
                  the unmirrored count: the recompute runs their forward
                  again), capture ms, and the parameters' gap to the
                  unmirrored run ('nothing' bit-identical, 'dots' within
                  train-parity's bound).
12g. monitor-fit — ResNet-50 v2 in f32 (TF32 off, cuDNN deterministic)
                  through Module.fit(monitor=Monitor(2, pattern
                  '.*(conv|fc).*')) over PrefetchingIter(ResizeIter(
                  NDArrayIter, 6)), 6 steps, beside the same fit
                  unmonitored (captured): step ms both ways, taps per
                  step and tap names, compile.capture_skipped (1: the
                  monitored module stays eager), and one monitored step
                  by hand: its forward launches no kernel (the original
                  symbol runs), its backward #1, #4 and #2 (the fused
                  training forward runs again).  The first monitored
                  step at PARITY_ROWS rows on the card and on the CPU:
                  stats within rtol 1e-3, parameters within
                  train-parity's bound.
12g2. observe-fit — the training observability planes on the train
                  phase's configuration (ResNet-50 v2, 32 rows, bf16,
                  captured, SGD), OBS_STEPS steps per run from the same
                  weights and batches, every run with cuDNN deterministic
                  and TF32 off: sentinels off, then warn (parameters bit
                  for bit equal, launches 36/2/16 a step in both,
                  health.host_syncs 0, metric.host_syncs equal; perfwatch
                  on in both, so the sentinels' cost is the difference of
                  the replays' mean device ms (perf.phase.dispatch), shown
                  beside the step ms medians after warm-up and held to no
                  bound); the fit.step fault site under
                  MXTPU_FAULTS='fit.step:delay:1.0:0.05', perfwatch on
                  (the median step grows by 45-60 ms); skip_update with a NaN pixel in
                  batch OBS_BAD (nan_steps 1, first = last = OBS_BAD;
                  parameters, optimizer state and aux after that step bit
                  for bit those after the step before; later steps
                  finite); abort on the same batch (TrainingDivergedError
                  (OBS_BAD, OBS_BAD, 1) and a flight record whose 'health'
                  key is filled); three planes (no chronicle), for their
                  step ms; then all four: the step's FLOPs (counted over
                  the warm-up before the capture) against the symbol's
                  analytic count of its convolutions and dots (equal),
                  MFU against the H100's 989 TFLOP/s at the replays'
                  device ms (perf.phase.dispatch, CUDA events) and at the
                  synchronised step, the perf.phase.* times, the top
                  memory-ledger entries, the goodput buckets (productive
                  + buckets, the ledger's wall by construction, within 2%
                  of the fit's wall timed by the script), the chronicle's
                  journal
                  samples and detector verdicts.
12h. mnist-lenet — MNISTIter over idx files written to a temporary
                  directory (60,000 seeded 28x28 images, MNIST's
                  training-set size; nothing downloaded): LeNet
                  (models/lenet.py) one epoch at batch 128, SGD, over
                  MNISTIter and PrefetchingIter(MNISTIter) with the device
                  feed off and over MNISTIter with it on: images/s and
                  the share of the epoch spent waiting on the iterator;
                  then CSVIter over a 10,000 x 784 CSV into the MLP
                  (models/mlp.py), one epoch.
12i. alexnet-train — AlexNet (models/alexnet.py, 1000 classes, 3x224x224,
                  32 rows) through Module.fit, float32 (TF32 off) and
                  bf16, 5 captured steps each (its Dropout draws inside
                  the graph): step ms, images/s; the two LRNs' forward +
                  backward at their path shapes timed alone, against the
                  f32 step.
12j. nn-ops     — each op this slice adds, forward and backward on the card
                  against the same call on the CPU (f32, TF32 off), at a
                  real user's shapes: Deconvolution at DCGAN's generator
                  layers (nz 100, ngf 64, 4x4, stride 2, 4 -> 64 pixels,
                  batch 64) and at examples/fcn_xs.py's 2x upsampling (21
                  classes) with its Crop; UpSampling x2 nearest and
                  bilinear at (8, 256, 56, 56); LRN at (32, 96, 55, 55);
                  L2Normalization (channel) at (32, 512, 38, 38);
                  CuDNNBatchNorm; SequenceLast / SequenceMask /
                  SequenceReverse at (512, 16, 512) with lengths; the
                  regression outputs and SVMOutput at (32, 1000);
                  softmax_cross_entropy at (2048, 32000).  Max abs error
                  against rtol 1e-4 of the largest |CPU value| per tensor
                  (exact for Crop and the Sequence ops), and ms.
12k. lstm-ptb   — the PTB LSTM (BASELINE config 4): the JAX package's
                  bench leg (bench.py:914-955: lstm_lm, V=10000, E=H=200,
                  2 layers, T=35, 32 rows, f32, SGD lr 0.1 momentum 0.9,
                  its RandomState(0) draws) through make_train_step, 22
                  steps captured (words/s from the last 20) and 3 under
                  NaiveEngine (parameters bit for bit), one f32 step at 2
                  rows on the card against the CPU; then BucketingModule(
                  lstm_lm.sym_gen_bucketing(...)).fit over a
                  BucketSentenceIter of seeded sentences in the example's
                  buckets 10-60 (3 batches each), captured and eager:
                  per bucket step ms and unpadded words/s.  The RNN op is
                  cuDNN through torch (no Pallas kernel in the JAX op).
12l. ssd        — SSD (BASELINE config 5): ssd-vgg16 (20 classes), saved
                  with model.save_checkpoint and served by predictor.load
                  at 8 x 3 x 300 x 300 (7308 anchors, pow2 buckets
                  captured by warm_buckets), 10 forwards captured and under
                  NaiveEngine (bit for bit; one multibox_nms launch a
                  forward); Predictor.reshape to one row against a fresh
                  Predictor (bit for bit); multibox_nms on the served
                  forward's own rows against its plain loop (row for
                  row), both timed, its bound from the IoU tests this
                  run's rows need; each of its two kernels (the masks,
                  the scan) timed from torch.profiler's records and
                  counted in one traced served forward, phase A's words
                  against the plain transcription's, the workspace
                  bytes and the pairs phase A tests (from the rows); a
                  per-class case off the path.
                  ssd-train: Module.fit on ssd-vgg16-train, 8 rows,
                  seeded boxes, f32, 4 steps captured and eager, the
                  example's lr over the localisation loss's valid count
                  (MakeLoss does not normalize it, as in the JAX op).
12m. zoo-train  — Inception-v3 (32 x 299 x 299: #2 84 and #4 10 launches
                  a step) and VGG-16 (32 x 224 x 224: #3 2 a step) through
                  Module.fit in bf16, captured against NaiveEngine.
12n. zoo-eval   — make_eval_step forwards at 32 rows in bf16:
                  Inception-v3 under MXTPU_FUSE=safe and =aggressive (its
                  conv+BN pairs folded), VGG-16; one captured served
                  forward of 8 rows of inception-bn, googlenet (256 x 256),
                  resnext-50 and inception-resnet-v2 against eager.
12o. zoo-kernels — #2, #4 and #3 at every shape the Inception-v3 and
                  VGG-16 training graphs give them (bf16), and #2 at every
                  shape the four served classifiers' inference graphs give
                  it at 8 rows (f32), against their plain versions by the
                  checks of phase 3.  tail-ops: the
                  12 ops of this slice on the card against the CPU at a
                  user's shapes (the PTB LSTM's RNN, lstm_ocr's CTC, an
                  STN, Fast R-CNN's ROIPooling, FlowNetC's Correlation, a
                  sparse autoencoder, SSD's heads).
13. capture     — the cuda tests of tests/test_torch_capture.py,
                  tests/test_torch_lifecycle.py and
                  tests/test_torch_observe_cuda.py in a child pytest, started
                  before phase 2 (it runs while this process builds) and
                  waited for before phase 3 times the card; the
                  lifecycle ones: each optimizer's captured narrow-ResNet
                  step against NaiveEngine and the Updater loop;
                  load_optimizer_states into a module that holds graphs
                  (the same graph replays after, no recapture); checkpoints
                  at two steps in flight against one; a mirrored captured
                  step against the unmirrored one (both policies); a
                  monitored step's forward and backward launches.  Each
                  capture test
                  is a behaviour of capture held against eager:
                  an lr schedule that lowers the lr at step 3 changes the
                  captured update; a metric with no device form reads
                  each replay's outputs with two steps in flight; a
                  warm-started fit equals a cold one
                  and the step window reaches 2 steps in flight;
                  alternating buckets share one set of parameters and a
                  bucket's outputs survive another's replay; a served
                  forward's arrays survive the next forward; set_params
                  drops the graphs and the next step trains the new
                  values; random nodes draw anew per replay; a host sync
                  raises naming its node; a Custom graph stays eager.
                  The observability ones: skip_update restores a captured
                  step bit for bit, the probe only reads, abort raises at
                  the drain, perfwatch counts the step before its capture.
14. mesh-fit    — the dp x tp product path in one process: ResNet-50 v2
                  (bf16 over f32 masters, 32 rows, SGD momentum, cuDNN
                  deterministic, MESH_STEPS captured steps) unmeshed, then
                  fit(mesh='1x1', partition='auto'): parameters, aux and
                  the metric bit for bit, #1/#4/#2 at 36/16/2 a step from
                  replays, each fit's step ms; the '1x1' fit writes an
                  MXTPU_COMPILE_CACHE's manifest, and the same fit in a
                  second process with MXTPU_WARM_START warms from it: 0
                  captures on its hot path, its parameters this one's.
15. mesh-ranks  — ranks sharing the card on gloo (tools/launch.py over
                  --mesh-worker): '2x1' replicated, '1x2' and '2x2' auto,
                  ResNet-50 v2 f32 (TF32 off) over the global batch of 32
                  rows, MESH_RANK_STEPS eager steps (see mesh_ranks: the
                  launches of every rank, the parameters against a
                  one-process '1x1' fit within the f32 noise floor measured
                  in the same run, each rank's optimizer-state bytes, the
                  step's collectives against the ring formula, '1x1' moving
                  0 bytes, the step ms split into compute, reduce-scatter,
                  all-gather and BatchNorm all-reduce).  The ranks' kernel
                  shapes (f32 at 16 and 32 rows) are kv-local's and the
                  kernels phase's cases.

16. serve-mesh  — the serving side of the mesh: full-width ResNet-50 v2
                  (f32, TF32 off, cuDNN deterministic) served by
                  ModelServer from one unsharded replica, from a '1x1'
                  replica built by load_model(mesh='1x1',
                  partition='auto') (the server carves the one card) and
                  from prebuilt Predictor(mesh='1x2' | '2x1' | '2x2',
                  partition='auto', devices=[gpu(0)] * dp*tp): each warmed
                  to 32 rows (every slot graph captured), then 64 requests
                  of 1-32 rows from 4 threads.  Every flush is rebuilt row
                  for row (tags in pixel [0, 0, 0]) and each response held
                  bit for bit against the unsharded Predictor run on each
                  dp slot's B/dp rows; compile.traces frozen while
                  serving.sharded_aot_calls counts every flush;
                  fused_bn_relu 17 times a slot forward; per mesh p50/p99
                  and images/s beside the unsharded replica's, each
                  position's parameter bytes against sharding_records()'s
                  shard bytes, peak allocated bytes during a 32-row
                  forward, graphs and reserved bytes; on the one card
                  load_model(mesh='1x2') raises the carve's error and a
                  sharded model's replica_capacity is 1 (scale_up None).
17. group2ctx   — the model-parallel LSTM LM of
                  examples/model_parallel_lstm.py on the port's rnn cells at
                  the PTB widths (V 10000, E = H = 200, 2 layers, T 35, 32
                  rows, f32, TF32 off), groups embed / layer0 / layer1 /
                  decode all on gpu(0), then embed on cpu(0) (host <->
                  card copies forward and backward), then bound with no
                  group2ctx: the first step's output and gradients within
                  rtol 1e-5 across the three, each gradient on its
                  variable's device, the loss falling over 10 SGD steps in
                  each, step ms.

Then the card's nvidia-smi line, the kernels summary line (the entries of
the GEMM, conv and attention kernels also carry path_route,
launches_by_route, wmma_ms (attention: mma_ms), host_us and
launch_host_us), and the result line {"ok": true,
"device": {...}}.  Without a CUDA device, or
without the mxnet_tpu_torch package beside it, the script exits nonzero
and prints no result.
"""
import atexit
import gc
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from collections import Counter

import numpy as np

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
FP32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12             # H100 SXM dense bf16 on the tensor cores
GEMM_RTOL = {'float32': 1e-4, 'bfloat16': 2e-2}
# the route each GEMM kernel must take at the training paths' shapes
PATH_ROUTE = {'bfloat16': 'sm90', 'float32': 'simt'}
# flash_attention: bf16 rounds P for the PV product and O on each side (3 *
# 2^-8 of P.|V|, ops/attention.py); f32 differs in summation order only
ATT_RTOL = {'float32': 1e-4, 'bfloat16': 2e-2}
LSE_RTOL = 1e-4
# the transformer LM of the JAX package's bench leg (bench.py:958-994)
LM = dict(vocab_size=32000, num_embed=512, num_heads=8, num_layers=6,
          seq_len=512)
LM_BATCH = 16
LM_STEPS = 10
LM_PARITY_ROWS = 2
# the bucketed LM (main path 5): the bench leg's width over length
# buckets (200 and 320 are no multiple of the 128-row tile), float32
BUCKETS = (128, 200, 320, 512)
BUCKET_MIN_LEN = 64         # sentences of BUCKET_MIN_LEN to 512 tokens
BUCKET_ROWS = 16
BUCKET_STEPS = 3            # measured batches per bucket, after one warm-up
BUCKET_PARITY = (200, 4)    # (bucket, rows) of the card-vs-CPU step
# sequence parallelism (main path 6): one NCCL rank, the LM at T=512
SP_STEPS = 5
SP_SEQ_PARAMS = ('pos_embed_weight',)
BATCH = 32
SGD_MOMENTUM = {'learning_rate': 0.05, 'momentum': 0.9, 'wd': 1e-4}
TRAIN_BATCHES = 10
TRAIN_WARMUP = 2
# the eager (NaiveEngine) run beside each captured main path: its first
# steps from the same numpy state
EAGER_STEPS = 3
# the card tests the capture phase runs (tests/test_torch_capture.py)
CAPTURE_CHECKS = (
    'test_fit_step_captured_matches_eager',
    'test_lm_train_step_captured_matches_eager',
    'test_predictor_bucket_captured_matches_eager',
    'test_lr_schedule_changes_the_captured_update',
    'test_host_metric_reads_each_replays_outputs',
    'test_warm_started_fit_equals_cold_fit_and_window_overlaps',
    'test_buckets_share_parameters_and_keep_their_outputs',
    'test_set_params_drops_the_graphs',
    'test_dropout_draws_a_new_mask_on_each_replay',
    'test_host_sync_under_capture_raises_naming_the_node',
    'test_custom_graph_is_captured_in_segments[before_head]',
    'test_custom_graph_is_captured_in_segments[mid]')
# ... and of tests/test_torch_warm_cuda.py (warm starts across processes)
WARM_CHECKS = (
    'test_rtc_cubin_store_across_processes',
    'test_warm_start_captures_the_manifest_signatures_off_the_hot_path')
# ... and of tests/test_torch_lifecycle.py (optimizers, .states, depth 2)
LIFECYCLE_CHECKS = tuple(
    'test_captured_optimizer_matches_eager_and_loop[%s]' % o
    for o in ('sgd', 'nag', 'adam', 'adagrad', 'rmsprop')) + (
    'test_load_optimizer_states_into_a_captured_module',
    'test_checkpoints_at_depth_two_on_the_card',
    'test_mirrored_captured_step_matches_unmirrored[nothing]',
    'test_mirrored_captured_step_matches_unmirrored[dots]',
    'test_monitored_step_runs_no_fused_forward')
# ... and of tests/test_torch_observe_cuda.py (the observability planes)
OBSERVE_CHECKS = (
    'test_captured_skip_update_restores_the_step_bit_for_bit',
    'test_captured_probe_only_reads',
    'test_captured_abort_raises_at_the_drain',
    'test_perfwatch_on_the_captured_step') + tuple(
    'test_each_wrapper_reports_its_analytic_flops[%s]' % k
    for k in ('fused_scale_bias_dot', 'fused_dot_epilogue',
              'fused_scale_bias_conv3x3', 'flash_attention',
              'fused_bn_relu'))
# observe-fit: steps per run, the batch that carries a NaN pixel, the
# fault plan of the fit.step site and the step growth it must show (ms)
OBS_STEPS = 10
OBS_BAD = 4
OBS_FAULT = 'fit.step:delay:1.0:0.05'
OBS_FAULT_MS = (45.0, 60.0)
OBS_CHRONICLE_MS = 100
# optim-train: each optimizer's captured ResNet step beside NaiveEngine and
# the Updater loop (MXTPU_FUSED_FIT=0), OPTIM_STEPS steps from one state,
# on ResNet-50 v2's four stages at full width cut to one unit each (depth)
OPTIM_STEPS = 2
OPTIM_UNITS = [1, 1, 1, 1]
OPTIMIZERS = (
    ('sgd', SGD_MOMENTUM),
    ('nag', SGD_MOMENTUM),
    ('adam', {'learning_rate': 0.001, 'wd': 1e-4}),
    ('adagrad', {'learning_rate': 0.01, 'wd': 1e-4}),
    ('rmsprop', {'learning_rate': 0.001, 'centered': True, 'wd': 1e-4}))
# checkpoint-resume: 2 epochs of CKPT_BATCHES batches; feedforward:
# FeedForward.create over FF_ROWS images, predict/score on FF_EVAL_ROWS
CKPT_BATCHES = 4
FF_ROWS = 128
FF_EVAL_ROWS = 64
# predicted probabilities of one model at two batch shapes under TF32:
# cuDNN's TF32 rounds each operand to 10 mantissa bits (2^-11 relative),
# and a different algorithm at another batch rounds otherwise
FF_TF32_ATOL = 2e-3
# lm-adam: the LM through Module.fit, Adam, a device-folded Perplexity
LM_ADAM_STEPS = 5
LM_ADAM = {'learning_rate': 0.001}
PARITY_ROWS = 2
IMAGE = (3, 224, 224)
N_REQUESTS = 64
N_CLIENTS = 4
SEED = 0


_START = time.monotonic()


def log(obj):
    """One JSON line; a phase's line also carries ``at_s``, the seconds
    since the script started (the whole run has a time budget)."""
    if 'phase' in obj:
        obj = dict(obj, at_s=time.monotonic() - _START)
    print(json.dumps(obj), flush=True)


def reset_launches(kernel):
    """Zero a wrapper's launch count (and its counts by route)."""
    kernel.launches = 0
    if hasattr(kernel, 'launches_by_route'):
        kernel.launches_by_route = dict.fromkeys(kernel.launches_by_route, 0)


def nvidia_smi():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bn_relu_shapes(mx, symbol, batch, image=IMAGE):
    """Counter of the input shapes the fused BN-ReLU nodes of the
    aggressive inference graph receive at ``batch`` rows of ``image``."""
    # parameter shapes from the unfused graph: a fused epilogue node does
    # not complete its inputs' shapes (:func:`graph_kernel_shapes`)
    arg_shapes, _, _ = symbol.infer_shape(data=(batch,) + image)
    prog = mx.fuse.apply_fuse_passes(symbol, False, 'aggressive')
    internals = prog.get_internals()
    _, out_shapes, _ = internals.infer_shape(
        **dict(zip(symbol.list_arguments(), arg_shapes)))
    shape_of = dict(zip(internals.list_outputs(), out_shapes))
    shapes = Counter()
    for n in prog.topo_nodes():
        if n.op == '_bn_relu':
            src, idx = n.inputs[0]
            shapes[tuple(shape_of[src.output_names()[idx]])] += 1
    return shapes


# a device time is the median of 20 runs after 5 warm-up runs, a host
# time the median of 50 calls: enough for a median, and the whole script
# has a time budget
def cuda_ms_each(torch, fns, flush, reps=20, warmup=5):
    """Median device time (ms) of each of ``fns`` from CUDA events, the
    functions launched in turns, run after run, so that all see the same
    card state.  Before each run a read of ``flush`` (larger than the 50 MB
    L2) evicts the inputs; a read leaves no dirty lines whose write-back
    would land in the timed run.  A spin kernel first holds the stream
    while the host enqueues every run, so the events bracket device work
    only and not the host's Python/launch overhead (see :func:`host_us`)."""
    torch.cuda.synchronize()
    # ~1 ms of spin (at 1.98 GHz) for each run the host enqueues behind it
    torch.cuda._sleep(2_000_000 * (warmup + reps) * len(fns))
    pairs = [[] for _ in fns]
    for _ in range(warmup + reps):
        for fn, runs in zip(fns, pairs):
            flush.sum()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            runs.append((start, end))
    torch.cuda.synchronize()
    return [statistics.median(s.elapsed_time(e) for s, e in runs[warmup:])
            for runs in pairs]


def cuda_ms(torch, fn, flush, reps=20, warmup=5):
    """Median device time (ms) of ``fn`` (:func:`cuda_ms_each`)."""
    return cuda_ms_each(torch, (fn,), flush, reps, warmup)[0]


def host_us(torch, fn, reps=50):
    """Median host time of one ``fn`` call (us): the wrapper's checks,
    allocation and launch, without waiting for the device."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
        if len(times) % 50 == 0:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def bf16_ulp(v):
    a = np.maximum(np.abs(v), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(a)) - 7).astype(np.float32)


def bn_relu_error(torch, fused, shape, dtype, gen):
    """fused_bn_relu against fused_bn_relu_plain at ``shape`` on the card:
    ((x, scale, bias), max abs err, tolerance); raises past the
    tolerance."""
    dev = torch.device('cuda', 0)
    c = shape[1]
    x = torch.randn(shape, generator=gen, device=dev).to(dtype)
    s = (torch.rand(c, generator=gen, device=dev) + 0.5).to(dtype)
    b = (torch.randn(c, generator=gen, device=dev) * 0.5).to(dtype)
    got = fused.fused_bn_relu(x, s, b)
    want = fused.fused_bn_relu_plain(x, s, b)
    torch.cuda.synchronize()
    if got.dtype != dtype or got.shape != x.shape:
        raise AssertionError('fused_bn_relu %s %s: got %s %s'
                             % (shape, dtype, got.dtype, tuple(got.shape)))
    g, w = got.float().cpu().numpy(), want.float().cpu().numpy()
    if not np.all(np.isfinite(g)):
        raise AssertionError('fused_bn_relu %s: non-finite output' % (shape,))
    err = float(np.max(np.abs(g - w)))
    if dtype == torch.float32:
        tol_ok, tol = err <= 1e-6, '1e-6'
    else:
        tol_ok = bool(np.all(np.abs(g - w) <=
                             bf16_ulp(np.maximum(np.abs(g), np.abs(w)))))
        tol = '1 bf16 ulp'
    if not tol_ok:
        raise AssertionError('fused_bn_relu %s %s disagrees with its plain '
                             'version: max abs err %g (tolerance %s)'
                             % (shape, dtype, err, tol))
    return (x, s, b), err, tol


def check_bn_relu(torch, fused, shape, dtype, gen, flush):
    """One fused_bn_relu case on the card: error vs plain, times, bound."""
    (x, s, b), err, tol = bn_relu_error(torch, fused, shape, dtype, gen)
    c = shape[1]
    ms = cuda_ms(torch, lambda: fused.fused_bn_relu(x, s, b), flush)
    plain_ms = cuda_ms(torch, lambda: fused.fused_bn_relu_plain(x, s, b),
                       flush)
    wrapper_us = host_us(torch, lambda: fused.fused_bn_relu(x, s, b))
    numel = x.numel()
    nbytes = 2 * numel * x.element_size() + 2 * c * 4
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = 3 * numel / FP32_FLOPS * 1e3
    return {'shape': list(shape), 'dtype': str(dtype).replace('torch.', ''),
            'max_abs_err': err, 'tolerance': tol, 'ms': ms,
            'plain_ms': plain_ms, 'host_us': wrapper_us,
            'bound_ms': max(byte_ms, op_ms),
            'bound_by': 'bytes' if byte_ms >= op_ms else 'operations',
            'bytes': nbytes}


def train_kernel_shapes(mx, symbol, batch, image=IMAGE):
    """The shapes the aggressive TRAINING graph gives each kernel at
    ``batch`` rows of ``image``, read from the graph: Counters of dot (M,
    K, N), conv (N, H, W, C, F, stride) and BN-ReLU input shapes."""
    prog = mx.fuse.apply_fuse_passes(symbol, True, 'aggressive')
    internals = prog.get_internals()
    _, out_shapes, _ = internals.infer_shape(data=(batch,) + image)
    shape_of = dict(zip(internals.list_outputs(), out_shapes))
    dots, convs, bn_relus = Counter(), Counter(), Counter()
    for n in prog.topo_nodes():
        if n.op not in ('_bn_relu_conv', '_bn_relu'):
            continue
        src, idx = n.inputs[0]
        d = tuple(shape_of[src.output_names()[idx]])
        if n.op == '_bn_relu':
            bn_relus[d] += 1
            continue
        nb, h, w, c = d if n.attrs.get('in_layout') == 'NHWC' else \
            (d[0], d[2], d[3], d[1])
        f = int(n.attrs['num_filter'])
        stride = tuple(n.attrs['stride'])[0]
        if tuple(n.attrs['kernel']) == (1, 1):
            oh, ow = (h - 1) // stride + 1, (w - 1) // stride + 1
            dots[(nb * oh * ow, c, f)] += 1
        else:
            convs[(nb, h, w, c, f, stride)] += 1
    return dots, convs, bn_relus


def routed_call(kernel, fn):
    """``fn()`` and the route of the one launch of ``kernel`` it made,
    read from the wrapper's ``launches_by_route``."""
    before = dict(kernel.launches_by_route)
    out = fn()
    moved = [r for r, n in kernel.launches_by_route.items()
             if n != before[r]]
    if len(moved) != 1 or kernel.launches_by_route[moved[0]] != \
            before[moved[0]] + 1:
        raise AssertionError('expected one launch on one route, got %s'
                             % {r: kernel.launches_by_route[r] - before[r]
                                for r in before})
    return out, moved[0]


def _gemm_err(torch, name, dt, got, want, magnitude, nan_row):
    """max |got - want| / magnitude elementwise, after checking dtype and
    shape, and that only ``nan_row`` (if any) holds NaN, in every
    element; that row is left out of the comparison."""
    if str(got.dtype).replace('torch.', '') != dt or \
            got.shape != want.shape:
        raise AssertionError('%s %s: got %s %s, want %s' % (
            name, dt, got.dtype, tuple(got.shape), tuple(want.shape)))
    if nan_row is not None:
        nan = torch.isnan(got.float())
        rows = [int(r) for r in torch.nonzero(nan.any(1)).flatten()]
        if rows != [nan_row] or not bool(nan[nan_row].all()):
            raise AssertionError('%s %s: a NaN in row %d of x reached '
                                 'output rows %s (all of its row: %s)'
                                 % (name, dt, nan_row, rows[:8],
                                    bool(nan[nan_row].all())))
        keep = torch.ones(got.shape[0], dtype=torch.bool, device=got.device)
        keep[nan_row] = False
        got, want, magnitude = got[keep], want[keep], magnitude[keep]
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError('%s %s: non-finite output' % (name, dt))
    err = (got.float() - want.float()).abs()
    ratio = float((err / magnitude.clamp_min(1e-30)).max())
    if ratio > GEMM_RTOL[dt]:
        raise AssertionError('%s %s disagrees with its plain version: '
                             'max |err| / (|A|.|W|) = %g > %g (max abs err '
                             '%g)' % (name, dt, ratio, GEMM_RTOL[dt],
                                      float(err.max())))
    return float(err.max()), ratio


def _gemm_case(torch, name, dtype, got, want, magnitude, timed, nbytes,
               flops, flush, route=None, launches=None, nan_row=None):
    """Check ``got`` against ``want`` elementwise within rtol * magnitude
    (|A| . |W|, the bound a K-term sum's rounding scales with), then time
    the kernel, the plain version and the library call.  ``route``: the
    route ``got`` took; ``launches``: route -> the same call forced onto
    that route (the taken one, and for a bf16 call on sm90 also 'wmma'),
    each checked by the same rule and timed for its host cost; the wmma
    route's device time (wmma_ms) is taken in turns with the kernel's."""
    dt = str(dtype).replace('torch.', '')
    torch.cuda.synchronize()
    max_err, ratio = _gemm_err(torch, name, dt, got, want, magnitude,
                               nan_row)
    launches = launches or {}
    route_errs = {}
    for r, fn in launches.items():
        out = fn()
        torch.cuda.synchronize()
        route_errs[r] = _gemm_err(torch, '%s (%s route)' % (name, r), dt,
                                  out, want, magnitude, nan_row)[1]
    kernel, plain, library = timed
    peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = flops / peak * 1e3
    wmma = launches.get('wmma') if route == 'sm90' else None
    if wmma is not None:
        ms, wmma_ms = cuda_ms_each(torch, (kernel, wmma), flush)
    else:
        ms, wmma_ms = cuda_ms(torch, kernel, flush), None
    case = {'dtype': dt, 'max_abs_err': max_err,
            'max_err_over_magnitude': ratio,
            'tolerance': '%g * (|A|.|W|)' % GEMM_RTOL[dt],
            'ms': ms, 'plain_ms': cuda_ms(torch, plain, flush),
            'library_ms': cuda_ms(torch, library, flush),
            'host_us': host_us(torch, kernel),
            'bound_ms': max(byte_ms, op_ms),
            'bound_by': 'bytes' if byte_ms >= op_ms else 'operations',
            'bytes': nbytes, 'flops': flops}
    if route is not None:
        case.update(route=route, wmma_ms=wmma_ms,
                    route_err_over_magnitude=route_errs,
                    launch_host_us={r: host_us(torch, fn)
                                    for r, fn in launches.items()})
    if nan_row is not None:
        case['nan_row'] = nan_row
    return case


def check_dot(torch, fused, mkn, dtype, gen, flush, positive_bias=False,
              nan_row=None):
    """One fused_scale_bias_dot case (relu on, as on the path), w passed
    as the transposed view of an (N, K) 1x1 weight, as the fuse pass
    passes it.  ``positive_bias``: bias > 0, and scale and bias are views
    of buffers whose elements past K are NaN, so that a padded channel
    not zeroed after the prologue (relu(bias) > 0 against TMA's zeros) or
    a scale or bias read past K shows in Y.  ``nan_row``: x holds a NaN
    in that row, which must reach exactly that output row."""
    dev = torch.device('cuda', 0)
    m, k, n = mkn
    x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
    if nan_row is not None:
        x[nan_row, k // 3] = float('nan')
    w = (torch.randn(n, k, generator=gen, device=dev) / k ** 0.5) \
        .to(dtype).t()
    s = torch.rand(k, generator=gen, device=dev) + 0.5
    b = torch.randn(k, generator=gen, device=dev) * 0.5
    if positive_bias:
        buf = torch.full((2, k + 64), float('nan'), device=dev)
        buf[0, :k], buf[1, :k] = s, b.abs() + 0.1
        s, b = buf[0, :k], buf[1, :k]
    kernel = fused.fused_scale_bias_dot
    got, route = routed_call(kernel, lambda: kernel(x, w, s, b, relu=True))
    want = fused.fused_scale_bias_dot_plain(x, w, s, b, relu=True)
    xa = torch.relu(x.float() * s + b).to(dtype)   # the normalized input
    magnitude = torch.matmul(xa.float().abs(), w.float().abs())
    launches = {r: (lambda r=r: fused._dot_launch(x, w, s, b, True, r))
                for r in ((route, 'wmma') if route == 'sm90' else (route,))}
    case = _gemm_case(
        torch, 'fused_scale_bias_dot', dtype, got, want, magnitude,
        (lambda: kernel(x, w, s, b, relu=True),
         lambda: fused.fused_scale_bias_dot_plain(x, w, s, b, relu=True),
         lambda: torch.matmul(xa, w)),
        (m * k + k * n + m * n) * x.element_size() + 2 * k * 4,
        2 * m * n * k, flush, route, launches, nan_row)
    case['mkn'] = list(mkn)
    if positive_bias:
        case['positive_bias_nan_tail'] = True
    return case


def check_dot_layouts(torch, fused, mkn, gen):
    """fused_scale_bias_dot with w as the transposed view of an (N, K)
    weight (the path) and as a contiguous (K, N) copy of it: the same
    route and the same bits."""
    dev = torch.device('cuda', 0)
    m, k, n = mkn
    x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
    w = (torch.randn(n, k, generator=gen, device=dev) / k ** 0.5) \
        .bfloat16().t()
    s = torch.rand(k, generator=gen, device=dev) + 0.5
    b = torch.randn(k, generator=gen, device=dev) * 0.5
    kernel = fused.fused_scale_bias_dot
    view, route = routed_call(kernel, lambda: kernel(x, w, s, b, relu=True))
    copy, route_c = routed_call(
        kernel, lambda: kernel(x, w.contiguous(), s, b, relu=True))
    torch.cuda.synchronize()
    if (route, route_c) != ('sm90', 'sm90') or not torch.equal(view, copy):
        raise AssertionError('fused_scale_bias_dot %s: the transposed view '
                             '(%s) and the contiguous w (%s) disagree'
                             % (mkn, route, route_c))
    return {'mkn': list(mkn), 'route': route, 'bit_equal': True}


def _conv_inputs(torch, shape, dtype, gen, positive_bias=False):
    """x, w (the HWIO view of an OIHW weight, as the fuse pass passes
    it), scale, bias of one conv case; ``positive_bias``: bias > 0, so
    that a halo row left at relu(bias) instead of 0 shows."""
    dev = torch.device('cuda', 0)
    n, h, wd, c, f, _ = shape
    x = torch.randn(n, h, wd, c, generator=gen, device=dev).to(dtype)
    w = (torch.randn(f, c, 3, 3, generator=gen, device=dev)
         / (9 * c) ** 0.5).to(dtype).permute(2, 3, 1, 0)
    s = torch.rand(c, generator=gen, device=dev) + 0.5
    b = torch.randn(c, generator=gen, device=dev) * 0.5
    if positive_bias:
        b = b.abs() + 0.1
    return x, w, s, b


def _conv_magnitude(torch, x, w, s, b, stride):
    """conv(|relu(x s + b)|, |w|): the bound a 9C-term sum's rounding
    scales with."""
    import torch.nn.functional as F
    xa = torch.relu(x.float() * s + b).to(x.dtype)   # the normalized input
    return F.conv2d(xa.float().abs().permute(0, 3, 1, 2),
                    w.float().abs().permute(3, 2, 0, 1), None, stride,
                    1).permute(0, 2, 3, 1)


def check_conv(torch, fused_conv, shape, dtype, gen, flush,
               positive_bias=False):
    """One fused_scale_bias_conv3x3 case (relu on, as on the path): the
    GEMM rule against the plain version, on the route the wrapper takes
    and (bf16 on sm90) on the wmma route, timed in turns."""
    import torch.nn.functional as F
    n, h, wd, c, f, stride = shape
    x, w, s, b = _conv_inputs(torch, shape, dtype, gen, positive_bias)
    kernel = fused_conv.fused_scale_bias_conv3x3
    got, route = routed_call(kernel, lambda: kernel(x, w, s, b, stride))
    want = fused_conv.fused_scale_bias_conv3x3_plain(x, w, s, b, stride)
    magnitude = _conv_magnitude(torch, x, w, s, b, stride)
    xa = torch.relu(x.float() * s + b).to(dtype)
    xa_cl = xa.permute(0, 3, 1, 2)     # NCHW view of NHWC memory
    w_cl = w.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    oh, ow = fused_conv.conv3x3_out_hw(h, wd, stride)
    launches = {r: (lambda r=r: fused_conv._launch(x, w, s, b, stride, True,
                                                   r))
                for r in ((route, 'wmma') if route == 'sm90' else (route,))}
    case = _gemm_case(
        torch, 'fused_scale_bias_conv3x3', dtype, got, want, magnitude,
        (lambda: kernel(x, w, s, b, stride),
         lambda: fused_conv.fused_scale_bias_conv3x3_plain(x, w, s, b,
                                                           stride),
         lambda: F.conv2d(xa_cl, w_cl, None, stride, 1)),
        (n * h * wd * c + 9 * c * f + n * oh * ow * f) * x.element_size()
        + 2 * c * 4,
        2 * n * oh * ow * f * 9 * c, flush, route, launches)
    case['nhwcf_stride'] = list(shape)
    if positive_bias:
        case['positive_bias'] = True
    return case


def check_conv_nan_pixel(torch, fused_conv, shape, pixel, gen):
    """A NaN in one channel of input pixel (n, ih, iw) must reach exactly
    the outputs whose 3x3 window covers that pixel, in all F channels;
    every other output within the GEMM rule of the plain version on the
    input with the NaN zeroed.  bf16, the route the wrapper takes."""
    n, h, wd, c, _, stride = shape
    x, w, s, b = _conv_inputs(torch, shape, torch.bfloat16, gen)
    x[pixel + (c // 3,)] = float('nan')
    kernel = fused_conv.fused_scale_bias_conv3x3
    got, route = routed_call(kernel, lambda: kernel(x, w, s, b, stride))
    clean = torch.nan_to_num(x, nan=0.0)
    want = fused_conv.fused_scale_bias_conv3x3_plain(clean, w, s, b, stride)
    magnitude = _conv_magnitude(torch, clean, w, s, b, stride)
    torch.cuda.synchronize()
    oh, ow = fused_conv.conv3x3_out_hw(h, wd, stride)
    pn, ih, iw = pixel
    dev = got.device
    rows = (torch.arange(oh, device=dev) * stride - 1)[:, None]
    cols = (torch.arange(ow, device=dev) * stride - 1)[None, :]
    mask = torch.zeros(n, oh, ow, dtype=torch.bool, device=dev)
    mask[pn] = (rows <= ih) & (ih <= rows + 2) & (cols <= iw) & \
        (iw <= cols + 2)
    nan = torch.isnan(got.float())
    if not bool(nan[mask].all()) or bool(nan[~mask].any()):
        raise AssertionError(
            'fused_scale_bias_conv3x3 %s: a NaN at input pixel %s reached '
            '%d outputs, %d of the %d whose window covers it'
            % (shape, pixel, int(nan.any(-1).sum()),
               int(nan.any(-1)[mask].sum()), int(mask.sum())))
    err, ratio = _gemm_err(torch, 'fused_scale_bias_conv3x3', 'bfloat16',
                           got[~mask], want[~mask], magnitude[~mask], None)
    return {'nhwcf_stride': list(shape), 'nan_pixel': list(pixel),
            'route': route, 'nan_outputs': int(mask.sum()),
            'max_abs_err': err, 'max_err_over_magnitude': ratio}


def lm_kernel_shapes(mx, symbol, batch, seq_len):
    """The shapes the aggressive LM training graph gives each kernel at
    ``batch`` rows: Counters of fused_dot_epilogue (M, K, N, bias, relu,
    clip) and flash_attention (BH, Tq, Tk, D, causal, scale) calls."""
    return graph_kernel_shapes(mx, symbol, {'data': (batch, seq_len),
                                            'softmax_label': (batch,
                                                              seq_len)})


def graph_kernel_shapes(mx, symbol, input_shapes):
    """:func:`lm_kernel_shapes` of any symbol at ``input_shapes``."""
    # parameter shapes from the unfused graph: the fused epilogue node
    # does not complete its inputs' shapes
    arg_shapes, _, _ = symbol.infer_shape(**input_shapes)
    prog = mx.fuse.apply_fuse_passes(symbol, True, 'aggressive')
    internals = prog.get_internals()
    _, out_shapes, _ = internals.infer_shape(
        **dict(zip(symbol.list_arguments(), arg_shapes)))
    shape_of = dict(zip(internals.list_outputs(), out_shapes))

    def shape(entry):
        src, idx = entry
        return tuple(shape_of[src.output_names()[idx]])

    dots, atts = Counter(), Counter()
    for n in prog.topo_nodes():
        if n.op == '_fused_epilogue' and n.attrs.get('lower_kernel') and \
                n.attrs['base_op'] == 'FullyConnected':
            d, w = shape(n.inputs[0]), shape(n.inputs[1])
            steps = [s['op'] for s in n.attrs['steps']]
            dots[(d[0], int(np.prod(d[1:])), w[0],
                  not n.attrs['base_attrs'].get('no_bias', False),
                  'Activation' in steps, 'clip' in steps)] += 1
        elif n.op == 'FlashAttention':
            q, k = shape(n.inputs[0]), shape(n.inputs[1])
            atts[(q[0] * q[1], q[2], k[2], q[3], bool(n.attrs['causal']),
                  float(n.attrs['scale']))] += 1
    return dots, atts


def live_pairs(tq, tk, causal):
    """(query, key) pairs the bottom-right aligned mask keeps per head."""
    if not causal:
        return tq * tk
    off = tk - tq
    return sum(min(tk, max(0, r + off + 1)) for r in range(tq))


def check_flash(torch, attention, bh, tq, tk, d, causal, scale, dtype, gen,
                flush):
    """One flash_attention case: O within rtol * (P @ |V|) of the plain
    version elementwise and lse within 1e-4 * (1 + |lse|); then the
    kernel, plain version and SDPA timed."""
    import torch.nn.functional as F
    dev = torch.device('cuda', 0)
    dt = str(dtype).replace('torch.', '')
    q = torch.randn(bh, tq, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(bh, tk, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(bh, tk, d, generator=gen, device=dev).to(dtype)
    kernel = attention.flash_attention
    (o, lse), route = routed_call(
        kernel, lambda: attention._launch(q, k, v, scale, causal))
    want, want_lse = attention.flash_attention_plain(q, k, v, scale, causal)
    torch.cuda.synchronize()
    if o.dtype != dtype or o.shape != q.shape or lse.shape != (bh, tq):
        raise AssertionError('flash_attention %s: got %s %s' % (
            dt, o.dtype, tuple(o.shape)))
    s = torch.einsum('btd,bsd->bts', q.float(), k.float()) * scale
    if causal:
        keep = attention._causal_keep(tq, tk, dev)
        s = torch.where(keep, s, torch.full_like(s, attention.NEG_INF))
    magnitude = torch.einsum('bts,bsd->btd', torch.softmax(s, -1),
                             v.float().abs())
    del s

    def errors(o, lse, name):
        err = (o.float() - want.float()).abs()
        if not bool(torch.isfinite(o.float()).all()):
            raise AssertionError('%s %s: non-finite output' % (name, dt))
        ratio = float((err / magnitude.clamp_min(1e-30)).max())
        lse_ratio = float(((lse - want_lse).abs()
                           / (1 + want_lse.abs())).max())
        if ratio > ATT_RTOL[dt] or lse_ratio > LSE_RTOL:
            raise AssertionError(
                '%s %s %s disagrees with its plain version: max |err| / '
                '(P.|V|) = %g (tolerance %g), lse %g (tolerance %g)'
                % (name, (bh, tq, tk, d), dt, ratio, ATT_RTOL[dt],
                   lse_ratio, LSE_RTOL))
        return err, ratio

    err, ratio = errors(o, lse, 'flash_attention')
    # each route's launch alone; on sm90 also the mma route (the first
    # design), checked by the same rule and timed in turns
    launches = {r: (lambda r=r: attention._launch(q, k, v, scale, causal,
                                                  r))
                for r in ((route, 'mma') if route == 'sm90' else (route,))}
    route_errs = {}
    for r, fn in launches.items():
        out = fn()
        torch.cuda.synchronize()
        route_errs[r] = errors(*out, 'flash_attention (%s route)' % r)[1]
    public = (lambda: attention.flash_attention(q, k, v, causal, scale))
    if route == 'sm90':
        ms, mma_ms = cuda_ms_each(torch, (public, launches['mma']), flush)
    else:
        ms, mma_ms = cuda_ms(torch, public, flush), None
    pairs = live_pairs(tq, tk, causal)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() \
        + 4 * bh * tq
    flops = 4 * bh * d * pairs
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = flops / (BF16_FLOPS if dtype == torch.bfloat16
                     else FP32_FLOPS) * 1e3
    # SDPA's is_causal is top-left aligned: the same function only when
    # tq == tk.  Its fused backends take [B, H, T, D]: BH heads of one row
    library = None
    if not causal or tq == tk:
        library = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=causal, scale=scale), flush)
    return {'bh_tq_tk_d': [bh, tq, tk, d], 'causal': causal, 'dtype': dt,
            'max_abs_err': float(err.max()),
            'max_err_over_magnitude': ratio,
            'tolerance': '%g * (P.|V|); lse %g * (1 + |lse|)'
                         % (ATT_RTOL[dt], LSE_RTOL),
            'lse_max_abs_err': float((lse - want_lse).abs().max()),
            'ms': ms,
            'plain_ms': cuda_ms(torch, lambda: attention.flash_attention_plain(
                q, k, v, scale, causal), flush),
            'library_ms': library,
            'host_us': host_us(torch, public),
            'bound_ms': max(byte_ms, op_ms),
            'bound_by': 'bytes' if byte_ms >= op_ms else 'operations',
            'bytes': nbytes, 'flops': flops, 'route': route,
            'mma_ms': mma_ms, 'route_err_over_magnitude': route_errs,
            'launch_host_us': {r: host_us(torch, fn)
                               for r, fn in launches.items()}}


def check_epilogue(torch, fused, mkn, has_bias, relu, clip, dtype, gen,
                   flush, nan_row=None):
    """One fused_dot_epilogue case, W given as the transposed view of an
    (N, K) FullyConnected weight, as the fuse pass passes it.
    ``nan_row``: x holds a NaN in that row, which must reach exactly that
    output row (through the bias add, relu and clip)."""
    dev = torch.device('cuda', 0)
    m, k, n = mkn
    x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
    if nan_row is not None:
        x[nan_row, k // 3] = float('nan')
    w = (torch.randn(n, k, generator=gen, device=dev) / k ** 0.5) \
        .to(dtype).t()
    b = (torch.randn(n, generator=gen, device=dev) * 0.5).to(dtype) \
        if has_bias else None
    kernel = fused.fused_dot_epilogue
    got, route = routed_call(
        kernel, lambda: kernel(x, w, b, relu=relu, clip=clip))
    want = fused.fused_dot_epilogue_plain(x, w, b, relu=relu, clip=clip)
    magnitude = torch.matmul(x.float().abs(), w.float().abs())
    if b is not None:
        magnitude = magnitude + b.float().abs()
    launches = {r: (lambda r=r: fused._epi_launch(x, w, b, relu, clip, r))
                for r in ((route, 'wmma') if route == 'sm90' else (route,))}
    case = _gemm_case(
        torch, 'fused_dot_epilogue', dtype, got, want, magnitude,
        (lambda: kernel(x, w, b, relu=relu, clip=clip),
         lambda: fused.fused_dot_epilogue_plain(x, w, b, relu=relu,
                                                clip=clip),
         (lambda: torch.addmm(b, x, w)) if b is not None
         else (lambda: torch.matmul(x, w))),
        (m * k + k * n + m * n) * x.element_size() + (4 * n if has_bias
                                                      else 0),
        2 * m * n * k, flush, route, launches, nan_row)
    case.update(mkn=list(mkn), bias=has_bias, relu=relu,
                clip=list(clip) if clip else None)
    return case


def lm_symbol(models):
    return models.get_symbol('transformer_lm', **LM)


def lm_kernels(mx, torch, attention, fused, models, gen, flush):
    """The LM phase of the kernel checks: both kernels at every shape the
    LM training graph gives them, in bf16 (the path) and f32, plus
    off-path cases (ragged and tq < tk attention, non-causal, D = 128; a
    ragged dot with bias, relu and clip; a dot with no bias)."""
    dots, atts = lm_kernel_shapes(mx, lm_symbol(models), LM_BATCH,
                                  LM['seq_len'])
    if sum(dots.values()) != LM['num_layers'] or \
            sum(atts.values()) != LM['num_layers']:
        raise AssertionError('expected %d lowered FC epilogues and %d '
                             'FlashAttention nodes, found %s / %s'
                             % (LM['num_layers'], LM['num_layers'],
                                dict(dots), dict(atts)))
    torch.backends.cuda.matmul.allow_tf32 = False
    att_cases, dot_cases = [], []
    for dtype in (torch.bfloat16, torch.float32):
        for (bh, tq, tk, d, causal, scale), per_step in sorted(atts.items()):
            case = check_flash(torch, attention, bh, tq, tk, d, causal, scale,
                               dtype, gen, flush)
            if case['route'] != PATH_ROUTE[case['dtype']]:
                raise AssertionError('flash_attention %s %s took the %s '
                                     'route' % ((bh, tq, tk, d),
                                                case['dtype'],
                                                case['route']))
            case['launches_per_step'] = per_step
            att_cases.append(case)
        # off the path: ragged tq < tk, non-causal and D = 128 (sm90 in
        # bf16); Tq = 300 against Tk = 700, causal and not (the diagonal
        # at an offset of 400 crosses 128-row tiles), and one head (sm90);
        # D = 40 (the mma route)
        for bh, tq, tk, d, causal, bf16_route in (
                (6, 77, 200, 64, True, 'sm90'),
                (8, 256, 256, 64, False, 'sm90'),
                (16, 256, 256, 128, True, 'sm90'),
                (4, 300, 700, 64, True, 'sm90'),
                (4, 300, 700, 64, False, 'sm90'),
                (1, 512, 512, 64, True, 'sm90'),
                (4, 100, 100, 40, True, 'mma')):
            case = check_flash(torch, attention, bh, tq, tk, d, causal,
                               d ** -0.5, dtype, gen, flush)
            want_route = bf16_route if dtype == torch.bfloat16 else 'simt'
            if case['route'] != want_route:
                raise AssertionError('flash_attention %s %s took the %s '
                                     'route' % ((bh, tq, tk, d), dtype,
                                                case['route']))
            case['launches_per_step'] = 0
            att_cases.append(case)
        for (m, k, n, bias, relu, clip), per_step in sorted(dots.items()):
            case = check_epilogue(torch, fused, (m, k, n), bias, relu,
                                  (0.0, 6.0) if clip else None, dtype, gen,
                                  flush)
            if case['route'] != PATH_ROUTE[case['dtype']]:
                raise AssertionError('fused_dot_epilogue %s %s took the %s '
                                     'route' % ((m, k, n), case['dtype'],
                                                case['route']))
            case['launches_per_step'] = per_step
            dot_cases.append(case)
        # (1001, 37, 130): K and N off the multiples of 8, the wmma route
        # in bf16; (256, 96, 72): the sm90 route's ragged N tile at BN 64
        for mkn, bias, relu, clip in (((1001, 37, 130), True, True,
                                       (-0.5, 0.7)),
                                      ((256, 96, 72), False, False, None)):
            case = check_epilogue(torch, fused, mkn, bias, relu, clip, dtype,
                                  gen, flush)
            case['launches_per_step'] = 0
            dot_cases.append(case)
    # the sm90 route off the path: ragged M, no bias with a clip, a NaN
    # row through bias, relu and clip
    for mkn, bias, relu, clip, nan_row in (
            ((1001, 512, 2048), True, True, None, None),
            ((512, 128, 256), False, False, (-0.5, 0.7), None),
            ((1001, 512, 2048), True, True, (0.0, 6.0), 500)):
        case = check_epilogue(torch, fused, mkn, bias, relu, clip,
                              torch.bfloat16, gen, flush, nan_row)
        if case['route'] != 'sm90':
            raise AssertionError('fused_dot_epilogue %s took the %s route'
                                 % (mkn, case['route']))
        case['launches_per_step'] = 0
        dot_cases.append(case)
    return att_cases, dot_cases


def bucket_gen(models):
    """The LM's sym_gen over length buckets: one positional table of
    max(BUCKETS) rows, prefix-sliced per bucket."""
    return models.transformer_lm.sym_gen_bucketing(
        vocab_size=LM['vocab_size'], num_embed=LM['num_embed'],
        num_heads=LM['num_heads'], num_layers=LM['num_layers'],
        max_seq_len=max(BUCKETS))


def bucket_kernels(mx, torch, attention, fused, models, gen, flush):
    """Both LM kernels at every bucket's shapes, read from each bucket's
    aggressive training graph at BUCKET_ROWS rows, in float32 (the
    bucketed path's dtype; the simt routes): flash_attention causal at
    Tq = Tk = T, fused_dot_epilogue at M = rows * T."""
    att_cases, dot_cases = [], []
    for t in BUCKETS:
        dots, atts = lm_kernel_shapes(mx, bucket_gen(models)(t)[0],
                                      BUCKET_ROWS, t)
        if sum(dots.values()) != LM['num_layers'] or \
                sum(atts.values()) != LM['num_layers']:
            raise AssertionError('bucket %d: expected %d lowered FC '
                                 'epilogues and FlashAttention nodes, found '
                                 '%s / %s' % (t, LM['num_layers'],
                                              dict(dots), dict(atts)))
        for (bh, tq, tk, d, causal, scale), per_step in sorted(atts.items()):
            case = check_flash(torch, attention, bh, tq, tk, d, causal, scale,
                               torch.float32, gen, flush)
            case.update(bucket=t, launches_per_step=per_step)
            att_cases.append(case)
        for (m, k, n, bias, relu, clip), per_step in sorted(dots.items()):
            case = check_epilogue(torch, fused, (m, k, n), bias, relu,
                                  (0.0, 6.0) if clip else None,
                                  torch.float32, gen, flush)
            case.update(bucket=t, launches_per_step=per_step)
            dot_cases.append(case)
    for case in att_cases + dot_cases:
        if case['route'] != 'simt':
            raise AssertionError('bucket %d: a float32 kernel took the %s '
                                 'route' % (case['bucket'], case['route']))
    return att_cases, dot_cases


def bucket_corpus(seed, per_bucket):
    """Random sentences of token ids from a numpy seed, ``per_bucket`` of
    them with lengths drawn in each bucket's range: [64, 128], [129, 200],
    [201, 320], [321, 512]."""
    rng = np.random.RandomState(seed)
    sentences, low = [], BUCKET_MIN_LEN
    for b in BUCKETS:
        for n in rng.randint(low, b + 1, per_bucket):
            sentences.append(list(rng.randint(0, LM['vocab_size'], n)))
        low = b + 1
    rng.shuffle(sentences)
    return sentences


def bucket_iter(mx, sentences, rows):
    """A BucketSentenceIter over ``sentences`` (padding -1), its shuffles
    seeded; its notice of discarded sentences goes to stderr."""
    import contextlib
    import random
    random.seed(SEED)
    np.random.seed(SEED)
    with contextlib.redirect_stdout(sys.stderr):
        return mx.rnn.BucketSentenceIter(sentences, rows,
                                         buckets=list(BUCKETS))


def timed_steps(torch, mod, kernels):
    """Wrap ``mod``'s fit step: each step's bucket, host ms (ending in a
    device synchronise), real (unpadded) tokens and launches of each of
    ``kernels`` by route go to the returned list."""
    steps, inner = [], mod._fit_step

    def step(data_batch, eval_metric=None):
        before = [dict(k.launches_by_route) for k in kernels]
        t0 = time.perf_counter()
        handled = inner(data_batch, eval_metric)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        steps.append({
            'bucket': data_batch.bucket_key, 'ms': ms,
            'real_tokens': int((data_batch.data[0].asnumpy() != -1).sum()),
            'launches': [{r: k.launches_by_route[r] - b[r] for r in b}
                         for k, b in zip(kernels, before)]})
        return handled

    mod._fit_step = step
    return steps


def bucket_fit(mx, torch, models, arg, sentences, bucket_keys=None):
    """``BucketingModule(...).fit`` on the card over a BucketSentenceIter
    of ``sentences``: SGD lr 0.01 momentum 0.9, float32; returns the
    module, its timed steps and the fit's wall seconds."""
    from mxnet_tpu_torch.ops import attention, fused
    mod = mx.mod.BucketingModule(bucket_gen(models),
                                 default_bucket_key=max(BUCKETS),
                                 context=mx.gpu(0), bucket_keys=bucket_keys)
    it = bucket_iter(mx, sentences, BUCKET_ROWS)
    # the step wrapper goes on the BucketingModule: its _fit_step picks
    # the bucket module
    steps = timed_steps(torch, mod, (fused.fused_dot_epilogue,
                                     attention.flash_attention))
    t0 = time.monotonic()
    mod.fit(it, num_epoch=1, eval_metric='acc', optimizer='sgd',
            optimizer_params={'learning_rate': 0.01, 'momentum': 0.9},
            arg_params={k: mx.nd.array(v) for k, v in arg.items()})
    torch.cuda.synchronize()
    return mod, steps, time.monotonic() - t0


class OneBatch(object):
    """A data iterator of one bucketed batch; ``provide_data`` names the
    default bucket's shapes, as a BucketSentenceIter's does."""

    def __init__(self, batch, default_shapes):
        self.batch = batch
        self.provide_data, self.provide_label = default_shapes
        self.done = False

    def __iter__(self):
        return self

    def __next__(self):
        if self.done:
            raise StopIteration
        self.done = True
        return self.batch

    def reset(self):
        self.done = False


def bucket_parity(mx, torch, models, arg, sentences):
    """One fit step of bucket BUCKET_PARITY[0] at BUCKET_PARITY[1] rows,
    float32, TF32 off, on the card and on the CPU from the same numpy
    parameters and batch (-1 padded): the updated parameters of both."""
    t, rows = BUCKET_PARITY
    picked = [s for s in sentences if max(b for b in BUCKETS if b < t)
              < len(s) <= t][:rows]
    data = np.full((rows, t), -1, np.float32)
    for i, sent in enumerate(picked):
        data[i, :len(sent)] = sent
    label = np.full_like(data, -1)
    label[:, :-1] = data[:, 1:]
    default = max(BUCKETS)
    stepped = {}
    for ctx in (mx.gpu(0), mx.cpu()):
        t0 = time.monotonic()
        batch = mx.io.DataBatch(
            [mx.nd.array(data)], [mx.nd.array(label)], pad=0, bucket_key=t,
            provide_data=[('data', (rows, t))],
            provide_label=[('softmax_label', (rows, t))])
        mod = mx.mod.BucketingModule(bucket_gen(models),
                                     default_bucket_key=default, context=ctx)
        mod.fit(OneBatch(batch, ([('data', (rows, default))],
                                 [('softmax_label', (rows, default))])),
                num_epoch=1, eval_metric='acc', optimizer='sgd',
                optimizer_params={'learning_rate': 0.01, 'momentum': 0.9},
                arg_params={k: mx.nd.array(v) for k, v in arg.items()})
        stepped[ctx.device_type] = ({k: v.asnumpy() for k, v in
                                     mod.get_params()[0].items()},
                                    time.monotonic() - t0)
        del mod
    return stepped, int((data == -1).sum())


def bucket_train(mx, torch, models, lm_arg, sentences):
    """Main path 5: ``BucketingModule(sym_gen_bucketing(...)).fit`` on the
    card over a BucketSentenceIter of ``sentences``, float32, TF32 off,
    the launch counts zeroed just before and read just after; then the
    same fit with every bucket declared under MXTPU_PRECOMPILE_BUCKETS.
    Returns the phase's report and the main path's launches (totals and
    by route) of fused_dot_epilogue and flash_attention."""
    from mxnet_tpu_torch.ops import attention, fused
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flash, epi = attention.flash_attention, fused.fused_dot_epilogue
    fresh_memory(torch)
    reset_launches(flash)
    reset_launches(epi)
    bmod, bsteps, bfit_s = bucket_fit(mx, torch, models, lm_arg, sentences)
    bucket_launches = {'fused_dot_epilogue': epi.launches,
                       'flash_attention': flash.launches}
    bucket_routes = {'fused_dot_epilogue': dict(epi.launches_by_route),
                     'flash_attention': dict(flash.launches_by_route)}
    peak = torch.cuda.max_memory_allocated()
    captured_memory = memory(torch)
    nsteps = len(bsteps)
    if nsteps != len(BUCKETS) * (BUCKET_STEPS + 1):
        raise AssertionError('bucket-train ran %d steps, expected %d'
                             % (nsteps, len(BUCKETS) * (BUCKET_STEPS + 1)))
    for name, n in bucket_launches.items():
        if n != LM['num_layers'] * nsteps or \
                bucket_routes[name]['simt'] != n:
            raise AssertionError('bucket-train: %s launched %d times in %d '
                                 'steps, by route %s (expected %d each, '
                                 'simt)' % (name, n, nsteps,
                                            bucket_routes[name],
                                            LM['num_layers']))
    if sorted(bmod._buckets) != sorted(BUCKETS):
        raise AssertionError('bucket-train bound %s' % sorted(bmod._buckets))
    default = bmod._buckets[max(BUCKETS)]._exec_group.execs[0]
    for key, m in bmod._buckets.items():
        ex = m._exec_group.execs[0]
        for name in default.grad_dict:
            if ex.arg_dict[name].handle.data_ptr() != \
                    default.arg_dict[name].handle.data_ptr() or \
                    ex.grad_dict[name] is not default.grad_dict[name]:
                raise AssertionError('bucket %d does not share %s with the '
                                     'default bucket' % (key, name))
        if m._fused_opt_state is not \
                bmod._buckets[max(BUCKETS)]._fused_opt_state:
            raise AssertionError('bucket %d has its own optimizer state'
                                 % key)
    out = bmod.get_outputs()[0].handle
    if out.shape != (BUCKET_ROWS * bmod._curr_bucket_key,
                     LM['vocab_size']) or \
            not bool(torch.isfinite(out).all()):
        raise AssertionError('bucket-train: bad output %s'
                             % (tuple(out.shape),))
    bucket_moved = 0.0
    for k, v in bmod.get_params()[0].items():
        t = v.asnumpy()
        if not np.all(np.isfinite(t)):
            raise AssertionError('bucket-train: %s is not finite' % k)
        bucket_moved = max(bucket_moved, float(np.max(np.abs(t - lm_arg[k]))))
    if bucket_moved <= 0.0:
        raise AssertionError('bucket-train: the parameters did not move')
    per_bucket = bucket_report(bsteps)
    graphs = {t: graph_report(m._graphs.values())
              for t, m in sorted(bmod._buckets.items())}
    for t, g in graphs.items():
        if len(g) != 1 or not g[0]['captured'] or \
                g[0]['replays'] != BUCKET_STEPS:
            raise AssertionError('bucket-train: bucket %d did not replay one '
                                 'graph: %s' % (t, g))
    card = {k: v.asnumpy() for k, v in bmod.get_params()[0].items()}
    del bmod
    # the same epoch eagerly (NaiveEngine), from the same state
    fresh_memory(torch)
    set_engine(mx, True)
    try:
        emod, esteps, _ = bucket_fit(mx, torch, models, lm_arg, sentences)
    finally:
        set_engine(mx, False)
    eager_buckets = bucket_report(esteps)
    capture = compare_runs(
        'bucket-train',
        {'step_ms_median_after_warmup': {
            t: b['step_ms_median_after_warmup']
            for t, b in per_bucket.items()},
         'launches_per_step': {t: b['launches_per_step_by_route']
                               for t, b in per_bucket.items()},
         **captured_memory},
        {'step_ms_median_after_warmup': {
            t: b['step_ms_median_after_warmup']
            for t, b in eager_buckets.items()},
         'launches_per_step': {t: b['launches_per_step_by_route']
                               for t, b in eager_buckets.items()},
         **memory(torch)},
        card, {k: v.asnumpy() for k, v in emod.get_params()[0].items()},
        nsteps)
    del emod
    # the same fit with every bucket declared and MXTPU_PRECOMPILE_BUCKETS:
    # each bucket is bound and its step built before the first batch
    os.environ['MXTPU_PRECOMPILE_BUCKETS'] = '1'
    try:
        pmod, psteps, pfit_s = bucket_fit(
            mx, torch, models, lm_arg,
            bucket_corpus(SEED + 4, BUCKET_ROWS), bucket_keys=list(BUCKETS))
    finally:
        del os.environ['MXTPU_PRECOMPILE_BUCKETS']
    pgraphs = {t: graph_report(m._graphs.values())
               for t, m in sorted(pmod._buckets.items())}
    if not all(g and g[0]['captured'] and g[0]['replays'] == 1
               for g in pgraphs.values()):
        raise AssertionError('bucket-train: precompile did not capture every '
                             'bucket before its batch: %s' % pgraphs)
    del pmod
    first_on = {x['bucket']: x['ms'] for x in psteps}
    report = {
        'model': 'transformer_lm',
        **{k: v for k, v in LM.items() if k != 'seq_len'},
        'max_seq_len': max(BUCKETS), 'buckets': list(BUCKETS),
        'rows': BUCKET_ROWS, 'dtype': 'float32', 'tf32': False,
        'fuse': 'aggressive', 'padding': -1,
        'entry': 'mod.BucketingModule(sym_gen_bucketing).fit over '
                 'rnn.BucketSentenceIter',
        'optimizer': 'sgd lr 0.01 momentum 0.9 rescale 1/%d' % BUCKET_ROWS,
        'steps': nsteps, 'fit_s': bfit_s, 'buckets_bound': len(BUCKETS),
        'launches': bucket_launches, 'launches_by_route': bucket_routes,
        'per_bucket': per_bucket, 'peak_memory_bytes': peak,
        'max_param_change': bucket_moved,
        'first_batch_ms_precompile_off': {t: per_bucket[t]['first_ms']
                                          for t in BUCKETS},
        'first_batch_ms_precompile_on': first_on,
        # bind, warm start (each bucket's capture) and the iterator: the
        # fit's time outside steps
        'precompile_fit_s': pfit_s,
        'precompile_outside_steps_s': pfit_s - sum(first_on.values()) / 1e3,
        'precompile_graphs': pgraphs, 'graphs': graphs,
        'capture_vs_eager': capture}
    return report, bucket_launches, bucket_routes


def bucket_report(steps):
    """Per bucket of a bucketed fit's timed steps: median step ms after
    the first, tokens/s and launches per step by route."""
    per_bucket = {}
    for t in BUCKETS:
        mine = [x for x in steps if x['bucket'] == t]
        ms = statistics.median(x['ms'] for x in mine[1:])
        real = statistics.mean(x['real_tokens'] for x in mine[1:])
        per_bucket[t] = {
            'steps': len(mine), 'first_ms': mine[0]['ms'],
            'step_ms': [x['ms'] for x in mine],
            'step_ms_median_after_warmup': ms,
            'tokens_per_s_padded': BUCKET_ROWS * t / ms * 1e3,
            'tokens_per_s_unpadded': real / ms * 1e3,
            'real_token_share': real / (BUCKET_ROWS * t),
            'launches_per_step_by_route': {
                name: {r: sum(x['launches'][i][r] for x in mine) / len(mine)
                       for r in mine[0]['launches'][i]}
                for i, name in enumerate(('fused_dot_epilogue',
                                          'flash_attention'))}}
    return per_bucket


def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def sp_step(ts, sp, symbol, mesh, mode, compute_dtype):
    opt = ts.make_sgd_momentum(lr=0.01, momentum=0.9, wd=0.0,
                               rescale_grad=1.0 / (LM_BATCH * LM['seq_len']))
    return sp.make_sp_train_step(symbol, mesh, opt, seq_axis='seq',
                                 seq_param_names=SP_SEQ_PARAMS,
                                 compute_dtype=compute_dtype, attn_mode=mode)


def sequence_parallel(mx, torch, models, ts, lm_arg, dev):
    """Main path 6: ``parallel.make_sp_train_step`` on a one-rank NCCL
    group (a DeviceMesh with one 'seq' dimension), the full-width LM at
    T = 512 and LM_BATCH rows, SP_STEPS bf16 steps in each of
    attn_mode 'ring' (plain PyTorch, no kernel) and 'ulysses' (the
    all-to-all around flash_attention, whose launches must take sm90);
    then one f32 step of each mode against ``make_train_step`` on the same
    parameters and batch, both on the card, TF32 off.  Returns the
    report and the main path's flash_attention launches."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from mxnet_tpu_torch.ops import attention, fused
    from mxnet_tpu_torch.parallel import sp
    flash, epi = attention.flash_attention, fused.fused_dot_epilogue
    symbol = lm_symbol(models)
    batch = lm_batch(torch, dev, LM_BATCH)
    dist.init_process_group('nccl', init_method='tcp://127.0.0.1:%d'
                            % free_port(), world_size=1, rank=0)
    try:
        mesh = init_device_mesh('cuda', (1,), mesh_dim_names=('seq',))
        report = {'model': 'transformer_lm', **LM, 'rows': LM_BATCH,
                  'ranks': 1, 'backend': dist.get_backend(),
                  'entry': 'parallel.make_sp_train_step',
                  'seq_param_names': list(SP_SEQ_PARAMS),
                  'compute_dtype': 'bfloat16', 'steps': SP_STEPS,
                  'optimizer': 'sgd lr 0.01 momentum 0.9 wd 0 rescale 1/%d'
                               % (LM_BATCH * LM['seq_len'])}
        torch_params = {k: torch.from_numpy(v) for k, v in lm_arg.items()}
        for mode in ('ring', 'ulysses'):
            p = sp.shard_sp_params(torch_params, mesh, 'seq', SP_SEQ_PARAMS)
            state = sp.shard_sp_params(ts.sgd_momentum_init(p), mesh, 'seq',
                                       SP_SEQ_PARAMS)
            step = sp_step(ts, sp, symbol, mesh, mode, torch.bfloat16)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches(flash)
            reset_launches(epi)
            times, ce = [], []
            for i in range(SP_STEPS):
                t0 = time.perf_counter()
                outs, p, state = step(p, state, batch)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                if i in (0, SP_STEPS - 1):
                    ce.append(cross_entropy(torch, outs[0],
                                            batch['softmax_label']))
            routes = dict(flash.launches_by_route)
            want = LM['num_layers'] * SP_STEPS if mode == 'ulysses' else 0
            if flash.launches != want or routes['sm90'] != want or \
                    epi.launches:
                raise AssertionError(
                    'sp %s: flash_attention launched %d times (%s), '
                    'fused_dot_epilogue %d; expected %d on sm90 and none'
                    % (mode, flash.launches, routes, epi.launches, want))
            if tuple(outs[0].shape) != (LM_BATCH * LM['seq_len'],
                                        LM['vocab_size']) or \
                    not bool(torch.isfinite(outs[0].float()).all()) or \
                    not all(np.isfinite(ce)):
                raise AssertionError('sp %s: bad output %s, cross-entropy '
                                     '%s' % (mode, tuple(outs[0].shape), ce))
            moved = max(float((p[k].float().cpu() - torch_params[k]).abs()
                              .max()) for k in p)
            if not all(bool(torch.isfinite(v).all()) for v in p.values()) \
                    or moved <= 0.0:
                raise AssertionError('sp %s: parameters not finite or did '
                                     'not move (%g)' % (mode, moved))
            report[mode] = {
                'step_ms': times,
                'step_ms_median_after_warmup': statistics.median(times[1:]),
                'tokens_per_s': LM_BATCH * LM['seq_len']
                / statistics.median(times[1:]) * 1e3,
                'flash_attention_launches_by_route': routes,
                'fused_dot_epilogue_launches': epi.launches,
                'peak_memory_bytes': torch.cuda.max_memory_allocated(),
                'cross_entropy_first_last': ce, 'max_param_change': moved}
            del p, state, outs, step
        launches = report['ulysses']['flash_attention_launches_by_route']
        # parity: one f32 step of each mode against make_train_step
        torch.backends.cuda.matmul.allow_tf32 = False
        ref = {k: torch.tensor(v, device=dev) for k, v in lm_arg.items()}
        _, ref, _, _ = lm_step(ts, symbol, LM_BATCH, None)(
            ref, {}, ts.sgd_momentum_init(ref), batch)
        ref = {k: v.cpu().numpy() for k, v in ref.items()}
        for mode in ('ring', 'ulysses'):
            p = sp.shard_sp_params(torch_params, mesh, 'seq', SP_SEQ_PARAMS)
            _, p, _ = sp_step(ts, sp, symbol, mesh, mode, None)(
                p, ts.sgd_momentum_init(p), batch)
            got = {k: v.cpu().numpy() for k, v in p.items()}
            n_out, total, worst, outside = param_parity(got, ref)
            report[mode + '_parity'] = {
                'against': 'make_train_step, float32, on the card',
                'tolerance': 'rtol 1e-3, atol 1e-5 elementwise; at most '
                             '1e-4 of the elements outside it, none beyond '
                             '1e-3',
                'elements': total, 'elements_outside': n_out,
                'max_abs_err': worst[0], 'worst_param': worst[1],
                'outside_tolerance': outside}
            if n_out > 1e-4 * total or worst[0] > 1e-3:
                raise AssertionError(
                    'sp %s parity: %d of %d parameter elements beyond rtol '
                    '1e-3, atol 1e-5, max abs err %g in %s'
                    % (mode, n_out, total, worst[0], worst[1]))
    finally:
        dist.destroy_process_group()
    return report, launches


def lm_batch(torch, dev, rows):
    """``rows`` x seq_len random token ids and their next-token labels,
    as the bench leg makes them (labels = (toks + 1) % V)."""
    v = LM['vocab_size']
    toks = np.random.RandomState(SEED + 1).randint(
        0, v, (LM_BATCH, LM['seq_len'])).astype(np.float32)[:rows]
    return {'data': torch.from_numpy(toks).to(dev),
            'softmax_label': torch.from_numpy((toks + 1) % v).to(dev)}


def lm_step(ts, symbol, rows, compute_dtype):
    opt = ts.make_sgd_momentum(lr=0.01, momentum=0.9, wd=0.0,
                               rescale_grad=1.0 / (rows * LM['seq_len']))
    return ts.make_train_step(symbol, opt, ('data', 'softmax_label'),
                              compute_dtype=compute_dtype)


def cross_entropy(torch, prob, label):
    p = torch.gather(prob.float(), 1, label.reshape(-1, 1).long())
    return float(-torch.log(p.clamp_min(1e-30)).mean())


def _sum_cases(cases, key):
    return sum(c[key] * c['launches_per_step'] for c in cases)


def gemm_summary(name, source, replaces, cases, launches_by_path,
                 library_call, per='one 32-row training step forward, '
                 'bfloat16'):
    """The kernels-line entry of a kernel timed per training step:
    per-shape bf16 medians summed over one step's forward launches."""
    on_path = [c for c in cases if c['launches_per_step']
               and c['dtype'] == 'bfloat16']
    return {'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'launches': sum(launches_by_path.values()),
            'launches_by_path': launches_by_path,
            'max_abs_err': max(c['max_abs_err'] for c in cases
                               if c['launches_per_step']),
            'ms': _sum_cases(on_path, 'ms'),
            'plain_ms': _sum_cases(on_path, 'plain_ms'),
            'bound_ms': _sum_cases(on_path, 'bound_ms'),
            # the side that holds the larger share of the summed bound
            'bound_by': ('operations' if _sum_cases(
                [c for c in on_path if c['bound_by'] == 'operations'],
                'bound_ms') > _sum_cases(on_path, 'bound_ms') / 2
                else 'bytes'),
            'library_ms': _sum_cases(on_path, 'library_ms'),
            'library_call': library_call, 'per': per,
            'f32_ms': _sum_cases([c for c in cases if c['launches_per_step']
                                  and c['dtype'] == 'float32'], 'ms'),
            'cases': cases}


def bucket_summary(cases):
    """The bucketed path's shapes of a kernel (float32, simt): per bucket,
    one launch's device ms, bound, plain and library ms, and the launches
    of one step."""
    return [{'bucket': c['bucket'], 'route': c['route'],
             'launches_per_step': c['launches_per_step'],
             'max_abs_err': c['max_abs_err'], 'ms': c['ms'],
             'bound_ms': c['bound_ms'], 'bound_by': c['bound_by'],
             'plain_ms': c['plain_ms'], 'library_ms': c['library_ms']}
            for c in cases]


def route_summary(cases, launches_by_route, old='wmma'):
    """The route entries of a kernel's summary: the route its bf16 path
    cases took, the replaced route's (``old``: wmma, or mma for
    flash_attention) device time at the same shapes (summed over one
    step's launches, like ms), host us per call (the public wrapper, and
    each route's launch alone) averaged over the step's launches, and the
    main paths' launches by route."""
    on_path = [c for c in cases if c['launches_per_step']
               and c['dtype'] == 'bfloat16']
    calls = sum(c['launches_per_step'] for c in on_path)
    return {'path_route': ','.join(sorted({c['route'] for c in on_path})),
            'launches_by_route': launches_by_route,
            old + '_ms': _sum_cases(on_path, old + '_ms'),
            'host_us': _sum_cases(on_path, 'host_us') / calls,
            'launch_host_us': {
                r: sum(c['launch_host_us'][r] * c['launches_per_step']
                       for c in on_path) / calls for r in ('sm90', old)}}


def ptxas_sm90(build_logs):
    """ptxas's register and spill report of every sm90 instantiation
    (``gemm_sm90<...>``, ``flash_fwd_sm90<D>``) in nvcc's -Xptxas -v
    output, by kernel source."""
    report = []
    for name, text in sorted(build_logs.items()):
        fn = None
        for ln in text.splitlines():
            if 'Compiling entry function' in ln:
                fn = ln.split("'")[1]
                if 'sm90' not in fn:
                    fn = None
                else:
                    report.append({'kernel': name, 'function': fn})
            elif fn and 'spill stores' in ln:
                nums = [int(t) for t in ln.replace(',', ' ').split()
                        if t.isdigit()]
                report[-1].update(stack_bytes=nums[0], spill_stores=nums[1],
                                  spill_loads=nums[2])
            elif fn and 'Used' in ln and 'registers' in ln:
                report[-1]['registers'] = int(
                    ln.split('Used')[1].split('registers')[0])
    return report


def param_parity(card, host):
    """Elementwise rtol 1e-3, atol 1e-5 between two parameter dicts.  A
    relu whose input lies within the two devices' float32 differences
    (~1e-6) of zero can take the other side of its kink on one device:
    its gradient element flips, and the weight gradients of the channel
    it feeds move by far more than the tolerance.  Such isolated flips
    are expected at full width (millions of relu inputs), so a phase
    fails when more than 1e-4 of all parameter elements are outside the
    tolerance, or any is more than 1e-3 away.  Returns (elements outside,
    total, worst (abs err, name), per-parameter outliers)."""
    outside, worst, total, n_out = [], (0.0, None), 0, 0
    for k in sorted(card):
        diff = np.abs(card[k] - host[k])
        bad = int((diff > 1e-5 + 1e-3 * np.abs(host[k])).sum())
        total += diff.size
        n_out += bad
        if bad:
            outside.append((k, bad, float(diff.max())))
        if float(diff.max()) > worst[0]:
            worst = (float(diff.max()), k)
    return n_out, total, worst, outside


def set_engine(mx, naive):
    """NaiveEngine (every step eager) or the default (captured)."""
    mx.engine.set_engine_type('NaiveEngine' if naive else
                              'ThreadedEnginePerDevice')


def launch_counts(kernels):
    """{kernel: (launches, {route: launches})} of the kernel wrappers."""
    return {getattr(k, '__name__', str(k)):
            (k.launches, dict(getattr(k, 'launches_by_route', {})))
            for k in kernels}


def launches_per_step(before, after, steps):
    """Launches per step by kernel (and route) between two
    launch_counts, for the kernels that launched."""
    out = {}
    for name, (n, routes) in after.items():
        n0, routes0 = before[name]
        if n != n0:
            out[name] = {'all': (n - n0) / steps}
            out[name].update({r: (v - routes0.get(r, 0)) / steps
                              for r, v in routes.items()
                              if v != routes0.get(r, 0)})
    return out


def custom_stage_profile(torch, cap):
    """Where the captured Custom-headed step spends its time: the step
    replayed CUSTOM_PROFILE_REPLAYS more times (after the run it was
    compared on), each stage bracketed by CUDA events (device ms of
    each graph and of the user's Rtc pushes) and by the host's clock
    (host us to issue it).  Medians, by stage."""
    names = []
    for i, st in enumerate(cap.stages):
        if hasattr(st, 'graph'):
            names.append('%d graph' % i)
        else:       # FitStep.stages.<locals>.custom_fwd.<locals>.run
            qual = getattr(st, '__qualname__', 'host')
            names.append('%d %s' % (i, qual.rsplit('.<locals>.', 1)[0]
                                    .rsplit('.', 1)[-1]))
    dev_ms = {n: [] for n in names}
    host_us = {n: [] for n in names}
    for _ in range(CUSTOM_PROFILE_REPLAYS):
        evs = [torch.cuda.Event(enable_timing=True)
               for _ in range(len(cap.stages) + 1)]
        evs[0].record()
        for i, st in enumerate(cap.stages):
            t0 = time.perf_counter()
            if hasattr(st, 'graph'):
                st.graph.replay()
            else:
                st()
            host_us[names[i]].append((time.perf_counter() - t0) * 1e6)
            evs[i + 1].record()
        torch.cuda.synchronize()
        for i, n in enumerate(names):
            dev_ms[n].append(evs[i].elapsed_time(evs[i + 1]))
    return {n: {'device_ms': statistics.median(dev_ms[n]),
                'host_us': statistics.median(host_us[n])} for n in names}


WARM_LM_BATCHES = 16        # the bucketed LM's epoch, cut (4 per bucket)
WARM_RESNET_STEPS = 4       # the Custom-headed ResNet's fit
WARM_CHILD_TIMEOUT = 300    # seconds, each child process


def _digest(params):
    """sha256 of every parameter's bytes, by name: equal digests are
    parameters equal bit for bit."""
    import hashlib
    h = hashlib.sha256()
    for k in sorted(params):
        h.update(k.encode())
        h.update(np.ascontiguousarray(params[k]).tobytes())
    return h.hexdigest()


_WARM_COUNTERS = ('compile.traces', 'compile.warmup_traces', 'rtc.compiles',
                  'compile.cache_hits', 'compile.cache_misses')


def _warm_counters(instrument):
    snap = instrument.metrics_snapshot()
    out = {k: snap['counters'].get(k, 0) for k in _WARM_COUNTERS}
    saved = snap['timers'].get('compile.time_saved_secs') or {}
    out['compile.time_saved_secs'] = saved.get('total_sec', 0.0)
    # captures' host seconds on the hot path, whole warm-ups' in a warm
    # start
    secs = (snap.get('histograms') or {}).get('compile.warmup_secs') or {}
    out['compile.warmup_secs'] = secs.get('sum', 0.0)
    return out


def _warm_fit(mx, torch, instrument, iowatch, fit):
    """Run ``fit()`` (a Module or BucketingModule fit whose first step is
    timed by ``fit``'s own wrapper) and report what a warm start
    changes: captures on the hot path and in the warm start, Rtc
    compiles, cubin store hits and the compile seconds they saved, the
    first batch's host ms, the fit's wall seconds, the goodput fraction
    and its compile seconds, the parameters' digest."""
    before = _warm_counters(instrument)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    mod, first_ms = fit()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    after = _warm_counters(instrument)
    good = iowatch.goodput_snapshot()
    params = numpy_params(mod)
    if not all(np.all(np.isfinite(v)) for v in params.values()):
        raise AssertionError('warm-start: parameters not finite')
    return {'hot_path_captures': after['compile.traces']
            - before['compile.traces'],
            'warmup_traces': after['compile.warmup_traces']
            - before['compile.warmup_traces'],
            'rtc_compiles': after['rtc.compiles'] - before['rtc.compiles'],
            'cache_hits': after['compile.cache_hits']
            - before['compile.cache_hits'],
            'cache_misses': after['compile.cache_misses']
            - before['compile.cache_misses'],
            'time_saved_secs': after['compile.time_saved_secs']
            - before['compile.time_saved_secs'],
            'capture_or_warmup_secs': after['compile.warmup_secs']
            - before['compile.warmup_secs'],
            'capture_ms': sum(c.capture_ms or 0.0 for c in
                              _module_steps(mod)),
            'first_batch_host_ms': first_ms, 'fit_wall_s': wall,
            'goodput_fraction': good.get('fraction'),
            'goodput_compile_s': (good.get('buckets') or {}).get('compile'),
            'goodput_wall_s': good.get('wall_secs'),
            'params_sha256': _digest(params)}


def _module_steps(mod):
    """The captured steps a Module or BucketingModule holds."""
    mods = getattr(mod, '_buckets', None) or {None: mod}
    return [c for m in mods.values() for c in m._graphs.values()]


def _first_step_timer(torch, mod):
    """Wrap ``mod``'s fit step: the first step's host ms (ending in a
    device synchronise) goes into the returned list."""
    first, inner = [], mod._fit_step

    def step(data_batch, eval_metric=None):
        t0 = time.perf_counter()
        handled = inner(data_batch, eval_metric)
        if not first:
            torch.cuda.synchronize()
            first.append((time.perf_counter() - t0) * 1e3)
        return handled
    mod._fit_step = step
    return first


def warm_child():
    """One process of the warm-start phase (``--warm-child``): the
    bucketed LM of path 5 and the Custom-headed ResNet-50 v2 of path 4,
    each fit once over the ``MXTPU_COMPILE_CACHE`` its parent set (with
    ``MXTPU_WARM_START`` in the warm process).  Prints one JSON line."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import convert, instrument, iowatch, models
    from mxnet_tpu_torch.models import resnet
    os.environ['MXTPU_FUSE'] = 'aggressive'
    os.environ['MXTPU_IOWATCH'] = '1'     # each fit re-reads the knob
    iowatch.refresh()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    register_user_ops(mx)
    out = {'warm_start': bool(os.environ.get('MXTPU_WARM_START'))}

    # the bucketed LM: buckets 128/200/320/512, f32, 16 batches
    lm_arg, _ = convert.random_params(
        lm_symbol(models), {'data': (BUCKET_ROWS, max(BUCKETS)),
                            'softmax_label': (BUCKET_ROWS, max(BUCKETS))},
        SEED, init='normal')
    sentences = bucket_corpus(SEED + 5, BUCKET_ROWS * WARM_LM_BATCHES
                              // len(BUCKETS))

    def lm_fit():
        mod = mx.mod.BucketingModule(bucket_gen(models),
                                     default_bucket_key=max(BUCKETS),
                                     context=mx.gpu(0))
        first = _first_step_timer(torch, mod)
        mod.fit(bucket_iter(mx, sentences, BUCKET_ROWS), num_epoch=1,
                eval_metric='acc', optimizer='sgd',
                optimizer_params={'learning_rate': 0.01, 'momentum': 0.9},
                arg_params={k: mx.nd.array(v) for k, v in lm_arg.items()})
        out['lm_buckets_bound'] = sorted(mod._buckets)
        return mod, first[0]
    out['lm'] = _warm_fit(mx, torch, instrument, iowatch, lm_fit)
    del lm_arg
    gc.collect()
    torch.cuda.empty_cache()

    # the Custom-headed ResNet-50 v2: f32, 32 rows, a few steps
    csym = custom_symbol(mx, resnet)
    arg, aux = convert.random_params(csym, {'data': (BATCH,) + IMAGE}, SEED)
    rng = np.random.default_rng(SEED + 11)
    images = rng.standard_normal((BATCH * WARM_RESNET_STEPS,) + IMAGE,
                                 dtype=np.float32)
    labels = rng.integers(0, 1000, BATCH * WARM_RESNET_STEPS) \
        .astype(np.float32)

    def resnet_fit():
        mod = mx.mod.Module(csym, context=mx.gpu(0))
        first = _first_step_timer(torch, mod)
        mod.fit(mx.io.NDArrayIter(images, labels, batch_size=BATCH),
                num_epoch=1, eval_metric='acc', optimizer='sgd',
                optimizer_params=dict(SGD_MOMENTUM),
                arg_params={k: mx.nd.array(v) for k, v in arg.items()},
                aux_params={k: mx.nd.array(v) for k, v in aux.items()})
        (cap,) = mod._graphs.values()
        out['resnet_step'] = {'kind': type(cap).__name__,
                              'captured': cap.captured,
                              'graphs': len(getattr(cap, 'graphs', []))}
        return mod, first[0]
    out['resnet'] = _warm_fit(mx, torch, instrument, iowatch, resnet_fit)
    log(out)
    return 0


def warm_start_phase():
    """warm-start: :func:`warm_child` twice, cold then warm, over one
    ``MXTPU_COMPILE_CACHE`` temporary directory, each bounded by
    WARM_CHILD_TIMEOUT.  The warm LM takes no capture on the hot path
    and as many in its warm start as the cold one took on it; the warm
    ResNet compiles no Rtc module (its 2 cubins are store hits); each
    model's parameters are bit for bit the cold process's."""
    import tempfile
    runs = {}
    with tempfile.TemporaryDirectory() as cache:
        for mode in ('cold', 'warm'):
            env = dict(os.environ, MXTPU_COMPILE_CACHE=cache,
                       CUBLAS_WORKSPACE_CONFIG=':4096:8')
            env.pop('MXTPU_WARM_START', None)
            if mode == 'warm':
                env['MXTPU_WARM_START'] = '1'
            t0 = time.monotonic()
            done = subprocess.run(
                [sys.executable, os.path.abspath(__file__), '--warm-child'],
                env=env, capture_output=True, text=True,
                timeout=WARM_CHILD_TIMEOUT)
            if done.returncode != 0:
                print(done.stdout[-4000:], done.stderr[-6000:],
                      file=sys.stderr)
                raise AssertionError('warm-start: the %s child exited %d'
                                     % (mode, done.returncode))
            runs[mode] = json.loads(done.stdout.strip().splitlines()[-1])
            runs[mode]['process_s'] = time.monotonic() - t0
        files = sorted(os.listdir(cache))
        cubins = len(os.listdir(os.path.join(cache, 'rtc'))) \
            if 'rtc' in files else 0
        with open(os.path.join(cache, 'manifest.json')) as f:
            kinds = Counter(e['kind'] for e in json.load(f)['traces'])
    cold, warm = runs['cold'], runs['warm']
    failures = []
    if warm['lm']['hot_path_captures'] != 0 or \
            warm['lm']['warmup_traces'] != cold['lm']['hot_path_captures'] \
            or cold['lm']['hot_path_captures'] != len(BUCKETS):
        failures.append('LM captures: cold %d on the hot path, warm %d on '
                        'the hot path and %d in its warm start'
                        % (cold['lm']['hot_path_captures'],
                           warm['lm']['hot_path_captures'],
                           warm['lm']['warmup_traces']))
    if warm['resnet']['rtc_compiles'] != 0 or \
            warm['resnet']['cache_hits'] != 2 or \
            cold['resnet']['rtc_compiles'] != 2:
        failures.append('ResNet Rtc: cold %d compiles, warm %d compiles and '
                        '%d cache hits' % (cold['resnet']['rtc_compiles'],
                                           warm['resnet']['rtc_compiles'],
                                           warm['resnet']['cache_hits']))
    for model in ('lm', 'resnet'):
        if cold[model]['params_sha256'] != warm[model]['params_sha256']:
            failures.append('%s: the warm process\'s parameters are not the '
                            'cold one\'s bit for bit' % model)
    if warm['resnet_step'] != {'kind': 'StagedStep', 'captured': True,
                               'graphs': 2}:
        failures.append('ResNet step: %s' % warm['resnet_step'])
    if failures:
        raise AssertionError('warm-start: ' + '; '.join(failures))
    return {'lm': {'model': 'transformer_lm (full width), BucketingModule',
                   'buckets': list(BUCKETS), 'rows': BUCKET_ROWS,
                   'batches': WARM_LM_BATCHES, 'dtype': 'float32',
                   'precompile_buckets': False,
                   'cold': cold['lm'], 'warm': warm['lm'],
                   'warm_buckets_bound': warm['lm_buckets_bound']},
            'resnet': {'model': 'resnet-50 v2, Custom softmax_rtc head',
                       'rows': BATCH, 'steps': WARM_RESNET_STEPS,
                       'dtype': 'float32', 'cold': cold['resnet'],
                       'warm': warm['resnet'], 'step': warm['resnet_step']},
            'cache_files': files, 'cubins_stored': cubins,
            'manifest_kinds': dict(kinds),
            'cold_process_s': cold['process_s'],
            'warm_process_s': warm['process_s'],
            'params_bit_for_bit': True}


NATIVE_ABANDON_CHILDREN = 5     # at once (the CPU tests run 10)
NATIVE_ABANDON_TIMEOUT = 60     # seconds, each


def abandon_child(index):
    """One child of the native-engine phase (``--abandon-child``): three
    PrefetchingIters on the native engine, one batch taken from each, a
    fetch in flight (a slow iterator), abandoned (on odd indices one of
    them collected first), then the process exits."""
    import mxnet_tpu_torch as mx

    class Slow(mx.io.NDArrayIter):
        def next(self):
            time.sleep(0.05)
            return super().next()
    x = np.zeros((256, 3), np.float32)
    its = [mx.io.PrefetchingIter([Slow(x, batch_size=4),
                                  mx.io.NDArrayIter({'b': x}, batch_size=4)])
           for _ in range(3)]
    for it in its:
        it.next()
    if index % 2:
        del its[0]
    print('abandoned %d' % index, flush=True)
    return 0


def native_engine_phase(mx, torch, models, convert, tmp):
    """native-engine: mnist-lenet's PrefetchingIter epoch (the idx files
    mnist_lenet wrote in ``tmp``) on the native engine with its profiler
    on (the fetches it ran and their ms), then NATIVE_ABANDON_CHILDREN
    child processes that abandon PrefetchingIters mid-epoch and exit:
    each must exit 0 within NATIVE_ABANDON_TIMEOUT seconds."""
    img, lab = os.path.join(tmp, 'images-idx3-ubyte'), \
        os.path.join(tmp, 'labels-idx1-ubyte')
    lenet = models.get_symbol('lenet', num_classes=10)
    arg, _ = convert.random_params(lenet, {'data': (MNIST_BATCH, 1, 28, 28)},
                                   SEED)
    eng = mx.engine.native_engine()
    eng.set_profiling(True)
    run = epoch_report(
        mx, torch, lenet, arg,
        lambda: mx.io.PrefetchingIter(mx.io.MNISTIter(
            image=img, label=lab, batch_size=MNIST_BATCH, shuffle=True,
            seed=SEED)), False, MNIST_IMAGES)
    eng.set_profiling(False)
    trace = os.path.join(tmp, 'engine.json')
    eng.dump_profile(trace)
    with open(trace) as f:
        events = [e for e in json.load(f)['traceEvents']
                  if e['name'].startswith('prefetch_')]
    if len(events) < MNIST_IMAGES // MNIST_BATCH:
        raise AssertionError('native-engine: %d prefetch ops ran for an '
                             'epoch of %d batches' % (
                                 len(events), MNIST_IMAGES // MNIST_BATCH))
    children = []
    procs = [(i, time.monotonic(), subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), '--abandon-child',
         str(i)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(os.environ, CUDA_VISIBLE_DEVICES='')))
        for i in range(NATIVE_ABANDON_CHILDREN)]
    for i, t0, p in procs:
        try:
            out, err = p.communicate(timeout=NATIVE_ABANDON_TIMEOUT)
            rc = p.returncode
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
            rc = 'timeout'
        children.append({'child': i, 'rc': rc,
                         'seconds': time.monotonic() - t0,
                         'abandoned': 'abandoned %d' % i in out})
        if rc != 0 or 'abandoned %d' % i not in out:
            print(err[-3000:], file=sys.stderr)
    bad = [c for c in children if c['rc'] != 0 or not c['abandoned']]
    if bad:
        raise AssertionError('native-engine: children that did not exit 0 '
                             'within %d s: %s' % (NATIVE_ABANDON_TIMEOUT,
                                                  bad))
    return {'engine': 'NativeEngine (csrc/host/engine.cc)',
            'workers': int(mx.config.get('MXNET_CPU_WORKER_NTHREADS')),
            'images': MNIST_IMAGES, 'batch': MNIST_BATCH, 'model': 'lenet',
            **run, 'prefetch_ops': len(events),
            'prefetch_op_ms_median': statistics.median(
                e['dur'] / 1e3 for e in events),
            'abandon_children': children,
            'abandon_max_s': max(c['seconds'] for c in children)}


def graph_report(caps):
    """Each captured step a path holds: whether it was captured (or the
    rule that kept it eager), its capture's host ms, its replays and the
    kernel launches it records per replay."""
    return [{'name': c.name, 'captured': c.captured, 'skip': c.skip,
             'capture_ms': c.capture_ms, 'replays': c.replays,
             'launches_per_replay': c.launches} for c in caps]


def memory(torch):
    """Peak allocated and reserved device bytes since the last reset (the
    graphs' pools are reserved memory)."""
    return {'peak_allocated_bytes': torch.cuda.max_memory_allocated(),
            'peak_reserved_bytes': torch.cuda.max_memory_reserved()}


def fresh_memory(torch):
    gc.collect()        # modules of earlier phases still in cycles
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def parity_report(got, want):
    """:func:`param_parity` of two parameter dicts as a report."""
    n_out, total, worst, outside = param_parity(got, want)
    return {'elements': total, 'elements_outside': n_out,
            'max_abs_err': worst[0], 'worst_param': worst[1],
            'outside_tolerance': outside,
            'bitwise_equal': all(np.array_equal(got[k], want[k])
                                 for k in want)}


def beyond_bound(phase, report):
    """The failure message when ``report`` is outside train-parity's
    bound, else None."""
    if report['elements_outside'] > 1e-4 * report['elements'] or \
            report['max_abs_err'] > 1e-3:
        return ('%s: %d of %d parameter elements beyond rtol 1e-3, atol '
                '1e-5, max abs err %g in %s'
                % (phase, report['elements_outside'], report['elements'],
                   report['max_abs_err'], report['worst_param']))
    return None


def compare_params(phase, got, want):
    """Two parameter dicts under train-parity's bound (raises outside)."""
    report = parity_report(got, want)
    failure = beyond_bound(phase, report)
    if failure:
        raise AssertionError(failure)
    return report


def compare_runs(phase, captured, eager, card, host, steps):
    """A captured run against the eager run of the same steps: launches
    per step by kernel and route must be equal, the parameters after
    ``steps`` steps within train-parity's bound (bit-identical where the
    library picks the same algorithms)."""
    if captured['launches_per_step'] != eager['launches_per_step']:
        raise AssertionError('%s: launches per step captured %s, eager %s'
                             % (phase, captured['launches_per_step'],
                                eager['launches_per_step']))
    return {'captured': captured, 'eager': eager,
            'params_after_steps': steps,
            **compare_params(phase + ', captured against eager', card,
                             host),
            'tolerance': 'rtol 1e-3, atol 1e-5 elementwise; at most 1e-4 '
                         'of the elements outside it, none beyond 1e-3'}


def serve_phase(mx, torch, server, symbol, params, data, rng, fused,
                instrument):
    """Main path 1 on ``server``: load (which builds, and unless under
    NaiveEngine captures, every pow2 bucket), one request per bucket,
    then the measured requests with the launch counts zeroed just before
    and read just after (17 fused_bn_relu per forward).  Each forward is
    timed on the host up to a device synchronise."""
    t0 = time.monotonic()
    predictor = server.load_model('resnet50', symbol_json=symbol.tojson(),
                                  params=params,
                                  input_shapes={'data': (BATCH,) + IMAGE})
    load_s = time.monotonic() - t0
    forward_s, forward = [], predictor.forward

    def timed_forward(**inputs):
        t1 = time.perf_counter()
        out = forward(**inputs)
        torch.cuda.synchronize()
        forward_s.append(time.perf_counter() - t1)
        return out
    predictor.forward = timed_forward
    # one request per pow2 bucket first: each bucket's first forward pays
    # cuDNN's algorithm setup, which the measured run should not
    t0 = time.monotonic()
    b = 1
    while b <= BATCH:
        server.predict('resnet50', timeout=300, data=data[:b])
        b *= 2
    torch.cuda.synchronize()
    warm_s = time.monotonic() - t0
    del forward_s[:]
    instrument.reset_metrics()
    reset_launches(fused.fused_bn_relu)
    results, wall = serve(server, data, rng)
    torch.cuda.synchronize()
    n_bn_relu = fused.fused_bn_relu.launches
    forwards = instrument.counter_value('executor.forwards')
    if n_bn_relu == 0:
        raise AssertionError('kernel fused_bn_relu never launched on the '
                             'main path')
    if n_bn_relu != 17 * forwards or forwards != len(forward_s):
        raise AssertionError('fused_bn_relu launched %d times in %d forwards '
                             '(expected 17 each)' % (n_bn_relu, forwards))
    for rows, _, out in results:
        if out.shape != (rows, 1000) or not np.all(np.isfinite(out)) \
                or not np.allclose(out.sum(axis=1), 1.0, atol=1e-4):
            raise AssertionError('bad response: shape %s' % (out.shape,))
    lat = np.array([r[1] for r in results])
    hist = instrument.histogram('serving.e2e_secs')
    fwd = np.array(forward_s)
    return {'load_s': load_s, 'warmup_s': warm_s,
            'rows': sum(r[0] for r in results), 'forwards': forwards,
            'fused_bn_relu_launches': n_bn_relu,
            'launches_per_forward': {'fused_bn_relu': n_bn_relu / forwards},
            'wall_s': wall,
            'images_per_s': sum(r[0] for r in results) / wall,
            'p50_ms': float(np.percentile(lat, 50)) * 1e3,
            'p99_ms': float(np.percentile(lat, 99)) * 1e3,
            'forward_p50_ms': float(np.percentile(fwd, 50)) * 1e3,
            'forward_p99_ms': float(np.percentile(fwd, 99)) * 1e3,
            'server_e2e_p50_ms': hist.quantile(0.5) * 1e3,
            'server_e2e_p99_ms': hist.quantile(0.99) * 1e3,
            'flushes': instrument.counter_value('serving.flushes'),
            'graphs': graph_report(e._forward_graph for e in
                                   predictor._bucket_execs.values()
                                   if e._forward_graph is not None),
            **memory(torch)}


# -- 4b. fleet: replicas on their own streams, lanes, deadlines, changes ----
FLEET_REPLICAS = (1, 2, 4)
FLEET_REQUESTS = 192
FLEET_CLIENTS = 16
FLEET_BURST = 64            # 8-row requests, all submitted at once
FLEET_CHANGE_CLIENTS = 4
FLEET_THINK_S = 0.08        # between a change client's requests
FLEET_WEDGE_S = 1.0         # how long the injected wedge holds r1
FLEET_WEDGE_MS = 400.0      # the supervisor's no-progress threshold
FLEET_CROSS = 16           # responses also run alone, for information


FLEET_TAG_SCALE = 8192.0     # tag t rides as t / 8192, exact in float32


class FleetProbe(object):
    """The fleet phase's instrumentation (host side only): each Predictor
    built while it is open carries the label of the parameter set being
    served (``label``), and each bucketed forward is logged as (the tags
    in pixel [0, 0, 0] of its rows, its bucket, its Predictor's label,
    the current CUDA stream, the Predictor's id, the monotonic time it
    returned)."""

    def __init__(self, mx, torch):
        cls = mx.predictor.Predictor
        self._cls, self._init, self._fwd = (cls, cls.__init__,
                                            cls._forward_bucketed)
        self.label, self.on, self.records = 'A', True, []
        self._lock = threading.Lock()
        probe = self

        def init(pred, *a, **kw):
            probe._init(pred, *a, **kw)
            pred.fleet_label = probe.label

        def forward(pred, kwargs):
            outs = probe._fwd(pred, kwargs)
            if probe.on:
                tags = np.asarray(kwargs['data'])[:, 0, 0, 0]
                rec = (tuple(int(round(t * FLEET_TAG_SCALE)) for t in tags),
                       pred._active_bucket,
                       getattr(pred, 'fleet_label', None),
                       torch.cuda.current_stream().cuda_stream, id(pred),
                       time.monotonic())
                with probe._lock:
                    probe.records.append(rec)
            return outs
        cls.__init__, cls._forward_bucketed = init, forward

    def close(self):
        self._cls.__init__ = self._init
        self._cls._forward_bucketed = self._fwd

    def first_by_tag(self):
        """tag -> the first forward that carried it (a seized flush's
        abandoned forward, if any, comes later than its replay's)."""
        out = {}
        with self._lock:
            for rec in self.records:
                for t in rec[0]:
                    out.setdefault(t, rec)
        return out


class FleetTraffic(object):
    """Requests of the fleet phase: ``rows`` images of a seeded pool,
    each row's pixel [0, 0, 0] replaced by a unique tag (request id * 8 +
    row + 1, scaled by 1 / FLEET_TAG_SCALE) so every forward names the
    requests it carried."""

    def __init__(self, server, pool):
        self.server, self.pool = server, pool
        self._uid = iter(range(1, 1 << 20))
        self._lock = threading.Lock()

    def rows_of(self, uid, rows):
        start = (uid * 7) % (len(self.pool) - 8)
        x = self.pool[start:start + rows].copy()
        x[:, 0, 0, 0] = (uid * 8 + np.arange(1, rows + 1)) / FLEET_TAG_SCALE
        return x

    def new(self, rows):
        with self._lock:
            uid = next(self._uid)
        return uid, self.rows_of(uid, rows)

    def run(self, specs=None, clients=FLEET_CLIENTS, stop=None, seed=0,
            think_s=0.0):
        """Start ``clients`` threads sending ``specs`` ((rows, lane) each,
        client k taking every clients-th) or, with ``stop``, random 1-8
        row batch-lane requests until it is set; :meth:`wait` takes what
        this returns and gives ([(uid, rows, lane, latency s, output)],
        wall s)."""
        results = []

        def client(k):
            rng = np.random.default_rng(seed + k)
            i = k
            while True:
                if stop is not None:
                    if stop.is_set():
                        return
                    rows, lane = int(rng.integers(1, 9)), None
                elif i < len(specs):
                    rows, lane = specs[i]
                    i += clients
                else:
                    return
                uid, x = self.new(rows)
                t0 = time.monotonic()
                try:
                    out = self.server.predict('fleet', timeout=300,
                                              priority=lane, data=x)[0]
                except Exception as e:        # noqa: BLE001 - reported
                    out = '%s: %s' % (type(e).__name__, e)
                results.append((uid, rows, lane, time.monotonic() - t0,
                                out))
                if think_s:
                    time.sleep(think_s)

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(clients)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        return threads, t0, results

    def wait(self, started, timeout=600):
        threads, t0, results = started
        for t in threads:
            t.join(timeout=timeout)
        if any(t.is_alive() for t in threads):
            raise AssertionError('fleet: a client hung')
        failed = [r for r in results if isinstance(r[4], str)]
        if failed:
            raise AssertionError('fleet: %d requests failed, first %s'
                                 % (len(failed), failed[0][4]))
        return results, time.monotonic() - t0


def fleet_graphs(entry):
    """Captured graphs the fleet holds (replicas x buckets when whole)."""
    return sum(1 for rep in entry.replicas
               for e in rep.predictor._bucket_execs.values()
               if e._forward_graph is not None and e._forward_graph.captured)


def fleet_check_graphs(entry, step, buckets):
    n = fleet_graphs(entry)
    if n != len(entry.replicas) * buckets:
        raise AssertionError('fleet %s: %d graphs held for %d replicas x %d '
                             'buckets' % (step, n, len(entry.replicas),
                                          buckets))
    return n


def fleet_bn_relu(entry):
    """fused_bn_relu launches each live replica's graphs have replayed:
    {replica: launches}."""
    return {rep.rid: sum(e._forward_graph.replays *
                         e._forward_graph.launches.get('fused_bn_relu', 0)
                         for e in rep.predictor._bucket_execs.values()
                         if e._forward_graph is not None)
            for rep in entry.replicas}


def fleet_latency(results, lane=None):
    lat = np.array([r[3] for r in results
                    if lane is None or r[2] == lane]) * 1e3
    return {'p50_ms': float(np.percentile(lat, 50)),
            'p99_ms': float(np.percentile(lat, 99)), 'requests': len(lat)}


def fleet_sane(results):
    for uid, rows, _, _, out in results:
        if out.shape != (rows, 1000) or not np.all(np.isfinite(out)) or \
                not np.allclose(out.sum(axis=1), 1.0, atol=1e-4):
            raise AssertionError('fleet: bad response %d, shape %s'
                                 % (uid, out.shape))


def fleet_throughput(mx, torch, fused, server, traffic, probe, rng):
    """Serve FLEET_REQUESTS requests of 1-8 rows from FLEET_CLIENTS
    threads at each replica count: images/s, p50/p99, graphs held,
    reserved memory, fused_bn_relu per replica, and each replica's
    flushes on its own stream; at 2 replicas the same requests again
    under the profiler (:func:`fleet_trace`)."""
    entry = server._entry('fleet')
    buckets = BATCH.bit_length()
    sizes = [int(v) for v in rng.integers(1, 9, size=FLEET_REQUESTS)]
    out = []
    for n in FLEET_REPLICAS:
        t0 = time.monotonic()
        while len(entry.replicas) < n:
            server.scale_up('fleet')
        scale_s = time.monotonic() - t0
        graphs = fleet_check_graphs(entry, 'at %d replicas' % n, buckets)
        before = fleet_bn_relu(entry)
        reset_launches(fused.fused_bn_relu)
        del probe.records[:]
        results, wall = traffic.wait(traffic.run(
            [(r, None) for r in sizes]))
        torch.cuda.synchronize()
        fleet_sane(results)
        per_rep = {rid: k - before.get(rid, 0)
                   for rid, k in fleet_bn_relu(entry).items()}
        total = fused.fused_bn_relu.launches
        forwards = len(probe.records)
        if total == 0 or total != 17 * forwards or \
                sum(per_rep.values()) != total:
            raise AssertionError('fleet: fused_bn_relu launched %d times in '
                                 '%d forwards, by replica %s'
                                 % (total, forwards, per_rep))
        streams = {}
        for rec in probe.records:
            streams.setdefault(rec[4], set()).add(rec[3])
        own = {id(rep.predictor): rep.stream.cuda_stream
               for rep in entry.replicas}
        if any(s != {own[p]} for p, s in streams.items()) or \
                len(set(own.values())) != n:
            raise AssertionError('fleet: flushes off their replica streams')
        flushed = Counter(rec[1] for rec in probe.records)
        out.append({'replicas': n, 'scale_s': scale_s,
                    'images_per_s': sum(sizes) / wall, 'wall_s': wall,
                    **fleet_latency(results), 'forwards': forwards,
                    'graphs_held': graphs,
                    'reserved_bytes': torch.cuda.memory_reserved(),
                    'fused_bn_relu_launches': total,
                    'fused_bn_relu_by_replica': per_rep,
                    'replicas_flushed': len(streams),
                    'flushes_by_bucket': dict(sorted(flushed.items()))})
        if n == 2:
            out[-1]['traced'] = fleet_trace(torch, traffic, sizes)
    # a model, not a measurement: each bucket's replay time alone, times
    # the step's flushes at that bucket, over its wall time.  Concurrent
    # replays contend, so past one replica it is not the busy share
    device_ms = fleet_replay_ms(torch, entry.replicas[0])
    for step in out:
        need = sum(device_ms[b] * k
                   for b, k in step['flushes_by_bucket'].items())
        step['device_busy_share_modelled'] = need / (step['wall_s'] * 1e3)
    return out, device_ms


def fleet_trace(torch, traffic, sizes):
    """The same requests again under torch.profiler: the card's busy time
    is the union of its kernel intervals (copies apart), over the run's
    wall time (clients started to the last response, synchronised)."""
    from torch.profiler import ProfilerActivity, profile
    t_trace = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results, _ = traffic.wait(traffic.run([(r, None) for r in sizes]))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fleet_sane(results)
    t0 = time.perf_counter()
    kernels, copies = [], []
    # the raw records: building the profiler's event tree for ~25k kernels
    # takes seconds
    for evt in prof.profiler.kineto_results.events():
        start, end = evt.start_ns(), evt.end_ns()
        if evt.device_type() != torch.autograd.DeviceType.CUDA or \
                end <= start:
            continue
        name = evt.name().lower()
        (copies if name.startswith(('memcpy', 'memset')) else
         kernels).append((start / 1e3, end / 1e3))
    out = {'wall_s': wall_ms / 1e3,
           'images_per_s': sum(sizes) / wall_ms * 1e3,
           **fleet_latency(results), 'kernels': len(kernels),
           'copies': len(copies)}
    if not kernels:
        out['device_busy_share'] = 'not measured'
        out['reason'] = 'the profiler recorded no device events'
        return out
    busy = union_us(kernels) / 1e3
    out.update(device_busy_ms=busy, device_busy_share=busy / wall_ms,
               copy_ms=union_us(copies) / 1e3,
               kernel_span_ms=(max(e for _, e in kernels) -
                               min(s for s, _ in kernels)) / 1e3,
               parse_s=time.perf_counter() - t0,
               trace_s=time.perf_counter() - t_trace)
    return out


def kernel_records(torch, fn, names):
    """Run ``fn`` under torch.profiler: for each of ``names``, the device
    durations (ms) of the kernels whose names contain it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {n: [] for n in names}
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        for n in names:
            if n in evt.name():
                out[n].append((evt.end_ns() - evt.start_ns()) / 1e6)
    return out


def union_us(spans):
    """Total length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0)


def fleet_replay_ms(torch, rep, reps=10):
    """Device ms of one replay of each bucket's graph of replica ``rep``,
    on its stream, by CUDA events (median of ``reps``)."""
    out = {}
    with torch.cuda.stream(rep.stream):
        for bucket, exe in sorted(rep.predictor._bucket_execs.items()):
            cap = exe._forward_graph
            times = []
            for _ in range(reps):
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                cap.graph.replay()
                t1.record()
                t1.synchronize()
                times.append(t0.elapsed_time(t1))
            out[bucket] = statistics.median(times)
    return out


def fleet_lanes(mx, torch, server, traffic, probe, rng, instrument):
    """At 2 replicas: 25% interactive 1-row and 75% batch 8-row requests,
    p99 by lane; then FLEET_BURST 8-row requests at once whose deadline
    is half a 32-row flush: the dropped ones are counted, typed, and
    never reach a forward."""
    entry = server._entry('fleet')
    lanes = rng.random(FLEET_REQUESTS) < 0.25
    specs = [(1, 'interactive') if i else (8, 'batch') for i in lanes]
    results, wall = traffic.wait(traffic.run(specs))
    fleet_sane(results)
    report = {'replicas': len(entry.replicas), 'wall_s': wall,
              'interactive': fleet_latency(results, 'interactive'),
              'batch': fleet_latency(results, 'batch'),
              'preempt_flushes':
                  instrument.counter_value('serving.preempt_flushes'),
              'starvation_flushes':
                  instrument.counter_value('serving.starvation_flushes')}
    flush_ms = instrument.histogram(
        'serving.execute_secs').quantile(0.5) * 1e3
    deadline_ms = flush_ms / 2
    drops0 = instrument.counter_value('serving.deadline_drops')
    del probe.records[:]
    burst = [traffic.new(8) for _ in range(FLEET_BURST)]
    futs = [(uid, server.submit('fleet', deadline_ms=deadline_ms, data=x))
            for uid, x in burst]
    dropped, served = [], 0
    for uid, f in futs:
        try:
            f.result(timeout=300)
            served += 1
        except mx.serving.DeadlineExceededError:
            dropped.append(uid)
    executed = probe.first_by_tag()
    ran_dead = [u for u in dropped if u * 8 + 1 in executed]
    counted = instrument.counter_value('serving.deadline_drops') - drops0
    if not dropped or counted != len(dropped) or ran_dead:
        raise AssertionError('fleet: deadline burst dropped %d (counted %d), '
                             '%d of them executed'
                             % (len(dropped), counted, len(ran_dead)))
    report['deadline_burst'] = {'requests': FLEET_BURST, 'rows': 8,
                                'deadline_ms': deadline_ms,
                                'flush_p50_ms': flush_ms,
                                'dropped': len(dropped), 'served': served,
                                'dropped_executed': 0}
    return report


FLEET_ORACLE_CHUNK = 64      # oracle forwards in flight before one check


def fleet_oracle(mx, torch, symbol_json, params, traffic, results, probe,
                 pred=None):
    """Every response against a one-replica Predictor holding the
    parameter set that served it (copied into its bound arrays, which its
    graphs read), fed the same rows: each flush that delivered a
    response is rebuilt from its rows' tags (the same requests in the
    same order, so the same bucket) and run through the oracle, and each
    response must equal its rows of the oracle's output bit for bit.  The
    oracle's outputs stay on the card until FLEET_ORACLE_CHUNK flushes
    have been run, then come back in one copy, so the host builds the
    next flush while the card runs the last.  Beside that, for
    information, FLEET_CROSS responses whose flush rode a larger bucket
    than the request alone would are run alone (their own bucket): the
    largest max |diff| / max |oracle| there, the f32 difference between
    buckets that the check above does not rely on.  ``pred``: an oracle
    an earlier call returned (the parameters are copied in before its
    first flush).  Returns (report, the oracle Predictor)."""
    from mxnet_tpu_torch.compile_cache import pad_to_bucket
    probe.on = False
    first = probe.first_by_tag()
    rows_of = {r[0]: r[1] for r in results}
    flushes = {}
    for uid, rows, _, _, out in results:
        rec = first[uid * 8 + 1]
        flushes.setdefault(id(rec), (rec, []))[1].append((uid, rows, out))
    top = max(rec[1] for rec, _ in flushes.values())
    held = None
    if pred is None:
        # a copy: the oracle's arrays are written when the label changes
        pred = mx.Predictor(symbol_json, {k: v.copy() for k, v in
                                          params['A'].items()},
                            {'data': (BATCH,) + IMAGE}, pad_to_bucket=True)
        held = 'A'
    pred.warm_buckets(top)
    checked, cross, worst = 0, 0, 0.0
    pending = []

    def check():
        """The pending flushes' responses against the oracle's rows."""
        got = torch.cat([t for t, _ in pending]).cpu().numpy()
        at = 0
        for t, (rec, bucket, label, offsets, served) in pending:
            want = got[at:at + len(t)]
            at += len(t)
            for uid, rows, out in served:
                ref = want[offsets[uid]:offsets[uid] + rows]
                if not np.array_equal(out, ref):
                    raise AssertionError(
                        'fleet: response %d (%d rows, bucket %d, parameters '
                        '%s, stream %x) differs from the oracle\'s forward '
                        'of its flush: max abs diff %g, max |oracle| %g'
                        % (uid, rows, bucket, label, rec[3],
                           float(np.max(np.abs(out - ref))),
                           float(np.max(np.abs(ref)))))
        del pending[:]

    for rec, served in sorted(flushes.values(), key=lambda f: f[0][2]):
        tags, bucket, label = rec[0], rec[1], rec[2]
        if label != held:
            if pending:
                check()
            pred._executor.copy_params_from(
                {k[4:]: v for k, v in params[label].items()
                 if k.startswith('arg:')},
                {k[4:]: v for k, v in params[label].items()
                 if k.startswith('aux:')})
            held = label
        uids = [(t - 1) // 8 for t in tags if (t - 1) % 8 == 0]
        merged = np.concatenate([traffic.rows_of(u, rows_of[u])
                                 for u in uids])
        offsets = dict(zip(uids, np.cumsum(
            [0] + [rows_of[u] for u in uids[:-1]])))
        if [t - 1 for t in tags] != [u * 8 + r for u in uids
                                     for r in range(rows_of[u])] or \
                pad_to_bucket(len(merged)) != bucket:
            raise AssertionError('fleet: a flush of %d rows that rode '
                                 'bucket %d is not whole requests'
                                 % (len(merged), bucket))
        # the forward's outputs are its own copies on the card
        out0 = pred.forward(data=merged)[0].handle[:len(merged)]
        pending.append((out0, (rec, bucket, label, offsets, served)))
        if len(pending) == FLEET_ORACLE_CHUNK:
            check()
        for uid, rows, out in served:
            checked += 1
            if cross < FLEET_CROSS and bucket != pad_to_bucket(rows):
                pred.forward(data=traffic.rows_of(uid, rows))
                alone = pred.get_output(0)
                worst = max(worst, float(np.max(np.abs(out - alone)) /
                                         np.max(np.abs(alone))))
                cross += 1
    if pending:
        check()
    probe.on = True
    return {'responses': len(results), 'flushes': len(flushes),
            'labels': sorted({rec[2] for rec, _ in flushes.values()}),
            'bit_equal': checked, 'cross_bucket_cases': cross,
            'cross_bucket_max_rel': worst}, pred


def fleet_bn_relu_cases(torch, fused, paths):
    """fused_bn_relu against its plain version at every shape the fleet's
    graphs give it: each bucket's BN-ReLU input shapes (f32)."""
    gen = torch.Generator(device='cuda').manual_seed(SEED + 6)
    cases = []
    for bucket, shapes in sorted(paths.items()):
        for shape, per_forward in sorted(shapes.items()):
            _, err, tol = bn_relu_error(torch, fused, shape, torch.float32,
                                        gen)
            cases.append({'bucket': bucket, 'shape': list(shape),
                          'launches_per_forward': per_forward,
                          'max_abs_err': err, 'tolerance': tol})
    return cases


def fleet_phase(mx, torch, fused, instrument, convert, symbol, arg, aux,
                data, bn_relu_paths):
    """4b. fleet (see the module docstring).  ``bn_relu_paths``: bucket ->
    the fused_bn_relu input shapes of the graph at that many rows."""
    t_phase = time.monotonic()
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    shapes = {'data': (BATCH,) + IMAGE}
    arg_b, aux_b = convert.random_params(symbol, shapes, SEED + 2)
    params = {'A': convert.params_from_numpy(arg, aux, 'cuda:0'),
              'B': convert.params_from_numpy(arg_b, aux_b, 'cuda:0')}
    symbol_json = symbol.tojson()
    buckets = BATCH.bit_length()
    rng = np.random.default_rng(SEED + 3)
    probe = FleetProbe(mx, torch)
    fresh_memory(torch)
    instrument.reset_metrics()
    server = mx.serving.ModelServer(max_delay_ms=2.0, max_batch=BATCH)
    report = {'model': 'resnet-50 v2', 'classes': 1000,
              'image': list(IMAGE), 'max_batch': BATCH, 'buckets': buckets,
              'fuse': 'aggressive', 'tf32': False,
              'cudnn_deterministic': True}
    try:
        t0 = time.monotonic()
        server.load_model('fleet', symbol_json=symbol_json,
                          params=params['A'], input_shapes=shapes,
                          replicas=1)
        report['load_s'] = time.monotonic() - t0
        entry = server._entry('fleet')
        fleet_check_graphs(entry, 'after load', buckets)
        traffic = FleetTraffic(server, data)
        report['throughput'], report['replay_ms_by_bucket'] = \
            fleet_throughput(mx, torch, fused, server, traffic, probe, rng)
        fleet_bn = sum(s['fused_bn_relu_launches']
                       for s in report['throughput'])
        while len(entry.replicas) > 2:
            server.scale_down('fleet')
        fleet_check_graphs(entry, 'after scale_down to 2', buckets)
        instrument.reset_metrics()
        report['lanes'] = fleet_lanes(mx, torch, server, traffic, probe,
                                      rng, instrument)
        report['at_s_lanes'] = time.monotonic() - t_phase

        # changes under traffic: scale_up 2 -> 3, reload to B, scale_down
        del probe.records[:]
        stop = threading.Event()
        started = traffic.run(clients=FLEET_CHANGE_CLIENTS, stop=stop,
                              seed=SEED + 4, think_s=FLEET_THINK_S)
        changes = {}
        t0 = time.monotonic()
        changes['scale_up'] = server.scale_up('fleet')
        changes['scale_up_s'] = time.monotonic() - t0
        fleet_check_graphs(entry, 'after scale_up to 3', buckets)
        probe.label = 'B'
        t0 = time.monotonic()
        server.reload_model('fleet', symbol_json=symbol_json,
                            params=params['B'])
        changes['reload_s'] = time.monotonic() - t0
        fleet_check_graphs(entry, 'after reload', buckets)
        reserved = [torch.cuda.memory_reserved()]
        t0 = time.monotonic()
        changes['scale_down'] = server.scale_down('fleet')
        changes['scale_down_s'] = time.monotonic() - t0
        fleet_check_graphs(entry, 'after scale_down to 2', buckets)
        stop.set()
        changed, wall = traffic.wait(started)
        fleet_sane(changed)
        changes.update(requests=len(changed), wall_s=wall)
        report['changes'] = changes

        # quarantine and replace: wedge serve.execute.r1 under traffic
        sup = server.supervise('fleet', wedge_ms=FLEET_WEDGE_MS,
                               interval_s=0.05)
        replays0 = instrument.counter_value('serving.replays')
        stop = threading.Event()
        started = traffic.run(clients=FLEET_CHANGE_CLIENTS, stop=stop,
                              seed=SEED + 5, think_s=FLEET_THINK_S)
        time.sleep(0.1)
        mx.resilience.set_faults('serve.execute.r1:after:1:wedge:%g'
                                 % FLEET_WEDGE_S)
        t_end = time.monotonic() + 60
        while not any(e['action'] == 'replace' for e in sup.events) and \
                time.monotonic() < t_end:
            time.sleep(0.02)
        time.sleep(0.3)                      # serve on after the repair
        stop.set()
        wedged, wall = traffic.wait(started)
        fleet_sane(wedged)
        mx.resilience.clear_faults()
        zombie = entry.batcher._zombies.get(1)
        if zombie is not None:
            zombie.join(timeout=60)
        evs = {e['action']: e for e in sup.events}
        if 'quarantine' not in evs or 'replace' not in evs or \
                evs['quarantine']['replica'] != 1:
            raise AssertionError('fleet: no quarantine and replacement of '
                                 'r1: %s' % sup.events)
        replays = instrument.counter_value('serving.replays') - replays0
        if replays < 1:
            raise AssertionError('fleet: the wedged flush was not replayed')
        fleet_check_graphs(entry, 'after the replacement', buckets)
        report['quarantine'] = {
            'wedge_s': FLEET_WEDGE_S, 'wedge_ms_threshold': FLEET_WEDGE_MS,
            'detected': evs['quarantine']['reason'],
            'inflight': evs['quarantine'].get('inflight'),
            'replayed': replays,
            'detect_to_repair_ms': evs['replace']['recovery_s'] * 1e3,
            'replacement': evs['replace']['replacement'],
            'replicas': len(entry.replicas),
            'abandoned_flushes':
                instrument.counter_value('serving.abandoned_flushes'),
            'requests': len(wedged), 'wall_s': wall,
            **fleet_latency(wedged)}

        # two more reloads, at one replica: reserved memory stays flat
        server.scale_down('fleet')
        reserved.append(torch.cuda.memory_reserved())
        for label in ('A', 'B'):
            probe.label = label
            server.reload_model('fleet', symbol_json=symbol_json,
                                params=params[label])
            reserved.append(torch.cuda.memory_reserved())
        per_replica = (report['throughput'][-1]['reserved_bytes'] -
                       report['throughput'][0]['reserved_bytes']) / 3.0
        report['reload_reserved_bytes'] = {
            'after_reload_1_at_3_replicas': reserved[0],
            'at_1_replica_before_reloads_2_3': reserved[1],
            'after_reload_2': reserved[2], 'after_reload_3': reserved[3],
            'one_replica_bytes': per_replica}
        if reserved[3] - reserved[1] > per_replica:
            raise AssertionError('fleet: reserved memory grew by %d bytes '
                                 'across reloads (one fleet: %d)'
                                 % (reserved[3] - reserved[1],
                                    per_replica))
        fleet_check_graphs(entry, 'after the reloads', buckets)
        report['oracle'], oracle = fleet_oracle(
            mx, torch, symbol_json, params, traffic, changed + wedged, probe)
        report['graphs_held'] = fleet_graphs(entry)
        report['bn_relu_cases'] = fleet_bn_relu_cases(torch, fused,
                                                      bn_relu_paths)
    finally:
        probe.close()
        mx.resilience.clear_faults()
        server.close(drain=False, timeout=60)
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = prev
    report['seconds'] = time.monotonic() - t_phase
    return report, fleet_bn, oracle


# -- 4c. autoscale: the windowed-p99 autoscaler with brownout, servewatch ----
AUTO_SLO_MS = 30.0
AUTO_INTERVAL_S = 0.25
AUTO_MAX_REPLICAS = 3
AUTO_HEAVY_MAX_S = 16.0      # heavy runs until brownout level 1 lands
AUTO_BROWNOUT_S = 2.0        # the heavy load held on from level 1
AUTO_HEAVY_CLIENTS = 16
AUTO_LIGHT_S = 6.0           # and on until the fleet is back at one replica
AUTO_LIGHT_MAX_S = 14.0
AUTO_LIGHT_CLIENTS = 2
AUTO_LIGHT_THINK_S = 0.02    # between a light client's requests
AUTO_SHED_BACKOFF_S = 0.02   # a shed client backs off before it retries
AUTO_POLL_S = 0.05
AUTO_DOWN_FRAC = 0.6         # a tick is clear under this x the SLO
AUTO_BN_RELU = 17            # fused_bn_relu launches of one served forward
# one Prometheus sample line: name, labels, value, then an optional
# OpenMetrics exemplar
_PROM_NUM = r'(?:[-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?|NaN|[-+]Inf)'
_PROM_LABEL = r'[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\\n]|\\.)*"'
PROM_LINE = (r'^(?:# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* '
             r'(?:counter|gauge|histogram)'
             r'|[a-zA-Z_:][a-zA-Z0-9_:]*(?:\{%s(?:,%s)*\})? %s'
             r'(?: # \{request_id="[^"]*"\} %s)?)$'
             % (_PROM_LABEL, _PROM_LABEL, _PROM_NUM, _PROM_NUM))


def auto_clients(mx, server, traffic, clients, stop, seed, interactive,
                 think_s=0.0):
    """Closed-loop clients until ``stop``: each request is interactive
    1-row with probability ``interactive``, else batch-lane 8-row.  A
    shed (ServerOverloadedError) is recorded and backed off.  Returns
    (threads, results); a result is (uid, rows, lane, latency s, output
    or 'shed', monotonic time done)."""
    results = []

    def client(k):
        rng = np.random.default_rng(seed + k)
        while not stop.is_set():
            lane = 'interactive' if rng.random() < interactive else 'batch'
            rows = 1 if lane == 'interactive' else 8
            uid, x = traffic.new(rows)
            t0 = time.monotonic()
            try:
                out = server.predict('fleet', timeout=300, priority=lane,
                                     data=x)[0]
            except mx.serving.ServerOverloadedError:
                out = 'shed'
            except Exception as e:        # noqa: BLE001 - reported
                out = '%s: %s' % (type(e).__name__, e)
            t1 = time.monotonic()
            results.append((uid, rows, lane, t1 - t0, out, t1))
            if isinstance(out, str):
                time.sleep(AUTO_SHED_BACKOFF_S)
            elif think_s:
                time.sleep(think_s)

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(clients)]
    for t in threads:
        t.start()
    return threads, results


def auto_join(threads, results):
    for t in threads:
        t.join(timeout=300)
    if any(t.is_alive() for t in threads):
        raise AssertionError('autoscale: a client hung')
    failed = [r for r in results if isinstance(r[4], str) and r[4] != 'shed']
    if failed:
        raise AssertionError('autoscale: %d requests failed, first %s'
                             % (len(failed), failed[0][4]))


def auto_stage(results, wall):
    """images/s served and p50/p99 by lane of one stage's requests."""
    served = [r for r in results if not isinstance(r[4], str)]
    out = {'wall_s': wall, 'requests': len(results),
           'served': len(served),
           'shed': sum(1 for r in results if isinstance(r[4], str)),
           'images_per_s': sum(r[1] for r in served) / wall}
    for lane in ('interactive', 'batch'):
        if any(r[2] == lane for r in served):
            out[lane] = fleet_latency([r[:5] for r in served], lane)
    return out


def auto_levels(log, t0, results, start, end):
    """The brownout stage split by the ladder's level in force when each
    request ended (the decision log's level changes, ``ms`` after the
    phase's monotonic ``t0``): {'level_<n>': auto_stage over the time
    spent at that level}."""
    changes = [(t0 + e['ms'] / 1e3, e['level']) for e in log
               if e.get('level') is not None]

    def level_at(t):
        return ([lv for tc, lv in changes if tc <= t] or [0])[-1]
    cuts = [start] + [tc for tc, _ in changes if start < tc < end] + [end]
    walls = Counter()
    for a, b in zip(cuts, cuts[1:]):
        walls[level_at(a)] += b - a
    return {'level_%d' % lv: auto_stage(
        [r for r in results if start < r[5] <= end and level_at(r[5]) == lv],
        wall) for lv, wall in sorted(walls.items())}


class AutoMonitor(object):
    """Polls the autoscaler's decision log from the main thread: after
    each decision (and its actuation thread, if any) the graphs the fleet
    holds must be replicas x buckets of the configured cap."""

    def __init__(self, sc, entry, buckets, t0_wall):
        self.sc, self.entry, self.buckets = sc, entry, buckets
        self.t0_wall = t0_wall
        self.seen = 0
        self.after = []
        self.rid_of = {}
        self.note_replicas()

    def note_replicas(self):
        for rep in list(self.entry.replicas):
            self.rid_of.setdefault(id(rep.predictor), rep.rid)

    def poll(self):
        self.note_replicas()
        evs = list(self.sc.events)
        while self.seen < len(evs):
            ev = evs[self.seen]
            self.seen += 1
            w = self.sc._watches.get('fleet')
            act = w.actuating if w is not None else None
            if act is not None:
                act.join(timeout=120)
                if act.is_alive():
                    raise AssertionError('autoscale: an actuation hung')
            self.note_replicas()
            self.after.append({
                'action': ev['action'], 'replicas': len(self.entry.replicas),
                'graphs': fleet_check_graphs(self.entry, 'after %s'
                                             % ev['action'], self.buckets)})

    def log(self):
        return [{'action': e['action'], 'reason': e['reason'],
                 'p99_ms': e.get('p99_ms'), 'replicas': e.get('replicas'),
                 'max_batch': e.get('max_batch'), 'level': e.get('level'),
                 'ms': (e['t'] - self.t0_wall) * 1e3}
                for e in self.sc.events]


def auto_light_windows(windows, start, end):
    """The light stage's ticks (``windows`` as ``autoscale_phase`` reads
    them): how many, how many meet the scale-down law's clear test (5 or
    more samples, p99 under AUTO_DOWN_FRAC of the SLO, no shed, at most a
    quarter batch queued), the longest run of clear ticks, and the
    windowed p99s of the ticks with 5 or more samples (ms: min, median,
    max)."""
    ticks = [w for w in windows if start < w[0] <= end]
    clear = [n >= 5 and not shed and p99 < AUTO_DOWN_FRAC * AUTO_SLO_MS and
             rows <= max(1, BATCH // 4) for _, p99, n, shed, rows in ticks]
    run = longest = 0
    for c in clear:
        run = run + 1 if c else 0
        longest = max(longest, run)
    p99s = sorted(p99 for _, p99, n, _, _ in ticks if n >= 5)
    return {'ticks': len(ticks), 'clear': sum(clear),
            'longest_clear_run': longest,
            'p99_ms': ([p99s[0], statistics.median(p99s), p99s[-1]]
                       if p99s else None)}


def auto_order(log, light=None):
    """The stepped load's story, in order: scale_up to the ceiling,
    brownout level >= 1, the ladder back to level 0 (max batch restored
    first where it was shrunk), scale_down to one replica.  ``light``:
    the light stage's ticks (``auto_light_windows``), named if the story
    is incomplete."""
    idx = {}
    for i, e in enumerate(log):
        a = e['action']
        if a == 'scale_up' and e['replicas'] == AUTO_MAX_REPLICAS:
            idx.setdefault('scale_up_max', i)
        if a == 'brownout' and (e['level'] or 0) >= 1 and \
                'scale_up_max' in idx:
            idx.setdefault('brownout', i)
            idx.pop('brownout_off', None)
            idx.pop('scale_down_1', None)
        if a == 'brownout' and e['level'] == 0 and 'brownout' in idx:
            idx['brownout_off'] = i
        if a == 'scale_down' and e['replicas'] == 1 and \
                'brownout_off' in idx:
            idx.setdefault('scale_down_1', i)
    missing = [k for k in ('scale_up_max', 'brownout', 'brownout_off',
                           'scale_down_1') if k not in idx]
    if missing:
        raise AssertionError('autoscale: the decision log lacks %s: %s; '
                             'light stage ticks %s'
                             % (missing, [(e['action'], e['replicas'],
                                           e['level'], round(e['ms']))
                                          for e in log], light))
    return idx


def prom_check(instrument, servewatch, text):
    """Every line of the exposition parses; returns (bad lines, a
    serving_e2e_secs exemplar request id whose postmortem was committed
    or None)."""
    import re
    line_re = re.compile(PROM_LINE)
    bad, found = [], None
    for line in text.splitlines():
        if not line_re.match(line):
            bad.append(line)
            continue
        if found is None and line.startswith('mxtpu_serving_e2e_secs_bucket') \
                and '# {request_id="' in line:
            rid = line.split('request_id="', 1)[1].split('"', 1)[0]
            pm = servewatch.postmortem_for(rid)
            if pm is not None and pm['path'] and os.path.exists(pm['path']):
                found = (rid, pm['path'], pm['kind'])
    return bad, found


def auto_chains(events, buckets):
    """Per delivered request its six servewatch bucket spans (us) and
    e2e; the flush bucket each rode."""
    flush_bucket, reqs = {}, {}
    for e in events:
        name, args = e['name'], e.get('args') or {}
        if name == 'serve.flush':
            flush_bucket[args['flush']] = args.get('bucket')
        elif name == 'serve.request':
            r = reqs.setdefault(args['req'], {})
            r['e2e'], r['flush'] = e['dur'], args['flush']
        elif name.startswith('serve.req.'):
            reqs.setdefault(args['req'], {})[name[len('serve.req.'):]] = \
                e['dur']
    broken = [rid for rid, r in reqs.items()
              if 'e2e' not in r or any(b not in r for b in buckets)
              or sum(r[b] for b in buckets) != r['e2e']]
    return reqs, flush_bucket, broken


def autoscale_phase(mx, torch, fused, instrument, convert, symbol, arg, aux,
                    data, oracle):
    """4c. autoscale (see the module docstring).  ``oracle``: the fleet
    phase's oracle Predictor."""
    import shutil
    import tempfile
    servewatch = mx.serving.servewatch
    t_phase = time.monotonic()
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    shapes = {'data': (BATCH,) + IMAGE}
    params = {'A': convert.params_from_numpy(arg, aux, 'cuda:0')}
    symbol_json = symbol.tojson()
    buckets = BATCH.bit_length()
    flight_dir = tempfile.mkdtemp(prefix='autoscale-flight-')
    probe = FleetProbe(mx, torch)
    fresh_memory(torch)
    instrument.reset_metrics()
    instrument.set_metrics(True)
    instrument.clear_trace()
    servewatch.reset()
    servewatch.set_enabled(True)
    servewatch.set_slow_ms(AUTO_SLO_MS)
    recorder = mx.health.install_flight_recorder(flight_dir)
    dump_ms = []
    dump = recorder.dump

    def timed_dump(reason, extra=None):
        t0 = time.perf_counter()
        try:
            return dump(reason, extra=extra)
        finally:
            dump_ms.append((time.perf_counter() - t0) * 1e3)
    recorder.dump = timed_dump
    server = mx.serving.ModelServer(max_delay_ms=2.0, max_batch=BATCH)
    stops = []
    report = {'model': 'resnet-50 v2', 'classes': 1000,
              'image': list(IMAGE), 'max_batch': BATCH, 'buckets': buckets,
              'fuse': 'aggressive', 'tf32': False,
              'cudnn_deterministic': True, 'slo_p99_ms': AUTO_SLO_MS,
              'interval_s': AUTO_INTERVAL_S,
              'max_replicas': AUTO_MAX_REPLICAS, 'brownout': True,
              'up_after': 2, 'down_after': 3, 'down_frac': AUTO_DOWN_FRAC}
    try:
        t0 = time.monotonic()
        server.load_model('fleet', symbol_json=symbol_json,
                          params=params['A'], input_shapes=shapes,
                          replicas=1)
        report['load_s'] = time.monotonic() - t0
        entry = server._entry('fleet')
        traffic = FleetTraffic(server, data)
        sc = server.autoscale('fleet', slo_p99_ms=AUTO_SLO_MS,
                              interval_s=AUTO_INTERVAL_S, min_replicas=1,
                              max_replicas=AUTO_MAX_REPLICAS, brownout=True,
                              up_after=2, down_after=3,
                              down_frac=AUTO_DOWN_FRAC, start=False)
        windows = []
        windowed = sc._windowed

        def read_window(w):
            out = windowed(w)
            windows.append((time.monotonic(), out[0], out[1], out[2],
                            entry.batcher.queued_rows()))
            return out
        sc._windowed = read_window
        reset_launches(fused.fused_bn_relu)
        del probe.records[:]
        captures0 = instrument.counter_value('compile.traces')
        t0_wall, t0 = time.time(), time.monotonic()
        mon = AutoMonitor(sc, entry, buckets, t0_wall)
        sc.start()
        prom = {}

        def watch_until(t_end, done=None, t_max=None):
            while True:
                mon.poll()
                if 'exemplar' not in prom and \
                        instrument.counter_value('serving.postmortems'):
                    bad, found = prom_check(instrument, servewatch,
                                            instrument.render_prometheus())
                    prom['bad_lines'] = bad[:5]
                    if bad:
                        raise AssertionError('autoscale: Prometheus lines '
                                             'do not parse: %s' % bad[:3])
                    if found is not None:
                        prom['exemplar'] = found
                now = time.monotonic()
                if now >= t_end and (done is None or done() or
                                     now >= t_max):
                    return
                time.sleep(AUTO_POLL_S)

        # heavy: 16 clients, 75% batch 8-row and 25% interactive 1-row
        stop = threading.Event()
        stops.append(stop)
        heavy = auto_clients(mx, server, traffic, AUTO_HEAVY_CLIENTS, stop,
                             SEED + 7, 0.25)
        batcher = entry.batcher
        watch_until(t0, lambda: batcher.shed_batch, t0 + AUTO_HEAVY_MAX_S)
        t_b = time.monotonic()
        # brownout: the same load, held on for a fixed span from level 1
        watch_until(t_b + AUTO_BROWNOUT_S)
        stop.set()
        auto_join(*heavy)
        t1 = time.monotonic()
        report['heavy'] = auto_stage([r for r in heavy[1] if r[5] <= t_b],
                                     t_b - t0)
        report['brownout'] = auto_stage(
            [r for r in heavy[1] if r[5] > t_b], t1 - t_b)
        report['brownout_start_ms'] = (t_b - t0) * 1e3
        report['heavy_end_ms'] = (t1 - t0) * 1e3
        # light: 2 clients of interactive 1-row requests
        stop = threading.Event()
        stops.append(stop)
        light = auto_clients(mx, server, traffic, AUTO_LIGHT_CLIENTS, stop,
                             SEED + 8, 1.0, AUTO_LIGHT_THINK_S)

        def settled():
            w = sc._watches.get('fleet')
            return len(entry.replicas) == 1 and not batcher.shed_batch and \
                batcher.max_batch == batcher.configured_max_batch and \
                (w is None or w.actuating is None or
                 not w.actuating.is_alive())
        watch_until(t1 + AUTO_LIGHT_S, settled, t1 + AUTO_LIGHT_MAX_S)
        stop.set()
        auto_join(*light)
        t2 = time.monotonic()
        sc.stop()
        mon.poll()
        report['light'] = auto_stage(light[1], t2 - t1)
        report['light_end_ms'] = (t2 - t0) * 1e3
        report['light_windows'] = auto_light_windows(windows, t1, t2)
        auto_bn = fused.fused_bn_relu.launches
        torch.cuda.synchronize()

        log = mon.log()
        report['decisions'] = log
        report['brownout_by_level'] = auto_levels(log, t0, heavy[1], t_b, t1)
        report['graphs_after_decisions'] = mon.after
        order = auto_order(log, report['light_windows'])
        report['order'] = order
        sheds = instrument.counter_value('serving.brownout_sheds')
        if not sheds:
            raise AssertionError('autoscale: brownout shed nothing: %s'
                                 % [(e['action'], e['replicas'], e['level'],
                                     round(e['ms'])) for e in log])
        report['brownout_sheds'] = sheds
        # the tick's breach evidence: the windowed p99 over the SLO (on a
        # window of 5 or more), sheds, or a backlog past one batch
        breach = [t for t, p99, n, shed, rows in windows
                  if (n >= 5 and p99 > AUTO_SLO_MS) or shed or rows > BATCH]
        new_ids = [pid for pid, rid in mon.rid_of.items() if rid == 1]
        first_flush = min(rec[5] for rec in probe.records
                          if rec[4] in new_ids)
        report['first_breach_ms'] = (breach[0] - t0) * 1e3
        report['breach_to_new_replica_flush_ms'] = \
            (first_flush - breach[0]) * 1e3
        report['windows'] = len(windows)

        # #2: 17 a forward on every replica, plus the eager warm-up before
        # each capture of a new replica's buckets (a capture launches
        # nothing; its replays count)
        forwards = Counter(rec[4] for rec in probe.records)
        warmups = instrument.counter_value('compile.traces') - captures0
        by_replica = Counter()
        for pid, n in forwards.items():
            by_replica['r%s' % mon.rid_of.get(pid, '?')] += AUTO_BN_RELU * n
        if auto_bn != AUTO_BN_RELU * (sum(forwards.values()) + warmups):
            raise AssertionError('autoscale: fused_bn_relu launched %d '
                                 'times in %d forwards and %d warm-ups'
                                 % (auto_bn, sum(forwards.values()),
                                    warmups))
        report['fused_bn_relu'] = {
            'launches': auto_bn, 'forwards': sum(forwards.values()),
            'by_replica': dict(by_replica),
            'warmup_launches': AUTO_BN_RELU * warmups,
            'replicas_built': instrument.counter_value('serving.scale_ups')}

        # attribution: every delivered request's six buckets sum to e2e
        served = [r for r in heavy[1] + light[1]
                  if not isinstance(r[4], str)]
        events = instrument.trace_events()
        reqs, flush_bucket, broken = auto_chains(events, servewatch.BUCKETS)
        if broken or len(reqs) != len(served):
            raise AssertionError('autoscale: %d of %d requests traced, %d '
                                 'chains do not sum to e2e'
                                 % (len(reqs), len(served), len(broken)))
        ex32 = [r['execute'] for r in reqs.values()
                if flush_bucket.get(r['flush']) == BATCH]
        replay_ms = fleet_replay_ms(torch, entry.replicas[0])
        tables = servewatch.budget_tables()
        ledger = max(abs(sum(t[b]['sum'] for b in servewatch.BUCKETS) -
                         t['e2e']['sum']) / max(t['e2e']['sum'], 1e-30)
                     for t in tables.values())
        trace_path = os.path.join(flight_dir, 'autoscale_trace.json')
        n_events = instrument.dump_trace(trace_path)
        rc = subprocess.call(
            [sys.executable, os.path.join(os.path.dirname(
                os.path.abspath(__file__)), 'tools', 'check_trace.py'),
             trace_path], timeout=300)
        if rc != 0:
            raise AssertionError('autoscale: tools/check_trace.py rejected '
                                 'the trace (rc %d)' % rc)
        if not ex32 or statistics.median(ex32) / 1e3 < replay_ms[BATCH]:
            raise AssertionError('autoscale: the median execute bucket at '
                                 '%d rows (%s ms over %d requests) is under '
                                 'its replay alone (%.3f ms)'
                                 % (BATCH, statistics.median(ex32) / 1e3
                                    if ex32 else None, len(ex32),
                                    replay_ms[BATCH]))
        bad, found = prom_check(instrument, servewatch,
                                instrument.render_prometheus())
        if bad or 'exemplar' not in prom:
            raise AssertionError('autoscale: Prometheus: %d bad lines, '
                                 'exemplar with a postmortem: %s'
                                 % (len(bad), prom.get('exemplar')))
        shares = {b: statistics.median(
            r[b] / max(r['e2e'], 1) for r in reqs.values())
            for b in servewatch.BUCKETS}
        report['attribution'] = {
            'requests_traced': len(reqs), 'chains_exact': len(reqs),
            'budget_ledger_max_rel': ledger,
            'bucket_median_share': shares,
            'execute_%d_rows' % BATCH: {
                'requests': len(ex32),
                'median_ms': statistics.median(ex32) / 1e3,
                'replay_alone_ms': replay_ms[BATCH]},
            'trace_events': n_events, 'check_trace_rc': rc,
            'prometheus_exemplar': prom['exemplar'],
            'postmortems': instrument.counter_value('serving.postmortems'),
            'postmortems_dropped':
                instrument.counter_value('serving.postmortems_dropped'),
            'postmortem_dump_ms': {
                'count': len(dump_ms),
                'median': statistics.median(dump_ms) if dump_ms else None,
                'max': max(dump_ms) if dump_ms else None}}

        # every response of the phase against the one-replica oracle
        t3 = time.monotonic()
        report['checks_s'] = t3 - t2
        report['oracle'], _ = fleet_oracle(
            mx, torch, symbol_json, params, traffic,
            [r[:5] for r in served], probe, oracle)
        report['oracle_s'] = time.monotonic() - t3

        # the plane's cost: fleet's 2-replica traffic, servewatch off / on
        sc.unwatch('fleet')
        while len(entry.replicas) < 2:
            server.scale_up('fleet')
        rng = np.random.default_rng(SEED + 9)
        sizes = [int(v) for v in rng.integers(1, 9, size=FLEET_REQUESTS)]
        runs = []
        for mode in ('off', 'on'):
            servewatch.set_enabled(mode == 'on')
            servewatch.reset()
            pm0 = instrument.counter_value('serving.postmortems')
            n_dumps = len(dump_ms)
            results, wall = traffic.wait(traffic.run(
                [(r, None) for r in sizes]))
            fleet_sane(results)
            runs.append({'servewatch': mode, 'replicas': 2,
                         'images_per_s': sum(sizes) / wall, 'wall_s': wall,
                         **fleet_latency(results),
                         'postmortems': instrument.counter_value(
                             'serving.postmortems') - pm0,
                         'dump_ms_total': sum(dump_ms[n_dumps:])})
        report['servewatch_cost'] = runs
        probe.on = False
        snap = server.drain(timeout=60, reason='autoscale')
        if not snap['flight_path'] or \
                not os.path.exists(snap['flight_path']):
            raise AssertionError('autoscale: drain committed no flight '
                                 'record')
        report['drain'] = {'flight_record': os.path.basename(
            snap['flight_path']), 'drain_secs': snap['drain_secs']}
    finally:
        for stop in stops:
            stop.set()
        probe.close()
        server.close(drain=False, timeout=60)
        servewatch.set_enabled(False)
        servewatch.set_slow_ms(0.0)
        servewatch.reset()
        mx.health._recorder = None
        instrument.set_profiling(False)
        instrument.clear_trace()
        shutil.rmtree(flight_dir, ignore_errors=True)
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = prev
    report['seconds'] = time.monotonic() - t_phase
    return report, auto_bn


def start_capture_checks():
    """Start the capture phase's child pytest: the card tests of
    tests/test_torch_capture.py and tests/test_torch_lifecycle.py.  It
    runs while this process starts and builds the kernels (the child
    builds what it reaches first itself; each build renames its library
    into place) and ends before any phase times the card
    (:func:`capture_checks`)."""
    import tempfile
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.TemporaryDirectory()
    report = os.path.join(tmp.name, 'capture.xml')
    proc = subprocess.Popen(
        [sys.executable, '-m', 'pytest', 'tests/test_torch_capture.py',
         'tests/test_torch_lifecycle.py', 'tests/test_torch_observe_cuda.py',
         'tests/test_torch_warm_cuda.py', '-m', 'cuda', '-q', '--noconftest', '-p', 'no:cacheprovider',
         '--durations=0', '--junitxml', report], cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, tmp, report, time.monotonic()


def capture_checks(started):
    """The capture phase: waits for :func:`start_capture_checks`'s child.
    Each test holds one behaviour of whole-step capture against the eager
    run of the same steps (an lr schedule changes the captured update at
    step 3; a warm-started fit equals a cold one and the step window
    reaches two steps in flight; alternating buckets share one set of
    parameters and keep their outputs; a served forward's arrays survive
    the next forward; set_params drops the graphs and the next step
    trains the new values; random nodes, host syncs, a Custom step
    captured in segments; the cubin store across processes and a warm
    start from the manifest, tests/test_torch_warm_cuda.py).
    Returns {test: outcome}, the child's seconds and each test's seconds
    (pytest's durations, setup and call); raises unless every test ran
    and passed."""
    import xml.etree.ElementTree as ET
    proc, tmp, report, t0 = started
    try:
        stdout, stderr = proc.communicate(timeout=600)
        seconds = time.monotonic() - t0
        cases = {}
        if os.path.exists(report):
            for case in ET.parse(report).getroot().iter('testcase'):
                outcome = 'passed'
                for child in case:
                    if child.tag in ('failure', 'error', 'skipped'):
                        outcome = child.tag
                cases[case.get('name')] = outcome
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        tmp.cleanup()
    durations = Counter()
    for line in stdout.splitlines():
        parts = line.split()
        if len(parts) == 3 and parts[0].endswith('s') and \
                parts[1] in ('setup', 'call', 'teardown'):
            try:
                durations[parts[2].split('::')[-1]] += float(parts[0][:-1])
            except ValueError:
                pass
    missing = [n for n in CAPTURE_CHECKS + LIFECYCLE_CHECKS + OBSERVE_CHECKS
               + WARM_CHECKS if cases.get(n) != 'passed']
    if proc.returncode != 0 or missing:
        print(stdout[-6000:], stderr[-2000:], file=sys.stderr)
        raise AssertionError('capture: pytest rc %d, not passed: %s'
                             % (proc.returncode, missing or cases))
    return cases, seconds, dict(durations.most_common())


def train_module(mx, torch, symbol, arg, aux, data, labels, ctx, dtype,
                 batch, snap_at=None, optimizer='sgd', optimizer_params=None,
                 eval_metric=('acc', 'ce'), epoch_end=None, **fit_kw):
    """``Module.fit`` over an NDArrayIter (SGD lr 0.05 momentum 0.9 wd
    1e-4 unless told otherwise; ``epoch_end(mod)`` makes the epoch-end
    callback); returns the module and the host seconds of each step
    (each ends in a device synchronise), and with ``snap_at`` the
    parameters after that many steps."""
    times = []
    last = [time.perf_counter()]
    on_card = (ctx[0] if isinstance(ctx, list) else ctx).device_type == 'gpu'
    snap = {}

    def tick(_):
        if on_card:
            torch.cuda.synchronize()
        now = time.perf_counter()
        times.append(now - last[0])
        if len(times) == snap_at:
            snap.update({k: v.asnumpy()
                         for k, v in mod.get_params()[0].items()})
        last[0] = time.perf_counter()

    mod = mx.mod.Module(symbol, context=ctx, compute_dtype=dtype)
    if epoch_end is not None:
        fit_kw['epoch_end_callback'] = epoch_end(mod)
    mod.fit(mx.io.NDArrayIter(data, labels, batch_size=batch),
            num_epoch=fit_kw.pop('num_epoch', 1),
            eval_metric=list(eval_metric) if isinstance(eval_metric, tuple)
            else eval_metric,
            optimizer=optimizer, optimizer_params=dict(
                optimizer_params or SGD_MOMENTUM),
            arg_params={k: mx.nd.array(v) for k, v in arg.items()},
            aux_params={k: mx.nd.array(v) for k, v in aux.items()},
            batch_end_callback=tick, **fit_kw)
    if snap_at is not None:
        return mod, times, snap
    return mod, times


def numpy_params(mod):
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def step_report(step_s, counts0, kernels, torch):
    """Host ms per step (the first captures), the median of the later
    ones, launches per step by kernel and route, peak memory."""
    return {'step_ms': [t * 1e3 for t in step_s],
            'step_ms_median_after_first': statistics.median(step_s[1:]) * 1e3,
            'launches_per_step': launches_per_step(
                counts0, launch_counts(kernels), len(step_s)),
            **memory(torch)}


def optim_train(mx, torch, symbol, arg, aux, images, labels, kernels,
                expected):
    """optim-train: per optimizer, OPTIM_STEPS captured bf16 steps of the
    full-width ResNet (counts zeroed just before, read just after), the
    same steps under NaiveEngine (launches per step by kernel and route
    must be equal, parameters within train-parity's bound), then the same
    steps in float32 captured and through the Updater loop
    (MXTPU_FUSED_FIT=0: forward_backward, then the ops/optim.py update
    ops; parameters within the bound)."""
    rows = images[:OPTIM_STEPS * BATCH], labels[:OPTIM_STEPS * BATCH]
    report, launches, failures = {}, dict.fromkeys(expected, 0), []
    for opt, params in OPTIMIZERS:
        entry = {'optimizer_params': params}
        fresh_memory(torch)
        for k in kernels:
            reset_launches(k)
        counts0 = launch_counts(kernels)
        mod, step_s = train_module(mx, torch, symbol, arg, aux, *rows,
                                   mx.gpu(0), torch.bfloat16, BATCH,
                                   optimizer=opt, optimizer_params=params)
        for name in launches:
            launches[name] += kernels_by_name(kernels)[name].launches
        captured = step_report(step_s, counts0, kernels, torch)
        graphs = graph_report(mod._graphs.values())
        if len(graphs) != 1 or not graphs[0]['captured'] or \
                graphs[0]['replays'] != OPTIM_STEPS - 1:
            raise AssertionError('optim-train %s: not one replayed graph: %s'
                                 % (opt, graphs))
        for name, per_step in expected.items():
            got = captured['launches_per_step'].get(name, {})
            if got.get('all') != per_step or (
                    name != 'fused_bn_relu' and got.get('sm90') != per_step):
                raise AssertionError('optim-train %s: %s launches per step '
                                     '%s, expected %d (sm90)'
                                     % (opt, name, got, per_step))
        card = numpy_params(mod)
        state_leaves = sum(len(v) if isinstance(v, tuple) else
                           int(v is not None)
                           for v in mod._fused_opt_state.values())
        del mod
        fresh_memory(torch)
        counts0 = launch_counts(kernels)
        set_engine(mx, True)
        try:
            emod, estep_s = train_module(mx, torch, symbol, arg, aux, *rows,
                                         mx.gpu(0), torch.bfloat16, BATCH,
                                         optimizer=opt,
                                         optimizer_params=params)
        finally:
            set_engine(mx, False)
        eager = step_report(estep_s, counts0, kernels, torch)
        entry['capture_vs_eager'] = compare_runs(
            'optim-train %s' % opt, captured, eager, card,
            numpy_params(emod), OPTIM_STEPS)
        del emod
        # float32: the captured step against the Updater loop, with
        # deterministic cuDNN algorithms (the two paths run the same ops)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        runs = {}
        for mode in ('captured', 'loop'):
            fresh_memory(torch)
            counts0 = launch_counts(kernels)
            os.environ['MXTPU_FUSED_FIT'] = '0' if mode == 'loop' else '1'
            try:
                m, ms = train_module(mx, torch, symbol, arg, aux, *rows,
                                     mx.gpu(0), None, BATCH, optimizer=opt,
                                     optimizer_params=params)
            finally:
                os.environ.pop('MXTPU_FUSED_FIT')
            if (m._fused is None) != (mode == 'loop'):
                raise AssertionError('optim-train %s: the %s run took the '
                                     'other path' % (opt, mode))
            runs[mode] = (step_report(ms, counts0, kernels, torch),
                          numpy_params(m))
            del m
        loop = parity_report(runs['loop'][1], runs['captured'][1])
        entry['f32_captured_vs_loop'] = {
            'captured': runs['captured'][0], 'loop': runs['loop'][0], **loop}
        failure = beyond_bound('optim-train %s, loop against captured'
                               % opt, loop)
        if failure:
            failures.append(failure)
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.allow_tf32 = True
        entry.update(capture_ms=graphs[0]['capture_ms'],
                     state_tensors=state_leaves,
                     step_ms_captured=captured['step_ms_median_after_first'],
                     step_ms_eager=eager['step_ms_median_after_first'],
                     step_ms_loop_f32=runs['loop'][0][
                         'step_ms_median_after_first'],
                     step_ms_captured_f32=runs['captured'][0][
                         'step_ms_median_after_first'])
        report[opt] = entry
    return report, launches, failures


def kernels_by_name(kernels):
    return {getattr(k, '__name__', str(k)): k for k in kernels}


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def checkpoint_resume(mx, torch, symbol, arg, aux, images, labels, kernels,
                      expected, tmp):
    """checkpoint-resume: SGD with momentum, bf16, 2 epochs of
    CKPT_BATCHES batches with fit(checkpoint_prefix=...) and
    module_checkpoint(..., save_optimizer_states=True); Module.load of
    epoch 1 with its optimizer states into a fresh module, fit of epoch
    2: its parameters against the uninterrupted run's; then
    fit(auto_resume=True) from a prefix holding only epoch 1, against
    Module.load without optimizer states (both restart the momentum).
    Times writing and reading the .params and .states files."""
    rows = images[:CKPT_BATCHES * BATCH], labels[:CKPT_BATCHES * BATCH]
    prefix = os.path.join(tmp, 'resnet')
    instrument = mx.instrument
    commits0 = instrument.counter_value('checkpoint.commits')
    resumes0 = instrument.counter_value('checkpoint.resumes')
    fresh_memory(torch)
    for k in kernels:
        reset_launches(k)
    counts0 = launch_counts(kernels)
    mod, step_s = train_module(
        mx, torch, symbol, arg, aux, *rows, mx.gpu(0), torch.bfloat16, BATCH,
        num_epoch=2, checkpoint_prefix=prefix,
        epoch_end=lambda m: mx.callback.module_checkpoint(
            m, prefix + '-mc', save_optimizer_states=True))
    launches = {name: kernels_by_name(kernels)[name].launches
                for name in expected}
    straight = step_report(step_s, counts0, kernels, torch)
    for name, per_step in expected.items():
        if straight['launches_per_step'].get(name, {}).get('all') != per_step:
            raise AssertionError('checkpoint-resume: %s launches per step %s'
                                 % (name, straight['launches_per_step']))
    want = numpy_params(mod)
    timing = {}
    fname = os.path.join(tmp, 'timed')
    _, timing['params_write_ms'] = _timed(
        lambda: mod.save_params(fname + '.params'))
    _, timing['states_write_ms'] = _timed(
        lambda: mod.save_optimizer_states(fname + '.states'))
    _, timing['params_read_ms'] = _timed(
        lambda: mx.nd.load(fname + '.params'))

    def read_states():
        with open(fname + '.states', 'rb') as f:
            return mx.optimizer.loads_states(f.read())
    _, timing['states_read_ms'] = _timed(read_states)
    timing['params_bytes'] = os.path.getsize(fname + '.params')
    timing['states_bytes'] = os.path.getsize(fname + '.states')
    del mod
    epochs = mx.model.loadable_epochs(prefix)
    mc_epochs = mx.model.loadable_epochs(prefix + '-mc')
    if epochs != [1, 2] or mc_epochs != [1, 2] or not os.path.exists(
            prefix + '-mc-0001.states'):
        raise AssertionError('checkpoint-resume: checkpoints %s / %s'
                             % (epochs, mc_epochs))

    def resumed(load_states):
        fresh_memory(torch)
        rmod = mx.mod.Module.load(prefix + '-mc', 1,
                                  load_optimizer_states=load_states,
                                  context=mx.gpu(0),
                                  compute_dtype=torch.bfloat16)
        first = []
        t0 = time.perf_counter()

        def tick(_):
            if not first:
                torch.cuda.synchronize()
                first.append((time.perf_counter() - t0) * 1e3)
        rmod.fit(mx.io.NDArrayIter(*rows, batch_size=BATCH), num_epoch=2,
                 begin_epoch=1, optimizer='sgd',
                 optimizer_params=dict(SGD_MOMENTUM),
                 eval_metric=['acc', 'ce'], batch_end_callback=tick)
        torch.cuda.synchronize()
        got = numpy_params(rmod)
        del rmod
        return got, first[0]

    got, first_ms = resumed(True)
    resume = compare_params('checkpoint-resume load', got, want)
    # auto_resume from a prefix that holds only epoch 1's files
    auto = os.path.join(tmp, 'auto')
    for suffix in ('-symbol.json', '-0001.params'):
        with open(prefix + '-mc' + suffix, 'rb') as f, \
                open(auto + suffix, 'wb') as g:
            g.write(f.read())
    fresh_memory(torch)
    amod, _ = train_module(mx, torch, symbol, arg, aux, *rows, mx.gpu(0),
                           torch.bfloat16, BATCH, num_epoch=2,
                           checkpoint_prefix=auto, auto_resume=True)
    got_auto = numpy_params(amod)
    del amod
    if mx.model.loadable_epochs(auto) != [1, 2]:
        raise AssertionError('checkpoint-resume: auto_resume wrote %s'
                             % mx.model.loadable_epochs(auto))
    want_auto, _ = resumed(False)
    auto_report = compare_params('checkpoint-resume auto', got_auto,
                                 want_auto)
    return {'checkpoints': epochs, 'module_checkpoints': mc_epochs,
            'uninterrupted': straight, **timing,
            'resumed_first_step_host_ms': first_ms,
            'load_optimizer_states_vs_uninterrupted': resume,
            'auto_resume_vs_load_without_states': auto_report,
            'checkpoint_commits':
                instrument.counter_value('checkpoint.commits') - commits0,
            'checkpoint_resumes':
                instrument.counter_value('checkpoint.resumes') - resumes0}, \
        launches


def feedforward_phase(mx, torch, fused, symbol, arg, aux, images, labels,
                      tmp):
    """feedforward: FeedForward.create over FF_ROWS images (float32, SGD
    with momentum, numpy_batch_size 32: 4 shuffled batches), then predict
    and score on FF_EVAL_ROWS images (17 fused_bn_relu per forward,
    counts zeroed just before), save, FeedForward.load, predict again:
    the predictions must be equal."""
    # float32 without TF32: which cuDNN algorithm a TF32 convolution takes
    # (and so its rounding) varied between two inference modules here
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    np.random.seed(SEED)
    t0 = time.perf_counter()
    model = mx.FeedForward.create(
        symbol, images[:FF_ROWS], labels[:FF_ROWS], ctx=mx.gpu(0),
        num_epoch=1, numpy_batch_size=BATCH, arg_params={
            k: mx.nd.array(v) for k, v in arg.items()},
        aux_params={k: mx.nd.array(v) for k, v in aux.items()},
        **SGD_MOMENTUM)
    torch.cuda.synchronize()
    fit_ms = (time.perf_counter() - t0) * 1e3
    reset_launches(fused.fused_bn_relu)
    forwards0 = mx.instrument.counter_value('executor.forwards')
    pred, predict_ms = _timed(lambda: model.predict(images[:FF_EVAL_ROWS]))
    bn_relu = fused.fused_bn_relu.launches
    forwards = mx.instrument.counter_value('executor.forwards') - forwards0
    if bn_relu != 17 * forwards or forwards != FF_EVAL_ROWS // BATCH:
        raise AssertionError('feedforward: %d fused_bn_relu launches in %d '
                             'forwards' % (bn_relu, forwards))
    acc = model.score(mx.io.NDArrayIter(images[:FF_EVAL_ROWS],
                                        labels[:FF_EVAL_ROWS],
                                        batch_size=BATCH))
    prefix = os.path.join(tmp, 'ff')
    model.save(prefix)
    back = mx.FeedForward.load(prefix, 1, ctx=mx.gpu(0))
    for name, saved, loaded in (('arg', model.arg_params, back.arg_params),
                                ('aux', model.aux_params, back.aux_params)):
        if sorted(saved) != sorted(loaded) or not all(
                np.array_equal(saved[k].asnumpy(), loaded[k].asnumpy())
                for k in saved):
            raise AssertionError('feedforward: the loaded %s params differ'
                                 % name)
    if back.symbol.tojson() != symbol.tojson():
        raise AssertionError('feedforward: the loaded symbol differs')
    repeat = model.predict(images[:FF_EVAL_ROWS])
    again = back.predict(images[:FF_EVAL_ROWS])
    if pred.shape != (FF_EVAL_ROWS, 1000) or not np.all(np.isfinite(pred)) \
            or not np.allclose(pred.sum(axis=1), 1.0, atol=1e-4):
        raise AssertionError('feedforward: bad predictions %s'
                             % (pred.shape,))
    if not np.array_equal(pred, again):
        raise AssertionError(
            'feedforward: the loaded model predicts otherwise (max abs diff '
            '%g; the trained model again: %g; rows differing %s)'
            % (float(np.max(np.abs(pred - again))),
               float(np.max(np.abs(pred - repeat))),
               np.nonzero(np.any(pred != again, axis=1))[0].tolist()))
    moved = max(float(np.max(np.abs(model.arg_params[k].asnumpy() - v)))
                for k, v in arg.items())
    if moved <= 0.0:
        raise AssertionError('feedforward: the parameters did not move')
    # TF32 on (cuDNN): a loaded FeedForward predicts at its own
    # numpy_batch_size (default 128: the 64 images as one 64-row batch,
    # where the trained model's are two of 32), and cuDNN's TF32
    # algorithm (its rounding) depends on the batch shape
    # (tools/torch_tf32_reload.py).  At the trained model's batch the
    # predictions are equal; at its own they stay within FF_TF32_ATOL.
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    same = mx.FeedForward.load(prefix, 1, ctx=mx.gpu(0),
                               numpy_batch_size=BATCH)
    tf32 = model.predict(images[:FF_EVAL_ROWS])
    tf32_same = same.predict(images[:FF_EVAL_ROWS])
    tf32_own = back.predict(images[:FF_EVAL_ROWS])
    tf32_gap = float(np.max(np.abs(tf32 - tf32_own)))
    torch.backends.cuda.matmul.allow_tf32 = False
    if not np.array_equal(tf32, tf32_same) or tf32_gap > FF_TF32_ATOL:
        raise AssertionError(
            'feedforward, TF32: at the trained batch max abs diff %g (must '
            'be 0); at the loaded model\'s own batch %g (bound %g)'
            % (float(np.max(np.abs(tf32 - tf32_same))), tf32_gap,
               FF_TF32_ATOL))
    return {'rows': FF_ROWS, 'batches': FF_ROWS // BATCH,
            'compute_dtype': 'float32', 'tf32': False, 'fit_ms': fit_ms,
            'predict_rows': FF_EVAL_ROWS, 'predict_ms': predict_ms,
            'fused_bn_relu_launches': bn_relu, 'forwards': forwards,
            'score_accuracy': acc, 'max_param_change': moved,
            'reloaded_predictions_equal': True,
            'tf32_reloaded_at_trained_batch_equal': True,
            'tf32_reloaded_at_own_batch_max_abs_diff': tf32_gap,
            'tf32_bound': FF_TF32_ATOL}, bn_relu


def lm_adam(mx, torch, models, lm_arg, kernels):
    """lm-adam: the full-width LM through Module.fit in bf16, Adam, a
    device-folded Perplexity(ignore_label=None), LM_ADAM_STEPS steps
    captured (counts zeroed just before, read just after: 6
    flash_attention and 6 fused_dot_epilogue per step, sm90), then the
    same steps under NaiveEngine: launches equal, perplexity within
    bf16's bound (rtol 2e-2), parameters within train-parity's bound."""
    sym = lm_symbol(models)
    seq, v = LM['seq_len'], LM['vocab_size']
    toks = np.random.RandomState(SEED + 4).randint(
        0, v, (LM_ADAM_STEPS * LM_BATCH, seq)).astype(np.float32)
    label = ((toks + 1) % v).astype(np.float32)
    runs = {}
    for mode in ('captured', 'eager'):
        fresh_memory(torch)
        for k in kernels:
            reset_launches(k)
        counts0 = launch_counts(kernels)
        set_engine(mx, mode == 'eager')
        try:
            metric = mx.metric.Perplexity(ignore_label=None)
            mod, step_s = train_module(
                mx, torch, sym, lm_arg, {}, toks, label, mx.gpu(0),
                torch.bfloat16, LM_BATCH, optimizer='adam',
                optimizer_params=LM_ADAM, eval_metric=metric)
        finally:
            set_engine(mx, False)
        if mod._fused_metric is not metric:
            raise AssertionError('lm-adam: the perplexity was not folded '
                                 'into the step')
        rep = step_report(step_s, counts0, kernels, torch)
        rep['launches'] = {k: kernels_by_name(kernels)[k].launches
                           for k in ('flash_attention',
                                     'fused_dot_epilogue')}
        rep['perplexity'] = metric.get()[1]
        rep['graphs'] = graph_report(mod._graphs.values())
        runs[mode] = (rep, numpy_params(mod))
        del mod
    cap, eager = runs['captured'][0], runs['eager'][0]
    for name in ('flash_attention', 'fused_dot_epilogue'):
        got = cap['launches_per_step'].get(name, {})
        if got.get('all') != LM['num_layers'] or \
                got.get('sm90') != LM['num_layers']:
            raise AssertionError('lm-adam: %s launches per step %s'
                                 % (name, got))
    if not (cap['graphs'][0]['captured'] and
            cap['graphs'][0]['replays'] == LM_ADAM_STEPS - 1):
        raise AssertionError('lm-adam: graphs %s' % cap['graphs'])
    ppl = (cap['perplexity'], eager['perplexity'])
    if not all(np.isfinite(ppl)) or abs(ppl[0] - ppl[1]) > 2e-2 * ppl[1]:
        raise AssertionError('lm-adam: perplexity captured %g, eager %g'
                             % ppl)
    report = compare_runs('lm-adam', cap, eager, runs['captured'][1],
                          runs['eager'][1], LM_ADAM_STEPS)
    step_ms = cap['step_ms_median_after_first']
    return {'model': 'transformer_lm', **LM, 'batch': LM_BATCH,
            'steps': LM_ADAM_STEPS, 'compute_dtype': 'bfloat16',
            'entry': 'Module.fit', 'optimizer': 'adam %s' % LM_ADAM,
            'metric': 'Perplexity(ignore_label=None), folded',
            'perplexity_captured': ppl[0], 'perplexity_eager': ppl[1],
            'step_ms_captured': step_ms,
            'step_ms_eager': eager['step_ms_median_after_first'],
            'tokens_per_s': LM_BATCH * seq / step_ms * 1e3,
            'capture_vs_eager': report}, cap['launches']


def serve(server, data, rng):
    """64 requests of 1-8 rows from 4 threads; returns per-request
    (rows, latency_s, output) and the wall seconds."""
    sizes = [int(v) for v in rng.integers(1, 9, size=N_REQUESTS)]
    offsets = np.cumsum([0] + sizes[:-1]) % (len(data) - 8)
    results = [None] * N_REQUESTS
    errors = []

    def client(k):
        try:
            for i in range(k, N_REQUESTS, N_CLIENTS):
                rows = data[offsets[i]:offsets[i] + sizes[i]]
                t0 = time.monotonic()
                out = server.predict('resnet50', timeout=300, data=rows)
                results[i] = (sizes[i], time.monotonic() - t0, out[0])
        except Exception as e:                    # noqa: BLE001 - reported
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(N_CLIENTS)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.monotonic() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError('serving failed: %s' % (errors or 'hung'))
    return results, wall


# -- the user-extension path: Rtc kernels and Custom operators ---------------
# What a user of mx.rtc writes (MXRtc's convention): the BODY of a CUDA
# __global__ function whose parameters are the named inputs (const T*) and
# outputs (T*).  MXRtc kernels take no scalar arguments, so the row width
# is compiled in: one module per width.
#
# Row softmax, one block per row of a compiled-in width N, T threads
# (blockDim.x, a multiple of 32, at most 1024; also compiled in).  Each
# thread keeps its share of the row in registers: V 4-wide chunks, chunk
# c = threadIdx.x + k * T, so a warp's loads are 512 contiguous bytes.
# One read of the row (128-bit loads where N % 4 == 0 and both row bases
# are 16-byte aligned, else scalar loads with the same layout), a block
# max and a block sum (warp shuffles and a 32-entry __shared__ array:
# Rtc.push gives no dynamic shared memory), one write: y = exp(x - max) /
# sum.  Padding past N holds -inf, whose exp adds nothing to the sum.
SOFTMAX_FWD = r'''
constexpr int N = %(n)d, T = %(block)d;
constexpr int C = (N + 3) / 4, V = (C + T - 1) / T;
const float* xr = x + (long long)blockIdx.x * N;
float* yr = y + (long long)blockIdx.x * N;
const bool vec = N %% 4 == 0 &&
    ((reinterpret_cast<unsigned long long>(xr) |
      reinterpret_cast<unsigned long long>(yr)) & 15) == 0;
__shared__ float part[32];
const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
const float ninf = __int_as_float(0xff800000);
float4 v[V];
if (vec) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int j = 4 * (threadIdx.x + k * T);
    v[k] = j < N ? *reinterpret_cast<const float4*>(xr + j)
                 : make_float4(ninf, ninf, ninf, ninf);
  }
} else {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int j = 4 * (threadIdx.x + k * T);
    v[k].x = j < N ? xr[j] : ninf;
    v[k].y = j + 1 < N ? xr[j + 1] : ninf;
    v[k].z = j + 2 < N ? xr[j + 2] : ninf;
    v[k].w = j + 3 < N ? xr[j + 3] : ninf;
  }
}
float m = ninf;
#pragma unroll
for (int k = 0; k < V; ++k)
  m = fmaxf(m, fmaxf(fmaxf(v[k].x, v[k].y), fmaxf(v[k].z, v[k].w)));
#pragma unroll
for (int o = 16; o > 0; o >>= 1)
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
if (lane == 0) part[warp] = m;
__syncthreads();
m = lane < T / 32 ? part[lane] : ninf;
#pragma unroll
for (int o = 16; o > 0; o >>= 1)
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
__syncthreads();
float s = 0.f;
#pragma unroll
for (int k = 0; k < V; ++k) {
  v[k].x = expf(v[k].x - m);
  v[k].y = expf(v[k].y - m);
  v[k].z = expf(v[k].z - m);
  v[k].w = expf(v[k].w - m);
  s += (v[k].x + v[k].y) + (v[k].z + v[k].w);
}
#pragma unroll
for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
if (lane == 0) part[warp] = s;
__syncthreads();
s = lane < T / 32 ? part[lane] : 0.f;
#pragma unroll
for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
const float inv = 1.f / s;
#pragma unroll
for (int k = 0; k < V; ++k) {
  const int j = 4 * (threadIdx.x + k * T);
  const float4 r = make_float4(v[k].x * inv, v[k].y * inv, v[k].z * inv,
                               v[k].w * inv);
  if (vec) {
    if (j < N) *reinterpret_cast<float4*>(yr + j) = r;
  } else {
    if (j < N) yr[j] = r.x;
    if (j + 1 < N) yr[j + 1] = r.y;
    if (j + 2 < N) yr[j + 2] = r.z;
    if (j + 3 < N) yr[j + 3] = r.w;
  }
}
'''
# the loss gradient of examples/numpy_ops.py, dx = y - onehot(label): the
# row copied in 4-wide chunks (as the forward reads it) with 1 taken off
# the one hot column; scalar where the chunks are not 16-byte aligned.
# The other columns are y itself, which is y - 0 to the bit.
SOFTMAX_BWD = r'''
constexpr int N = %(n)d, T = %(block)d;
constexpr int C = (N + 3) / 4, V = (C + T - 1) / T;
const long long row = blockIdx.x;
const int hot = (int)label[row];
const float* yr = y + row * N;
float* dr = dx + row * N;
const bool vec = N %% 4 == 0 &&
    ((reinterpret_cast<unsigned long long>(yr) |
      reinterpret_cast<unsigned long long>(dr)) & 15) == 0;
if (vec) {
  float4 v[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int j = 4 * (threadIdx.x + k * T);
    if (j < N) v[k] = *reinterpret_cast<const float4*>(yr + j);
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int j = 4 * (threadIdx.x + k * T);
    if (j >= N) continue;
    const int h = hot - j;
    if (h == 0) v[k].x -= 1.f;
    if (h == 1) v[k].y -= 1.f;
    if (h == 2) v[k].z -= 1.f;
    if (h == 3) v[k].w -= 1.f;
    *reinterpret_cast<float4*>(dr + j) = v[k];
  }
} else {
  for (int j = threadIdx.x; j < N; j += T)
    dr[j] = yr[j] - (j == hot ? 1.f : 0.f);
}
'''
# The first bodies, kept as the yardstick the ones above are timed
# against in turns: three passes over the row (max, sum, write), the
# second and third reading it from device memory again at the LM head's
# width; and a scalar backward.
SOFTMAX_FWD_3PASS = r'''
const int n = %(n)d;
const float* xr = x + (long long)blockIdx.x * n;
float* yr = y + (long long)blockIdx.x * n;
__shared__ float part[32];
const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
const int warps = blockDim.x >> 5;
float m = __int_as_float(0xff800000);
for (int j = threadIdx.x; j < n; j += blockDim.x) m = fmaxf(m, xr[j]);
for (int o = 16; o > 0; o >>= 1)
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
if (lane == 0) part[warp] = m;
__syncthreads();
m = part[0];
for (int w = 1; w < warps; ++w) m = fmaxf(m, part[w]);
__syncthreads();
float s = 0.f;
for (int j = threadIdx.x; j < n; j += blockDim.x) s += expf(xr[j] - m);
for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
if (lane == 0) part[warp] = s;
__syncthreads();
s = 0.f;
for (int w = 0; w < warps; ++w) s += part[w];
const float inv = 1.f / s;
for (int j = threadIdx.x; j < n; j += blockDim.x)
  yr[j] = expf(xr[j] - m) * inv;
'''
SOFTMAX_BWD_SCALAR = r'''
const int n = %(n)d;
const long long row = blockIdx.x;
const int hot = (int)label[row];
const float* yr = y + row * n;
float* dr = dx + row * n;
for (int j = threadIdx.x; j < n; j += blockDim.x)
  dr[j] = yr[j] - (j == hot ? 1.f : 0.f);
'''
# (forward, backward) bodies by name; 'floor' is an empty body: what a
# push of the same grid, block and arguments costs the card
SOFTMAX_BODIES = {'new': (SOFTMAX_FWD, SOFTMAX_BWD),
                  'old': (SOFTMAX_FWD_3PASS, SOFTMAX_BWD_SCALAR),
                  'floor': ('', '')}
# the reference MXNet's tests/python/gpu/test_rtc.py
REF_BODY = r'''
__shared__ float s_rec[10];
s_rec[threadIdx.x] = x[threadIdx.x];
y[threadIdx.x] = expf(s_rec[threadIdx.x]*5.0);
'''
# tests/test_rtc.py's axpy and square as CUDA bodies: one thread per
# element, grid (rows, 1, 1) x block (columns, 1, 1)
AXPY_BODY = r'''
const int i = blockIdx.x * blockDim.x + threadIdx.x;
out[i] = 2.0f * x[i] + y[i];
'''
SQUARE_BODY = r'''
const int i = blockIdx.x * blockDim.x + threadIdx.x;
o[i] = a[i] * a[i];
'''
BROKEN_BODY = 'y[0] = x[0] +;'
SOFTMAX_RTOL = 1e-5
LM_HEAD = (8192, 32000)     # the LM's logits at 16 x 512 tokens (off-path)
CUSTOM_PARITY_ROWS = 2
_SOFTMAX_KERNELS = {}
USER_CALLS = {'forward': 0, 'backward': 0}     # softmax_rtc on the card
CUSTOM_PROFILE_REPLAYS = 10     # custom-train's per-stage timing


def rtc_block(n):
    """Threads per row, compiled into the bodies: 256 for the head's 1000
    classes (one 4-wide chunk a thread); 1024 for wider rows (at 32000
    classes, 8 chunks, 32 floats of registers a thread)."""
    return 256 if n <= 4096 else 1024


def softmax_kernels(mx, n, bodies='new'):
    """The (forward, backward) Rtc kernels for rows of ``n`` classes from
    ``SOFTMAX_BODIES[bodies]``, made once per width."""
    k = _SOFTMAX_KERNELS.get((n, bodies))
    if k is None:
        fwd, bwd = SOFTMAX_BODIES[bodies]
        fill = {'n': n, 'block': rtc_block(n)}
        row, lab = mx.nd.zeros((1, n)), mx.nd.zeros((1,))
        k = _SOFTMAX_KERNELS[n, bodies] = (
            mx.rtc.Rtc('softmax_fwd', [('x', row)], [('y', row)],
                       fwd % fill),
            mx.rtc.Rtc('softmax_bwd', [('y', row), ('label', lab)],
                       [('dx', row)], bwd % fill))
    return k


def push_softmax(mx, x, out):
    fwd, _ = softmax_kernels(mx, x.shape[1])
    fwd.push([x], [out], (x.shape[0], 1, 1), (rtc_block(x.shape[1]), 1, 1))


def push_softmax_grad(mx, y, label, out):
    _, bwd = softmax_kernels(mx, y.shape[1])
    bwd.push([y, label], [out], (y.shape[0], 1, 1),
             (rtc_block(y.shape[1]), 1, 1))


def register_user_ops(mx):
    """The user code of the extension phases, registered as Custom ops:
    ``softmax_rtc``, the loss head of examples/numpy_ops.py
    (need_top_grad=False; on a gpu context two Rtc kernels, on the CPU
    nd.* only, the reference's idiom), and tests/test_operator_custom.py's
    ``sqr``."""
    nd = mx.nd

    class RtcSoftmax(mx.operator.CustomOp):
        # Rtc.push swaps its result into out_data / in_grad: a 'write'
        def forward(self, is_train, req, in_data, out_data, aux):
            USER_CALLS['forward'] += 1
            push_softmax(mx, in_data[0], out_data[0])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            USER_CALLS['backward'] += 1
            push_softmax_grad(mx, out_data[0], in_data[1], in_grad[0])

    class NdSoftmax(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0]
            e = nd.exp(x - nd.max(x, axis=1, keepdims=True))
            self.assign(out_data[0], req[0],
                        e / nd.sum(e, axis=1, keepdims=True))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0]
            self.assign(in_grad[0], req[0],
                        y - nd.one_hot(in_data[1], depth=y.shape[1]))

    @mx.operator.register('softmax_rtc')
    class SoftmaxRtcProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ['data', 'label']

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return RtcSoftmax() if ctx.device_type == 'gpu' else NdSoftmax()

    class Sqr(mx.operator.CustomOp):
        def __init__(self, scale):
            self.scale = scale

        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0],
                        nd.square(in_data[0]) * self.scale)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0],
                        out_grad[0] * in_data[0] * (2.0 * self.scale))

    @mx.operator.register('sqr')
    class SqrProp(mx.operator.CustomOpProp):
        contexts = []       # what create_operator was given

        def __init__(self, scale='1.0'):
            super().__init__(need_top_grad=True)
            self.scale = float(scale)

        def create_operator(self, ctx, shapes, dtypes):
            SqrProp.contexts.append(ctx)
            return Sqr(self.scale)

    return SqrProp


def custom_symbol(mx, resnet):
    """Full-width ResNet-50 v2 whose SoftmaxOutput is replaced by the
    ``softmax_rtc`` Custom head over fc1's output."""
    net = resnet.get_symbol(num_classes=1000, num_layers=50,
                            image_shape=IMAGE)
    fc1 = net.get_internals()['fc1_output']
    return mx.sym.Custom(fc1, mx.sym.Variable('softmax_label'),
                         op_type='softmax_rtc', name='softmax')


def rtc_compile_stats(instrument):
    return (instrument.counter_value('rtc.compiles'),
            instrument.histogram('rtc.compile_secs').sum)


def rtc_case(torch, instrument, name, kernel, ins, outs, dims, check, plain,
             library, nbytes, ops, flush, old=None, **info):
    """One Rtc case on the card: the first push (NVRTC compile and module
    load where its dtypes are new to ``kernel``), ``check(outs)`` of its
    outputs (-> max abs error, tolerance text), then the push timed as the
    other kernels are, in turns with ``old`` (the body it replaced, held
    to the same check; None where there is none) and with the floor (an
    empty body of the same launch, grid, block and arguments: what a push
    costs the card), then its plain version and the library call (None
    where no single PyTorch call computes the function), the host cost of
    one push (checks, output allocation, plan lookup, the ctypes launch)
    and of the library call, and the bound."""
    n0, s0 = rtc_compile_stats(instrument)
    t0 = time.perf_counter()
    kernel.push(ins, outs, *dims)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    n1, s1 = rtc_compile_stats(instrument)
    err, tol = check(outs)
    # old bodies and the floor write into spare arrays, not the case's
    spare = [o.copy() for o in outs]
    floor = type(kernel)(kernel.name + '_floor',
                         list(zip(kernel.input_names, ins)),
                         list(zip(kernel.output_names, spare)), '')
    runs = [lambda: kernel.push(ins, outs, *dims),
            lambda: floor.push(ins, spare, *dims)]
    if old is not None:
        old.push(ins, spare, *dims)
        torch.cuda.synchronize()
        check(spare)
        runs.append(lambda: old.push(ins, spare, *dims))
    floor.push(ins, spare, *dims)
    times = cuda_ms_each(torch, runs, flush)
    floor.close()
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = ops / FP32_FLOPS * 1e3
    return dict(name=name, **info, grid=list(dims[0]), block=list(dims[1]),
                compiles=n1 - n0, nvrtc_s=s1 - s0, first_push_s=first_s,
                max_abs_err=err, tolerance=tol, ms=times[0],
                floor_ms=times[1],
                old_body_ms=times[2] if old is not None else None,
                plain_ms=cuda_ms(torch, plain, flush),
                library_ms=(cuda_ms(torch, library, flush)
                            if library is not None else None),
                host_us=host_us(torch, runs[0]),
                library_host_us=(host_us(torch, library)
                                 if library is not None else None),
                bound_ms=max(byte_ms, op_ms),
                bound_by='bytes' if byte_ms >= op_ms else 'operations',
                bytes=nbytes, operations=ops)


def softmax_cases(mx, torch, instrument, rows, n, gen, flush, per_step):
    """The softmax head's two kernels at (rows, n) f32: the forward within
    rtol 1e-5 of torch.softmax in float64 cast back (and of the plain
    version, the nd.* head's arithmetic); the backward exactly y -
    onehot(label).  The first bodies (``SOFTMAX_BODIES['old']``) are held
    to the same checks and timed in turns (``old_body_ms``)."""
    dev = torch.device('cuda', 0)
    x = torch.randn(rows, n, generator=gen, device=dev) * 3.0
    label = torch.randint(0, n, (rows,), generator=gen,
                          device=dev).float()
    xa, la = mx.nd.NDArray(x), mx.nd.NDArray(label)
    y, dx = mx.nd.zeros((rows, n), ctx=mx.gpu(0)), \
        mx.nd.zeros((rows, n), ctx=mx.gpu(0))
    fwd, bwd = softmax_kernels(mx, n)
    old_fwd, old_bwd = softmax_kernels(mx, n, 'old')
    dims = ((rows, 1, 1), (rtc_block(n), 1, 1))

    def plain_fwd():
        e = torch.exp(x - x.amax(1, keepdim=True))
        return e / e.sum(1, keepdim=True)

    def plain_bwd():
        return y.handle - (torch.arange(n, device=dev)[None]
                           == label.long()[:, None]).float()

    hot = label.long()[:, None]
    minus_one = torch.full((rows, 1), -1.0, device=dev)

    def library_bwd():
        return torch.scatter_add(y.handle, 1, hot, minus_one)

    def check_fwd(outs):
        got = outs[0].handle
        want = torch.softmax(x.double(), 1).float()
        rel = float(((got - want).abs()
                     / want.abs().clamp_min(1e-37)).max())
        plain = plain_fwd()
        rel_plain = float(((got - plain).abs()
                           / plain.abs().clamp_min(1e-37)).max())
        if not bool(torch.isfinite(got).all()) or rel > SOFTMAX_RTOL or \
                rel_plain > 2 * SOFTMAX_RTOL:
            raise AssertionError(
                'rtc softmax_fwd %s: max rel err %g vs float64 softmax, '
                '%g vs the plain version (tolerance %g, %g)'
                % ((rows, n), rel, rel_plain, SOFTMAX_RTOL,
                   2 * SOFTMAX_RTOL))
        return float((got - plain).abs().max()), \
            'rtol %g of torch.softmax in float64 (max rel err %g)' % (
                SOFTMAX_RTOL, rel)

    def check_bwd(outs):
        want = plain_bwd()
        if not torch.equal(library_bwd(), want):
            raise AssertionError('rtc softmax_bwd %s: the library call '
                                 'computes another function' % ((rows, n),))
        got = outs[0].handle
        if not torch.equal(got, want):
            raise AssertionError('rtc softmax_bwd %s: dx differs from y - '
                                 'onehot(label) by %g' % (
                                     (rows, n), float((got - want)
                                                      .abs().max())))
        return 0.0, 'exact'

    elems = rows * n
    cases = [
        rtc_case(torch, instrument, 'softmax_fwd', fwd, [xa], [y], dims,
                 check_fwd, plain_fwd, lambda: torch.softmax(x, 1),
                 2 * elems * 4, 7 * elems, flush, old=old_fwd,
                 shape=[rows, n], dtype='float32',
                 launches_per_step=per_step, library_call='torch.softmax'),
        rtc_case(torch, instrument, 'softmax_bwd', bwd, [y, la], [dx], dims,
                 check_bwd, plain_bwd, library_bwd, 2 * elems * 4 + rows * 4,
                 elems, flush, old=old_bwd, shape=[rows, n],
                 dtype='float32', launches_per_step=per_step,
                 library_call='torch.scatter_add(y, 1, label, -1)')]
    return cases


def rtc_kernels(mx, torch, instrument, gen, flush):
    """Phase 3c: the Rtc cases on the card, TF32 off."""
    ctx = mx.gpu(0)
    nd = mx.nd
    cases = []
    # the reference MXNet's GPU test: shared memory, expf, a 10-thread block
    x, y = nd.ones((10,), ctx=ctx), nd.zeros((10,), ctx=ctx)
    k = mx.rtc.Rtc('abc', [('x', x)], [('y', y)], REF_BODY)
    want = np.float32(np.exp(5.0))

    def check_ref(outs):
        got = outs[0].asnumpy()
        ulps = float(np.max(np.abs(got.astype(np.float64) - float(want))
                            / np.spacing(want)))
        if ulps > 2:
            raise AssertionError('rtc abc: expf(5x) %d ulp from exp(5)'
                                 % ulps)
        return float(np.max(np.abs(got - want))), '2 ulp (%g ulp)' % ulps

    cases.append(rtc_case(
        torch, instrument, 'abc', k, [x], [y], ((1, 1, 1), (10, 1, 1)),
        check_ref, lambda: torch.exp(x.handle * 5.0), None, 80, 20, flush,
        shape=[10], dtype='float32', launches_per_step=0))
    # tests/test_rtc.py's axpy and square; a second shape of square
    # reuses its module, float16 compiles a second one
    xa = nd.array(np.arange(12, dtype=np.float32).reshape(3, 4), ctx=ctx)
    ya = nd.array(np.full((3, 4), 2.0, np.float32), ctx=ctx)
    out = nd.zeros((3, 4), ctx=ctx)
    axpy = mx.rtc.Rtc('axpy', [('x', xa), ('y', ya)], [('out', out)],
                      AXPY_BODY)

    def check_axpy(outs):
        want = 2.0 * xa.asnumpy() + ya.asnumpy()
        if not np.array_equal(outs[0].asnumpy(), want):
            raise AssertionError('rtc axpy disagrees: %s'
                                 % outs[0].asnumpy())
        return 0.0, 'exact'

    cases.append(rtc_case(
        torch, instrument, 'axpy', axpy, [xa, ya], [out],
        ((3, 1, 1), (4, 1, 1)), check_axpy,
        lambda: 2.0 * xa.handle + ya.handle,
        lambda: torch.add(ya.handle, xa.handle, alpha=2.0), 144, 24, flush,
        shape=[3, 4], dtype='float32', launches_per_step=0,
        library_call='torch.add(y, x, alpha=2)'))
    sq = mx.rtc.Rtc('square', [('a', xa)], [('o', out)], SQUARE_BODY)
    for shape, dt in (((3, 4), 'float32'), ((2, 3), 'float32'),
                      ((2, 3), 'float16')):
        a = nd.array(np.arange(np.prod(shape)).reshape(shape), ctx=ctx,
                     dtype=dt)
        o = nd.zeros(shape, ctx=ctx, dtype=dt)

        def check_sq(outs, a=a):
            if not torch.equal(outs[0].handle, a.handle * a.handle):
                raise AssertionError('rtc square %s %s disagrees'
                                     % (a.shape, a.dtype))
            return 0.0, 'exact'

        case = rtc_case(
            torch, instrument, 'square', sq, [a], [o],
            ((shape[0], 1, 1), (shape[1], 1, 1)), check_sq,
            lambda a=a: a.handle * a.handle,
            lambda a=a: torch.square(a.handle), 2 * a.size * a.handle
            .element_size(), a.size, flush, shape=list(shape), dtype=dt,
            launches_per_step=0, library_call='torch.square')
        cases.append(case)
    new = [c['compiles'] for c in cases if c['name'] == 'square']
    if new != [1, 0, 1] or len(sq._cache) != 2:
        raise AssertionError('rtc square: compiles per push %s (want one per '
                             'dtype, none for a new shape), %d modules'
                             % (new, len(sq._cache)))
    # path 4's head at its shape, then at the LM head's (off the path)
    cases += softmax_cases(mx, torch, instrument, BATCH, 1000, gen, flush, 1)
    cases += softmax_cases(mx, torch, instrument, LM_HEAD[0], LM_HEAD[1],
                           gen, flush, 0)
    # a syntax error raises with NVRTC's log
    bad = mx.rtc.Rtc('broken', [('x', x)], [('y', y)], BROKEN_BODY)
    try:
        bad.push([x], [nd.zeros((10,), ctx=ctx)])
    except mx.MXNetError as e:
        if 'expected an expression' not in str(e):
            raise AssertionError('rtc: compile error without the log: %s'
                                 % e) from e
        bad_log = str(e)
    else:
        raise AssertionError('rtc: a body with a syntax error compiled')
    for kernel in (k, axpy, sq):
        kernel.close()
    return cases, bad_log


def rtc_summary(cases, launches):
    """The kernels-line entry of Rtc: the head's two launches of one
    32-row training step (forward and backward, float32)."""
    on_path = [c for c in cases if c['launches_per_step']]
    modules = [c for c in cases if c['compiles']]
    return {'name': 'rtc', 'route': 'cuda',
            'source': 'mxnet_tpu_torch/csrc/rtc.cu',
            'replaces': 'mxnet_tpu/rtc.py:91', 'launches': launches,
            'launches_by_path': {'custom-train': launches},
            'kernel_bodies': 'chip_smoke.py SOFTMAX_FWD (one read of each '
                             'row, 128-bit loads), SOFTMAX_BWD (128-bit); '
                             'old_body_ms: SOFTMAX_FWD_3PASS, '
                             'SOFTMAX_BWD_SCALAR',
            'old_body_ms': _sum_cases(on_path, 'old_body_ms'),
            'floor_ms': _sum_cases(on_path, 'floor_ms'),
            'max_abs_err': max(c['max_abs_err'] for c in on_path),
            'ms': _sum_cases(on_path, 'ms'),
            'plain_ms': _sum_cases(on_path, 'plain_ms'),
            'bound_ms': _sum_cases(on_path, 'bound_ms'),
            'bound_by': 'bytes',
            'library_ms': _sum_cases(on_path, 'library_ms'),
            'library_call': 'torch.softmax (forward) + torch.scatter_add '
                            '(backward)',
            'per': 'one 32-row training step (softmax forward and '
                   'backward), float32',
            'host_us_per_push': statistics.mean(c['host_us']
                                                for c in on_path),
            'library_host_us': statistics.mean(c['library_host_us']
                                               for c in on_path),
            'nvrtc_s_per_module': statistics.mean(
                c['nvrtc_s'] / c['compiles'] for c in modules),
            'cases': cases}


def imperative_script(mx, data):
    """A fixed script of nd.* calls on the current context: one op of each
    family of the imperative layer, NDArray arithmetic, indexing and
    in-place updates, and nd.Custom.  Returns [(name, result, exact)]."""
    nd = mx.nd
    a, b = nd.array(data['a']), nd.array(data['b'])     # (3, 4)
    i, j = nd.array(data['i']), nd.array(data['j'])     # integer-valued
    r = nd.array(data['row'])                            # (1, 4)
    idx = nd.array(data['idx'])                          # (3,) in [0, 4)
    m3 = nd.array(data['m3'])                            # (2, 3, 4)
    c = a.copy()
    c[1, 1:3] = 7.0
    c[0] = b[2]
    d = a.copy()
    d += b
    d *= 2.0
    e = nd.zeros((3, 4))
    nd.relu(b, out=e)
    top_v, top_i = nd.topk(i, k=2, ret_typ='both')
    return [
        ('exp', nd.exp(a), False), ('relu', nd.relu(a), True),
        ('stop_gradient', nd.stop_gradient(a), True),
        ('Cast', nd.Cast(a * 10, dtype='int32'), True),
        ('_plus', nd._plus(a, b), True),
        ('broadcast_mul', nd.broadcast_mul(a, r), True),
        ('div', a / b, False), ('mod', a % 1.5, False),
        ('scalar', 2.0 - a * 3.0, True), ('power_scalar', a ** 2, False),
        ('greater', i > j, True),
        ('smooth_l1', nd.smooth_l1(a, scalar=0.7), False),
        ('broadcast_to', nd.broadcast_to(r, shape=(3, 4)), True),
        ('broadcast_axis', nd.broadcast_axis(nd.expand_dims(idx, axis=1),
                                             axis=1, size=4), True),
        ('sum', nd.sum(m3, axis=(0, 2), keepdims=True), False),
        ('mean', nd.mean(m3, axis=1), False),
        ('max', nd.max(i, axis=1), True),
        ('argmax', nd.argmax(i, axis=1), True),
        ('norm', nd.norm(a), False),
        ('expand_dims', nd.expand_dims(a, axis=0), True),
        ('dot', nd.dot(a, b, transpose_b=True), False),
        ('batch_dot', nd.batch_dot(m3, m3, transpose_b=True), False),
        ('slice', nd.slice(m3, begin=(0, 1, None), end=(2, 3, -1)), True),
        ('setitem', c, True), ('getitem', a[1:3], True),
        ('_crop_assign_scalar', nd._crop_assign_scalar(
            a, begin=(0, 1), end=(2, 3), scalar=5.0), True),
        ('flip', nd.flip(a, axis=1), True),
        ('repeat', nd.repeat(a, repeats=2, axis=0), True),
        ('tile', nd.tile(a, reps=(2, 1)), True),
        ('pad', nd.pad(m3.reshape((1, 2, 3, 4)), mode='constant',
                       pad_width=(0, 0, 0, 0, 1, 1, 2, 2),
                       constant_value=1.5), True),
        ('take', nd.take(a, idx, axis=1), True),
        ('batch_take', nd.batch_take(a, idx), True),
        ('one_hot', nd.one_hot(idx, depth=4), True),
        ('where', nd.where(i > 0, a, b), True),
        ('_ones', nd._ones(shape=(2, 3)), True),
        ('_full', nd._full(shape=(2, 3), value=2.5), True),
        ('_arange', nd._arange(start=1.0, stop=9.0, step=2.0, repeat=2),
         True),
        ('arange', nd.arange(0, 6), True),
        ('zeros_like', nd.zeros_like(a), True),
        ('topk_value', top_v, True), ('topk_index', top_i, True),
        ('sort', nd.sort(i, axis=1), True),
        ('argsort', nd.argsort(i, axis=1), True),
        ('add_n', nd.add_n(a, b, a), False),
        ('reciprocal', nd.reciprocal(b), False),
        ('trunc', nd.trunc(a * 3), True),
        ('diag', nd.diag(i[:, :3], k=1), True),
        ('stack', nd.stack(a, b, axis=1), True),
        ('pick', nd.pick(a, idx, axis=1), True),
        ('softmax', nd.softmax(a, axis=1), False),
        ('SoftmaxActivation', nd.SoftmaxActivation(a), False),
        ('LeakyReLU', nd.LeakyReLU(a, slope=0.1), True),
        ('Dropout_p0', nd.Dropout(a, p=0.0), True),
        ('Concat', nd.Concat(a, b, dim=1), True),
        ('inplace', d, True), ('out', e, True),
        ('maximum', nd.maximum(a, b), True),
        ('power', nd.power(2.0, a), False),
        ('Custom', nd.Custom(a, op_type='sqr', scale=3), True)]


def imperative_data():
    rs = np.random.RandomState(SEED)
    return {'a': rs.randn(3, 4).astype(np.float32),
            'b': (rs.rand(3, 4) + 0.5).astype(np.float32),
            'i': rs.randint(-3, 3, (3, 4)).astype(np.float32),
            'j': rs.randint(-3, 3, (3, 4)).astype(np.float32),
            'row': rs.randn(1, 4).astype(np.float32),
            'idx': rs.randint(0, 4, (3,)).astype(np.float32),
            'm3': rs.randn(2, 3, 4).astype(np.float32)}


def random_moments(mx):
    """mx.random on the current context: moments of 10^5 draws (the
    bounds of tests/test_random.py), seed determinism, and Dropout's kept
    share."""
    mx.random.seed(SEED)
    u = mx.random.uniform(-2.0, 3.0, shape=(100000,))
    n = mx.random.normal(1.0, 2.0, shape=(100000,))
    mx.random.seed(SEED)
    again = mx.random.uniform(-2.0, 3.0, shape=(100000,))
    kept = float((mx.nd.Dropout(mx.nd.ones((100, 100)), p=0.3)
                  .asnumpy() != 0).mean())
    uv, nv = u.asnumpy(), n.asnumpy()
    res = {'device': str(u.context), 'uniform_min': float(uv.min()),
           'uniform_max': float(uv.max()), 'uniform_mean': float(uv.mean()),
           'normal_mean': float(nv.mean()), 'normal_std': float(nv.std()),
           'seed_repeats': bool(np.array_equal(uv, again.asnumpy())),
           'dropout_kept': kept}
    if not (uv.min() >= -2.0 and uv.max() <= 3.0
            and abs(uv.mean() - 0.5) < 0.05 and abs(nv.mean() - 1.0) < 0.05
            and abs(nv.std() - 2.0) < 0.05 and res['seed_repeats']
            and abs(kept - 0.7) < 0.03):
        raise AssertionError('mx.random moments off: %s' % res)
    return res


def imperative(mx, sqr_prop):
    """Phase 10: the script under ``with mx.gpu(0):`` and on ``cpu()``
    from the same numpy inputs: rtol 1e-5 (atol 1e-6), exact for integer,
    indexing and data-movement ops; every result on its scope's
    context."""
    data = imperative_data()
    # outside a scope: nd.array / nd.zeros on the host, the rest on the card
    placed = [mx.nd.array([1.0]).context, mx.nd.zeros((1,)).context,
              mx.nd.ones((1,)).context, mx.nd.arange(2).context,
              mx.random.uniform(shape=(2,)).context]
    if placed != [mx.cpu(0)] * 2 + [mx.gpu(0)] * 3:
        raise AssertionError('imperative: default contexts %s' % placed)
    runs, moments = {}, {}
    for ctx in (mx.gpu(0), mx.cpu()):
        with ctx:
            del sqr_prop.contexts[:]
            res = imperative_script(mx, data)
            moments[ctx.device_type] = random_moments(mx)
        wrong = [name for name, v, _ in res if v.context != ctx]
        if wrong or sqr_prop.contexts != [ctx]:
            raise AssertionError('imperative: %s ran off %s (Custom got %s)'
                                 % (wrong, ctx, sqr_prop.contexts))
        runs[ctx.device_type] = [(name, v.asnumpy(), exact)
                                 for name, v, exact in res]
    worst = (0.0, None)
    for (name, g, exact), (_, h, _) in zip(runs['gpu'], runs['cpu']):
        if g.dtype != h.dtype or g.shape != h.shape:
            raise AssertionError('imperative %s: %s %s on the card, %s %s '
                                 'on the CPU' % (name, g.dtype, g.shape,
                                                 h.dtype, h.shape))
        if exact:
            np.testing.assert_array_equal(g, h, err_msg=name)
        else:
            np.testing.assert_allclose(g, h, rtol=1e-5, atol=1e-6,
                                       err_msg=name)
            err = float(np.max(np.abs(g.astype(np.float64) - h)))
            if err > worst[0]:
                worst = (err, name)
    return {'calls': len(runs['gpu']),
            'exact': sum(1 for r in runs['gpu'] if r[2]),
            'max_abs_err_float': worst[0], 'worst': worst[1],
            'tolerance': 'rtol 1e-5, atol 1e-6; exact for integer, '
                         'indexing and data-movement ops',
            'random': moments}


# ---------------------------------------------------------------------------
# The rest of training: backward mirroring, monitors, the data iterators,
# AlexNet, and the nn ops of the slice
# ---------------------------------------------------------------------------

MIRROR_STEPS = 3
MIRROR_POLICIES = ('off', 'dots', 'nothing')
MONITOR_STEPS = 6
MONITOR_PATTERN = '.*(conv|fc).*'
MNIST_IMAGES = 60000        # the size of MNIST's training set
MNIST_BATCH = 128
CSV_ROWS = 10000
ALEXNET_STEPS = 5


def set_mirror(policy):
    """MXNET_BACKWARD_DO_MIRROR under ``policy`` ('off' unsets it)."""
    if policy == 'off':
        os.environ.pop('MXNET_BACKWARD_DO_MIRROR', None)
        os.environ.pop('MXNET_BACKWARD_MIRROR_POLICY', None)
    else:
        os.environ['MXNET_BACKWARD_DO_MIRROR'] = '1'
        os.environ['MXNET_BACKWARD_MIRROR_POLICY'] = policy


def mirror_runs(mx, torch, run, kernels):
    """``run(policy) -> (step seconds, params, graphs)`` under each
    policy from the same state: per run the step ms, peak memory, launches
    per step by kernel and route, capture ms and the parameters' gap to
    the unmirrored run ('nothing' must be bit-identical, 'dots' within
    train-parity's bound)."""
    runs, params = {}, {}
    for policy in MIRROR_POLICIES:
        set_mirror(policy)
        try:
            fresh_memory(torch)
            counts0 = launch_counts(kernels)
            mirrored0 = mx.instrument.counter_value(
                'executor.mirrored_forwards')
            step_s, params[policy], graphs = run(policy)
        finally:
            set_mirror('off')
        runs[policy] = {
            **step_report(step_s, counts0, kernels, torch),
            'mirrored_forwards': mx.instrument.counter_value(
                'executor.mirrored_forwards') - mirrored0,
            'graphs': graphs}
    failures = []
    for policy in ('dots', 'nothing'):
        rep = parity_report(params[policy], params['off'])
        runs[policy]['gap_to_off'] = rep
        if policy == 'nothing' and not rep['bitwise_equal']:
            failures.append("mirror 'nothing' is not bit-identical to the "
                            'unmirrored run: %s' % rep['worst_param'])
        failure = beyond_bound('mirror %s' % policy, rep)
        if failure:
            failures.append(failure)
        for name, off in runs['off']['launches_per_step'].items():
            got = runs[policy]['launches_per_step'].get(name, {}).get('all')
            if got is None or not off['all'] <= got <= 2 * off['all']:
                failures.append('mirror %s: %s launched %s per step against '
                                '%s unmirrored' % (policy, name, got,
                                                   off['all']))
        if not runs[policy]['mirrored_forwards']:
            failures.append('mirror %s: no mirrored forward' % policy)
        if not all(g['captured'] for g in runs[policy]['graphs']):
            failures.append('mirror %s: not captured: %s'
                            % (policy, runs[policy]['graphs']))
    for policy in MIRROR_POLICIES:
        runs[policy]['peak_allocated_vs_off'] = (
            runs[policy]['peak_allocated_bytes']
            / runs['off']['peak_allocated_bytes'])
        runs[policy]['step_ms_vs_off'] = (
            runs[policy]['step_ms_median_after_first']
            / runs['off']['step_ms_median_after_first'])
    return runs, failures


def mirror_train(mx, torch, ts, symbol, arg, aux, images, labels, lm_sym,
                 lm_arg, resnet_kernels, lm_kern):
    """mirror-train: the captured ResNet fit step (bf16 over f32 masters,
    SGD with momentum, 32 rows) and the captured LM train step (bf16, 16 x
    512) with the mirror off, under 'dots' and under 'nothing', from the
    same state, MIRROR_STEPS steps each, cuDNN deterministic."""
    torch.backends.cudnn.deterministic = True
    dev = torch.device('cuda', 0)
    n = MIRROR_STEPS * BATCH
    launches = Counter()
    try:
        def resnet_run(policy):
            c0 = launch_counts(resnet_kernels)
            mod, step_s = train_module(mx, torch, symbol, arg, aux,
                                       images[:n], labels[:n], mx.gpu(0),
                                       torch.bfloat16, BATCH)
            for name, (k, _) in launch_counts(resnet_kernels).items():
                launches[name] += k - c0[name][0]
            out = (step_s, numpy_params(mod),
                   graph_report(mod._graphs.values()))
            del mod
            return out
        resnet_runs, failures = mirror_runs(mx, torch, resnet_run,
                                            resnet_kernels)
        batch = lm_batch(torch, dev, LM_BATCH)

        def lm_run(policy):
            c0 = launch_counts(lm_kern)
            step = lm_step(ts, lm_sym, LM_BATCH, torch.bfloat16)
            params = {k: torch.tensor(v, device=dev)
                      for k, v in lm_arg.items()}
            state = ts.sgd_momentum_init(params)
            step_s = []
            for _ in range(MIRROR_STEPS):
                t1 = time.perf_counter()
                _, params, _, state = step(params, {}, state, batch)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t1)
            for name, (k, _) in launch_counts(lm_kern).items():
                launches[name] += k - c0[name][0]
            out = (step_s, {k: v.cpu().numpy() for k, v in params.items()},
                   graph_report(c for c, _ in step.graphs.values()))
            del step, params, state
            return out
        lm_runs, lm_failures = mirror_runs(mx, torch, lm_run, lm_kern)
    finally:
        torch.backends.cudnn.deterministic = False
    return ({'resnet': resnet_runs, 'lm': lm_runs},
            failures + lm_failures, dict(launches))


class _Recorder(object):
    """A monitor's ``toc_print`` that keeps what it would log."""

    def __init__(self, mon):
        self.seen = []
        mon.toc_print = lambda: self.seen.append(mon.toc())


def monitor_iter(mx, images, labels, rows, steps):
    """PrefetchingIter(ResizeIter(NDArrayIter(...), steps)): two batches
    of data, resized to ``steps`` batches."""
    return mx.io.PrefetchingIter(mx.io.ResizeIter(
        mx.io.NDArrayIter(images[:2 * rows], labels[:2 * rows],
                          batch_size=rows), steps))


def monitored_fit(mx, torch, symbol, arg, aux, images, labels, ctx, rows,
                  steps, monitor):
    """Module.fit over :func:`monitor_iter` (float32, SGD with momentum),
    with ``monitor`` or without; returns the module, the step seconds and
    the recorder."""
    times, last = [], [time.perf_counter()]
    on_card = ctx.device_type == 'gpu'

    def tick(_):
        if on_card:
            torch.cuda.synchronize()
        now = time.perf_counter()
        times.append(now - last[0])
        last[0] = time.perf_counter()

    recorder = _Recorder(monitor) if monitor is not None else None
    it = monitor_iter(mx, images, labels, rows, steps)
    mod = mx.mod.Module(symbol, context=ctx)
    try:
        mod.fit(it, num_epoch=1, optimizer='sgd',
                optimizer_params=dict(SGD_MOMENTUM),
                arg_params={k: mx.nd.array(v) for k, v in arg.items()},
                aux_params={k: mx.nd.array(v) for k, v in aux.items()},
                batch_end_callback=tick, monitor=monitor)
    finally:
        it.close()
    return mod, times, recorder


def monitor_fit(mx, torch, symbol, arg, aux, images, labels, kernels):
    """monitor-fit: ResNet-50 v2 (f32, TF32 off, cuDNN deterministic)
    through Module.fit(monitor=Monitor(2, pattern=MONITOR_PATTERN)) over
    PrefetchingIter(ResizeIter(NDArrayIter, 6)), against the same fit
    unmonitored (captured); one more monitored step by hand counts the
    kernels of its forward (none: the original symbol runs) and of its
    backward (the fused program's training forward); the first monitored
    step's stats and parameters at PARITY_ROWS rows on the card against
    the CPU."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    out, failures = {}, []
    try:
        fresh_memory(torch)
        mod, plain_s, _ = monitored_fit(mx, torch, symbol, arg, aux, images,
                                        labels, mx.gpu(0), BATCH,
                                        MONITOR_STEPS, None)
        out['unmonitored'] = {
            'step_ms': [t * 1e3 for t in plain_s],
            'step_ms_median_after_first':
                statistics.median(plain_s[1:]) * 1e3,
            'graphs': graph_report(mod._graphs.values())}
        del mod
        fresh_memory(torch)
        skipped0 = mx.instrument.counter_value('compile.capture_skipped')
        counts0 = launch_counts(kernels)
        mon = mx.monitor.Monitor(2, pattern=MONITOR_PATTERN)
        mod, mon_s, rec = monitored_fit(mx, torch, symbol, arg, aux, images,
                                        labels, mx.gpu(0), BATCH,
                                        MONITOR_STEPS, mon)
        fit_launches = launch_counts(kernels)
        skipped = mx.instrument.counter_value('compile.capture_skipped') \
            - skipped0
        taps = [len(b) for b in rec.seen]
        names = sorted({n for b in rec.seen for _, n, _ in b})
        # one monitored step by hand: the forward's and backward's kernels
        batch = mx.io.DataBatch([mx.nd.array(images[:BATCH])],
                                [mx.nd.array(labels[:BATCH])])
        c0 = launch_counts(kernels)
        mon.tic()
        mod.forward(batch, is_train=True)
        torch.cuda.synchronize()
        c1 = launch_counts(kernels)
        mod.backward()
        mod.update()
        torch.cuda.synchronize()
        c2 = launch_counts(kernels)
        mon.toc()
        launches = {name: c2[name][0] - counts0[name][0] for name in c2}
        out['monitored'] = {
            'step_ms': [t * 1e3 for t in mon_s],
            'step_ms_median_after_first':
                statistics.median(mon_s[1:]) * 1e3,
            'launches_per_step': launches_per_step(counts0, fit_launches,
                                                   len(mon_s)),
            'forward_launches': launches_per_step(c0, c1, 1),
            'backward_launches': launches_per_step(c1, c2, 1),
            'taps_per_step': taps, 'tap_names': len(names),
            'tap_names_head': names[:6], 'capture_skipped': skipped,
            'fused': mod._fused is not None,
            'graphs': graph_report(mod._graphs.values())}
        del mod
        if out['monitored']['forward_launches']:
            failures.append('monitor-fit: the tapped forward launched %s'
                            % out['monitored']['forward_launches'])
        back = out['monitored']['backward_launches']
        for name in ('fused_scale_bias_dot', 'fused_scale_bias_conv3x3',
                     'fused_bn_relu'):
            if not back.get(name):
                failures.append('monitor-fit: the backward did not launch %s'
                                % name)
        if taps != [len(taps) and taps[0], 0] * (MONITOR_STEPS // 2) or \
                not taps[0] or skipped != 1 or out['monitored']['graphs']:
            failures.append('monitor-fit: taps %s, capture_skipped %d, '
                            'graphs %s' % (taps, skipped,
                                           out['monitored']['graphs']))
        # the first monitored step on the card and on the CPU
        stepped = {}
        for ctx in (mx.gpu(0), mx.cpu()):
            m = mx.monitor.Monitor(2, pattern=MONITOR_PATTERN)
            pmod, _, prec = monitored_fit(mx, torch, symbol, arg, aux,
                                          images, labels, ctx, PARITY_ROWS,
                                          1, m)
            stepped[ctx.device_type] = (numpy_params(pmod), prec.seen[0])
            del pmod
        (card, ctaps), (host, htaps) = stepped['gpu'], stepped['cpu']
        if [n for _, n, _ in ctaps] != [n for _, n, _ in htaps]:
            failures.append('monitor-fit: tap names differ card/CPU')
        worst = 0.0
        for (_, name, cv), (_, _, hv) in zip(ctaps, htaps):
            a, b = np.array(cv.split(), np.float64), \
                np.array(hv.split(), np.float64)
            worst = max(worst, float(np.max(np.abs(a - b) / np.maximum(
                np.abs(b), 1e-12))))
        if worst > 1e-3:
            failures.append('monitor-fit: stats differ card/CPU by %g '
                            '(relative)' % worst)
        out['parity'] = {'rows': PARITY_ROWS, 'taps': len(ctaps),
                         'stats_max_rel_err': worst,
                         'stats_tolerance': 'rtol 1e-3 (one norm each)',
                         **parity_report(card, host),
                         'tolerance': 'rtol 1e-3, atol 1e-5 elementwise; '
                                      'at most 1e-4 of the elements outside '
                                      'it, none beyond 1e-3'}
        failure = beyond_bound('monitor-fit parity', out['parity'])
        if failure:
            failures.append(failure)
    finally:
        torch.backends.cudnn.deterministic = False
    return out, failures, launches


class knobs(object):
    """Environment knobs set for a block and restored after it."""

    def __init__(self, **env):
        self.env = {k: str(v) for k, v in env.items()}

    def __enter__(self):
        self.old = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return False


def obs_state(mod, torch):
    """Host copies of a module's parameters, aux and fused optimizer
    state (after a synchronise)."""
    torch.cuda.synchronize()
    args, auxs = mod.get_params()
    state = {}
    for k, v in mod._fused_opt_state.items():
        ts = [t for t in (v if isinstance(v, (list, tuple)) else [v])
              if t is not None]
        for i, t in enumerate(ts):
            state['%s.%d' % (k, i)] = t.detach().cpu().numpy()
    return ({k: v.asnumpy() for k, v in args.items()},
            {k: v.asnumpy() for k, v in auxs.items()}, state)


def obs_fit(mx, torch, symbol, arg, aux, images, labels, kernels,
            callbacks=(), epoch_end=None):
    """One observe-fit run: a Module bound, initialized from ``arg``/
    ``aux`` and given SGD before ``fit`` (so the fit's own wall time is
    the goodput ledger's), then ``fit`` over OBS_STEPS bf16 batches, a
    synchronise after each.  Returns the module (None when fit raised),
    the host seconds of each step, the fit's wall seconds, launches per
    step and the exception fit raised, if any."""
    times = []
    last = [time.perf_counter()]

    def tick(_):
        torch.cuda.synchronize()
        now = time.perf_counter()
        times.append(now - last[0])
        last[0] = time.perf_counter()

    it = mx.io.NDArrayIter(images, labels, batch_size=BATCH)
    mod = mx.mod.Module(symbol, context=mx.gpu(0),
                        compute_dtype=torch.bfloat16)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params={k: mx.nd.array(v) for k, v in arg.items()},
                    aux_params={k: mx.nd.array(v) for k, v in aux.items()})
    mod.init_optimizer(optimizer='sgd', optimizer_params=dict(SGD_MOMENTUM))
    counts0 = launch_counts(kernels)
    raised = None
    t0 = time.perf_counter()
    try:
        mod.fit(it, num_epoch=1, eval_metric=['acc', 'ce'],
                batch_end_callback=[tick] + list(callbacks),
                epoch_end_callback=epoch_end)
    except Exception as e:          # noqa: BLE001 - the caller checks it
        raised = e
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    per_step = launches_per_step(counts0, launch_counts(kernels),
                                 max(1, len(times)))
    return mod, times, wall, per_step, raised


def obs_median_ms(times):
    return statistics.median(times[TRAIN_WARMUP:]) * 1e3


def observe_fit(mx, torch, symbol, arg, aux, images, labels, kernels,
                expected, tmp):
    """observe-fit: the four training observability planes on the train
    phase's configuration (see the module docstring, 12g2).  Returns the
    report, the failures and the launches of #1, #2 and #4 in the
    phase."""
    from mxnet_tpu_torch import (chronicle, health, instrument, iowatch,
                                 perfwatch, resilience)
    images = images[:OBS_STEPS * BATCH].copy()
    labels = labels[:OBS_STEPS * BATCH]
    out, failures = {}, []
    counts_phase = launch_counts(kernels)
    want = {k: {'all': float(v)} for k, v in expected.items()}

    def per_kernel(per_step):
        return {k: per_step.get(k, {}).get('all') for k in expected}

    def check_launches(run, per_step):
        got = per_kernel(per_step)
        if got != {k: v['all'] for k, v in want.items()}:
            failures.append('observe-fit %s: launches per step %s, '
                            'expected %s' % (run, got, expected))
        return got

    def dispatch_device_ms():
        """The mean device ms of the run's replays: perf.phase.dispatch,
        each replay between two CUDA events on the stream (the
        histogram's p50 is a log-bucket estimate; the mean is exact)."""
        h = instrument.metrics_snapshot().get('histograms', {}).get(
            'perf.phase.dispatch', {})
        return h['sum'] / h['count'] * 1e3 if h.get('count') else None

    # -- sentinels off, warn, and the fault site: cuDNN deterministic, and
    # perfwatch on in each, so each run's replays are timed on the card ------
    deterministic(torch, True)
    runs = {}
    for run, env in (('off', {'MXTPU_HEALTH_SENTINELS': '0'}),
                     ('warn', {'MXTPU_HEALTH_SENTINELS': '1',
                               'MXTPU_HEALTH_ACTION': 'warn'})):
        fresh_memory(torch)
        instrument.reset_metrics()
        perfwatch.clear_executables()
        perfwatch.ledger_reset()
        h0 = instrument.counter_value('health.host_syncs')
        m0 = instrument.counter_value('metric.host_syncs')
        with knobs(MXTPU_PERFWATCH=1, **env):
            mod, times, wall, per_step, raised = obs_fit(
                mx, torch, symbol, arg, aux, images, labels, kernels)
        perfwatch.set_enabled(False)
        if raised is not None:
            raise raised
        runs[run] = {
            'step_ms': [t * 1e3 for t in times],
            'step_ms_median_after_warmup': obs_median_ms(times),
            'dispatch_device_ms_mean': dispatch_device_ms(),
            'launches_per_step': check_launches(run, per_step),
            'health_host_syncs':
                instrument.counter_value('health.host_syncs') - h0,
            'metric_host_syncs':
                instrument.counter_value('metric.host_syncs') - m0,
            'fit_s': wall, 'params': numpy_params(mod)}
        del mod
    off, warn = runs['off'], runs['warn']
    same = all(np.array_equal(warn['params'][k], v)
               for k, v in off['params'].items())
    if not same:
        failures.append('observe-fit: parameters differ between sentinels '
                        'off and warn')
    if warn['health_host_syncs'] != 0:
        failures.append('observe-fit: health.host_syncs %d under warn'
                        % warn['health_host_syncs'])
    if warn['metric_host_syncs'] != off['metric_host_syncs']:
        failures.append('observe-fit: metric.host_syncs %d under warn, %d '
                        'off' % (warn['metric_host_syncs'],
                                 off['metric_host_syncs']))
    for r in runs.values():
        r.pop('params')
    dev_cost = (warn['dispatch_device_ms_mean']
                - off['dispatch_device_ms_mean']
                if off['dispatch_device_ms_mean'] is not None and
                warn['dispatch_device_ms_mean'] is not None else None)
    # the sentinels' cost is reported, not held to a bound: the device
    # ms of a replay is the measure, the host-synchronised step's median
    # is shown beside it
    out['sentinels'] = {'off': off, 'warn': warn,
                        'params_bitwise_equal': same,
                        'warn_cost_device_ms': dev_cost,
                        'warn_cost_step_ms':
                            warn['step_ms_median_after_warmup']
                            - off['step_ms_median_after_warmup']}

    fresh_memory(torch)
    resilience.set_faults(OBS_FAULT)
    try:
        with knobs(MXTPU_PERFWATCH=1):
            _, times, _, per_step, raised = obs_fit(
                mx, torch, symbol, arg, aux, images, labels, kernels)
    finally:
        perfwatch.set_enabled(False)
        resilience.clear_faults()
    if raised is not None:
        raise raised
    grown = obs_median_ms(times) - off['step_ms_median_after_warmup']
    if not OBS_FAULT_MS[0] <= grown <= OBS_FAULT_MS[1]:
        failures.append('observe-fit: the fit.step delay grew the median '
                        'step by %.2f ms, not %s' % (grown, OBS_FAULT_MS))
    out['fault'] = {'plan': OBS_FAULT, 'step_ms': [t * 1e3 for t in times],
                    'step_ms_median_after_warmup': obs_median_ms(times),
                    'growth_ms': grown, 'expected_ms': list(OBS_FAULT_MS),
                    'launches_per_step': per_kernel(per_step)}

    # -- skip_update and abort on a NaN pixel in batch OBS_BAD --------------
    bad = images.copy()
    bad[OBS_BAD * BATCH + 1, 1, IMAGE[1] // 2, IMAGE[2] // 3] = np.nan
    fresh_memory(torch)
    snaps, values = {}, []

    def snap(param):
        if param.nbatch in (OBS_BAD - 1, OBS_BAD):
            snaps[param.nbatch] = obs_state(param.locals['self'], torch)
    with knobs(MXTPU_HEALTH_SENTINELS=1, MXTPU_HEALTH_ACTION='skip_update'):
        mod, times, _, per_step, raised = obs_fit(
            mx, torch, symbol, arg, aux, bad, labels, kernels,
            callbacks=[snap],
            epoch_end=lambda *a: values.append(health.last_values()))
    if raised is not None:
        raise raised
    restored = {}
    for part, before, after in zip(('params', 'aux', 'optimizer_state'),
                                   snaps[OBS_BAD - 1], snaps[OBS_BAD]):
        restored[part] = all(np.array_equal(after[k], v)
                             for k, v in before.items())
    final = obs_state(mod, torch)
    finite = all(np.all(np.isfinite(v)) for part in final
                 for v in part.values())
    del mod, snaps, final
    vals = values[0] if values else {}
    if not all(restored.values()) or not finite or \
            (vals.get('nan_steps'), vals.get('first_bad_step'),
             vals.get('last_bad_step')) != (1, OBS_BAD, OBS_BAD):
        failures.append('observe-fit skip_update: restored %s, finite %s, '
                        'health %s' % (restored, finite, vals))
    out['skip_update'] = {'bad_batch': OBS_BAD, 'health': vals,
                          'bitwise_restored': restored,
                          'finite_after': finite,
                          'step_ms_median_after_warmup':
                              obs_median_ms(times),
                          'launches_per_step': per_kernel(per_step)}

    fresh_memory(torch)
    rec_dir = os.path.join(tmp, 'flightrec')
    health.install_flight_recorder(rec_dir)
    try:
        with knobs(MXTPU_HEALTH_SENTINELS=1, MXTPU_HEALTH_ACTION='abort'):
            _, times, _, _, raised = obs_fit(
                mx, torch, symbol, arg, aux, bad, labels, kernels,
                callbacks=[mx.callback.Speedometer(BATCH, 1)])
    finally:
        health._recorder = None
        instrument.set_profiling(False)
    record = {}
    path = os.path.join(rec_dir, 'flightrec-rank0.json')
    if os.path.exists(path):
        with open(path) as f:
            record = json.load(f)
    got = (getattr(raised, 'first_bad_step', None),
           getattr(raised, 'last_bad_step', None),
           getattr(raised, 'nan_steps', None))
    if not isinstance(raised, health.TrainingDivergedError) or \
            got != (OBS_BAD, OBS_BAD, 1) or \
            record.get('reason') != 'diverged' or \
            (record.get('health') or {}).get('nan_steps') != 1:
        failures.append('observe-fit abort: raised %r, range %s, flight '
                        'record %s' % (raised, got, {
                            k: record.get(k) for k in ('reason', 'health')}))
    out['abort'] = {'raised': type(raised).__name__, 'range': list(got),
                    'message': str(raised), 'steps_run': len(times),
                    'flight_record': {'reason': record.get('reason'),
                                      'health': record.get('health')}}

    # -- the planes: three of them, then all four (the chronicle's sampler
    # thread too); the same cuDNN settings as the runs above ------------------
    planes = dict(MXTPU_HEALTH_SENTINELS=1, MXTPU_HEALTH_ACTION='warn',
                  MXTPU_PERFWATCH=1, MXTPU_IOWATCH=1)
    fresh_memory(torch)
    with knobs(**planes):
        _, times, _, per_step, raised = obs_fit(
            mx, torch, symbol, arg, aux, images, labels, kernels)
    if raised is not None:
        raise raised
    check_launches('three planes', per_step)
    out['three_planes'] = {'step_ms': [t * 1e3 for t in times],
                           'step_ms_median_after_warmup':
                               obs_median_ms(times)}
    fresh_memory(torch)
    jdir = os.path.join(tmp, 'chronicle')
    instrument.reset_metrics()
    perfwatch.clear_executables()
    perfwatch.ledger_reset()
    with knobs(MXTPU_CHRONICLE=jdir,
               MXTPU_CHRONICLE_EVERY_MS=OBS_CHRONICLE_MS, **planes):
        mod, times, wall, per_step, raised = obs_fit(
            mx, torch, symbol, arg, aux, images, labels, kernels)
        chronicle.stop()
    perfwatch.set_enabled(False)
    iowatch.set_enabled(False)
    deterministic(torch, False)
    if raised is not None:
        raise raised
    check_launches('four planes', per_step)
    snap_ = instrument.metrics_snapshot()
    rows = [r for r in perfwatch.executables() if r['kind'] == 'fit_step']
    analytic = perfwatch.analytic_step_flops(
        symbol, {'data': (BATCH,) + IMAGE, 'softmax_label': (BATCH,)})
    flops = rows[0]['flops'] if rows else 0
    if len(rows) != 1 or flops != analytic:
        failures.append('observe-fit perfwatch: step FLOPs %s, analytic %d'
                        % ([r['flops'] for r in rows], analytic))
    step_ms = obs_median_ms(times)
    hists = snap_.get('histograms', {})
    phases = {k: {q: hists[k].get(q) for q in ('count', 'sum', 'p50',
                                                'p99')}
              for k in hists if k.startswith('perf.phase.')}
    dispatch = phases.get('perf.phase.dispatch', {})
    # the replays' device seconds, each between two events on the stream
    # (the histogram's p50 is a log-bucket estimate; the mean is exact)
    device_s = dispatch['sum'] / dispatch['count'] \
        if dispatch.get('count') else None
    peak = perfwatch.peak_flops(torch.device('cuda', 0))
    out['perfwatch'] = {
        'flops_per_step': flops, 'analytic_flops_per_step': analytic,
        'aten_flops': rows[0]['aten_flops'] if rows else None,
        'kernel_flops': rows[0]['kernel_flops'] if rows else None,
        'peak_flops': peak,
        'mfu_at_step_ms': flops / (step_ms / 1e3) / peak,
        'dispatch_device_ms_mean': device_s * 1e3 if device_s else None,
        'mfu_at_dispatch_device_ms': (flops / device_s / peak
                                      if device_s else None),
        'perf_mfu_gauge': snap_['gauges'].get('perf.mfu'),
        'steps_per_sec_gauge': snap_['gauges'].get('perf.steps_per_sec'),
        'step_ms_median_after_warmup': step_ms,
        'phases': phases,
        'graph_pool_bytes': rows[0]['pool_bytes'] if rows else None,
        'ledger_top': perfwatch.ledger_top(5),
        'device_memory': perfwatch.ledger_stats()['device'],
        'launches_per_step': per_kernel(per_step)}
    # the ledger defines productive time as its wall less the buckets, so
    # productive + buckets equals the ledger's wall by construction; what
    # can fail is that sum against the fit's own wall, timed here
    gp = iowatch.goodput_snapshot()
    total = gp.get('productive_secs', 0.0) + sum(gp.get('buckets',
                                                       {}).values())
    ledger_wall = gp.get('wall_secs', 0.0)
    if not ledger_wall or abs(total - wall) > 0.02 * wall:
        failures.append('observe-fit iowatch: buckets sum %.4f s, fit wall '
                        '%.4f s' % (total, wall))
    out['iowatch'] = {'fit_wall_s': wall, 'ledger_wall_s': ledger_wall,
                      'sum_s': total, 'sum_less_fit_wall_s': total - wall,
                      'fraction': gp.get('fraction'),
                      'productive_s': gp.get('productive_secs'),
                      'buckets_s': gp.get('buckets'),
                      'events': gp.get('events')}
    samples, verdicts = 0, []
    for name in sorted(os.listdir(jdir)) if os.path.isdir(jdir) else []:
        if name.startswith('journal-'):
            with open(os.path.join(jdir, name)) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if rec.get('kind') == 'sample':
                        samples += 1
                    elif rec.get('kind') == 'decision' and \
                            rec['ev'].get('subsystem') == 'chronicle':
                        verdicts.append((rec['ev'].get('action'),
                                         rec['ev'].get('series')))
    if not samples:
        failures.append('observe-fit chronicle: the journal holds no '
                        'sample')
    out['chronicle'] = {'every_ms': OBS_CHRONICLE_MS, 'samples': samples,
                        'detector_verdicts': verdicts,
                        'detectors': sorted(chronicle.default_detectors())}
    del mod
    launches = {k: n - counts_phase[k][0]
                for k, (n, _) in launch_counts(kernels).items()}
    return out, failures, launches


def write_idx(path, array):
    """An idx file: two zero bytes, the type 0x08 (uint8), the number of
    dims, each dim big-endian, then the bytes."""
    import struct
    with open(path, 'wb') as f:
        f.write(struct.pack('>HBB', 0, 0x08, array.ndim))
        f.write(struct.pack('>%dI' % array.ndim, *array.shape))
        f.write(np.ascontiguousarray(array, dtype=np.uint8).tobytes())


class _TimedIter(object):
    """Seconds the consumer waited in ``next()`` of the wrapped
    iterator."""

    def __init__(self, it):
        self.it, self.wait_s = it, 0.0
        self.provide_data, self.provide_label = it.provide_data, \
            it.provide_label
        self.batch_size = it.batch_size

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        try:
            return self.it.next()
        finally:
            self.wait_s += time.perf_counter() - t0

    next = __next__

    def reset(self):
        self.it.reset()


def epoch_report(mx, torch, symbol, arg, make_iter, feed, rows):
    """One epoch of Module.fit (float32, SGD with momentum) over
    ``make_iter()``: images/s and the share of the epoch the consumer
    waited on the iterator."""
    os.environ['MXTPU_DEVICE_FEED'] = '1' if feed else '0'
    it = _TimedIter(make_iter())
    try:
        mod = mx.mod.Module(symbol, context=mx.gpu(0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod.fit(it, num_epoch=1, optimizer='sgd',
                optimizer_params=dict(SGD_MOMENTUM),
                arg_params={k: mx.nd.array(v) for k, v in arg.items()})
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
    finally:
        os.environ.pop('MXTPU_DEVICE_FEED', None)
        close = getattr(it.it, 'close', None)
        if close is not None:
            close()
    params = numpy_params(mod)
    moved = max(float(np.max(np.abs(params[k] - v))) for k, v in arg.items())
    if not all(np.all(np.isfinite(v)) for v in params.values()) or \
            moved <= 0.0:
        raise AssertionError('%s: parameters not finite or not moved'
                             % symbol.name)
    return {'epoch_s': epoch_s, 'images_per_s': rows / epoch_s,
            'iterator_wait_s': it.wait_s,
            'host_share': it.wait_s / epoch_s, 'device_feed': feed}


def mnist_lenet(mx, torch, models, convert, tmp):
    """mnist-lenet: MNISTIter over idx files written here (MNIST_IMAGES
    seeded 28x28 images, labels 0-9), LeNet one epoch at batch 128 (SGD),
    over MNISTIter and over PrefetchingIter(MNISTIter) with the device
    feed off, and over MNISTIter with the fit loop's feed on; then
    CSVIter over a CSV_ROWS x 784 CSV into the MLP, one epoch."""
    rng = np.random.default_rng(SEED + 7)
    images = rng.integers(0, 256, (MNIST_IMAGES, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, MNIST_IMAGES, dtype=np.uint8)
    img, lab = os.path.join(tmp, 'images-idx3-ubyte'), \
        os.path.join(tmp, 'labels-idx1-ubyte')
    t0 = time.perf_counter()
    write_idx(img, images)
    write_idx(lab, labels)
    write_s = time.perf_counter() - t0
    lenet = models.get_symbol('lenet', num_classes=10)
    arg, _ = convert.random_params(lenet, {'data': (MNIST_BATCH, 1, 28, 28)},
                                   SEED)

    def mnist():
        return mx.io.MNISTIter(image=img, label=lab, batch_size=MNIST_BATCH,
                               shuffle=True, seed=SEED)
    t0 = time.perf_counter()
    first = mnist()
    load_s = time.perf_counter() - t0
    b = first.next()
    if b.data[0].shape != (MNIST_BATCH, 1, 28, 28) or \
            float(b.data[0].asnumpy().max()) > 1.0:
        raise AssertionError('mnist-lenet: bad MNISTIter batch')
    # a short untimed fit first: the first fit of the process builds what
    # every later one reuses
    epoch_report(mx, torch, lenet, arg,
                 lambda: mx.io.ResizeIter(mnist(), 8), False, 8 * MNIST_BATCH)
    runs = {
        'mnist_iter': epoch_report(mx, torch, lenet, arg, mnist, False,
                                   MNIST_IMAGES),
        'prefetching_iter': epoch_report(
            mx, torch, lenet, arg,
            lambda: mx.io.PrefetchingIter(mnist()), False, MNIST_IMAGES),
        'mnist_iter_device_feed': epoch_report(mx, torch, lenet, arg, mnist,
                                               True, MNIST_IMAGES)}
    # CSVIter into the MLP
    csv_data = os.path.join(tmp, 'data.csv')
    csv_label = os.path.join(tmp, 'label.csv')
    t0 = time.perf_counter()
    flat = images[:CSV_ROWS].reshape(CSV_ROWS, 784)
    with open(csv_data, 'w') as f:
        f.write('\n'.join(','.join(map(str, r)) for r in flat.tolist()))
    np.savetxt(csv_label, labels[:CSV_ROWS], fmt='%d')
    csv_write_s = time.perf_counter() - t0
    mlp = models.get_symbol('mlp', num_classes=10)
    marg, _ = convert.random_params(mlp, {'data': (MNIST_BATCH, 784)}, SEED)
    t0 = time.perf_counter()
    csv_iter = mx.io.CSVIter(data_csv=csv_data, data_shape=(784,),
                             label_csv=csv_label, batch_size=MNIST_BATCH)
    csv_load_s = time.perf_counter() - t0
    csv_run = epoch_report(mx, torch, mlp, marg, lambda: csv_iter, False,
                           CSV_ROWS)
    csv_run['load_s'] = csv_load_s
    csv_run['write_s'] = csv_write_s
    return {'images': MNIST_IMAGES, 'batch': MNIST_BATCH, 'model': 'lenet',
            'idx_write_s': write_s, 'mnist_load_s': load_s, **runs,
            'prefetching_moves_host_share_by':
                runs['mnist_iter']['host_share']
                - runs['prefetching_iter']['host_share'],
            'csv': {'rows': CSV_ROWS, 'columns': 784, 'model': 'mlp',
                    **csv_run}}


def alexnet_train(mx, torch, models, convert, flush):
    """alexnet-train: AlexNet (1000 classes, 3x224x224, 32 rows) through
    Module.fit, float32 (TF32 off) and bfloat16, ALEXNET_STEPS captured
    steps each; and the LRN's forward + backward at its two path shapes,
    timed alone with CUDA events, against the step."""
    from mxnet_tpu_torch.ops import get_op
    symbol = models.get_symbol('alexnet', num_classes=1000)
    arg, aux = convert.random_params(symbol, {'data': (BATCH,) + IMAGE},
                                     SEED)
    rng = np.random.default_rng(SEED + 5)
    images = rng.standard_normal((ALEXNET_STEPS * BATCH,) + IMAGE,
                                 dtype=np.float32)
    labels = rng.integers(0, 1000, ALEXNET_STEPS * BATCH).astype(np.float32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for dtype in (None, torch.bfloat16):
        fresh_memory(torch)
        mod, step_s = train_module(mx, torch, symbol, arg, aux, images,
                                   labels, mx.gpu(0), dtype, BATCH)
        metric = dict(mod._fused_metric.get_name_value())
        params = numpy_params(mod)
        moved = max(float(np.max(np.abs(params[k] - v)))
                    for k, v in arg.items())
        if not np.isfinite(metric['cross-entropy']) or moved <= 0.0 or \
                not all(np.all(np.isfinite(v)) for v in params.values()):
            raise AssertionError('alexnet-train: loss %s, max |dw| %g'
                                 % (metric['cross-entropy'], moved))
        graphs = graph_report(mod._graphs.values())
        if not all(g['captured'] for g in graphs):
            raise AssertionError('alexnet-train: not captured: %s' % graphs)
        out['float32' if dtype is None else 'bfloat16'] = {
            'step_ms': [t * 1e3 for t in step_s],
            'step_ms_median_after_first':
                statistics.median(step_s[1:]) * 1e3,
            'images_per_s': BATCH / statistics.median(step_s[1:]),
            'cross_entropy': metric['cross-entropy'],
            'graphs': graphs, **memory(torch)}
        del mod
    lrn = get_op('LRN')
    attrs = lrn.canon_attrs({'alpha': 0.0001, 'beta': 0.75, 'knorm': 2,
                             'nsize': 5})
    internals = symbol.get_internals()
    _, shapes, _ = internals.infer_shape(data=(BATCH,) + IMAGE)
    shape_of = dict(zip(internals.list_outputs(), shapes))
    lrn_ms = {}
    for node in symbol.topo_nodes():
        if node.op == 'LRN':
            src, idx = node.inputs[0]
            shape = tuple(shape_of[src.output_names()[idx]])
            x = torch.randn(shape, device='cuda').relu_().requires_grad_()
            g = torch.randn(shape, device='cuda')

            def fwd_bwd(x=x, g=g):
                y = lrn.apply(attrs, [x], True, None)[0]
                torch.autograd.grad(y, x, g)
            lrn_ms[node.name] = {'shape': list(shape),
                                 'fwd_bwd_ms': cuda_ms(torch, fwd_bwd, flush,
                                                       reps=10, warmup=3)}
    total = sum(v['fwd_bwd_ms'] for v in lrn_ms.values())
    out['lrn'] = {'nodes': lrn_ms, 'fwd_bwd_ms': total,
                  'share_of_f32_step': total
                  / out['float32']['step_ms_median_after_first']}
    torch.backends.cudnn.allow_tf32 = True
    return out


def _op_run(torch, op, attrs, inputs, diff, dev, cots=None):
    """``op`` forward (and backward) on ``dev``; without ``cots`` the
    cotangents are drawn from a seeded generator at the outputs' shapes.
    Returns the outputs, the gradients, the cotangents and the
    arguments on the device."""
    args = [torch.from_numpy(a).to(dev) for a in inputs]
    for i in diff:
        args[i].requires_grad_(True)
    outs = op.apply(attrs, args, True, None)[0]
    if cots is None:
        cot_rng = np.random.default_rng(SEED + 11)
        cots = [cot_rng.standard_normal(tuple(o.shape)).astype(np.float32)
                for o in outs]
    if diff:
        torch.autograd.backward(outs, [torch.from_numpy(c).to(dev)
                                       for c in cots])
    return ([o.detach().cpu().numpy() for o in outs],
            [args[i].grad.cpu().numpy() for i in diff], cots, args)


def op_cpu_half(torch, spec):
    """The CPU half of an op case ``spec`` (name, attrs, inputs, diff,
    exact): its outputs, gradients and cotangents."""
    from mxnet_tpu_torch.ops import get_op
    name, attrs, inputs, diff, _ = spec
    op = get_op(name)
    outs, grads, cots, _ = _op_run(torch, op, op.canon_attrs(attrs), inputs,
                                   diff, torch.device('cpu'))
    return outs, grads, cots


def _op_case(torch, phase, spec, host, flush):
    """One op ``spec`` forward and backward on the card against its CPU
    half ``host`` (f32, TF32 off): max abs error of the outputs and the
    gradients against ``rtol * max|CPU value|`` (exact when the spec
    says so), and the card's forward + backward ms.  With no ``diff``
    (an op without a gradient) the forward alone."""
    from mxnet_tpu_torch.ops import get_op
    name, attrs, inputs, diff, exact = spec
    op = get_op(name)
    attrs = op.canon_attrs(attrs)
    host_outs, host_grads, cots = host
    card_outs, card_grads, _, args = _op_run(
        torch, op, attrs, inputs, diff, torch.device('cuda', 0), cots)
    rtol = 0.0 if exact else 1e-4
    err, bound = 0.0, 0.0
    worst_rel = 0.0
    for got, want in zip(card_outs + card_grads, host_outs + host_grads):
        if got.shape != want.shape:
            raise AssertionError('%s %s: shape %s against %s'
                                 % (phase, name, got.shape, want.shape))
        e = float(np.max(np.abs(got - want)))
        b = rtol * float(np.max(np.abs(want)))
        err, bound = max(err, e), max(bound, b)
        if e > b:
            worst_rel = max(worst_rel, e / max(b, 1e-30))
    cots_dev = [torch.from_numpy(c).to('cuda') for c in cots]

    def fwd_bwd():
        xs = [a.detach().requires_grad_(a.requires_grad) for a in args]
        ys = op.apply(attrs, xs, True, None)[0]
        if diff:
            torch.autograd.backward(ys, cots_dev)
    ms = cuda_ms(torch, fwd_bwd, flush, reps=10, warmup=3)
    return {'op': name, 'shapes': [list(a.shape) for a in inputs],
            'max_abs_err': err, 'bound': bound,
            'tolerance': 'exact' if exact else
            'rtol 1e-4 of the largest |CPU value| per tensor',
            'ms_fwd_bwd' if diff else 'ms_fwd': ms,
            'within': worst_rel == 0.0}


_OP_CASES = {}      # phase -> (specs, their CPU halves)


def op_cpu_halves(torch):
    """nn-ops' and tail-ops' specs and their CPU halves, made once: main
    makes them while the capture child runs (torch on all but two of
    the host's threads, which the child keeps)."""
    if _OP_CASES:
        return _OP_CASES
    threads = torch.get_num_threads()
    torch.set_num_threads(max(threads - 2, 1))
    try:
        for phase, specs in (('nn-ops', nn_op_specs()),
                             ('tail-ops', tail_op_specs(torch))):
            _OP_CASES[phase] = (specs, [op_cpu_half(torch, spec)
                                        for spec in specs])
    finally:
        torch.set_num_threads(threads)
    return _OP_CASES


def run_op_cases(torch, phase, flush):
    """``phase``'s op cases on the card against their CPU halves; the
    cases and the failures."""
    specs, hosts = op_cpu_halves(torch)[phase]
    cases = [_op_case(torch, phase, spec, host, flush)
             for spec, host in zip(specs, hosts)]
    failures = ['%s %s %s: max abs err %g beyond %g'
                % (phase, c['op'], c['shapes'], c['max_abs_err'], c['bound'])
                for c in cases if not c['within']]
    return cases, failures


def nn_op_specs():
    """nn-ops: Deconvolution, Crop, UpSampling, LRN, L2Normalization,
    CuDNNBatchNorm, the Sequence ops, the regression outputs, SVMOutput
    and softmax_cross_entropy, forward and backward on the card against
    the same call on the CPU, at a real user's shapes: the specs (name,
    attrs, inputs, diff, exact)."""
    rng = np.random.default_rng(SEED + 9)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    specs = []

    def case(name, attrs, inputs, diff, exact=False):
        specs.append((name, attrs, inputs, diff, exact))

    # DCGAN's generator (examples/train_dcgan.py) at the upstream widths:
    # nz 100, ngf 64, 4x4 kernels, 4 -> 64 pixels, batch 64
    dcgan = [((64, 100, 1, 1), 512, (1, 1), (0, 0)),
             ((64, 512, 4, 4), 256, (2, 2), (1, 1)),
             ((64, 256, 8, 8), 128, (2, 2), (1, 1)),
             ((64, 128, 16, 16), 64, (2, 2), (1, 1)),
             ((64, 64, 32, 32), 3, (2, 2), (1, 1))]
    for shape, nf, stride, pad in dcgan:
        case('Deconvolution', {
            'kernel': (4, 4), 'stride': stride, 'pad': pad,
            'num_filter': nf, 'no_bias': True},
            [n(*shape), n(shape[1], nf, 4, 4, scale=0.05)], (0, 1))
    # examples/fcn_xs.py's 2x upsampling and its Crop, VOC's 21 classes
    case('Deconvolution', {
        'kernel': (4, 4), 'stride': (2, 2), 'pad': (1, 1), 'num_filter': 21,
        'no_bias': True}, [n(8, 21, 125, 125), n(21, 21, 4, 4, scale=0.1)],
        (0, 1))
    case('Crop', {'num_args': 2}, [n(8, 21, 250, 250), n(8, 21, 248, 248)],
         (0,), exact=True)
    for sample in ('nearest', 'bilinear'):
        # nearest's forward copies; its backward sums 4 values a pixel
        # (8 rows: the CPU's side takes seconds at 32)
        case('UpSampling', {
            'scale': 2, 'sample_type': sample, 'num_filter': 256},
            [n(8, 256, 56, 56)], (0,))
    case('LRN', {'nsize': 5, 'alpha': 1e-4, 'beta': 0.75, 'knorm': 2.0},
         [np.abs(n(32, 96, 55, 55, scale=4.0))], (0,))
    case('L2Normalization', {'mode': 'channel'}, [n(32, 512, 38, 38)],
         (0,))
    case('CuDNNBatchNorm', {'fix_gamma': False},
         [n(32, 64, 56, 56), n(64), n(64), n(64), np.abs(n(64)) + 0.5],
         (0, 1, 2))
    lengths = rng.integers(1, 513, 16).astype(np.float32)
    for name, attrs in (('SequenceLast', {}), ('SequenceMask',
                                               {'value': -1.0}),
                        ('SequenceReverse', {})):
        case(name, dict(attrs, use_sequence_length=True),
             [n(512, 16, 512), lengths], (0,), exact=True)
    label = rng.integers(0, 1000, 32).astype(np.float32)
    for name in ('LinearRegressionOutput', 'MAERegressionOutput',
                 'LogisticRegressionOutput'):
        case(name, {}, [n(32, 1000), n(32, 1000)], (0,))
    case('SVMOutput', {}, [n(32, 1000), label], (0,))
    # the LM's head at 4 x 512 tokens (at 16 x 512 the CPU's side and
    # the draws take ~10 s), drawn in float32
    case('softmax_cross_entropy', {},
         [rng.standard_normal((2048, 32000), dtype=np.float32),
          rng.integers(0, 32000, 2048).astype(np.float32)], (0,))
    return specs


# ---------------------------------------------------------------------------
# The three BASELINE configurations of the JAX package that the port could
# not run before: the PTB LSTM (RNN op, cells, BucketingModule), SSD (the
# MultiBox ops and the multibox_nms kernel, predictor.load and reshape) and
# the zoo (Inception-v3 and VGG-16 training and inference, four more
# served classifiers); kernels #2, #3, #4 at the shapes these graphs give
# them; the last 12 ops on the card against the CPU
# ---------------------------------------------------------------------------

LSTM_PTB = dict(vocab_size=10000, num_embed=200, num_hidden=200,
                num_layers=2)
LSTM_T, LSTM_ROWS = 35, 32
LSTM_WARMUP, LSTM_STEPS = 2, 20        # the bench leg's 20 timed steps
LSTM_BUCKETS = (10, 20, 30, 40, 50, 60)    # example/rnn/lstm_bucketing.py
LSTM_PER_BUCKET = 96                   # 3 batches of 32 per bucket
LSTM_OPT = {'learning_rate': 0.1, 'momentum': 0.9}
SSD_CLASSES, SSD_ROWS, SSD_IMAGE = 20, 8, (3, 300, 300)
SSD_ANCHORS = 7308                     # tests/test_ssd.py:3
SSD_FORWARDS = 10
SSD_TRAIN_STEPS = 4
SSD_OPT = {'learning_rate': 0.004, 'momentum': 0.9, 'wd': 5e-4}
SSD_VARIANCES = (0.1, 0.1, 0.2, 0.2)
NMS_KERNELS = ('nms_masks', 'nms_scan')   # csrc/multibox_nms.cu
NMS_OPS_PER_PAIR = 16   # 2 max, 2 min, 4 sub, 2 clamp, 3 mul, add, div, cmp
DETECTION_INPUTS = ('cls_prob_output', 'multibox_loc_pred_output',
                    'multibox_anchors_output')
INCEPTION_IMAGE = (3, 299, 299)
ZOO_STEPS = 4                          # captured Module.fit steps
ZOO_OPT = {'learning_rate': 0.01, 'momentum': 0.9, 'wd': 1e-4}
ZOO_EVALS = 5                          # make_eval_step forwards
ZOO_SERVE_ROWS = 8
# googlenet at 256: the reference's graph ends in a 0 x 0 pool at 224
ZOO_SERVE = (('inception-bn', (3, 224, 224)), ('googlenet', (3, 256, 256)),
             ('resnext-50', (3, 224, 224)),
             ('inception-resnet-v2', (3, 299, 299)))


def deterministic(torch, on):
    """cuDNN's deterministic algorithms (captured against eager must be
    bit for bit) with TF32 off, or back to the defaults."""
    torch.backends.cudnn.deterministic = on
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = not on
    torch.backends.cuda.matmul.allow_tf32 = False


def lstm_bench_draws(symbol):
    """The LSTM bench leg's draws (bench.py:914-955): N(0, 0.05²) for every
    parameter from RandomState(0) in list_arguments order, then the token
    ids and labels of its one batch."""
    dshape = (LSTM_ROWS, LSTM_T)
    arg_shapes, _, _ = symbol.infer_shape(data=dshape, softmax_label=dshape)
    rng = np.random.RandomState(0)
    params = {n: rng.normal(0, 0.05, size=s).astype(np.float32)
              for n, s in zip(symbol.list_arguments(), arg_shapes)
              if n not in ('data', 'softmax_label')}
    v = LSTM_PTB['vocab_size']
    batch = {'data': rng.randint(0, v, dshape).astype(np.float32),
             'softmax_label': rng.randint(0, v, dshape).astype(np.float32)}
    return params, batch


def lstm_steps(mx, torch, ts, symbol, params, batch, steps, naive=False,
               rows=LSTM_ROWS, dev='cuda', snap_at=None):
    """``steps`` make_train_step steps (SGD lr 0.1 momentum 0.9, f32) from
    ``params`` on one batch, as the bench leg runs them: the parameters
    after, each step's host ms (ending in a synchronise), the parameters
    after ``snap_at`` steps, the last step's cross-entropy and the graphs."""
    set_engine(mx, naive)
    try:
        p = {k: torch.from_numpy(v.copy()).to(dev) for k, v in params.items()}
        b = {k: torch.from_numpy(v[:rows]).to(dev) for k, v in batch.items()}
        step = ts.make_train_step(
            symbol, ts.make_sgd_momentum(lr=0.1, momentum=0.9, wd=0.0,
                                         rescale_grad=1.0 / rows),
            ('data', 'softmax_label'))
        state = ts.sgd_momentum_init(p)
        times, snap = [], None
        for i in range(steps):
            t0 = time.perf_counter()
            outs, p, _, state = step(p, {}, state, b)
            if dev == 'cuda':
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if i + 1 == snap_at:
                snap = {k: v.cpu().numpy().copy() for k, v in p.items()}
        ce = cross_entropy(torch, outs[0], b['softmax_label'])
        return ({k: v.cpu().numpy() for k, v in p.items()}, times, snap, ce,
                graph_report(c for c, _ in step.graphs.values()))
    finally:
        set_engine(mx, False)


def lstm_corpus(seed):
    """Random sentences of token ids, LSTM_PER_BUCKET in each bucket's
    length range (1-10, 11-20, ..., 51-60), shuffled."""
    rng = np.random.RandomState(seed)
    sentences, low = [], 1
    for b in LSTM_BUCKETS:
        for n in rng.randint(low, b + 1, LSTM_PER_BUCKET):
            sentences.append(list(rng.randint(1, LSTM_PTB['vocab_size'],
                                              n)))
        low = b + 1
    rng.shuffle(sentences)
    return sentences


def lstm_bucket_fit(mx, torch, models, params, sentences, naive):
    """``BucketingModule(lstm_lm.sym_gen_bucketing(...)).fit`` on the card
    over a BucketSentenceIter of ``sentences`` (the example's buckets,
    padding -1), one epoch, SGD lr 0.1 momentum 0.9, f32: the module, its
    timed steps and the fit's wall seconds."""
    import contextlib
    import random
    set_engine(mx, naive)
    try:
        mod = mx.mod.BucketingModule(
            models.lstm_lm.sym_gen_bucketing(**LSTM_PTB),
            default_bucket_key=max(LSTM_BUCKETS), context=mx.gpu(0))
        random.seed(SEED)
        np.random.seed(SEED)
        with contextlib.redirect_stdout(sys.stderr):
            it = mx.rnn.BucketSentenceIter(sentences, LSTM_ROWS,
                                           buckets=list(LSTM_BUCKETS))
        steps = timed_steps(torch, mod, ())
        t0 = time.monotonic()
        mod.fit(it, num_epoch=1, eval_metric='acc', optimizer='sgd',
                optimizer_params=dict(LSTM_OPT),
                arg_params={k: mx.nd.array(v) for k, v in params.items()})
        torch.cuda.synchronize()
        return mod, steps, time.monotonic() - t0
    finally:
        set_engine(mx, False)


def lstm_ptb(mx, torch, models, ts):
    """lstm-ptb: the PTB LSTM (BASELINE config 4) through make_train_step
    (the bench leg) captured and eager, one f32 step against the CPU, and
    BucketingModule.fit over the example's buckets captured and eager."""
    deterministic(torch, True)
    symbol = models.get_symbol('lstm_lm', seq_len=LSTM_T, **LSTM_PTB)
    params, batch = lstm_bench_draws(symbol)
    fresh_memory(torch)
    total = LSTM_WARMUP + LSTM_STEPS
    cap, cap_s, cap_snap, ce, graphs = lstm_steps(
        mx, torch, ts, symbol, params, batch, total, snap_at=EAGER_STEPS)
    cap_mem = memory(torch)
    fresh_memory(torch)
    eager, eager_s, _, _, egraphs = lstm_steps(
        mx, torch, ts, symbol, params, batch, EAGER_STEPS, naive=True)
    step_ms = statistics.median(cap_s[LSTM_WARMUP:]) * 1e3
    for k, v in cap.items():
        if not np.all(np.isfinite(v)):
            raise AssertionError('lstm-ptb: parameter %s not finite' % k)
    if not np.isfinite(ce) or not all(g['captured'] for g in graphs):
        raise AssertionError('lstm-ptb: cross-entropy %s, graphs %s'
                             % (ce, graphs))
    parity = compare_params('lstm-ptb, captured against eager', cap_snap,
                            eager)
    # one f32 step at 2 rows on the card and on the CPU
    card, _, _, _, _ = lstm_steps(mx, torch, ts, symbol, params, batch, 1,
                                  rows=PARITY_ROWS)
    host, _, _, _, _ = lstm_steps(mx, torch, ts, symbol, params, batch, 1,
                                  rows=PARITY_ROWS, dev='cpu')
    cpu_parity = compare_params('lstm-ptb, card against the CPU', card, host)
    train = {'model': 'lstm_lm', **LSTM_PTB, 'seq_len': LSTM_T,
             'rows': LSTM_ROWS, 'dtype': 'float32',
             'optimizer': 'sgd lr 0.1 momentum 0.9',
             'step_ms': [t * 1e3 for t in cap_s],
             'step_ms_median_after_warmup': step_ms,
             'words_per_s': LSTM_ROWS * LSTM_T / step_ms * 1e3,
             'eager_step_ms': [t * 1e3 for t in eager_s],
             'eager_step_ms_median': statistics.median(eager_s) * 1e3,
             'cross_entropy_last': ce, 'ln_vocab': float(np.log(
                 LSTM_PTB['vocab_size'])),
             'graphs': graphs, 'eager_graphs': egraphs, **cap_mem,
             'captured_against_eager': parity,
             'card_against_cpu': {'rows': PARITY_ROWS, **cpu_parity}}
    # BucketingModule.fit over the example's buckets
    sentences = lstm_corpus(SEED + 21)
    fits = {}
    for mode in ('captured', 'eager'):
        fresh_memory(torch)
        mod, steps, fit_s = lstm_bucket_fit(mx, torch, models, params,
                                            sentences, mode == 'eager')
        fits[mode] = (numpy_params(mod), steps, fit_s, memory(torch),
                      graph_report(g for m in mod._buckets.values()
                                   for g in m._graphs.values()))
        del mod
    per_bucket = {}
    for s in fits['captured'][1]:
        per_bucket.setdefault(s['bucket'], []).append(s)
    buckets = {}
    for b, ss in sorted(per_bucket.items()):
        ms = statistics.median(x['ms'] for x in ss[1:] or ss)
        buckets[b] = {'steps': len(ss), 'step_ms': [x['ms'] for x in ss],
                      'step_ms_median_after_first': ms,
                      'unpadded_words_per_s': statistics.mean(
                          x['real_tokens'] for x in ss) / ms * 1e3,
                      'padded_words_per_s': LSTM_ROWS * b / ms * 1e3}
    bgraphs = fits['captured'][4]
    if not bgraphs or not all(g['captured'] for g in bgraphs):
        raise AssertionError('lstm-ptb: bucket steps not captured: %s'
                             % bgraphs)
    bparity = compare_params('lstm-ptb buckets, captured against eager',
                             fits['captured'][0], fits['eager'][0])
    deterministic(torch, False)
    return train, {'buckets': buckets, 'fit_s': fits['captured'][2],
                   'eager_fit_s': fits['eager'][2],
                   'eager_step_ms': [s['ms'] for s in fits['eager'][1]],
                   'graphs': bgraphs, **fits['captured'][3],
                   'captured_against_eager': bparity}


def ssd_labels(rng, rows):
    """Ground truth as tests/test_ssd.py:19-30 builds it: (rows, 4, 5) of
    (class, xmin, ymin, xmax, ymax) in [0, 1], 1-3 boxes an image, the
    rest -1."""
    labels = np.full((rows, 4, 5), -1.0, np.float32)
    for i in range(rows):
        for j in range(int(rng.integers(1, 4))):
            x0, y0 = rng.uniform(0.0, 0.6, 2)
            w, h = rng.uniform(0.15, 0.4, 2)
            labels[i, j] = [rng.integers(0, SSD_CLASSES), x0, y0,
                            min(x0 + w, 1.0), min(y0 + h, 1.0)]
    return labels


def ssd_params(convert, symbol, shapes):
    arg, aux = convert.random_params(symbol, shapes, SEED)
    arg['relu4_3_scale'][:] = 20.0      # its Constant(20) init
    return arg, aux


def nms_pairs(rows, threshold, force):
    """The (i, j) IoU tests the greedy scan makes on these rows: for each
    row alive at its turn, the later rows still alive then (of its class
    unless ``force``); a numpy replay of the scan, in float32."""
    total = 0
    for img in rows:
        cls = img[:, 0].copy()
        x0, y0, x1, y1 = (img[:, k] for k in range(2, 6))
        area = (x1 - x0) * (y1 - y0)
        for i in range(len(cls)):
            if cls[i] < 0:
                continue
            j = np.arange(i + 1, len(cls))
            live = cls[j] >= 0
            if not force:
                live &= cls[j] == cls[i]
            j = j[live]
            total += len(j)
            w = np.maximum(np.minimum(x1[j], x1[i])
                           - np.maximum(x0[j], x0[i]), 0)
            h = np.maximum(np.minimum(y1[j], y1[i])
                           - np.maximum(y0[j], y0[i]), 0)
            inter = w * h
            union = area[j] + area[i] - inter
            iou = np.where(union > 0, inter / np.where(union > 0, union, 1),
                           0)
            cls[j[iou >= threshold]] = -1
    return total


def nms_case(mx, torch, mb, symbol, params, images, flush):
    """multibox_nms on the served forward's own rows: the detection inputs
    of the deploy graph at SSD_ROWS images (an eager Predictor over its
    internals), ordered as MultiBoxDetection orders them; the kernel
    against its plain version row for row, both timed, and the bound."""
    inner = symbol.get_internals()
    group = mx.sym.Group([inner[n] for n in DETECTION_INPUTS])
    pred = mx.Predictor(group.tojson(), params,
                        {'data': (SSD_ROWS,) + SSD_IMAGE})
    pred.forward(data=images)
    cls_prob, loc, anchors = (o.handle for o in pred._out_arrays)
    rows = mb.detection_rows(cls_prob.float(), loc.float(),
                             anchors.reshape(-1, 4).float(), 0.01, True,
                             SSD_VARIANCES)
    n0 = mb.multibox_nms.launches
    got = mb.multibox_nms(rows, 0.5, True)
    if mb.multibox_nms.launches != n0 + 1:
        raise AssertionError('multibox_nms did not launch')
    # the plain loop (~12 launches a row, seconds) runs once: timed by
    # events and by the host clock, and its rows are the comparison's
    flush.sum()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    want = mb.multibox_nms_plain(rows, 0.5, True)
    end.record()
    torch.cuda.synchronize()
    plain_host_s = time.perf_counter() - t0
    plain_ms = start.elapsed_time(end)
    equal = bool(torch.equal(got, want))
    host_rows = rows.cpu().numpy()
    pairs = nms_pairs(host_rows, 0.5, True)
    nbytes = rows.numel() * 4 * 2          # the rows read, the output written
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = pairs * NMS_OPS_PER_PAIR / FP32_FLOPS * 1e3
    ms = cuda_ms(torch, lambda: mb.multibox_nms(rows, 0.5, True), flush,
                 reps=20, warmup=3)
    # each kernel's device time from torch.profiler's records of 20 more
    # calls (each after an L2 flush), and phase A's words from a call into
    # a zeroed workspace against the plain transcription's, every word
    for _ in range(3):
        mb.multibox_nms(rows, 0.5, True)

    def timed():
        for _ in range(20):
            flush.sum()
            mb.multibox_nms(rows, 0.5, True)
    phase = kernel_records(torch, timed, NMS_KERNELS)
    phase_ms = {n: statistics.median(v) if v else 'not measured'
                for n, v in phase.items()}
    ws = torch.zeros(mb.nms_workspace_shape(*rows.shape[:2]),
                     dtype=torch.int64, device=rows.device)
    ws = mb._nms_launch(rows, 0.5, True, ws=ws)[1]
    words_equal = bool(torch.equal(ws, mb.nms_masks_plain(rows, 0.5, True)))
    # derived from this run's rows, not counted: phase A tests every valid
    # row against the 64 rows of each column block from its own on
    valid_rows = host_rows[:, :, 0] >= 0
    row_block = np.arange(rows.shape[1]) // mb.NMS_BLOCK
    words = mb.nms_words(rows.shape[1])
    phase_a_pairs = int((valid_rows * (words - row_block)).sum()
                        * mb.NMS_BLOCK)
    kept = int((got[..., 0] >= 0).sum())
    case = {'shape': list(rows.shape), 'nms_threshold': 0.5,
            'force_suppress': True, 'equal_to_plain': equal,
            'phase_a_words_equal_to_plain': words_equal,
            'max_abs_err': float((got - want).abs().max()),
            'kept_rows': kept, 'valid_rows': int((got[..., 1] >= 0).sum()),
            'iou_pairs': pairs, 'ms': ms, 'plain_ms': plain_ms,
            'phase_ms': phase_ms, 'phase_a_pairs_from_rows': phase_a_pairs,
            'workspace_bytes': ws.numel() * ws.element_size(),
            'plain_host_s': plain_host_s,
            'host_us': host_us(torch, lambda: mb.multibox_nms(rows, 0.5,
                                                              True), 20),
            'bound_ms': max(byte_ms, op_ms),
            'bound_by': 'bytes' if byte_ms >= op_ms else 'operations',
            'bytes': nbytes, 'flops': pairs * NMS_OPS_PER_PAIR,
            'library_ms': None}
    # per-class suppression, off the path, on the 1000 best rows of two of
    # the images (the plain loop takes ~0.4 ms a row; 19,600 rows and the
    # edge cases: tests/test_torch_cuda.py)
    r = rows[:2, :1000].contiguous()
    g, w = mb.multibox_nms(r, 0.5, False), mb.multibox_nms_plain(r, 0.5,
                                                                  False)
    extra = [{'shape': list(r.shape), 'force_suppress': False,
              'equal_to_plain': bool(torch.equal(g, w)),
              'kept_rows': int((g[..., 0] >= 0).sum())}]
    del pred
    return case, extra


def ssd_serve(mx, torch, models, convert, mb, tmp, flush):
    """ssd serving: the deploy graph saved with model.save_checkpoint,
    served through predictor.load (pow2 buckets to SSD_ROWS, each captured
    by warm_buckets), SSD_FORWARDS forwards of SSD_ROWS images captured
    and under NaiveEngine; Predictor.reshape to one row against a fresh
    Predictor; multibox_nms on the served forward's rows."""
    deterministic(torch, True)
    symbol = models.get_symbol('ssd-vgg16', num_classes=SSD_CLASSES)
    shape = (SSD_ROWS,) + SSD_IMAGE
    arg, aux = ssd_params(convert, symbol, {'data': shape})
    prefix = os.path.join(tmp, 'ssd-vgg16')
    mx.model.save_checkpoint(prefix, 0, symbol,
                             {k: mx.nd.array(v) for k, v in arg.items()},
                             {k: mx.nd.array(v) for k, v in aux.items()})
    rng = np.random.default_rng(SEED + 31)
    batches = [rng.random(shape, dtype=np.float32)
               for _ in range(SSD_FORWARDS)]
    served = {}
    for mode in ('eager', 'captured'):
        set_engine(mx, mode == 'eager')
        fresh_memory(torch)
        try:
            t0 = time.perf_counter()
            pred = mx.predictor.load(prefix, 0, {'data': shape})
            # the served path's pow2 buckets, each captured
            pred._pad_to_bucket = True
            warm = pred.warm_buckets(SSD_ROWS)
            load_s = time.perf_counter() - t0
            n0 = mb.multibox_nms.launches
            times, outs = [], []
            for b in batches:
                t0 = time.perf_counter()
                pred.forward(data=b)
                outs.append(pred.get_output(0))
                times.append(time.perf_counter() - t0)
            launches = mb.multibox_nms.launches - n0
            graphs = graph_report(e._forward_graph for e in
                                  pred._bucket_execs.values()
                                  if getattr(e, '_forward_graph', None))
            traced = None
            if mode == 'captured':
                # one more served forward under torch.profiler: the NMS
                # kernels its graph replay ran, counted by name
                recs = kernel_records(
                    torch, lambda: pred.forward(data=batches[0]),
                    NMS_KERNELS)
                if not np.array_equal(pred.get_output(0), outs[0]):
                    raise AssertionError('ssd: the traced forward differs '
                                         'from the first')
                traced = {n: len(v) for n, v in recs.items()}
            served[mode] = {'outs': outs, 'pred': pred, 'traced': traced,
                            'report': {
                                'load_and_warm_s': load_s,
                                'buckets': warm,
                                'forward_ms': [t * 1e3 for t in times],
                                'forward_ms_p50': float(np.median(times))
                                * 1e3,
                                'images_per_s': SSD_ROWS
                                / float(np.median(times)),
                                'multibox_nms_launches': launches,
                                'graphs': graphs, **memory(torch)}}
        finally:
            set_engine(mx, False)
    cap, eager = served['captured'], served['eager']
    out = cap['outs'][0]
    if out.shape != (SSD_ROWS, SSD_ANCHORS, 6) or \
            not np.all(np.isfinite(out)):
        raise AssertionError('ssd: detections of shape %s, finite %s'
                             % (out.shape, np.all(np.isfinite(out))))
    bitwise = all(np.array_equal(a, b) for a, b in
                  zip(cap['outs'], eager['outs']))
    if not bitwise:
        raise AssertionError('ssd: captured detections differ from eager')
    if cap['report']['multibox_nms_launches'] != SSD_FORWARDS or \
            eager['report']['multibox_nms_launches'] != SSD_FORWARDS:
        raise AssertionError('ssd: multibox_nms launched %d / %d times in %d '
                             'forwards' % (cap['report'][
                                 'multibox_nms_launches'], eager['report'][
                                 'multibox_nms_launches'], SSD_FORWARDS))
    if not all(g['captured'] for g in cap['report']['graphs']):
        raise AssertionError('ssd: buckets not captured: %s'
                             % cap['report']['graphs'])
    # Predictor.reshape to one row against a fresh Predictor
    pred = cap['pred']
    pred.reshape({'data': (1,) + SSD_IMAGE})
    one = batches[1][:1]
    pred.forward(data=one)
    got = pred.get_output(0)
    fresh = mx.predictor.load(prefix, 0, {'data': (1,) + SSD_IMAGE})
    fresh._pad_to_bucket = True
    fresh.forward(data=one)
    want = fresh.get_output(0)
    if got.shape != (1, SSD_ANCHORS, 6) or not np.array_equal(got, want):
        raise AssertionError('ssd: reshape to one row differs from a fresh '
                             'Predictor (max abs %g)'
                             % float(np.max(np.abs(got - want))))
    reshape = {'rows': 1, 'bitwise_equal_to_fresh': True,
               'kept': int((got[..., 0] >= 0).sum())}
    del pred, fresh, served
    params = convert.params_from_numpy(arg, aux, 'cuda:0')
    case, extra = nms_case(mx, torch, mb, symbol, params, batches[0], flush)
    case['kernels_per_served_forward'] = traced = cap['traced']
    if any(traced.values()) and set(traced.values()) != {1}:
        raise AssertionError('ssd: a traced served forward ran the NMS '
                             'kernels %s times, not once each' % traced)
    if not any(traced.values()):
        case['kernels_per_served_forward'] = 'not measured: the profiler ' \
            'recorded no NMS kernel'
    if not case['equal_to_plain'] or \
            not case['phase_a_words_equal_to_plain'] or \
            not all(e['equal_to_plain'] for e in extra):
        raise AssertionError('multibox_nms disagrees with its plain version: '
                             '%s %s' % (case, extra))
    first = cap['report']
    deterministic(torch, False)
    return {'model': 'ssd-vgg16', 'classes': SSD_CLASSES,
            'image': list(SSD_IMAGE), 'rows': SSD_ROWS,
            'anchors': SSD_ANCHORS, 'forwards': SSD_FORWARDS,
            'served_through': 'predictor.load(prefix, 0, {data: ...}), '
                              'its pow2 buckets on',
            'kept_per_image': float((out[..., 0] >= 0).sum() / SSD_ROWS),
            **first, 'eager': eager['report'],
            'captured_equals_eager_bitwise': bitwise,
            'reshape': reshape}, case, extra


def ssd_metric(mx):
    """The SSD example's training metric, on the host: the cross-entropy
    of cls_prob at the assigned classes (rows with cls_target -1 left
    out) and the mean smooth-L1 localisation loss per assigned row."""

    class MultiBoxMetric(mx.metric.EvalMetric):
        def __init__(self):
            super().__init__('multibox')

        def reset(self):
            self.ce, self.loc, self.n = 0.0, 0.0, 0

        def update(self, labels, preds):
            prob, loc, target = (p.asnumpy() for p in preds[:3])
            t = target.astype(np.int64)
            valid = t >= 0
            p = np.take_along_axis(prob, np.maximum(t, 0)[:, None],
                                   axis=1)[:, 0]
            self.ce += float(-np.log(np.maximum(p[valid], 1e-30)).mean())
            self.loc += float(loc.sum() / max(valid.sum(), 1))
            self.n += 1

        def get(self):
            return (['cross-entropy', 'smooth-l1'],
                    [self.ce / max(self.n, 1), self.loc / max(self.n, 1)])

    return MultiBoxMetric()


def ssd_valid_counts(mx, symbol, shapes, arg, aux, images, labels):
    """Each batch's count of localisation-loss entries above MakeLoss's
    valid_thresh (0): what upstream MXNet's normalization='valid'
    divides that loss's gradient by.  The JAX op, and so the port,
    injects grad_scale undivided."""
    exe = symbol.simple_bind(mx.gpu(0), grad_req='null', **shapes)
    for k, v in list(arg.items()) + list(aux.items()):
        (exe.arg_dict if k in exe.arg_dict else exe.aux_dict)[k][:] = v
    counts = []
    for i in range(0, len(images), SSD_ROWS):
        exe.arg_dict['data'][:] = images[i:i + SSD_ROWS]
        exe.arg_dict['label'][:] = labels[i:i + SSD_ROWS]
        loc_loss = exe.forward(is_train=False)[1].asnumpy()
        counts.append(int((loc_loss > 0).sum()))
    del exe
    return counts


def ssd_train(mx, torch, models, convert):
    """ssd training: Module.fit on ssd-vgg16-train at SSD_ROWS x 300 x 300
    with seeded boxes, f32 (cuDNN deterministic, TF32 off), SGD momentum
    0.9 wd 5e-4 (the SSD example's), SSD_TRAIN_STEPS steps captured and
    under NaiveEngine from the same state.  The example's lr 0.004
    assumes the localisation loss normalized by its valid count, which
    MakeLoss ignores here as in the JAX op: the lr is 0.004 over the
    largest count of the run's batches, so no step moves the
    localisation head further than the example's would."""
    deterministic(torch, True)
    symbol = models.get_symbol('ssd-vgg16-train', num_classes=SSD_CLASSES)
    shapes = {'data': (SSD_ROWS,) + SSD_IMAGE, 'label': (SSD_ROWS, 4, 5)}
    arg, aux = ssd_params(convert, symbol, shapes)
    rng = np.random.default_rng(SEED + 33)
    n = SSD_TRAIN_STEPS * SSD_ROWS
    images = rng.random((n,) + SSD_IMAGE, dtype=np.float32)
    labels = ssd_labels(rng, n)
    counts = ssd_valid_counts(mx, symbol, shapes, arg, aux, images, labels)
    opt = dict(SSD_OPT, learning_rate=SSD_OPT['learning_rate']
               / max(max(counts), 1))
    runs = {}
    for mode in ('captured', 'eager'):
        set_engine(mx, mode == 'eager')
        fresh_memory(torch)
        try:
            times, last = [], [time.perf_counter()]

            def tick(_):
                torch.cuda.synchronize()
                now = time.perf_counter()
                times.append(now - last[0])
                last[0] = time.perf_counter()

            metric = ssd_metric(mx)
            mod = mx.mod.Module(symbol, data_names=('data',),
                                label_names=('label',), context=mx.gpu(0))
            mod.fit(mx.io.NDArrayIter(images, labels, batch_size=SSD_ROWS,
                                      label_name='label'),
                    num_epoch=1, eval_metric=metric, optimizer='sgd',
                    optimizer_params=dict(opt),
                    arg_params={k: mx.nd.array(v) for k, v in arg.items()},
                    aux_params={k: mx.nd.array(v) for k, v in aux.items()},
                    batch_end_callback=tick)
            runs[mode] = (numpy_params(mod), times,
                          dict(zip(*metric.get())),
                          graph_report(mod._graphs.values()), memory(torch))
            del mod
        finally:
            set_engine(mx, False)
    params, times, loss, graphs, mem = runs['captured']
    moved = max(float(np.max(np.abs(params[k] - v))) for k, v in arg.items())
    if not all(np.all(np.isfinite(v)) for v in params.values()) or \
            moved <= 0 or not all(np.isfinite(v) for v in loss.values()):
        raise AssertionError('ssd-train: loss %s, max |dw| %g' % (loss,
                                                                  moved))
    if len(graphs) != 1 or not graphs[0]['captured']:
        raise AssertionError('ssd-train: not captured: %s' % graphs)
    parity = compare_params('ssd-train, captured against eager', params,
                            runs['eager'][0])
    deterministic(torch, False)
    return {'model': 'ssd-vgg16-train', 'rows': SSD_ROWS,
            'image': list(SSD_IMAGE), 'steps': SSD_TRAIN_STEPS,
            'dtype': 'float32', 'optimizer': 'sgd lr 0.004 / %d momentum '
            '0.9 wd 5e-4' % max(max(counts), 1),
            'loc_valid_counts': counts, 'step_ms': [t * 1e3 for t in times],
            'step_ms_median_after_first': statistics.median(times[1:]) * 1e3,
            'images_per_s': SSD_ROWS / statistics.median(times[1:]),
            'loss': loss, 'graphs': graphs, **mem,
            'eager_step_ms': [t * 1e3 for t in runs['eager'][1]],
            'captured_against_eager': parity}


_AHEAD = {}         # what the zoo phases make on the host, made once


def ahead(key, make):
    """``make()``, once per ``key``: main makes these while the capture
    child runs (:func:`zoo_ahead`)."""
    if key not in _AHEAD:
        _AHEAD[key] = make()
    return _AHEAD[key]


def zoo_model(models, convert, name, image, rows=BATCH):
    """``name``'s symbol (1000 classes) and random parameters at ``rows``
    rows of ``image``, shared by zoo-train and zoo-eval (32 rows) or
    made for zoo-serve (ZOO_SERVE_ROWS)."""
    def make():
        symbol = models.get_symbol(name, num_classes=1000)
        arg, aux = convert.random_params(symbol, {'data': (rows,) + image},
                                         SEED)
        return symbol, arg, aux
    return ahead(('model', name, image, rows), make)


def zoo_train_shapes(mx, models):
    """Inception-v3's training kernel shapes at 32 rows (dots, convs,
    BN-ReLUs) and VGG-16's FullyConnected epilogues."""
    def make():
        inception = models.get_symbol('inception-v3', num_classes=1000)
        vgg = models.get_symbol('vgg16', num_classes=1000)
        return (train_kernel_shapes(mx, inception, BATCH, INCEPTION_IMAGE),
                graph_kernel_shapes(mx, vgg, {'data': (BATCH,) + IMAGE})[0])
    return ahead('zoo-train-shapes', make)


def zoo_ahead(mx, models, convert):
    """The zoo phases' host work, made ahead: parameters and shapes."""
    for name, image in (('inception-v3', INCEPTION_IMAGE),
                        ('vgg16', IMAGE)):
        zoo_model(models, convert, name, image)
    for name, image in ZOO_SERVE:
        zoo_model(models, convert, name, image, ZOO_SERVE_ROWS)
    zoo_train_shapes(mx, models)


def zoo_train(mx, torch, models, convert, name, image, kernels, expected):
    """Module.fit of ``name`` (1000 classes, 32 rows of ``image``) in bf16
    over f32 masters, SGD lr 0.01 momentum 0.9 wd 1e-4 (VGG-16 has no
    BatchNorm: at the ResNet phases' 0.05 it diverges from He-scaled
    weights): ZOO_STEPS steps captured, then EAGER_STEPS from the
    same state under NaiveEngine; launches per step by kernel must be
    ``expected`` in both."""
    symbol, arg, aux = zoo_model(models, convert, name, image)
    rng = np.random.default_rng(SEED + 41)
    images = rng.standard_normal((ZOO_STEPS * BATCH,) + image,
                                 dtype=np.float32)
    labels = rng.integers(0, 1000, ZOO_STEPS * BATCH).astype(np.float32)
    fresh_memory(torch)
    counts0 = launch_counts(kernels)
    mx.random.seed(SEED)        # VGG's Dropout: the same draws both runs
    mod, step_s, snap = train_module(mx, torch, symbol, arg, aux, images,
                                     labels, mx.gpu(0), torch.bfloat16,
                                     BATCH, snap_at=EAGER_STEPS,
                                     optimizer_params=ZOO_OPT)
    cap = step_report(step_s, counts0, kernels, torch)
    metric = dict(mod._fused_metric.get_name_value())
    graphs = graph_report(mod._graphs.values())
    del mod
    fresh_memory(torch)
    counts0 = launch_counts(kernels)
    set_engine(mx, True)
    mx.random.seed(SEED)
    try:
        emod, estep_s = train_module(
            mx, torch, symbol, arg, aux, images[:EAGER_STEPS * BATCH],
            labels[:EAGER_STEPS * BATCH], mx.gpu(0), torch.bfloat16, BATCH,
            optimizer_params=ZOO_OPT)
    finally:
        set_engine(mx, False)
    eager = step_report(estep_s, counts0, kernels, torch)
    eparams = numpy_params(emod)
    del emod
    got = {k: v['all'] for k, v in cap['launches_per_step'].items()}
    if got != expected:
        raise AssertionError('%s: launches per step %s, expected %s'
                             % (name, got, expected))
    if not np.isfinite(metric['cross-entropy']) or len(graphs) != 1 or \
            not graphs[0]['captured']:
        raise AssertionError('%s: cross-entropy %s, graphs %s'
                             % (name, metric['cross-entropy'], graphs))
    report = compare_runs('zoo %s' % name, cap, eager, snap, eparams,
                          EAGER_STEPS)
    ms = cap['step_ms_median_after_first']
    return {'model': name, 'image': list(image), 'rows': BATCH,
            'dtype': 'bfloat16 over float32 masters',
            'steps': ZOO_STEPS, 'images_per_s': BATCH / ms * 1e3,
            'cross_entropy': metric['cross-entropy'], 'graphs': graphs,
            **report}


def zoo_eval(mx, torch, models, convert, ts, name, image, fuse, kernels):
    """make_eval_step forwards of ``name`` at 32 rows in bf16 under
    MXTPU_FUSE=``fuse``, captured: ms per forward, images/s, launches per
    forward; the first captured forward against an eager one."""
    symbol, arg, aux = zoo_model(models, convert, name, image)
    data = np.random.default_rng(SEED + 43).standard_normal(
        (BATCH,) + image, dtype=np.float32)
    os.environ['MXTPU_FUSE'] = fuse
    outs = {}
    try:
        for mode in ('eager', 'captured'):
            set_engine(mx, mode == 'eager')
            try:
                p = {k: torch.from_numpy(v).cuda() for k, v in arg.items()}
                a = {k: torch.from_numpy(v).cuda() for k, v in aux.items()}
                b = {'data': torch.from_numpy(data).cuda(),
                     'softmax_label': torch.zeros(BATCH).cuda()}
                step = ts.make_eval_step(symbol,
                                         compute_dtype=torch.bfloat16)
                step(p, a, b)       # captures on the card
                counts0 = launch_counts(kernels)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(ZOO_EVALS):
                    last = step(p, a, b)[0]
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) / ZOO_EVALS * 1e3
                outs[mode] = (last.float().cpu().numpy(), {
                    'forward_ms': ms, 'images_per_s': BATCH / ms * 1e3,
                    'launches_per_forward': {
                        k: v['all'] for k, v in launches_per_step(
                            counts0, launch_counts(kernels),
                            ZOO_EVALS).items()},
                    'graphs': graph_report(c for c, _ in
                                           step.graphs.values())})
            finally:
                set_engine(mx, False)
    finally:
        os.environ['MXTPU_FUSE'] = 'aggressive'
    got, want = outs['captured'][0], outs['eager'][0]
    if got.shape != (BATCH, 1000) or not np.all(np.isfinite(got)):
        raise AssertionError('%s eval: output %s' % (name, got.shape))
    rows = np.abs(got.sum(axis=1) - 1.0).max()
    if not np.array_equal(got, want) or rows > 2e-2:
        raise AssertionError('%s eval (%s): captured against eager max abs '
                             '%g, row sums off by %g'
                             % (name, fuse, float(np.abs(got - want).max()),
                                rows))
    return {'model': name, 'fuse': fuse, 'image': list(image),
            'rows': BATCH, 'dtype': 'bfloat16', 'forwards': ZOO_EVALS,
            **outs['captured'][1], 'eager': outs['eager'][1],
            'captured_equals_eager_bitwise': True,
            'max_row_sum_error': float(rows)}


def zoo_serve(mx, torch, models, convert, bn_relu):
    """One captured served forward of ZOO_SERVE_ROWS rows of each of
    ZOO_SERVE's models (a pad_to_bucket Predictor: its first forward
    records the bucket's graph, the second replays it) against a
    NaiveEngine Predictor: finite, equal, probability rows summing
    to 1; ``bn_relu`` (fused_bn_relu) launches by model."""
    out = []
    for name, image in ZOO_SERVE:
        n0 = bn_relu.launches
        shape = (ZOO_SERVE_ROWS,) + image
        symbol, arg, aux = zoo_model(models, convert, name, image,
                                     ZOO_SERVE_ROWS)
        params = convert.params_from_numpy(arg, aux, 'cuda:0')
        data = np.random.default_rng(SEED + 47).standard_normal(
            shape, dtype=np.float32)
        got = {}
        for mode in ('eager', 'captured'):
            set_engine(mx, mode == 'eager')
            try:
                pred = mx.Predictor(symbol.tojson(), params, {'data': shape},
                                    pad_to_bucket=True)
                if mode == 'captured':
                    pred.forward(data=data)     # warm-up, then the capture
                t0 = time.perf_counter()
                pred.forward(data=data)
                got[mode] = (pred.get_output(0),
                             (time.perf_counter() - t0) * 1e3,
                             graph_report([pred._bucket_execs[
                                 ZOO_SERVE_ROWS]._forward_graph]))
                del pred
            finally:
                set_engine(mx, False)
        prob, ms, graphs = got['captured']
        sums = np.abs(prob.sum(axis=1) - 1.0).max()
        if prob.shape != (ZOO_SERVE_ROWS, 1000) or \
                not np.all(np.isfinite(prob)) or sums > 1e-4 or \
                not np.array_equal(prob, got['eager'][0]) or \
                not graphs[0]['captured'] or graphs[0]['replays'] != 1:
            raise AssertionError('zoo serve %s: shape %s, row sums off by %g,'
                                 ' captured against eager max abs %g, %s'
                                 % (name, prob.shape, sums, float(np.abs(
                                     prob - got['eager'][0]).max()), graphs))
        out.append({'model': name, 'image': list(image),
                    'rows': ZOO_SERVE_ROWS, 'forward_ms': ms,
                    'eager_forward_ms': got['eager'][1],
                    'max_row_sum_error': float(sums),
                    'captured_equals_eager_bitwise': True,
                    'graphs': graphs,
                    'fused_bn_relu_launches': bn_relu.launches - n0})
    return out


def zoo_kernels(mx, torch, fused, fused_conv, models, gen, flush, served_zoo):
    """#2, #4 and #3 at every shape Inception-v3's and VGG-16's aggressive
    training graphs give them at 32 rows (bf16, the path's dtype), and
    #2 at every shape the inference graph of each served model that
    launched it (``served_zoo``, zoo_serve's report) gives it at
    ZOO_SERVE_ROWS rows (f32, the served path's dtype), each against its
    plain version by the existing checks."""
    (dots, convs, bn_relus), epis = zoo_train_shapes(mx, models)
    if dots or sum(convs.values()) != 10 or sum(bn_relus.values()) != 84:
        raise AssertionError('inception-v3 training: %d 1x1, %d 3x3, %d '
                             'BN-ReLU kernel nodes (expected 0, 10, 84)'
                             % (sum(dots.values()), sum(convs.values()),
                                sum(bn_relus.values())))
    if sum(epis.values()) != 2:
        raise AssertionError('vgg16: %d FullyConnected epilogue kernels '
                             '(expected 2)' % sum(epis.values()))
    served, served_by = {}, {}     # shape -> {model: launches a forward}
    for run in served_zoo:
        if not run['fused_bn_relu_launches']:
            continue
        name, image = run['model'], tuple(run['image'])
        shapes = bn_relu_shapes(mx, models.get_symbol(name, num_classes=1000),
                                ZOO_SERVE_ROWS, image)
        if not shapes:
            raise AssertionError('zoo serve %s: %d fused_bn_relu launches, '
                                 'none in its graph' % (
                                     name, run['fused_bn_relu_launches']))
        served_by[name] = sum(shapes.values())
        for shape, per_forward in shapes.items():
            served.setdefault(shape, {})[name] = per_forward
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    bn_cases, conv_cases, epi_cases = [], [], []
    for shape, per_step in sorted(bn_relus.items()):
        case = check_bn_relu(torch, fused, shape, torch.bfloat16, gen, flush)
        case.update(model='inception-v3', launches_per_step=per_step)
        bn_cases.append(case)
    served_cases = []
    for shape, per_model in sorted(served.items()):
        case = check_bn_relu(torch, fused, shape, torch.float32, gen, flush)
        case.update(models=per_model,
                    launches_per_forward=sum(per_model.values()))
        served_cases.append(case)
    for shape, per_step in sorted(convs.items()):
        case = check_conv(torch, fused_conv, shape, torch.bfloat16, gen,
                          flush)
        case.update(model='inception-v3', launches_per_step=per_step)
        conv_cases.append(case)
    for (m, k, n, bias, relu, clip), per_step in sorted(epis.items()):
        case = check_epilogue(torch, fused, (m, k, n), bias, relu,
                              (0.0, 6.0) if clip else None, torch.bfloat16,
                              gen, flush)
        case.update(model='vgg16', launches_per_step=per_step)
        epi_cases.append(case)
    torch.backends.cudnn.allow_tf32 = True
    return bn_cases, served_cases, served_by, conv_cases, epi_cases


def tail_op_specs(torch):
    """tail-ops: the 12 ops this slice adds, forward (and backward where
    the op has one) on the card against the same call on the CPU, at a
    real user's shapes: the specs."""
    from mxnet_tpu_torch.ops import multibox as mb
    rng = np.random.default_rng(SEED + 51)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    specs = []

    def case(name, attrs, inputs, diff, exact=False):
        specs.append((name, attrs, inputs, diff, exact))

    # the PTB LSTM's RNN op (T, N, E) and a bidirectional GRU
    from mxnet_tpu_torch.ops.rnn_op import rnn_param_size
    for mode, bi in (('lstm', False), ('gru', True)):
        size = rnn_param_size(mode, 200, 200, 2, bi)
        case('RNN', {
            'mode': mode, 'state_size': 200, 'num_layers': 2,
            'bidirectional': bi, 'state_outputs': True},
            [n(LSTM_T, LSTM_ROWS, 200), n(size, scale=0.07)], (0, 1))
    # example/warpctc/lstm_ocr.py: 80 steps, 32 rows, 11 symbols, 4 labels
    labels = rng.integers(1, 11, (32, 4)).astype(np.float32)
    case('ctc_loss', {}, [n(80, 32, 11), labels], (0,))
    case('WarpCTC', {'label_length': 4, 'input_length': 80},
         [n(80 * 32, 11), labels.reshape(-1)], (0,))
    # a spatial transformer over 28 x 28 digits, 64 rows
    theta = np.tile(np.array([0.9, -0.1, 0.05, 0.1, 0.85, -0.05],
                             np.float32), (64, 1)) + n(64, 6, scale=0.05)
    case('GridGenerator', {
        'transform_type': 'affine', 'target_shape': (28, 28)}, [theta], (0,))
    grid = np.clip(n(64, 2, 28, 28, scale=0.6), -1.1, 1.1)
    case('BilinearSampler', {}, [n(64, 1, 28, 28), grid], (0, 1))
    case('SpatialTransformer', {
        'target_shape': (28, 28)}, [n(64, 1, 28, 28), theta], (0, 1))
    # Fast R-CNN: VGG16 conv5_3 of a 600 x 800 image, 64 rois, 7 x 7
    rois = np.zeros((64, 5), np.float32)
    xy = rng.uniform(0, 500, (64, 2))
    wh = rng.uniform(32, 300, (64, 2))
    rois[:, 1:3], rois[:, 3:5] = xy, xy + wh
    case('ROIPooling', {
        'pooled_size': (7, 7), 'spatial_scale': 1.0 / 16},
        [n(1, 512, 38, 50), rois], (0,))
    # FlowNetC's correlation: conv3 features, displacement 20, stride 2
    case('Correlation', {
        'max_displacement': 20, 'stride2': 2, 'pad_size': 20},
        [n(2, 256, 48, 64), n(2, 256, 48, 64)], (0, 1))
    # a sparse autoencoder's sigmoid layer
    case('IdentityAttachKLSparseReg', {
        'sparseness_target': 0.05, 'penalty': 1e-3},
        [rng.uniform(0.01, 0.99, (128, 1000)).astype(np.float32),
         rng.uniform(0.0, 0.2, 1000).astype(np.float32)], (0,))
    # SSD's heads at 300 x 300, 8 images, 21 classes; the target and the
    # detection over the 10 x 10 head's 600 anchors (the CPU's side of
    # the detection is the plain NMS loop, ~1 ms a row)
    anchors = mb.multibox_prior(torch.zeros(1, 1, 10, 10),
                                sizes=(0.38, 0.461),
                                ratios=(1, 2, 0.5, 3, 1. / 3),
                                clip=True).numpy()
    # not exact: CUDA divides by a scalar as a multiply by its reciprocal
    case('MultiBoxPrior', {
        'sizes': (0.2, 0.276), 'ratios': (1, 2, 0.5, 3, 1. / 3),
        'clip': True}, [n(8, 1024, 19, 19)], ())
    a = anchors.shape[1]
    # class 1's logit decides every anchor's background-free score, its
    # values far apart: negative mining ranks the same anchors on both
    # devices (ulp-close scores could swap places)
    cls_pred = np.zeros((8, 21, a), np.float32)
    cls_pred[:, 1] = rng.permutation(8 * a).reshape(8, a) * 1e-3
    case('MultiBoxTarget', {
        'overlap_threshold': 0.5, 'negative_mining_ratio': 3,
        'negative_mining_thresh': 0.5},
        [anchors, ssd_labels(rng, 8), cls_pred], ())
    prob = np.exp(cls_pred - cls_pred.max(1, keepdims=True))
    prob = (prob / prob.sum(1, keepdims=True)).astype(np.float32)
    # zero offsets decode to the anchors exactly (exp(0) = 1) on both
    # devices, so the kernel and the plain loop test the same boxes
    case('MultiBoxDetection', {
        'nms_threshold': 0.5, 'force_suppress': True},
        [prob, np.zeros((8, a * 4), np.float32), anchors], (),
        exact=True)
    return specs


def nms_summary(case, launches):
    """The kernels-line entry of multibox_nms."""
    return {'name': 'multibox_nms', 'route': 'cuda',
            'source': 'mxnet_tpu_torch/csrc/multibox_nms.cu',
            'replaces': 'mxnet_tpu/ops/multibox.py:279 (the fori_loop of '
                        'MultiBoxDetection; no pl.pallas_call)',
            'launches': sum(launches.values()),
            'launches_by_path': launches,
            'kernels_per_call': case['kernels_per_served_forward'],
            'phase_ms': case['phase_ms'],
            'workspace_bytes': case['workspace_bytes'],
            'phase_a_pairs_from_rows': case['phase_a_pairs_from_rows'],
            'max_abs_err': case['max_abs_err'], 'ms': case['ms'],
            'plain_ms': case['plain_ms'], 'bound_ms': case['bound_ms'],
            'bound_by': case['bound_by'], 'library_ms': None,
            'per': 'one served forward of %d images, %d anchors'
                   % (SSD_ROWS, SSD_ANCHORS),
            'host_us': case['host_us'], 'case': case}


# -- the kvstore data plane (kv-local, kv-dist-sync, kv-dist-async) ------
# full-width ResNet-50 v2, f32, MXTPU_FUSE=aggressive, SGD_MOMENTUM, TF32
# off and cuDNN deterministic; KV_STEPS steps of BATCH rows per executor
# (kv-local, kv-dist-sync), KV_ASYNC_STEPS per worker (kv-dist-async)
KV_STEPS = 4
KV_ASYNC_STEPS = 2
KV_FAULT_STEPS = 2
# the fault run: rank 1's client severs its 40th push frame (a step is
# 161 pushes, one per parameter), then reconnects and replays
KV_FAULT = 'client.send.push:after:40:sever'
KV_CLUSTER_TIMEOUT = 240        # seconds, each launcher run
KV_RTOL = 1e-5                  # against the slice arithmetic (-n 2)
# kv-local against the one-context fit: at most this times the f32 noise
# floor, the distance of a one-context fit over every batch's rows in
# another order (the same arithmetic summed in another order)
KV_NOISE_FACTOR = 2.0
FEED_CAPTURE_CHILDREN = 3


def kv_data(rows):
    """The kv phases' images and labels: the same rows in every process."""
    rng = np.random.default_rng(SEED + 19)
    x = rng.standard_normal((rows,) + IMAGE, dtype=np.float32)
    y = rng.integers(0, 1000, rows).astype(np.float32)
    return x, y


def kv_rows(batch, nranks, rank, steps):
    """The rows of ``rank``'s part of each of ``steps`` global batches."""
    per = batch // nranks
    return np.concatenate([np.arange(b * batch + rank * per,
                                     b * batch + (rank + 1) * per)
                           for b in range(steps)])


def kv_slice_oracle(mx, torch, symbol, arg, aux, x, y, batch, nslices,
                    steps):
    """What a dist_sync job of ``nslices`` processes computes, done by
    hand in one: one one-context module per process's slice of every
    batch over the same weights (each its own BatchNorm statistics, as
    each worker process has), their gradients summed in slice order, the
    Updater of the Module's SGD (rescale_grad 1 / batch) on the weights;
    returns the weights."""
    per = batch // nslices
    mods = []
    for _ in range(nslices):
        m = mx.mod.Module(symbol, context=mx.gpu(0))
        m.bind([('data', (per,) + IMAGE)], [('softmax_label', (per,))])
        m.init_params(arg_params={k: mx.nd.array(v) for k, v in arg.items()},
                      aux_params={k: mx.nd.array(v) for k, v in aux.items()})
        mods.append(m)
    names = mods[0]._param_names
    upd = mx.optimizer.get_updater(mx.optimizer.create(
        'sgd', rescale_grad=1.0 / batch,
        param_idx2name=dict(enumerate(names)), **SGD_MOMENTUM))
    weights = {k: mx.nd.array(v, ctx=mx.gpu(0)) for k, v in arg.items()}
    for b in range(steps):
        grads = {}
        for s, m in enumerate(mods):
            m._exec_group.set_params(weights, {})
            lo = b * batch + s * per
            m.forward_backward(mx.io.DataBatch(
                [mx.nd.array(x[lo:lo + per])],
                [mx.nd.array(y[lo:lo + per])]))
            ex = m._exec_group.execs[0]
            for n in names:
                g = ex.grad_dict[n].handle
                grads[n] = g.clone() if n not in grads else grads[n] + g
        for i, n in enumerate(names):
            upd(i, mx.nd.NDArray(grads[n]), weights[n])
    torch.cuda.synchronize()
    return {k: v.asnumpy() for k, v in weights.items()}


def max_rel(got, want):
    """The largest |got - want| / max|want| over the parameters."""
    return max(float(np.max(np.abs(got[k] - want[k])) /
                     max(float(np.max(np.abs(want[k]))), 1e-30))
               for k in want)


def kv_kernel_cases(torch, fused, fused_conv, mx, symbol, gen):
    """The three kernels of the kv paths in float32 at their shapes: a
    16-row executor's (kv-local's two executors), and the BN-ReLUs of a
    32-row one (the dist workers'; their 1x1 and 3x3 convs at 32 rows are
    the kernels phase's float32 cases)."""
    flush = torch.ones(32 << 20, device='cuda')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dots, convs, bn16 = train_kernel_shapes(mx, symbol, BATCH // 2)
    _, _, bn32 = train_kernel_shapes(mx, symbol, BATCH)
    out = {'fused_scale_bias_dot': [], 'fused_scale_bias_conv3x3': [],
           'fused_bn_relu': []}
    for mkn, per_exec in sorted(dots.items()):
        case = check_dot(torch, fused, mkn, torch.float32, gen, flush)
        case.update(rows=BATCH // 2, launches_per_executor_step=per_exec)
        out['fused_scale_bias_dot'].append(case)
    for shape, per_exec in sorted(convs.items()):
        case = check_conv(torch, fused_conv, shape, torch.float32, gen,
                          flush)
        case.update(rows=BATCH // 2, launches_per_executor_step=per_exec)
        out['fused_scale_bias_conv3x3'].append(case)
    for rows, shapes in ((BATCH // 2, bn16), (BATCH, bn32)):
        for shape, per_exec in sorted(shapes.items()):
            case = check_bn_relu(torch, fused, shape, torch.float32, gen,
                                 flush)
            case.update(rows=rows, launches_per_executor_step=per_exec)
            out['fused_bn_relu'].append(case)
    for name, cases in out.items():
        for c in cases:
            if name != 'fused_bn_relu' and c['route'] != 'simt':
                raise AssertionError('%s %s took the %s route'
                                     % (name, c.get('mkn') or c.get('shape'),
                                        c['route']))
    torch.backends.cudnn.allow_tf32 = True
    return out


def kv_local(mx, torch, symbol, arg, aux, kernels, bn_relu_nodes):
    """kv-local: Module(context=[gpu(0), gpu(0)]), 32 rows as 16 + 16,
    kvstore 'local' then 'device', KV_STEPS steps each: launches per step
    by kernel (counts zeroed just before each fit, read just after: two
    executors, twice a one-context step's 36 / 16 / 2), step ms, and the
    parameters against the one-context fit at 32 rows (the executors
    share their BatchNorm statistics, so both take the whole batch's
    step): within KV_NOISE_FACTOR times the f32 noise floor, measured
    here as the distance from that fit of a one-context fit over every
    batch's rows in another order (on ResNet-50 v2 four steps amplify a
    summation order's rounding to about 1e-3; per-slice BatchNorm stood
    at 1.44e-2)."""
    deterministic(torch, True)
    x, y = kv_data(BATCH * KV_STEPS)
    fresh_memory(torch)
    one, one_s = train_module(mx, torch, symbol, arg, aux, x, y, mx.gpu(0),
                              None, BATCH, eval_metric='acc')
    one_params = numpy_params(one)
    del one
    order = np.concatenate([b * BATCH + np.random.default_rng(
        SEED + 20).permutation(BATCH) for b in range(KV_STEPS)])
    fresh_memory(torch)
    other, _ = train_module(mx, torch, symbol, arg, aux, x[order],
                            y[order], mx.gpu(0), None, BATCH,
                            eval_metric='acc')
    noise = max_rel(numpy_params(other), one_params)
    del other
    expected = {'fused_scale_bias_dot': 2 * 36,
                'fused_scale_bias_conv3x3': 2 * 16,
                'fused_bn_relu': 2 * bn_relu_nodes}
    runs, launches = {}, dict.fromkeys(expected, 0)
    for kind in ('local', 'device'):
        fresh_memory(torch)
        for k in kernels:
            reset_launches(k)
        counts0 = launch_counts(kernels)
        mod, step_s = train_module(mx, torch, symbol, arg, aux, x, y,
                                   [mx.gpu(0), mx.gpu(0)], None, BATCH,
                                   kvstore=kind, eval_metric='acc')
        torch.cuda.synchronize()
        got = numpy_params(mod)
        per_step = launches_per_step(counts0, launch_counts(kernels),
                                     len(step_s))
        for name, n in expected.items():
            if per_step.get(name, {}).get('all') != n:
                raise AssertionError('kv-local %s: %s launched %s a step '
                                     '(expected %d)' % (
                                         kind, name, per_step.get(name), n))
            launches[name] += n * len(step_s)
        if len(mod._exec_group.execs) != 2 or mod._fused is not None or \
                mod._kvstore is None or mod._kvstore.type != kind:
            raise AssertionError('kv-local %s: not two executors through '
                                 'the store' % kind)
        rel = max_rel(got, one_params)
        if not rel <= KV_NOISE_FACTOR * noise:
            raise AssertionError('kv-local %s: parameters %.3g from the '
                                 'one-context fit, past %g times the f32 '
                                 'noise floor %.3g' % (kind, rel,
                                                       KV_NOISE_FACTOR,
                                                       noise))
        runs[kind] = {
            'step_ms': [t * 1e3 for t in step_s],
            'step_ms_median_after_first':
                statistics.median(step_s[1:]) * 1e3,
            'launches_per_step': per_step,
            'max_rel_vs_one_context_32_rows': rel,
            **memory(torch)}
        del mod
    deterministic(torch, False)
    return {'runs': runs, 'contexts': ['gpu(0)', 'gpu(0)'],
            'rows': [BATCH // 2, BATCH // 2], 'steps': KV_STEPS,
            'one_context_step_ms_median_after_first':
                statistics.median(one_s[1:]) * 1e3,
            'launches_per_step_expected': expected,
            'noise_floor_max_rel': noise,
            'noise_factor': KV_NOISE_FACTOR}, launches, one_params


def kv_cluster(nworkers, mode, out_dir, extra_env=None, flag='--kv-worker',
               argv=None):
    """``tools/launch.py -n nworkers --launcher local`` over this script's
    ``flag`` entry (``--kv-worker mode out_dir`` unless ``argv`` is given);
    the process group is killed past KV_CLUSTER_TIMEOUT.  Returns (wall
    s, the workers' reports)."""
    root = os.path.dirname(os.path.abspath(__file__))
    port = free_port_pair()
    env = dict(os.environ)
    env.pop('MXTPU_KV_SERVER_ADDR', None)
    env.update(extra_env or {})
    cmd = [sys.executable, os.path.join(root, 'tools', 'launch.py'),
           '-n', str(nworkers), '--launcher', 'local', '--port', str(port),
           ' '.join([sys.executable, os.path.abspath(__file__), flag]
                    + list(argv or [mode, out_dir]))]
    t0 = time.monotonic()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env,
                            cwd=root, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=KV_CLUSTER_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        out, _ = proc.communicate()
        raise AssertionError('kv cluster %s -n %d ran past %d s: %s'
                             % (mode, nworkers, KV_CLUSTER_TIMEOUT,
                                out[-2000:]))
    wall = time.monotonic() - t0
    if proc.returncode != 0:
        raise AssertionError('kv cluster %s -n %d exited %d: %s'
                             % (mode, nworkers, proc.returncode,
                                out[-3000:]))
    reports = []
    for r in range(nworkers):
        with open(os.path.join(out_dir, 'rank%d.json' % r)) as f:
            reports.append(json.load(f))
    return wall, reports


def free_port_pair():
    """A port the OS picked whose successor is free too (the launcher
    puts the kv server on port + 1)."""
    import socket
    for _ in range(50):
        with socket.socket() as a:
            a.bind(('127.0.0.1', 0))
            port = a.getsockname()[1]
            with socket.socket() as b:
                try:
                    b.bind(('127.0.0.1', port + 1))
                except OSError:
                    continue
            return port
    raise AssertionError('no free port pair')


def _timed_method(torch, owner, name, into):
    """Wrap ``owner.name`` so each call's seconds, device synchronised
    before and after, land in ``into[name]``."""
    plain = getattr(owner, name)

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return plain(*a, **k)
        finally:
            torch.cuda.synchronize()
            into.setdefault(name, []).append(time.perf_counter() - t0)
    setattr(owner, name, timed)


def kv_worker(mode, out_dir):
    """One worker of kv-dist-sync ('sync') or kv-dist-async ('async',
    'async-fault'), started by tools/launch.py: Module.fit of the
    full-width ResNet-50 v2 (f32, BATCH rows a step on this rank, the
    card shared by every rank) through the store; writes rank<r>.json
    (step ms by part, launches, kvstore counters, the server's applies on
    rank 0) and, for 'sync', rank<r>.npz of the parameters."""
    import hashlib
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import convert, instrument, kvstore, resilience
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.ops import fused, fused_conv
    os.environ['MXTPU_FUSE'] = 'aggressive'
    instrument.set_metrics(True)
    deterministic(torch, True)
    rank = int(os.environ['MXTPU_PROCESS_ID'])
    nranks = int(os.environ['MXTPU_NUM_PROCESSES'])
    steps = {'sync': KV_STEPS, 'async': KV_ASYNC_STEPS,
             'async-fault': KV_FAULT_STEPS}[mode]
    symbol = resnet.get_symbol(num_classes=1000, num_layers=50,
                               image_shape=IMAGE)
    arg, aux = convert.random_params(symbol, {'data': (BATCH,) + IMAGE},
                                     SEED)
    x, y = kv_data(BATCH * nranks * steps)
    rows = kv_rows(BATCH * nranks, nranks, rank, steps)
    if mode == 'async-fault' and rank == 1:
        resilience.set_faults(KV_FAULT)
    times = {}
    store = kvstore.DistKVStore if mode == 'sync' else \
        kvstore.DistAsyncKVStore
    kernels = (fused.fused_scale_bias_dot,
               fused_conv.fused_scale_bias_conv3x3, fused.fused_bn_relu)
    pushed = [0]

    def timed(name, plain):
        """The store's ``name``, counting the keys pushed and timing the
        step's list calls (the seeding pulls one key a call)."""
        def run(self, key, *a, **k):
            many = isinstance(key, (list, tuple))
            if name == 'push':
                pushed[0] += len(key) if many else 1
            if not many:
                return plain(self, key, *a, **k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return plain(self, key, *a, **k)
            finally:
                torch.cuda.synchronize()
                times.setdefault(name, []).append(time.perf_counter() - t0)
        return run
    store.push = timed('push', store.push)
    store.pull = timed('pull', store.pull)
    mod = mx.mod.Module(symbol, context=mx.gpu(0))
    _timed_method(torch, mod, 'forward_backward', times)
    steps_s, last = [], [0.0]

    def tick(_):
        torch.cuda.synchronize()
        now = time.perf_counter()
        steps_s.append(now - last[0])
        last[0] = now
    counters = ('kvstore.retries', 'kvstore.reconnects',
                'kvstore.push_replays', 'kvstore.push_bytes',
                'kvstore.pull_bytes', 'kvstore.pushes', 'kvstore.pulls')
    c0 = {k: instrument.counter_value(k) for k in counters}
    for k in kernels:
        reset_launches(k)
    t0 = last[0] = time.perf_counter()
    mod.fit(mx.io.NDArrayIter(x[rows], y[rows], batch_size=BATCH),
            num_epoch=1, kvstore='dist_sync' if mode == 'sync'
            else 'dist_async', optimizer='sgd', batch_end_callback=tick,
            optimizer_params=dict(SGD_MOMENTUM), eval_metric='acc',
            arg_params={k: mx.nd.array(v) for k, v in arg.items()},
            aux_params={k: mx.nd.array(v) for k, v in aux.items()})
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {getattr(k, '__name__', str(k)): k.launches for k in kernels}
    kv = mod._kvstore
    params = numpy_params(mod)
    digest = hashlib.sha256()
    for k in sorted(params):
        digest.update(params[k].tobytes())
    report = {
        'rank': rank, 'ranks': nranks, 'mode': mode, 'steps': steps,
        'rows_per_step': BATCH, 'fit_s': fit_s, 'step_s': steps_s,
        'images_per_s': steps * BATCH / fit_s,
        'backend': getattr(kv, 'backend', None),
        'launches': launches,
        'ms': {k: [t * 1e3 for t in v] for k, v in times.items()},
        'counters': {k: instrument.counter_value(k) - c0[k]
                     for k in counters},
        'keys_pushed': pushed[0], 'params_sha256': digest.hexdigest(),
        'param_bytes': int(sum(v.nbytes for v in params.values()))}
    if mode == 'sync':
        np.savez(os.path.join(out_dir, 'rank%d.npz' % rank), **params)
    else:
        if rank == 0:
            report['server_applied'] = kv._server.applied_pushes
        resilience.clear_faults()
        # every rank has read its counters before rank 0 stops the server
        kv.barrier()
        report['undelivered'] = kv.close()
    if mode == 'sync' and nranks > 1:
        import torch.distributed as dist
        dist.barrier()
        dist.destroy_process_group()
    with open(os.path.join(out_dir, 'rank%d.json' % rank), 'w') as f:
        json.dump(report, f)
    print('kv worker %s rank %d of %d done' % (mode, rank, nranks),
          flush=True)
    return 0


def _split(report, parts):
    """Median ms of a step's parts from a worker report."""
    return {p: statistics.median(report['ms'][p]) if report['ms'].get(p)
            else None for p in parts}


def kv_worker_launches(where, reps, bn_relu_nodes):
    """Each worker's launches of #1, #4 and #2 against its steps times one
    executor's 36 / 16 / ``bn_relu_nodes``; returns their sum by kernel."""
    per_step = {'fused_scale_bias_dot': 36, 'fused_scale_bias_conv3x3': 16,
                'fused_bn_relu': bn_relu_nodes}
    total = {}
    for r in reps:
        for name, n in per_step.items():
            got = r['launches'].get(name)
            if got != n * r['steps']:
                raise AssertionError(
                    '%s rank %d: %s launched %s times in %d steps '
                    '(expected %d)' % (where, r['rank'], name, got,
                                       r['steps'], n * r['steps']))
            total[name] = total.get(name, 0) + got
    return total


def kv_dist_sync(mx, torch, symbol, arg, aux, one_params, bn_relu_nodes,
                 tmp):
    """kv-dist-sync: tools/launch.py -n 1 (NCCL, one rank, so no
    collective runs: the reference's one-process dist_sync) and -n 2
    (both ranks on the one card: gloo over CUDA tensors), KV_STEPS steps
    of BATCH rows a rank.  -n 1 is held against kv-local's one-context fit
    at 32 rows (the same rows); the two -n 2 ranks must be bit for bit
    equal, and equal the per-slice arithmetic of 64-row global batches
    (kv_slice_oracle: each process normalises its own rows)."""
    out, launches = {}, {}
    for n in (1, 2):
        d = os.path.join(tmp, 'kv-sync-%d' % n)
        os.makedirs(d)
        wall, reps = kv_cluster(n, 'sync', d)
        params = [dict(np.load(os.path.join(d, 'rank%d.npz' % r)))
                  for r in range(n)]
        row = {'wall_s': wall, 'backend': reps[0]['backend'],
               'launches': reps[0]['launches'],
               'images_per_s_per_rank': [r['images_per_s'] for r in reps],
               'step_ms_median': [_split(r, ('forward_backward', 'push',
                                             'pull')) for r in reps],
               'push_bytes_per_step': reps[0]['counters'][
                   'kvstore.push_bytes'] / KV_STEPS,
               'param_bytes': reps[0]['param_bytes']}
        if n == 1:
            row['max_rel_vs_one_context_fit'] = max_rel(params[0],
                                                        one_params)
            if not row['max_rel_vs_one_context_fit'] <= 1e-4:
                raise AssertionError('kv-dist-sync -n 1: %.3g from the '
                                     'one-context fit'
                                     % row['max_rel_vs_one_context_fit'])
        else:
            if reps[0]['params_sha256'] != reps[1]['params_sha256']:
                raise AssertionError('kv-dist-sync -n 2: the ranks differ')
            x, y = kv_data(BATCH * 2 * KV_STEPS)
            deterministic(torch, True)     # as in the workers
            want = kv_slice_oracle(mx, torch, symbol, arg, aux, x, y,
                                   2 * BATCH, 2, KV_STEPS)
            deterministic(torch, False)
            row['ranks_bit_for_bit'] = True
            row['max_rel_vs_slice_arithmetic'] = max_rel(params[0], want)
            row['bit_for_bit_vs_slice_arithmetic'] = all(
                np.array_equal(params[0][k], want[k]) for k in want)
            if not row['max_rel_vs_slice_arithmetic'] <= KV_RTOL:
                raise AssertionError(
                    'kv-dist-sync -n 2: %.3g from the per-slice arithmetic'
                    % row['max_rel_vs_slice_arithmetic'])
        out['n%d' % n] = row
        for k, v in kv_worker_launches('kv-dist-sync -n %d' % n, reps,
                                       bn_relu_nodes).items():
            launches[k] = launches.get(k, 0) + v
    return out, launches


def kv_dist_async(bn_relu_nodes, tmp):
    """kv-dist-async: tools/launch.py -n 2, two workers sharing the card,
    KV_ASYNC_STEPS steps of BATCH rows each, rank 0 hosting the server;
    then the fault run (KV_FAULT on rank 1, KV_FAULT_STEPS steps): the
    server's applies must equal the pushes sent."""
    out, launches = {}, {}
    for mode in ('async', 'async-fault'):
        d = os.path.join(tmp, 'kv-%s' % mode)
        os.makedirs(d)
        wall, reps = kv_cluster(2, mode, d)
        steps = reps[0]['steps']
        sent = sum(r['keys_pushed'] for r in reps)
        applied = reps[0]['server_applied']
        row = {
            'wall_s': wall, 'steps': steps,
            'images_per_s_per_worker': [r['images_per_s'] for r in reps],
            'step_ms_median': [_split(r, ('forward_backward', 'push',
                                          'pull')) for r in reps],
            'push_mb_per_s': [r['counters']['kvstore.push_bytes'] / 1e6 /
                              r['fit_s'] for r in reps],
            'pull_mb_per_s': [r['counters']['kvstore.pull_bytes'] / 1e6 /
                              r['fit_s'] for r in reps],
            'pushes_sent': sent, 'server_applied': applied,
            'retries': [r['counters']['kvstore.retries'] for r in reps],
            'reconnects': [r['counters']['kvstore.reconnects']
                           for r in reps],
            'push_replays': [r['counters']['kvstore.push_replays']
                             for r in reps],
            'undelivered': [r['undelivered'] for r in reps],
            'launches': [r['launches'] for r in reps]}
        if applied != sent or any(row['undelivered']):
            raise AssertionError('kv-dist-async %s: %d applied of %d sent, '
                                 'undelivered %s' % (mode, applied, sent,
                                                     row['undelivered']))
        if mode == 'async' and any(row['retries']):
            raise AssertionError('kv-dist-async: retries %s'
                                 % row['retries'])
        if mode == 'async-fault' and (row['reconnects'][1] < 1 or
                                      row['push_replays'][1] < 1):
            raise AssertionError('kv-dist-async fault run: no reconnect or '
                                 'replay on rank 1: %s' % row)
        for k, n in kv_worker_launches('kv-dist-async %s' % mode, reps,
                                       bn_relu_nodes).items():
            launches[k] = launches.get(k, 0) + n
        out[mode] = row
    return out, launches


def feed_capture_phase():
    """feed-capture: tools/torch_feed_capture.py --lever in
    FEED_CAPTURE_CHILDREN child processes at once (3 small MLP fits each,
    the feed on, the previous fit's module collected inside each
    recording): 0 red."""
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, 'tools'))
    try:
        import torch_feed_capture
    finally:
        sys.path.pop(0)
    t0 = time.monotonic()
    summary = torch_feed_capture.run(
        FEED_CAPTURE_CHILDREN, 3, FEED_CAPTURE_CHILDREN, False, True,
        root=root, timeout=120, lever=True)
    report = {'red': summary['red'], 'children': summary['children'],
              'fits': summary['fits'], 'lever': True, 'feed': True,
              'seconds': time.monotonic() - t0,
              'graph_resets_in_capture': sum(
                  r['graph_resets_in_capture'] for r in summary['runs']),
              'errors': [r['error'] for r in summary['runs'] if r['error']]}
    if summary['red']:
        raise AssertionError('feed-capture: %d of %d children red: %s'
                             % (summary['red'], summary['children'],
                                report['errors']))
    return report


# -- the dp x tp mesh (mesh-fit, mesh-ranks) --------------------------------
MESH_STEPS = 4              # mesh-fit: captured steps of each fit
MESH_RANK_STEPS = 3         # mesh-ranks: eager steps of each job
# one launch of ranks per world size, its meshes fit one after another
MESH_RANKS = ((('2x1', 'replicated'), ('1x2', 'auto')),
              (('2x2', 'auto'),))
MESH_TIMEOUT = 300          # seconds, each launcher run and child


def mesh_data(rows):
    """The mesh phases' images and labels: the same rows in every
    process."""
    rng = np.random.default_rng(SEED + 23)
    x = rng.standard_normal((rows,) + IMAGE, dtype=np.float32)
    y = rng.integers(0, 1000, rows).astype(np.float32)
    return x, y


def mesh_fit_run(mx, torch, symbol, arg, aux, x, y, kernels, dtype=None,
                 **fit_kw):
    """One ``Module.fit`` of ``symbol`` at BATCH rows a global batch (SGD
    lr 0.05 momentum 0.9 wd 1e-4, metrics acc and ce), a synchronise
    after each step.  Returns the module, each step's host seconds, the
    launches per step by kernel and the fit's launches by kernel (counts
    zeroed just before the fit, read just after) and the metric's
    reading."""
    times, last = [], [0.0]

    def tick(_):
        torch.cuda.synchronize()
        now = time.perf_counter()
        times.append(now - last[0])
        last[0] = time.perf_counter()
    for k in kernels:
        reset_launches(k)
    counts0 = launch_counts(kernels)
    metric = mx.metric.create(['acc', 'ce'])
    mod = mx.mod.Module(symbol, context=mx.gpu(0), compute_dtype=dtype)
    last[0] = time.perf_counter()
    mod.fit(mx.io.NDArrayIter(x, y, batch_size=BATCH), num_epoch=1,
            eval_metric=metric, optimizer='sgd',
            optimizer_params=dict(SGD_MOMENTUM), batch_end_callback=tick,
            arg_params={k: mx.nd.array(v) for k, v in arg.items()},
            aux_params={k: mx.nd.array(v) for k, v in aux.items()},
            **fit_kw)
    torch.cuda.synchronize()
    counts = launch_counts(kernels)
    per_step = launches_per_step(counts0, counts, len(times))
    totals = {k: n - counts0[k][0] for k, (n, _) in counts.items()}
    return mod, times, per_step, totals, metric.get_name_value()


def mesh_state(mod):
    args, auxs = mod.get_params()
    out = {'arg:' + k: v.asnumpy() for k, v in args.items()}
    out.update({'aux:' + k: v.asnumpy() for k, v in auxs.items()})
    return out


def mesh_launches_ok(per_step, expected):
    return {k: per_step.get(k, {}).get('all') for k in expected} == \
        {k: float(v) for k, v in expected.items()}


def mesh_warm_child():
    """The second process of mesh-fit's warm start
    (``--mesh-warm-child``): the '1x1' fit of ResNet-50 v2 (bf16, BATCH
    rows, MESH_STEPS steps) with ``MXTPU_WARM_START`` over the
    ``MXTPU_COMPILE_CACHE`` whose manifest its parent's '1x1' fit wrote.
    Prints one JSON line: the captures on the hot path and in the warm
    start, the parameters' digest."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import compile_cache, convert, instrument
    from mxnet_tpu_torch.models import resnet
    os.environ['MXTPU_FUSE'] = 'aggressive'
    deterministic(torch, True)
    instrument.set_metrics(True)
    symbol = resnet.get_symbol(num_classes=1000, num_layers=50,
                               image_shape=IMAGE)
    arg, aux = convert.random_params(symbol, {'data': (BATCH,) + IMAGE},
                                     SEED)
    x, y = mesh_data(BATCH * MESH_STEPS)
    before = _warm_counters(instrument)
    mod, times, _, _, _ = mesh_fit_run(
        mx, torch, symbol, arg, aux, x, y, (), dtype=torch.bfloat16,
        mesh='1x1', partition='auto')
    after = _warm_counters(instrument)
    metas = sorted({json.dumps(e.get('meta', {}).get('mesh'))
                    for e in compile_cache.manifest_entries('fit_step')})
    log({'warm_start': bool(os.environ.get('MXTPU_WARM_START')),
         'hot_path_captures': after['compile.traces']
         - before['compile.traces'],
         'warmup_traces': after['compile.warmup_traces']
         - before['compile.warmup_traces'],
         'captured': all(c.captured for c in mod._graphs.values()),
         'step_ms': [t * 1e3 for t in times], 'manifest_meshes': metas,
         'params_sha256': _digest(mesh_state(mod))})
    return 0


def mesh_warm(cache, digest):
    """The '1x1' fit again in a second process, with ``MXTPU_WARM_START``
    over the ``MXTPU_COMPILE_CACHE`` (``cache``) this process's '1x1' fit
    wrote: it takes no capture on the hot path and ends bit for bit where
    this process's fit did (``digest``)."""
    env = dict(os.environ, MXTPU_COMPILE_CACHE=cache, MXTPU_WARM_START='1')
    t0 = time.monotonic()
    done = subprocess.run(
        [sys.executable, os.path.abspath(__file__), '--mesh-warm-child'],
        env=env, capture_output=True, text=True, timeout=MESH_TIMEOUT)
    if done.returncode != 0:
        print(done.stdout[-4000:], done.stderr[-6000:], file=sys.stderr)
        raise AssertionError('mesh-fit: the warm child exited %d'
                             % done.returncode)
    warm = json.loads(done.stdout.strip().splitlines()[-1])
    warm['process_s'] = time.monotonic() - t0
    if warm['hot_path_captures'] != 0 or warm['warmup_traces'] < 1 or \
            not warm['captured'] or warm['params_sha256'] != digest or \
            warm['manifest_meshes'] != ['"dp=1,tp=1|auto"']:
        raise AssertionError('mesh-fit warm start: %s (this process\'s '
                             'digest %s)' % (warm, digest))
    return warm


def mesh_fit(mx, torch, symbol, arg, aux, kernels, expected, tmp):
    """mesh-fit: ResNet-50 v2 (bf16 compute over f32 masters, BATCH rows,
    MESH_STEPS captured steps, cuDNN deterministic) unmeshed, then
    ``fit(mesh='1x1', partition='auto')``: parameters, aux and the metric
    bit for bit, #1/#4/#2 at 36/16/2 a step from replays in both, each
    fit's step ms.  The '1x1' fit runs over an ``MXTPU_COMPILE_CACHE``,
    so this process is the warm start's cold one; then a second process
    warms from its manifest (:func:`mesh_warm`)."""
    from mxnet_tpu_torch import compile_cache
    deterministic(torch, True)
    x, y = mesh_data(BATCH * MESH_STEPS)
    cache = os.path.join(tmp, 'mesh-cache')
    runs, states, launches = {}, {}, dict.fromkeys(expected, 0)
    for name, kw in (('unmeshed', {}),
                     ('1x1', {'mesh': '1x1', 'partition': 'auto'})):
        fresh_memory(torch)
        if name == '1x1':
            os.environ['MXTPU_COMPILE_CACHE'] = cache
        try:
            mod, times, per_step, totals, metric = mesh_fit_run(
                mx, torch, symbol, arg, aux, x, y, kernels,
                dtype=torch.bfloat16, **kw)
        finally:
            os.environ.pop('MXTPU_COMPILE_CACHE', None)
        if name == '1x1' and compile_cache.cache_dir() != cache:
            raise AssertionError('mesh-fit: the 1x1 fit wrote to the '
                                 'compile cache %r, not %r'
                                 % (compile_cache.cache_dir(), cache))
        if not mesh_launches_ok(per_step, expected):
            raise AssertionError('mesh-fit %s: launches per step %s, '
                                 'expected %s' % (name, per_step, expected))
        caps = list(mod._graphs.values())
        if not caps or not all(c.captured for c in caps):
            raise AssertionError('mesh-fit %s: the step was not captured: %s'
                                 % (name, graph_report(caps)))
        for k in expected:
            launches[k] += totals[k]
        states[name] = mesh_state(mod)
        runs[name] = {'step_ms': [t * 1e3 for t in times],
                      'step_ms_median_after_first':
                          statistics.median(times[1:]) * 1e3,
                      'launches_per_step': per_step, 'metric': metric,
                      'graphs': graph_report(caps),
                      'mesh_sig': mod._mesh_sig, **memory(torch)}
        del mod
    bad = [k for k in states['unmeshed']
           if not np.array_equal(states['unmeshed'][k], states['1x1'][k])]
    if bad or runs['unmeshed']['metric'] != runs['1x1']['metric']:
        raise AssertionError('mesh-fit: 1x1 is not the unmeshed fit bit for '
                             'bit: %d arrays differ (%s), metric %s vs %s'
                             % (len(bad), bad[:4], runs['1x1']['metric'],
                                runs['unmeshed']['metric']))
    warm = mesh_warm(cache, _digest(states['1x1']))
    deterministic(torch, False)
    return {'runs': runs, 'bit_for_bit': True, 'warm_start': warm,
            'steps': MESH_STEPS, 'rows': BATCH}, launches


def mesh_worker(out_dir, cases):
    """One rank of mesh-ranks (``--mesh-worker out_dir mesh:part,...``),
    started by tools/launch.py, every rank on the one card (gloo): for
    each case, Module.fit of ResNet-50 v2 (f32, TF32 off, cuDNN
    deterministic) over the global batch of BATCH rows with that
    ``mesh=``/``partition=``, MESH_RANK_STEPS eager steps, MXTPU_COMMWATCH
    on.  Writes rank<r>.json (per case: step seconds, the last step's
    collectives by kind with their seconds, launches, the resident
    optimizer state by leaf)
    and, on rank 0, <mesh>_<part>.npz of the parameters and aux."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import commwatch, convert
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.ops import fused, fused_conv
    from mxnet_tpu_torch.parallel import collectives
    os.environ['MXTPU_FUSE'] = 'aggressive'
    os.environ['MXTPU_COMMWATCH'] = '1'
    deterministic(torch, True)
    backend = collectives.init_distributed()
    rank, nranks = collectives.rank(), collectives.world_size()
    symbol = resnet.get_symbol(num_classes=1000, num_layers=50,
                               image_shape=IMAGE)
    arg, aux = convert.random_params(symbol, {'data': (BATCH,) + IMAGE},
                                     SEED)
    x, y = mesh_data(BATCH * MESH_RANK_STEPS)
    kernels = (fused.fused_scale_bias_dot,
               fused_conv.fused_scale_bias_conv3x3, fused.fused_bn_relu)
    report = {'rank': rank, 'ranks': nranks, 'backend': backend,
              'cases': {}}
    for case in cases.split(','):
        mesh, partition = case.split(':')
        commwatch.clear_programs()
        t0 = time.perf_counter()
        mod, times, _, totals, metric = mesh_fit_run(
            mx, torch, symbol, arg, aux, x, y, kernels, mesh=mesh,
            partition=partition)
        fit_s = time.perf_counter() - t0
        (row,) = commwatch.programs()
        state = mesh_state(mod)
        report['cases'][case] = {
            'rank': rank, 'mesh': mesh, 'partition': partition,
            'coords': list(mod._mesh_plan.mesh.coords),
            'fit_s': fit_s, 'step_s': times, 'metric': metric,
            'launches': totals,
            'comm': row, 'tp_dims': mod._fused.zero.tp_dims,
            'opt_leaf_bytes': {n: [t.numel() * t.element_size() for t in
                                   (s if isinstance(s, tuple) else (s,))
                                   if t is not None]
                               for n, s in mod._fused_opt_state.items()},
            'param_shapes': {n: list(v.shape) for n, v in arg.items()},
            'params_sha256': _digest(state)}
        if rank == 0:
            np.savez(os.path.join(out_dir, '%s_%s.npz' % (mesh, partition)),
                     **state)
        del mod
    collectives.host_barrier()
    import torch.distributed as dist
    dist.destroy_process_group()
    with open(os.path.join(out_dir, 'rank%d.json' % rank), 'w') as f:
        json.dump(report, f)
    print('mesh worker %s rank %d of %d done' % (cases, rank, nranks),
          flush=True)
    return 0


def mesh_bn_payloads(mx, symbol):
    """The BatchNorm statistics a training step all-reduces over dp: per
    node of the aggressive training program that computes them
    (BatchNorm, and the fused _bn_relu / _bn_relu_conv, one computation
    each: a BatchNorm whose output feeds two fused convs is computed in
    both), its sums of x and x^2 (8C bytes), once in the forward and once
    more in the backward unless its input is the data (no gradient)."""
    prog = mx.fuse.apply_fuse_passes(symbol, True, 'aggressive')
    arg_shapes = dict(zip(prog.list_arguments(),
                          prog.infer_shape(data=(BATCH,) + IMAGE)[0]))
    out = []
    for node in prog.topo_nodes():
        if node.is_variable or node.op not in ('BatchNorm', '_bn_relu',
                                               '_bn_relu_conv'):
            continue
        gamma = [src.name for src, _ in node.inputs if src.is_variable and
                 src.name.endswith('_gamma')][0]
        src0 = node.inputs[0][0]
        out.append((8 * arg_shapes[gamma][0],
                    not (src0.is_variable and src0.name == 'data')))
    return out


def mesh_ranks_case(mx, reps, state, one_state, noise, bn, expected, mesh,
                    part):
    """One mesh of mesh-ranks held (see :func:`mesh_ranks`): ``reps`` the
    ranks' reports, ``state`` rank 0's parameters and aux.  Returns the
    report row and the launches of #1/#4/#2 by kernel."""
    axes = mx.parallel.mesh.parse_mesh_spec(mesh)
    dp, tp = axes['dp'], axes['tp']
    failures, launches = [], dict.fromkeys(expected, 0)
    if len({r['params_sha256'] for r in reps}) != 1:
        failures.append('the ranks\' parameters differ')
    rel = max_rel(state, one_state)
    if not rel <= KV_NOISE_FACTOR * noise:
        failures.append('%.3g from the 1x1 fit, past %g times the f32 '
                        'noise floor %.3g' % (rel, KV_NOISE_FACTOR, noise))
    want_bn = sum(2.0 * (dp - 1) / dp * b * (2 if twice else 1)
                  for b, twice in bn)
    for r in reps:
        steps = len(r['step_s'])
        for k, n in expected.items():
            if r['launches'].get(k) != n * steps:
                failures.append('rank %d: %s launched %s in %d steps'
                                % (r['rank'], k, r['launches'].get(k),
                                   steps))
            launches[k] += r['launches'].get(k, 0)
        padded = sharded = 0
        for name, shape in r['param_shapes'].items():
            size = int(np.prod(shape))
            owned = size // tp if r['tp_dims'][name] is not None else size
            padded += -(-owned // dp) * dp * 4
            sharded += size * 4 if r['tp_dims'][name] is not None else 0
            if r['opt_leaf_bytes'][name] != [-(-owned // dp) * 4]:
                failures.append('rank %d: %s holds %s optimizer bytes, '
                                'expected %d of %d' % (
                                    r['rank'], name,
                                    r['opt_leaf_bytes'][name],
                                    -(-owned // dp) * 4, size * 4))
        kinds = r['comm']['collectives']
        # the all-gathers: the ZeRO one over dp and the tp one
        zero_wire = kinds.get('reduce-scatter', {}).get('wire_bytes', 0.0) \
            + kinds.get('all-gather', {}).get('wire_bytes', 0.0) \
            - sharded * (tp - 1) / tp
        want_zero = 2.0 * (dp - 1) / dp * padded
        got_bn = kinds.get('all-reduce', {}).get('wire_bytes', 0.0)
        if abs(zero_wire - want_zero) > 1e-6 * max(want_zero, 1.0) or \
                abs(got_bn - want_bn) > 1e-6 * max(want_bn, 1.0):
            failures.append('rank %d: wire bytes a step: ZeRO %r (ring '
                            'formula %r), BatchNorm %r (%r)'
                            % (r['rank'], zero_wire, want_zero, got_bn,
                               want_bn))
    if failures:
        raise AssertionError('mesh-ranks %s %s: %s'
                             % (mesh, part, '; '.join(failures)))
    split = []
    for r in reps:
        ms = statistics.median(r['step_s'][1:]) * 1e3
        sec = {k: v['seconds'] * 1e3
               for k, v in r['comm']['collectives'].items()}
        split.append({'step_ms': ms,
                      'reduce_scatter_ms': sec.get('reduce-scatter', 0.0),
                      'all_gather_ms': sec.get('all-gather', 0.0),
                      'bn_all_reduce_ms': sec.get('all-reduce', 0.0),
                      'compute_ms': ms - sum(sec.values())})
    return {'ranks': dp * tp,
            'max_rel_vs_1x1': rel, 'split_median_after_first': split,
            'bytes_per_step': reps[0]['comm']['wire_bytes_per_step'],
            'zero_ring_formula_bytes': want_zero,
            'bn_ring_formula_bytes': want_bn,
            'opt_state_bytes_per_rank': [sum(sum(b) for b in
                                             r['opt_leaf_bytes'].values())
                                         for r in reps],
            'collectives': reps[0]['comm']['collectives'],
            'metric': reps[0]['metric'],
            'coords': [r['coords'] for r in reps]}, launches


def mesh_ranks(mx, torch, symbol, arg, aux, kernels, expected, tmp):
    """mesh-ranks: ResNet-50 v2 f32 over meshes of ranks sharing the card
    on gloo (tools/launch.py over ``--mesh-worker``), MESH_RANK_STEPS eager
    steps of the global batch of BATCH rows each.  Held: every rank's
    #1/#4/#2 launches (36/16/2 a rank step); every rank's parameters and
    aux equal and within KV_NOISE_FACTOR times the f32 noise floor of a
    one-process '1x1' eager fit over the same rows, the floor measured
    here (the '1x1' fit over every batch's rows in another order); each
    rank's resident optimizer state (1/dp of every leaf, 1/(dp*tp) of a
    tp-sharded one); the step's collectives against the ring formula:
    the ZeRO pair 2(dp-1)/dp of the padded owned parameter bytes, the tp
    all-gather (tp-1)/tp of the tp-sharded bytes, the BatchNorm
    all-reduces 2(dp-1)/dp of their payloads; '1x1' moves 0 bytes.  The
    step ms split into compute, reduce-scatter, all-gather and the
    BatchNorm all-reduce (commwatch times each collective with the card
    synchronised around it)."""
    from mxnet_tpu_torch import commwatch, instrument
    deterministic(torch, True)
    x, y = mesh_data(BATCH * MESH_RANK_STEPS)
    set_engine(mx, True)
    os.environ['MXTPU_COMMWATCH'] = '1'
    try:
        fresh_memory(torch)
        one, one_s, one_launches, _, _ = mesh_fit_run(
            mx, torch, symbol, arg, aux, x, y, kernels, mesh='1x1',
            partition='auto')
        one_bytes = instrument.metrics_snapshot()['gauges'].get(
            'comm.bytes_per_step')
    finally:
        os.environ.pop('MXTPU_COMMWATCH')
        commwatch.refresh()
    if one_bytes != 0.0:
        raise AssertionError('mesh-ranks: 1x1 moved %r bytes a step'
                             % one_bytes)
    one_state = mesh_state(one)
    del one
    order = np.concatenate([b * BATCH + np.random.default_rng(
        SEED + 24).permutation(BATCH) for b in range(MESH_RANK_STEPS)])
    fresh_memory(torch)
    other, _, _, _, _ = mesh_fit_run(mx, torch, symbol, arg, aux,
                                     x[order], y[order], kernels,
                                     mesh='1x1')
    noise = max_rel(mesh_state(other), one_state)
    del other
    set_engine(mx, False)
    deterministic(torch, False)
    bn = mesh_bn_payloads(mx, symbol)
    out, launches = {}, dict.fromkeys(expected, 0)
    for cases in MESH_RANKS:
        (nranks,) = {int(np.prod(list(mx.parallel.mesh.parse_mesh_spec(
            m).values()))) for m, _ in cases}
        d = os.path.join(tmp, 'mesh-%d' % nranks)
        os.makedirs(d)
        spec = ','.join('%s:%s' % c for c in cases)
        wall, reports = kv_cluster(nranks, 'mesh %s' % spec, d,
                                   flag='--mesh-worker', argv=[d, spec])
        for mesh, part in cases:
            reps = [r['cases']['%s:%s' % (mesh, part)] for r in reports]
            state = dict(np.load(os.path.join(d, '%s_%s.npz'
                                              % (mesh, part))))
            row, case_launches = mesh_ranks_case(
                mx, reps, state, one_state, noise, bn, expected, mesh,
                part)
            row.update(wall_s=wall, backend=reports[0]['backend'],
                       param_bytes=int(sum(v.nbytes for v in arg.values())))
            out['%s_%s' % (mesh, part)] = row
            for k, v in case_launches.items():
                launches[k] += v
    return {'steps': MESH_RANK_STEPS, 'rows': BATCH, 'dtype': 'float32',
            'noise_floor_max_rel': noise, 'noise_factor': KV_NOISE_FACTOR,
            'one_1x1_step_ms_median_after_first':
                statistics.median(one_s[1:]) * 1e3,
            'one_1x1_launches_per_step': one_launches,
            'one_1x1_bytes_per_step': one_bytes,
            'meshes': out}, launches


# -- the image input pipeline: RecordIO, the native decode, ImageRecordIter --
REC_IMAGES = 1280           # imagenet-rec: 40 batches of BATCH
REC_QUALITY = 95            # tools/im2rec.py's default
REC_MEAN = {'mean_r': 123.68, 'mean_g': 116.779, 'mean_b': 103.939}
REC_THREADS = 4             # examples/train_imagenet.py's default
REC_HEAVY = {'max_rotate_angle': 10, 'max_shear_ratio': 0.1,
             'max_aspect_ratio': 0.25, 'random_h': 36, 'random_s': 50,
             'random_l': 50, 'min_random_scale': 0.533,
             'max_random_scale': 1.0}


def rec_image(torch, rng):
    """One smooth ImageNet-shaped RGB image (uint8 HWC) made on the card:
    short side 256-480, aspect 3:4-4:3, linear gradients, a low-frequency
    texture and four soft-edged ellipses of random colours, all drawn from
    ``rng``."""
    short = int(rng.integers(256, 481))
    aspect = float(rng.uniform(3 / 4, 4 / 3))
    h, w = (short, int(round(short * aspect))) if aspect >= 1 else \
        (int(round(short / aspect)), short)
    yy = torch.linspace(0, 1, h, device='cuda')[:, None]
    xx = torch.linspace(0, 1, w, device='cuda')[None, :]
    p = torch.from_numpy(rng.uniform(size=(3, 6)).astype(np.float32)) \
        .cuda()[:, :, None, None]
    img = (40 + 170 * p[:, 0] + 60 * (p[:, 1] - 0.5) * xx
           + 60 * (p[:, 2] - 0.5) * yy
           + 18 * torch.sin(6.2832 * (1 + 4 * p[:, 3]) * xx
                            + 6.2832 * (1 + 4 * p[:, 4]) * yy
                            + 6.2832 * p[:, 5]))
    for e in rng.uniform(size=(4, 7)).astype(np.float32):
        d = ((xx - e[0]) / (0.05 + 0.3 * e[2])) ** 2 + \
            ((yy - e[1]) / (0.05 + 0.3 * e[3])) ** 2
        a = torch.sigmoid((1 - d) * 12)
        color = torch.tensor(255 * e[4:7], device='cuda')[:, None, None]
        img = img * (1 - a) + color * a
    return img.clamp(0, 255).round().to(torch.uint8).permute(1, 2, 0) \
        .contiguous().cpu().numpy()


def rec_write(mx, torch, path_rec, path_idx):
    """imagenet-rec's .rec/.idx: REC_IMAGES JPEGs at REC_QUALITY through
    the port's pack_img (its native encoder, on every host core) and
    MXIndexedRecordIO; labels 0-999.  The seconds and bytes of each part."""
    from concurrent.futures import ThreadPoolExecutor
    rng = np.random.default_rng(SEED + 31)
    labels = rng.integers(0, 1000, REC_IMAGES)
    t0 = time.monotonic()
    images = [rec_image(torch, rng) for _ in range(REC_IMAGES)]
    made_s = time.monotonic() - t0
    t0 = time.monotonic()

    def packed(i):
        return mx.recordio.pack_img(
            mx.recordio.IRHeader(0, float(labels[i]), i, 0), images[i],
            quality=REC_QUALITY)
    with ThreadPoolExecutor(os.cpu_count()) as pool:
        records = list(pool.map(packed, range(REC_IMAGES)))
    encode_s = time.monotonic() - t0
    t0 = time.monotonic()
    writer = mx.recordio.MXIndexedRecordIO(path_idx, path_rec, 'w')
    for i, rec in enumerate(records):
        writer.write_idx(i, rec)
    writer.close()
    shorts = [min(im.shape[:2]) for im in images]
    return {'images': REC_IMAGES, 'make_s': made_s, 'encode_s': encode_s,
            'write_s': time.monotonic() - t0,
            'rec_bytes': os.path.getsize(path_rec),
            'mean_jpeg_bytes': float(np.mean([len(r) for r in records])),
            'short_side_min_max': [min(shorts), max(shorts)],
            'pixels_mean': float(np.mean([im.shape[0] * im.shape[1]
                                          for im in images]))}


def rec_iter(mx, path_rec, threads, **kw):
    return mx.io.ImageRecordIter(
        path_imgrec=path_rec, data_shape=IMAGE, batch_size=BATCH,
        preprocess_threads=threads, seed=SEED, **kw)


def rec_rate(mx, path_rec, threads, heavy):
    """The iterator alone: images/s over one epoch (the producer restarted
    just before the clock starts), REC_MEAN with rand_crop and
    rand_mirror, and the heavy augmenter knobs when ``heavy``."""
    kw = dict(REC_MEAN, rand_crop=True, rand_mirror=True,
              **(REC_HEAVY if heavy else {}))
    it = rec_iter(mx, path_rec, threads, **kw)
    it.reset()
    t0 = time.monotonic()
    n, finite = 0, True
    for batch in it:
        n += batch.data[0].shape[0]
        finite = finite and bool(np.isfinite(
            batch.data[0].asnumpy()[:, :, ::37, ::37]).all())
    wall = time.monotonic() - t0
    it.close()
    return {'threads': threads, 'augment': 'heavy' if heavy else 'off',
            'images': n, 'seconds': wall, 'images_per_s': n / wall,
            'finite': finite}


def rec_fit_run(mx, torch, symbol, arg, aux, data_iter, kernels):
    """One ``Module.fit`` of ResNet-50 v2 (bf16 over f32 masters, SGD
    lr 0.05 momentum 0.9 wd 1e-4, metrics acc and ce) over ``data_iter``
    for one epoch, a synchronise after each step: the module, each step's
    host seconds, the fit's wall seconds, the launches per step by kernel,
    the fit's launches by kernel (counts zeroed just before the fit, read
    just after) and the metric's reading."""
    times, last = [], [0.0]

    def tick(_):
        torch.cuda.synchronize()
        now = time.perf_counter()
        times.append(now - last[0])
        last[0] = time.perf_counter()
    for k in kernels:
        reset_launches(k)
    counts0 = launch_counts(kernels)
    metric = mx.metric.create(['acc', 'ce'])
    mod = mx.mod.Module(symbol, context=mx.gpu(0),
                        compute_dtype=torch.bfloat16)
    t0 = last[0] = time.perf_counter()
    mod.fit(data_iter, num_epoch=1, eval_metric=metric, optimizer='sgd',
            optimizer_params=dict(SGD_MOMENTUM), batch_end_callback=tick,
            arg_params={k: mx.nd.array(v) for k, v in arg.items()},
            aux_params={k: mx.nd.array(v) for k, v in aux.items()})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts(kernels)
    per_step = launches_per_step(counts0, counts, len(times))
    totals = {k: n - counts0[k][0] for k, (n, _) in counts.items()}
    return mod, times, wall, per_step, totals, metric.get_name_value()


_REC_STAGES = ('read', 'decode', 'batchify', 'prefetch_wait', 'feed_wait',
               'device_stage', 'window_wait')


def rec_stage_sums(instrument):
    out = {}
    for name in _REC_STAGES:
        h = instrument.histogram('iowatch.stage.' + name)
        out[name] = (h.sum, h.count)
    return out


def imagenet_rec(mx, torch, symbol, arg, aux, kernels, expected, tmp):
    """imagenet-rec: ResNet-50 v2 trained through ``Module.fit`` from a
    ``.rec`` of JPEGs, as ``examples/train_imagenet.py`` does.  Writes the
    .rec/.idx (rec_write), times the iterator alone at REC_THREADS and at
    the host's core count, augmenter off and heavy, then fits one epoch
    (captured, device feed on, pinned staging) over
    ``ImageRecordIter(shuffle, rand_crop, rand_mirror, REC_MEAN)`` with
    iowatch on, and the same fit over an ``NDArrayIter`` holding the
    batches a second iterator of the same seed produces: bit for bit
    (cuDNN deterministic, TF32 off).  The report and the launches by
    kernel of both fits."""
    from mxnet_tpu_torch import instrument, iowatch
    failures = []
    path_rec = os.path.join(tmp, 'imagenet.rec')
    path_idx = os.path.join(tmp, 'imagenet.idx')
    out = {'data': rec_write(mx, torch, path_rec, path_idx),
           'host_cores': os.cpu_count(),
           'codec': 'the port\'s baseline JPEG codec (csrc/host/jpeg.cc); '
                    'no libjpeg on this host'}
    rates = [rec_rate(mx, path_rec, n, heavy)
             for n in sorted({REC_THREADS, os.cpu_count()})
             for heavy in (False, True)]
    out['iterator'] = rates
    if not all(r['finite'] and r['images'] == REC_IMAGES for r in rates):
        failures.append('imagenet-rec iterator: %s' % rates)
    deterministic(torch, True)
    fit_kw = dict(REC_MEAN, shuffle=True, rand_crop=True, rand_mirror=True)
    launches = dict.fromkeys(expected, 0)
    pinned0 = instrument.counter_value('io.pinned_buffers')
    with knobs(MXTPU_IOWATCH=1):
        iowatch.refresh()
        stages0 = rec_stage_sums(instrument)
        it = rec_iter(mx, path_rec, REC_THREADS, **fit_kw)
        mod, times, wall, per_step, totals, metric = rec_fit_run(
            mx, torch, symbol, arg, aux, it, kernels)
        stages1 = rec_stage_sums(instrument)
        gp = iowatch.goodput_snapshot()
    iowatch.refresh()
    it.close()
    steps = len(times)
    if steps != REC_IMAGES // BATCH or not mesh_launches_ok(per_step,
                                                            expected):
        failures.append('imagenet-rec fit: %d steps, launches per step %s '
                        '(expected %s)' % (steps, per_step, expected))
    graphs = graph_report(mod._graphs.values())
    if len(graphs) != 1 or not graphs[0]['captured'] or \
            graphs[0]['replays'] != steps - 1:
        failures.append('imagenet-rec fit: not one replayed graph: %s'
                        % graphs)
    for k in expected:
        launches[k] += totals.get(k, 0)
    state = mesh_state(mod)
    if not all(np.all(np.isfinite(v)) for v in state.values()):
        failures.append('imagenet-rec fit: a parameter is not finite')
    del mod
    step_ms = statistics.median(times[TRAIN_WARMUP:]) * 1e3
    buckets = gp.get('buckets') or {}
    out['fit'] = {
        'steps': steps, 'preprocess_threads': REC_THREADS,
        'fit_wall_s': wall, 'images_per_s_fit_wall': REC_IMAGES / wall,
        'step_ms': [t * 1e3 for t in times],
        'step_ms_median_after_warmup': step_ms,
        'images_per_s_median_step': BATCH / step_ms * 1e3,
        'launches_per_step': per_step, 'graphs': graphs, 'metric': metric,
        'pinned_buffers_made': instrument.counter_value('io.pinned_buffers')
        - pinned0,
        'stage_s': {k: stages1[k][0] - stages0[k][0] for k in _REC_STAGES},
        'stage_samples': {k: stages1[k][1] - stages0[k][1]
                          for k in _REC_STAGES},
        'goodput_fraction': gp.get('fraction'),
        'goodput_wall_s': gp.get('wall_secs'),
        'goodput_buckets_s': buckets,
        'input_stall_share': (buckets.get('input_stall', 0.0)
                              / gp['wall_secs'] if gp.get('wall_secs')
                              else None)}
    # the twin: the very batches, from a second iterator of the same seed
    t0 = time.monotonic()
    xs, ys = [], []
    twin = rec_iter(mx, path_rec, os.cpu_count(), **fit_kw)
    for batch in twin:
        xs.append(batch.data[0].asnumpy())
        ys.append(batch.label[0].asnumpy())
    twin.close()
    collect_s = time.monotonic() - t0
    x, y = np.concatenate(xs), np.concatenate(ys)
    del xs, ys
    mod, ttimes, _, tper_step, ttotals, tmetric = rec_fit_run(
        mx, torch, symbol, arg, aux,
        mx.io.NDArrayIter(x, y, batch_size=BATCH), kernels)
    del x, y
    for k in expected:
        launches[k] += ttotals.get(k, 0)
    twin_state = mesh_state(mod)
    del mod
    diff = max(float(np.max(np.abs(state[k] - twin_state[k])))
               for k in state)
    bit = all(np.array_equal(state[k], twin_state[k]) for k in state) and \
        metric == tmetric
    out['exact'] = {'against': 'the same fit over an NDArrayIter holding '
                               'the batches a second ImageRecordIter of '
                               'the same seed produced',
                    'bit_for_bit': bit, 'max_abs_diff': diff,
                    'metric': metric, 'twin_metric': tmetric,
                    'twin_step_ms_median_after_warmup':
                        statistics.median(ttimes[TRAIN_WARMUP:]) * 1e3,
                    'collect_s': collect_s, 'cudnn_deterministic': True,
                    'tf32': False}
    if not bit:
        failures.append('imagenet-rec: the fit over ImageRecordIter is not '
                        'the NDArrayIter fit over its batches bit for bit '
                        '(max abs diff %g; metric %s against %s)'
                        % (diff, metric, tmetric))
    if not mesh_launches_ok(tper_step, expected):
        failures.append('imagenet-rec twin launches per step %s' % tper_step)
    deterministic(torch, False)
    if failures:
        raise AssertionError('; '.join(failures))
    return out, launches


def pick_fill_cases(torch):
    """tail-ops' card case of the fill rule: ``pick`` (both keepdims),
    ``choose_element_0index`` and ``batch_take`` on a CUDA tensor with the
    indices -1, -size-1 and size against the same call on the CPU (NaN
    where an index is past either end), then a synchronise and a fresh
    kernel: the CUDA context is alive (an out-of-range gather index would
    have been a device-side assert)."""
    from mxnet_tpu_torch.ops import get_op
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    idx = torch.tensor([-1.0, -7.0, 6.0, 2.0])
    cases = []
    for name, attrs in (('pick', {'axis': 1}),
                        ('pick', {'axis': 1, 'keepdims': True}),
                        ('choose_element_0index', {}),
                        ('batch_take', {})):
        op = get_op(name)
        attrs = op.canon_attrs(attrs)
        host = op.apply(attrs, [x, idx], False, None)[0][0]
        card = op.apply(attrs, [x.cuda(), idx.cuda()], False, None)[0][0]
        torch.cuda.synchronize()
        card = card.cpu()
        cases.append({'op': name, 'attrs': {k: str(v) for k, v in
                                            attrs.items()},
                      'index': idx.tolist(), 'card': card.flatten().tolist(),
                      'equal_to_cpu': bool(torch.equal(
                          card.isnan(), host.isnan()) and torch.equal(
                          card.nan_to_num(), host.nan_to_num()))})
    torch.cuda.synchronize()
    alive = float(torch.ones(8, device='cuda').sum().item()) == 8.0
    return cases, alive


# -- serve-mesh: tensor-parallel replicas over [gpu(0)] * dp*tp --------------
SMESH_MESHES = ('1x1', '1x2', '2x1', '2x2')
SMESH_REQUESTS = 64             # of 1-32 rows each, per mesh
SMESH_CLIENTS = 4


class SmeshTraffic(object):
    """serve-mesh's requests: ``rows`` images of a seeded pool, each row's
    pixel [0, 0, 0] replaced by a unique tag ((uid * 64 + row + 1) /
    FLEET_TAG_SCALE, exact in float32), so a logged flush names its rows
    and the rows can be rebuilt for the oracle."""

    def __init__(self, pool, seed):
        self.pool = pool
        rng = np.random.default_rng(seed)
        self.sizes = [int(v) for v in rng.integers(1, BATCH + 1,
                                                   size=SMESH_REQUESTS)]

    def rows_of(self, uid):
        rows = self.sizes[uid]
        start = (uid * 13) % (len(self.pool) - BATCH)
        x = self.pool[start:start + rows].copy()
        x[:, 0, 0, 0] = (uid * 64 + np.arange(1, rows + 1)) / FLEET_TAG_SCALE
        return x

    def row(self, tag):
        uid, r = divmod(tag - 1, 64)
        return self.rows_of(uid)[r]

    def run(self, server, name):
        """Every request from SMESH_CLIENTS threads: ({uid: output},
        [latency s], wall s)."""
        outs, lat, errors = {}, [], []

        def client(k):
            try:
                for uid in range(k, SMESH_REQUESTS, SMESH_CLIENTS):
                    x = self.rows_of(uid)
                    t0 = time.monotonic()
                    outs[uid] = server.predict(name, timeout=300, data=x)[0]
                    lat.append(time.monotonic() - t0)
            except Exception as e:                # noqa: BLE001 - reported
                errors.append(repr(e))
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(SMESH_CLIENTS)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.monotonic() - t0
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError('serve-mesh %s: %s' % (name,
                                                        errors or 'hung'))
        return outs, lat, wall


def smesh_record(predictor):
    """Log each forward of ``predictor`` as (the tags of its rows, its
    bucket): the flushes the server made."""
    flushes, fwd = [], predictor.forward

    def forward(**inputs):
        outs = fwd(**inputs)
        tags = np.asarray(inputs['data'])[:, 0, 0, 0]
        flushes.append((tuple(int(round(t * FLEET_TAG_SCALE))
                              for t in tags), predictor._active_bucket))
        return outs
    predictor.forward = forward
    return flushes


def smesh_latency(lat, wall, images):
    lat = np.array(lat) * 1e3
    return {'p50_ms': float(np.percentile(lat, 50)),
            'p99_ms': float(np.percentile(lat, 99)),
            'images_per_s': images / wall, 'wall_s': wall}


def smesh_check(traffic, outs, flushes, oracle, dp):
    """Every flush rebuilt row for row, padded to its bucket and split into
    its dp slots; each slot's rows through the unsharded oracle at the
    slot's bucket (B/dp rows); every response bit for bit those rows.
    Returns the flushes checked."""
    where = {}
    for i, (tags, bucket) in enumerate(flushes):
        for j, tag in enumerate(tags):
            where.setdefault(tag, (i, j))
    want_of = {}
    for i, (tags, bucket) in enumerate(flushes):
        x = np.stack([traffic.row(t) for t in tags])
        per = bucket // dp
        padded = np.concatenate([x, np.zeros((bucket - len(x),) + x.shape[1:],
                                             np.float32)])
        got = []
        for d in range(dp):
            oracle.forward(data=padded[d * per:(d + 1) * per])
            got.append(oracle.get_output(0))
        want_of[i] = np.concatenate(got)
    bad = []
    for uid, out in outs.items():
        rows = traffic.sizes[uid]
        spots = [where.get(uid * 64 + r + 1) for r in range(rows)]
        if any(s is None for s in spots) or len({s[0] for s in spots}) != 1:
            bad.append((uid, 'rows not in one logged flush'))
            continue
        i = spots[0][0]
        want = want_of[i][[s[1] for s in spots]]
        if out.shape != (rows, 1000) or not np.array_equal(out, want):
            bad.append((uid, float(np.max(np.abs(out - want)))
                        if out.shape == want.shape else out.shape))
    if bad:
        raise AssertionError('serve-mesh: %d responses differ from the '
                             'unsharded Predictor at their slot buckets, '
                             'e.g. %s' % (len(bad), bad[:3]))
    return len(flushes)


def smesh_bytes(sp):
    """Persistent bytes of each mesh position: its shard (or copy) of every
    argument, and its copy of the aux states."""
    def nbytes(t):
        return t.numel() * t.element_size()
    plan = sp._plan
    out = []
    for d in range(plan.dp):
        for t in range(plan.tp):
            out.append({'position': [d, t],
                        'param_bytes': sum(nbytes(g[d][t])
                                           for g in sp._params.values()),
                        'aux_bytes': sum(nbytes(g[d][t])
                                         for g in sp._aux.values())})
    return out


def serve_mesh(mx, torch, instrument, all_kernels, symbol, params):
    """serve-mesh: full-width ResNet-50 v2 (f32, TF32 off, cuDNN
    deterministic) served by ModelServer from one unsharded replica, then
    from a '1x1' replica (load_model(mesh='1x1', partition='auto'), which
    carves the one card) and from prebuilt Predictor(mesh='1x2' | '2x1' |
    '2x2', partition='auto', devices=[gpu(0)] * dp*tp): each warmed to
    BATCH rows, then SMESH_REQUESTS requests of 1-32 rows from
    SMESH_CLIENTS threads.  Each response bit for bit the unsharded
    Predictor's at its slot bucket; compile.traces frozen while
    serving.sharded_aot_calls counts every flush; fused_bn_relu 17 times a
    slot forward, from the captured slot graphs."""
    shapes = {'data': (BATCH,) + IMAGE}
    sym_json = symbol.tojson()
    pool = np.random.default_rng(SEED + 22).standard_normal(
        (96,) + IMAGE, dtype=np.float32)
    traffic = SmeshTraffic(pool, SEED + 23)
    images = sum(traffic.sizes)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    report, failures = {'meshes': {}}, []
    launches = {}
    instrument.set_metrics(True)
    try:
        fresh_memory(torch)
        oracle = mx.Predictor(sym_json, params, shapes, pad_to_bucket=True)
        oracle.warm_buckets(BATCH)
        server = mx.serving.ModelServer(max_delay_ms=2.0, max_batch=BATCH)
        try:
            server.load_model('plain', symbol_json=sym_json, params=params,
                              input_shapes=shapes)
            outs, lat, wall = traffic.run(server, 'plain')
            report['unsharded'] = smesh_latency(lat, wall, images)
            server.unload_model('plain')
            # one card: no disjoint pair for a '1x2' replica of its own
            try:
                server.load_model('wide', symbol_json=sym_json,
                                  params=params, input_shapes=shapes,
                                  mesh='1x2', partition='auto')
                failures.append('load_model(mesh=1x2) on one card built a '
                                'replica')
            except mx.MXNetError as e:
                report['carve_refusal'] = str(e)
                if 'no disjoint device set' not in str(e):
                    failures.append('load_model(mesh=1x2): %s' % e)
            for mesh in SMESH_MESHES:
                dp, tp = (int(v) for v in mesh.split('x'))
                fresh_memory(torch)
                name = 'm' + mesh.replace('x', '_')
                t0 = time.monotonic()
                if mesh == '1x1':
                    sp = server.load_model(name, symbol_json=sym_json,
                                           params=params, input_shapes=shapes,
                                           mesh=mesh, partition='auto')
                else:
                    sp = mx.Predictor(sym_json, params, shapes, mesh=mesh,
                                      partition='auto',
                                      devices=[mx.gpu(0)] * (dp * tp))
                    server.load_model(name, predictor=sp, input_shapes=shapes,
                                      mesh=mesh, partition='auto')
                torch.cuda.synchronize()
                load_s = time.monotonic() - t0
                steps = [slot['step'] for e in sp._slots.values()
                         for slot in e['slots']]
                buckets = sum(1 for b in (1, 2, 4, 8, 16, 32) if b >= dp)
                flushes = smesh_record(sp)
                c1 = launch_counts(all_kernels)
                traces0 = instrument.counter_value('compile.traces')
                aot0 = instrument.counter_value('serving.sharded_aot_calls')
                outs, lat, wall = traffic.run(server, name)
                torch.cuda.synchronize()
                traces = instrument.counter_value('compile.traces') - traces0
                aot = instrument.counter_value('serving.sharded_aot_calls') \
                    - aot0
                flushes = list(flushes)     # the peak forward comes later
                slot_forwards = dp * len(flushes)
                hot = {k: n - c1[k][0] for k, (n, _) in
                       launch_counts(all_kernels).items()}
                bn = hot['fused_bn_relu']
                checked = smesh_check(traffic, outs, flushes, oracle, dp)
                per_replay = sorted({s.launches.get('fused_bn_relu', 0)
                                     for s in steps})
                recs = sp.sharding_records()
                rec_bytes = sum(r['shard_bytes']
                                for r in recs['params'].values())
                positions = smesh_bytes(sp)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                sp.forward(data=pool[:BATCH])
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated()
                entry = {
                    'dp': dp, 'tp': tp, 'devices': ['gpu(0)'] * (dp * tp),
                    'entry': ('load_model(mesh=%r, partition=auto)' % mesh
                              if mesh == '1x1' else
                              'Predictor(mesh=%r, partition=auto, devices='
                              '[gpu(0)] * %d) -> load_model(predictor=)'
                              % (mesh, dp * tp)),
                    'load_s': load_s, 'requests': len(outs),
                    'images': images, 'flushes': len(flushes),
                    'flushes_checked_bit_for_bit': checked,
                    **smesh_latency(lat, wall, images),
                    'hot_path_captures': traces,
                    'sharded_aot_calls': aot,
                    'slot_forwards': slot_forwards,
                    'fused_bn_relu_launches': bn,
                    'fused_bn_relu_per_slot_forward': bn / max(slot_forwards,
                                                               1),
                    'launches_by_kernel': hot,
                    'launches_per_replay': per_replay,
                    'graphs': sum(1 for s in steps if s.captured),
                    'graphs_expected': buckets * dp,
                    'capture_ms': sum(s.capture_ms or 0 for s in steps),
                    'sharded_params': sum(1 for r in recs['params'].values()
                                          if 'tp' in r['spec']),
                    'degraded_params': len([r for r in
                                            recs['params'].values()
                                            if r.get('reason')]),
                    'records_shard_bytes': rec_bytes,
                    'positions': positions,
                    'forward_base_allocated_bytes': base,
                    'forward_peak_allocated_bytes': peak,
                    'reserved_bytes': torch.cuda.memory_reserved(),
                    'replica_capacity': server.replica_capacity(name),
                    'scale_up': server.scale_up(name)}
                launches[mesh] = hot
                if traces:
                    failures.append('%s: %d captures on the hot path'
                                    % (mesh, traces))
                if aot != len(flushes) or not flushes:
                    failures.append('%s: %d sharded calls for %d flushes'
                                    % (mesh, aot, len(flushes)))
                if bn != 17 * slot_forwards or per_replay != [17]:
                    failures.append('%s: fused_bn_relu %d in %d slot '
                                    'forwards (replays %s)'
                                    % (mesh, bn, slot_forwards, per_replay))
                if entry['graphs'] != entry['graphs_expected']:
                    failures.append('%s: %d graphs, expected %d'
                                    % (mesh, entry['graphs'],
                                       entry['graphs_expected']))
                if any(p['param_bytes'] != rec_bytes for p in positions):
                    failures.append('%s: position bytes %s against the '
                                    'records\' %d' % (mesh, positions,
                                                      rec_bytes))
                if entry['replica_capacity'] != 1 or \
                        entry['scale_up'] is not None:
                    failures.append('%s: capacity %s, scale_up %s'
                                    % (mesh, entry['replica_capacity'],
                                       entry['scale_up']))
                report['meshes'][mesh] = entry
                server.unload_model(name)
                del sp, steps
        finally:
            server.close(drain=False)
        del oracle
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = tf32
    if failures:
        raise AssertionError('serve-mesh: ' + '; '.join(failures))
    report['launches_by_mesh'] = launches
    return report, {k: sum(v[k] for v in launches.values())
                    for k in launches['1x1']}


# -- group2ctx: the model-parallel LSTM LM ------------------------------------
G2C = dict(vocab=10000, embed=200, hidden=200, layers=2, seq_len=35,
           batch=32)                # BASELINE config 4's PTB widths
G2C_STEPS = 10
G2C_LR = 0.005                      # examples/model_parallel_lstm.py's
G2C_GROUPS = ('embed', 'layer0', 'layer1', 'decode')


def g2c_lm(mx):
    """``examples/model_parallel_lstm.py``'s ``build_lm`` on the port's
    own rnn cells."""
    from mxnet_tpu_torch.rnn.rnn_cell import LSTMCell
    data = mx.sym.Variable('data')
    label = mx.sym.Variable('softmax_label')
    with mx.AttrScope(ctx_group='embed'):
        states = mx.sym.Embedding(data, input_dim=G2C['vocab'],
                                  output_dim=G2C['embed'], name='embed')
    for i in range(G2C['layers']):
        with mx.AttrScope(ctx_group='layer%d' % i):
            cell = LSTMCell(num_hidden=G2C['hidden'], prefix='lstm_l%d_' % i)
            begin = cell.begin_state(func=mx.sym.Variable,
                                     shape=(G2C['batch'], G2C['hidden']))
            states, _ = cell.unroll(G2C['seq_len'], inputs=states,
                                    begin_state=begin, merge_outputs=True)
    with mx.AttrScope(ctx_group='decode'):
        pred = mx.sym.Reshape(states, shape=(-1, G2C['hidden']))
        pred = mx.sym.FullyConnected(pred, num_hidden=G2C['vocab'],
                                     name='pred')
        label_flat = mx.sym.Reshape(label, shape=(-1,))
        return mx.sym.SoftmaxOutput(pred, label_flat, name='softmax')


def g2c_train(mx, torch, net, group2ctx):
    """The example's loop: weights rand * 0.1 from one seed, the +1 token
    walk, G2C_STEPS SGD steps at G2C_LR.  Returns the first step's output
    and gradients (numpy), the executor, the loss of every step and each
    step's ms (to a device synchronise)."""
    b, t = G2C['batch'], G2C['seq_len']
    ex = net.simple_bind(mx.gpu(0), data=(b, t), softmax_label=(b, t),
                         group2ctx=group2ctx, grad_req='write')
    rng = np.random.RandomState(0)
    for name in net.list_arguments():
        if name.endswith(('weight', 'parameters')):
            arr = ex.arg_dict[name]
            arr[:] = (rng.rand(*arr.shape) * 0.1).astype(np.float32)
    tokens = np.arange(b * (t + 1)).reshape(b, t + 1) % (G2C['vocab'] - 1) + 1
    label = tokens[:, 1:]
    ex.arg_dict['data'][:] = tokens[:, :-1].astype(np.float32)
    ex.arg_dict['softmax_label'][:] = label.astype(np.float32)
    first, losses, step_ms = None, [], []
    for _ in range(G2C_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ex.forward(is_train=True)[0]
        ex.backward()
        for name, arr in ex.arg_dict.items():
            g = ex.grad_dict.get(name)
            if g is not None and name not in ('data', 'softmax_label'):
                arr[:] = arr - G2C_LR * g
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if first is None:
            first = (out.asnumpy(), {k: g.asnumpy()
                                     for k, g in ex.grad_dict.items()
                                     if k not in ('data', 'softmax_label')})
        p = out.asnumpy().reshape(b, t, -1)
        losses.append(float(-np.log(np.maximum(
            p[np.arange(b)[:, None], np.arange(t)[None, :], label],
            1e-8)).mean()))
    return first, ex, losses, step_ms


def g2c_compare(got, want):
    """(max abs err, max err over rtol 1e-5 * |want| + atol) of two
    (output, gradients) pairs; the atol of each tensor is 1e-5 of its
    largest magnitude."""
    worst, over = 0.0, 0.0
    pairs = [(got[0], want[0])] + [(got[1][k], want[1][k])
                                   for k in sorted(want[1])]
    if sorted(got[1]) != sorted(want[1]):
        return float('inf'), float('inf')
    for a, b in pairs:
        diff = np.abs(a - b)
        bound = 1e-5 * np.abs(b) + 1e-5 * float(np.max(np.abs(b)) or 1.0)
        worst = max(worst, float(np.max(diff)))
        over = max(over, float(np.max(diff / bound)))
    return worst, over


def group2ctx_phase(mx, torch, all_kernels):
    """group2ctx: the model-parallel LSTM LM (examples/model_parallel_lstm.py
    on the port's rnn cells) at BASELINE config 4's PTB widths, f32, TF32
    off, bound three ways: groups all on gpu(0); 'embed' on cpu(0) and the
    rest on gpu(0) (host <-> card copies forward and backward); no
    group2ctx (the pass pipeline's program).  The first step's output and
    gradients within rtol 1e-5 (atol 1e-5 of each tensor's largest
    magnitude) across the three, each gradient on its variable's device;
    the loss falls over G2C_STEPS steps in each."""
    from mxnet_tpu_torch.executor import _partition_segments
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    net = g2c_lm(mx)
    runs, failures = {}, []
    c0 = launch_counts(all_kernels)
    try:
        for key, g2c in (
                ('all_gpu', {g: mx.gpu(0) for g in G2C_GROUPS}),
                ('embed_cpu', dict({g: mx.gpu(0) for g in G2C_GROUPS},
                                   embed=mx.cpu(0))),
                ('unpartitioned', None)):
            fresh_memory(torch)
            first, ex, losses, step_ms = g2c_train(mx, torch, net, g2c)
            wrong = sorted(n for n, g in ex.grad_dict.items()
                           if g.context != ex.arg_dict[n].context)
            runs[key] = {'first': first, 'losses': losses,
                         'step_ms': step_ms,
                         'step_ms_median_after_first':
                             statistics.median(step_ms[1:]),
                         'peak_allocated_bytes':
                             torch.cuda.max_memory_allocated(),
                         'grads_off_their_device': wrong,
                         'embed_weight_on': str(
                             ex.arg_dict['embed_weight'].context),
                         'segments': len(_partition_segments(
                             net, ex._group2ctx, ex._ctx))
                         if g2c else None}
            if wrong:
                failures.append('%s: gradients off their variable\'s '
                                'device: %s' % (key, wrong[:4]))
            if not losses[-1] < losses[0] or not np.isfinite(losses[-1]):
                failures.append('%s: the loss did not fall: %s'
                                % (key, losses))
            del ex
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    launches = {k: n - c0[k][0] for k, (n, _) in
                launch_counts(all_kernels).items()}
    report = {'model': 'examples/model_parallel_lstm.py build_lm', **G2C,
              'steps': G2C_STEPS, 'lr': G2C_LR, 'dtype': 'float32',
              'tf32': False, 'launches_by_kernel': launches}
    for a, b in (('all_gpu', 'unpartitioned'), ('embed_cpu', 'all_gpu')):
        worst, over = g2c_compare(runs[a]['first'], runs[b]['first'])
        report['%s_vs_%s' % (a, b)] = {'max_abs_err': worst,
                                       'max_err_over_bound': over}
        if not over <= 1.0:
            failures.append('%s against %s: first step beyond rtol 1e-5 '
                            '(%g of the bound, max abs err %g)'
                            % (a, b, over, worst))
    for key, run in runs.items():
        run.pop('first')
        report[key] = run
    if failures:
        raise AssertionError('group2ctx: ' + '; '.join(failures))
    return report


def main():
    try:
        import torch
    except ImportError:
        print('chip_smoke: torch is not installed', file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this smoke test runs on the GPU',
              file=sys.stderr)
        return 1
    try:
        import mxnet_tpu_torch as mx
        from mxnet_tpu_torch import convert, instrument, models
        from mxnet_tpu_torch.ops import _kernels, attention, fused, fused_conv
        from mxnet_tpu_torch.models import resnet
        from mxnet_tpu_torch.parallel import train_step as ts
        all_kernels = (fused.fused_bn_relu, fused.fused_scale_bias_dot,
                       fused.fused_dot_epilogue,
                       fused_conv.fused_scale_bias_conv3x3,
                       attention.flash_attention, mx.rtc.Rtc)
    except ImportError as e:
        print('chip_smoke: the mxnet_tpu_torch package is missing (%s); run '
              'from the root of a checkout' % e, file=sys.stderr)
        return 1
    os.environ['MXTPU_FUSE'] = 'aggressive'
    # 13. capture starts first: its child pytest runs while this process
    # starts and builds, and ends before phase 3 times the card
    capture_child = start_capture_checks()
    atexit.register(lambda: capture_child[0].poll() is None and
                    capture_child[0].kill())
    sqr_prop = register_user_ops(mx)

    # -- 1. device ---------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log({'phase': 'device', 'kind': kind, 'count': torch.cuda.device_count(),
         'nvidia_smi': smi, 'torch': torch.__version__,
         'cuda': torch.version.cuda, 'python': sys.version.split()[0]})

    # -- 2. build, in a thread: nvcc runs in processes of its own ------------
    t0 = t_build = time.monotonic()
    built = {}

    def build():
        try:
            _kernels.build()
        except BaseException as e:        # noqa: BLE001 - raised below
            built['error'] = e
        built['seconds'] = time.monotonic() - t_build
    builder = threading.Thread(target=build)
    builder.start()

    # -- 13. capture: whole-step capture's behaviours on the card ----------
    # while its child runs and the kernels build, the host's work of later
    # phases: graph shapes, the zoo's parameters, the op cases' CPU halves
    symbol = resnet.get_symbol(num_classes=1000, num_layers=50,
                               image_shape=IMAGE)
    path = bn_relu_shapes(mx, symbol, BATCH)
    fleet_bn_paths = {1 << k: (path if 1 << k == BATCH else
                               bn_relu_shapes(mx, symbol, 1 << k))
                      for k in range(BATCH.bit_length())}
    resnet_train_shapes = train_kernel_shapes(mx, symbol, BATCH)
    optim_symbol = resnet.resnet(
        units=OPTIM_UNITS, num_stages=4,
        filter_list=[64, 256, 512, 1024, 2048], num_classes=1000,
        image_shape=IMAGE, bottle_neck=True)
    optim_arg, optim_aux = convert.random_params(
        optim_symbol, {'data': (BATCH,) + IMAGE}, SEED)
    optim_dots, optim_convs, optim_bn_relus = train_kernel_shapes(
        mx, optim_symbol, BATCH)
    zoo_ahead(mx, models, convert)
    op_cpu_halves(torch)
    ahead_s = time.monotonic() - t0
    builder.join()
    if 'error' in built:
        raise built['error']
    ptxas = {n: [ln.strip() for ln in log_.splitlines()
                 if 'registers' in ln or 'spill' in ln]
             for n, log_ in _kernels.build_logs.items()}
    log({'phase': 'build', 'seconds': built['seconds'],
         'nvcc_seconds': _kernels.build_seconds, 'ptxas': ptxas})
    sm90_report = ptxas_sm90(_kernels.build_logs)
    log({'phase': 'ptxas-sm90', 'instantiations': sm90_report,
         'spilling': [r['function'] for r in sm90_report
                      if r.get('spill_stores') or r.get('spill_loads')]})
    checks, capture_s, durations = capture_checks(capture_child)
    log({'phase': 'capture', 'checks': checks, 'seconds': capture_s,
         'test_seconds': durations, 'host_work_meanwhile_s': ahead_s,
         'source': 'tests/test_torch_capture.py (cuda)'})

    # -- 3. kernels: each against its plain version ------------------------
    if sum(path.values()) != 17:
        raise AssertionError('expected 17 BN-ReLU nodes on the ResNet-50 '
                             'inference path, found %s' % dict(path))
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    flush = torch.ones(32 << 20, device='cuda')    # 128 MiB
    cases = []
    for shape, per_forward in sorted(path.items()):
        case = check_bn_relu(torch, fused, shape, torch.float32, gen, flush)
        case['launches_per_forward'] = per_forward
        cases.append(case)
    # off the path: a ragged bf16 shape (odd sizes, numel not a multiple
    # of the 8-wide vector) and an unaligned view (scalar path)
    ragged = check_bn_relu(torch, fused, (3, 37, 7, 5), torch.bfloat16, gen,
                           flush)
    ragged['launches_per_forward'] = 0
    cases.append(ragged)
    base = torch.randn(1 + 2 * 64 * 9, generator=gen, device='cuda')
    xu = base[1:].view(2, 64, 3, 3)
    su, bu = torch.ones(64, device='cuda'), torch.zeros(64, device='cuda')
    if not torch.equal(fused.fused_bn_relu(xu, su, bu),
                       fused.fused_bn_relu_plain(xu, su, bu)):
        raise AssertionError('fused_bn_relu: unaligned view disagrees')
    # the training path, read from the aggressive training graph
    dots, convs, train_bn_relus = resnet_train_shapes
    if sum(dots.values()) != 36 or sum(convs.values()) != 16:
        raise AssertionError('expected 36 1x1 and 16 3x3 _bn_relu_conv '
                             'nodes in ResNet-50 v2 training, found %s / %s'
                             % (dict(dots), dict(convs)))
    for shape, per_step in sorted(train_bn_relus.items()):
        case = check_bn_relu(torch, fused, shape, torch.bfloat16, gen, flush)
        case['launches_per_forward'] = 0
        case['launches_per_step'] = per_step
        cases.append(case)
    # TF32 off: the f32 plain versions and library calls are full f32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dot_cases, conv_cases = [], []
    for dtype in (torch.bfloat16, torch.float32):
        for mkn, per_step in sorted(dots.items()):
            case = check_dot(torch, fused, mkn, dtype, gen, flush)
            if case['route'] != PATH_ROUTE[case['dtype']]:
                raise AssertionError('fused_scale_bias_dot %s %s took the '
                                     '%s route' % (mkn, case['dtype'],
                                                   case['route']))
            case['launches_per_step'] = per_step
            dot_cases.append(case)
        for shape, per_step in sorted(convs.items()):
            case = check_conv(torch, fused_conv, shape, dtype, gen, flush)
            if case['route'] != PATH_ROUTE[case['dtype']]:
                raise AssertionError('fused_scale_bias_conv3x3 %s %s took '
                                     'the %s route' % (shape, case['dtype'],
                                                       case['route']))
            case['launches_per_step'] = per_step
            conv_cases.append(case)
        # off the path: a ragged dot (no tile divides M, K or N) and an
        # odd-H/W stride-2 conv
        case = check_dot(torch, fused, (1001, 37, 130), dtype, gen, flush)
        case['launches_per_step'] = 0
        dot_cases.append(case)
        case = check_conv(torch, fused_conv, (3, 15, 13, 24, 40, 2), dtype,
                          gen, flush)
        case['launches_per_step'] = 0
        conv_cases.append(case)
    # the sm90 route off the path: K = 72 (a second, padded K step) with a
    # positive bias and NaN past K in scale and bias, ragged M; the ragged
    # N tile at BN 64; a NaN row
    for mkn, kw in (((1001, 72, 256), {'positive_bias': True}),
                    ((256, 96, 72), {}),
                    ((1001, 64, 256), {'nan_row': 500})):
        case = check_dot(torch, fused, mkn, torch.bfloat16, gen, flush, **kw)
        if case['route'] != 'sm90':
            raise AssertionError('fused_scale_bias_dot %s took the %s route'
                                 % (mkn, case['route']))
        case['launches_per_step'] = 0
        dot_cases.append(case)
    # the conv's sm90 route off the path: odd H and W at stride 2 with F =
    # 40 and M = 168 (no multiple of 128); 7 x 9 images (tiles span
    # images); a positive bias at both strides (a halo left at
    # relu(bias) shows); a NaN pixel on the left edge and inside
    for shape, kw in (((3, 15, 13, 64, 40, 2), {}),
                      ((2, 7, 9, 64, 64, 1), {}),
                      ((2, 14, 14, 128, 64, 1), {'positive_bias': True}),
                      ((2, 14, 15, 192, 128, 2), {'positive_bias': True})):
        case = check_conv(torch, fused_conv, shape, torch.bfloat16, gen,
                          flush, **kw)
        if case['route'] != 'sm90':
            raise AssertionError('fused_scale_bias_conv3x3 %s took the %s '
                                 'route' % (shape, case['route']))
        case['launches_per_step'] = 0
        conv_cases.append(case)
    conv_nan = [check_conv_nan_pixel(torch, fused_conv, shape, pixel, gen)
                for shape, pixel in (((2, 9, 9, 64, 32, 1), (1, 4, 0)),
                                     ((2, 12, 12, 64, 32, 2), (0, 5, 6)))]
    if any(c['route'] != 'sm90' for c in conv_nan):
        raise AssertionError('fused_scale_bias_conv3x3 NaN-pixel cases took '
                             'the routes %s' % [c['route'] for c in conv_nan])
    dot_layouts = check_dot_layouts(torch, fused, (25088, 128, 512), gen)
    torch.backends.cudnn.allow_tf32 = True
    log({'phase': 'kernels', 'cases': cases, 'dot_cases': dot_cases,
         'dot_w_layouts': dot_layouts, 'conv_cases': conv_cases,
         'conv_nan_pixel_cases': conv_nan, 'tf32': False})
    att_cases, epi_cases = lm_kernels(mx, torch, attention, fused, models,
                                      gen, flush)
    log({'phase': 'lm-kernels', 'flash_attention_cases': att_cases,
         'fused_dot_epilogue_cases': epi_cases, 'tf32': False})
    bucket_att, bucket_epi = bucket_kernels(mx, torch, attention, fused,
                                            models, gen, flush)
    log({'phase': 'bucket-kernels', 'rows': BUCKET_ROWS,
         'buckets': list(BUCKETS), 'flash_attention_cases': bucket_att,
         'fused_dot_epilogue_cases': bucket_epi, 'tf32': False})
    rtc_cases, bad_log = rtc_kernels(mx, torch, instrument, gen, flush)
    del flush
    compiles = instrument.histogram('rtc.compile_secs')
    log({'phase': 'rtc-kernels', 'cases': rtc_cases, 'tf32': False,
         'nvrtc_modules': compiles.count,
         'nvrtc_s_per_module': compiles.sum / max(compiles.count, 1),
         'compile_error_log': bad_log})

    # -- 4. serve: the main path, captured, beside an eager server ----------
    arg, aux = convert.random_params(symbol, {'data': (BATCH,) + IMAGE},
                                      SEED)
    params = convert.params_from_numpy(arg, aux, 'cuda:0')
    rng = np.random.default_rng(SEED + 1)
    data = rng.standard_normal((64,) + IMAGE, dtype=np.float32)
    served = {}
    for mode in ('eager', 'captured'):
        fresh_memory(torch)
        set_engine(mx, mode == 'eager')
        server = mx.serving.ModelServer(max_delay_ms=2.0, max_batch=BATCH)
        try:
            served[mode] = serve_phase(mx, torch, server, symbol, params,
                                       data, np.random.default_rng(SEED + 1),
                                       fused, instrument)
        finally:
            set_engine(mx, False)
            server.close()
    cap, eager = served['captured'], served['eager']
    if cap['launches_per_forward'] != eager['launches_per_forward']:
        raise AssertionError('serve: launches per forward captured %s, eager '
                             '%s' % (cap['launches_per_forward'],
                                     eager['launches_per_forward']))
    if not all(g['captured'] for g in cap['graphs']) or \
            len(cap['graphs']) != BATCH.bit_length():
        raise AssertionError('serve: buckets not all captured: %s'
                             % cap['graphs'])
    launches = {'fused_bn_relu': cap.pop('fused_bn_relu_launches')}
    eager.pop('fused_bn_relu_launches')
    log({'phase': 'serve', 'model': 'resnet-50 v2', 'classes': 1000,
         'image': list(IMAGE), 'max_batch': BATCH, 'fuse': 'aggressive',
         'tf32_conv': torch.backends.cudnn.allow_tf32,
         'requests': N_REQUESTS, **cap, 'eager': eager})

    # -- 5. parity against the CPU, TF32 off ---------------------------------
    # a graph keeps the library kernels chosen when it was recorded, TF32
    # on or off: the card's side is a served Predictor captured with TF32
    # off, its 4-row bucket replayed
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = data[:4]
    card_pred = mx.Predictor(symbol.tojson(), params, {'data': (BATCH,)
                                                       + IMAGE},
                             pad_to_bucket=True)
    card_pred.warm_buckets(4)
    card_pred.forward(data=rows)
    card = card_pred.get_output(0)
    if card_pred._bucket_execs[4]._forward_graph.replays != 1:
        raise AssertionError('parity: the 4-row bucket did not replay')
    del params, card_pred
    cpu_pred = mx.Predictor(symbol.tojson(),
                            convert.params_from_numpy(arg, aux, 'cpu'),
                            {'data': (4,) + IMAGE}, dev_type='cpu')
    cpu_pred.forward(data=rows)
    ref = cpu_pred.get_output(0)
    rel = float(np.max(np.abs(card - ref) / np.maximum(np.abs(ref), 1e-30)))
    top1 = bool(np.array_equal(card.argmax(1), ref.argmax(1)))
    log({'phase': 'parity', 'rows': 4, 'tf32': False, 'max_rel_err': rel,
         'max_abs_err': float(np.max(np.abs(card - ref))),
         'top1_equal': top1})
    np.testing.assert_allclose(card, ref, rtol=1e-3, atol=1e-7)
    if not top1:
        raise AssertionError('top-1 differs between the card and the CPU')

    # -- 4b. fleet: 1, 2 and 4 replicas, lanes, deadlines, changes, repair --
    fleet_report, fleet_bn, oracle = fleet_phase(
        mx, torch, fused, instrument, convert, symbol, arg, aux, data,
        fleet_bn_paths)
    log({'phase': 'fleet', **fleet_report})

    # -- 4c. autoscale: windowed p99, brownout, servewatch, postmortems ------
    auto_report, auto_bn = autoscale_phase(mx, torch, fused, instrument,
                                           convert, symbol, arg, aux, data,
                                           oracle)
    del oracle
    log({'phase': 'autoscale', **auto_report})

    # -- 6. train: the second main path ----------------------------------
    prog = mx.fuse.apply_fuse_passes(symbol, True, 'aggressive')
    bn_relu_nodes = sum(1 for n in prog.topo_nodes() if n.op == '_bn_relu')
    rng = np.random.default_rng(SEED + 2)
    images = rng.standard_normal((TRAIN_BATCHES * BATCH,) + IMAGE,
                                 dtype=np.float32)
    labels = rng.integers(0, 1000, TRAIN_BATCHES * BATCH).astype(np.float32)
    fresh_memory(torch)
    for k in (fused.fused_bn_relu, fused.fused_scale_bias_dot,
              fused_conv.fused_scale_bias_conv3x3):
        reset_launches(k)
    counts0 = launch_counts(all_kernels)
    t0 = time.monotonic()
    mod, step_s, snap = train_module(mx, torch, symbol, arg, aux, images,
                                     labels, mx.gpu(0), torch.bfloat16,
                                     BATCH, snap_at=EAGER_STEPS)
    torch.cuda.synchronize()
    fit_s = time.monotonic() - t0
    train_captured = {
        'step_ms_median_after_warmup':
            statistics.median(step_s[TRAIN_WARMUP:]) * 1e3,
        'launches_per_step': launches_per_step(
            counts0, launch_counts(all_kernels), len(step_s)),
        **memory(torch)}
    train_graphs = graph_report(mod._graphs.values())
    if len(train_graphs) != 1 or not train_graphs[0]['captured'] or \
            train_graphs[0]['replays'] != TRAIN_BATCHES - 1:
        raise AssertionError('train: the fit step did not replay one graph: '
                             '%s' % train_graphs)
    train_launches = {
        'fused_scale_bias_dot': fused.fused_scale_bias_dot.launches,
        'fused_scale_bias_conv3x3':
            fused_conv.fused_scale_bias_conv3x3.launches,
        'fused_bn_relu': fused.fused_bn_relu.launches}
    expected = {'fused_scale_bias_dot': 36, 'fused_scale_bias_conv3x3': 16,
                'fused_bn_relu': bn_relu_nodes}
    steps = len(step_s)
    for name, per_step in expected.items():
        if train_launches[name] != per_step * steps or steps != \
                TRAIN_BATCHES:
            raise AssertionError('%s launched %d times in %d training steps '
                                 '(expected %d each)'
                                 % (name, train_launches[name], steps,
                                    per_step))
    train_routes = dict(fused.fused_scale_bias_dot.launches_by_route)
    train_conv_routes = dict(
        fused_conv.fused_scale_bias_conv3x3.launches_by_route)
    for name, routes, per_step in (
            ('fused_scale_bias_dot', train_routes, 36),
            ('fused_scale_bias_conv3x3', train_conv_routes, 16)):
        if routes['sm90'] != per_step * steps:
            raise AssertionError('%s took the sm90 route %d times of %d in '
                                 '%d steps: %s' % (name, routes['sm90'],
                                                   per_step * steps, steps,
                                                   routes))
    metric = dict(mod._fused_metric.get_name_value())
    trained, trained_aux = mod.get_params()
    moved = 0.0
    for k, v in arg.items():
        t = trained[k].asnumpy()
        if not np.all(np.isfinite(t)):
            raise AssertionError('parameter %s is not finite' % k)
        moved = max(moved, float(np.max(np.abs(t - v))))
    if not all(np.all(np.isfinite(v.asnumpy()))
               for v in trained_aux.values()):
        raise AssertionError('a BatchNorm moving statistic is not finite')
    if not np.isfinite(metric['cross-entropy']) or moved <= 0.0:
        raise AssertionError('training did not move: loss %s, max |dw| %g'
                             % (metric['cross-entropy'], moved))
    step_ms = statistics.median(step_s[TRAIN_WARMUP:]) * 1e3
    peak = torch.cuda.max_memory_allocated()
    del mod, trained, trained_aux
    # the same first steps eagerly (NaiveEngine), from the same state
    fresh_memory(torch)
    counts0 = launch_counts(all_kernels)
    set_engine(mx, True)
    mx.random.seed(SEED)
    try:
        emod, estep_s = train_module(
            mx, torch, symbol, arg, aux, images[:EAGER_STEPS * BATCH],
            labels[:EAGER_STEPS * BATCH], mx.gpu(0), torch.bfloat16, BATCH)
    finally:
        set_engine(mx, False)
    train_capture = compare_runs(
        'train', train_captured,
        {'step_ms_median_after_warmup': statistics.median(estep_s[1:]) * 1e3,
         'launches_per_step': launches_per_step(
             counts0, launch_counts(all_kernels), len(estep_s)),
         **memory(torch)},
        snap, {k: v.asnumpy() for k, v in emod.get_params()[0].items()},
        EAGER_STEPS)
    del emod
    log({'phase': 'train', 'model': 'resnet-50 v2', 'classes': 1000,
         'image': list(IMAGE), 'batch': BATCH, 'steps': steps,
         'compute_dtype': 'bfloat16', 'fuse': 'aggressive',
         'optimizer': 'sgd lr 0.05 momentum 0.9 wd 1e-4',
         'launches': train_launches, 'launches_per_step': expected,
         'fused_scale_bias_dot_launches_by_route': train_routes,
         'fused_scale_bias_conv3x3_launches_by_route': train_conv_routes,
         'fit_s': fit_s, 'step_ms': [t * 1e3 for t in step_s],
         'step_ms_median_after_warmup': step_ms,
         'images_per_s': BATCH / step_ms * 1e3,
         'peak_memory_bytes': peak,
         'train_cross_entropy': metric['cross-entropy'],
         'train_accuracy': metric['accuracy'], 'max_param_change': moved,
         'graphs': train_graphs, 'capture_vs_eager': train_capture})

    # -- 7. train-parity: one f32 step on the card and on the CPU ----------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    p_images, p_labels = images[:PARITY_ROWS], labels[:PARITY_ROWS]
    stepped = {}
    for ctx in (mx.gpu(0), mx.cpu()):
        t0 = time.monotonic()
        pmod, _ = train_module(mx, torch, symbol, arg, aux, p_images,
                               p_labels, ctx, None, PARITY_ROWS)
        stepped[ctx.device_type] = ({k: v.asnumpy() for k, v in
                                     pmod.get_params()[0].items()},
                                    time.monotonic() - t0)
        del pmod
    (card, card_s), (host, cpu_s) = stepped['gpu'], stepped['cpu']
    # the relu-kink bound of param_parity; every parameter that differs
    # is reported
    n_out, total, worst, outside = param_parity(card, host)
    log({'phase': 'train-parity', 'rows': PARITY_ROWS, 'dtype': 'float32',
         'tf32': False, 'tolerance': 'rtol 1e-3, atol 1e-5 elementwise; '
         'at most 1e-4 of the elements outside it, none beyond 1e-3',
         'params': len(card), 'elements': total,
         'elements_outside': n_out, 'max_abs_err': worst[0],
         'worst_param': worst[1], 'outside_tolerance': outside,
         'card_s': card_s, 'cpu_s': cpu_s})
    if n_out > 1e-4 * total or worst[0] > 1e-3:
        raise AssertionError('train-parity: %d of %d parameter elements '
                             'beyond rtol 1e-3, atol 1e-5, max abs err %g '
                             'in %s' % (n_out, total, worst[0], worst[1]))

    # -- 8. lm-train: the third main path ----------------------------------
    dev = torch.device('cuda', 0)
    lm_sym = lm_symbol(models)
    seq = LM['seq_len']
    lm_arg, _ = convert.random_params(
        lm_sym, {'data': (LM_BATCH, seq), 'softmax_label': (LM_BATCH, seq)},
        SEED, init='normal')
    params = {k: torch.from_numpy(v).to(dev) for k, v in lm_arg.items()}
    opt_state = ts.sgd_momentum_init(params)
    batch = lm_batch(torch, dev, LM_BATCH)
    step = lm_step(ts, lm_sym, LM_BATCH, torch.bfloat16)
    fresh_memory(torch)
    reset_launches(attention.flash_attention)
    reset_launches(fused.fused_dot_epilogue)
    counts0 = launch_counts(all_kernels)
    lm_step_s, ce = [], []
    t0 = time.monotonic()
    for i in range(LM_STEPS):
        t1 = time.perf_counter()
        outs, params, _, opt_state = step(params, {}, opt_state, batch)
        torch.cuda.synchronize()
        lm_step_s.append(time.perf_counter() - t1)
        if i in (0, LM_STEPS - 1):
            ce.append(cross_entropy(torch, outs[0], batch['softmax_label']))
        if i == EAGER_STEPS - 1:
            lm_snap = {k: v.cpu().numpy() for k, v in params.items()}
    lm_s = time.monotonic() - t0
    lm_captured = {
        'step_ms_median_after_warmup':
            statistics.median(lm_step_s[TRAIN_WARMUP:]) * 1e3,
        'launches_per_step': launches_per_step(
            counts0, launch_counts(all_kernels), LM_STEPS),
        **memory(torch)}
    lm_graphs = graph_report(c for c, _ in step.graphs.values())
    if len(lm_graphs) != 1 or lm_graphs[0]['replays'] != LM_STEPS - 1:
        raise AssertionError('lm-train: the step did not replay one graph: '
                             '%s' % lm_graphs)
    lm_launches = {'flash_attention': attention.flash_attention.launches,
                   'fused_dot_epilogue': fused.fused_dot_epilogue.launches}
    for name, n in lm_launches.items():
        if n != LM['num_layers'] * LM_STEPS:
            raise AssertionError('%s launched %d times in %d LM steps '
                                 '(expected %d each)' % (
                                     name, n, LM_STEPS, LM['num_layers']))
    lm_routes = dict(fused.fused_dot_epilogue.launches_by_route)
    flash_routes = dict(attention.flash_attention.launches_by_route)
    for name, routes in (('fused_dot_epilogue', lm_routes),
                         ('flash_attention', flash_routes)):
        if routes['sm90'] != LM['num_layers'] * LM_STEPS:
            raise AssertionError('%s took the sm90 route %d times of %d in '
                                 '%d LM steps: %s'
                                 % (name, routes['sm90'], LM['num_layers']
                                    * LM_STEPS, LM_STEPS, routes))
    if tuple(outs[0].shape) != (LM_BATCH * seq, LM['vocab_size']) or \
            not bool(torch.isfinite(outs[0].float()).all()) or \
            not all(np.isfinite(ce)):
        raise AssertionError('lm-train: bad output %s, cross-entropy %s'
                             % (tuple(outs[0].shape), ce))
    lm_moved = 0.0
    for k, v in lm_arg.items():
        t = params[k].cpu().numpy()
        if not np.all(np.isfinite(t)):
            raise AssertionError('LM parameter %s is not finite' % k)
        lm_moved = max(lm_moved, float(np.max(np.abs(t - v))))
    if lm_moved <= 0.0:
        raise AssertionError('lm-train: the parameters did not move')
    lm_ms = statistics.median(lm_step_s[TRAIN_WARMUP:]) * 1e3
    lm_peak = torch.cuda.max_memory_allocated()
    del params, opt_state, outs, step
    fresh_memory(torch)
    counts0 = launch_counts(all_kernels)
    set_engine(mx, True)
    try:
        estep = lm_step(ts, lm_sym, LM_BATCH, torch.bfloat16)
        eparams = {k: torch.from_numpy(v).to(dev) for k, v in lm_arg.items()}
        estate = ts.sgd_momentum_init(eparams)
        elm_s = []
        for i in range(EAGER_STEPS):
            t1 = time.perf_counter()
            _, eparams, _, estate = estep(eparams, {}, estate, batch)
            torch.cuda.synchronize()
            elm_s.append(time.perf_counter() - t1)
    finally:
        set_engine(mx, False)
    lm_capture = compare_runs(
        'lm-train', lm_captured,
        {'step_ms_median_after_warmup': statistics.median(elm_s[1:]) * 1e3,
         'launches_per_step': launches_per_step(
             counts0, launch_counts(all_kernels), EAGER_STEPS),
         **memory(torch)},
        lm_snap, {k: v.cpu().numpy() for k, v in eparams.items()},
        EAGER_STEPS)
    del estep, eparams, estate
    log({'phase': 'lm-train', 'model': 'transformer_lm', **LM,
         'batch': LM_BATCH, 'steps': LM_STEPS, 'compute_dtype': 'bfloat16',
         'fuse': 'aggressive', 'entry': 'parallel.make_train_step',
         'optimizer': 'sgd lr 0.01 momentum 0.9 wd 0 rescale 1/%d'
                      % (LM_BATCH * seq),
         'launches': lm_launches,
         'launches_per_step': {k: LM['num_layers'] for k in lm_launches},
         'fused_dot_epilogue_launches_by_route': lm_routes,
         'flash_attention_launches_by_route': flash_routes,
         'wall_s': lm_s, 'step_ms': [t * 1e3 for t in lm_step_s],
         'step_ms_median_after_warmup': lm_ms,
         'tokens_per_s': LM_BATCH * seq / lm_ms * 1e3,
         'peak_memory_bytes': lm_peak,
         'cross_entropy_first_last': ce,
         'ln_vocab': float(np.log(LM['vocab_size'])),
         'max_param_change': lm_moved,
         'graphs': lm_graphs, 'capture_vs_eager': lm_capture})

    # -- 9. lm-parity: one f32 LM step on the card and on the CPU ----------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    stepped = {}
    for d in (dev, torch.device('cpu')):
        t0 = time.monotonic()
        # copies: the step updates in place, and on the CPU
        # torch.from_numpy(...).to(d) would share lm_arg's memory
        p = {k: torch.tensor(v, device=d) for k, v in lm_arg.items()}
        _, p, _, _ = lm_step(ts, lm_sym, LM_PARITY_ROWS, None)(
            p, {}, ts.sgd_momentum_init(p),
            lm_batch(torch, d, LM_PARITY_ROWS))
        stepped[d.type] = ({k: v.cpu().numpy() for k, v in p.items()},
                           time.monotonic() - t0)
        del p
    (card, card_s), (host, cpu_s) = stepped['cuda'], stepped['cpu']
    n_out, total, worst, outside = param_parity(card, host)
    # the update itself is small against N(0, 0.02) weights (many
    # elements move by less than their float32 spacing): the largest
    # difference is reported against the largest update as well
    max_update = max(float(np.max(np.abs(host[k] - lm_arg[k])))
                     for k in host)
    log({'phase': 'lm-parity', 'rows': LM_PARITY_ROWS, 'seq_len': seq,
         'dtype': 'float32', 'tf32': False,
         'tolerance': 'rtol 1e-3, atol 1e-5 elementwise; at most 1e-4 of '
         'the elements outside it, none beyond 1e-3',
         'params': len(card), 'elements': total,
         'elements_outside': n_out, 'max_abs_err': worst[0],
         'worst_param': worst[1], 'outside_tolerance': outside,
         'max_update': max_update,
         'max_abs_err_over_max_update': worst[0] / max_update,
         'card_s': card_s, 'cpu_s': cpu_s})
    if n_out > 1e-4 * total or worst[0] > 1e-3:
        raise AssertionError('lm-parity: %d of %d parameter elements beyond '
                             'rtol 1e-3, atol 1e-5, max abs err %g in %s'
                             % (n_out, total, worst[0], worst[1]))

    # -- 9b. bucket-train: the fifth main path ------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sentences = bucket_corpus(SEED + 3, BUCKET_ROWS * (BUCKET_STEPS + 1))
    report, bucket_launches, bucket_routes = bucket_train(
        mx, torch, models, lm_arg, sentences)
    log({'phase': 'bucket-train', **report})
    stepped, pads = bucket_parity(mx, torch, models, lm_arg, sentences)
    (card, card_s), (host, cpu_s) = stepped['gpu'], stepped['cpu']
    n_out, total, worst, outside = param_parity(card, host)
    max_update = max(float(np.max(np.abs(host[k] - lm_arg[k])))
                     for k in host)
    log({'phase': 'bucket-parity', 'bucket': BUCKET_PARITY[0],
         'rows': BUCKET_PARITY[1], 'padded_tokens': pads, 'dtype': 'float32',
         'tf32': False,
         'tolerance': 'rtol 1e-3, atol 1e-5 elementwise; at most 1e-4 of '
         'the elements outside it, none beyond 1e-3',
         'params': len(card), 'elements': total,
         'elements_outside': n_out, 'max_abs_err': worst[0],
         'worst_param': worst[1], 'outside_tolerance': outside,
         'max_update': max_update, 'card_s': card_s, 'cpu_s': cpu_s})
    if n_out > 1e-4 * total or worst[0] > 1e-3:
        raise AssertionError('bucket-parity: %d of %d parameter elements '
                             'beyond rtol 1e-3, atol 1e-5, max abs err %g in '
                             '%s' % (n_out, total, worst[0], worst[1]))

    # -- 9c. sp: the sixth main path, sequence parallelism on NCCL ---------
    sp_report, sp_launches = sequence_parallel(mx, torch, models, ts,
                                               lm_arg, dev)
    log({'phase': 'sp', **sp_report})

    # -- 10. imperative: nd.* on the card and on the CPU ------------------
    log({'phase': 'imperative', **imperative(mx, sqr_prop)})

    # -- 11. custom-train: the fourth main path, captured in segments -----
    csym = custom_symbol(mx, resnet)
    dots, convs, bn_relus = train_kernel_shapes(mx, csym, BATCH)
    expected = {'fused_scale_bias_dot': sum(dots.values()),
                'fused_scale_bias_conv3x3': sum(convs.values()),
                'fused_bn_relu': sum(bn_relus.values()), 'rtc': 2}
    custom_kernels = (fused.fused_bn_relu, fused.fused_scale_bias_dot,
                      fused_conv.fused_scale_bias_conv3x3, mx.rtc.Rtc)
    # captured against NaiveEngine must be bit for bit: cuDNN's
    # deterministic algorithms for the convolutions it runs.  A captured
    # run under the setting the other phases keep comes first, for a
    # step time comparable with theirs
    cudnn_det = torch.backends.cudnn.deterministic
    custom_runs = {}
    for key, naive, det in (('earlier_cudnn', False, cudnn_det),
                            (False, False, True), (True, True, True)):
        torch.backends.cudnn.deterministic = det
        fresh_memory(torch)
        for k in custom_kernels:
            reset_launches(k)
        USER_CALLS.update(forward=0, backward=0)
        set_engine(mx, naive)
        try:
            t0 = time.monotonic()
            mod, step_s = train_module(mx, torch, csym, arg, aux, images,
                                       labels, mx.gpu(0), None, BATCH)
            torch.cuda.synchronize()
            fit_s = time.monotonic() - t0
        finally:
            set_engine(mx, False)
        custom_runs[key] = {
            'mod': mod, 'step_s': step_s, 'fit_s': fit_s,
            'user_calls': dict(USER_CALLS),
            'peak_memory_bytes': torch.cuda.max_memory_allocated(),
            'launches': {
                'fused_scale_bias_dot': fused.fused_scale_bias_dot.launches,
                'fused_scale_bias_conv3x3':
                    fused_conv.fused_scale_bias_conv3x3.launches,
                'fused_bn_relu': fused.fused_bn_relu.launches,
                'rtc': mx.rtc.Rtc.launches},
            'routes': (dict(fused.fused_scale_bias_dot.launches_by_route),
                       dict(fused_conv.fused_scale_bias_conv3x3
                            .launches_by_route))}
        if key == 'earlier_cudnn':
            # its graphs' memory goes before the next run's peak
            del mod, custom_runs[key]['mod']
    torch.backends.cudnn.deterministic = cudnn_det
    captured_run, naive_run = custom_runs[False], custom_runs[True]
    earlier_run = custom_runs.pop('earlier_cudnn')
    mod, step_s, fit_s = (captured_run['mod'], captured_run['step_s'],
                          captured_run['fit_s'])
    custom_launches = captured_run['launches']
    custom_routes, custom_conv_routes = captured_run['routes']
    steps = len(step_s)
    for run_name, run in (('captured', captured_run),
                          ('NaiveEngine', naive_run)):
        for name, per_step in expected.items():
            if run['launches'][name] != per_step * len(run['step_s']) or \
                    len(run['step_s']) != TRAIN_BATCHES:
                raise AssertionError(
                    'custom-train (%s): %s launched %d times in %d steps '
                    '(expected %d each)' % (run_name, name,
                                            run['launches'][name],
                                            len(run['step_s']), per_step))
        if run['user_calls'] != {'forward': TRAIN_BATCHES,
                                 'backward': TRAIN_BATCHES}:
            raise AssertionError('custom-train (%s): the user\'s code ran '
                                 '%s in %d steps' % (run_name,
                                                     run['user_calls'],
                                                     TRAIN_BATCHES))
    # float32 keeps the SIMT routes
    for name, routes in (('fused_scale_bias_dot', custom_routes),
                         ('fused_scale_bias_conv3x3', custom_conv_routes)):
        if routes['simt'] != custom_launches[name]:
            raise AssertionError('custom-train: %s routes %s'
                                 % (name, routes))
    metric = dict(mod._fused_metric.get_name_value())
    trained = mod.get_params()[0]
    moved = 0.0
    for k, v in arg.items():
        t = trained[k].asnumpy()
        if not np.all(np.isfinite(t)):
            raise AssertionError('custom-train: parameter %s is not finite'
                                 % k)
        moved = max(moved, float(np.max(np.abs(t - v))))
    if not np.isfinite(metric['cross-entropy']) or moved <= 0.0:
        raise AssertionError('custom-train did not move: loss %s, max |dw| '
                             '%g' % (metric['cross-entropy'], moved))
    step_ms = statistics.median(step_s[TRAIN_WARMUP:]) * 1e3
    naive_ms = statistics.median(naive_run['step_s'][TRAIN_WARMUP:]) * 1e3
    custom_graphs = graph_report(mod._graphs.values())
    (ccap,) = mod._graphs.values()
    stage_kinds = ['graph' if hasattr(st, 'graph') else 'host'
                   for st in getattr(ccap, 'stages', [])]
    if type(ccap).__name__ != 'StagedStep' or ccap.skip is not None or \
            not ccap.captured or \
            stage_kinds != ['graph', 'host', 'host', 'graph'] or \
            ccap.replays != TRAIN_BATCHES - 1:
        raise AssertionError('custom-train: the Custom-headed step must be '
                             'captured in segments (one forward graph, the '
                             'head\'s forward and backward, one backward-'
                             'and-update graph): %s %s' % (stage_kinds,
                                                            custom_graphs))
    naive_params = numpy_params(naive_run['mod'])
    captured_params = numpy_params(mod)
    differ = sorted(k for k in captured_params
                    if not np.array_equal(captured_params[k],
                                          naive_params[k]))
    if differ:
        raise AssertionError('custom-train: captured and NaiveEngine '
                             'parameters differ in %d tensors, e.g. %s'
                             % (len(differ), differ[:3]))
    custom_profile = custom_stage_profile(torch, ccap)
    log({'phase': 'custom-train', 'model': 'resnet-50 v2', 'classes': 1000,
         'image': list(IMAGE), 'batch': BATCH, 'steps': steps,
         'head': 'Custom softmax_rtc (Rtc softmax_fwd / softmax_bwd)',
         'compute_dtype': 'float32', 'fuse': 'aggressive',
         'tf32_conv': torch.backends.cudnn.allow_tf32,
         'cudnn_deterministic': True,
         'optimizer': 'sgd lr 0.05 momentum 0.9 wd 1e-4',
         'capture': 'in segments: %s' % stage_kinds,
         'segments': 2, 'graphs': len(ccap.graphs),
         'user_calls_per_step': {
             k: v / steps for k, v in captured_run['user_calls'].items()},
         'launches': custom_launches, 'launches_per_step': expected,
         'naive_launches': naive_run['launches'],
         'fused_scale_bias_dot_launches_by_route': custom_routes,
         'fused_scale_bias_conv3x3_launches_by_route': custom_conv_routes,
         'fit_s': fit_s, 'step_ms': [t * 1e3 for t in step_s],
         'step_ms_median_after_warmup': step_ms,
         'naive_fit_s': naive_run['fit_s'],
         'naive_step_ms': [t * 1e3 for t in naive_run['step_s']],
         'naive_step_ms_median_after_warmup': naive_ms,
         'captured_over_naive': step_ms / naive_ms,
         'earlier_cudnn_deterministic': cudnn_det,
         'earlier_cudnn_step_ms': [t * 1e3 for t in earlier_run['step_s']],
         'earlier_cudnn_step_ms_median_after_warmup': statistics.median(
             earlier_run['step_s'][TRAIN_WARMUP:]) * 1e3,
         'params_bit_for_bit_vs_naive': True,
         'stage_profile': custom_profile,
         'images_per_s': BATCH / step_ms * 1e3,
         'peak_memory_bytes': captured_run['peak_memory_bytes'],
         'naive_peak_memory_bytes': naive_run['peak_memory_bytes'],
         'train_cross_entropy': metric['cross-entropy'],
         'train_accuracy': metric['accuracy'], 'max_param_change': moved,
         'graphs_report': custom_graphs})
    del mod, trained, ccap, custom_runs, captured_run, naive_run

    # -- 11b. warm-start: two processes over one compile cache -------------
    fresh_memory(torch)
    log({'phase': 'warm-start', **warm_start_phase()})

    # -- 12. custom-parity: one f32 step, Rtc head vs nd.* head ------------
    stepped = {}
    for ctx in (mx.gpu(0), mx.cpu()):
        t0 = time.monotonic()
        pmod, _ = train_module(mx, torch, csym, arg, aux,
                               images[:CUSTOM_PARITY_ROWS],
                               labels[:CUSTOM_PARITY_ROWS], ctx, None,
                               CUSTOM_PARITY_ROWS)
        stepped[ctx.device_type] = ({k: v.asnumpy() for k, v in
                                     pmod.get_params()[0].items()},
                                    time.monotonic() - t0)
        del pmod
    (card, card_s), (host, cpu_s) = stepped['gpu'], stepped['cpu']
    n_out, total, worst, outside = param_parity(card, host)
    log({'phase': 'custom-parity', 'rows': CUSTOM_PARITY_ROWS,
         'dtype': 'float32', 'tf32': False,
         'heads': 'Rtc on the card, nd.* on the CPU',
         'tolerance': 'rtol 1e-3, atol 1e-5 elementwise; at most 1e-4 of '
         'the elements outside it, none beyond 1e-3',
         'params': len(card), 'elements': total,
         'elements_outside': n_out, 'max_abs_err': worst[0],
         'worst_param': worst[1], 'outside_tolerance': outside,
         'card_s': card_s, 'cpu_s': cpu_s})
    if n_out > 1e-4 * total or worst[0] > 1e-3:
        raise AssertionError('custom-parity: %d of %d parameter elements '
                             'beyond rtol 1e-3, atol 1e-5, max abs err %g '
                             'in %s' % (n_out, total, worst[0], worst[1]))

    # -- 12b-12e. the training lifecycle ----------------------------------
    import tempfile
    resnet_kernels = (fused.fused_bn_relu, fused.fused_scale_bias_dot,
                      fused_conv.fused_scale_bias_conv3x3)
    resnet_expected = {'fused_scale_bias_dot': 36,
                       'fused_scale_bias_conv3x3': 16,
                       'fused_bn_relu': bn_relu_nodes}
    optim_expected = {
        'fused_scale_bias_dot': sum(optim_dots.values()),
        'fused_scale_bias_conv3x3': sum(optim_convs.values()),
        'fused_bn_relu': sum(optim_bn_relus.values())}
    t0 = time.monotonic()
    optim_report, optim_launches, failures = optim_train(
        mx, torch, optim_symbol, optim_arg, optim_aux, images, labels,
        resnet_kernels, optim_expected)
    log({'phase': 'optim-train', 'model': 'resnet v2, resnet-50\'s stages '
         'at full width, units %s' % OPTIM_UNITS, 'batch': BATCH,
         'steps': OPTIM_STEPS, 'compute_dtype': 'bfloat16 (f32 masters); '
         'f32 for captured-vs-loop', 'launches': optim_launches,
         'launches_per_step': optim_expected,
         'seconds': time.monotonic() - t0, 'optimizers': optim_report,
         'failures': failures})
    if failures:
        raise AssertionError('; '.join(failures))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.monotonic()
        ckpt_report, ckpt_launches = checkpoint_resume(
            mx, torch, symbol, arg, aux, images, labels, resnet_kernels,
            resnet_expected, tmp)
        log({'phase': 'checkpoint-resume', 'model': 'resnet-50 v2',
             'batch': BATCH, 'batches_per_epoch': CKPT_BATCHES,
             'optimizer': 'sgd %s' % SGD_MOMENTUM,
             'compute_dtype': 'bfloat16', 'launches': ckpt_launches,
             'seconds': time.monotonic() - t0, **ckpt_report})
        t0 = time.monotonic()
        ff_report, ff_bn_relu = feedforward_phase(
            mx, torch, fused, symbol, arg, aux, images, labels, tmp)
        log({'phase': 'feedforward', 'model': 'resnet-50 v2',
             'seconds': time.monotonic() - t0, **ff_report})
    t0 = time.monotonic()
    lm_adam_report, lm_adam_launches = lm_adam(
        mx, torch, models, lm_arg, (attention.flash_attention,
                                    fused.fused_dot_epilogue))
    log({'phase': 'lm-adam', 'seconds': time.monotonic() - t0,
         'launches': lm_adam_launches, **lm_adam_report})

    # -- 12f-12j. the rest of training and the nn ops ----------------------
    t0 = time.monotonic()
    mirror_report, failures, mirror_launches = mirror_train(
        mx, torch, ts, symbol, arg, aux, images, labels, lm_sym, lm_arg,
        resnet_kernels, (attention.flash_attention, fused.fused_dot_epilogue))
    log({'phase': 'mirror-train', 'steps': MIRROR_STEPS,
         'resnet': 'resnet-50 v2, 32 rows, bf16 over f32 masters, sgd '
                   'momentum, Module.fit captured',
         'lm': 'transformer_lm %d x %d, bf16, make_train_step captured'
               % (LM_BATCH, LM['seq_len']),
         'cudnn_deterministic': True, 'launches': mirror_launches,
         'seconds': time.monotonic() - t0, **mirror_report,
         'failures': failures})
    if failures:
        raise AssertionError('; '.join(failures))
    t0 = time.monotonic()
    monitor_report, failures, monitor_launches = monitor_fit(
        mx, torch, symbol, arg, aux, images, labels, resnet_kernels)
    log({'phase': 'monitor-fit', 'model': 'resnet-50 v2', 'batch': BATCH,
         'steps': MONITOR_STEPS, 'monitor': 'Monitor(2, pattern=%r)'
         % MONITOR_PATTERN, 'data': 'PrefetchingIter(ResizeIter('
         'NDArrayIter, %d))' % MONITOR_STEPS, 'dtype': 'float32',
         'tf32': False, 'launches': monitor_launches,
         'seconds': time.monotonic() - t0, **monitor_report,
         'failures': failures})
    if failures:
        raise AssertionError('; '.join(failures))
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        observe_report, failures, observe_launches = observe_fit(
            mx, torch, symbol, arg, aux, images, labels, resnet_kernels,
            resnet_expected, tmp)
    log({'phase': 'observe-fit', 'model': 'resnet-50 v2', 'batch': BATCH,
         'steps': OBS_STEPS, 'compute_dtype': 'bfloat16',
         'optimizer': 'sgd lr 0.05 momentum 0.9 wd 1e-4',
         'launches': observe_launches, 'seconds': time.monotonic() - t0,
         **observe_report, 'failures': failures})
    if failures:
        raise AssertionError('; '.join(failures))
    # the MLP's and AlexNet's FullyConnected -> relu chains run #3
    epi0 = fused.fused_dot_epilogue.launches
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.monotonic()
        mnist_report = mnist_lenet(mx, torch, models, convert, tmp)
        mnist_launches = fused.fused_dot_epilogue.launches - epi0
        log({'phase': 'mnist-lenet', 'seconds': time.monotonic() - t0,
             'launches': {'fused_dot_epilogue': mnist_launches},
             **mnist_report})
        t0 = time.monotonic()
        epi0 = fused.fused_dot_epilogue.launches
        native_report = native_engine_phase(mx, torch, models, convert, tmp)
        mnist_launches += fused.fused_dot_epilogue.launches - epi0
        log({'phase': 'native-engine', 'seconds': time.monotonic() - t0,
             **native_report})
    flush = torch.ones(32 << 20, device='cuda')    # 128 MiB
    t0 = time.monotonic()
    epi0 = fused.fused_dot_epilogue.launches
    alexnet_report = alexnet_train(mx, torch, models, convert, flush)
    alexnet_launches = fused.fused_dot_epilogue.launches - epi0
    log({'phase': 'alexnet-train', 'batch': BATCH, 'image': list(IMAGE),
         'steps': ALEXNET_STEPS, 'tf32': False,
         'launches': {'fused_dot_epilogue': alexnet_launches},
         **alexnet_report, 'seconds': time.monotonic() - t0})
    # #3 at the shapes these two paths give it, against its plain version
    torch.backends.cudnn.allow_tf32 = False
    fc_cases = []
    for name, shapes, dtypes in (
            ('alexnet', {'data': (BATCH,) + IMAGE},
             (torch.float32, torch.bfloat16)),
            ('mlp', {'data': (MNIST_BATCH, 784)}, (torch.float32,))):
        dots, _ = graph_kernel_shapes(
            mx, models.get_symbol(name, num_classes=1000 if name ==
                                  'alexnet' else 10), shapes)
        for dtype in dtypes:
            for (m, k, n, bias, relu, clip), per_step in sorted(
                    dots.items()):
                case = check_epilogue(torch, fused, (m, k, n), bias, relu,
                                      (0.0, 6.0) if clip else None, dtype,
                                      gen, flush)
                case.update(model=name, launches_per_step=per_step)
                fc_cases.append(case)
    torch.backends.cudnn.allow_tf32 = True
    log({'phase': 'fc-kernels', 'tf32': False,
         'fused_dot_epilogue_cases': fc_cases})
    t0 = time.monotonic()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    op_cases, failures = run_op_cases(torch, 'nn-ops', flush)
    torch.backends.cudnn.allow_tf32 = True
    del flush
    log({'phase': 'nn-ops', 'tf32': False, 'cases': op_cases,
         'seconds': time.monotonic() - t0, 'failures': failures})
    if failures:
        raise AssertionError('; '.join(failures))

    # -- 12k-12o. the PTB LSTM, SSD, the zoo, the last ops ----------------
    from mxnet_tpu_torch.ops import multibox as mb
    t0 = time.monotonic()
    lstm_report, lstm_buckets = lstm_ptb(mx, torch, models, ts)
    log({'phase': 'lstm-ptb', 'train_step': lstm_report,
         'bucketing_module': {'buckets_declared': list(LSTM_BUCKETS),
                              'rows': LSTM_ROWS, **lstm_buckets},
         'kernels': 'none (the RNN op is cuDNN through torch; no Pallas '
                    'kernel in the JAX package)',
         'seconds': time.monotonic() - t0})
    flush = torch.ones(32 << 20, device='cuda')    # 128 MiB
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.monotonic()
        ssd_report, nms, nms_extra = ssd_serve(mx, torch, models, convert,
                                               mb, tmp, flush)
        log({'phase': 'ssd', 'serve': ssd_report, 'multibox_nms': nms,
             'multibox_nms_off_path': nms_extra,
             'seconds': time.monotonic() - t0})
    t0 = time.monotonic()
    nms0 = mb.multibox_nms.launches
    ssd_train_report = ssd_train(mx, torch, models, convert)
    ssd_train_nms = mb.multibox_nms.launches - nms0
    log({'phase': 'ssd-train', **ssd_train_report,
         'multibox_nms_launches': ssd_train_nms,
         'seconds': time.monotonic() - t0})
    nms_launches = {'ssd-serve': ssd_report['multibox_nms_launches']}
    t0 = time.monotonic()
    zoo_kernel_set = (fused.fused_bn_relu, fused.fused_dot_epilogue,
                      fused.fused_scale_bias_dot,
                      fused_conv.fused_scale_bias_conv3x3)
    zoo_launches = {}
    zoo_runs = []
    for name, image, expected in (
            ('inception-v3', INCEPTION_IMAGE,
             {'fused_bn_relu': 84, 'fused_scale_bias_conv3x3': 10}),
            ('vgg16', IMAGE, {'fused_dot_epilogue': 2})):
        counts0 = launch_counts(zoo_kernel_set)
        zoo_runs.append(zoo_train(mx, torch, models, convert, name, image,
                                  zoo_kernel_set, expected))
        after = launch_counts(zoo_kernel_set)
        for k, (n_after, _) in after.items():
            zoo_launches.setdefault(k, {})[name] = n_after - counts0[k][0]
    log({'phase': 'zoo-train', 'runs': zoo_runs,
         'launches': zoo_launches, 'seconds': time.monotonic() - t0})
    t0 = time.monotonic()
    counts0 = launch_counts(zoo_kernel_set)
    zoo_evals = [zoo_eval(mx, torch, models, convert, ts, name, image, fuse,
                          zoo_kernel_set)
                 for name, image, fuse in (
                     ('inception-v3', INCEPTION_IMAGE, 'safe'),
                     ('inception-v3', INCEPTION_IMAGE, 'aggressive'),
                     ('vgg16', IMAGE, 'aggressive'))]
    eval_launches = {k: n - counts0[k][0] for k, (n, _) in
                     launch_counts(zoo_kernel_set).items()}
    counts0 = launch_counts(zoo_kernel_set)
    served_zoo = zoo_serve(mx, torch, models, convert, fused.fused_bn_relu)
    serve_launches = {k: n - counts0[k][0] for k, (n, _) in
                      launch_counts(zoo_kernel_set).items()}
    log({'phase': 'zoo-eval', 'eval_step': zoo_evals, 'served': served_zoo,
         'launches': {'eval_step': eval_launches, 'served': serve_launches},
         'seconds': time.monotonic() - t0})
    t0 = time.monotonic()
    zoo_bn, zoo_served_bn, served_by, zoo_conv, zoo_epi = zoo_kernels(
        mx, torch, fused, fused_conv, models, gen, flush, served_zoo)
    log({'phase': 'zoo-kernels', 'tf32': False,
         'fused_bn_relu_cases': zoo_bn,
         'fused_bn_relu_served_cases': zoo_served_bn,
         'fused_bn_relu_served_nodes': served_by,
         'fused_scale_bias_conv3x3_cases': zoo_conv,
         'fused_dot_epilogue_cases': zoo_epi,
         'seconds': time.monotonic() - t0})
    t0 = time.monotonic()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tail_cases, failures = run_op_cases(torch, 'tail-ops', flush)
    fill_cases, alive = pick_fill_cases(torch)
    if not alive or not all(c['equal_to_cpu'] for c in fill_cases):
        failures.append('tail-ops fill rule: %s, context alive %s'
                        % (fill_cases, alive))
    torch.backends.cudnn.allow_tf32 = True
    del flush
    log({'phase': 'tail-ops', 'tf32': False, 'cases': tail_cases,
         'fill_cases': fill_cases, 'context_alive': alive,
         'seconds': time.monotonic() - t0, 'failures': failures})
    if failures:
        raise AssertionError('; '.join(failures))

    # -- the kvstore data plane: context lists, dist_sync, dist_async ------
    t0 = time.monotonic()
    kv_kernel_set = (fused.fused_scale_bias_dot,
                     fused_conv.fused_scale_bias_conv3x3,
                     fused.fused_bn_relu)
    kv_cases = kv_kernel_cases(
        torch, fused, fused_conv, mx, symbol,
        torch.Generator(device='cuda').manual_seed(SEED + 19))
    kv_local_report, kv_local_launches, one_params = kv_local(
        mx, torch, symbol, arg, aux, kv_kernel_set, bn_relu_nodes)
    log({'phase': 'kv-local', 'model': 'resnet-50 v2', 'dtype': 'float32',
         'tf32': False, 'cudnn_deterministic': True,
         'launches': kv_local_launches, **kv_local_report,
         'kernel_cases': kv_cases, 'seconds': time.monotonic() - t0})
    import tempfile
    with tempfile.TemporaryDirectory() as kv_tmp:
        t0 = time.monotonic()
        sync_report, sync_launches = kv_dist_sync(
            mx, torch, symbol, arg, aux, one_params, bn_relu_nodes, kv_tmp)
        log({'phase': 'kv-dist-sync', 'model': 'resnet-50 v2',
             'dtype': 'float32', 'steps': KV_STEPS,
             'rows_per_rank': BATCH, 'launcher': 'tools/launch.py --launcher'
             ' local', 'launches': sync_launches, **sync_report,
             'seconds': time.monotonic() - t0})
        t0 = time.monotonic()
        async_report, async_launches = kv_dist_async(bn_relu_nodes,
                                                     kv_tmp)
        log({'phase': 'kv-dist-async', 'model': 'resnet-50 v2',
             'dtype': 'float32', 'workers': 2, 'rows_per_worker': BATCH,
             'fault': KV_FAULT, 'launches': async_launches, **async_report,
             'seconds': time.monotonic() - t0})
    del one_params
    log({'phase': 'feed-capture', **feed_capture_phase()})
    kv_launches = {k: kv_local_launches.get(k, 0) + sync_launches.get(k, 0)
                   + async_launches.get(k, 0) for k in kv_local_launches}

    # -- the dp x tp mesh: '1x1' captured, then ranks on gloo ----------------
    with tempfile.TemporaryDirectory() as mesh_tmp:
        t0 = time.monotonic()
        mesh_fit_report, mesh_fit_launches = mesh_fit(
            mx, torch, symbol, arg, aux, resnet_kernels, resnet_expected,
            mesh_tmp)
        log({'phase': 'mesh-fit', 'model': 'resnet-50 v2', 'batch': BATCH,
             'compute_dtype': 'bfloat16', 'optimizer': 'sgd lr 0.05 '
             'momentum 0.9 wd 1e-4', 'launches': mesh_fit_launches,
             **mesh_fit_report, 'seconds': time.monotonic() - t0})
        t0 = time.monotonic()
        mesh_ranks_report, mesh_ranks_launches = mesh_ranks(
            mx, torch, symbol, arg, aux, resnet_kernels, resnet_expected,
            mesh_tmp)
        log({'phase': 'mesh-ranks', 'model': 'resnet-50 v2',
             'launcher': 'tools/launch.py --launcher local, every rank on '
             'the one card (gloo)', 'launches': mesh_ranks_launches,
             **mesh_ranks_report, 'seconds': time.monotonic() - t0})
    mesh_launches = {k: mesh_fit_launches.get(k, 0)
                     + mesh_ranks_launches.get(k, 0)
                     for k in resnet_expected}

    # -- imagenet-rec: ResNet-50 v2 fed from a .rec through ImageRecordIter -
    with tempfile.TemporaryDirectory() as rec_tmp:
        t0 = time.monotonic()
        rec_report, rec_launches = imagenet_rec(
            mx, torch, symbol, arg, aux, resnet_kernels, resnet_expected,
            rec_tmp)
        log({'phase': 'imagenet-rec', 'model': 'resnet-50 v2',
             'batch': BATCH, 'compute_dtype': 'bfloat16',
             'optimizer': 'sgd lr 0.05 momentum 0.9 wd 1e-4',
             'launches': rec_launches, **rec_report,
             'seconds': time.monotonic() - t0})

    # -- serve-mesh: tensor-parallel replicas over [gpu(0)] * dp*tp --------
    t0 = time.monotonic()
    smesh_report, smesh_launches = serve_mesh(
        mx, torch, instrument, all_kernels, symbol,
        convert.params_from_numpy(arg, aux, 'cuda:0'))
    log({'phase': 'serve-mesh', 'model': 'resnet-50 v2', 'classes': 1000,
         'image': list(IMAGE), 'max_batch': BATCH, 'fuse': 'aggressive',
         'dtype': 'float32', 'tf32': False, 'cudnn_deterministic': True,
         'requests_per_mesh': SMESH_REQUESTS, 'clients': SMESH_CLIENTS,
         'launches': smesh_launches, **smesh_report,
         'seconds': time.monotonic() - t0})

    # -- group2ctx: the model-parallel LSTM LM ------------------------------
    t0 = time.monotonic()
    log({'phase': 'group2ctx', **group2ctx_phase(mx, torch, all_kernels),
         'seconds': time.monotonic() - t0})

    # -- summary -------------------------------------------------------------
    on_path = [c for c in cases if c['launches_per_forward']]
    summary = {
        'name': 'fused_bn_relu', 'route': 'cuda',
        'source': 'mxnet_tpu_torch/csrc/fused_bn_relu.cu',
        'replaces': 'mxnet_tpu/ops/pallas_fused.py:196',
        'launches': launches['fused_bn_relu']
        + train_launches['fused_bn_relu']
        + optim_launches['fused_bn_relu'] + ckpt_launches['fused_bn_relu']
        + ff_bn_relu + mirror_launches['fused_bn_relu']
        + monitor_launches['fused_bn_relu']
        + observe_launches['fused_bn_relu']
        + sum(zoo_launches['fused_bn_relu'].values())
        + serve_launches['fused_bn_relu'] + fleet_bn + auto_bn
        + kv_launches['fused_bn_relu'] + mesh_launches['fused_bn_relu']
        + rec_launches['fused_bn_relu'] + smesh_launches['fused_bn_relu'],
        'launches_by_path': {'serve': launches['fused_bn_relu'],
                             'fleet': fleet_bn, 'autoscale': auto_bn,
                             'train': train_launches['fused_bn_relu'],
                             'optim-train': optim_launches['fused_bn_relu'],
                             'checkpoint-resume':
                                 ckpt_launches['fused_bn_relu'],
                             'feedforward': ff_bn_relu,
                             'mirror-train': mirror_launches['fused_bn_relu'],
                             'monitor-fit':
                                 monitor_launches['fused_bn_relu'],
                             'observe-fit':
                                 observe_launches['fused_bn_relu'],
                             'zoo-train':
                                 sum(zoo_launches['fused_bn_relu'].values()),
                             'zoo-serve': serve_launches['fused_bn_relu'],
                             'kv-local': kv_local_launches['fused_bn_relu'],
                             'kv-dist-sync': sync_launches['fused_bn_relu'],
                             'kv-dist-async':
                                 async_launches['fused_bn_relu'],
                             'mesh-fit': mesh_fit_launches['fused_bn_relu'],
                             'mesh-ranks':
                                 mesh_ranks_launches['fused_bn_relu'],
                             'imagenet-rec': rec_launches['fused_bn_relu'],
                             'serve-mesh': smesh_launches['fused_bn_relu']},
        'max_abs_err': max(c['max_abs_err'] for c in
                           on_path + fleet_report['bn_relu_cases']
                           + kv_cases['fused_bn_relu']),
        # every bucket's shapes, checked in the fleet phase
        'fleet_cases': fleet_report['bn_relu_cases'],
        # the 17 launches of one 32-row forward: per-shape medians summed
        'ms': sum(c['ms'] * c['launches_per_forward'] for c in on_path),
        'plain_ms': sum(c['plain_ms'] * c['launches_per_forward']
                        for c in on_path),
        'bound_ms': sum(c['bound_ms'] * c['launches_per_forward']
                        for c in on_path),
        'bound_by': ('bytes' if all(c['bound_by'] == 'bytes'
                               for c in on_path) else 'operations'),
        'library_ms': None,
        'per': 'one 32-row serving forward, float32',
        'train_ms': sum(c['ms'] * c.get('launches_per_step', 0)
                        for c in cases),
        'train_bound_ms': sum(c['bound_ms'] * c.get('launches_per_step', 0)
                              for c in cases),
        'cases': cases, 'zoo_shapes': zoo_bn,
        'zoo_serve_shapes': zoo_served_bn}
    lm_per = 'one %d-row LM training step forward, bfloat16' % LM_BATCH
    kernels = [
        summary,
        {**gemm_summary('fused_scale_bias_dot', 'mxnet_tpu_torch/csrc/'
                        'fused_scale_bias_dot.cu',
                        'mxnet_tpu/ops/pallas_fused.py:72', dot_cases,
                        {'train': train_launches['fused_scale_bias_dot'],
                         'optim-train':
                             optim_launches['fused_scale_bias_dot'],
                         'checkpoint-resume':
                             ckpt_launches['fused_scale_bias_dot'],
                         'mirror-train':
                             mirror_launches['fused_scale_bias_dot'],
                         'monitor-fit':
                             monitor_launches['fused_scale_bias_dot'],
                         'observe-fit':
                             observe_launches['fused_scale_bias_dot'],
                         'zoo-serve': serve_launches['fused_scale_bias_dot'],
                         'kv-local': kv_local_launches['fused_scale_bias_dot'],
                         'kv-dist-sync': sync_launches['fused_scale_bias_dot'],
                         'kv-dist-async':
                             async_launches['fused_scale_bias_dot'],
                         'mesh-fit': mesh_fit_launches['fused_scale_bias_dot'],
                         'mesh-ranks':
                             mesh_ranks_launches['fused_scale_bias_dot'],
                         'imagenet-rec':
                             rec_launches['fused_scale_bias_dot']},
                        'torch.matmul on the normalized input'),
         **route_summary(dot_cases, {'train': train_routes,
                                     'custom-train': custom_routes})},
        {**gemm_summary('fused_scale_bias_conv3x3', 'mxnet_tpu_torch/csrc/'
                        'fused_scale_bias_conv3x3.cu',
                        'mxnet_tpu/ops/pallas_conv.py:91', conv_cases,
                        {'train': train_launches['fused_scale_bias_conv3x3'],
                         'optim-train':
                             optim_launches['fused_scale_bias_conv3x3'],
                         'checkpoint-resume':
                             ckpt_launches['fused_scale_bias_conv3x3'],
                         'mirror-train':
                             mirror_launches['fused_scale_bias_conv3x3'],
                         'monitor-fit':
                             monitor_launches['fused_scale_bias_conv3x3'],
                         'observe-fit':
                             observe_launches['fused_scale_bias_conv3x3'],
                         'zoo-train': sum(zoo_launches[
                             'fused_scale_bias_conv3x3'].values()),
                         'zoo-serve':
                             serve_launches['fused_scale_bias_conv3x3'],
                         'kv-local':
                             kv_local_launches['fused_scale_bias_conv3x3'],
                         'kv-dist-sync':
                             sync_launches['fused_scale_bias_conv3x3'],
                         'kv-dist-async':
                             async_launches['fused_scale_bias_conv3x3'],
                         'mesh-fit':
                             mesh_fit_launches['fused_scale_bias_conv3x3'],
                         'mesh-ranks':
                             mesh_ranks_launches['fused_scale_bias_conv3x3'],
                         'imagenet-rec':
                             rec_launches['fused_scale_bias_conv3x3']},
                        'F.conv2d on the normalized input'),
         **route_summary(conv_cases, {'train': train_conv_routes,
                                      'custom-train': custom_conv_routes}),
         'zoo_shapes': zoo_conv},
        {**gemm_summary('fused_dot_epilogue', 'mxnet_tpu_torch/csrc/'
                        'fused_dot_epilogue.cu',
                        'mxnet_tpu/ops/pallas_fused.py:328', epi_cases,
                        {'lm-train': lm_launches['fused_dot_epilogue'],
                         'bucket-train':
                             bucket_launches['fused_dot_epilogue'],
                         'lm-adam': lm_adam_launches['fused_dot_epilogue'],
                         'mirror-train':
                             mirror_launches['fused_dot_epilogue'],
                         'mnist-lenet': mnist_launches,
                         'alexnet-train': alexnet_launches,
                         'zoo-train': sum(zoo_launches[
                             'fused_dot_epilogue'].values()),
                         'zoo-eval': eval_launches['fused_dot_epilogue'],
                         'zoo-serve': serve_launches['fused_dot_epilogue']},
                        'torch.addmm (product and bias, no relu)', lm_per),
         **route_summary(epi_cases, {
             'lm-train': lm_routes,
             'bucket-train': bucket_routes['fused_dot_epilogue']}),
         'bucket_shapes': bucket_summary(bucket_epi),
         'zoo_shapes': zoo_epi},
        {**gemm_summary('flash_attention', 'mxnet_tpu_torch/csrc/'
                        'flash_attention.cu',
                        'mxnet_tpu/ops/pallas_attention.py:197', att_cases,
                        {'lm-train': lm_launches['flash_attention'],
                         'bucket-train': bucket_launches['flash_attention'],
                         'sp': sum(sp_launches.values()),
                         'lm-adam': lm_adam_launches['flash_attention'],
                         'mirror-train': mirror_launches['flash_attention']},
                        'F.scaled_dot_product_attention(is_causal=True)',
                        lm_per),
         **route_summary(att_cases, {
             'lm-train': flash_routes,
             'bucket-train': bucket_routes['flash_attention'],
             'sp': sp_launches}, 'mma'),
         'bucket_shapes': bucket_summary(bucket_att)},
        rtc_summary(rtc_cases, custom_launches['rtc']),
        nms_summary(nms, nms_launches)]
    # the kv paths' float32 shapes (a 16-row executor's, the dist
    # workers' BN-ReLUs at 32 rows): their own cases, in the error too
    for entry in kernels:
        cases_kv = kv_cases.get(entry['name'])
        if cases_kv:
            entry['kv_cases'] = cases_kv
            entry['max_abs_err'] = max(entry['max_abs_err'],
                                       max(c['max_abs_err']
                                           for c in cases_kv))
    print(smi, flush=True)
    log({'kernels': kernels})
    log({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    if sys.argv[1:2] == ['--warm-child']:
        sys.exit(warm_child())
    if sys.argv[1:2] == ['--abandon-child']:
        sys.exit(abandon_child(int(sys.argv[2])))
    if sys.argv[1:2] == ['--kv-worker']:
        sys.exit(kv_worker(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ['--mesh-worker']:
        sys.exit(mesh_worker(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ['--mesh-warm-child']:
        sys.exit(mesh_warm_child())
    sys.exit(main())
