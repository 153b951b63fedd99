#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card (H100): build its CUDA
kernels, hold each against its plain PyTorch version, run packed (varlen)
attention forward and backward through the op registry, serve Llama-3-8B
(full width and depth, random weights from a seed) through the ragged
continuous-batching engine, the gang-scheduled engine and ``generate()``
over the paged and the contiguous caches, with its ``observability``
series and spans, serve it
again quantized to int4 weights through the int4 GEMM kernel, multiply
block-pruned Llama-3-8B MLP weights through ``sparse.bcsr_matmul``, train
Llama-3-8B's width (8 layers) through ``TrainStep`` with AdamW and then
with Lamb, and again under selective and full recompute and with
stacked (scan) layers, then train DeepSeek-MoE-16B's width (5 layers) the
same way as the first through the grouped-GEMM kernel. The serving and
training steps run as CUDA graphs (step capture), each held against its
eager run; ``hapi.Model.fit`` also runs over DataLoader worker
processes, and a network built from the ported layers trains on the card
against the CPU. Then BERT-base fine-tunes on SQuAD-shaped batches and
the PP-OCR models (CRNN recognition, DBNet detection) train, at their own
widths, on the op table, ``nn.transformer``, ``nn.rnn`` and the CTC loss,
and ``paddle.vision``'s ResNet-18 (CIFAR-10, also through ``Model.fit``
over ``vision.datasets.Cifar10``), ResNet-50 and YOLOv3-DarkNet53 train
at their published widths, with every vision registry op and zoo model
held to the CPU; an audio front end (ESC-50), the decompositions at
Llama-3-8B's shapes, message passing and sampling at ogbn-arxiv's scale
and CRF decoding run on the card against the CPU; the registry's last
single-device entries run card vs CPU, and ResNet-50 trains
quantization-aware. Its dataset classes sit at module level and its run
under ``if __name__ == "__main__"``: the DataLoader's forkserver workers
import this script.

    python3 chip_smoke.py [--seed N] [--report PATH]

Phases (any failure raises and the script exits non-zero):

1. card and build: the card's name and power limit (nvidia-smi), then
   every ``paddle_tpu_torch/csrc/*.cu`` compiled by nvcc, one process per
   source, all started together, timed; each tensor-core kernel's
   registers, spills and shared memory (``ptxas[...]`` lines);
2. serving kernel checks at the serving path's head geometry (H=32, KV=8,
   D=128, BS=64, a 512-token step over 16 rows mixing decode rows, prefill
   chunks at several offsets, empty rows and padding tokens): each kernel
   against its plain version (the ragged kernels over bf16 and int8 pools,
   and float32; the gang-decode kernel over bf16 and int8 pools), with
   planted faults, timed with CUDA events beside its bound and one
   PyTorch library call (``scaled_dot_product_attention`` over the
   gathered, dequantized dense KV, timed here only: the port never calls
   it); the ragged kernels (split pass and merge for decode rows, a
   tensor-core tile pass for the other rows) also at the engine's decode
   step, its prefill step and a speculative verify step (RAGGED_MIXES),
   each against the plain mirror of their arithmetic at the call's split
   plan and tile schedule, with the wrapper's host time a call; the gang
   decode (a split-KV pass and a merge) also against the plain mirror of
   its split arithmetic at its split plan; each with GB/s, the share of
   the bound and two launches giving the same bytes;
3. training kernel checks at the training shapes (b 2, s 2048, 32/8 heads,
   d 128, causal; bf16 and float32): flash forward (out, lse), dq and
   dk/dv against the plain versions, with two planted faults that the
   limits must reject, each bf16 kernel launched twice for the same bytes,
   its TFLOP/s and share of the bound, and SDPA's own error against the
   plain version under the same limits; the fused AdamW kernel over one decoder layer plus
   the embedding (743M bf16 params, float32 masters) bit for bit against
   its plain version over three steps (plain; unscale and clip; found=1,
   which must keep every input); Lamb's two kernel passes with the trust
   ratios between them over the same bucket, bit for bit against the plain
   version over the same three steps, each part timed; each timed beside
   its bound and a library yardstick (SDPA forward and backward,
   ``torch._fused_adamw_``, also beside Lamb's first pass);
   the grouped GEMM at the MoE path's shapes (64 groups of capacity 480,
   K x N 2048 x 1408 and 1408 x 2048, counts with empty, partial and full
   groups; bf16 and float32; groups per expert 1 and 2; dx through the
   transposed view of w) against its plain version, with two planted
   faults (a zeroed live C tile, group g reading expert g mod E instead of
   g // 2), timed at the path's four launch shapes beside its bound and
   ``torch.bmm`` over the count-masked buffer, with TFLOP/s, GB/s, the
   share of the bound, the route the C entry took and two launches giving
   the same bytes; the int4 weight-only GEMM at Llama-3-8B's four (k, n)
   pairs and m 1, 4, 16, 37 and 512, plus two shapes with tails in m, n
   and k, in bf16 and float32 x, against its plain version, with two
   planted faults (the nibbles swapped, no sign extension), each case's
   route (decode with its k slices, prefill, or the WMMA route), timed at
   all four pairs at m 4, 16 (the engine's decode rows) and 512 beside its
   bound, ``torch.mm`` over the codes unpacked to bf16 and
   ``torch.matmul`` over the bf16 weight, with the same rates and two
   launches giving the same bytes; block-CSR SpMM through
   ``sparse.bcsr_from_dense`` and
   ``sparse.bcsr_matmul``, a path of its own, over Llama-3-8B's
   ``gate_proj`` and ``down_proj`` weights block-pruned in 128 x 128 blocks
   (about half kept by a mask from the seed, two block rows empty) times
   the transposed activations of 4096 tokens, bf16 and float32, and 16 x
   128 blocks at a smaller size: exactly one launch per call, the kernel
   against its plain version, three planted faults (a column id off by
   one, a run cut by one block, an empty row left unwritten), times beside
   the bound, ``torch.matmul`` over the zero-filled weight and torch's BSR
   product, with TFLOP/s, GB/s, the share of the bound and two launches
   giving the same bytes;
3b. packed (varlen) attention, a main path of its own, at Llama-3-8B's
   attention width (32/8 heads, d 128) over 16384 tokens of documents
   whose lengths are drawn log-uniform over 32-4096 from the seed (the
   last cut to fill), causal: bf16 and float32 self packing and a bf16
   cross packing (k documents in reverse order), each forward and backward
   through ``call_op("flash_attn_unpadded")`` and ``loss.backward()`` with
   exactly one launch of each of the three varlen kernels per call (counts
   reset before); then each kernel against its plain version (out, lse,
   dq, dk, dv), planted faults made with the plain formulation (segment
   mask dropped, lse one token off, causal bottom-right under cross
   packing), two launches of each bf16 kernel for the same bytes, the
   tiles walked and the share the mask skips, and times (with TFLOP/s and
   the share of the bound) beside the bound from the live pairs, the plain
   version, one library call (``varlen_attn`` where the installed torch
   has it, else masked SDPA; its own error against the plain version
   too) and the padded flash kernels over the same documents padded to
   batch x longest;
4. serving, the first main path: 16 requests through
   ``ContinuousBatchingEngine`` with a bf16 pool, again with an int8 pool,
   again with speculative decoding, then one paged ``generate()`` call;
   then one over an int8 pool (each ``generate()`` exactly one gang-decode
   launch per layer and decode step), all with the serving kernels' plain
   versions made to raise on a CUDA tensor; both serving kernels' launch
   counts must rise, every request must
   finish with in-vocabulary tokens, the bf16 run's peak memory must stay
   at slice 1's (restated by the step graph's pool bytes, measured in
   the run), and the model's last-position logits through the kernels
   must agree with the plain path's. The engine step is one CUDA graph:
   each of the bf16, int8 and speculative runs has 1 capture, steps - 1
   replays and no fallback, and after the path's counts are read the same
   requests run through the eager engine step (``FLAGS_step_capture=0``),
   which must give the same tokens; captured against eager: tokens/s,
   step p50/p99, TTFT, TPOT, peak memory, capture time and pool bytes.
   The captured bf16 run's ``serving.*`` series (``observability``)
   must equal its own tallies (admitted, finished, generated and
   prefilled tokens, steps, 16 TTFT observations), with one
   ``serving.step`` span a step; the same serve with ``FLAGS_metrics=0``
   and ``FLAGS_tracing=0`` records nothing, and the step time it saves is
   the host cost of metrics and tracing (``serving_metrics``). Then
   ``GangScheduledEngine`` serves the 16 requests (64 new tokens, a bf16
   pool; then 4 of them, 16 new, over an int8 pool): batch-1 prefills
   through the ragged kernel, one gang-decode launch per layer and step,
   its tokens held to the ragged engine's, a token differing only at a
   logit margin under ``FLIP_MARGIN_MAX`` (the rest of that request then
   not compared), every 8th step's last-layer gang-decode call held to
   the plain versions (``serve_gang``); ``generate()`` over the
   contiguous ``KVCache`` (4 prompts cut to 1024 tokens, 16 new) against
   the paged one under the same rule, and one masked, left-padded
   prefill through ``KVCache`` against the rows alone
   (``generate_contiguous``). Last, more runs (bf16 and int8 pools
   captured, bf16 eager) each profile one prefill step and three decode
   steps with torch.profiler (device time by kernel and by part, the
   busy share of wall); their launches are not counted;
4b. int4 serving, after the serving model is freed: the same model from
   the same seed, its bf16 logits of one prompt, then
   ``quantize_for_inference(model, "weight_only_int4")`` on the card
   (timed; model bytes before and after); the int4 logits through the
   kernel against the plain route (``FLAGS_use_pallas_kernels`` off) and,
   without a limit, against bf16; the same 16 requests with a bf16 pool,
   with exactly 224 int4 GEMM launches per engine step (counts reset just
   before), greedy agreement with the bf16 run's tokens, and the same
   capture checks against its eager run; a paged ``generate()``; a
   profiled run with the int4 GEMM as its own part;
5. training, the second main path, after the serving model is freed:
   ``LlamaForCausalLM`` at Llama-3-8B width with 8 layers (2.80 B params,
   bf16, float32 masters), ``LlamaPretrainingCriterion``,
   ``AdamW(lr 1e-4, weight_decay 0.01, ClipGradByGlobalNorm(1.0))``
   through ``TrainStep`` on an LCG-scrambled batch of 2 x 2048 tokens:
   first the hand-written eager loop (forward, loss, backward, ``step``,
   ``clear_grad``) twice from the seed's weights, which must agree bit for
   bit; then the loss and layer-0 grads through the kernels vs the plain
   versions, then the captured ``TrainStep`` (a probe, a warm-up and
   capture, 10 timed replays: tokens/s, step p50/p99, MFU as bench.py
   defines it, peak memory, every loss, which must be finite and fall),
   whose losses and final weights (params and float32 masters, by
   fingerprints of their bits) must equal the eager loop's,
   the four training kernels' launch counts (reset just before), one
   profiled step (device time by kernel and by part of the step), and a
   GradScaler step with a poisoned grad, which must be skipped with the
   params bitwise unchanged; then, with the AdamW optimizer gone, the
   same model trained on with ``Lamb(lr 1e-4, lamb_weight_decay 0.01,
   ClipGradByGlobalNorm(1.0), 1-D params excluded from decay)``: 2
   warm-up and 10 timed steps with the same metrics, exactly two Lamb
   launches per bucket per step and no AdamW launch, one profiled step;
6. MoE training, the third main path, after the Llama model is freed:
   ``MoEForCausalLM`` at DeepSeek-MoE-16B width (hidden 2048, 16 heads,
   64 routed experts of width 1408, 6 per token, 2 shared, the first layer
   dense) with 5 layers (2.855 B params, bf16), ``MoEPretrainingCriterion``
   and the same optimizer, step and batch: two eager loops of 6 steps
   (the expert sums' atomics are not bitwise), then the loss and the first MoE
   layer's expert and router grads through the grouped-GEMM kernel vs its
   plain version (that layer's routing must be equal), then 2 warm-up and
   10 timed steps (tokens/s, step p50/p99, MFU over the active params,
   peak memory, every loss; the first 6 losses within the eager loops'
   spread), exactly 24 grouped-GEMM launches per step,
   the choices dropped by capacity and each MoE layer's min/max counts,
   and one profiled step with the grouped GEMM as its own part;
5c. capture edges and ``Model.fit``: on a small linear layer a
   GradScaler step with an inf planted in a replay is skipped on the device
   (weights bitwise unchanged) and ``consume_anomaly()`` brings the step
   count back; a step that calls ``.item()`` falls back as "trace failed",
   random draws still work after the failed capture and its memory pool
   is gone; ``jit_step`` over an MLP with the fused AdamW, two batch
   shapes in turns, equals the eager loop bit for bit (each shape's eager
   probe rebuilds the buckets' chunk tables between the other shape's
   replays); then ``hapi.Model.fit`` over a shuffled ``io.DataLoader``
   (Llama-3-8B width, 2 layers, 2 epochs of 19 steps of 2 x 512, the lr
   halved after the first) eagerly, with single-step capture and with
   ``FLAGS_multi_step=4`` (per epoch four 4-step blocks and a 3-step
   tail: the K-step graph is captured in the first epoch's second block
   and replayed 6 times, the second epoch's at the halved lr), which must
   all give the same losses bit for bit; each graph's pool bytes (a
   K-step block's pool against a single step's); then once more with
   single-step capture over ``io.DataLoader(num_workers=2,
   persistent_workers=True)``, whose losses must equal the
   ``num_workers=0`` fit's bit for bit, from two worker processes other
   than this one;
5d. ``train_layers``, after phase 5: the 8-layer Llama-3-8B-width
   training of phase 5 (the same seed, batch, optimizer and captured
   ``TrainStep``) built three more ways, one at a time (each build's
   model, optimizer and graphs freed and the cache returned before the
   next; ``memory_reserved()`` printed at each start): list layers with
   ``recompute="selective"``, with ``recompute=True``, and
   ``use_scan_layers=True`` with ``recompute="selective"``; each 2 + 5
   steps (counts reset just before): its first 3 losses equal phase 5's
   bit for bit (the scan build: step 1 bit for bit, then within
   SCAN_LOSS_ATOL), flash forward launches per step twice phase 5's, dq,
   dk/dv and the fused optimizer's equal to phase 5's; tokens/s, step
   p50/p99, peak memory and the graph's pool bytes beside phase 5's;
5e. the layer surface, after phase 5c: a network built only from the
   ported layers (Conv2D, BatchNorm2D, ReLU, MaxPool2D, Flatten, Dropout
   with its own CUDA generator, Linear with a bias) trained with
   ``hapi.Model.fit`` over two worker processes, captured, for 2 epochs
   on the card and on the CPU from the same weights and Dropout masks:
   losses, weights and BatchNorm statistics within LAYER_NET_ATOL /
   LAYER_NET_REL; then ASGD (batch_num 3) under a captured ``TrainStep``
   for 6 steps with a poisoned batch at step 3, bit for bit its eager
   steps;
5f. ``bert_squad``: ``BertForQuestionAnswering(BertConfig.base())`` (hidden
   768, 12 layers, 12 heads, 108.9 M params) from the seed, fine-tuned as
   PaddleNLP's ``run_squad`` runs it: batch 12 x 384 tokens of random ids
   with a padded tail of 10-30% a row and a random span, AdamW (lr 3e-5,
   weight decay 0.01), global-norm clip 1.0, dropout 0.1; the mean of the
   start and end cross entropies; three runs of 10 ``TrainStep``s on the
   fixed batch: float32 captured, float32 eager (``FLAGS_step_capture=0``)
   and ``amp.decorate`` O2 bf16 captured; per run tokens/s, step p50/p99,
   peak memory, losses, MFU over 67 (float32) or 989 TFLOP/s (bf16) with
   6 N + 12 layers hidden seq FLOPs a token (N the non-embedding params),
   and the fused optimizer's launches; one profiled float32 step by part
   and the composite attention timed alone; the captured float32 losses
   must equal the eager ones bit for bit, every run's losses be finite and
   falling, and with dropout off the first loss at batch 2 be within
   BERT_CPU_REL of the CPU's from the same weights;
5g. ``ocr``: CRNN at PP-OCR rec's width (3 x 32 x 320, T 81, BiLSTM 256 ->
   96 x 2 layers, 97 classes) at batch 128 with labels of 1-25 symbols,
   Adam lr 1e-3 through ``CTCHeadLoss``: 10 captured and 10 eager steps,
   bit for bit (cuDNN's deterministic convolutions for the phase), each
   with images/s, step p50/p99, peak memory, losses and a profiled step's
   kernel count; its BiLSTM forward and backward eager and as a CUDA graph
   beside cuDNN's ``torch.nn.LSTM`` on the same weights (largest output
   difference within LSTM_CUDNN_ATOL), ``ctc_loss`` beside ``F.ctc_loss``;
   then DBNet (scale 0.5) at 3 x 640 x 640, batch 8, 5 captured steps;
   each model's first loss against the CPU from the same weights (CRNN at
   batch 8, DBNet at 1) within OCR_CPU_REL;
5h. ``eager_surface``: Paddle's canonical eager loop written as user code
   over ``import paddle_tpu_torch as paddle`` at phase 5's width (8
   layers, 2 x 2048, bf16, AdamW lr 1e-4, weight decay 0.01, global-norm
   clip 1.0): ``paddle.seed``, ids from ``paddle.randint`` on the card,
   inputs by ``Tensor`` slicing, then 6 steps of ``loss = crit(model(x),
   x)``, ``loss.backward()``, ``opt.step()``, ``opt.clear_grad()``,
   ``loss.item()``; the same 6 steps from the same weights over the same
   ids as plain tensors (``eager_llama_run``). The losses and the weights'
   fingerprint must be equal bit for bit, ``model(x)`` a ``Tensor``, one
   ``paddle.grad(loss, [embed.weight], retain_graph=True)`` equal to the
   step's accumulated grad, a ``no_grad`` forward ``stop_gradient``, and
   ``loss.numpy()`` equal ``loss.item()``; each loop's steps/s and host ms
   a step (the boundary's cost), the flash forward, dq and dk/dv launches
   (8 a step each) and fused AdamW's (1 a step), peak memory. Then
   ``rand``, ``randn``, ``randint``, ``bernoulli`` and ``multinomial`` at
   2^24 draws on the card (moments within MOMENT_SE standard errors, the
   same bytes after the same seed with ``torch.manual_seed`` between, each
   draw under ``jit_step`` over 4 calls equal to 4 eager draws: probe,
   warm-up, two replays of one graph), and the WGAN-GP penalty step with
   ``paddle.grad(create_graph=True)``, card against CPU within WGAN_REL;
5i. ``vision_cifar`` (``BASELINE.md`` config 1, ``bench.py:246-271``):
   ``vision.models.resnet18(num_classes=10)``, ``CrossEntropyLoss``,
   ``Momentum(lr 0.1, momentum 0.9)`` at b 256 x 3 x 32 x 32 float32
   through ``TrainStep``, 2 + 10 steps captured and 2 + 10 eager (cuDNN's
   deterministic convolutions: bit for bit), the eager run's Momentum
   bucket against the plain version bit for bit, the first loss against
   the CPU (VISION_CPU_REL); then ``hapi.Model.fit`` for one epoch over
   ``vision.datasets.Cifar10`` reading a 10,240-image CIFAR-10-format
   tar.gz written from the seed, RandomCrop(32, 4), RandomHorizontalFlip,
   Normalize and Transpose in 2 worker processes, ``prepare(metrics=
   Accuracy())``, the step captured (images/s, losses, accuracy, the
   evaluation of the test batch);
5j. ``vision_resnet50`` (PaddleClas ``ResNet50.yaml``): ``resnet50()``,
   1000 classes, 224 x 224, b 64, Momentum 0.9, lr 0.1, L2 1e-4: float32
   captured and eager, 2 + 10 steps each, bit for bit; O2 bf16 captured,
   finite and falling; MFU over 3 x 2 x 4.1 G multiply-adds an image; the
   fused Momentum kernel over ResNet-50's parameters, fresh tensors and
   the run's own padded bucket, bit for bit its plain version, timed
   beside its bound and ``torch._fused_sgd_``;
5k. ``vision_yolov3`` (PaddleDetection ``yolov3_darknet53_270e_coco``):
   ``yolov3_darknet53(num_classes=80)`` at 608 x 608, b 8, 1-50 gt boxes
   an image from the seed, Momentum 0.9, lr 0.001, L2 5e-4: 2 + 5 steps
   captured and 2 + 5 eager, bit for bit; ``predict`` (``yolo_box`` +
   ``multiclass_nms3``) on the first image from the seed's weights (the
   BatchNorm statistics taken from the batch) on the card and on the
   CPU: the same labels and indices, boxes and scores within
   YOLO_PREDICT_REL;
5l. ``vision_ops``: every registry entry of ``extra_nn.py``,
   ``detection.py`` and ``vision_io.py`` but ``decode_jpeg`` (PIL) at a
   size its models run (``roi_align`` over a 256 x 200 x 304 FPN level
   with 512 boxes, ``conv3d`` at 16 x 64 x 16 x 56 x 56, ...) on the card
   and on the CPU from the same inputs, within each case's limit, with
   the card's ms; then each zoo model's float32 forward at 224 x 224,
   batch 2, card against CPU within ZOO_REL; every vision phase prints
   images/s, step p50/p99, peak GiB, MFU, every loss, the fused
   optimizer's route and launches and a profiled step's kernels;
5m. the audio, linalg, graph, text and registry phases (no TPU kernel on
   their paths: each checks that none of the fourteen launched):
   ``audio_frontend`` (PANNs CNN14's front end as PaddleSpeech's ESC-50
   example sets it: 32 kHz, n_fft 1024, hop 320, Hann, 64 mels over
   50-14000 Hz; 64 seeded 5-second clips through ``LogMelSpectrogram``
   and ``MFCC(n_mfcc=40)`` card vs CPU in dB where the power exceeds
   1e3 amin; ``istft(stft(x))`` against x; 50 ESC-50-format WAVs (5 s,
   44.1 kHz, 16-bit, one a class) written through ``audio.save`` and
   read back through ``ESC50(mode="train", split=1)`` and a DataLoader
   of 16, each clip's features held to the clip alone; clips/s, ms a
   batch); ``linalg`` (float32: ``svd`` and ``qr`` of a 4096 x 14336
   matrix, a Llama-3-8B MLP gradient's shape as GaLore projects it;
   ``eigh`` / ``eigvalsh`` of its 4096 x 4096 Gram, a Shampoo
   preconditioner; ``solve``, ``cholesky_solve``, ``lstsq`` at 4096 with
   64 right-hand sides; ``det``, ``slogdet``, ``pinv``, ``matrix_rank``,
   ``lu`` + ``lu_unpack`` over 64 matrices of 256 x 256; each held by its
   invariants and to float64 numpy within LINALG_LIMITS, timed);
   ``graph`` (a seeded graph at ogbn-arxiv's scale, 169,343 nodes,
   1,166,243 edges, 128-d float32: ``send_u_recv`` SUM / MEAN / MAX,
   ``send_ue_recv`` MUL with edge weights and ``send_uv``, forward and
   backward card vs CPU; GraphSAGE's two-hop sampling, fanouts 25 and
   10 from 1024 seeds, with ``reindex_graph``, held by support and
   exactly); ``text_viterbi`` (64 x 128 tokens, 57 tags, lengths 1-128,
   both BOS/EOS modes: scores card vs CPU within 1e-4, paths equal where
   the decision margin exceeds it; eager and ``jit_step`` ms);
   ``registry_tranche`` (every other entry of the 98 linalg, fft, signal,
   math, graph and Viterbi entries card vs CPU at a size its users run,
   one backward where the reference has one); ``registry_tranche3`` (the
   46 last single-device entries: the compat tranche, the op forms of
   the optimizers, amp, the local ``c_*`` and fused ops,
   ``memory_efficient_attention``, ``fake_quantize`` and
   ``llm_int8_linear``, card vs CPU at TRANCHE3's sizes, each card ms at
   the full size); ``quant_qat`` (quantization-aware training of
   ``resnet50()`` at 224 x 224, b 64, eager, beside the plain model's
   eager step: images/s, step p50/p99, peak, losses, one fused Momentum
   launch a step, a profiled step by part; each quantized layer and the
   first loss card vs CPU; PTQ's int8 weights and logits card vs CPU; an
   observer refusing a captured step);
7. last, after every timed phase (a profiler session slows the launches
   that follow it): the kernels the card ran, by the profiler's names and
   with their device ms a call, for the ragged op at the smoke mix (bf16,
   int8 and float32 pools) and the engine's decode and prefill steps
   (bf16 and int8: the split pass, the tensor-core tile pass and the
   merge), for one gang decode over a bf16 and an int8 pool (the split-KV
   pass and its merge) and for ``sparse.bcsr_matmul`` at the block
   phase's bf16 and float32 shapes (the wgmma route with the M tile its
   ``bm`` picks, the FMA kernel).

Every kernel time is the median of CUDA-event windows around one call,
the L2 flushed before each and the card held busy while the host
enqueues the call, so host time never counts as device time.

Every phase runs through ``main``'s ``checked``: its seconds go to the
report, and it fails when the fused optimizer built a chunk-table row
whose pointers are not aligned to the kernel's vector accesses
(``fused_optimizer.unaligned_rows``): a training path has none.

Output: findings on earlier lines (a ``capture:`` line sums up every
captured-against-eager result), then the ``kernels`` JSON line
(fourteen kernels; the training kernels' entries add their
``train_amp`` and ``train_layers`` launches, the fused optimizer's its
``bert_squad``, ``ocr``, vision and ``quant_qat`` launches and its
Momentum time over ResNet-50's parameters), then as the last line ``{"ok": true, "device":
{...}}``. Exits
non-zero, printing no result, when no CUDA device is present or the
package is missing. A longer report goes to ``--report`` (default
``chiprun_out/chip_smoke_report.json``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import itertools
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12        # dense bf16 tensor-core peak, same source
F32_FLOPS_PER_S = 67e12          # float32 outside the tensor cores

# kernel vs plain tolerances: both accumulate in float32 and round the
# output once, so they differ by summation order (~1e-6 relative) and, in
# bf16, by at most one ulp of the final rounding (at most 2^-7 = 0.78% of
# |value|, within rtol 1e-2; atol 2e-3 covers outputs near 0, where the
# float32 sums cancel). Measured on an H100: max abs err 9.8e-4 (bf16),
# 2.0e-3 (int8 pool), 6e-7 (f32). planted_faults() shows every run that
# this limit rejects a kernel that skips one 64-position chunk or reads
# one wrong block.
TOL = {"bfloat16": dict(atol=2e-3, rtol=1e-2),
       "float32": dict(atol=1e-4, rtol=1e-4)}
# last-position logits of the 32-layer bf16 model, kernel path vs plain
# path: per-layer bf16 roundings of the attention output differ (one ulp)
# and compound through 32 random layers (measured on an H100: max abs err
# 0.23, cosine 0.9992, logit std 1.28); 0.5 is ~40% of the logits'
# spread, and the two vectors must point the same way
LOGITS_ATOL, LOGITS_MIN_COS = 0.5, 0.995
SERVE_PEAK_GIB = 23.12   # the bf16 serving run's peak before this slice
SERVING_KERNELS = ("ragged_paged_attention", "paged_attention")
TRAINING_KERNELS = ("flash_attention_fwd", "flash_attention_dq",
                    "flash_attention_dkv", "fused_optimizer")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


# device cycles (~0.2 ms) that the card spins at least before each timed
# call, so the wrapper's host work is enqueued before the start event runs
# and the events bracket device work only; a call whose host work takes
# longer (the fused optimizer's checks over ResNet-50's 161 tensors)
# spins 4e9 cycles a second of its warm-up call's host time, twice that
# time at ~2 GHz, at most ~2 ms (a call that waits on the card itself
# gains nothing from a longer hold)
HOLD_CYCLES = 400_000
HOLD_MAX_CYCLES = 4_000_000
HOLDS = []        # every timed run's hold, cycles (the script's cost)


def time_ms(torch, fn, iters: int = 10, flush=None) -> float:
    """Median CUDA-event time of ``fn()``; ``flush()`` (outside the timed
    window) evicts the L2 before each run, as a cold pool read would. The
    card is held busy while the host enqueues the call (longer than the
    warm-up call's host time), so a slow host adds no idle gap to the
    window."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    hold = min(HOLD_MAX_CYCLES, max(HOLD_CYCLES, int(
        4e9 * (time.perf_counter() - t0))))
    torch.cuda.synchronize()
    times = []
    HOLDS.extend([hold] * iters)
    for _ in range(iters):
        if flush is not None:
            flush()
        torch.cuda._sleep(hold)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(bytes_moved: int, flops: int, flops_rate: float):
    tb = bytes_moved / HBM_BYTES_PER_S * 1e3
    to = flops / flops_rate * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# -- phase 2: kernel checks --------------------------------------------------

# (q_len, context_len) per row of the checked step: 10 decode rows, prefill
# chunks at offsets 0, 256, 1024 and 1900, two empty rows; 498 of 512
# tokens used, so 14 are step padding
SMOKE_ROWS = [(1, 130), (1, 513), (1, 777), (1, 1024), (1, 1500),
              (1, 2047), (1, 2100), (1, 64), (1, 1), (1, 900),
              (256, 256), (128, 384), (64, 1088), (40, 1940), (0, 0), (0, 0)]
SMOKE_T, SMOKE_NB, SMOKE_MB, SMOKE_BS = 512, 1024, 128, 64
H, KV, D = 32, 8, 128


# the engine's steps at the serving geometry (the smoke's 1024-block pool,
# MB 128, BS 64, T 512): a decode step (16 decode rows at contexts
# 128-2112, 496 padding tokens), a prefill step (two 256-token chunks at
# contexts 2048 and 256; the table's other 14 rows at q_len 0) and a
# speculative verify step (16 rows of 1 + 4 tokens)
ENGINE_CTX = [int(c) for c in np.linspace(128, 2112, 16).round()]
RAGGED_MIXES = {
    "smoke_mix": SMOKE_ROWS,
    "engine_decode": [(1, c) for c in ENGINE_CTX],
    "engine_prefill": [(256, 2048), (256, 256)]
                      + [(0, c) for c in ENGINE_CTX[:14]],
    "spec_verify": [(5, c) for c in ENGINE_CTX],
}
# the ragged kernels by the stems of their symbols: the split pass and
# merge (decode rows), the tile pass (bf16 q: tensor cores; float32 q:
# CUDA cores)
RAGGED_TC_KERNEL = "ragged_paged_attention_tc_kernel"
RAGGED_F32_KERNEL = "ragged_paged_attention_kernel"
RAGGED_MERGE_KERNEL = "ragged_paged_attention_merge_kernel"


def mix_tables(rng, rows):
    """Block tables (each row owns random blocks of the pool, disjoint from
    the other rows'; entries past a context stay 0), context_lens and
    cu_q_lens of a mix of (q_len, context_len) rows, numpy int32."""
    qlens = [q for q, _ in rows]
    ctxs = [c for _, c in rows]
    cu = np.concatenate([[0], np.cumsum(qlens)]).astype(np.int32)
    tbl = np.zeros((len(rows), SMOKE_MB), np.int32)
    perm = rng.permutation(SMOKE_NB)
    nxt = 0
    for r, c in enumerate(ctxs):
        n = -(-c // SMOKE_BS)
        tbl[r, :n] = perm[nxt:nxt + n]
        nxt += n
    return tbl, np.asarray(ctxs, np.int32), cu


def smoke_layout(torch, rng, dtype, dev="cuda"):
    tbl, ctxs, cu = mix_tables(rng, SMOKE_ROWS)
    g = torch.Generator(device=dev).manual_seed(int(rng.randint(1 << 30)))
    shape = (SMOKE_NB, SMOKE_BS, KV, D)
    q = torch.randn((SMOKE_T, H, D), generator=g, device=dev).to(dtype)
    kp = torch.randn(shape, generator=g, device=dev).to(dtype)
    vp = torch.randn(shape, generator=g, device=dev).to(dtype)
    put = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return (q, kp, vp, put(tbl), put(ctxs), put(cu))


def dense_sdpa_inputs(torch, q, kp, vp, tbl, ctx, cu, ks=None, vs=None):
    """Padded dense tensors for one scaled_dot_product_attention call over
    the rows with query tokens: q [R', H, maxq, D], k/v [R', H, maxL, D]
    (kv heads repeated), bool mask [R', 1, maxq, maxL]."""
    cu_l, ctx_l = cu.tolist(), ctx.tolist()
    rows = [r for r in range(len(ctx_l)) if cu_l[r + 1] > cu_l[r]]
    maxq = max(cu_l[r + 1] - cu_l[r] for r in rows)
    maxl = max(ctx_l[r] for r in rows)
    Rp, G = len(rows), H // KV
    dt = q.dtype
    qd = torch.zeros((Rp, H, maxq, D), dtype=dt, device=q.device)
    kd = torch.zeros((Rp, H, maxl, D), dtype=dt, device=q.device)
    vd = torch.zeros_like(kd)
    mask = torch.zeros((Rp, 1, maxq, maxl), dtype=torch.bool,
                       device=q.device)
    bs = kp.shape[1]
    for i, r in enumerate(rows):
        ql, L = cu_l[r + 1] - cu_l[r], ctx_l[r]
        qd[i, :, :ql] = q[cu_l[r]:cu_l[r + 1]].transpose(0, 1)
        blocks = tbl[r, :-(-L // bs)].long()
        k = kp[blocks].float()
        v = vp[blocks].float()
        if ks is not None:
            k = k * ks[blocks][..., None]
            v = v * vs[blocks][..., None]
        k = k.reshape(-1, KV, D)[:L].to(dt)
        v = v.reshape(-1, KV, D)[:L].to(dt)
        kd[i, :, :L] = k.repeat_interleave(G, dim=1).transpose(0, 1)
        vd[i, :, :L] = v.repeat_interleave(G, dim=1).transpose(0, 1)
        qpos = L - ql + torch.arange(ql, device=q.device)
        mask[i, 0, :ql, :L] = (torch.arange(L, device=q.device)[None, :]
                               <= qpos[:, None])
        mask[i, 0, ql:, 0] = True          # padded query rows: one column
        if L == 0:
            mask[i, 0, :, 0] = True        # no context: keep SDPA finite
    return qd, kd, vd, mask


def check_close(torch, name, got, want, dtype_name, pad_from=None):
    tol = TOL[dtype_name]
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (g - w).abs()
    lim = tol["atol"] + tol["rtol"] * w.abs()
    if bool((err > lim).any()):
        raise AssertionError(
            f"{name}: kernel differs from plain version: max abs err "
            f"{float(err.max())} (atol {tol['atol']}, rtol {tol['rtol']})")
    if pad_from is not None and bool((got[pad_from:] != 0).any()):
        raise AssertionError(f"{name}: step-padding tokens are not zero")
    return float(err.max())


def planted_faults(torch, name, plain, args, kw, want, lens_at, decode):
    """Two faults a kernel could make in the longest decode row (where
    outputs are smallest), produced with the plain version on altered
    inputs, must each fail ``check_close`` against ``want``: skipping the
    row's last 64-position chunk, and reading one wrong pool block halfway
    along its context. ``args[lens_at]`` is the context lengths,
    ``args[3]`` the block tables, ``decode`` a bool per row. Returns each
    fault's max abs err."""
    lens, tbl = args[lens_at], args[3]
    r = int(torch.where(decode, lens, torch.zeros_like(lens)).argmax())
    short = lens.clone()
    short[r] -= SMOKE_BS
    spare = sorted(set(range(SMOKE_NB)) - set(tbl.flatten().tolist()))[-1]
    wrong = tbl.clone()
    wrong[r, int(lens[r]) // SMOKE_BS // 2] = spare
    errs = {}
    for fault, i, t in (("drop_last_chunk", lens_at, short),
                        ("wrong_block", 3, wrong)):
        bad = plain(*args[:i], t, *args[i + 1:], **kw)
        try:
            check_close(torch, name, bad, want, "bfloat16")
        except AssertionError:
            errs[fault] = float((bad.float() - want.float()).abs().max())
            continue
        raise AssertionError(f"{name}: the tolerance passes a planted "
                             f"fault ({fault})")
    return errs


# the gang-decode kernels (csrc/paged_attention.cu): the split-KV pass and
# its merge, by the stems of their symbols
DECODE_KERNELS = ("paged_attention_split_kernel",
                  "paged_attention_merge_kernel")


def profiled_kernels(torch, fn, stems, windows: int = 5):
    """The device activities that ``fn`` runs, by the names the profiler
    gives them, with each one's device ms a call: the route as the card
    took it (three calls a window). Every stem in ``stems`` must name one
    of them in one window. The profiler can lose a window's device records,
    all of them or some (one ragged window once kept only the merge kernel
    of its three calls' nine launches), so up to ``windows`` windows are
    taken until one holds every stem; each window that lacked one is kept
    in the result as ``lossy_windows``, and the call fails if no window
    held them all. A profiler that records no device time in any window
    leaves the route not measured (recorded, not raised)."""
    def run():
        for _ in range(3):
            fn()
    lossy, prof = [], {}
    for _ in range(windows):
        prof = profile_call(torch, run, 3)
        if "all_kernels" not in prof:
            continue
        names = sorted(prof["all_kernels"])
        missing = [t for t in stems if not any(t in n for n in names)]
        if not missing:
            break
        lossy.append({"kernels": [n[:120] for n in names],
                      "missing": missing})
    else:
        if lossy:
            raise AssertionError(f"in {windows} profiler windows the call "
                                 f"never ran all of {list(stems)}: {lossy}")
        return {"not_measured": prof.get("not_measured")}
    out = {"kernels": [n[:120] for n in names],
           "ms_per_call": {n[:120]: prof["all_kernels"][n] / 3
                           for n in names}}
    if lossy:
        out["lossy_windows"] = lossy
    return out


def host_us(torch, fn, n: int = 50) -> float:
    """Host microseconds per call of ``fn`` (the wrapper's checks, its
    allocations and the launches, not waited for)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def decode_extras(torch, pa, name, args, kw, ms, flops, nbytes, b_ms):
    """What the gang-decode lines add to a kernel's check: the split plan,
    the kernel against the plain mirror of its split pass and merge (at
    the plan's split length), two launches giving the same bytes, the
    wrapper's host time per call (``generate()`` makes 32 calls a token
    step), GB/s and the share of the bound."""
    sp, splits = pa.call_plan(args[0], args[1], args[3])
    call = lambda: pa.paged_attention(*args, **kw)  # noqa: E731
    got = call()
    split_err = check_close(
        torch, f"{name} vs its split-pass mirror", got,
        pa.paged_attention_split_plain(*args, sp=sp, **kw), "bfloat16")
    out = dict(split_positions=sp, splits=splits,
               max_abs_err_vs_split_mirror=split_err,
               bitwise_twice=bitwise_twice(torch, name, call),
               host_us_per_call=host_us(torch, call))
    out.update(achieved({"k": ms}, {"k": flops}, {"k": b_ms},
                        {"k": nbytes})["k"])
    return out


def ragged_case(torch, name, args, kw, kv_item, quant, flush, faults):
    """The ragged kernels at one mix and pool dtype: against the plain
    version (step padding exact zeros) and the plain mirror of their
    arithmetic at the call's split plan, planted faults (``faults``) in the
    longest row with query tokens, two calls giving the same bytes, the
    wrapper's host time a call (the engine makes 32 calls a step), kernel
    ms beside its bound, the plain version and SDPA over the gathered
    dense KV (timed here only)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa
    q, kp, vp, tbl, ctx, cu = args
    dname = "float32" if q.dtype == torch.float32 else "bfloat16"
    call = lambda: rpa.ragged_paged_attention(*args, **kw)  # noqa: E731
    plain = lambda: rpa.ragged_paged_attention_plain(*args, **kw)  # noqa
    pad_from = int(cu[-1])
    got = call()
    torch.cuda.synchronize()
    want = plain()
    err = check_close(torch, name, got, want, dname, pad_from)
    sp, splits = pa.call_plan(q, kp, tbl)
    piece, items = rpa.call_schedule(q, kp, tbl, ctx, cu)
    split_err = check_close(
        torch, f"{name} vs its split mirror", got,
        rpa.ragged_paged_attention_split_plain(*args, sp=sp, piece=piece,
                                               **kw), dname, pad_from)
    res = dict(max_abs_err=err, max_abs_err_vs_split_mirror=split_err,
               split_positions=sp, splits=splits, piece_steps=piece,
               tile_items=len(items),
               bitwise_twice=bitwise_twice(torch, name, call),
               host_us_per_call=host_us(torch, call))
    if faults:
        res["planted_fault_max_abs_err"] = planted_faults(
            torch, name, rpa.ragged_paged_attention_plain, args, kw, want, 4,
            (cu[1:] - cu[:-1]) > 0)
    ms = time_ms(torch, call, flush=flush)
    plain_ms = time_ms(torch, plain, iters=3, flush=flush)
    dq, dk, dv, mask = dense_sdpa_inputs(
        torch, q, kp, vp, tbl, ctx, cu, kw.get("k_scale"), kw.get("v_scale"))
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        dq, dk, dv, attn_mask=mask), flush=flush)
    del dq, dk, dv, mask
    # q is read for the live tokens only (below cu[R]); the output is
    # written whole, the step padding as zeros
    nbytes = ((int(cu[-1]) + q.shape[0]) * q[0].numel() * q.element_size()
              + rpa.kv_bytes_read(ctx, cu, SMOKE_BS, KV, D, kv_item, quant)
              + 4 * (tbl.numel() + ctx.numel() + cu.numel()))
    flops = rpa.attention_flops(ctx, cu, H, D)
    b_ms, b_by = bound(nbytes, flops, F32_FLOPS_PER_S
                       if dname == "float32" else BF16_FLOPS_PER_S)
    res.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=lib_ms, bytes=nbytes, flops=flops)
    res.update(achieved({"k": ms}, {"k": flops}, {"k": b_ms},
                        {"k": nbytes})["k"])
    log(f"ragged_paged_attention[{name}]: max_abs_err {err:.3e} (vs the "
        f"split mirror {split_err:.3e}) ms {ms:.4f} plain_ms "
        f"{plain_ms:.3f} library_ms {lib_ms:.4f} bound_ms {b_ms:.4f} "
        f"({b_by}), {res['bound_share']:.1%} of the bound; {splits} splits "
        f"of {sp} positions, {len(items)} tile pieces of <= {piece} steps, "
        f"two calls bitwise equal, "
        f"{res['host_us_per_call']:.1f} us of host time a call"
        + (f", planted faults rejected: "
           f"{res['planted_fault_max_abs_err']}" if faults else ""))
    return res


def quantized_pools(torch, kp, vp):
    """An int8 pool as the serving cache writes it (per token slot and kv
    head), with its scales."""
    from paddle_tpu_torch.ops.kernels.quant_common import (
        absmax_scale, quantize_symmetric)
    ks, vs = absmax_scale(kp, -1), absmax_scale(vp, -1)
    return (quantize_symmetric(kp, ks[..., None]),
            quantize_symmetric(vp, vs[..., None]), ks, vs)


def ragged_cases(torch, rng, layout, flush):
    """Every mix of RAGGED_MIXES over the smoke's pool: bf16 and int8
    pools (the smoke mix also float32). Keys: the smoke mix by dtype
    (``bfloat16``, ``int8``, ``float32``), the others ``<mix>/<dtype>``."""
    q, kp, vp, tbl, ctx, cu = layout
    kq, vq, ks, vs = quantized_pools(torch, kp, vp)
    g = torch.Generator(device="cuda").manual_seed(int(rng.randint(1 << 30)))
    put = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    res = {}
    for mix, rows in RAGGED_MIXES.items():
        if mix != "smoke_mix":
            t, c, u = mix_tables(rng, rows)
            q = torch.randn((SMOKE_T, H, D), generator=g,
                            device="cuda").to(torch.bfloat16)
            tbl, ctx, cu = put(t), put(c), put(u)
        cases = {"bfloat16": ((q, kp, vp, tbl, ctx, cu), {}, 2, False),
                 "int8": ((q, kq, vq, tbl, ctx, cu),
                          dict(k_scale=ks, v_scale=vs), 1, True)}
        if mix == "smoke_mix":
            cases["float32"] = ((q.float(), kp.float(), vp.float(), tbl, ctx,
                                 cu), {}, 4, False)
        for label, (args, kw, item, quant) in cases.items():
            key = label if mix == "smoke_mix" else f"{mix}/{label}"
            res[key] = ragged_case(torch, key, args, kw, item, quant, flush,
                                   faults=label != "float32")
            del args
        torch.cuda.empty_cache()
    return res


def phase_kernels(torch, seed, report):
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa
    import torch.nn.functional as F

    rng = np.random.RandomState(seed)
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    flush = lambda: scratch.zero_()  # noqa: E731  (> 50 MB L2)
    out = {}

    # ragged kernels over bf16 / int8 / float32 pools at the smoke mix,
    # then the engine's steps
    layout = smoke_layout(torch, rng, torch.bfloat16)
    out["ragged_paged_attention"] = ragged_cases(torch, rng, layout, flush)
    _, kp, vp, tbl, _, _ = layout

    # gang-decode kernel, bf16: 16 rows, one with context 0
    ctxs = np.array([c for _, c in SMOKE_ROWS], np.int32)
    ctxs[-1] = 0
    ctxs[-2] = 333
    B = len(ctxs)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    qd = torch.randn((B, 1, H, D), generator=g, device="cuda").to(
        torch.bfloat16)
    lens = torch.from_numpy(ctxs).cuda()
    tbl_d = tbl.clone()
    tbl_d[-2, :6] = torch.arange(SMOKE_NB - 6, SMOKE_NB, dtype=torch.int32,
                                 device="cuda")
    args = (qd, kp, vp, tbl_d, lens)
    got = pa.paged_attention(*args)
    torch.cuda.synchronize()
    want = pa.paged_attention_plain(*args)
    err = check_close(torch, "paged_attention[bfloat16]", got, want,
                      "bfloat16")
    if bool((got[-1] != 0).any()):
        raise AssertionError("paged_attention: context_len 0 row not zero")
    faults = planted_faults(torch, "paged_attention[bfloat16]",
                            pa.paged_attention_plain, args, {}, want, 4,
                            lens > 0)
    ms = time_ms(torch, lambda: pa.paged_attention(*args), flush=flush)
    plain_ms = time_ms(torch, lambda: pa.paged_attention_plain(*args),
                       iters=3, flush=flush)
    cu1 = torch.arange(B + 1, dtype=torch.int32, device="cuda")
    keep = lens > 0
    sq, sk, sv, mask = dense_sdpa_inputs(torch, qd[:, 0], kp, vp, tbl_d, lens,
                                         cu1)
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        sq, sk, sv, attn_mask=mask), flush=flush)
    del sq, sk, sv, mask
    nbytes = (2 * qd.numel() * 2
              + rpa.kv_bytes_read(lens, cu1, SMOKE_BS, KV, D, 2, False)
              + 4 * (tbl_d.numel() + B))
    flops = rpa.attention_flops(lens, cu1, H, D)
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
    extra = decode_extras(torch, pa, "paged_attention[bfloat16]", args, {},
                          ms, flops, nbytes, b_ms)
    out["paged_attention"] = {"bfloat16": dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, bytes=nbytes, flops=flops,
        rows_with_context=int(keep.sum()), planted_fault_max_abs_err=faults,
        **extra)}
    log(f"paged_attention[bfloat16]: max_abs_err {err:.3e} ms {ms:.4f} "
        f"plain_ms {plain_ms:.3f} library_ms {lib_ms:.4f} "
        f"bound_ms {b_ms:.4f} ({b_by}), {extra['gbps']:.0f} GB/s, "
        f"{extra['bound_share']:.1%} of the bound, planted faults "
        f"rejected: {faults}; {extra['splits']} splits of "
        f"{extra['split_positions']} positions, max abs err vs the split "
        f"mirror {extra['max_abs_err_vs_split_mirror']:.3e}, two launches "
        f"bitwise equal, {extra['host_us_per_call']:.1f} us of host time a "
        f"call")

    # gang-decode kernel over an int8 pool: the same rows and blocks, the
    # pool quantized per token slot as the serving cache writes it
    kq, vq, ks, vs = quantized_pools(torch, kp, vp)
    args = (qd, kq, vq, tbl_d, lens)
    kw = dict(k_scale=ks, v_scale=vs)
    got = pa.paged_attention(*args, **kw)
    torch.cuda.synchronize()
    want = pa.paged_attention_plain(*args, **kw)
    err = check_close(torch, "paged_attention[int8]", got, want, "bfloat16")
    if bool((got[-1] != 0).any()):
        raise AssertionError("paged_attention[int8]: context_len 0 row not "
                             "zero")
    faults = planted_faults(torch, "paged_attention[int8]",
                            pa.paged_attention_plain, args, kw, want, 4,
                            lens > 0)
    ms = time_ms(torch, lambda: pa.paged_attention(*args, **kw), flush=flush)
    plain_ms = time_ms(torch, lambda: pa.paged_attention_plain(*args, **kw),
                       iters=3, flush=flush)
    # yardstick, timed here only: SDPA over the dequantized pool
    sq, sk, sv, mask = dense_sdpa_inputs(torch, qd[:, 0], args[1], args[2],
                                         tbl_d, lens, cu1, ks, vs)
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        sq, sk, sv, attn_mask=mask), flush=flush)
    del sq, sk, sv, mask
    nbytes = (2 * qd.numel() * 2
              + rpa.kv_bytes_read(lens, cu1, SMOKE_BS, KV, D, 1, True)
              + 4 * (tbl_d.numel() + B))
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
    extra = decode_extras(torch, pa, "paged_attention[int8]", args, kw, ms,
                          flops, nbytes, b_ms)
    out["paged_attention"]["int8"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, bytes=nbytes, flops=flops,
        planted_fault_max_abs_err=faults, **extra)
    log(f"paged_attention[int8]: max_abs_err {err:.3e} ms {ms:.4f} "
        f"plain_ms {plain_ms:.3f} library_ms {lib_ms:.4f} (SDPA over the "
        f"dequantized pool) bound_ms {b_ms:.4f} ({b_by}), "
        f"{extra['gbps']:.0f} GB/s, {extra['bound_share']:.1%} of the "
        f"bound, planted faults rejected: {faults}; max abs err vs the "
        f"split mirror {extra['max_abs_err_vs_split_mirror']:.3e}, two "
        f"launches bitwise equal, {extra['host_us_per_call']:.1f} us of "
        f"host time a call")
    del scratch
    report["kernels"] = out
    return out


# -- phase 3: the main path --------------------------------------------------

def make_requests(cfg, seed: int, n: int = 16, shared_prefix: int = 512):
    """n prompts of 128..2048 tokens from the seed; the last one shares
    the first ``shared_prefix`` tokens of the first (a prefix-cache hit)."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(128, 2049, size=n)
    lens[0] = max(lens[0], shared_prefix + 64)
    prompts = [rng.randint(0, cfg.vocab_size, size=int(L)).astype(np.int32)
               for L in lens]
    prompts[-1] = np.concatenate(
        [prompts[0][:shared_prefix], prompts[-1][shared_prefix:]]
        if len(prompts[-1]) > shared_prefix else
        [prompts[0][:shared_prefix], prompts[-1]])
    return prompts


def device_activity(prof):
    """The device's own activities (kernels, copies, sets) of a profile:
    ``(name, start_us, end_us)``. CPU ops and the GPU-side annotations
    that span an op's kernels are left out, so nothing counts twice."""
    out = []
    for ev in prof.events():
        if str(ev.device_type).endswith("CPU") or \
                getattr(ev, "is_user_annotation", False) or \
                "annotation" in str(getattr(ev, "activity_type", "")).lower():
            continue
        tr = ev.time_range
        if tr.end > tr.start:
            out.append((ev.name, tr.start, tr.end))
    return out


def profile_call(torch, fn, n: int):
    """Run ``fn()`` under torch.profiler: device time by kernel (top 8,
    plus ``all_kernels``, every kernel's ms), device busy time (the union
    of the device's activity intervals), wall time and the busy share,
    each per ``n`` units of work (engine or train steps). If the profiler
    itself fails to start, stop or parse, the window is recorded as not
    measured; a failure of ``fn`` raises as anywhere else."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except Exception as e:   # profiler set-up only
        prof, why = None, f"{type(e).__name__}: {e}"
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if prof is None:
        return {"not_measured": why}
    try:
        prof.stop()
        acts = device_activity(prof)
    except Exception as e:   # trace collection and parsing only
        return {"not_measured": f"{type(e).__name__}: {e}"}
    if not acts:
        return {"not_measured": "profiler recorded no device time",
                "wall_ms": 1e3 * wall}
    by_name = {}
    for name, a, b in acts:
        ms, calls = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (b - a) / 1e3, calls + 1)
    busy_us, end = 0.0, float("-inf")
    for _, a, b in sorted(acts, key=lambda x: x[1]):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    busy = busy_us / 1e3
    span = (max(b for _, _, b in acts) - min(a for _, a, _ in acts)) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"steps": n, "wall_ms": 1e3 * wall, "device_busy_ms": busy,
            "launches": sum(c for _, c in by_name.values()),
            "device_busy_ms_per_step": busy / n,
            "device_span_ms": span, "busy_share_of_span": busy / span,
            "busy_share_of_wall": busy / (1e3 * wall),
            "top": [{"kernel": k[:90], "ms": ms, "calls": c}
                    for k, (ms, c) in top],
            "all_kernels": {k: ms for k, (ms, _) in by_name.items()}}


def profile_steps(torch, eng, n, outs):
    """``n`` engine steps under the profiler (see :func:`profile_call`)."""
    def run():
        for _ in range(n):
            for req in eng.step():
                outs[req.rid] = list(req.out_tokens)
    prof = profile_call(torch, run, n)
    if "all_kernels" in prof:
        prof["by_part_ms"] = categorize(prof.pop("all_kernels"),
                                        prof["device_busy_ms"])
    return prof


def serve(torch, model, prompts, new_tokens, profile=False,
          before_step=None, **engine_kw):
    """Run the engine over ``prompts`` (the last one arrives after four
    steps, once the first one's shared prefix is in the prefix cache).
    Returns (outputs by rid, metrics). With ``profile``, two windows run
    under the profiler (their steps stay out of the step percentiles, but
    the run's wall time and TTFT include them: profile in a run of its
    own). ``before_step(i)`` runs before step ``i``, off its clock."""
    from paddle_tpu_torch.jit import capture_counters
    from paddle_tpu_torch.models import ContinuousBatchingEngine
    from paddle_tpu_torch.observability import tracing
    eng = ContinuousBatchingEngine(
        model, max_batch=16, block_size=64, token_budget=512,
        prefill_chunk=256, kv_pool_bytes=8 << 30, temperature=0.0,
        **engine_kw)
    # the run's own tally of the tokens the engine wrote into the pool
    written, write_slots = [0], eng._write_slots

    def tally(i, pos0, n):
        written[0] += n
        return write_slots(i, pos0, n)
    eng._write_slots = tally
    series0 = serving_series()
    tracing.clear()
    fallbacks0 = capture_counters["fallbacks"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for p in prompts[:-1]:
        eng.add_request(p, max_new_tokens=new_tokens)
    step_s = []
    late = False
    outs = {}
    profiles = {}
    while eng.pending or eng.num_active or not late:
        if not late and (eng.steps >= 4
                         or not (eng.pending or eng.num_active)):
            eng.add_request(prompts[-1], max_new_tokens=new_tokens)
            late = True
        # profiled windows (their steps stay out of the step percentiles):
        # the second step (prefill chunks of every row) and, once every
        # row decodes, three decode steps
        decoding = late and not eng.pending and all(
            r.ctx >= r.target for r in eng.slots if r is not None)
        window = ("prefill" if eng.steps == 1 else
                  "decode" if decoding and eng.num_active == len(prompts)
                  else None)
        if profile and window and window not in profiles:
            profiles[window] = profile_steps(
                torch, eng, 1 if window == "prefill" else 3, outs)
            continue
        if before_step is not None:
            before_step(eng.steps)
        ts = time.perf_counter()
        for req in eng.step():
            outs[req.rid] = list(req.out_tokens)
        step_s.append(time.perf_counter() - ts)
    wall = time.perf_counter() - t0
    chrome = tracing.to_chrome()["traceEvents"]
    reqs = [eng.results[r] for r in sorted(eng.results)]
    ttft = [r.t_first - r.t_arrive for r in reqs]
    tpot = [(r.t_done - r.t_first) / (len(r.out_tokens) - 1) for r in reqs
            if len(r.out_tokens) > 1]
    gen = sum(len(r.out_tokens) for r in reqs)
    m = dict(requests=len(reqs), generated_tokens=gen,
             prompt_tokens=int(sum(len(p) for p in prompts)),
             wall_s=wall, tokens_per_s=gen / wall, steps=eng.steps,
             step_ms_p50=1e3 * float(np.percentile(step_s, 50)),
             step_ms_p99=1e3 * float(np.percentile(step_s, 99)),
             step_ms_mean=1e3 * float(np.mean(step_s)), step_s=step_s,
             ttft_ms_p50=1e3 * float(np.percentile(ttft, 50)),
             ttft_ms_p99=1e3 * float(np.percentile(ttft, 99)),
             tpot_ms_p50=1e3 * float(np.percentile(tpot, 50)),
             tpot_ms_p99=1e3 * float(np.percentile(tpot, 99)),
             peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
             num_blocks=eng.cache.k[0].shape[0],
             kv_dtype=eng.cache.kv_dtype,
             metrics=series_delta(series0, serving_series()),
             tallies=dict(
                 admitted=sum(r.admit_order >= 0 for r in reqs),
                 finished=sum(r.done for r in reqs),
                 generated_tokens=gen, pool_writes=written[0],
                 # spec off: every decode write is one emitted token but
                 # the request's first (sampled off its prefill)
                 prefill_tokens=written[0] - (gen - len(reqs))),
             spans=dict(
                 serving_step=sum(e["name"] == "serving.step"
                                  for e in chrome),
                 recorded=len(chrome)),
             profile=profiles,
             capture=dict(eng.capture_stats, fallbacks=capture_counters[
                 "fallbacks"] - fallbacks0))
    for rid, toks in outs.items():
        if len(toks) != new_tokens:
            raise AssertionError(f"request {rid} emitted {len(toks)} of "
                                 f"{new_tokens} tokens")
        if min(toks) < 0 or max(toks) >= model.config.vocab_size:
            raise AssertionError(f"request {rid}: token out of vocabulary")
    if len(outs) != len(prompts):
        raise AssertionError(f"{len(outs)} of {len(prompts)} finished")
    del eng._write_slots          # the tally's cycle would keep the pool
    del eng
    torch.cuda.empty_cache()
    return outs, m


def serving_series() -> dict:
    """Every ``serving.*`` instrument of the port's registry: a counter's
    or gauge's value, a histogram's count (``name.count``) and its p50 /
    p99 upper bounds."""
    from paddle_tpu_torch import observability
    out = {}
    for key, snap in observability.snapshot().items():
        if not key.startswith("serving."):
            continue
        if snap["type"] == "histogram":
            h = observability.registry().get(key)
            out[key + ".count"] = snap["count"]
            out[key + ".p50"] = h.quantile(0.5)
            out[key + ".p99"] = h.quantile(0.99)
        else:
            out[key] = snap["value"]
    return out


def series_delta(before: dict, after: dict) -> dict:
    """Counters and histogram counts as increments, the rest as read."""
    from paddle_tpu_torch import observability
    reg = observability.registry()
    out = {}
    for k, v in after.items():
        m = reg.get(k.rsplit(".", 1)[0] if k.endswith(
            (".count", ".p50", ".p99")) else k)
        inc = k.endswith(".count") or getattr(m, "kind", "") == "counter"
        out[k] = v - before.get(k, 0) if inc else v
    return out


def eager_serve(torch, model, prompts, new_tokens, **kw):
    """:func:`serve` with ``FLAGS_step_capture`` off: the eager engine
    step, the baseline of a captured run over the same requests."""
    from paddle_tpu_torch import flags
    flags.set_flags({"step_capture": False})
    try:
        return serve(torch, model, prompts, new_tokens, **kw)
    finally:
        flags.set_flags({"step_capture": True})


SERVE_METRICS = ("tokens_per_s", "step_ms_p50", "step_ms_p99", "ttft_ms_p50",
                 "ttft_ms_p99", "tpot_ms_p50", "tpot_ms_p99", "peak_mem_gib")


def check_capture(label, m, outs, m_eager, outs_eager):
    """A captured serve run against its eager run over the same requests:
    token-identical, one capture, steps - 1 replays, no eager step and no
    fallback. Returns the captured-vs-eager comparison."""
    c = m["capture"]
    if outs != outs_eager:
        raise AssertionError(f"{label}: captured tokens differ from the "
                             f"eager run's: {agree(outs, outs_eager)}")
    if (c["captures"], c["replays"], c["eager_steps"], c["fallbacks"]) != \
            (1, m["steps"] - 1, 0, 0):
        raise AssertionError(f"{label}: capture stats {c} over "
                             f"{m['steps']} steps, want 1 capture, "
                             f"{m['steps'] - 1} replays, 0 fallbacks")
    if m_eager["capture"]["eager_steps"] != m_eager["steps"]:
        raise AssertionError(f"{label}: the eager run captured: "
                             f"{m_eager['capture']}")
    return {"token_identical": True, "captures": c["captures"],
            "replays": c["replays"], "capture_s": c["capture_s"],
            "pool_bytes": c["pool_bytes"],
            "captured": {k: m[k] for k in SERVE_METRICS},
            "eager": {k: m_eager[k] for k in SERVE_METRICS}}


def prompt_logits(torch, model, prompt, kv="bf16", cache_cls=None):
    """Last-position float32 logits of one prompt, prefilled through a
    fresh paged cache (``cache_cls``, default ``PagedKVCache``)."""
    from paddle_tpu_torch.models.generation import PagedKVCache
    cfg = model.config
    dev = next(model.parameters()).device
    mb = -(-len(prompt) // 64)
    cache = (cache_cls or PagedKVCache)(
        cfg.num_hidden_layers, 1, num_blocks=mb, block_size=64,
        num_kv_heads=cfg.num_key_value_heads,
        head_dim=cfg.hidden_size // cfg.num_attention_heads,
        max_blocks_per_seq=mb, dtype=cfg.dtype, kv_dtype=kv, device=dev)
    ids = torch.from_numpy(prompt[None]).to(dev)
    return model(ids, cache=cache, start_pos=0)[0, -1].float()


def cosine(torch, a, b) -> float:
    return float(torch.nn.functional.cosine_similarity(a, b, dim=0))


def logits_check(torch, model, prompt):
    """Last-position logits of one prompt through the kernels and through
    the plain attention, both on the card, with a bf16 and with an int8
    pool; and how far the int8 pool moves the logits from the bf16 one."""
    from paddle_tpu_torch.models.generation import PagedKVCache
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa

    class PlainCache(PagedKVCache):
        def attend(self, layer, q, pos=None, attn_mask=None):
            tables, lens, cu = self._dev_meta
            b, s, h, d = q.shape
            return rpa.ragged_paged_attention_plain(
                q.reshape(b * s, h, d), self.k[layer], self.v[layer], tables,
                lens, cu, **self.scale_kwargs(layer)).reshape(b, s, h, d)

    out, logits = {}, {}
    for kv in ("bf16", "int8"):
        a, b = (prompt_logits(torch, model, prompt, kv, cls)
                for cls in (PagedKVCache, PlainCache))
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"kernel-path logits ({kv}) are not finite")
        err, cos = float((a - b).abs().max()), cosine(torch, a, b)
        if err > LOGITS_ATOL or cos < LOGITS_MIN_COS:
            raise AssertionError(
                f"logits ({kv} pool): kernel vs plain path max abs err {err} "
                f"(atol {LOGITS_ATOL}), cosine {cos}")
        out[kv] = dict(max_abs_err=err, cosine=cos, std=float(b.std()),
                       argmax_equal=bool(a.argmax() == b.argmax()))
        logits[kv] = a
    a, b = logits["int8"], logits["bf16"]
    out["int8_vs_bf16"] = dict(max_abs_err=float((a - b).abs().max()),
                               cosine=cosine(torch, a, b),
                               argmax_equal=bool(a.argmax() == b.argmax()))
    return out


def agree(a, b, first=False):
    """Share of greedy tokens of run ``a`` equal to run ``b``'s, over all
    positions or over the first token of each request."""
    pairs = [(x, y) for r in a for x, y in zip(a[r][:1 if first else None],
                                               b[r])]
    return sum(x == y for x, y in pairs) / len(pairs)


@contextlib.contextmanager
def no_plain_on_card():
    """The serving kernels' plain versions raise when a CUDA tensor reaches
    them: on the card the serving path launches the kernels."""
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa
    slots = [(pa, "paged_attention_plain"),
             (pa, "ragged_paged_attention_plain"),
             (rpa, "ragged_paged_attention_plain")]
    saved = [getattr(m, name) for m, name in slots]

    def guard(name, fn):
        def call(q, *args, **kw):
            if q.is_cuda:
                raise AssertionError(f"{name}, the plain version, ran on the "
                                     f"card on the serving path")
            return fn(q, *args, **kw)
        return call
    for (m, name), fn in zip(slots, saved):
        setattr(m, name, guard(name, fn))
    try:
        yield
    finally:
        for (m, name), fn in zip(slots, saved):
            setattr(m, name, fn)


# a greedy token that flips between the gang-decode kernel's generate()
# and the plain attention's must sit where its two candidates' logits
# nearly tie: each path's logits lie within LOGITS_ATOL of the other's
# (logits_check), so a flip from rounding needs the candidates' gap under
# a third path (the prefill's) to be at most twice that. A wrong kernel
# picks a token far down the plain path's list (logit std ~1.28 here)
FLIP_MARGIN_MAX = 2 * LOGITS_ATOL
GEN_NEW_TOKENS = 16     # generate()'s new tokens: 15 decode steps


@contextlib.contextmanager
def decode_capture(torch, layers, every: int = 1):
    """Records the gang-decode calls of the last layer (every ``layers``-th
    call; of those, every ``every``-th from the first) on the path that
    runs inside: each call's inputs and the kernel's output, cloned, to be
    held against the plain versions after the run. The kernel's launch
    and count are the path's own."""
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    launch, calls, n = pa.paged_attention, [], itertools.count(1)

    def clone(t):
        return t.clone() if torch.is_tensor(t) else t

    def record(*args, **kw):
        out = launch(*args, **kw)
        i = next(n)
        if i % layers == 0 and (i // layers - 1) % every == 0:
            calls.append(([clone(a) for a in args],
                          {k: clone(v) for k, v in kw.items()}, out.clone()))
        return out
    pa.paged_attention = record
    try:
        yield calls
    finally:
        pa.paged_attention = launch


def check_decode_calls(torch, name, calls):
    """The gang-decode calls one ``generate()`` made at its last layer
    (``decode_capture``): each kernel output against the plain version and
    against the plain mirror of the split pass at the call's own plan,
    under the bf16 TOL; the contexts, the plan and the largest errors."""
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    errs, split_errs, lens = [], [], []
    for i, (args, kw, got) in enumerate(calls):
        sp, splits = pa.call_plan(args[0], args[1], args[3])
        errs.append(check_close(torch, f"{name} call {i}", got,
                                pa.paged_attention_plain(*args, **kw),
                                "bfloat16"))
        split_errs.append(check_close(
            torch, f"{name} call {i} vs its split-pass mirror", got,
            pa.paged_attention_split_plain(*args, sp=sp, **kw), "bfloat16"))
        lens += args[4].tolist()
    if not calls:
        raise AssertionError(f"{name}: no gang-decode call recorded")
    args = calls[0][0]
    return dict(calls=len(calls), batch=args[0].shape[0],
                contexts=[min(lens), max(lens)],
                block_table=list(args[3].shape), pool_blocks=args[1].shape[0],
                pool_dtype=str(args[1].dtype).removeprefix("torch."),
                split_positions=sp, splits=splits, max_abs_err=max(errs),
                max_abs_err_vs_split_mirror=max(split_errs))


def plain_attention_generate(torch, model, ids, out, kv):
    """``generate()`` again with the gang decode's plain version on the
    card (the ragged prefill and the rest unchanged), against ``out``, the
    kernel's tokens: the share of generated tokens that agree, and for
    each row that diverges its first divergent position and the margin
    there between the two tokens, read off the prefill path's logits of
    the shared prefix. A margin over ``FLIP_MARGIN_MAX`` fails: the flip
    would not be rounding."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    launch = pa.paged_attention
    pa.paged_attention = pa.paged_attention_plain
    flags.set_flags({"kv_cache_dtype": kv})
    try:
        ref = model.generate(ids, max_new_tokens=GEN_NEW_TOKENS,
                             temperature=0.0, cache_type="paged",
                             block_size=64)
    finally:
        pa.paged_attention = launch
        flags.set_flags({"kv_cache_dtype": "auto"})
    p0 = ids.shape[1]
    a, b = out[:, p0:], ref[:, p0:]
    res = dict(agreement=float((a == b).float().mean()), flips=[])
    for r in range(out.shape[0]):
        diff = torch.nonzero(a[r] != b[r])
        if len(diff) == 0:
            continue
        p = p0 + int(diff[0])
        logits = prompt_logits(torch, model, out[r, :p].cpu().numpy(), kv)
        tk, tp = int(out[r, p]), int(ref[r, p])
        res["flips"].append(dict(
            row=r, position=p, kernel_token=tk, plain_token=tp,
            margin=abs(float(logits[tk] - logits[tp])),
            top1_is_either=int(logits.argmax()) in (tk, tp)))
    worst = max((f["margin"] for f in res["flips"]), default=0.0)
    if worst > FLIP_MARGIN_MAX:
        raise AssertionError(f"generate() with the kernel against the plain "
                             f"attention: a token flips at logit margin "
                             f"{worst} (> {FLIP_MARGIN_MAX}): {res}")
    return res


# -- the gang-scheduled engine, the contiguous cache and the serving
# series, on phase_main's model --------------------------------------------

GANG_INT8_REQUESTS, GANG_INT8_NEW = 4, 16    # the int8-pool gang run
SERVING_OVERHEAD_PAIRS = 2   # (off, on) serves timing metrics and tracing
GANG_DECODE_EVERY = 8     # last-layer gang-decode calls kept: every 8th step
CONTIG_LEN, CONTIG_PAD = 1024, 256           # generate_contiguous's batch


def flip_check(torch, model, prompts, got, want, kv):
    """Each request's tokens ``got[r]`` against ``want[r]`` (lists): at the
    first divergent position, the margin between the two tokens read off
    the prefill path's logits of the shared prefix (``prompt_logits``).
    A margin over ``FLIP_MARGIN_MAX`` fails: the flip would not be
    rounding. The rest of a request after its flip is not compared."""
    flips, compared = [], 0
    for r, (a, b) in enumerate(zip(got, want)):
        n = min(len(a), len(b))
        j = next((i for i in range(n) if a[i] != b[i]), None)
        compared += n if j is None else j + 1
        if j is None:
            continue
        ctx = np.concatenate([prompts[r], np.asarray(a[:j], np.int32)])
        logits = prompt_logits(torch, model, ctx, kv)
        flips.append(dict(
            request=r, position=j, got=int(a[j]), want=int(b[j]),
            margin=abs(float(logits[a[j]] - logits[b[j]])),
            top1_is_either=int(logits.argmax()) in (a[j], b[j])))
    worst = max((f["margin"] for f in flips), default=0.0)
    if worst > FLIP_MARGIN_MAX:
        raise AssertionError(f"a token flips at logit margin {worst} "
                             f"(> {FLIP_MARGIN_MAX}): {flips}")
    return dict(requests=len(got), flips=len(flips),
                compared_tokens=compared, worst_margin=worst, detail=flips)


@contextlib.contextmanager
def tap_decode_logits(eng, rids):
    """Records, on the engine's path that runs inside, the last-position
    logits of the requests ``rids`` at every decode step (the sampler's
    input with one row a slot), with the count of tokens each had
    generated then: (request, count, float32 row). The sampling is the
    engine's own."""
    from paddle_tpu_torch.ops.kernels import serving as S
    sample, taps = S.sample_logits, []

    def record(logits, *args, **kw):
        if logits.shape[0] == eng.max_batch:
            for r in rids:
                req = eng.results[r]
                if req.slot is not None:
                    taps.append((r, len(req.out_tokens),
                                 logits[req.slot].float().clone()))
        return sample(logits, *args, **kw)
    S.sample_logits = record
    try:
        yield taps
    finally:
        S.sample_logits = sample


def decode_logits_check(torch, model, prompts, outs, taps, kv):
    """Each decode step's logits row of the gang engine (``taps``) against
    the prefill path's last-position logits over the same context (the
    prompt and the tokens generated before it, ``prompt_logits``) at
    ``LOGITS_ATOL`` / ``LOGITS_MIN_COS``, and the token the engine sampled
    against the row's argmax: every later step's slot, position and
    context at full width, past any flip against the ragged run. Also
    the prefill path's top-2 logit gap and how far the gang path moves
    that pair's difference: a step whose gap is under the drift is one
    where two paths may pick different tokens."""
    errs, coss, gaps, drifts, argmax_equal = [], [], [], [], 0
    for r, j, got in taps:
        ctx = np.concatenate([prompts[r], np.asarray(outs[r][:j], np.int32)])
        want = prompt_logits(torch, model, ctx, kv)
        err, cos = float((got - want).abs().max()), cosine(torch, got, want)
        if not bool(torch.isfinite(got).all()) or err > LOGITS_ATOL \
                or cos < LOGITS_MIN_COS:
            raise AssertionError(
                f"gang decode step of request {r} at token {j}: logits "
                f"max abs err {err} (atol {LOGITS_ATOL}), cosine {cos} "
                f"against the prefill path over the same context")
        if int(got.argmax()) != outs[r][j]:
            raise AssertionError(f"request {r} token {j}: sampled "
                                 f"{outs[r][j]}, its logits' argmax is "
                                 f"{int(got.argmax())}")
        t1, t2 = (int(t) for t in want.topk(2).indices)
        gaps.append(float(want[t1] - want[t2]))
        drifts.append(abs(float(got[t1] - got[t2]) - gaps[-1]))
        errs.append(err)
        coss.append(cos)
        argmax_equal += int(got.argmax()) == t1
    if not taps:
        raise AssertionError("no gang decode step recorded")
    gaps, drift_p50 = np.asarray(gaps), float(np.median(drifts))
    return dict(
        requests=sorted({r for r, _, _ in taps}), steps=len(taps),
        contexts=[int(min(len(prompts[r]) + j for r, j, _ in taps)),
                  int(max(len(prompts[r]) + j for r, j, _ in taps))],
        max_abs_err=max(errs), min_cosine=min(coss),
        argmax_equal=argmax_equal,
        top2_gap_p50=float(np.median(gaps)), pair_drift_p50=drift_p50,
        pair_drift_max=float(max(drifts)),
        share_gap_below_drift_p50=float(np.mean(gaps < drift_p50)),
        share_gap_below_2_drift_p50=float(np.mean(gaps < 2 * drift_p50)))


def serve_gang(torch, model, prompts, new_tokens, kv="bf16", profile=False,
               watch=(), before_step=None):
    """All ``prompts`` through ``GangScheduledEngine`` (16 rows, blocks of
    64, greedy) over a ``kv`` pool sized to the requests' worst case plus
    the trash block. Returns (tokens in prompt order, metrics, the
    recorded last-layer gang-decode calls, the decode-step logits of the
    requests ``watch``). The metrics hold each step's host seconds.
    ``before_step(i)`` runs before step ``i``, off its clock. With
    ``profile``, the last 3 steps (every row decoding) run under the
    profiler and stay out of the step percentiles: run it last, the
    profiler slows what follows."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.models import GangScheduledEngine
    from paddle_tpu_torch.ops import kernels
    cfg = model.config
    blocks = sum(-(-(len(p) + new_tokens) // 64) for p in prompts) + 1
    flags.set_flags({"kv_cache_dtype": kv})
    try:
        eng = GangScheduledEngine(model, max_batch=16, num_blocks=blocks,
                                  block_size=64, temperature=0.0)
    finally:
        flags.set_flags({"kv_cache_dtype": "auto"})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rids = [eng.add_request(p, max_new_tokens=new_tokens) for p in prompts]
    step_s, decode_s = [], []
    with decode_capture(torch, cfg.num_hidden_layers,
                        every=GANG_DECODE_EVERY) as calls, \
            tap_decode_logits(eng, [rids[r] for r in watch]) as taps:
        while eng.pending or eng.num_active:
            if profile and eng.steps == new_tokens - 4:
                m_prof = profile_call(torch, lambda: [eng.step()
                                                      for _ in range(3)], 3)
                if "all_kernels" in m_prof:
                    m_prof["by_part_ms"] = categorize(
                        m_prof.pop("all_kernels"), m_prof["device_busy_ms"])
                continue
            if before_step is not None:
                before_step(eng.steps)
            pre = eng.prefills
            ts = time.perf_counter()
            eng.step()             # ends reading the sampled tokens back
            step_s.append(time.perf_counter() - ts)
            if eng.prefills == pre:
                decode_s.append(step_s[-1])
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    outs = [list(eng.results[r].out_tokens) for r in rids]
    gen = sum(len(o) for o in outs)
    if any(len(o) != new_tokens for o in outs) or min(map(min, outs)) < 0 \
            or max(map(max, outs)) >= cfg.vocab_size:
        raise AssertionError("serve_gang: a request's tokens are short or "
                             "out of vocabulary")
    # one gang-decode call per layer and step; one ragged prefill call per
    # layer and admission
    want = dict(paged_attention=cfg.num_hidden_layers * eng.steps,
                ragged_paged_attention=cfg.num_hidden_layers * eng.prefills)
    got = {k: launches[k] for k in want}
    if got != want and not profile:
        raise AssertionError(f"serve_gang({kv}): launches {got}, want "
                             f"{want}")
    m = dict(requests=len(prompts), new_tokens=new_tokens, kv_dtype=kv,
             generated_tokens=gen, wall_s=wall, tokens_per_s=gen / wall,
             steps=eng.steps, prefills=eng.prefills,
             preemptions=eng.preempt_count, num_blocks=blocks,
             step_ms_p50=1e3 * float(np.percentile(step_s, 50)),
             step_ms_p99=1e3 * float(np.percentile(step_s, 99)),
             decode_step_ms_p50=1e3 * float(np.percentile(decode_s, 50)),
             decode_step_ms_p99=1e3 * float(np.percentile(decode_s, 99)),
             decode_steps=len(decode_s), step_s=step_s,
             peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
             launches={k: v for k, v in launches.items() if v},
             paged_attention_per_step=launches["paged_attention"]
             / eng.steps,
             ragged_per_prefill=launches["ragged_paged_attention"]
             / eng.prefills)
    if profile:
        m["profile_decode"] = m_prof
    del eng
    torch.cuda.empty_cache()
    return outs, m, calls, taps


def phase_serve_gang(torch, model, prompts, outs_bf16, outs_int8):
    """``serve_gang``: the 16 requests with 64 new tokens over a bf16 pool,
    and 4 of them with 16 over an int8 pool (the plain versions made to
    raise on the card while they run), each held to the ragged engine's
    tokens of the same run (``flip_check``) and their sampled last-layer
    gang-decode calls to the plain versions; over the bf16 pool, every
    decode step's logits of the shortest and the longest request to the
    prefill path's (``decode_logits_check``)."""
    res = {}
    by_len = sorted(range(len(prompts)), key=lambda r: len(prompts[r]))
    for kv, n, new, ref, watch in (
            ("bf16", len(prompts), 64, outs_bf16, (by_len[0], by_len[-1])),
            ("int8", GANG_INT8_REQUESTS, GANG_INT8_NEW, outs_int8, ())):
        ps = prompts[:n]
        with no_plain_on_card():
            outs, m, calls, taps = serve_gang(torch, model, ps, new, kv,
                                              watch=watch)
        del m["step_s"]
        m["vs_ragged"] = flip_check(torch, model, ps, outs,
                                    [ref[r][:new] for r in range(n)], kv)
        m["decode_calls"] = check_decode_calls(torch, f"serve_gang({kv})",
                                               calls)
        if watch:
            m["decode_logits"] = decode_logits_check(torch, model, ps, outs,
                                                     taps, kv)
        del calls, taps
        torch.cuda.empty_cache()
        res[kv] = m
        log(f"serve_gang[{kv}]: {json.dumps(m)}")
    return res


def recorder_cost(torch, model, prompts):
    """The host time that the flight recorder (on by default) adds to an
    engine step. Each run turns the recorder on for every other step
    (``before_step``) and reads the median over its pairs of (a step with
    it on - the step before it, off), which shares its load and nearly
    its work; of two runs, one has it on for the odd steps and one for
    the even ones, so half their sum is the cost and half their
    difference what the steps' parity alone gives. For the gang engine's
    decode step (16 rows of up to 512-token prompts, 64 new tokens; the
    prefill step left out) and the eager ragged engine's step (the 16
    requests, 64 new tokens); with the ops the recorder took an on step,
    and the µs each."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.observability import flight_recorder
    rec, short = flight_recorder.recorder(), [p[:512] for p in prompts]

    def run(serve_fn, parity):
        seen = []

        def alternate(i):
            seen.append(rec.total_recorded)
            flags.set_flags({"flight_recorder": i % 2 == parity})
        try:
            with no_plain_on_card():
                st = serve_fn(alternate)["step_s"]
        finally:
            flags.set_flags({"flight_recorder": True})
        ops = np.diff(seen)
        if len(st) != len(seen) or ops[1 - parity::2].any() \
                or not ops[parity::2].all():
            raise AssertionError(f"flight recorder: {len(st)} steps timed, "
                                 f"{len(seen)} toggled, ops a step {ops}")
        on = range(4 - parity, len(st), 2)
        return dict(on_steps="odd" if parity else "even",
                    host_us_added=1e6 * float(np.median(
                        [st[i] - st[i - 1] for i in on])),
                    pairs=len(on), ops_per_step=float(np.median(
                        ops[parity::2])),
                    step_ms_p50_on=1e3 * float(np.median(
                        [st[i] for i in on])),
                    step_ms_p50_off=1e3 * float(np.median(
                        [st[i - 1] for i in on])))
    out = {}
    for name, fn in (
            ("gang_decode_step", lambda cb: serve_gang(
                torch, model, short, 64, before_step=cb)[1]),
            ("eager_ragged_step", lambda cb: eager_serve(
                torch, model, prompts, 64, before_step=cb)[1])):
        odd, even = run(fn, 1), run(fn, 0)
        us = (odd["host_us_added"] + even["host_us_added"]) / 2
        out[name] = dict(runs=[odd, even], host_us_per_step_added=us,
                         parity_us=(odd["host_us_added"]
                                    - even["host_us_added"]) / 2,
                         ops_per_step=odd["ops_per_step"],
                         us_per_op=us / odd["ops_per_step"])
    log(f"flight_recorder_cost: {json.dumps(out)}")
    return out


def phase_generate_contiguous(torch, model, prompts):
    """``generate(cache_type="contiguous")`` on 4 of the prompts cut to
    ``CONTIG_LEN`` tokens, 16 new, against ``generate(cache_type="paged")``
    on the same batch (``flip_check``); then one masked prefill through
    ``KVCache``: a full row and a row left-padded by ``CONTIG_PAD`` (an
    additive mask, -1e9 at the pads), each row's last-position logits
    against the same row run alone, unpadded (``LOGITS_ATOL`` /
    ``LOGITS_MIN_COS``)."""
    from paddle_tpu_torch.models import KVCache
    from paddle_tpu_torch.ops import kernels
    cfg = model.config
    kvh, d = cfg.num_key_value_heads, cfg.hidden_size // cfg.num_attention_heads
    rows = [p[:CONTIG_LEN] for p in prompts if len(p) >= CONTIG_LEN][:4]
    if len(rows) < 4:
        raise AssertionError(f"only {len(rows)} prompts of >= {CONTIG_LEN} "
                             f"tokens")
    ids = torch.from_numpy(np.stack(rows)).cuda()
    res = {}
    for cache_type in ("contiguous", "paged"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = model.generate(ids, max_new_tokens=GEN_NEW_TOKENS,
                             temperature=0.0, cache_type=cache_type,
                             block_size=64)
        torch.cuda.synchronize()
        res[cache_type] = dict(
            out=out, wall_s=time.perf_counter() - t0,
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            launches={k: v for k, v in kernels.launch_counts().items()
                      if v})
    c = res["contiguous"]
    if tuple(c["out"].shape) != (4, CONTIG_LEN + GEN_NEW_TOKENS):
        raise AssertionError(f"generate(contiguous): {tuple(c['out'].shape)}")
    if c["launches"]:
        raise AssertionError(f"generate(contiguous) launched the paged "
                             f"kernels: {c['launches']}")
    item = 2 if cfg.dtype == "bfloat16" else 4
    m = dict(batch=4, prompt=CONTIG_LEN, new_tokens=GEN_NEW_TOKENS,
             kvcache_bytes=cfg.num_hidden_layers * 2 * 4
             * (CONTIG_LEN + GEN_NEW_TOKENS) * kvh * d * item,
             vs_paged=flip_check(
                 torch, model, rows,
                 c["out"][:, CONTIG_LEN:].tolist(),
                 res["paged"]["out"][:, CONTIG_LEN:].tolist(), "bf16"))
    for k in ("contiguous", "paged"):
        m[k] = {x: res[k][x] for x in ("wall_s", "peak_mem_gib", "launches")}
    del res
    # one masked prefill: row 0 whole, row 1 left-padded
    pad = CONTIG_PAD
    padded = np.stack([rows[0], np.concatenate(
        [np.zeros(pad, np.int32), rows[1][:CONTIG_LEN - pad]])])
    mask = torch.zeros((2, 1, CONTIG_LEN, CONTIG_LEN), dtype=torch.float32,
                       device="cuda")
    mask[1, :, :, :pad] = -1e9
    cache = KVCache(cfg.num_hidden_layers, 2, CONTIG_LEN, kvh, d,
                    dtype=cfg.dtype, device="cuda")
    got = model(torch.from_numpy(padded).cuda(), attn_mask=mask, cache=cache,
                start_pos=0)[:, -1].float()
    m["masked_prefill"] = dict(pad=pad, cache_bytes=cache.nbytes())
    del cache
    for r, alone in enumerate((rows[0], rows[1][:CONTIG_LEN - pad])):
        c1 = KVCache(cfg.num_hidden_layers, 1, len(alone), kvh, d,
                     dtype=cfg.dtype, device="cuda")
        want = model(torch.from_numpy(alone[None]).cuda(), cache=c1,
                     start_pos=0)[0, -1].float()
        del c1
        err, cos = float((got[r] - want).abs().max()), cosine(torch, got[r],
                                                              want)
        if not bool(torch.isfinite(got[r]).all()) or err > LOGITS_ATOL \
                or cos < LOGITS_MIN_COS:
            raise AssertionError(
                f"masked prefill row {r}: max abs err {err} (atol "
                f"{LOGITS_ATOL}), cosine {cos} against the row alone")
        m["masked_prefill"][f"row{r}"] = dict(
            max_abs_err=err, cosine=cos,
            argmax_equal=bool(got[r].argmax() == want.argmax()))
    # without the mask the padded row attends its pads: it must move
    cache = KVCache(cfg.num_hidden_layers, 2, CONTIG_LEN, kvh, d,
                    dtype=cfg.dtype, device="cuda")
    nomask = model(torch.from_numpy(padded).cuda(), cache=cache,
                   start_pos=0)[1, -1].float()
    m["masked_prefill"]["row1_unmasked_max_abs_diff"] = float(
        (nomask - got[1]).abs().max())
    del cache
    torch.cuda.empty_cache()
    log(f"generate_contiguous: {json.dumps(m)}")
    return m


def paired_step_us(on, off):
    """The median over step indices of (``on``'s step - ``off``'s step), in
    µs: two serves of the same requests run the same schedule, so step i
    does the same work in both."""
    return 1e6 * float(np.median(np.asarray(on["step_s"])
                                 - np.asarray(off["step_s"])))


def check_serving_metrics(torch, m, m_off, pairs_on_off=()):
    """The captured bf16 run's registry series against its own tallies,
    its TTFT count and percentiles, one ``serving.step`` span a step, and
    the host time a step that metrics and tracing add: over each (on,
    off) pair of serves in ``pairs_on_off`` (off: ``FLAGS_metrics=0`` and
    ``FLAGS_tracing=0``), the median paired step difference. ``m_off`` is
    an off run, which must record nothing."""
    s, t = m["metrics"], m["tallies"]
    pairs = {"serving.admitted": t["admitted"],
             "serving.finished": t["finished"],
             "serving.generated_tokens": t["generated_tokens"],
             "serving.prefill_tokens": t["prefill_tokens"],
             "serving.ttft_seconds.count": m["requests"],
             "serving.steps": m["steps"]}
    bad = {k: (s.get(k), v) for k, v in pairs.items() if s.get(k) != v}
    if bad:
        raise AssertionError(f"serving series against the run's tallies "
                             f"(registry, tally): {bad}")
    if m["spans"]["serving_step"] != m["steps"]:
        raise AssertionError(f"{m['spans']} serving.step spans over "
                             f"{m['steps']} steps")
    if any(v for k, v in m_off["metrics"].items()
           if k.endswith(".count") or k in pairs) or \
            m_off["spans"]["recorded"]:
        raise AssertionError(f"FLAGS_metrics=0 / FLAGS_tracing=0 still "
                             f"recorded: {m_off['metrics']} "
                             f"{m_off['spans']}")
    return dict(
        matched=pairs, spans=m["spans"],
        ttft_s_p50=s["serving.ttft_seconds.p50"],
        ttft_s_p99=s["serving.ttft_seconds.p99"],
        tpot_s_p50=s["serving.tpot_seconds.p50"],
        tpot_s_p99=s["serving.tpot_seconds.p99"],
        queue_wait_s_p50=s["serving.queue_wait_seconds.p50"],
        steps_on_off=[(a["steps"], b["steps"]) for a, b in pairs_on_off],
        step_ms_p50_on_off=[(a["step_ms_p50"], b["step_ms_p50"])
                            for a, b in pairs_on_off],
        step_ms_mean_on_off=[(a["step_ms_mean"], b["step_ms_mean"])
                             for a, b in pairs_on_off],
        host_us_per_step_added=[paired_step_us(a, b)
                                for a, b in pairs_on_off
                                if a["steps"] == b["steps"]],
        tokens_identical_off=m_off["tokens_identical"])


def phase_main(torch, seed, report):
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import kernels

    cfg = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = LlamaForCausalLM(cfg, device="cuda", generator=gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model: Llama-3-8B geometry, {cfg.num_hidden_layers} layers, "
        f"{n_params / 1e9:.3f} B parameters (bf16, normal std 0.02 from "
        f"seed {seed}) built in {time.perf_counter() - t0:.1f} s")
    prompts = make_requests(cfg, seed)
    main = {}

    def counted_serve(**kw):
        """serve(), with the kernel launches it made and their count per
        engine step (read off the counters without resetting them)."""
        before = kernels.launch_counts()
        outs, m = serve(torch, model, prompts, 64, **kw)
        m["launches"] = {k: n - before[k]
                         for k, n in kernels.launch_counts().items()}
        m["launches_per_step"] = {k: n / m["steps"]
                                  for k, n in m["launches"].items()}
        return outs, m

    kernels.reset_launch_counts()
    with no_plain_on_card():
        outs_bf16, main["bf16"] = counted_serve()
        # trainable params must not make serving build an autograd graph:
        # the bf16 run's peak stays at slice 1's (23.12 GiB on an H100),
        # restated by the step graph's pool, measured in this run
        pool_gib = main["bf16"]["capture"]["pool_bytes"] / 2 ** 30
        limit = SERVE_PEAK_GIB * 1.05 + pool_gib
        main["bf16"]["peak_limit_gib"] = limit
        if main["bf16"]["peak_mem_gib"] > limit:
            raise AssertionError(f"serving peak "
                                 f"{main['bf16']['peak_mem_gib']} GiB is "
                                 f"over slice 1's {SERVE_PEAK_GIB} GiB x "
                                 f"1.05 + the graph pool's {pool_gib} GiB")
        if main["bf16"]["metrics"]["serving.prefix_cache.hit_blocks"] <= 0:
            raise AssertionError("the shared-prefix request did not hit the "
                                 "prefix cache")
        outs_int8, main["int8"] = counted_serve(kv_dtype="int8")
        outs_spec, main["spec_k4"] = counted_serve(speculative_k=4)
        ids = torch.from_numpy(np.stack([p[:128] for p in prompts[:4]])) \
            .cuda()
        gens = {}
        for kv in ("bf16", "int8"):   # generate() over each pool dtype
            before = kernels.launch_counts()["paged_attention"]
            flags.set_flags({"kv_cache_dtype": kv})
            tg = time.perf_counter()
            try:
                with decode_capture(torch, cfg.num_hidden_layers) as calls:
                    out = model.generate(ids, max_new_tokens=GEN_NEW_TOKENS,
                                         temperature=0.0, cache_type="paged",
                                         block_size=64)
                torch.cuda.synchronize()
            finally:
                flags.set_flags({"kv_cache_dtype": "auto"})
            gang = kernels.launch_counts()["paged_attention"] - before
            gens[kv] = out, calls
            main["generate" if kv == "bf16" else "generate_int8"] = dict(
                batch=4, prompt=128, new_tokens=GEN_NEW_TOKENS, kv_dtype=kv,
                wall_s=time.perf_counter() - tg, paged_attention_launches=gang)
            if tuple(out.shape) != (4, 144) or int(out.max()) >= \
                    cfg.vocab_size or int(out.min()) < 0:
                raise AssertionError(f"generate({kv}) returned "
                                     f"{tuple(out.shape)} or tokens out of "
                                     f"vocabulary")
            # one gang-decode launch per layer and decode step
            if gang != cfg.num_hidden_layers * 15:
                raise AssertionError(f"generate({kv}): {gang} paged_attention "
                                     f"launches, want "
                                     f"{cfg.num_hidden_layers * 15}")
    counts = kernels.launch_counts()
    main["launches"] = counts
    for name in SERVING_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"serving path")
    # the same requests through the eager engine step (after the path's
    # counts were read)
    vs_eager = {}
    with no_plain_on_card():
        for k, kw, outs in (("bf16", {}, outs_bf16),
                            ("int8", dict(kv_dtype="int8"), outs_int8),
                            ("spec_k4", dict(speculative_k=4), outs_spec)):
            oe, me = eager_serve(torch, model, prompts, 64, **kw)
            vs_eager[k] = check_capture(f"serve[{k}]", main[k], outs, me, oe)
            log(f"serve[{k}] captured vs eager: {json.dumps(vs_eager[k])}")
    main["capture_vs_eager"] = vs_eager
    # the captured bf16 run's serving series and spans, against the same
    # serve with metrics and tracing off
    pairs = []
    for _ in range(SERVING_OVERHEAD_PAIRS):
        run = {}
        for on in (False, True):
            flags.set_flags({"metrics": on, "tracing": on})
            try:
                with no_plain_on_card():
                    outs_x, run[on] = serve(torch, model, prompts, 64)
            finally:
                flags.set_flags({"metrics": True, "tracing": True})
            run[on]["tokens_identical"] = outs_x == outs_bf16
        pairs.append((run[True], run[False]))
    m_off = pairs[0][1]
    main["serving_metrics"] = check_serving_metrics(torch, main["bf16"],
                                                    m_off, pairs)
    log(f"serving_metrics: {json.dumps(main['serving_metrics'])}")
    # the gang-scheduled engine and the contiguous cache, each path's
    # kernel counts reset just before it and read just after
    main["serve_gang"] = phase_serve_gang(torch, model, prompts, outs_bf16,
                                          outs_int8)
    main["flight_recorder_cost"] = recorder_cost(torch, model, prompts)
    with no_plain_on_card():
        main["generate_contiguous"] = phase_generate_contiguous(
            torch, model, prompts)
    # generate()'s own gang-decode calls against the plain versions, and
    # its tokens against a generate() through the plain attention
    for kv, (out, calls) in gens.items():
        m = main["generate" if kv == "bf16" else "generate_int8"]
        m["decode_calls"] = check_decode_calls(torch, f"generate({kv})",
                                               calls)
        m["vs_plain_attention"] = plain_attention_generate(torch, model, ids,
                                                           out, kv)
    del gens

    # greedy tokens against the bf16 run: all positions, and the first
    # token of each request (before one early flip changes the rest)
    main["greedy_token_agreement"] = dict(
        int8_vs_bf16=agree(outs_int8, outs_bf16),
        int8_vs_bf16_first=agree(outs_int8, outs_bf16, first=True),
        spec_vs_bf16=agree(outs_spec, outs_bf16))
    for k in ("bf16", "int8", "spec_k4"):
        m = main[k]
        log(f"serve[{k}]: {m['requests']} requests, "
            f"{m['prompt_tokens']} prompt + {m['generated_tokens']} "
            f"generated tokens in {m['wall_s']:.2f} s: "
            f"{m['tokens_per_s']:.1f} tok/s, step p50 "
            f"{m['step_ms_p50']:.1f} ms p99 {m['step_ms_p99']:.1f} ms, TTFT "
            f"p50 {m['ttft_ms_p50']:.0f} ms p99 {m['ttft_ms_p99']:.0f} ms, "
            f"TPOT p50 {m['tpot_ms_p50']:.1f} ms p99 {m['tpot_ms_p99']:.1f} "
            f"ms, peak {m['peak_mem_gib']:.2f} GiB, {m['num_blocks']} "
            f"blocks, launches {m['launches']} ({m['launches_per_step']} "
            f"per step), serving series {m['metrics']}")
    log(f"generate(paged): {main['generate']}; int8 pool: "
        f"{main['generate_int8']}")
    log(f"launches on the main path: {counts}")
    log(f"greedy agreement with the bf16 run: "
        f"{main['greedy_token_agreement']}")
    main["logits_check"] = logits_check(torch, model, prompts[1][:300])
    log(f"logits kernel vs plain: {main['logits_check']}")
    # last: profiled runs of their own (the profiler slows what follows)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)   # profiler warm-up
    for kv in ("bf16", "int8"):
        _, m = serve(torch, model, prompts, 64, profile=True,
                     kv_dtype=None if kv == "bf16" else "int8")
        main[f"profile_{kv}"] = m["profile"]
        for window, prof in m["profile"].items():
            log(f"profile[{kv}/{window}]: {json.dumps(prof)}")
    # the eager engine step's windows, for the busy share against capture
    _, m = eager_serve(torch, model, prompts, 64, profile=True)
    main["profile_bf16_eager"] = m["profile"]
    for window, prof in m["profile"].items():
        log(f"profile[bf16 eager/{window}]: {json.dumps(prof)}")
    # the gang engine's decode step: 16 rows of up to 512-token prompts
    _, m, _, _ = serve_gang(torch, model, [p[:512] for p in prompts], 16,
                            profile=True)
    main["profile_gang_decode"] = m["profile_decode"]
    log(f"profile[gang decode]: {json.dumps(m['profile_decode'])}")
    report["main"] = main
    return main, outs_bf16


# -- phase 3b: int4 weight-only serving ------------------------------------------

INT4_LINEARS = 7        # q, k, v, o, gate, up, down per decoder layer
# last-position logits of the int4 model, GEMM kernel route vs plain route
# (FLAGS_use_pallas_kernels off), both on the card and through the same
# attention kernels: each linear's bf16 output may differ by one ulp
# (float32 sums in another order), which compounds through 32 random layers
# as the attention kernels' ulps do in phase_main's check (measured on an
# H100: max abs err 0.26, cosine 0.9990, logit std 1.28); the same limits:
# 0.5 is ~40% of the logits' spread, and 1 - cosine may grow 5x. A wrong
# unpack moves them far more (int4 vs bf16 on these weights: cosine 0.15)
INT4_LOGITS_ATOL, INT4_LOGITS_MIN_COS = LOGITS_ATOL, LOGITS_MIN_COS


def model_bytes(model) -> int:
    """Bytes of the model's parameters and buffers (each tensor once)."""
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers()))


def phase_int4_serve(torch, seed, report, outs_bf16):
    """Llama-3-8B from phase_main's seed, quantized to per-channel int4 on
    the card, served through the engine and generate()."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.nn.quant import (WeightOnlyLinear,
                                           quantize_for_inference)
    from paddle_tpu_torch.ops import kernels

    cfg = LlamaConfig.llama3_8b()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = LlamaForCausalLM(cfg, device="cuda", generator=gen)
    prompts = make_requests(cfg, seed)
    probe = prompts[1][:300]
    logits_bf16 = prompt_logits(torch, model, probe)
    res = {"bytes_before": model_bytes(model)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    quantize_for_inference(model, "weight_only_int4")
    torch.cuda.synchronize()
    res.update(quantize_s=time.perf_counter() - t0,
               quantize_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               bytes_after=model_bytes(model))
    torch.cuda.empty_cache()
    n_q = sum(isinstance(m, WeightOnlyLinear) for m in model.modules())
    if n_q != INT4_LINEARS * cfg.num_hidden_layers:
        raise AssertionError(f"{n_q} WeightOnlyLinear layers, want "
                             f"{INT4_LINEARS * cfg.num_hidden_layers}")
    log(f"int4: quantize_for_inference(weight_only_int4) of {n_q} linears "
        f"in {res['quantize_s']:.2f} s (peak {res['quantize_peak_gib']:.2f} "
        f"GiB); model {res['bytes_before'] / 1e9:.3f} GB -> "
        f"{res['bytes_after'] / 1e9:.3f} GB (parameters and buffers)")

    # logits: the kernel route against the plain route, and against bf16
    a = prompt_logits(torch, model, probe)
    flags.set_flags({"use_pallas_kernels": False})
    try:
        b = prompt_logits(torch, model, probe)
    finally:
        flags.set_flags({"use_pallas_kernels": True})
    if not bool(torch.isfinite(a).all()):
        raise AssertionError("int4 kernel-route logits are not finite")
    err, cos = float((a - b).abs().max()), cosine(torch, a, b)
    res["logits_kernel_vs_plain"] = dict(
        max_abs_err=err, cosine=cos, std=float(b.std()),
        argmax_equal=bool(a.argmax() == b.argmax()))
    if err > INT4_LOGITS_ATOL or cos < INT4_LOGITS_MIN_COS:
        raise AssertionError(
            f"int4 logits: kernel vs plain route max abs err {err} (atol "
            f"{INT4_LOGITS_ATOL}), cosine {cos}")
    res["logits_int4_vs_bf16"] = dict(
        max_abs_err=float((a - logits_bf16).abs().max()),
        cosine=cosine(torch, a, logits_bf16),
        argmax_equal=bool(a.argmax() == logits_bf16.argmax()))
    log(f"int4 logits kernel vs plain: {res['logits_kernel_vs_plain']}; "
        f"int4 vs bf16 (no limit: random weights): "
        f"{res['logits_int4_vs_bf16']}")
    del a, b, logits_bf16

    # serving: the path's counts read just before and just after
    kernels.reset_launch_counts()
    outs, m = serve(torch, model, prompts, 64)
    counts = kernels.launch_counts()
    m["launches"] = counts
    m["launches_per_step"] = {k: n / m["steps"] for k, n in counts.items()}
    want = INT4_LINEARS * cfg.num_hidden_layers * m["steps"]
    if counts["weight_only_int4_gemm"] != want:
        raise AssertionError(
            f"weight_only_int4_gemm launched {counts['weight_only_int4_gemm']}"
            f" times in {m['steps']} engine steps, want {want}")
    if counts["ragged_paged_attention"] <= 0:
        raise AssertionError("the ragged kernel was not launched")
    m["greedy_token_agreement_vs_bf16"] = dict(
        all=agree(outs, outs_bf16), first=agree(outs, outs_bf16, first=True))
    res["serve"] = m
    oe, me = eager_serve(torch, model, prompts, 64)
    res["capture_vs_eager"] = check_capture("serve[int4]", m, outs, me, oe)
    log(f"serve[int4] captured vs eager: "
        f"{json.dumps(res['capture_vs_eager'])}")
    log(f"serve[int4]: {m['requests']} requests, {m['prompt_tokens']} prompt "
        f"+ {m['generated_tokens']} generated tokens in {m['wall_s']:.2f} s: "
        f"{m['tokens_per_s']:.1f} tok/s, step p50 {m['step_ms_p50']:.1f} ms "
        f"p99 {m['step_ms_p99']:.1f} ms, TTFT p50 {m['ttft_ms_p50']:.0f} ms "
        f"p99 {m['ttft_ms_p99']:.0f} ms, TPOT p50 {m['tpot_ms_p50']:.1f} ms "
        f"p99 {m['tpot_ms_p99']:.1f} ms, peak {m['peak_mem_gib']:.2f} GiB, "
        f"{m['num_blocks']} blocks, {m['steps']} steps, launches {counts} "
        f"({m['launches_per_step']['weight_only_int4_gemm']:.0f} int4 GEMM "
        f"per step); greedy agreement with the bf16 run "
        f"{m['greedy_token_agreement_vs_bf16']}")

    ids = torch.from_numpy(np.stack([p[:128] for p in prompts[:4]])).cuda()
    before = kernels.launch_counts()["weight_only_int4_gemm"]
    tg = time.perf_counter()
    with decode_capture(torch, cfg.num_hidden_layers) as calls:
        out = model.generate(ids, max_new_tokens=GEN_NEW_TOKENS,
                             temperature=0.0, cache_type="paged",
                             block_size=64)
    torch.cuda.synchronize()
    res["generate"] = dict(
        batch=4, prompt=128, new_tokens=GEN_NEW_TOKENS,
        wall_s=time.perf_counter() - tg,
        int4_gemm_launches=kernels.launch_counts()["weight_only_int4_gemm"]
        - before)
    if tuple(out.shape) != (4, 144) or int(out.max()) >= cfg.vocab_size \
            or int(out.min()) < 0 or res["generate"]["int4_gemm_launches"] \
            <= 0:
        raise AssertionError(f"int4 generate(): {tuple(out.shape)}, "
                             f"{res['generate']}")
    res["generate"]["decode_calls"] = check_decode_calls(
        torch, "generate(int4)", calls)
    res["generate"]["vs_plain_attention"] = plain_attention_generate(
        torch, model, ids, out, "bf16")
    del calls
    log(f"generate(paged, int4): {res['generate']}")
    # last: a profiled run of its own (the profiler slows what follows)
    _, mp = serve(torch, model, prompts, 64, profile=True)
    res["profile"] = mp["profile"]
    for window, prof in mp["profile"].items():
        log(f"profile[int4/{window}]: {json.dumps(prof)}")
    del model
    torch.cuda.empty_cache()
    report["int4_serve"] = res
    return res


# -- phase 4: training-path kernels -------------------------------------------

# dynamic shared memory of the bf16 attention kernels, as flash_wgmma.cuh
# sizes it: 64-row bf16 tiles (forward: Q and two stages of K and V; dq and
# dk/dv: two own tiles and two stages of two), per-stage column words and
# 1024 B of alignment slack
TC_TILES = {"fwd": (5, 2), "dq": (6, 2), "dkv": (6, 4)}


def tc_smem_bytes(kind: str, d: int) -> int:
    tiles, words = TC_TILES[kind]
    return tiles * 64 * d * 2 + 2 * words * 64 * 4 + 1024


# dynamic shared memory of the float32 attention kernels, as flash_f32.cuh
# sizes it: [64][d + 4] float32 tiles (forward: its hb query heads' Q, a K
# and a V slot; dq: Q, dO and two stages of K and V; dk/dv: K, V and three
# slots of Q or dO), W tiles of [64][64 hb + 4] floats (dk/dv: one for P,
# one for dS) and 64-word column arrays (the forward's one set of 2, dq's
# two stages of 2, dk/dv's two sets of 4)
def f32_attn_smem_bytes(kind: str, d: int, hb: int = 1) -> int:
    tile, w = 64 * (d + 4) * 4, 64 * (64 * hb + 4) * 4
    if kind == "fwd":
        return (hb + 2) * tile + w + 2 * 64 * 4
    if kind == "dq":
        return 6 * tile + w + 2 * 2 * 64 * 4
    return 5 * tile + 2 * w + 2 * 4 * 64 * 4


def f32_smem_bytes(tm: int) -> int:
    """Dynamic shared memory of a float32 FMA kernel with a ``tm``-row M
    tile, as csrc/gemm_f32.cuh's ``Tile`` sizes it: per k group a 3-slot
    ring of 16-deep [16][tm + 4] A and [16][tn + 4] B float32 tiles (tn 128,
    or 64 with two k groups at tm 16)."""
    tn, kg = (64, 2) if tm == 16 else (128, 1)
    return kg * 3 * 16 * (tm + 4 + tn + 4) * 4


# dynamic shared memory of the GEMM kernels, as grouped_gemm.cu,
# bcsr_spmm.cu and weight_only_gemm.cu size them (bf16 tiles of 64-deep k;
# 1024 B of alignment slack): the grouped GEMM's 4-stage ring of 128 x 64
# A and 256 x 64 B tiles; the int4 prefill's 6-stage ring of A and packed
# [32][256] tiles plus two unpacked [64][256] B tiles; the int4 decode's
# 6-stage ring of x's [NX][128] tile and 64 packed rows at an 80-byte
# pitch; the float32 kernels' rings (f32_smem_bytes: the grouped GEMM's
# 64-row forward and 128-row dx tiles, the template's M tile for BCSR)
def gemm_smem_bytes(kernel: str, args) -> int:
    if kernel == "grouped_gemm_f32_kernel":
        return f32_smem_bytes(128 if args[0] == "true" else 64)
    if kernel == "bcsr_spmm_f32_kernel":
        return f32_smem_bytes(int(args[0]))
    if kernel == "grouped_gemm_wgmma_kernel":
        return 4 * (128 + 256) * 64 * 2 + 1024
    if kernel == "bcsr_spmm_wgmma_kernel":   # 4 stages of [TM][64] + [64][256]
        return 4 * (int(args[0]) + 256) * 64 * 2 + 1024
    if kernel == "int4_gemm_prefill_kernel":
        return 6 * (128 * 64 * 2 + 32 * 256) + 2 * 64 * 256 * 2 + 1024
    if kernel == "int4_gemm_decode_kernel":
        return 6 * (int(args[0]) * 128 * 2 + 64 * 80) + 1024
    return 0


def demangled_args(mangled: str):
    """Template arguments of an Itanium-mangled kernel name, as far as
    the port's kernels use them (ints, bools, float, int8 and bf16; a
    substitution ``S<n>_`` repeats bf16, the only type they substitute)."""
    out = []
    while mangled:
        m = re.match(r"Li(\d+)E|Lb([01])E|13__nv_bfloat16|S\d*_|f|a",
                     mangled)
        if not m:
            break
        out.append(m.group(1) or {"0": "false", "1": "true"}.get(
            m.group(2)) or {"f": "float", "a": "int8"}.get(m.group(0),
                                                          "bf16"))
        mangled = mangled[m.end():]
    return out


# dynamic shared memory of the gang-decode split pass, as
# csrc/paged_attention.cu sizes it: a ring of 64-position K and V chunks in
# the pool's dtype (3 stages, 2 for float32; int8 adds their scales), q
# [GT][D] and the warps' P [4][GT][16] in float32, 512 block-table ids
def decode_smem_bytes(args) -> int:
    kt, d, gt = args[1], int(args[2]), int(args[3])
    item = {"float": 4, "bf16": 2, "int8": 1}[kt]
    stage = 2 * 64 * d * item + (2 * 64 * 4 if kt == "int8" else 0)
    return (2 if item == 4 else 3) * stage + gt * d * 4 + 4 * gt * 16 * 4 \
        + 512 * 4


# dynamic shared memory of the ragged tensor-core tile pass, as
# csrc/ragged_paged_attention.cu sizes it: two stages of K and V bf16
# tiles [64][D] (bf16 pool), or one K/V pair and two stages of int8 K/V
# codes and their scales (Q stays in registers)
def ragged_smem_bytes(args) -> int:
    kt, d = args[0], int(args[1])
    if kt == "int8":
        return 2 * 64 * d * 2 + 2 * (2 * 64 * d + 2 * 64 * 4) + 1024
    return 2 * 2 * 64 * d * 2 + 1024


def ptxas_tc_kernels(txt: str):
    """Registers, spills and shared memory of each redesigned kernel in
    nvcc's ``-Xptxas -v`` report: the bf16 and float32 attention kernels
    (dynamic shared memory; the float32 ones named by their source, as
    ``flash_varlen::fwd_kernel<128, 2>``), every GEMM kernel of
    grouped_gemm.cu and
    weight_only_gemm.cu, the wgmma and float32 BCSR kernels, both split-KV
    passes (the gang decode's and the ragged decode rows') and the ragged
    tensor-core tile pass (dynamic, or the static bytes ptxas reports)."""
    rows, name = [], None
    for line in txt.splitlines():
        m = re.search(r"Compiling entry function '\w*?_(flash_attention|"
                      r"flash_varlen)_cu_\w*?\d(fwd|dq|dkv)_kernelILi(\d+)E"
                      r"(?:Li(\d+)E)?E", line)
        if m:
            d, hb = int(m.group(3)), int(m.group(4) or 1)
            args = f"{d}, {hb}" if m.group(4) else f"{d}"
            name = dict(kernel=f"{m.group(1)}::{m.group(2)}_kernel<{args}>",
                        smem_bytes=f32_attn_smem_bytes(m.group(2), d, hb))
            continue
        m = re.search(r"Compiling entry function '\w*?((?:flash|varlen)_tc_"
                      r"(fwd|dq|dkv))ILi(\d+)E", line)
        if m:
            name = dict(kernel=f"{m.group(1)}<{m.group(3)}>",
                        smem_bytes=tc_smem_bytes(m.group(2),
                                                 int(m.group(3))))
            continue
        m = re.search(r"Compiling entry function '\w*?\d((?:int4|grouped)"
                      r"_gemm_\w*?kernel|bcsr_spmm_(?:wgmma|f32)_kernel|"
                      r"paged_attention_(?:split|merge)_kernel|ragged_paged_"
                      r"attention_tc_kernel)I(\w*?)EEv", line)
        if m:
            args = demangled_args(m.group(2))
            name = dict(kernel=f"{m.group(1)}<{', '.join(args)}>",
                        smem_bytes=decode_smem_bytes(args)
                        if "split" in m.group(1)
                        else ragged_smem_bytes(args)
                        if "ragged" in m.group(1)
                        else gemm_smem_bytes(m.group(1), args))
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            name.update(spill_stores=int(m.group(1)),
                        spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            name["registers"] = int(m.group(1))
            static = re.search(r"(\d+) bytes smem", line)
            if static and not name["smem_bytes"]:
                name["smem_bytes"] = int(static.group(1))
            rows.append(name)
            name = None
    return rows


def bitwise_twice(torch, name, fn):
    """Two launches of a kernel give the same bytes (no atomics, a fixed
    order of sums)."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    a, b = (a if isinstance(a, tuple) else (a,)), \
        (b if isinstance(b, tuple) else (b,))
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{name}: two launches give different bytes")
    return True


def library_errors(torch, dtype_name, out, grads, want_out, want_grads):
    """The library call's own error against the plain version, under the
    kernels' limits: reported, not enforced (the library is a yardstick).
    It shows what a tensor-core kernel with a single bf16 P gets."""
    tol = TOL[dtype_name]
    w = want_out.float()
    err = (out.float() - w).abs()
    res = dict(out_max_abs_err=float(err.max()),
               out_over_limit=int((err > tol["atol"] + tol["rtol"] * w.abs())
                                  .sum()))
    for n, a, b in zip(("dq", "dk", "dv"), grads, want_grads):
        res[f"{n}_rel_err"] = rel_err(torch, a, b)
    res["within_limits"] = res["out_over_limit"] == 0 and all(
        res[f"{n}_rel_err"] <= GRAD_REL_TOL[dtype_name]
        for n in ("dq", "dk", "dv"))
    return res


def achieved(ms, flops, bound_ms, nbytes=None):
    """TFLOP/s of the products each kernel needs, GB/s of the bytes it
    must move (given ``nbytes``) and the share of the bound reached; each
    argument maps a kernel to its own. ``flops`` may be one int instead:
    the attention forward's, from which each attention kernel's need
    follows (forward 2, dq 3, dk/dv 4 of the forward's flops / 2)."""
    if isinstance(flops, int):
        flops = {"fwd": flops, "dq": 3 * flops // 2, "dkv": 2 * flops}
    out = {}
    for kern in ms:
        sec = ms[kern] * 1e-3
        out[kern] = dict(tflops=flops[kern] / sec / 1e12,
                         bound_share=bound_ms[kern] / ms[kern])
        if nbytes is not None:
            out[kern]["gbps"] = nbytes[kern] / sec / 1e9
    return out


TRAIN_B, TRAIN_S = 2, 2048
TRAIN_LAYERS = 8       # Llama-3-8B width; 32 layers of params, grads, masters
#                        and moments (16 B/param) would need ~128 GB
# flash kernel vs plain: both accumulate in float32 and round once, so a
# bf16 output or grad differs by at most one bf16 ulp (0.39% of its own
# magnitude, so at most 0.39% of the tensor's max): grads are judged by
# max error relative to the tensor's max, 1e-2 in bf16, 1e-4 in float32
# (summation order only); lse is float32 in both, atol 1e-4 + rtol 1e-5.
# planted_flash_faults() shows every run that these limits reject a
# forward that skips one causal tile and a backward that drops one kv tile.
GRAD_REL_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
LSE_TOL = dict(atol=1e-4, rtol=1e-5)
# the 8-layer bf16 model's loss and layer-0 grads through the kernels vs
# through the plain versions, same weights and batch: per-layer one-ulp
# differences of the attention output compound through 8 random layers
# (measured on the H100: 1.1e-4 and 0.99972; the limits are ~10x and ~4x
# those gaps)
LOSS_ATOL, GRAD_MIN_COS = 1e-3, 0.999


def rel_err(torch, got, want) -> float:
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        return float("inf")
    return float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))


def flash_work(b, h, kv, sq, sk, d, item, causal=True):
    """(forward flops, forward bytes, dq bytes, dk/dv bytes): the minimum
    work, each input read once and each output written once; causal counts
    only the (query, key) pairs the right-aligned mask keeps."""
    coff = sk - sq
    pairs = sum(min(sk, i + coff + 1) for i in range(sq)) if causal \
        else sq * sk
    return attn_work(b * pairs, b * sq, b * sk, h, kv, d, item)


def attn_work(pairs, nq, nk, h, kv, d, item):
    """(forward flops, forward bytes, dq bytes, dk/dv bytes) of attention
    over ``pairs`` live (query, key) pairs per head, ``nq`` query and
    ``nk`` key rows: each input read once, each output written once."""
    flops = 4 * h * pairs * d
    qb, kb = nq * h * d * item, nk * kv * d * item
    lse = h * nq * 4
    return (flops,
            2 * qb + 2 * kb + lse,       # q k v -> out, lse
            3 * qb + 2 * kb + 2 * lse,   # q k v dO lse delta -> dq
            2 * qb + 4 * kb + 2 * lse)   # q k v dO lse delta -> dk dv


def planted_flash_faults(torch, fa, q, k, v, scale, want, grads, dtype_name):
    """Two faults a kernel could make, produced with the plain version:
    a forward that skips the diagonal 64-key tile of the last q tile (its
    rows then attend keys [0, S-64) only), and a dk/dv that drops the
    middle 64-key tile (zeros). Each must fail the limits above for the
    inputs' dtype."""
    S = q.shape[1]
    bad = want.clone()
    bad[:, S - 64:] = fa.flash_fwd_plain(q[:, S - 64:], k[:, :S - 64],
                                         v[:, :S - 64], False, scale)[0]
    errs = {}
    try:
        check_close(torch, "flash_fwd", bad, want, dtype_name)
        raise AssertionError("flash_fwd: the tolerance passes a planted "
                             "fault (skipped causal tile)")
    except AssertionError as e:
        if "planted" in str(e):
            raise
        errs["skip_causal_tile"] = float((bad.float() - want.float())
                                         .abs().max())
    mid = S // 2
    for name, g in zip(("dk", "dv"), grads[1:]):
        bad = g.clone()
        bad[:, mid:mid + 64] = 0
        err = rel_err(torch, bad, g)
        if err <= GRAD_REL_TOL[dtype_name]:
            raise AssertionError(f"flash {name}: the tolerance passes a "
                                 f"planted fault (dropped kv tile)")
        errs[f"drop_kv_tile_{name}"] = err
    return errs


def phase_flash(torch, seed, report, flush):
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    out = {}
    B, S = TRAIN_B, TRAIN_S
    scale = D ** -0.5
    for label, dt in (("bfloat16", torch.bfloat16),
                      ("float32", torch.float32)):
        mk = lambda n: torch.randn((B, S, n, D), generator=g,  # noqa: E731
                                   device="cuda").to(dt)
        q, k, v, dout = mk(H), mk(KV), mk(KV), mk(H)
        o, lse = fa.flash_fwd_kernel(q, k, v, True, scale)
        torch.cuda.synchronize()
        wo, wl = fa.flash_fwd_plain(q, k, v, True, scale)
        e_out = check_close(torch, f"flash_fwd[{label}]", o, wo, label)
        e_out_rel = rel_err(torch, o, wo)
        e_lse = float((lse - wl).abs().max())
        if bool(((lse - wl).abs() > LSE_TOL["atol"]
                 + LSE_TOL["rtol"] * wl.abs()).any()):
            raise AssertionError(f"flash_fwd[{label}]: lse differs by "
                                 f"{e_lse}")
        delta = (dout.float() * wo.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        dq = fa.flash_dq_kernel(q, k, v, dout, wl, delta, True, scale)
        dk, dv = fa.flash_dkv_kernel(q, k, v, dout, wl, delta, True, scale)
        torch.cuda.synchronize()
        ref = fa.flash_bwd_plain(q, k, v, dout, wl, delta, True, scale)
        errs, abs_errs = {}, {}
        for name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
            errs[name] = rel_err(torch, a, b)
            abs_errs[name] = float((a.float() - b.float()).abs().max())
            if errs[name] > GRAD_REL_TOL[label]:
                raise AssertionError(
                    f"flash {name}[{label}]: kernel differs from plain "
                    f"version: max err {errs[name]} of the tensor's max "
                    f"(limit {GRAD_REL_TOL[label]})")
        faults = planted_flash_faults(torch, fa, q, k, v, scale, wo, ref,
                                      label)
        bitwise = all((
            bitwise_twice(torch, "flash_fwd", lambda: fa.flash_fwd_kernel(
                q, k, v, True, scale)),
            bitwise_twice(torch, "flash_dq", lambda: fa.flash_dq_kernel(
                q, k, v, dout, wl, delta, True, scale)),
            bitwise_twice(torch, "flash_dkv", lambda: fa.flash_dkv_kernel(
                q, k, v, dout, wl, delta, True, scale))))
        del o, lse, dq, dk, dv
        ms = {
            "fwd": time_ms(torch, lambda: fa.flash_fwd_kernel(
                q, k, v, True, scale), flush=flush),
            "dq": time_ms(torch, lambda: fa.flash_dq_kernel(
                q, k, v, dout, wl, delta, True, scale), flush=flush),
            "dkv": time_ms(torch, lambda: fa.flash_dkv_kernel(
                q, k, v, dout, wl, delta, True, scale), flush=flush)}
        plain = {
            "fwd": time_ms(torch, lambda: fa.flash_fwd_plain(
                q, k, v, True, scale), iters=3, flush=flush),
            "bwd": time_ms(torch, lambda: fa.flash_bwd_plain(
                q, k, v, dout, wl, delta, True, scale), iters=3,
                flush=flush)}
        # yardsticks, timed here only: SDPA forward, and its backward
        # alone (one autograd call over a kept graph: dq, dk, dv together)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), flush=flush)
        lo = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                            enable_gqa=True)
        dout_t = dout.transpose(1, 2)
        lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
            lo, (qt, kt, vt), dout_t, retain_graph=True), flush=flush)
        lib_err = library_errors(
            torch, label, lo.detach().transpose(1, 2),
            [x.transpose(1, 2) for x in torch.autograd.grad(
                lo, (qt, kt, vt), dout_t)], wo, ref)
        del lo, qt, kt, vt, ref
        flops, b_fwd, b_dq, b_dkv = flash_work(B, H, KV, S, S, D,
                                               q.element_size())
        rate = BF16_FLOPS_PER_S if label == "bfloat16" else F32_FLOPS_PER_S
        # minimum backward = five products (2.5x the forward's flops): dq
        # owns the dq product, dk/dv owns the recomputed s, dp, dk, dv.
        # The dq kernel recomputes s and dp too, so a dq kept apart from
        # dk/dv (no atomics) has a floor of three products, printed beside
        # its bound (which stays the one product, comparable across runs)
        bounds = {"fwd": bound(b_fwd, flops, rate),
                  "dq": bound(b_dq, flops // 2, rate),
                  "dkv": bound(b_dkv, 2 * flops, rate)}
        dq_floor = bound(b_dq, 3 * flops // 2, rate)[0]
        abs_errs["fwd"], errs["fwd"] = e_out, e_out_rel
        abs_errs["dkv"] = max(abs_errs["dk"], abs_errs["dv"])
        errs["dkv"] = max(errs["dk"], errs["dv"])
        rates = achieved(ms, flops, {n: b[0] for n, b in bounds.items()})
        res = {}
        for kern in ("fwd", "dq", "dkv"):
            res[kern] = dict(
                max_abs_err=abs_errs[kern], max_rel_err=errs[kern],
                ms=ms[kern], plain_ms=plain["fwd" if kern == "fwd"
                                            else "bwd"],
                bound_ms=bounds[kern][0], bound_by=bounds[kern][1],
                library_ms=lib_fwd if kern == "fwd" else lib_bwd,
                **rates[kern])
        res["fwd"]["lse_max_abs_err"] = e_lse
        res["fwd"]["flops"] = flops
        res["dq"]["three_product_floor_ms"] = dq_floor
        res["grad_errs"] = errs
        res["library_errs"] = lib_err
        res["bitwise_run_to_run"] = bitwise
        if faults:
            res["planted_fault_errs"] = faults
        out[label] = res
        log(f"flash[{label}] b{B} s{S} h{H}/{KV} d{D} causal: out max_abs_err "
            f"{e_out:.3e} lse {e_lse:.2e} rel errs {errs}; ms fwd "
            f"{ms['fwd']:.3f} dq {ms['dq']:.3f} dkv {ms['dkv']:.3f}; "
            f"TFLOP/s (share of bound) "
            + ", ".join(f"{n} {r['tflops']:.1f} ({r['bound_share']:.3f})"
                        for n, r in rates.items())
            + f"; plain fwd {plain['fwd']:.2f} bwd {plain['bwd']:.2f}; "
            f"library fwd {lib_fwd:.3f} bwd {lib_bwd:.3f}, its own errors "
            f"vs plain {lib_err}; bound fwd {bounds['fwd'][0]:.4f} dq "
            f"{bounds['dq'][0]:.4f} (three-product floor {dq_floor:.4f}) dkv "
            f"{bounds['dkv'][0]:.4f} ({bounds['fwd'][1]})"
            + ("; two launches of each kernel give the same bytes"
               if bitwise else "")
            + (f"; planted faults rejected: {faults}" if faults else ""))
        del q, k, v, dout, wo, wl, delta
    report["kernels"]["flash_attention"] = out
    return out


# -- phase 3b: packed (varlen) attention through the op registry -------------

VARLEN_T = 16384                 # packed tokens: a batch of 8 x 2048
VARLEN_LEN = (32, 4096)          # document lengths, log-uniform, last one cut
VARLEN_KERNELS = ("flash_varlen_fwd", "flash_varlen_dq", "flash_varlen_dkv")
VARLEN_LABELS = ("bfloat16", "float32", "cross_bfloat16")


def varlen_lengths(rng, total=VARLEN_T, lo=VARLEN_LEN[0], hi=VARLEN_LEN[1]):
    """Document lengths drawn log-uniform in [lo, hi] until they fill
    ``total`` tokens; the last document is cut to fill exactly."""
    lens = []
    while sum(lens) < total:
        lens.append(int(np.exp(rng.uniform(np.log(lo), np.log(hi)))))
    lens[-1] -= sum(lens) - total
    return lens


def varlen_pairs(lq, lk) -> int:
    """Live (query, key) pairs of causal attention packed by segments, the
    mask top-left in each: sum over segments and query positions p of
    min(p + 1, len_k)."""
    return sum(sum(min(p + 1, b) for p in range(a)) for a, b in zip(lq, lk))


def varlen_library(torch, q, k, v, cu, max_len):
    """One PyTorch call for the same function, timed here only: the
    installed torch's ``torch.nn.attention.varlen.varlen_attn`` for bf16
    (flash attention takes no float32), else ``scaled_dot_product_attention``
    over [1, h, T, d] with a block-diagonal causal bool mask on the
    memory-efficient backend (kv heads repeated outside the call). Returns
    (name, differentiable inputs, call)."""
    import inspect
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    G = q.shape[1] // k.shape[1]
    try:
        from torch.nn.attention.varlen import varlen_attn
        params = inspect.signature(varlen_attn).parameters
    except ImportError:
        params = {}
    if q.dtype == torch.bfloat16 and ("window_size" in params
                                      or "is_causal" in params):
        kw = dict(window_size=(-1, 0)) if "window_size" in params \
            else dict(is_causal=True)
        if "enable_gqa" in params:
            kw["enable_gqa"] = True
        else:
            k, v = (x.repeat_interleave(G, dim=1) for x in (k, v))
        ins = [x.detach().requires_grad_() for x in (q, k, v)]
        return ("torch.nn.attention.varlen.varlen_attn", ins,
                lambda: varlen_attn(*ins, cu, cu, max_len, max_len, **kw))
    seg = torch.searchsorted(cu, torch.arange(q.shape[0], device=q.device,
                                              dtype=cu.dtype), right=True)
    pos = torch.arange(q.shape[0], device=q.device)
    mask = (seg[:, None] == seg[None, :]) & (pos[None, :] <= pos[:, None])
    ins = [x.transpose(0, 1)[None].detach().requires_grad_()
           for x in (q, k.repeat_interleave(G, dim=1),
                     v.repeat_interleave(G, dim=1))]

    def call():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(*ins, attn_mask=mask)
    return ("scaled_dot_product_attention (efficient, block-diagonal causal "
            "mask, kv heads repeated)", ins, call)


def varlen_tiles(torch, lay):
    """(64 x 64 tiles the q blocks walk, the share of them that the bf16
    kernels' causal segment mask calls interior: one segment on both
    sides, every key at or before every query)."""
    qb = lay.q_bounds.long()
    runs = (qb[1] - qb[0] + 1).clamp_min(0)
    i = torch.repeat_interleave(torch.arange(len(runs), device=qb.device),
                                runs)
    first = torch.cumsum(runs, 0) - runs
    j = qb[0][i] + torch.arange(len(i), device=qb.device) - first[i]
    sq, pq = lay.segq.view(-1, 64), lay.posq.view(-1, 64)
    sk, pk = lay.segk.view(-1, 64), lay.posk.view(-1, 64)
    inner = (sq[i, 0] == sq[i, 63]) & (sk[j, 0] == sk[j, 63]) \
        & (sq[i, 0] == sk[j, 0]) & (pk[j, 63] <= pq[i, 0])
    return int(len(i)), float(inner.float().mean()) if len(i) else 0.0


def planted_varlen_faults(torch, fv, fa, q, k, v, cuq, cuk, lq, lk, scale,
                          want, want_lse, lse, dtype_name):
    """Faults a varlen kernel could make, produced with the plain
    formulation, each of which must fail the limits: the segment mask
    dropped (one causal segment over all tokens: documents leak into each
    other), causal aligned bottom-right in each segment instead of
    top-left (only cross packing tells the two apart), and lse read one
    token off. Returns each fault's max abs err."""
    errs = {}

    def must_fail(fault, bad, ref, check):
        try:
            check(bad)
        except AssertionError:
            errs[fault] = float((bad.float() - ref.float()).abs().max())
            return
        raise AssertionError(f"flash_varlen: the tolerance passes a planted "
                             f"fault ({fault})")

    out_ok = lambda bad: check_close(  # noqa: E731
        torch, "flash_varlen_fwd", bad, want, dtype_name)
    if lq == lk:
        whole = torch.tensor([0, q.shape[0]], dtype=torch.int32,
                             device=q.device)
        must_fail("segment_mask_dropped",
                  fv.flash_varlen_fwd_plain(q, k, v, whole, whole, True,
                                            scale)[0], want, out_ok)
        shifted = lse.clone()
        shifted[:, 1:] = lse[:, :-1]

        def lse_ok(bad):
            if bool(((bad - want_lse).abs() > LSE_TOL["atol"]
                     + LSE_TOL["rtol"] * want_lse.abs()).any()):
                raise AssertionError("lse differs")
        must_fail("lse_one_token_off", shifted, want_lse, lse_ok)
    else:
        bad = torch.zeros_like(want)
        cq, ck = cuq.tolist(), cuk.tolist()
        for i in range(len(lq)):
            if lq[i] and lk[i]:
                bad[cq[i]:cq[i + 1]] = fa.flash_fwd_plain(
                    q[None, cq[i]:cq[i + 1]], k[None, ck[i]:ck[i + 1]],
                    v[None, ck[i]:ck[i + 1]], True, scale)[0][0]
        must_fail("causal_bottom_right", bad, want, out_ok)
    return errs


def phase_flash_varlen(torch, seed, report, flush):
    """Packed attention at Llama-3-8B's attention width (32/8 heads, d 128)
    over 16384 tokens of documents from ``varlen_lengths``: forward and
    backward through ``call_op("flash_attn_unpadded")`` with the launches
    counted (1 forward, 1 dq, 1 dk/dv per call), each kernel against its
    plain version, planted faults, and times beside the bound, the plain
    version, one library call and the padded flash kernels."""
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.dispatcher import call_op
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import flash_varlen as fv

    rng = np.random.RandomState(seed + 5)
    lens = varlen_lengths(rng)
    cases = zip(VARLEN_LABELS, (torch.bfloat16, torch.float32,
                                torch.bfloat16), (lens, lens, lens[::-1]))
    g = torch.Generator(device="cuda").manual_seed(seed + 5)
    scale = D ** -0.5
    out, launched = {"lengths": lens}, {n: 0 for n in VARLEN_KERNELS}
    for label, dt, lk in cases:
        dname = "bfloat16" if dt == torch.bfloat16 else "float32"
        mk = lambda n: torch.randn((VARLEN_T, n, D), generator=g,  # noqa: E731
                                   device="cuda").to(dt)
        q, k, v, dout = mk(H), mk(KV), mk(KV), mk(H)
        cuq = torch.tensor(np.cumsum([0] + lens), dtype=torch.int32,
                           device="cuda")
        cuk = cuq if lk is lens else torch.tensor(
            np.cumsum([0] + lk), dtype=torch.int32, device="cuda")
        max_len = max(max(lens), max(lk))

        # the main path: the op, then loss.backward(), counts reset before
        ins = [x.detach().requires_grad_() for x in (q, k, v)]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        o_main = call_op("flash_attn_unpadded", *ins, cuq, cuk, max_len,
                         max_len, 0.0, True)
        loss = (o_main.float() * dout.float()).sum()
        loss.backward()
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        want_counts = {n: int(n in VARLEN_KERNELS) for n in counts}
        if counts != want_counts:
            raise AssertionError(f"flash_attn_unpadded[{label}]: launches "
                                 f"{counts}, want one of each varlen kernel")
        for n in VARLEN_KERNELS:
            launched[n] += counts[n]
        grads_main = [x.grad for x in ins]
        del ins, loss

        # each kernel against its plain version (comparison launches)
        tok = lk is lens
        lay = fv.varlen_layout(cuq, cuk, VARLEN_T, VARLEN_T, tok)
        o, lse = fv.flash_varlen_fwd(q, k, v, lay, True, scale)
        torch.cuda.synchronize()
        if not torch.equal(o, o_main.detach()):
            raise AssertionError(f"flash_varlen[{label}]: the op's output "
                                 f"differs from the forward kernel's")
        wo, wl = fv.flash_varlen_fwd_plain(q, k, v, cuq, cuk, True, scale)
        e_out = check_close(torch, f"flash_varlen_fwd[{label}]", o, wo, dname)
        e_out_rel = rel_err(torch, o, wo)
        e_lse = float((lse - wl).abs().max())
        if bool(((lse - wl).abs() > LSE_TOL["atol"]
                 + LSE_TOL["rtol"] * wl.abs()).any()):
            raise AssertionError(f"flash_varlen_fwd[{label}]: lse differs "
                                 f"by {e_lse}")
        delta = (dout.float() * wo.float()).sum(-1).transpose(0, 1) \
            .contiguous()
        dq = fv.flash_varlen_dq(q, k, v, dout, wl, delta, lay, True, scale)
        dk, dv = fv.flash_varlen_dkv(q, k, v, dout, wl, delta, lay, True,
                                     scale)
        torch.cuda.synchronize()
        ref = fv.flash_varlen_bwd_plain(q, k, v, dout, wl, delta, cuq, cuk,
                                        True, scale)
        errs, abs_errs = {}, {}
        for name, a, b, m in zip(("dq", "dk", "dv"), (dq, dk, dv), ref,
                                 grads_main):
            errs[name] = rel_err(torch, a, b)
            abs_errs[name] = float((a.float() - b.float()).abs().max())
            errs[f"{name}_main"] = rel_err(torch, m, b)
            if max(errs[name], errs[f"{name}_main"]) > GRAD_REL_TOL[dname]:
                raise AssertionError(
                    f"flash_varlen {name}[{label}]: kernel differs from "
                    f"plain version: max err {errs[name]} (the op's "
                    f"{errs[name + '_main']}) of the tensor's max (limit "
                    f"{GRAD_REL_TOL[dname]})")
        faults = planted_varlen_faults(torch, fv, fa, q, k, v, cuq, cuk,
                                       lens, lk, scale, wo, wl, lse, dname)
        bitwise = all((
            bitwise_twice(torch, "flash_varlen_fwd",
                          lambda: fv.flash_varlen_fwd(q, k, v, lay, True,
                                                      scale)),
            bitwise_twice(torch, "flash_varlen_dq",
                          lambda: fv.flash_varlen_dq(
                              q, k, v, dout, wl, delta, lay, True, scale)),
            bitwise_twice(torch, "flash_varlen_dkv",
                          lambda: fv.flash_varlen_dkv(
                              q, k, v, dout, wl, delta, lay, True, scale))))
        del o_main, grads_main, o, dq, dk, dv

        pairs = varlen_pairs(lens, lk)
        flops, b_fwd, b_dq, b_dkv = attn_work(pairs, VARLEN_T, VARLEN_T, H,
                                              KV, D, q.element_size())
        rate = BF16_FLOPS_PER_S if dt == torch.bfloat16 else F32_FLOPS_PER_S
        bounds = {"fwd": bound(b_fwd, flops, rate),
                  "dq": bound(b_dq, flops // 2, rate),
                  "dkv": bound(b_dkv, 2 * flops, rate)}
        dq_floor = bound(b_dq, 3 * flops // 2, rate)[0]   # as phase_flash
        run = lambda f, *a: time_ms(torch, lambda: f(*a), flush=flush)  # noqa
        ms = {"fwd": run(fv.flash_varlen_fwd, q, k, v, lay, True, scale),
              "dq": run(fv.flash_varlen_dq, q, k, v, dout, wl, delta, lay,
                        True, scale),
              "dkv": run(fv.flash_varlen_dkv, q, k, v, dout, wl, delta, lay,
                         True, scale)}
        plain = {"fwd": run(fv.flash_varlen_fwd_plain, q, k, v, cuq, cuk,
                            True, scale),
                 "bwd": run(fv.flash_varlen_bwd_plain, q, k, v, dout, wl,
                            delta, cuq, cuk, True, scale)}
        lib_name, lib_in, lib_call = varlen_library(torch, q, k, v, cuq,
                                                    max_len) \
            if tok else (None, None, None)
        lib, lib_err = {}, None
        if lib_call is not None:
            lib["fwd"] = time_ms(torch, lib_call, flush=flush)
            lo = lib_call()
            ct = dout if lo.dim() == 3 else dout.transpose(0, 1)[None]
            lib["bwd"] = time_ms(torch, lambda: torch.autograd.grad(
                lo, lib_in, ct, retain_graph=True), flush=flush)
            # back to [T, heads, d]; kv heads repeated outside the call
            # sum their group's grads
            packed = lambda x, n: (x[0].transpose(0, 1) if x.dim() == 4  # noqa
                                   else x).unflatten(1, (n, -1)).sum(2)
            lgrads = torch.autograd.grad(lo, lib_in, ct)
            lib_err = library_errors(
                torch, dname, packed(lo.detach(), H),
                [packed(g_, n) for g_, n in zip(lgrads, (H, KV, KV))], wo,
                ref)
            del lo, lib_in, lib_call, lgrads
        del ref
        # the padded flash kernels over the same documents, b x max_len
        padded = {}
        if tok:
            B, S = len(lens), max(lens)
            pad = lambda x: torch.zeros(  # noqa: E731
                (B, S) + x.shape[1:], dtype=x.dtype, device=x.device)
            pq, pk, pv, pdo = pad(q), pad(k), pad(v), pad(dout)
            c = cuq.tolist()
            for i in range(B):
                for src, dst in ((q, pq), (k, pk), (v, pv), (dout, pdo)):
                    dst[i, :lens[i]] = src[c[i]:c[i + 1]]
            po, pl = fa.flash_fwd_kernel(pq, pk, pv, True, scale)
            pdel = (pdo.float() * po.float()).sum(-1).transpose(1, 2) \
                .contiguous()
            padded = {
                "shape": [B, S],
                "fwd": run(fa.flash_fwd_kernel, pq, pk, pv, True, scale),
                "dq": run(fa.flash_dq_kernel, pq, pk, pv, pdo, pl, pdel,
                          True, scale),
                "dkv": run(fa.flash_dkv_kernel, pq, pk, pv, pdo, pl, pdel,
                           True, scale)}
            del pq, pk, pv, pdo, po, pl, pdel
        abs_errs["fwd"], errs["fwd"] = e_out, e_out_rel
        abs_errs["dkv"] = max(abs_errs["dk"], abs_errs["dv"])
        errs["dkv"] = max(errs["dk"], errs["dv"])
        rates = achieved(ms, flops, {n: b[0] for n, b in bounds.items()})
        res = {}
        for kern in ("fwd", "dq", "dkv"):
            lib_ms = lib.get("fwd" if kern == "fwd" else "bwd")
            res[kern] = dict(
                max_abs_err=abs_errs[kern], max_rel_err=errs[kern],
                ms=ms[kern], plain_ms=plain["fwd" if kern == "fwd"
                                            else "bwd"],
                bound_ms=bounds[kern][0], bound_by=bounds[kern][1],
                library_ms=lib_ms, padded_flash_ms=padded.get(kern),
                launches=counts[f"flash_varlen_{kern}"], **rates[kern])
        res["dq"]["three_product_floor_ms"] = dq_floor
        tiles, interior = varlen_tiles(torch, lay)
        res.update(lse_max_abs_err=e_lse, pairs=pairs, flops=flops,
                   tiles=tiles, interior_tile_share=interior,
                   library=lib_name, padded_shape=padded.get("shape"),
                   grad_errs=errs, planted_fault_errs=faults,
                   library_errs=lib_err, bitwise_run_to_run=bitwise)
        out[label] = res
        log(f"flash_varlen[{label}] T {VARLEN_T} ({len(lens)} docs, max "
            f"{max(lens)}) h{H}/{KV} d{D} causal: out max_abs_err "
            f"{e_out:.3e} lse {e_lse:.2e} rel errs "
            f"{ {n: round(e, 6) for n, e in errs.items()} }; launches per "
            f"call 1/1/1; ms fwd {ms['fwd']:.3f} dq {ms['dq']:.3f} dkv "
            f"{ms['dkv']:.3f}; TFLOP/s (share of bound) "
            + ", ".join(f"{n} {r['tflops']:.1f} ({r['bound_share']:.3f})"
                        for n, r in rates.items())
            + f"; plain fwd {plain['fwd']:.2f} bwd "
            f"{plain['bwd']:.2f}; bound fwd {bounds['fwd'][0]:.4f} dq "
            f"{bounds['dq'][0]:.4f} (three-product floor {dq_floor:.4f}) "
            f"dkv {bounds['dkv'][0]:.4f} "
            f"({bounds['fwd'][1]}; {pairs} pairs, {tiles} tiles per head, "
            f"{interior:.3f} of them interior)"
            + (f"; library {lib_name}: fwd {lib['fwd']:.3f} bwd "
               f"{lib['bwd']:.3f}, its own errors vs plain {lib_err}"
               if lib else "")
            + ("; two launches of each kernel give the same bytes"
               if bitwise else "")
            + (f"; padded flash {padded['shape']}: fwd {padded['fwd']:.3f} "
               f"dq {padded['dq']:.3f} dkv {padded['dkv']:.3f}"
               if padded else "")
            + (f"; planted faults rejected: {faults}" if faults else ""))
        del q, k, v, dout, wo, wl, lse, delta, lay
        torch.cuda.empty_cache()
    out["launches"] = launched
    report["kernels"]["flash_varlen"] = out
    return out


def fused_bucket_tensors(torch, g, dev="cuda"):
    """One decoder layer's and the embedding's parameters at Llama-3-8B
    width: bf16 params, float32 masters and zero moments, bf16 grads."""
    from paddle_tpu_torch.models import LlamaConfig
    c = LlamaConfig.llama3_8b()
    hid, inter, vocab = c.hidden_size, c.intermediate_size, c.vocab_size
    kvd = c.num_key_value_heads * hid // c.num_attention_heads
    shapes = [(vocab, hid), (hid, hid), (hid, kvd), (hid, kvd), (hid, hid),
              (hid, inter), (hid, inter), (inter, hid), (hid,), (hid,)]
    lows = [(torch.randn(s, generator=g, device=dev) * 0.02).bfloat16()
            for s in shapes]
    masters = [p.float() for p in lows]
    states = [{"m": torch.zeros(s, device=dev), "v": torch.zeros(s,
                                                                 device=dev)}
              for s in shapes]
    grads = [(torch.randn(s, generator=g, device=dev) * 1e-3).bfloat16()
             for s in shapes]
    return masters, grads, states, lows


def fused_plan_facts(torch, name, cfg, cdtype, gdtype, rows):
    """The kernel's launch geometry for a bucket of ``rows`` chunk-table
    rows: blocks a row (``split_plan``) and resident blocks an SM."""
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import fused_optimizer as fo
    return dict(rows=rows, split=fo.split_plan(rows, _build.sm_count(
        torch.device("cuda"))), blocks_per_sm=fo.blocks_per_sm(
            name, cfg, cdtype, gdtype))


def fused_vs_plain(torch, kind, cfg, bucket, lr, wd, step):
    """``fused_bucket_kernel`` on ``bucket = (targets, grads, states,
    lows)``, in place, against ``fused_bucket_plain`` on copies, bit for
    bit over three Adam steps from ``step``: a plain one; one through the
    unscale and clip channels (inv 1/64, coeff 0.5), its weight decay
    0.01 where ``wd`` is 0, so a coupled rule's decay term runs too; and
    found = 1, where the kernel must leave every input as it was. Returns
    the steps checked."""
    from paddle_tpu_torch.ops.kernels import fused_optimizer as fo

    targets, grads, states, lows = bucket
    copies = ([t.clone() for t in targets], grads,
              [{k: t.clone() for k, t in s.items()} for s in states],
              [None if t is None else t.clone() for t in lows])
    one = torch.ones((), device=targets[0].device)

    def svec(at, inv=1.0, coeff=1.0, found=0.0, decay=wd):
        st = one * at
        # Adam's bias corrections (the Momentum rule reads none)
        bc1, bc2 = fo.bias_inv(cfg.get("b1", 0.9), cfg.get("b2", 0.999), st)
        return fo.pack_scalars(lr=one * lr, step=st, inv=one * inv,
                               coeff=one * coeff, found=one * found,
                               wd=one * decay, inv_bc1=bc1, inv_bc2=bc2)

    def flat(side):
        return side[0] + [t for t in side[3] if t is not None] \
            + [t for s in side[2] for t in s.values()]

    def same(tag):
        for a, b in zip(flat(bucket), flat(copies)):
            if not torch.equal(a, b):
                raise AssertionError(
                    f"fused_optimizer ({tag}): kernel and plain version "
                    f"differ: {int((a != b).sum())} elements of a "
                    f"{tuple(a.shape)} {a.dtype} tensor")

    decay = wd or 0.01
    steps = [("plain step", svec(step)),
             (f"inv 1/64, coeff 0.5, wd {decay}",
              svec(step + 1, inv=1 / 64, coeff=0.5, decay=decay))]
    for tag, sv in steps:
        fo.fused_bucket_kernel(kind, cfg, *bucket, sv)
        torch.cuda.synchronize()
        fo.fused_bucket_plain(kind, cfg, *copies, sv)
        same(tag)
    # found = 1: the kernel must leave every input as it was (the copies
    # hold them), and then the plain version too
    sv = svec(step + 2, found=1.0)
    fo.fused_bucket_kernel(kind, cfg, *bucket, sv)
    torch.cuda.synchronize()
    same("found=1, kernel outputs vs inputs")
    fo.fused_bucket_plain(kind, cfg, *copies, sv)
    same("found=1, plain")
    return [t for t, _ in steps] + ["found=1"]


def run_buckets_vs_plain(torch, train, inputs, labels):
    """The fused optimizer's kernel against its plain version on a
    training run's own buckets (:func:`fused_vs_plain`): the plan, rule
    and hyperparameters of ``train``'s optimizer, its parameters,
    masters and moments after the run, and the grads of one more
    backward on the run's batch. Leaves the model and optimizer
    changed: call it on a run that is done."""
    from paddle_tpu_torch.optimizer.optimizer import _fused_kind_cfg
    opt = train.optimizer
    train._forward_backward(tuple(inputs), tuple(labels))
    idxs = opt._grad_idxs()
    plan = opt._fused_route(idxs, record=False)
    kind, cfg = _fused_kind_cfg(opt)
    if plan is None or kind not in ("adam", "momentum"):
        raise AssertionError(f"the run's optimizer takes no fused Adam or "
                             f"Momentum route ({type(opt).__name__})")
    params = opt._parameter_list
    lr = float(opt.get_lr())
    out = []
    for b in plan.buckets:
        ks = [idxs[j] for j in b.ids]
        bucket = ([params[i].detach() if opt._masters[i] is None
                   else opt._masters[i] for i in ks],
                  [params[i].grad for i in ks],
                  [opt._states[i] for i in ks],
                  [None if opt._masters[i] is None else params[i].detach()
                   for i in ks])
        steps = fused_vs_plain(torch, kind, cfg, bucket, lr, b.wd,
                               opt._step_count + 1)
        out.append(dict(params=b.total, compute=b.cdtype, grads=b.gdtype,
                        write_back=b.low, wd=b.wd, rule=kind,
                        decoupled=cfg.get("decoupled"), bitwise_equal=True,
                        checked_steps=steps))
    opt.clear_grad()
    return out


def phase_fused_optimizer(torch, seed, report, flush):
    from paddle_tpu_torch.ops.kernels import fused_optimizer as fo

    g = torch.Generator(device="cuda").manual_seed(seed + 3)
    cfg = {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "decoupled": True}
    A = fused_bucket_tensors(torch, g)
    n = sum(t.numel() for t in A[0])
    one = torch.ones((), device="cuda")
    checked = fused_vs_plain(torch, "adam", cfg, A, 1e-4, 0.01, 1)
    bc1, bc2 = fo.bias_inv(cfg["b1"], cfg["b2"], one * 2)
    sv = fo.pack_scalars(lr=one * 1e-4, step=one * 2, inv=one / 64,
                         coeff=one * 0.5, found=one * 0, wd=one * 0.01,
                         inv_bc1=bc1, inv_bc2=bc2)
    # a bucket caches the chunk table (built by the warm-up call), so the
    # timed window holds the launch only, as on the training path
    bucket = fo.plan_buckets("adam", cfg, [
        (tuple(t.shape), "float32", "bfloat16", "bfloat16", 0.01)
        for t in A[0]]).buckets[0]
    ms = time_ms(torch, lambda: fo.fused_bucket_kernel(
        "adam", cfg, *A, sv, bucket), flush=flush)
    plain_ms = time_ms(torch, lambda: fo.fused_bucket_plain(
        "adam", cfg, *A, sv), iters=3, flush=flush)
    # yardstick, timed here only: torch's fused AdamW over the float32
    # masters, float32 copies of the grads and the moments; a near-equal
    # function (no bf16 write-back, no unscale/clip/sentinel channels)
    g32 = [x.float() for x in A[1]]
    steps_t = [one * 2 for _ in A[0]]
    lib_ms = time_ms(torch, lambda: torch._fused_adamw_(
        A[0], g32, [s["m"] for s in A[2]], [s["v"] for s in A[2]], [],
        steps_t, lr=1e-4, beta1=0.9, beta2=0.999, weight_decay=0.01,
        eps=1e-8, amsgrad=False, maximize=False), flush=flush)
    rows = fo.table_rows(A[0])[0]
    del g32, A
    nbytes = 28 * n
    b_ms, b_by = bound(nbytes, 20 * n, F32_FLOPS_PER_S)
    res = dict(max_abs_err=0.0, bitwise_equal=True, params=n, ms=ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=lib_ms, bytes=nbytes, checked_steps=checked,
               **fused_plan_facts(torch, "adam", cfg, "float32", "bfloat16",
                                  rows))
    log(f"fused_optimizer[adamw, {n / 1e6:.0f}M bf16 params, f32 masters]: "
        f"bitwise equal to plain over {res['checked_steps']}; ms {ms:.3f} "
        f"plain_ms {plain_ms:.2f} library_ms {lib_ms:.3f} "
        f"(torch._fused_adamw_, f32 grads, no write-back) bound_ms "
        f"{b_ms:.3f} ({b_by}); rows {res['rows']} split {res['split']} "
        f"blocks/SM {res['blocks_per_sm']}")
    report["kernels"]["fused_optimizer"] = {"bfloat16": res}
    return res


LAMB_CFG = {"b1": 0.9, "b2": 0.999, "eps": 1e-6}


def phase_lamb_optimizer(torch, seed, report, flush):
    """Lamb's two kernel passes over the same 743M-param bucket as the
    AdamW check: pass 1, the trust ratios in torch, pass 2, bit for bit
    against the plain version over three steps (plain; unscale and clip;
    found = 1, which must keep every input), then each part timed."""
    from paddle_tpu_torch.ops.kernels import fused_optimizer as fo

    g = torch.Generator(device="cuda").manual_seed(seed + 6)
    A = fused_bucket_tensors(torch, g)
    Bt = ([t.clone() for t in A[0]], A[1],
          [{k: t.clone() for k, t in s.items()} for s in A[2]],
          [t.clone() for t in A[3]])
    n = sum(t.numel() for t in A[0])
    one = torch.ones((), device="cuda")

    def svec(step, inv=1.0, coeff=1.0, found=0.0):
        st = one * step
        bc1, bc2 = fo.bias_inv(LAMB_CFG["b1"], LAMB_CFG["b2"], st)
        return fo.pack_scalars(lr=one * 1e-4, step=st, inv=one * inv,
                               coeff=one * coeff, found=one * found,
                               wd=one * 0.01, inv_bc1=bc1, inv_bc2=bc2)

    def flat(side):
        return side[0] + side[3] + [t for s in side[2] for t in s.values()]

    def same(tag):
        for a, b in zip(flat(A), flat(Bt)):
            if not torch.equal(a, b):
                raise AssertionError(
                    f"lamb ({tag}): kernel and plain version differ: "
                    f"{int((a != b).sum())} elements of a {tuple(a.shape)} "
                    f"tensor")

    bucket = fo.plan_buckets("lamb", LAMB_CFG, [
        (tuple(t.shape), "float32", "bfloat16", "bfloat16", 0.01)
        for t in A[0]]).buckets[0]
    steps = [("plain step", svec(1)),
             ("inv 1/64, coeff 0.5", svec(2, inv=1 / 64, coeff=0.5))]
    for tag, sv in steps:
        fo.fused_bucket_kernel("lamb", LAMB_CFG, *A, sv, bucket)
        torch.cuda.synchronize()
        fo.fused_bucket_plain("lamb", LAMB_CFG, *Bt, sv)
        same(tag)
    sv = svec(3, found=1.0)
    fo.fused_bucket_kernel("lamb", LAMB_CFG, *A, sv, bucket)
    torch.cuda.synchronize()
    same("found=1, kernel outputs vs inputs")
    fo.fused_bucket_plain("lamb", LAMB_CFG, *Bt, sv)
    same("found=1, plain")
    del Bt
    torch.cuda.empty_cache()

    # times of each part (the bucket holds the chunk table and the
    # scratch, as on the training path)
    sv = svec(2, inv=1 / 64, coeff=0.5)
    scratch = fo.lamb_scratch(A[0], bucket)
    ms = {
        "moments": time_ms(torch, lambda: fo.launch_pass(
            "lamb_moments", "lamb", LAMB_CFG, *A, sv, bucket, scratch),
            flush=flush),
        "ratios": time_ms(torch, lambda: fo.lamb_trust_ratios(
            A[0], scratch[0], out=scratch[1]), flush=flush),
        "apply": time_ms(torch, lambda: fo.launch_pass(
            "lamb_apply", "lamb", LAMB_CFG, *A, sv, bucket, scratch),
            flush=flush),
        "step": time_ms(torch, lambda: fo.fused_bucket_kernel(
            "lamb", LAMB_CFG, *A, sv, bucket), flush=flush)}
    trs = fo.lamb_moments_plain(LAMB_CFG, A[0], A[1], A[2], sv)
    plain = {
        "moments": time_ms(torch, lambda: fo.lamb_moments_plain(
            LAMB_CFG, A[0], A[1], A[2], sv), iters=3, flush=flush),
        "apply": time_ms(torch, lambda: fo.lamb_apply_plain(
            A[0], trs, scratch[1], A[3], sv), iters=3, flush=flush)}
    del trs
    # yardstick, timed here only: no PyTorch call computes Lamb; the
    # nearest elementwise call is torch's fused AdamW over the same
    # masters, float32 copies of the grads and the moments (it stands
    # beside the first pass, which runs Adam's chain)
    g32 = [x.float() for x in A[1]]
    steps_t = [one * 2 for _ in A[0]]
    lib_ms = time_ms(torch, lambda: torch._fused_adamw_(
        A[0], g32, [s["m"] for s in A[2]], [s["v"] for s in A[2]], [],
        steps_t, lr=1e-4, beta1=0.9, beta2=0.999, weight_decay=0.01,
        eps=1e-6, amsgrad=False, maximize=False), flush=flush)
    rows = fo.table_rows(A[0])[0]
    del g32, A, scratch
    torch.cuda.empty_cache()
    # bytes per parameter, each input read once and each output written
    # once: pass 1 reads master 4, grad 2, m 4, v 4 and writes m 4, v 4,
    # tr_div 4; pass 2 reads master 4, tr_div 4 and writes master 4,
    # param 2; the whole step's inputs and outputs are 28 (row #5's rule)
    bounds = {"moments": bound(26 * n, 20 * n, F32_FLOPS_PER_S),
              "apply": bound(14 * n, 3 * n, F32_FLOPS_PER_S),
              "ratios": bound(8 * n, 4 * n, F32_FLOPS_PER_S),
              "step": bound(28 * n, 27 * n, F32_FLOPS_PER_S)}
    res = {}
    for kern, lib in (("moments", lib_ms), ("apply", None)):
        res[kern] = dict(max_abs_err=0.0, bitwise_equal=True, ms=ms[kern],
                         plain_ms=plain[kern], bound_ms=bounds[kern][0],
                         bound_by=bounds[kern][1], library_ms=lib)
    res.update(geometry={name: fused_plan_facts(
                   torch, name, LAMB_CFG, "float32", "bfloat16", rows)
                   for name in ("lamb_moments", "lamb_apply")})
    res.update(params=n, ratios_ms=ms["ratios"],
               ratios_bound_ms=bounds["ratios"][0], step_ms=ms["step"],
               step_bound_ms=bounds["step"][0],
               library="torch._fused_adamw_ (float32 grads, no write-back): "
                       "the nearest elementwise call, beside pass 1",
               checked_steps=[t for t, _ in steps] + ["found=1"])
    log(f"lamb[{n / 1e6:.0f}M bf16 params, f32 masters]: bitwise equal to "
        f"plain over {res['checked_steps']}; ms moments {ms['moments']:.3f} "
        f"ratios {ms['ratios']:.3f} apply {ms['apply']:.3f} (whole step "
        f"{ms['step']:.3f}); plain moments {plain['moments']:.2f} apply "
        f"{plain['apply']:.2f}; bound moments {bounds['moments'][0]:.3f} "
        f"ratios {bounds['ratios'][0]:.3f} apply {bounds['apply'][0]:.3f} "
        f"step {bounds['step'][0]:.3f} (bytes); library_ms {lib_ms:.3f} "
        f"(torch._fused_adamw_, the nearest elementwise call); geometry "
        f"{json.dumps(res['geometry'])}")
    report["kernels"]["fused_optimizer_lamb"] = res
    return res


# -- phase 4b: the grouped GEMM ------------------------------------------------

# the MoE training path's shapes (DeepSeek-MoE-16B width, b 2 x s 2048 =
# 4096 tokens, 6 of 64 experts): G = E = 64 groups of capacity C =
# int(1.25 * 4096 * 6 / 64) = 480; (K, N) of the forward products, whose
# dx runs the transposed pairs through a strided view of w
MOE_E, MOE_C = 64, 480
GMM_SHAPES = {"gate_up": (2048, 1408), "down": (1408, 2048)}
GMM_TILE = 128    # the bf16 kernel's C tile (csrc/grouped_gemm.cu)


def moe_counts(rng, G, C):
    """Live rows per group as the path's routing gives them (mean t*k/E =
    384, clipped at C), with one empty group, one full group, one of a
    single row, and groups ending one row past and exactly at a C tile."""
    c = np.clip(np.rint(rng.normal(384, 64, G)), 0, C).astype(np.int32)
    c[:5] = [0, C, 1, GMM_TILE + 1, GMM_TILE]
    return c


def gmm_work(counts, G, C, K, N, E, item):
    """(flops, bytes) of one grouped product: the routed rows' products;
    the weights of every expert with a live row (the kernel reads none of
    an expert whose groups are empty), the live x rows and the whole y,
    each once."""
    live = int(counts.sum())
    experts = int((counts.reshape(E, -1).sum(1) > 0).sum())
    return (2 * live * K * N, experts * K * N * item + live * K * item
            + G * C * N * item + 4 * G)


def planted_gmm_faults(torch, gg, x, w, counts_t, want):
    """Two faults a kernel could make, produced with the plain version at
    groups per expert 2: one live C tile of a full group zeroed, and every
    group g reading expert g mod E instead of g // 2. Each must fail
    ``check_close``."""
    bad_tile = want.clone()
    bad_tile[1, GMM_TILE:2 * GMM_TILE] = 0
    bad_expert = gg.gmm_plain(x, w.repeat(2, 1, 1), counts_t, 1)
    errs = {}
    for fault, bad in (("zeroed_live_tile", bad_tile),
                       ("expert_g_not_g_div_gpe", bad_expert)):
        try:
            check_close(torch, "grouped_gemm", bad, want, "bfloat16")
        except AssertionError:
            errs[fault] = float((bad.float() - want.float()).abs().max())
            continue
        raise AssertionError(f"grouped_gemm: the tolerance passes a planted "
                             f"fault ({fault})")
    return errs


def phase_grouped_gemm(torch, seed, report, flush):
    from paddle_tpu_torch.ops.kernels import grouped_gemm as gg

    rng = np.random.RandomState(seed + 4)
    g = torch.Generator(device="cuda").manual_seed(seed + 4)
    G, C = MOE_E, MOE_C
    counts = moe_counts(rng, G, C)
    counts_t = torch.from_numpy(counts).cuda()
    dead = (torch.arange(C, device="cuda")[None, :]
            >= counts_t[:, None])
    out, faults, routes = {}, None, {}
    for label, dt in (("bfloat16", torch.bfloat16),
                      ("float32", torch.float32)):
        errs = {}
        for shape, (K, N) in GMM_SHAPES.items():
            x = torch.randn((G, C, K), generator=g, device="cuda").to(dt)
            dy = torch.randn((G, C, N), generator=g, device="cuda").to(dt)
            for gpe in (1, 2):
                w = (torch.randn((G // gpe, K, N), generator=g,
                                 device="cuda") * 0.02).to(dt)
                cases = [(f"{shape}/gpe{gpe}", x, w)]
                if gpe == 1:      # dx: dy @ w^T through a strided view
                    cases.append((f"{shape}/dx_transposed_w", dy,
                                  w.transpose(1, 2)))
                for name, a, b in cases:
                    routes[f"{label}/{name}"] = gg.gmm_route(a, b)
                    got = gg.gmm_kernel(a, b, counts_t, gpe)
                    torch.cuda.synchronize()
                    want = gg.gmm_plain(a, b, counts_t, gpe)
                    errs[name] = check_close(torch, f"grouped_gemm[{label}/"
                                             f"{name}]", got, want, label)
                    if bool((got[dead] != 0).any()):
                        raise AssertionError(f"grouped_gemm[{label}/{name}]: "
                                             f"rows past counts not zero")
                    if label == "bfloat16" and shape == "gate_up" \
                            and gpe == 2:
                        faults = planted_gmm_faults(torch, gg, a, b,
                                                    counts_t, want)
                    del got, want
                del w
            del x, dy
        out[label] = {"max_abs_err_by_case": errs,
                      "max_abs_err": max(errs.values())}
    out["bfloat16"]["planted_fault_max_abs_err"] = faults

    # times at the path's four launch shapes (gpe 1), bf16 and float32:
    # the forward products and their dx through the transposed view.
    # Yardstick: torch.bmm over the count-masked buffer, on the same view
    # of w (what gmm_reference computes: a near-equal function that spends
    # products on the dead rows), timed here only
    rows = ~dead[..., None]
    times = {}
    for label, dt in (("bfloat16", torch.bfloat16),
                      ("float32", torch.float32)):
        for shape, (K, N) in GMM_SHAPES.items():
            for launch in ("fwd", "dx"):
                w = (torch.randn((G, K, N), generator=g, device="cuda")
                     * 0.02).to(dt)
                if launch == "fwd":
                    a, b = torch.randn((G, C, K), generator=g,
                                       device="cuda").to(dt), w
                else:
                    a, b = torch.randn((G, C, N), generator=g,
                                       device="cuda").to(dt), \
                        w.transpose(1, 2)
                am = torch.where(rows, a, 0)
                kk, nn_ = a.shape[2], b.shape[2]
                flops, nbytes = gmm_work(counts, G, C, kk, nn_, G,
                                         a.element_size())
                b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S
                                   if label == "bfloat16"
                                   else F32_FLOPS_PER_S)
                key = f"{label}/{shape}/{launch}"
                times[key] = t = dict(
                    K=kk, N=nn_, route=gg.gmm_route(a, b),
                    bitwise_twice=bitwise_twice(
                        torch, f"grouped_gemm[{key}]",
                        lambda: gg.gmm_kernel(a, b, counts_t)),
                    ms=time_ms(torch, lambda: gg.gmm_kernel(
                        a, b, counts_t), flush=flush),
                    plain_ms=time_ms(torch, lambda: gg.gmm_plain(
                        a, b, counts_t), iters=3, flush=flush),
                    library_ms=time_ms(torch, lambda: torch.bmm(am, b),
                                       flush=flush),
                    bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes)
                t.update(achieved({key: t["ms"]}, {key: flops},
                                  {key: b_ms}, {key: nbytes})[key])
                del w, a, b, am
    for label in out:
        head = times[f"{label}/gate_up/fwd"]
        out[label].update({k: head[k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})
    out["times"] = times
    out["routes"] = routes

    # dw, outside the kernel as in the reference: the route the backward
    # takes for bf16 (bf16 products, float32 output) against the float32
    # product of the same values, at the gate/up shape
    K, N = GMM_SHAPES["gate_up"]
    x = torch.randn((G, C, K), generator=g, device="cuda").bfloat16()
    dy = torch.randn((G, C, N), generator=g, device="cuda").bfloat16()
    dw = gg.grad_w(x, dy, counts_t, 1, torch.bfloat16)
    dw32 = gg.grad_w(x.float(), dy.float(), counts_t, 1, torch.float32)
    err = check_close(torch, "grad_w[bf16 vs float32]", dw, dw32,
                      "bfloat16")
    out["grad_w"] = dict(
        max_abs_err_vs_float32=err, flops=2 * G * C * K * N,
        ms=time_ms(torch, lambda: gg.grad_w(x, dy, counts_t, 1,
                                            torch.bfloat16), flush=flush),
        float32_ms=time_ms(torch, lambda: gg.grad_w(
            x.float(), dy.float(), counts_t, 1, torch.float32),
            flush=flush))
    del x, dy, dw, dw32
    log(f"grouped_gemm dw [E{G}, K{K}, N{N}] over C{C}: bf16 route "
        f"{out['grad_w']['ms']:.4f} ms, float32 route "
        f"{out['grad_w']['float32_ms']:.4f} ms, max abs err "
        f"{err:.3e} between them")
    out["counts"] = dict(sum=int(counts.sum()), min=int(counts.min()),
                         max=int(counts.max()), G=G, C=C)
    for label in ("bfloat16", "float32"):
        log(f"grouped_gemm[{label}] G{G} C{C}: max_abs_err "
            f"{out[label]['max_abs_err']:.3e} over "
            f"{sorted(out[label]['max_abs_err_by_case'])}")
    log(f"grouped_gemm: planted faults rejected: {faults}")
    log(f"grouped_gemm: routes (C entry, by dtype and strides): "
        f"{json.dumps(routes)}")
    for key, t in times.items():
        log(f"grouped_gemm[{key}] K{t['K']} N{t['N']} (counts sum "
            f"{int(counts.sum())}, {t['route']}): ms {t['ms']:.4f} plain_ms "
            f"{t['plain_ms']:.3f} library_ms {t['library_ms']:.4f} (bmm, "
            f"masked buffer) bound_ms {t['bound_ms']:.4f} ({t['bound_by']}),"
            f" {t['tflops']:.1f} TFLOP/s, {t['gbps']:.0f} GB/s, "
            f"{t['bound_share']:.1%} of the bound, two launches bitwise "
            f"equal")
    report["kernels"]["grouped_gemm"] = out
    return out


# -- phase 4c: the int4 weight-only GEMM ----------------------------------------

# Llama-3-8B's linears as (k, n): q and o, k and v, gate and up, down; m:
# one row, generate()'s decode batch of 4, the engine's decode rows (16,
# max_batch), a ragged count, and the engine's 512-token step; two shapes
# with tails in m, n and k (the second with n and k % 8 != 0, so element
# loads on the WMMA route). Timed: every Llama shape at m 4, 16 and 512
INT4_KN = {"qo": (4096, 4096), "kv": (4096, 1024), "gate_up": (4096, 14336),
           "down": (14336, 4096)}
INT4_MS = (1, 4, 16, 37, 512)
INT4_TIMED_MS = (4, 16, 512)
INT4_TAILS = ((77, 4100, 1000), (3, 330, 1001))


def int4_from_planes(torch, x, lo, hi, s):
    """The plain formulation over given nibble planes: a planted fault of
    the unpack is a change of the planes."""
    xb = x.to(torch.bfloat16)
    acc = xb[:, 0::2].float() @ lo.float() + xb[:, 1::2].float() @ hi.float()
    return (acc * s.reshape(1, -1)).to(x.dtype)


def planted_int4_faults(torch, wog, x, q, s, want):
    """Two faults an unpack could make, produced with the plain
    formulation: the nibbles swapped (row 2i read from the high nibble)
    and no sign extension (nibbles read as 0..15). Each must fail
    ``check_close``."""
    lo, hi = wog._nibbles(q)
    w32 = q.to(torch.int32)
    errs = {}
    for fault, planes in (("nibbles_swapped", (hi, lo)),
                          ("no_sign_extension", (w32 & 0xF,
                                                 (w32 >> 4) & 0xF))):
        bad = int4_from_planes(torch, x, *planes, s)
        try:
            check_close(torch, "weight_only_int4_gemm", bad, want, "bfloat16")
        except AssertionError:
            errs[fault] = float((bad.float() - want.float()).abs().max())
            continue
        raise AssertionError(f"weight_only_int4_gemm: the tolerance passes "
                             f"a planted fault ({fault})")
    return errs


def int4_work(m, k, n, x_item):
    """(flops, bytes) of one product: the packed weight, x, the scales and
    y (in x's dtype), each once."""
    return 2 * m * k * n, k // 2 * n + m * k * x_item + 4 * n + m * n * x_item


def phase_int4_gemm(torch, seed, report, flush):
    from paddle_tpu_torch.ops.kernels import weight_only_gemm as wog

    g = torch.Generator(device="cuda").manual_seed(seed + 5)
    dtypes = (("bfloat16", torch.bfloat16), ("float32", torch.float32))
    errs = {label: {} for label, _ in dtypes}
    faults, times, routes = None, {}, {}
    # (name, k, n, the m of each case): one weight per entry
    weights = [(name, k, n, INT4_MS) for name, (k, n) in INT4_KN.items()] \
        + [(f"tail_{m}x{k}x{n}", k, n, (m,)) for m, k, n in INT4_TAILS]
    for name, k, n, ms in weights:
        w = torch.randn((k, n), generator=g, device="cuda") * 0.02
        w16, (q, s) = w.bfloat16(), wog.quantize(w, "int4")
        del w
        for m, (label, dt) in itertools.product(ms, dtypes):
            x = torch.randn((m, k), generator=g, device="cuda").to(dt)
            got = wog.int4_matmul_kernel(x, q, s)
            torch.cuda.synchronize()
            want = wog.int4_matmul_plain(x, q, s)
            case = f"{name}/m{m}" if name in INT4_KN else name
            errs[label][case] = check_close(
                torch, f"weight_only_int4_gemm[{label}/{case}]", got, want,
                label)
            # the C entry's route for the bf16 x the wrapper passes on
            route, slices = wog.int4_route(x.to(torch.bfloat16), q)
            routes[case] = f"{route}/{slices} slices"
            if label == "bfloat16" and name == "gate_up" and m == 512:
                faults = planted_int4_faults(torch, wog, x, q, s, want)
            del got, want
            # times: every Llama shape at m 4, 16 and 512 in bf16, and the
            # gate/up step in float32; yardsticks, timed here only: one
            # torch.mm of bf16(x) and the codes unpacked to bf16 (unpacked
            # outside the window) with a float32 output, then the scale
            # (the same function up to summation order, reading 4x the
            # weight bytes); and torch.matmul over the bf16 weight before
            # quantization
            if name in INT4_KN and m in INT4_TIMED_MS and (
                    label == "bfloat16" or (name, m) == ("gate_up", 512)):
                wq = wog._unpack_int4(q, n).bfloat16()
                xm = x if label == "bfloat16" else x.bfloat16()
                flops, nbytes = int4_work(m, k, n, x.element_size())
                b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
                key = f"{label}/{name}/m{m}"
                t = dict(
                    m=m, k=k, n=n, route=routes[case],
                    bitwise_twice=bitwise_twice(
                        torch, f"weight_only_int4_gemm[{key}]",
                        lambda: wog.int4_matmul_kernel(x, q, s)),
                    ms=time_ms(torch, lambda: wog.int4_matmul_kernel(
                        x, q, s), flush=flush),
                    plain_ms=time_ms(torch, lambda: wog.int4_matmul_plain(
                        x, q, s), iters=3, flush=flush),
                    library_ms=time_ms(torch, lambda: (torch.mm(
                        x.bfloat16(), wq, out_dtype=torch.float32)
                        * s).to(x.dtype), flush=flush),
                    library_bf16_weight_ms=time_ms(
                        torch, lambda: torch.matmul(xm, w16), flush=flush),
                    bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes)
                t.update(achieved({key: t["ms"]}, {key: flops},
                                  {key: b_ms}, {key: nbytes})[key])
                times[key] = t
                del wq, xm
            del x
        del w16, q, s
    out = {}
    for label, _ in dtypes:
        head = times[f"{label}/gate_up/m512"]
        out[label] = dict(max_abs_err_by_case=errs[label],
                          max_abs_err=max(errs[label].values()),
                          **{k: head[k] for k in (
                              "ms", "plain_ms", "library_ms",
                              "library_bf16_weight_ms", "bound_ms",
                              "bound_by")})
        log(f"weight_only_int4_gemm[{label}]: max_abs_err "
            f"{out[label]['max_abs_err']:.3e} over {len(errs[label])} "
            f"shapes ({sorted(errs[label])})")
    out["bfloat16"]["planted_fault_max_abs_err"] = faults
    out["bfloat16"]["decode_m16_ms"] = {
        name: times[f"bfloat16/{name}/m16"]["ms"] for name in INT4_KN}
    out["times"] = times
    out["routes"] = routes
    log(f"weight_only_int4_gemm: planted faults rejected: {faults}")
    log(f"weight_only_int4_gemm: routes (C entry, by shape): "
        f"{json.dumps(routes)}")
    for key, t in times.items():
        log(f"weight_only_int4_gemm[{key}] k{t['k']} n{t['n']} "
            f"({t['route']}): ms {t['ms']:.4f} plain_ms "
            f"{t['plain_ms']:.3f} library_ms {t['library_ms']:.4f} (mm "
            f"over the unpacked codes) bf16-weight matmul "
            f"{t['library_bf16_weight_ms']:.4f} bound_ms "
            f"{t['bound_ms']:.4f} ({t['bound_by']}), {t['tflops']:.1f} "
            f"TFLOP/s, {t['gbps']:.0f} GB/s, {t['bound_share']:.1%} of "
            f"the bound, two launches bitwise equal")
    report["kernels"]["weight_only_int4_gemm"] = out
    return out


# -- phase 4d: block-CSR SpMM through sparse.bcsr_matmul ------------------------

# Llama-3-8B's MLP weights (out x in) block-pruned in 128 x 128 blocks, about
# half kept, times the activations of a 2 x 2048 training batch transposed
# (yT = W xT); the reference test's 16 x 128 blocks at a smaller size
BCSR_TOKENS = 4096
BCSR_SHAPES = {"gate_proj": (14336, 4096, 128, 128),
               "down_proj": (4096, 14336, 128, 128),
               "blocks_16x128": (2048, 1024, 16, 128)}
BCSR_EMPTY_ROWS = (3, 17)        # block rows pruned whole
BCSR_TOL = {"bfloat16": 1e-2, "float32": 1e-4}   # of the output's max
# the kernel each dtype's aligned x must reach (csrc/bcsr_spmm.cu)
BCSR_ROUTE_STEMS = {"bfloat16": ("bcsr_spmm_wgmma_kernel",),
                    "float32": ("bcsr_spmm_f32_kernel",)}


def bcsr_tile_rows(dname, bm):
    """The M tile of the BCSR kernel that ``bm`` takes (csrc/bcsr_spmm.cu):
    bf16 (wgmma) 64 or 128 rows; float32 the smallest of 16, 32, 64 and
    128 that holds bm, 128 past it."""
    tiles = (64, 128) if dname == "bfloat16" else (16, 32, 64, 128)
    return next((t for t in tiles if bm <= t), 128)


def pruned_weight(torch, g, rng, M, K, bm, bk, dtype):
    """A normal(0, 0.02) [M, K] weight with about half of its bm x bk
    blocks zeroed by a mask from ``rng``, and BCSR_EMPTY_ROWS zeroed."""
    mask = rng.rand(M // bm, K // bk) < 0.5
    mask[list(BCSR_EMPTY_ROWS)] = False
    m = torch.from_numpy(mask).cuda()
    w = torch.randn((M, K), generator=g, device="cuda") * 0.02
    w = (w.view(M // bm, bm, K // bk, bk) * m[:, None, :, None]).view(M, K)
    return w.to(dtype)


def spmm_work(nb, bm, bk, mb, k, n, item):
    """(flops, bytes) of one call: 2·bm·bk·N per kept block; the kept
    blocks, x and y once each, and the int32 structure."""
    return (2 * nb * bm * bk * n,
            (nb * bm * bk + k * n + mb * bm * n) * item + 4 * (mb + 1 + nb))


def bcsr_check(torch, name, got, want, dtype_name, bm):
    """The kernel's output within BCSR_TOL of the plain one's max, the
    empty block rows exactly zero; returns the max abs err."""
    err = float((got.float() - want.float()).abs().max())
    lim = BCSR_TOL[dtype_name] * float(want.float().abs().max())
    if not bool(torch.isfinite(got).all()) or err > lim:
        raise AssertionError(f"{name}: kernel differs from plain version: "
                             f"max abs err {err} (limit {lim})")
    for r in BCSR_EMPTY_ROWS:
        if bool((got[r * bm:(r + 1) * bm] != 0).any()):
            raise AssertionError(f"{name}: empty block row {r} not zero")
    return err


def planted_bcsr_faults(torch, bs, crows, cols, vals, x, want, dtype_name):
    """Three faults a kernel could make, produced with the plain version,
    each of which must fail ``bcsr_check``: one block read at a column id
    off by one, a block row's run cut by its last block, and an empty
    block row left unwritten (holding another row's values)."""
    bm, Kb = vals.shape[1], x.shape[0] // vals.shape[2]
    row = int(np.argmax(np.diff(crows)))          # the longest run
    p = int(crows[row + 1]) - 1                   # its last block
    bad_cols = cols.copy()
    bad_cols[p] = (bad_cols[p] + 1) % Kb
    cut = vals.clone()
    cut[p] = 0
    unwritten = want.clone()
    r = BCSR_EMPTY_ROWS[0]
    unwritten[r * bm:(r + 1) * bm] = want[row * bm:(row + 1) * bm]
    errs = {}
    for fault, bad in (
            ("column_off_by_one",
             bs.bcsr_spmm_plain(crows, bad_cols, vals, x)),
            ("run_cut_by_one_block", bs.bcsr_spmm_plain(crows, cols, cut, x)),
            ("empty_row_not_zeroed", unwritten)):
        try:
            bcsr_check(torch, "bcsr_spmm", bad, want, dtype_name, bm)
        except AssertionError:
            errs[fault] = float((bad.float() - want.float()).abs().max())
            continue
        raise AssertionError(f"bcsr_spmm: the check passes a planted fault "
                             f"({fault})")
    return errs


def phase_bcsr(torch, seed, report, flush):
    """``sparse.bcsr_from_dense`` over block-pruned Llama-3-8B MLP weights
    and ``sparse.bcsr_matmul`` against transposed activations, the path a
    user of block-pruned weights calls: exactly one kernel launch per
    call; the kernel against its plain version (bf16 and float32); three
    planted faults; times beside the bound, the plain version, the dense
    product over the zero-filled weight and torch's own BSR product."""
    from paddle_tpu_torch import sparse
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import bcsr_spmm as bs

    rng = np.random.RandomState(seed + 7)
    g = torch.Generator(device="cuda").manual_seed(seed + 7)
    out, faults, launched = {}, None, 0
    cases = [("gate_proj", "bfloat16"), ("down_proj", "bfloat16"),
             ("gate_proj", "float32"), ("blocks_16x128", "bfloat16"),
             ("blocks_16x128", "float32")]
    for shape, dname in cases:
        M, K, bm, bk = BCSR_SHAPES[shape]
        dt = getattr(torch, dname)
        N = BCSR_TOKENS if shape != "blocks_16x128" else 512
        w = pruned_weight(torch, g, rng, M, K, bm, bk, dt)
        x = torch.randn((N, K), generator=g, device="cuda").to(dt).t() \
            .contiguous()                               # [K, N]: x^T
        crows, cols, vals = sparse.bcsr_from_dense(w, bm, bk)
        # the main path: one call, counts reset just before
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        got = sparse.bcsr_matmul(crows, cols, vals, x)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        if counts != {k: int(k == "bcsr_spmm") for k in counts}:
            raise AssertionError(f"bcsr_matmul[{shape}/{dname}]: launches "
                                 f"{counts}, want one bcsr_spmm")
        launched += counts["bcsr_spmm"]
        want = bs.bcsr_spmm_plain(crows, cols, vals, x)
        label = f"{shape}/{dname}"
        err = bcsr_check(torch, f"bcsr_spmm[{label}]", got, want, dname, bm)
        if (shape, dname) == ("gate_proj", "bfloat16"):
            faults = planted_bcsr_faults(torch, bs, crows, cols, vals, x,
                                         want, dname)
        del got, want
        nb = len(cols)
        flops, nbytes = spmm_work(nb, bm, bk, M // bm, K, N,
                                  x.element_size())
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S
                           if dname == "bfloat16" else F32_FLOPS_PER_S)
        structure = bs.device_structure(crows, cols, nb, K // bk, x.device)
        kern = lambda: bs.bcsr_spmm_kernel(  # noqa: E731
            *structure, vals, x)
        twice = bitwise_twice(torch, f"bcsr_spmm[{shape}/{dname}]", kern)
        ms = time_ms(torch, kern, flush=flush)
        plain_ms = time_ms(torch, lambda: bs.bcsr_spmm_plain(
            crows, cols, vals, x), iters=3, flush=flush)
        # yardsticks, timed here only: the dense product over the
        # zero-filled weight, and torch's block-sparse (BSR) product
        dense_ms = time_ms(torch, lambda: torch.matmul(w, x), flush=flush)
        try:
            wb = w.to_sparse_bsr((bm, bk))
            bsr_ms, bsr_err = time_ms(torch, lambda: wb @ x,
                                      flush=flush), None
            del wb
        except (RuntimeError, NotImplementedError, TypeError) as e:
            bsr_ms, bsr_err = None, f"{type(e).__name__}: {str(e)[:160]}"
        rate = achieved({"k": ms}, {"k": flops}, {"k": b_ms},
                        {"k": nbytes})["k"]
        out[label] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=dense_ms, library_bsr_ms=bsr_ms,
            library_bsr_error=bsr_err, blocks_kept=nb,
            blocks=(M // bm) * (K // bk), M=M, K=K, N=N, bm=bm, bk=bk,
            flops=flops, bytes=nbytes, tflops_per_s=rate["tflops"],
            gbps=rate["gbps"], bound_share=rate["bound_share"],
            bitwise_twice=twice)
        log(f"bcsr_spmm[{label}] [{M}, {K}] in {bm}x{bk} blocks, {nb} of "
            f"{out[label]['blocks']} kept, x^T [{K}, {N}]: max_abs_err "
            f"{err:.3e}; ms {ms:.4f} ({rate['tflops']:.1f} TFLOP/s, "
            f"{rate['gbps']:.0f} GB/s, {rate['bound_share']:.1%} of the "
            f"bound) plain_ms {plain_ms:.3f} bound_ms {b_ms:.4f} ({b_by}); "
            f"dense matmul {dense_ms:.4f} ms; torch BSR "
            + (f"{bsr_ms:.4f} ms" if bsr_ms is not None else
               f"refused ({bsr_err})")
            + "; two launches bitwise equal")
        del w, x, vals, structure
        torch.cuda.empty_cache()
    log(f"bcsr_spmm: planted faults rejected: {faults}")
    res = {"cases": out, "launches": launched,
           "planted_fault_max_abs_err": faults}
    head = out["gate_proj/bfloat16"]
    for dname in ("bfloat16", "float32"):
        res[dname] = {k: out[f"gate_proj/{dname}"][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_bsr_ms")}
    res["bfloat16"].update(planted_fault_max_abs_err=faults,
                           library_bsr_error=head["library_bsr_error"])
    report["kernels"]["bcsr_spmm"] = res
    return res


# -- last: the routes the redesigned kernels took -------------------------------

def phase_routes(torch, seed, report):
    """The kernels the card ran for the ragged op (bf16, int8 and float32
    pools at the smoke mix, bf16 and int8 at the engine's decode and
    prefill steps), the gang decode (bf16 and int8 pools, the serving head
    geometry) and ``sparse.bcsr_matmul`` (each BCSR_SHAPES case the block
    phase times), by the profiler's names, with each one's device ms a
    call: the split-KV pass and its merge, the ragged tile pass (bf16:
    tensor cores; float32: CUDA cores), the bf16 wgmma BCSR route (64-
    and 128-row M tiles) and the float32 FMA kernel (its M tile by bm).
    Run after every timed phase: a profiler session may slow the launches
    that follow it."""
    from paddle_tpu_torch import sparse
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa
    rng = np.random.RandomState(seed)
    q, kp, vp, tbl, ctx, cu = smoke_layout(torch, rng, torch.bfloat16)
    qd = q[:len(SMOKE_ROWS), None].contiguous()
    kq, vq, ks, vs = quantized_pools(torch, kp, vp)
    ragged_bf16 = (DECODE_KERNELS[0], RAGGED_TC_KERNEL, RAGGED_MERGE_KERNEL)
    routes = {
        "paged_attention[bfloat16]": profiled_kernels(
            torch, lambda: pa.paged_attention(qd, kp, vp, tbl, ctx),
            DECODE_KERNELS),
        "paged_attention[int8]": profiled_kernels(
            torch, lambda: pa.paged_attention(
                qd, kq, vq, tbl, ctx, k_scale=ks, v_scale=vs),
            DECODE_KERNELS)}
    put = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    for mix in ("smoke_mix", "engine_decode", "engine_prefill"):
        if mix != "smoke_mix":
            t, c, u = mix_tables(rng, RAGGED_MIXES[mix])
            tbl, ctx, cu = put(t), put(c), put(u)
        routes[f"ragged[{mix}/bfloat16]"] = profiled_kernels(
            torch, lambda: rpa.ragged_paged_attention(q, kp, vp, tbl, ctx,
                                                      cu), ragged_bf16)
        routes[f"ragged[{mix}/int8]"] = profiled_kernels(
            torch, lambda: rpa.ragged_paged_attention(
                q, kq, vq, tbl, ctx, cu, k_scale=ks, v_scale=vs),
            ragged_bf16)
        if mix == "smoke_mix":
            qf, kf, vf = q.float(), kp.float(), vp.float()
            routes[f"ragged[{mix}/float32]"] = profiled_kernels(
                torch, lambda: rpa.ragged_paged_attention(qf, kf, vf, tbl,
                                                          ctx, cu),
                (DECODE_KERNELS[0], RAGGED_F32_KERNEL + "<",
                 RAGGED_MERGE_KERNEL))
            del qf, kf, vf
    del q, kp, vp, qd, kq, vq, ks, vs
    g = torch.Generator(device="cuda").manual_seed(seed + 7)
    for shape, dname in (("gate_proj", "bfloat16"),
                         ("blocks_16x128", "bfloat16"),
                         ("gate_proj", "float32"),
                         ("blocks_16x128", "float32")):
        M, K, bm, bk = BCSR_SHAPES[shape]
        dt = getattr(torch, dname)
        N = BCSR_TOKENS if shape != "blocks_16x128" else 512
        w = pruned_weight(torch, g, rng, M, K, bm, bk, dt)
        x = torch.randn((K, N), generator=g, device="cuda").to(dt)
        crows, cols, vals = sparse.bcsr_from_dense(w, bm, bk)
        stems = BCSR_ROUTE_STEMS[dname]   # the M tile follows the block
        stems = (f"{stems[0]}<{bcsr_tile_rows(dname, bm)}>",)
        routes[f"bcsr_spmm[{shape}/{dname}]"] = profiled_kernels(
            torch, lambda: sparse.bcsr_matmul(crows, cols, vals, x), stems)
        del w, x, vals
    torch.cuda.empty_cache()
    for name, r in routes.items():
        log(f"route[{name}]: {json.dumps(r)}")
    report["routes"] = routes
    return routes


# -- phase 5: training --------------------------------------------------------

@contextlib.contextmanager
def plain_flash(fa):
    """Route the flash path to its plain versions on the card."""
    saved = fa.flash_fwd, fa.flash_bwd
    fa.flash_fwd, fa.flash_bwd = fa.flash_fwd_plain, fa.flash_bwd_plain
    try:
        yield
    finally:
        fa.flash_fwd, fa.flash_bwd = saved


def lcg_ids(torch, b, s, vocab):
    """LCG-scrambled token ids, as bench.py makes them (uint32 wrap)."""
    i = torch.arange(b * s, dtype=torch.int64, device="cuda")
    return (((i * 1103515245 + 12345) & 0xFFFFFFFF) % vocab).reshape(b, s)


def kernel_vs_plain_training(torch, model, crit, ids):
    """Loss and layer-0 grads through the kernels and through the plain
    versions, same weights and batch."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    layer = model.llama.layers[0]
    res = []
    for plain in (False, True):
        with plain_flash(fa) if plain else contextlib.nullcontext():
            loss = crit(model(ids), ids)
            loss.backward()
        res.append((float(loss.detach()),
                    {n: p.grad.float().clone()
                     for n, p in layer.named_parameters()}))
        model.zero_grad(set_to_none=True)
        del loss
    (lk, gk), (lp, gp) = res
    cos = {n: float(torch.nn.functional.cosine_similarity(
        gk[n].flatten(), gp[n].flatten(), dim=0)) for n in gk}
    out = dict(loss_kernels=lk, loss_plain=lp, loss_abs_diff=abs(lk - lp),
               grad_cosine_min=min(cos.values()), grad_cosine=cos)
    if not (abs(lk - lp) <= LOSS_ATOL and min(cos.values()) >= GRAD_MIN_COS):
        raise AssertionError(f"training kernels vs plain: {out}")
    return out


# the port's attention kernels by the exact stems of their symbols, checked
# before any other pattern: a templated or renamed kernel must not land in
# "matmul" or "other" (bf16: the tensor-core kernels; float32: the FMA
# engine's kernels of flash_attention.cu and flash_varlen.cu)
FLASH_FWD_STEMS = ("flash_tc_fwd<", "varlen_tc_fwd<", "::fwd_kernel<")
FLASH_BWD_STEMS = ("flash_tc_dq<", "flash_tc_dkv<", "varlen_tc_dq<",
                   "varlen_tc_dkv<", "::dq_kernel<", "::dkv_kernel<")


# the paged kernels: the ragged tile passes, and the split pass and merge
# (the gang decode's and the ragged decode rows')
PAGED_STEMS = (RAGGED_F32_KERNEL, RAGGED_TC_KERNEL) + DECODE_KERNELS


def categorize(all_kernels, busy_ms):
    """Device ms of one step by part of the step, from every activity's
    full name; ``unaccounted`` is the busy time the parts leave out (0
    when no two activities overlap)."""
    cats = {"grouped_gemm": 0.0, "int4_gemm": 0.0, "bcsr_spmm": 0.0,
            "paged_attention": 0.0, "flash_fwd": 0.0, "flash_bwd": 0.0,
            "fused_optimizer": 0.0, "matmul": 0.0, "other": 0.0}
    for name, ms in all_kernels.items():
        low = name.lower()
        if any(t in name for t in FLASH_FWD_STEMS):
            cats["flash_fwd"] += ms
        elif any(t in name for t in FLASH_BWD_STEMS):
            cats["flash_bwd"] += ms
        elif "grouped_gemm_" in low:
            cats["grouped_gemm"] += ms
        elif "int4_gemm_" in low:
            cats["int4_gemm"] += ms
        elif "bcsr_spmm_" in low:
            cats["bcsr_spmm"] += ms
        elif any(t in low for t in PAGED_STEMS):  # ragged, gang decode
            cats["paged_attention"] += ms
        elif "fused_kernel" in low:
            cats["fused_optimizer"] += ms
        elif any(t in low for t in ("gemm", "nvjet", "cutlass", "xmma",
                                    "sm90_")):
            cats["matmul"] += ms
        else:
            cats["other"] += ms
    cats["unaccounted"] = busy_ms - sum(cats.values())
    return cats


TRAIN_STEPS = 12


def bits_fingerprint(torch, tensors, chunk=1 << 26):
    """Per tensor, the sum and a position-weighted sum of its bit patterns
    (int64, in chunks): weights equal bit for bit give equal fingerprints,
    and one differing element moves both sums."""
    out = []
    for t in tensors:
        flat = t.detach().reshape(-1)
        bits = flat.view({1: torch.int8, 2: torch.int16,
                          4: torch.int32}[flat.element_size()])
        s = w = 0
        for a in range(0, bits.numel(), chunk):
            b = bits[a:a + chunk].long()
            pos = torch.arange(a, a + b.numel(), device=b.device) % 65521 + 1
            s += int(b.sum())
            w += int((b * pos).sum())
        out.append((s, w))
    return out


def train_state(model, opt):
    """The weights a run ends with: the params and the float32 masters."""
    return list(model.parameters()) + [m for m in opt._masters
                                       if m is not None]


def eager_train_run(torch, build, ids, steps):
    """The hand-written eager loop (forward, loss, backward, ``step``,
    ``clear_grad``) over ``build() -> (model, crit, opt)``: losses, the
    weights' fingerprint, tokens/s, step p50/p99 (steps 2 on), the host's
    ms a step until ``clear_grad`` returns (before the sync) and peak."""
    torch.cuda.reset_peak_memory_stats()
    model, crit, opt = build()
    losses, step_s, host_s = [], [], []
    for i in range(steps):
        ts = time.perf_counter()
        loss = crit(model(ids), ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        th = time.perf_counter()
        torch.cuda.synchronize()
        if i >= 2:
            step_s.append(time.perf_counter() - ts)
            host_s.append(th - ts)
        losses.append(float(loss.detach()))
    res = dict(losses=losses,
               fingerprint=bits_fingerprint(torch, train_state(model, opt)),
               tokens_per_s=ids.numel() / float(np.mean(step_s)),
               step_ms_p50=1e3 * float(np.percentile(step_s, 50)),
               step_ms_p99=1e3 * float(np.percentile(step_s, 99)),
               host_ms_p50=1e3 * float(np.percentile(host_s, 50)),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del model, crit, opt, loss
    gc.collect()
    torch.cuda.empty_cache()
    return res


def eager_llama_run(torch, cfg, seed, ids, steps):
    """phase_train's recipe (AdamW, lr 1e-4, global-norm clip) as the
    eager loop, from the seed's weights."""
    from paddle_tpu_torch.models import (LlamaForCausalLM,
                                         LlamaPretrainingCriterion)
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    def build():
        gen = torch.Generator(device="cuda").manual_seed(seed)
        model = LlamaForCausalLM(cfg, device="cuda", generator=gen)
        return model, LlamaPretrainingCriterion(cfg), AdamW(
            learning_rate=1e-4, weight_decay=0.01,
            parameters=model.parameters(),
            grad_clip=ClipGradByGlobalNorm(1.0))
    return eager_train_run(torch, build, ids, steps)


def phase_train(torch, seed, report):
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         LlamaPretrainingCriterion)
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.optimizer import AdamW

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              num_hidden_layers=TRAIN_LAYERS)
    ids = lcg_ids(torch, TRAIN_B, TRAIN_S, cfg.vocab_size)
    # the hand-written eager loop, twice: the baseline of the captured
    # TrainStep below, which must match it bit for bit
    eager = [eager_llama_run(torch, cfg, seed, ids, TRAIN_STEPS)
             for _ in range(2)]
    if eager[0]["losses"] != eager[1]["losses"] or \
            eager[0]["fingerprint"] != eager[1]["fingerprint"]:
        raise AssertionError("two eager Llama training runs differ: the "
                             "bitwise check has no baseline")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = LlamaForCausalLM(cfg, device="cuda", generator=gen)
    crit = LlamaPretrainingCriterion(cfg)
    n_params = sum(p.numel() for p in model.parameters())
    n_matmul = n_params - model.llama.embed_tokens.weight.numel()
    log(f"train model: Llama-3-8B width, {cfg.num_hidden_layers} layers, "
        f"{n_params / 1e9:.3f} B parameters (bf16, seed {seed}) built in "
        f"{time.perf_counter() - t0:.1f} s")
    res = {"layers": cfg.num_hidden_layers, "params": n_params,
           "batch": TRAIN_B, "seq": TRAIN_S}
    res["kernel_vs_plain"] = kernel_vs_plain_training(torch, model, crit,
                                                      ids)
    log(f"train kernels vs plain (loss, layer-0 grads): "
        f"{json.dumps(res['kernel_vs_plain'])}")

    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    train = TrainStep(model, crit, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, step_s = [], []
    for i in range(TRAIN_STEPS):   # probe, capture, then 10 timed replays
        ts = time.perf_counter()
        loss = train((ids,), (ids,))
        torch.cuda.synchronize()
        if i >= 2:
            step_s.append(time.perf_counter() - ts)
        losses.append(float(loss))
    counts = kernels.launch_counts()
    res["launches"] = counts
    fp = bits_fingerprint(torch, train_state(model, opt))
    graphs = train.graphs()
    res["capture_vs_eager"] = dict(
        losses_bitwise=losses == eager[0]["losses"],
        weights_bitwise=fp == eager[0]["fingerprint"],
        eager_runs_bitwise=True, graphs=len(graphs),
        capture_s=[g["capture_s"] for g in graphs],
        pool_bytes=[g["pool_bytes"] for g in graphs],
        eager={k: eager[0][k] for k in ("tokens_per_s", "step_ms_p50",
                                        "step_ms_p99", "peak_mem_gib")})
    log(f"train: captured TrainStep vs the eager loop: "
        f"{json.dumps(res['capture_vs_eager'])}")
    if not (res["capture_vs_eager"]["losses_bitwise"]
            and res["capture_vs_eager"]["weights_bitwise"]
            and res["capture_vs_eager"]["graphs"] == 1):
        raise AssertionError(f"captured TrainStep is not the eager loop bit "
                             f"for bit: {losses} vs {eager[0]['losses']}")
    for name in TRAINING_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"training path")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training losses not finite and falling: "
                             f"{losses}")
    tok_s = TRAIN_B * TRAIN_S / float(np.mean(step_s))
    flops_tok = 6 * n_matmul + 6 * TRAIN_S * cfg.hidden_size \
        * cfg.num_hidden_layers
    res.update(losses=losses, tokens_per_s=tok_s,
               step_ms_p50=1e3 * float(np.percentile(step_s, 50)),
               step_ms_p99=1e3 * float(np.percentile(step_s, 99)),
               step_ms=[1e3 * x for x in step_s],
               mfu=tok_s * flops_tok / BF16_FLOPS_PER_S,
               flops_per_token=flops_tok,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               optimizer_bytes_per_param=16)
    log(f"train: losses {[round(x, 4) for x in losses]}")
    log(f"train: {tok_s:.1f} tokens/s, step p50 {res['step_ms_p50']:.1f} ms "
        f"p99 {res['step_ms_p99']:.1f} ms, mfu {res['mfu']:.4f}, peak "
        f"{res['peak_mem_gib']:.2f} GiB, launches {counts}")
    prof = profile_call(torch, lambda: train((ids,), (ids,)), 1)
    if "all_kernels" in prof:
        prof["by_part_ms"] = categorize(prof.pop("all_kernels"),
                                        prof["device_busy_ms"])
    res["profile"] = prof
    log(f"train profile (one step): {json.dumps(prof)}")

    # GradScaler: a step with a poisoned grad is skipped, params bitwise
    # unchanged (a short batch: the skip does not depend on its size)
    sc = GradScaler(init_loss_scaling=2.0 ** 10)
    small = ids[:, :256]
    snap = [p.detach().clone() for p in model.parameters()]
    step_before = opt._step_count
    sc.scale(crit(model(small), small)).backward()
    next(p for p in model.parameters() if p.grad is not None) \
        .grad.view(-1)[0] = float("nan")
    sc.step(opt)
    opt.clear_grad()
    torch.cuda.synchronize()
    unchanged = all(torch.equal(a, p.detach())
                    for a, p in zip(snap, model.parameters()))
    if not (sc._found_last and unchanged and opt._step_count == step_before):
        raise AssertionError("GradScaler did not skip the poisoned step "
                             "bitwise")
    res["grad_scaler_poisoned_step"] = "skipped, params bitwise unchanged"
    log("train: GradScaler skipped the poisoned step, params bitwise "
        "unchanged")
    del snap, opt, train
    gc.collect()
    torch.cuda.empty_cache()
    res["lamb"] = train_lamb(torch, model, crit, ids, flops_tok)
    del model
    torch.cuda.empty_cache()
    report["train"] = res
    return res


LAMB_KERNELS = ("fused_optimizer_lamb_moments", "fused_optimizer_lamb_apply")


def train_lamb(torch, model, crit, ids, flops_tok):
    """The same model, after the AdamW run and with its optimizer gone,
    trained on by ``Lamb`` through ``TrainStep``: 2 warm-up and 10 timed
    steps, exactly two Lamb launches per bucket per step and no AdamW
    launch, then one profiled step."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.optimizer import Lamb

    opt = Lamb(learning_rate=1e-4, lamb_weight_decay=0.01,
               parameters=model.parameters(),
               grad_clip=ClipGradByGlobalNorm(1.0),
               exclude_from_weight_decay_fn=lambda p: p.ndim == 1)
    train = TrainStep(model, crit, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, step_s = [], []
    for i in range(12):            # 2 warm-up steps, then 10 timed
        ts = time.perf_counter()
        loss = train((ids,), (ids,))
        torch.cuda.synchronize()
        if i >= 2:
            step_s.append(time.perf_counter() - ts)
        losses.append(float(loss))
    counts = kernels.launch_counts()
    plan = next(iter(opt._fused_plans.values()))
    want = len(plan.buckets) * 12
    if counts["fused_optimizer"] != 0 or any(counts[k] != want
                                             for k in LAMB_KERNELS):
        raise AssertionError(f"Lamb launches {counts}: want {want} of each "
                             f"Lamb pass ({len(plan.buckets)} buckets x 12 "
                             f"steps) and no AdamW launch")
    for name in TRAINING_KERNELS[:3]:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"Lamb training path")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"Lamb training losses not finite and falling: "
                             f"{losses}")
    tok_s = TRAIN_B * TRAIN_S / float(np.mean(step_s))
    res = dict(losses=losses, tokens_per_s=tok_s,
               step_ms_p50=1e3 * float(np.percentile(step_s, 50)),
               step_ms_p99=1e3 * float(np.percentile(step_s, 99)),
               step_ms=[1e3 * x for x in step_s],
               mfu=tok_s * flops_tok / BF16_FLOPS_PER_S,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches=counts, buckets=len(plan.buckets),
               bucket_params=[b.total for b in plan.buckets],
               optimizer_bytes_per_param=20)
    log(f"train[lamb]: losses {[round(x, 5) for x in losses]}")
    log(f"train[lamb]: {tok_s:.1f} tokens/s, step p50 "
        f"{res['step_ms_p50']:.1f} ms p99 {res['step_ms_p99']:.1f} ms, mfu "
        f"{res['mfu']:.4f}, peak {res['peak_mem_gib']:.2f} GiB, "
        f"{len(plan.buckets)} buckets {res['bucket_params']}, launches "
        f"{counts}")
    prof = profile_call(torch, lambda: train((ids,), (ids,)), 1)
    if "all_kernels" in prof:
        prof["by_part_ms"] = categorize(prof.pop("all_kernels"),
                                        prof["device_busy_ms"])
    res["profile"] = prof
    log(f"train[lamb] profile (one step): {json.dumps(prof)}")
    del opt, train
    return res


# -- phase 5b: scheduled mixed-precision training -----------------------------

AMP_ACCUM = 2          # micro-batches per optimizer step
AMP_STEPS, AMP_WARMUP = 12, 2        # O2: 2 warm-up and 10 timed steps
O1_STEPS, O1_WARMUP = 7, 2           # O1: 2 warm-up and 5 timed steps
RESUME_LAYERS, RESUME_STEPS = 2, 3   # resume: 3 steps, save, 3 more, twice
FLASH_KERNELS = TRAINING_KERNELS[:3]
# the six per-parameter rules on the card vs on the CPU, over a gate_proj-
# shaped and a norm-shaped parameter: the same torch ops on both, each
# rounded once, so bit for bit is expected where the ops round alike. The
# CPU's torch.sqrt does not (one ulp off the correctly rounded value on
# ~0.7% of float32 inputs, sqrt_rounding() counts it), so Adadelta,
# RMSProp and Adagrad may differ: the float32 values the rules compute
# (float32 params, masters, slots) within 1e-6 of each tensor's largest
# magnitude. A bf16 param must equal its own master's rounding on each
# device; across devices it may then differ by a bf16 ulp wherever the
# masters differ at all (reported, no limit beyond the masters')
PER_PARAM_SHAPES = ((4096, 14336), (4096,))
PER_PARAM_RULES = {
    "Adamax": dict(learning_rate=1e-3, weight_decay=0.01),
    "Adadelta": dict(learning_rate=1.0, rho=0.95, weight_decay=0.01),
    "ASGD": dict(learning_rate=1e-3, batch_num=3, weight_decay=0.01),
    "Rprop": dict(learning_rate=1e-3),
    "Adagrad": dict(learning_rate=1e-2, weight_decay=0.01,
                    initial_accumulator_value=0.1),
    "RMSProp": dict(learning_rate=1e-3, momentum=0.9, centered=True,
                    weight_decay=0.01),
}
PER_PARAM_REL_TOL = 1e-6


def amp_schedule(lr):
    """The recipe's schedule: 4 warm-up steps to 1e-4, then cosine over
    10 (``lr`` is the port's ``optimizer.lr`` module)."""
    return lr.LinearWarmup(lr.CosineAnnealingDecay(1e-4, T_max=10),
                           warmup_steps=4, start_lr=0.0, end_lr=1e-4)


def no_norm_decay(name: str) -> bool:
    """``apply_decay_param_fun``: no weight decay on the norm weights."""
    return "norm" not in name


def lr_mismatches(seen, want):
    """Optimizer steps whose lr, as each bucket's kernel read it
    (``seen[k]``, one value per bucket), is not the scheduler's value for
    that step in float32 (``want[k]``): ``[(step, seen, want)]``."""
    bad = [(k, s, float(np.float32(w)))
           for k, (s, w) in enumerate(zip(seen, want))
           if not s or any(x != float(np.float32(w)) for x in s)]
    if len(seen) != len(want):
        bad.append(("steps", len(seen), len(want)))
    return bad


def launch_pattern_errors(per_call, accum, buckets, layers):
    """Calls of ``TrainStep(grad_accum=accum)`` whose launches (a dict of
    count deltas per call) break the pattern: each call one launch of
    each flash kernel per layer, and the fused AdamW kernel once per
    bucket on the last call of each window and never on a micro step."""
    errs = []
    for i, c in enumerate(per_call):
        want = buckets if (i + 1) % accum == 0 else 0
        if c.get("fused_optimizer", 0) != want:
            errs.append((i, "fused_optimizer", c.get("fused_optimizer", 0),
                         want))
        errs += [(i, k, c.get(k, 0), layers) for k in FLASH_KERNELS
                 if c.get(k, 0) != layers]
    return errs


def amp_model(torch, cfg, seed, level):
    """The recipe over ``cfg``: the model built in float32 from the seed,
    ``AdamW`` over the schedule with the global-norm clip (given the
    named parameters: the decay rule reads the names), then
    ``amp.decorate`` to bf16 under O2, and ``TrainStep(grad_accum=2,
    amp_level=level)``."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (LlamaForCausalLM,
                                         LlamaPretrainingCriterion)
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW, lr

    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = LlamaForCausalLM(dataclasses.replace(cfg, dtype="float32"),
                             device="cuda", generator=gen)
    opt = AdamW(learning_rate=amp_schedule(lr), weight_decay=0.01,
                parameters=model.named_parameters(),
                apply_decay_param_fun=no_norm_decay,
                grad_clip=ClipGradByGlobalNorm(1.0))
    if level == "O2":
        amp.decorate(model, opt, level="O2", dtype="bfloat16")
    train = TrainStep(model, LlamaPretrainingCriterion(cfg), opt,
                      grad_accum=AMP_ACCUM, amp_level=level)
    return model, opt, train


def amp_steps(torch, train, opt, mbs, steps, warmup=0):
    """``steps`` optimizer steps of ``len(mbs)`` calls each, the
    scheduler stepped after each: every call's loss and launches, each
    timed step's seconds, and the lr each bucket's kernel read per step
    (copies of the device vectors the launches read, taken after each
    step and read after the run) beside the scheduler's value."""
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.optimizer import fused_counters

    losses, per_call, step_s, svecs, want = [], [], [], [], []
    fallbacks = fused_counters["fallbacks"]
    for k in range(steps):
        ts = time.perf_counter()
        want.append(opt.get_lr())
        for ids in mbs:
            before = kernels.launch_counts()
            losses.append(train((ids,), (ids,)))
            after = kernels.launch_counts()
            per_call.append({n: after[n] - before[n] for n in after
                             if after[n] != before[n]})
        torch.cuda.synchronize()
        if k >= warmup:
            step_s.append(time.perf_counter() - ts)
        # a copy now: under replay the graph rewrites the same vectors
        svecs.append([b.svec.clone() for b in
                      next(iter(opt._fused_plans.values())).buckets])
        opt._lr.step()
    if fused_counters["fallbacks"] != fallbacks:
        raise AssertionError(f"the fused optimizer fell back "
                             f"{fused_counters['fallbacks'] - fallbacks} "
                             f"times: {opt._fused_last_reason}")
    return dict(losses=[float(x) for x in losses], per_call=per_call,
                step_s=step_s, want=want,
                seen=[[float(v[0]) for v in vs] for vs in svecs])


def check_amp_run(run, opt, layers, label):
    plan = next(iter(opt._fused_plans.values()))
    errs = launch_pattern_errors(run["per_call"], AMP_ACCUM,
                                 len(plan.buckets), layers)
    if errs:
        raise AssertionError(f"{label}: launches off the pattern: "
                             f"{errs[:6]}")
    bad = lr_mismatches(run["seen"], run["want"])
    if bad:
        raise AssertionError(f"{label}: the kernel read another lr than "
                             f"the scheduler's: {bad[:6]}")
    lr_scalars = [k for k in opt._live if k[0] == "lr"]
    if len(lr_scalars) != 1 or len(set(run["want"])) < 2:
        raise AssertionError(f"{label}: {len(lr_scalars)} lr device "
                             f"scalars over {len(set(run['want']))} lr "
                             f"values, want one scalar")
    per_step = [float(np.mean(run["losses"][i:i + AMP_ACCUM]))
                for i in range(0, len(run["losses"]), AMP_ACCUM)]
    if not all(np.isfinite(run["losses"])) or \
            not per_step[-1] < per_step[0]:
        raise AssertionError(f"{label}: losses not finite and falling: "
                             f"{run['losses']}")
    return plan


def amp_metrics(torch, run, flops_tok, tokens):
    tok_s = tokens / float(np.mean(run["step_s"]))
    return dict(tokens_per_s=tok_s,
                step_ms_p50=1e3 * float(np.percentile(run["step_s"], 50)),
                step_ms_p99=1e3 * float(np.percentile(run["step_s"], 99)),
                step_ms=[1e3 * x for x in run["step_s"]],
                mfu=tok_s * flops_tok / BF16_FLOPS_PER_S,
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


@contextlib.contextmanager
def flash_dtypes(fa, seen):
    """Record the q dtype each flash kernel wrapper was called with."""
    saved = fa.flash_fwd_kernel, fa.flash_dq_kernel, fa.flash_dkv_kernel

    def tap(name, fn):
        def wrapped(q, *args):
            seen.setdefault(name, set()).add(str(q.dtype))
            return fn(q, *args)
        return wrapped

    fa.flash_fwd_kernel = tap("fwd", saved[0])
    fa.flash_dq_kernel = tap("dq", saved[1])
    fa.flash_dkv_kernel = tap("dkv", saved[2])
    try:
        yield seen
    finally:
        fa.flash_fwd_kernel, fa.flash_dq_kernel, fa.flash_dkv_kernel = saved


def train_flops(model, cfg) -> int:
    """Training FLOPs per token as bench.py counts them: 6 per matmul
    parameter (the embedding's gather is none) and the attention's
    6·s·hidden per layer."""
    n_matmul = sum(p.numel() for p in model.parameters()) \
        - model.llama.embed_tokens.weight.numel()
    return 6 * n_matmul + 6 * TRAIN_S * cfg.hidden_size \
        * model.config.num_hidden_layers


def amp_o1(torch, cfg, seed, mbs):
    """The same recipe over float32 weights under O1: the flash kernels
    must see bf16 q/k/v (the white list cast them) and the fused optimizer
    float32 buckets. At the full depth: running out of memory fails."""
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    res = {}
    layers = cfg.num_hidden_layers
    torch.cuda.reset_peak_memory_stats()
    model, opt, train = amp_model(torch, cfg, seed, "O1")
    kernels.reset_launch_counts()
    with flash_dtypes(fa, {}) as seen:
        run = amp_steps(torch, train, opt, mbs, O1_STEPS, O1_WARMUP)
    plan = check_amp_run(run, opt, layers, "train_amp[O1]")
    if any(s != {"torch.bfloat16"} for s in seen.values()) or \
            len(seen) != 3:
        raise AssertionError(f"O1: the flash kernels saw {seen}, not bf16 "
                             f"only")
    cdt = {(b.cdtype, b.gdtype, b.low) for b in plan.buckets}
    if cdt != {("float32", "float32", None)}:
        raise AssertionError(f"O1: optimizer buckets {cdt}, want float32")
    n_params = sum(p.numel() for p in model.parameters())
    res.update(layers=layers, params=n_params,
               flash_q_dtypes={k: sorted(v) for k, v in seen.items()},
               buckets=[(b.cdtype, b.gdtype, b.total) for b in plan.buckets],
               losses=run["losses"], lr=run["want"],
               launches=kernels.launch_counts(),
               **amp_metrics(torch, run, train_flops(model, cfg),
                             AMP_ACCUM * TRAIN_B * TRAIN_S))
    del model, opt, train
    gc.collect()
    torch.cuda.empty_cache()
    return res


def amp_resume(torch, cfg, seed, mbs):
    """At 2 full-width layers: 3 steps, ``state_dict`` and the weights
    taken, 3 more steps; then a new model and optimizer loaded with them
    take the same 3 steps. Losses and final weights must be equal bit for
    bit."""
    cfg = dataclasses.replace(cfg, num_hidden_layers=RESUME_LAYERS)
    model, opt, train = amp_model(torch, cfg, seed, "O2")
    amp_steps(torch, train, opt, mbs, RESUME_STEPS)
    sd = opt.state_dict()
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    first = amp_steps(torch, train, opt, mbs, RESUME_STEPS)
    final = [p.detach().clone() for p in model.parameters()]
    n_params = sum(p.numel() for p in model.parameters())
    del model, opt, train
    gc.collect()
    torch.cuda.empty_cache()
    model, opt, train = amp_model(torch, cfg, seed + 1, "O2")
    model.load_state_dict(weights)
    opt.set_state_dict(sd)
    second = amp_steps(torch, train, opt, mbs, RESUME_STEPS)
    same_w = all(torch.equal(a, p.detach())
                 for a, p in zip(final, model.parameters()))
    res = dict(layers=RESUME_LAYERS, params=n_params,
               losses_first=first["losses"],
               losses_resumed=second["losses"],
               lr_first=first["want"], lr_resumed=second["want"],
               losses_bitwise=first["losses"] == second["losses"],
               weights_bitwise=same_w)
    del model, opt, train, sd, weights, final
    torch.cuda.empty_cache()
    if not (res["losses_bitwise"] and same_w
            and first["want"] == second["want"]):
        raise AssertionError(f"resume not bit for bit: {res}")
    return res


def per_param_on_card(torch, seed):
    """Each per-parameter rule, 3 steps over PER_PARAM_SHAPES in float32
    and as bf16 with float32 masters, on the card and on the CPU from the
    same numpy inputs: the largest difference of the updated values and
    of every slot, relative to the CPU value's largest magnitude."""
    from paddle_tpu_torch import optimizer as O

    rng = np.random.default_rng(seed)
    init = [rng.standard_normal(s, dtype=np.float32) * 0.02
            for s in PER_PARAM_SHAPES]
    grads = [[rng.standard_normal(s, dtype=np.float32) * 1e-3
              for s in PER_PARAM_SHAPES] for _ in range(3)]
    res = {}
    for name, kw in PER_PARAM_RULES.items():
        for dt in (torch.float32, torch.bfloat16):
            outs = []
            for dev in ("cuda", "cpu"):
                ps = [torch.nn.Parameter(torch.from_numpy(x).to(
                    dev, dt, copy=True)) for x in init]
                opt = getattr(O, name)(parameters=ps, **kw)
                for gs in grads:
                    for p, g in zip(ps, gs):
                        p.grad = torch.from_numpy(g).to(dev, dt, copy=True)
                    opt.step()
                    opt.clear_grad()
                vals, low = {}, set()
                for i, p in enumerate(ps):
                    m = opt._masters[i]
                    if m is not None:
                        if not torch.equal(p.detach(), m.to(p.dtype)):
                            raise AssertionError(
                                f"{name} on {dev}: a bf16 param is not "
                                f"its master's rounding")
                        vals[f"master{i}"] = m
                        low.add(f"param{i}")
                    vals[f"param{i}"] = p.detach()
                    vals.update({f"{k}{i}": v
                                 for k, v in opt._states[i].items()})
                outs.append({k: v.float().cpu() for k, v in vals.items()})
                del ps, opt, vals
            card, cpu = outs

            def rel(k):
                return float((card[k] - cpu[k]).abs().max()) \
                    / max(float(cpu[k].abs().max()), 1e-30)

            err = max(rel(k) for k in cpu if k not in low)
            label = f"{name}[{str(dt).removeprefix('torch.')}]"
            res[label] = dict(
                max_rel_err=err,
                bf16_param_rel_err=max([rel(k) for k in low] or [0.0]),
                bitwise=all(torch.equal(card[k], cpu[k]) for k in cpu),
                slots=sorted(cpu))
            if not err <= PER_PARAM_REL_TOL:
                raise AssertionError(f"{label} on the card vs the CPU: "
                                     f"{res[label]}")
    res["sqrt_rounding"] = sqrt_rounding(torch, rng)
    return res


def sqrt_rounding(torch, rng, n=1 << 22):
    """How many float32 inputs (uniform over [1e-7, 1.1e-6], the rules'
    second-moment range) each device's ``torch.sqrt`` rounds other than
    the correctly rounded value (numpy's float32 sqrt)."""
    x = (rng.random(n, dtype=np.float32) * 1e-6 + 1e-7).astype(np.float32)
    want = np.sqrt(x)
    t = torch.from_numpy(x)
    return {"inputs": n, "card_off": int((torch.sqrt(t.cuda()).cpu().numpy()
                                          != want).sum()),
            "cpu_off": int((torch.sqrt(t).numpy() != want).sum())}


def phase_train_amp(torch, seed, report):
    """Scheduled mixed-precision training at Llama-3-8B width (8 layers):
    O2 with grad_accum 2, then O1, the resume check at 2 layers, and the
    six per-parameter optimizers on the card against the CPU."""
    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.ops import kernels

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              num_hidden_layers=TRAIN_LAYERS)
    ids = lcg_ids(torch, AMP_ACCUM * TRAIN_B, TRAIN_S, cfg.vocab_size)
    mbs = [ids[i * TRAIN_B:(i + 1) * TRAIN_B] for i in range(AMP_ACCUM)]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, opt, train = amp_model(torch, cfg, seed, "O2")
    n_params = sum(p.numel() for p in model.parameters())
    flops_tok = train_flops(model, cfg)
    tokens = AMP_ACCUM * TRAIN_B * TRAIN_S
    log(f"train_amp model: Llama-3-8B width, {cfg.num_hidden_layers} "
        f"layers, {n_params / 1e9:.3f} B parameters built in float32 and "
        f"decorated to bf16 (O2) in {time.perf_counter() - t0:.1f} s; "
        f"AdamW over LinearWarmup(4) + cosine(10), grad_accum "
        f"{AMP_ACCUM} x {TRAIN_B} x {TRAIN_S}")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    run = amp_steps(torch, train, opt, mbs, AMP_STEPS, AMP_WARMUP)
    counts = kernels.launch_counts()
    plan = check_amp_run(run, opt, cfg.num_hidden_layers, "train_amp[O2]")
    res = {"layers": cfg.num_hidden_layers, "params": n_params,
           "micro_batch": [TRAIN_B, TRAIN_S], "grad_accum": AMP_ACCUM,
           "tokens_per_step": tokens, "flops_per_token": flops_tok,
           "losses": run["losses"], "lr": run["want"],
           "lr_read": run["seen"], "launches": counts,
           "buckets": [(b.cdtype, b.gdtype, b.low, b.wd, b.total)
                       for b in plan.buckets]}
    res.update(amp_metrics(torch, run, flops_tok, tokens))
    log(f"train_amp[O2]: losses {[round(x, 4) for x in run['losses']]}")
    log(f"train_amp[O2]: lr read by the kernel each step {run['seen']}")
    log(f"train_amp[O2]: {res['tokens_per_s']:.1f} tokens/s ({tokens} a "
        f"step), step p50 {res['step_ms_p50']:.1f} ms p99 "
        f"{res['step_ms_p99']:.1f} ms, mfu {res['mfu']:.4f}, peak "
        f"{res['peak_mem_gib']:.2f} GiB, {len(plan.buckets)} buckets, "
        f"launches {counts}")
    prof = profile_call(torch, lambda: [train((m,), (m,)) for m in mbs], 1)
    if "all_kernels" in prof:
        prof["by_part_ms"] = categorize(prof.pop("all_kernels"),
                                        prof["device_busy_ms"])
    res["profile"] = prof
    log(f"train_amp[O2] profile (one optimizer step, {AMP_ACCUM} micro "
        f"steps): {json.dumps(prof)}")
    del model, opt, train
    gc.collect()
    torch.cuda.empty_cache()

    res["o1"] = amp_o1(torch, cfg, seed, mbs)
    o1 = res["o1"]
    log(f"train_amp[O1]: {o1['layers']} layers over float32 weights, "
        f"flash q dtypes {o1['flash_q_dtypes']}, buckets {o1['buckets']}, "
        f"losses {[round(x, 4) for x in o1['losses']]}, "
        f"{o1['tokens_per_s']:.1f} tokens/s, step p50 "
        f"{o1['step_ms_p50']:.1f} ms p99 {o1['step_ms_p99']:.1f} ms, mfu "
        f"{o1['mfu']:.4f}, peak {o1['peak_mem_gib']:.2f} GiB")
    res["resume"] = amp_resume(torch, cfg, seed, mbs)
    log(f"train_amp[resume]: {RESUME_LAYERS} layers "
        f"({res['resume']['params'] / 1e9:.3f} B), losses bit for bit "
        f"{res['resume']['losses_bitwise']}, weights bit for bit "
        f"{res['resume']['weights_bitwise']}: "
        f"{res['resume']['losses_resumed']}")
    res["per_param"] = per_param_on_card(torch, seed)
    log(f"train_amp[per-param rules, card vs CPU]: "
        f"{json.dumps(res['per_param'])}")
    report["train_amp"] = res
    return res


# -- phase 5b: capture edges and Model.fit in K-step blocks --------------------

FIT_LAYERS, FIT_BATCH, FIT_SEQ, FIT_SAMPLES, FIT_K = 2, 2, 512, 38, 4
FIT_EPOCHS = 2
FIT_WORKERS = 2          # the DataLoader's worker processes in the 4th fit
WORKER_TIMEOUT_S = 300   # a worker's batch may take this long, then raise


def capture_edges(torch):
    """On a small linear layer: a GradScaler step with a planted inf is
    skipped on the device under replay (weights bitwise unchanged) and
    ``consume_anomaly()`` brings the step count back; a step that calls
    ``.item()`` falls back as "trace failed" and the process keeps
    drawing random numbers after the failed capture."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import jit_step
    from paddle_tpu_torch.optimizer import SGD

    gen = torch.Generator(device="cuda").manual_seed(0)
    net = torch.nn.Linear(256, 256, device="cuda")
    opt = SGD(learning_rate=0.1, parameters=net.parameters())
    sc = amp.GradScaler(init_loss_scaling=2.0 ** 10)

    def scaled_step(x):
        loss = net(x).square().mean()
        sc.scale(loss).backward()
        sc.step(opt)
        opt.clear_grad()
        return loss.detach()

    step = jit_step(scaled_step)
    x = torch.randn(64, 256, device="cuda", generator=gen)
    for _ in range(3):                   # probe, capture, replay
        step(x)
    w0 = [p.detach().clone() for p in net.parameters()]
    n0 = opt._step_count
    step(x * float("inf"))               # a replay whose grads are inf
    torch.cuda.synchronize()
    unchanged = all(torch.equal(a, p.detach())
                    for a, p in zip(w0, net.parameters()))
    host_ahead = opt._step_count
    skipped = opt.consume_anomaly()
    reconciled = opt._step_count
    step(x)
    moved = not all(torch.equal(a, p.detach())
                    for a, p in zip(w0, net.parameters()))
    scaler = dict(weights_unchanged=unchanged, anomaly=skipped,
                  steps_before=n0, host_count_before_consume=host_ahead,
                  host_count_after_consume=reconciled,
                  bad_steps=sc.state_dict()["bad"], next_step_moved=moved)
    if not (unchanged and skipped and skipped[0] and host_ahead == n0 + 1
            and reconciled == n0 and opt._step_count == n0 + 1 and moved):
        raise AssertionError(f"GradScaler under replay: {scaler}")

    net2 = torch.nn.Linear(64, 64, device="cuda")
    opt2 = SGD(learning_rate=0.1, parameters=net2.parameters())

    def synced_step(x):
        loss = net2(x).square().mean()
        loss.backward()
        opt2.step()
        opt2.clear_grad()
        if loss.item() > 1e30:           # a host sync: no graph can hold it
            raise AssertionError("unreachable")
        return loss.detach()

    step2 = jit_step(synced_step)
    x2 = torch.randn(8, 64, device="cuda", generator=gen)
    pools0 = graph_pools(torch)
    for _ in range(3):
        step2(x2)
    reason = step2.last_fallback or ""
    draw = float(torch.randn(4, device="cuda").abs().sum())
    free_card(torch)
    pools1 = graph_pools(torch)
    # the scaled step's graph holds one pool; the failed capture's pool
    # must be gone once the cache is returned
    item = dict(fallback=reason[:160], draws_after=bool(np.isfinite(draw)),
                graph_pools_before=len(pools0), graph_pools_after=len(pools1))
    if not reason.startswith("trace failed") or not pools0 \
            or pools1 != pools0:
        raise AssertionError(f".item() in a captured step: {item}")
    return dict(grad_scaler=scaler, item=item,
                alternating_shapes=alternating_shapes(torch))


def graph_pools(torch):
    """The private pools (CUDA graphs' memory) that hold segments."""
    return {tuple(s["segment_pool_id"]) for s in torch.cuda.memory_snapshot()
            if tuple(s.get("segment_pool_id") or (0, 0)) != (0, 0)}


def alternating_shapes(torch):
    """``jit_step`` over an MLP with the fused AdamW, two batch shapes in
    turns: each shape's eager probe rebuilds the optimizer buckets' chunk
    tables between the other shape's replays (junk allocations then reuse
    any block freed), and losses and weights must equal the eager loop's
    bit for bit."""
    from paddle_tpu_torch.jit import capture_counters, jit_step
    from paddle_tpu_torch.optimizer import AdamW

    def run(captured):
        gen = torch.Generator(device="cuda").manual_seed(1)
        net = torch.nn.Sequential(torch.nn.Linear(512, 1024), torch.nn.GELU(),
                                  torch.nn.Linear(1024, 512)).cuda()
        with torch.no_grad():
            for p in net.parameters():
                p.copy_(torch.randn(p.shape, device="cuda", generator=gen)
                        * 0.02)
        opt = AdamW(learning_rate=1e-3, weight_decay=0.01,
                    parameters=net.parameters())

        def step(x):
            loss = net(x).square().mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss.detach()

        fn = jit_step(step) if captured else step
        losses = []
        for i in range(16):
            n = (64, 96)[(i // 3) % 2]
            x = torch.randn(n, 512, device="cuda", generator=gen)
            losses.append(float(fn(x)))
            junk = torch.full((1 << 20,), -1, dtype=torch.int64,
                              device="cuda")
            del junk
        return losses, [p.detach().clone() for p in net.parameters()]

    le, we = run(False)
    before = dict(capture_counters)
    lc, wc = run(True)
    moved = {k: capture_counters[k] - before[k]
             for k in ("probes", "captures", "replays", "fallbacks")}
    res = dict(losses_bitwise=le == lc,
               weights_bitwise=all(torch.equal(a, b)
                                   for a, b in zip(we, wc)), **moved)
    if not (res["losses_bitwise"] and res["weights_bitwise"]
            and moved["replays"] >= 8 and not moved["fallbacks"]):
        raise AssertionError(f"jit_step over alternating shapes: {res}")
    return res


def free_card(torch):
    """Collect cycles, then return the cache to the card: a finished
    run's graph pools are released only once their owners are gone."""
    gc.collect()
    torch.cuda.empty_cache()


def fit_run(torch, cfg, seed, data, k, capture=True, workers=0):
    """``Model.fit`` over a shuffled DataLoader for FIT_EPOCHS epochs
    (the lr halved after each by fit's default LRScheduler callback) with
    ``FLAGS_multi_step`` = k, or with capture off, over ``workers``
    persistent worker processes (0: the prefetch thread): per-step
    losses, wall, peak, the graphs' pool bytes and the workers' PIDs."""
    from paddle_tpu_torch import flags, io
    from paddle_tpu_torch.hapi import Model, callbacks
    from paddle_tpu_torch.jit import capture_counters
    from paddle_tpu_torch.jit.multi_step import multi_counters
    from paddle_tpu_torch.models import (LlamaForCausalLM,
                                         LlamaPretrainingCriterion)
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW, lr

    losses, pids = [], set()

    class Record(callbacks.ProgBarLogger):     # a read-only observer
        def on_train_batch_end(self, step, logs=None):
            losses.append(logs["loss"])
            pids.update(loader.worker_pids())

    flags.set_flags({"multi_step": k, "step_capture": capture})
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = LlamaForCausalLM(cfg, device="cuda", generator=gen)
    opt = AdamW(learning_rate=lr.StepDecay(1e-4, step_size=1, gamma=0.5),
                weight_decay=0.01,
                parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    m = Model(model)
    m.prepare(opt, LlamaPretrainingCriterion(cfg))
    np.random.seed(seed)
    loader = io.DataLoader(io.TensorDataset([data, data]), places="cuda",
                           batch_size=FIT_BATCH, shuffle=True,
                           num_workers=workers,
                           persistent_workers=bool(workers),
                           timeout=WORKER_TIMEOUT_S if workers else 0)
    before = dict(capture_counters), dict(multi_counters)
    t0 = time.perf_counter()
    try:
        m.fit(loader, epochs=FIT_EPOCHS, verbose=0,
              callbacks=[Record(verbose=0)])
    finally:
        flags.set_flags({"multi_step": 0, "step_capture": True})
        if loader._pool is not None:
            loader._pool.shutdown()
    torch.cuda.synchronize()
    graphs = [g for s in (m._captured_step, m._multi_step) if s is not None
              for g in s.graphs()]
    res = dict(k=k, capture=capture, workers=workers, losses=losses,
               worker_pids=sorted(pids), wall_s=time.perf_counter() - t0,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               graphs=graphs,
               capture_counters={c: capture_counters[c] - before[0][c]
                                 for c in capture_counters},
               multi_counters={c: multi_counters[c] - before[1][c]
                               for c in multi_counters})
    del m, model, opt, loader
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_capture(torch, seed, report):
    """The capture edges, then Model.fit over a DataLoader at Llama-3-8B
    width cut to FIT_LAYERS layers: single-step capture, and K-step blocks
    (FLAGS_multi_step = FIT_K) that must give the same losses."""
    from paddle_tpu_torch.models import LlamaConfig

    res = capture_edges(torch)
    log(f"capture edges: {json.dumps(res)}")
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              num_hidden_layers=FIT_LAYERS)
    data = np.random.RandomState(seed).randint(
        0, cfg.vocab_size, size=(FIT_SAMPLES, FIT_SEQ)).astype(np.int64)
    eager = fit_run(torch, cfg, seed, data, 0, capture=False)
    free_card(torch)
    single = fit_run(torch, cfg, seed, data, 0)
    free_card(torch)
    multi = fit_run(torch, cfg, seed, data, FIT_K)
    free_card(torch)
    workers = fit_run(torch, cfg, seed, data, 0, workers=FIT_WORKERS)
    free_card(torch)
    steps = FIT_SAMPLES // FIT_BATCH
    blocks, tail = divmod(steps, FIT_K)
    res["fit"] = dict(layers=FIT_LAYERS, batch=FIT_BATCH, seq=FIT_SEQ,
                      epochs=FIT_EPOCHS, steps=steps * FIT_EPOCHS,
                      eager=eager, single=single, multi=multi,
                      workers=workers, parent_pid=os.getpid(),
                      losses_equal=eager["losses"] == single["losses"]
                      == multi["losses"],
                      workers_losses_equal=workers["losses"]
                      == single["losses"])
    log(f"capture fit: {json.dumps(res['fit'])}")
    if not res["fit"]["workers_losses_equal"] \
            or len(workers["worker_pids"]) != FIT_WORKERS \
            or os.getpid() in workers["worker_pids"] \
            or workers["capture_counters"]["fallbacks"]:
        raise AssertionError(f"Model.fit over {FIT_WORKERS} worker "
                             f"processes vs the prefetch thread: "
                             f"{res['fit']['workers']}")
    mc = multi["multi_counters"]
    # epoch 1: the first block probes (eager), the second warms up and
    # captures, the rest replay; epoch 2's blocks all replay (at the
    # halved lr, from the lr stack); the tails take single-step capture
    replays = FIT_EPOCHS * blocks - 2
    if not res["fit"]["losses_equal"] \
            or len(multi["losses"]) != steps * FIT_EPOCHS \
            or mc["blocks"] != FIT_EPOCHS * blocks - 1 \
            or mc["replays"] != replays or replays < 4 \
            or mc["tail_steps"] != FIT_EPOCHS * tail \
            or multi["capture_counters"]["fallbacks"] \
            or single["capture_counters"]["fallbacks"]:
        raise AssertionError(f"Model.fit multi-step vs single-step vs "
                             f"eager: {res['fit']}")
    report["capture_edges"] = res
    return res


# -- phase 5d: the training loop's rest and the layer surface ------------------

# the three builds of train_layers, each at TRAIN_LAYERS layers
LAYER_BUILDS = {
    "list_selective": dict(recompute="selective"),
    "list_full": dict(recompute=True),
    "scan_selective": dict(use_scan_layers=True, recompute="selective")}
LAYER_WARM, LAYER_TIMED = 2, 5     # probe + capture, then timed replays
LAYER_CHECK_STEPS = 3              # losses held to the list build's
# scan vs list after the first clip: the stacked global norm sums its
# per-tensor norms in another order, an ulp of the clip coefficient that a
# bf16 rounding can turn into an ulp of a weight; the bf16 loss limit of
# tests/test_torch_layer_stack.py (and test_torch_llama_training.py)
SCAN_LOSS_ATOL = 2e-3


class ImageRows:
    """A seeded table of 3 x 32 x 32 float32 images and int64 labels of 10
    classes. Module level: the DataLoader's forkserver workers import it
    (this script's ``__main__`` as ``__mp_main__``)."""

    def __init__(self, n, seed):
        rng = np.random.RandomState(seed)
        self.x = rng.randn(n, 3, 32, 32).astype(np.float32)
        self.y = rng.randint(0, 10, n).astype(np.int64)

    def __getitem__(self, i):
        return self.x[i], self.y[i]

    def __len__(self):
        return len(self.x)


def train_layers_build(torch, cfg, seed, ids, name, kw):
    """One build of ``train_layers``: from the seed's weights, the
    captured TrainStep for LAYER_WARM + LAYER_TIMED steps (counts reset
    just before), then everything dropped and the cache returned."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (LlamaForCausalLM,
                                         LlamaPretrainingCriterion)
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.optimizer import AdamW

    free_card(torch)
    reserved0 = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = LlamaForCausalLM(dataclasses.replace(cfg, **kw), device="cuda",
                             generator=gen)
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    train = TrainStep(model, LlamaPretrainingCriterion(cfg), opt)
    kernels.reset_launch_counts()
    losses, step_s = [], []
    steps = LAYER_WARM + LAYER_TIMED
    for i in range(steps):
        ts = time.perf_counter()
        loss = train((ids,), (ids,))
        torch.cuda.synchronize()
        if i >= LAYER_WARM:
            step_s.append(time.perf_counter() - ts)
        losses.append(float(loss))
    counts = kernels.launch_counts()
    graphs = train.graphs()
    res = dict(build=name, config=kw,
               reserved_at_start_gib=reserved0 / 2 ** 30, losses=losses,
               tokens_per_s=ids.numel() / float(np.mean(step_s)),
               step_ms_p50=1e3 * float(np.percentile(step_s, 50)),
               step_ms_p99=1e3 * float(np.percentile(step_s, 99)),
               step_ms=[1e3 * x for x in step_s],
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               graphs=len(graphs),
               pool_bytes=[g["pool_bytes"] for g in graphs],
               launches={k: counts[k] for k in TRAINING_KERNELS},
               launches_per_step={k: counts[k] / steps
                                  for k in TRAINING_KERNELS})
    del train, opt, model, loss
    free_card(torch)
    return res


def phase_train_layers(torch, seed, report, base):
    """``train_layers``: the 8-layer Llama-3-8B-width training of
    phase_train built three more ways (list layers with selective and with
    full recompute, scan layers with selective recompute); ``base`` is
    phase_train's no-recompute list result of this run."""
    from paddle_tpu_torch.models import LlamaConfig

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              num_hidden_layers=TRAIN_LAYERS)
    ids = lcg_ids(torch, TRAIN_B, TRAIN_S, cfg.vocab_size)
    want = base["losses"][:LAYER_CHECK_STEPS]
    base_per_step = {k: base["launches"][k] / TRAIN_STEPS
                     for k in TRAINING_KERNELS}
    res = {"baseline": {k: base[k] for k in (
        "tokens_per_s", "step_ms_p50", "step_ms_p99", "peak_mem_gib")}}
    res["baseline"].update(
        pool_bytes=base["capture_vs_eager"]["pool_bytes"],
        launches_per_step=base_per_step)
    errors = []
    for name, kw in LAYER_BUILDS.items():
        r = train_layers_build(torch, cfg, seed, ids, name, kw)
        got = r["losses"][:LAYER_CHECK_STEPS]
        if name.startswith("scan"):
            ok = got[0] == want[0] and all(
                abs(a - b) <= SCAN_LOSS_ATOL for a, b in zip(got, want))
        else:
            ok = got == want
        r["losses_vs_list"] = dict(
            bitwise=got == want, step1_bitwise=got[0] == want[0],
            max_abs_diff=max(abs(a - b) for a, b in zip(got, want)))
        per = r["launches_per_step"]
        expect = dict(base_per_step,
                      flash_attention_fwd=2 * base_per_step[
                          "flash_attention_fwd"])
        if not ok:
            errors.append(f"{name}: losses {got} vs the list build's {want}")
        if per != expect:
            errors.append(f"{name}: launches per step {per}, want {expect}")
        if r["graphs"] != 1 or not all(np.isfinite(r["losses"])):
            errors.append(f"{name}: {r['graphs']} graphs, losses "
                          f"{r['losses']}")
        log(f"train_layers {name}: {r['tokens_per_s']:.1f} tokens/s, step "
            f"p50 {r['step_ms_p50']:.1f} ms p99 {r['step_ms_p99']:.1f} ms, "
            f"peak {r['peak_mem_gib']:.2f} GiB, pool "
            f"{[b / 2 ** 30 for b in r['pool_bytes']]} GiB, reserved at "
            f"start {r['reserved_at_start_gib']:.2f} GiB, launches per step "
            f"{per}, losses vs list {r['losses_vs_list']} (no recompute, "
            f"list: {res['baseline']['tokens_per_s']:.1f} tokens/s, p50 "
            f"{res['baseline']['step_ms_p50']:.1f} ms, peak "
            f"{res['baseline']['peak_mem_gib']:.2f} GiB)")
        res[name] = r
    report["train_layers"] = res
    if errors:
        raise AssertionError("train_layers: " + "; ".join(errors))
    return res


def asgd_capture(torch):
    """ASGD (batch_num 3) through a captured TrainStep on the card: six
    steps with a poisoned batch at step 3 under the anomaly sentinel, bit
    for bit the eager steps (``FLAGS_step_capture=0``)."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.jit import TrainStep, capture_counters
    from paddle_tpu_torch.optimizer import ASGD

    def run(capture):
        flags.set_flags({"step_capture": capture, "anomaly_sentinel": True})
        tnn.initializer.seed(0)
        net = tnn.Sequential(tnn.Linear(512, 1024), tnn.GELU(),
                             tnn.Linear(1024, 512))
        opt = ASGD(learning_rate=1e-3, batch_num=3, weight_decay=0.01,
                   parameters=net.parameters())
        train = TrainStep(net, tnn.MSELoss(), opt)
        gen = torch.Generator(device="cuda").manual_seed(1)
        before = capture_counters["captures"]
        losses = []
        for t in range(6):
            x = torch.randn(64, 512, device="cuda", generator=gen)
            if t == 2:
                x[3, 7] = float("nan")
            losses.append(float(train((x,), (x,))))
            opt.consume_anomaly()
        torch.cuda.synchronize()
        state = [v.clone() for st in opt._states for v in st.values()]
        return (np.array(losses, np.float32).view(np.int32).tolist(),
                [p.detach().clone() for p in net.parameters()], state,
                opt._step_count, capture_counters["captures"] - before)

    try:
        le, pe, se, ne, _ = run(False)
        lc, pc, sc_, nc, captures = run(True)
    finally:
        flags.set_flags({"step_capture": True, "anomaly_sentinel": False})
    res = dict(steps=6, captures=captures, step_count=[ne, nc],
               losses_bitwise=le == lc,
               params_bitwise=all(torch.equal(a, b) for a, b in zip(pe, pc)),
               state_bitwise=all(torch.equal(a, b) for a, b in zip(se, sc_)))
    if not (captures == 1 and ne == nc == 5 and res["losses_bitwise"]
            and res["params_bitwise"] and res["state_bitwise"]):
        raise AssertionError(f"ASGD under a captured TrainStep: {res}")
    return res


# the layer-built network on the card vs the same network on the CPU:
# float32 on both (no TF32), the same weights and Dropout masks; cuDNN's
# convolutions and the CPU's sum in other orders, so after the 8 SGD steps
# losses, weights and BatchNorm statistics differ by summation order
# only: within LAYER_NET_ATOL absolute (losses) and LAYER_NET_REL of each
# tensor's max (weights, statistics)
LAYER_NET_ATOL, LAYER_NET_REL = 1e-3, 1e-3
LAYER_NET_SAMPLES, LAYER_NET_BATCH = 64, 16


def layer_net(tnn, dropout):
    """Convolutions without a bias: BatchNorm cancels one, so its true
    grad is zero and its trained value float noise."""
    return tnn.Sequential(
        tnn.Conv2D(3, 16, 3, padding=1, bias_attr=False),
        tnn.BatchNorm2D(16), tnn.ReLU(), tnn.MaxPool2D(2),
        tnn.Conv2D(16, 32, 3, padding=1, bias_attr=False),
        tnn.BatchNorm2D(32), tnn.ReLU(), tnn.MaxPool2D(2), tnn.Flatten(),
        dropout, tnn.Linear(32 * 8 * 8, 10))


def phase_layer_net(torch, seed, report):
    """A network built only from the ported layers (Conv2D, BatchNorm2D,
    ReLU, MaxPool2D, Flatten, Dropout with its generator, Linear with a
    bias) trains through ``hapi.Model.fit`` over a DataLoader with
    FIT_WORKERS worker processes, captured, on the card and on the CPU
    from the same weights and Dropout masks (the CPU copy's Dropout draws
    its masks from a CUDA generator seeded as the card's); then ASGD under
    a captured TrainStep."""
    from paddle_tpu_torch import io
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.core.device import set_device
    from paddle_tpu_torch.hapi import Model, callbacks
    from paddle_tpu_torch.jit import capture_counters
    from paddle_tpu_torch.optimizer import Momentum

    class CardMaskDropout(tnn.Dropout):
        """The port's dropout on a CPU tensor with the mask drawn on the
        card (the same draw the card's layer makes)."""

        def forward(self, x):
            if not self.training:
                return x
            keep = 1.0 - self.p
            mask = torch.rand(x.shape, generator=self.generator,
                              device="cuda") < keep
            return torch.where(mask.cpu(), x / keep, 0.0).to(x.dtype)

    def fit(net, device):
        losses, pids = [], set()

        class Record(callbacks.ProgBarLogger):
            def on_train_batch_end(self, step, logs=None):
                losses.append(logs["loss"])
                pids.update(loader.worker_pids())

        m = Model(net)
        m.prepare(Momentum(learning_rate=1e-3, momentum=0.9,
                           parameters=net.parameters()),
                  tnn.CrossEntropyLoss())
        np.random.seed(seed)
        loader = io.DataLoader(ImageRows(LAYER_NET_SAMPLES, seed),
                               places=device, batch_size=LAYER_NET_BATCH,
                               shuffle=True, num_workers=FIT_WORKERS,
                               persistent_workers=True,
                               timeout=WORKER_TIMEOUT_S)
        before = capture_counters["captures"], capture_counters["fallbacks"]
        try:
            m.fit(loader, epochs=FIT_EPOCHS, verbose=0,
                  callbacks=[Record(verbose=0)])
        finally:
            if loader._pool is not None:
                loader._pool.shutdown()
        state = {k: v.detach().float().cpu()
                 for k, v in net.state_dict().items()}
        return dict(losses=losses, worker_pids=sorted(pids),
                    captures=capture_counters["captures"] - before[0],
                    fallbacks=capture_counters["fallbacks"] - before[1]), \
            state

    set_device("cpu")
    try:
        tnn.initializer.seed(seed)
        cpu_net = layer_net(tnn, CardMaskDropout(
            0.25, generator=torch.Generator(device="cuda").manual_seed(seed)))
    finally:
        set_device(None)
    card_net = layer_net(tnn, tnn.Dropout(
        0.25, generator=torch.Generator(device="cuda").manual_seed(seed)))
    card_net.set_state_dict(cpu_net.state_dict())
    card, card_state = fit(card_net, "cuda")
    cpu, cpu_state = fit(cpu_net, "cpu")
    diffs = {k: float((card_state[k] - cpu_state[k]).abs().max()
                      / max(float(cpu_state[k].abs().max()), 1e-30))
             for k in cpu_state}
    res = dict(samples=LAYER_NET_SAMPLES, batch=LAYER_NET_BATCH,
               epochs=FIT_EPOCHS, card=card, cpu=cpu,
               loss_max_abs_diff=max(abs(a - b) for a, b in
                                     zip(card["losses"], cpu["losses"])),
               state_max_rel_diff=max(diffs.values()),
               bn_stats_max_rel_diff=max(v for k, v in diffs.items()
                                         if k.endswith(("_mean",
                                                        "_variance"))))
    res["asgd_capture"] = asgd_capture(torch)
    log(f"layer net: {json.dumps(res)}")
    report["layer_net"] = res
    steps = FIT_EPOCHS * LAYER_NET_SAMPLES // LAYER_NET_BATCH
    if not (len(card["losses"]) == len(cpu["losses"]) == steps
            and res["loss_max_abs_diff"] <= LAYER_NET_ATOL
            and res["state_max_rel_diff"] <= LAYER_NET_REL
            and card["captures"] == 1 and not card["fallbacks"]
            and len(card["worker_pids"]) == FIT_WORKERS
            and os.getpid() not in card["worker_pids"]
            and np.mean(card["losses"][steps // 2:])
            < np.mean(card["losses"][:steps // 2])):
        raise AssertionError(f"the layer-built network, card vs CPU: {res}")
    return res


# -- phase 5f: BERT-base SQuAD fine-tuning -------------------------------------

BERT_B, BERT_S = 12, 384        # PaddleNLP run_squad: batch 12, max_seq 384
BERT_STEPS = 10                 # a probe, the capture, then 8 timed replays
BERT_LR, BERT_WD = 3e-5, 0.01
BERT_CPU_B = 2                  # the first step's loss against the CPU
BERT_CPU_REL = 1e-4


def squad_batch(torch, seed, vocab, device="cuda"):
    """SQuAD-shaped rows from the seed: [CLS] question [SEP] context [SEP]
    token ids (random), type ids 0 for the question and 1 after, a padded
    tail of 10-30% per row (mask 0, id 0), and a start / end span inside
    each row's context."""
    rng = np.random.RandomState(seed)
    b, s = BERT_B, BERT_S
    ids = np.zeros((b, s), np.int64)
    types = np.zeros((b, s), np.int64)
    mask = np.zeros((b, s), np.int64)
    start = np.zeros(b, np.int64)
    end = np.zeros(b, np.int64)
    for r in range(b):
        valid = s - int(s * rng.uniform(0.10, 0.30))
        q = int(rng.randint(12, min(64, valid // 2)))
        ids[r, :valid] = rng.randint(1000, vocab, valid)
        ids[r, 0], ids[r, q], ids[r, valid - 1] = 101, 102, 102
        types[r, q + 1:valid] = 1
        mask[r, :valid] = 1
        start[r] = rng.randint(q + 1, valid - 1)
        end[r] = min(start[r] + rng.randint(0, 30), valid - 2)
    return [torch.from_numpy(a).to(device)
            for a in (ids, types, mask, start, end)]


def squad_loss(start_logits, end_logits, start, end):
    """The mean of the start and end cross entropies (PaddleNLP's
    ``CrossEntropyLossForSQuAD``)."""
    from paddle_tpu_torch.nn import functional as F
    return (F.cross_entropy(start_logits, start)
            + F.cross_entropy(end_logits, end)) / 2


def bert_flops_per_token(model, cfg, seq):
    """6 N + 12 layers hidden seq, N the non-embedding parameters."""
    emb = sum(p.numel() for n, p in model.named_parameters()
              if "embeddings" in n)
    n = sum(p.numel() for p in model.parameters()) - emb
    return 6 * n + 12 * cfg.num_hidden_layers * cfg.hidden_size * seq, n


def bert_build(torch, seed, dropout=True):
    """BERT-base QA from the seed, the SQuAD loss, and run_squad's AdamW
    (lr 3e-5, weight decay 0.01, global-norm clip 1.0)."""
    import paddle_tpu_torch
    from paddle_tpu_torch.models import BertConfig, BertForQuestionAnswering
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    cfg = BertConfig.base()
    if not dropout:
        cfg = dataclasses.replace(cfg, hidden_dropout_prob=0.0,
                                  attention_probs_dropout_prob=0.0)
    paddle_tpu_torch.seed(seed)
    model = BertForQuestionAnswering(cfg)
    return model, squad_loss, AdamW(
        learning_rate=BERT_LR, weight_decay=BERT_WD,
        parameters=model.parameters(), grad_clip=ClipGradByGlobalNorm(1.0))


def train_run(torch, build, inputs, labels, steps, unit, per_step,
              capture=True, amp_level=None):
    """The model, loss and optimizer that ``build()`` makes, through
    ``TrainStep`` for ``steps`` steps on one batch (``amp.decorate`` O2
    to bf16 first when ``amp_level`` is "O2"), FLAGS_step_capture set to
    ``capture``: losses, ``unit``s a second (``per_step`` a step), step
    p50/p99 (steps 3 on), peak memory, the fused optimizer's launches and
    the graphs. Returns the metrics and the ``TrainStep``."""
    from paddle_tpu_torch import amp, flags
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops import kernels
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model, loss_fn, opt = build()
    if amp_level == "O2":
        amp.decorate(model, opt, level="O2", dtype="bfloat16")
    train = TrainStep(model, loss_fn, opt, amp_level=amp_level)
    flags.set_flags({"step_capture": capture})
    kernels.reset_launch_counts()
    losses, step_s = [], []
    try:
        for i in range(steps):
            ts = time.perf_counter()
            loss = train(inputs, labels)
            torch.cuda.synchronize()
            if i >= 2:
                step_s.append(time.perf_counter() - ts)
            losses.append(float(loss))
    finally:
        flags.set_flags({"step_capture": True})
    res = {"losses": losses,
           f"{unit}_per_s": per_step / float(np.mean(step_s)),
           "step_ms_p50": 1e3 * float(np.percentile(step_s, 50)),
           "step_ms_p99": 1e3 * float(np.percentile(step_s, 99)),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "fused_optimizer_launches":
               kernels.launch_counts()["fused_optimizer"],
           "graphs": len(train.graphs())}
    return res, train


def cpu_first_loss(torch, build, inputs, labels, rows):
    """The first loss (train mode, before any update) of ``build()``'s
    model on the card and, from the same weights, on the CPU, over the
    batch's first ``rows`` rows (``None`` inputs pass as they are)."""
    from paddle_tpu_torch.core.device import set_device

    def first_loss(model, loss_fn, dev):
        def cut(ts):
            return [None if t is None else t[:rows].to(dev) for t in ts]
        with torch.no_grad():
            out = model(*cut(inputs))
            outs = tuple(out) if isinstance(out, (list, tuple)) else (out,)
            return float(loss_fn(*outs, *cut(labels)))
    card, card_loss = build()[:2]
    want = first_loss(card, card_loss, inputs[0].device)
    set_device("cpu")
    try:
        cpu, cpu_loss = build()[:2]
    finally:
        set_device(None)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    got = first_loss(cpu, cpu_loss, "cpu")
    del card, cpu
    free_card(torch)
    return dict(card_loss=want, cpu_loss=got, batch=rows,
                rel_diff=abs(got - want) / abs(want))


def attention_composite_ms(torch, cfg, batch):
    """One layer's composite attention (the registry op over [b, s, heads,
    head_dim] float32 with the padding mask and dropout 0.1), forward
    and backward, by CUDA events; times the layers."""
    from paddle_tpu_torch.ops.dispatcher import call_op
    ids, _, mask, _, _ = batch
    h, d = cfg.num_attention_heads, cfg.hidden_size // cfg.num_attention_heads
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn(BERT_B, BERT_S, h, d, device="cuda", generator=g)
               .requires_grad_() for _ in range(3))
    add = (1.0 - mask.float()[:, None, None, :]) * -1e9
    ct = torch.randn(BERT_B, BERT_S, h, d, device="cuda", generator=g)

    def step():
        out = call_op("scaled_dot_product_attention", q, k, v,
                      attn_mask=add, dropout_p=0.1)
        out.backward(ct)
    return time_ms(torch, step) * cfg.num_hidden_layers


def phase_bert_squad(torch, seed, report):
    """BERT-base SQuAD fine-tuning on the card: float32 captured, float32
    eager (FLAGS_step_capture=0), O2 bf16 captured; each 10 steps on one
    fixed batch. The eager run's AdamW bucket (float32 params and grads)
    is then held to the plain version."""
    from paddle_tpu_torch.models import BertConfig
    cfg = BertConfig.base()
    batch = squad_batch(torch, seed, cfg.vocab_size)
    inputs, labels = (batch[0], batch[1], None, batch[2]), tuple(batch[3:])
    res = dict(batch=BERT_B, seq=BERT_S, steps=BERT_STEPS,
               padded_tokens=int((batch[2] == 0).sum()))
    runs = {}
    for label, kw in (("float32", {}), ("float32_eager", dict(capture=False)),
                      ("bf16_o2", dict(amp_level="O2"))):
        run, train = train_run(torch, lambda: bert_build(torch, seed),
                               inputs, labels, BERT_STEPS, "tokens",
                               batch[0].numel(), **kw)
        flops_tok, n = bert_flops_per_token(train.model, cfg, BERT_S)
        peak = BF16_FLOPS_PER_S if "amp_level" in kw else F32_FLOPS_PER_S
        run.update(mfu=run["tokens_per_s"] * flops_tok / peak,
                   flops_per_token=flops_tok, non_embedding_params=n)
        runs[label] = run
        if label == "float32":
            n_params = sum(p.numel() for p in train.model.parameters())
            prof = profile_call(torch, lambda: train(inputs, labels), 1)
            if "all_kernels" in prof:
                prof["by_part_ms"] = categorize(prof.pop("all_kernels"),
                                                prof["device_busy_ms"])
            res["profile_float32"] = prof
        elif label == "float32_eager":
            res["optimizer_vs_plain"] = run_buckets_vs_plain(
                torch, train, inputs, labels)
        del train
        free_card(torch)
        log(f"bert_squad {label}: {json.dumps(run)}")
    res["params"] = n_params
    res["runs"] = runs
    res["attention_composite_ms"] = attention_composite_ms(torch, cfg, batch)
    res["cpu_check"] = cpu_first_loss(
        torch, lambda: bert_build(torch, seed, dropout=False), inputs,
        labels, BERT_CPU_B)
    res["captured_losses_bitwise_eager"] = \
        runs["float32"]["losses"] == runs["float32_eager"]["losses"]
    log(f"bert_squad: {n_params / 1e6:.1f} M params, profile "
        f"{json.dumps(res.get('profile_float32'))}, attention composite "
        f"(isolated, fwd+bwd, all layers) {res['attention_composite_ms']:.2f}"
        f" ms, CPU check {json.dumps(res['cpu_check'])}, fused optimizer "
        f"vs plain {json.dumps(res['optimizer_vs_plain'])}")
    report["bert_squad"] = res
    for label, run in runs.items():
        ls = run["losses"]
        if not (all(np.isfinite(ls)) and ls[-1] < ls[0]):
            raise AssertionError(f"bert_squad {label}: losses not finite "
                                 f"and falling: {ls}")
        if run["fused_optimizer_launches"] <= 0:
            raise AssertionError(f"bert_squad {label}: the fused optimizer "
                                 f"kernel was not launched")
    if not res["captured_losses_bitwise_eager"]:
        raise AssertionError(
            f"bert_squad: captured float32 losses differ from eager: "
            f"{runs['float32']['losses']} vs "
            f"{runs['float32_eager']['losses']}")
    if not res["cpu_check"]["rel_diff"] <= BERT_CPU_REL:
        raise AssertionError(f"bert_squad: the card's first loss is not the "
                             f"CPU's: {res['cpu_check']}")
    return res


# -- phase 5g: PP-OCR recognition (CRNN) and detection (DBNet) training --------

OCR_B, OCR_H, OCR_W = 128, 32, 320     # PP-OCR rec: 3 x 32 x 320
OCR_CLASSES, OCR_HIDDEN, OCR_MAX_LEN = 97, 96, 25
OCR_STEPS = 10
DB_B, DB_SIZE, DB_STEPS = 8, 640, 5    # PP-OCR det: 3 x 640 x 640
OCR_CPU_REL = 1e-4                     # first-step loss, card vs CPU
LSTM_CUDNN_ATOL = 1e-4
# the port's CTC against F.ctc_loss at b 128, T 81: losses of ~1e2-4e2,
# where a float32 ulp is 1.5e-5-3e-5, each summed over 81 steps in its
# own order (1.5e-4 apart in PR 16's first run); the logits' gradients
# are posteriors taken through exp(alpha + beta - loss), so the loss's
# rounding shows in them as the same relative error
CTC_LIBRARY_ATOL = 1e-3
CTC_GRAD_ATOL = 1e-3


def ocr_batch(torch, seed, device="cuda"):
    rng = np.random.RandomState(seed)
    imgs = rng.rand(OCR_B, 3, OCR_H, OCR_W).astype(np.float32)
    lens = rng.randint(1, OCR_MAX_LEN + 1, OCR_B)
    labels = np.zeros((OCR_B, OCR_MAX_LEN), np.int64)
    for i, n in enumerate(lens):
        labels[i, :n] = rng.randint(1, OCR_CLASSES, n)
    return [torch.from_numpy(a).to(device) for a in (imgs, labels, lens)]


def db_batch(torch, seed):
    rng = np.random.RandomState(seed + 1)
    shape = (DB_B, 1, DB_SIZE, DB_SIZE)
    out = [rng.rand(DB_B, 3, DB_SIZE, DB_SIZE).astype(np.float32),
           (rng.rand(*shape) > 0.8).astype(np.float32),
           rng.rand(*shape).astype(np.float32),
           (rng.rand(*shape) > 0.5).astype(np.float32)]
    return [torch.from_numpy(a).to("cuda") for a in out]


def ocr_build(torch, seed, kind):
    """``kind``'s model from the seed ("crnn": PP-OCR rec's CRNN and its
    CTC head loss; "dbnet": DBNet at scale 0.5 and DBLoss) and Adam (lr
    1e-3, no weight decay: the coupled rule)."""
    import paddle_tpu_torch
    from paddle_tpu_torch.models import CRNN, CTCHeadLoss, DBLoss, DBNet
    from paddle_tpu_torch.optimizer import Adam
    paddle_tpu_torch.seed(seed)
    if kind == "crnn":
        model, crit = CRNN(3, OCR_CLASSES, OCR_HIDDEN), CTCHeadLoss()
    else:
        model, crit = DBNet(3, scale=0.5), DBLoss()
    return model, crit, Adam(learning_rate=1e-3,
                             parameters=model.parameters())


def lstm_vs_cudnn(torch, lstm, t_len):
    """The CRNN's BiLSTM (the port's recurrence op, eager and as a CUDA
    graph of forward and backward) beside cuDNN's ``torch.nn.LSTM`` over
    the same weights, at the model's shapes: ms and the largest output
    difference."""
    x = torch.randn(OCR_B, t_len, 256, device="cuda", requires_grad=True)
    ref = torch.nn.LSTM(256, OCR_HIDDEN, num_layers=2, bidirectional=True,
                        batch_first=True).cuda()
    ref.load_state_dict({k: v.detach().clone()
                         for k, v in lstm.named_parameters()})
    ct = torch.randn(OCR_B, t_len, 2 * OCR_HIDDEN, device="cuda")
    with torch.no_grad():
        diff = float((lstm(x)[0] - ref(x)[0]).abs().max())

    class Outputs(torch.nn.Module):      # the sequence output alone
        def __init__(self):
            super().__init__()
            self.lstm = lstm

        def forward(self, t):
            return self.lstm(t)[0]
    graphed = torch.cuda.make_graphed_callables(Outputs(), (x,),
                                                num_warmup_iters=3)
    out = dict(max_abs_diff_vs_cudnn=diff,
               fwd_ms=time_ms(torch, lambda: lstm(x)),
               fwd_bwd_ms=time_ms(torch, lambda: lstm(x)[0].backward(ct)),
               graphed_fwd_bwd_ms=time_ms(torch,
                                          lambda: graphed(x).backward(ct)),
               cudnn_fwd_ms=time_ms(torch, lambda: ref(x)),
               cudnn_fwd_bwd_ms=time_ms(torch,
                                        lambda: ref(x)[0].backward(ct)))
    prof = profile_call(torch, lambda: lstm(x)[0].backward(ct), 1)
    out["eager_fwd_bwd_launches"] = prof.get("launches")
    return out


def ctc_vs_library(torch, t_len, labels, lens):
    """The port's ``ctc_loss`` (forward and backward) beside torch's
    ``F.ctc_loss`` at the CRNN's shapes: the rows where both losses are
    finite, the largest difference of those losses and of the logits'
    gradients of their sum, and each one's ms."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.dispatcher import call_op
    logits = torch.randn(t_len, OCR_B, OCR_CLASSES, device="cuda",
                         requires_grad=True)
    in_len = torch.full((OCR_B,), t_len, dtype=torch.long, device="cuda")

    def port():
        return call_op("ctc_loss", torch.log_softmax(logits, -1), labels,
                       in_len, lens)

    def lib():
        return F.ctc_loss(torch.log_softmax(logits, -1), labels, in_len, lens,
                          reduction="none")

    def loss_and_grad(fn):
        loss = fn()
        return loss.detach(), torch.autograd.grad(loss.sum(), logits)[0]
    got, g_got = loss_and_grad(port)
    want, g_want = loss_and_grad(lib)
    finite = torch.isfinite(got) & torch.isfinite(want)
    return dict(finite_rows=int(finite.sum()),
                loss_range=[float(want.min()), float(want.max())],
                max_abs_diff_vs_library=float((got - want)[finite].abs()
                                              .max()),
                max_abs_grad_diff_vs_library=float((g_got - g_want).abs()
                                                   .max()),
                fwd_bwd_ms=time_ms(torch, lambda: port().sum().backward()),
                library_fwd_bwd_ms=time_ms(
                    torch, lambda: lib().sum().backward()))


def phase_ocr(torch, seed, report):
    """CRNN at PP-OCR rec's width trained 10 steps captured and 10 eager
    (bit for bit), its BiLSTM and CTC beside cuDNN's and torch's, the
    eager run's Adam bucket against the plain version; then DBNet at
    PP-OCR det's input size, 5 steps; each first loss against the CPU."""
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True   # convolution grads, bitwise
    try:
        imgs, labels, lens = ocr_batch(torch, seed)
        crnn_in, crnn_lab = (imgs,), (labels, lens)
        res = dict(crnn=dict(batch=OCR_B, image=[3, OCR_H, OCR_W],
                             classes=OCR_CLASSES, hidden=OCR_HIDDEN))
        runs = {}
        for label, capture in (("captured", True), ("eager", False)):
            run, train = train_run(
                torch, lambda: ocr_build(torch, seed, "crnn"), crnn_in,
                crnn_lab, OCR_STEPS, "images", OCR_B, capture)
            runs[label] = run
            # one more step under the profiler: the kernels it runs (an
            # eager step launches each one; a replay is one graph launch)
            prof = profile_call(torch, lambda: train(crnn_in, crnn_lab), 1)
            res["crnn"][f"{label}_step_profile"] = {
                k: prof.get(k) for k in ("device_busy_ms", "wall_ms",
                                         "busy_share_of_wall", "launches",
                                         "not_measured")}
            if capture:
                with torch.no_grad():
                    t_len = train.model(imgs[:1]).shape[0]
                res["crnn"]["time_steps"] = t_len
                res["lstm"] = lstm_vs_cudnn(torch, train.model.rnn, t_len)
            else:
                res["crnn"]["optimizer_vs_plain"] = run_buckets_vs_plain(
                    torch, train, crnn_in, crnn_lab)
            del train
            free_card(torch)
            log(f"ocr crnn {label}: {json.dumps(run)}")
        res["crnn"]["runs"] = runs
        res["ctc"] = ctc_vs_library(torch, res["crnn"]["time_steps"], labels,
                                    lens)
        res["crnn"]["cpu_check"] = cpu_first_loss(
            torch, lambda: ocr_build(torch, seed, "crnn"), crnn_in, crnn_lab,
            8)
        db_in = db_batch(torch, seed)
        run, train = train_run(torch, lambda: ocr_build(torch, seed, "dbnet"),
                               db_in[:1], db_in[1:], DB_STEPS, "images", DB_B)
        del train
        free_card(torch)
        res["dbnet"] = dict(batch=DB_B, image=[3, DB_SIZE, DB_SIZE],
                            scale=0.5, run=run,
                            cpu_check=cpu_first_loss(
                                torch, lambda: ocr_build(torch, seed,
                                                         "dbnet"),
                                db_in[:1], db_in[1:], 1))
    finally:
        torch.backends.cudnn.deterministic = det
    log(f"ocr: lstm {json.dumps(res['lstm'])}; ctc {json.dumps(res['ctc'])};"
        f" crnn {json.dumps({k: v for k, v in res['crnn'].items() if k != 'runs'})};"
        f" dbnet {json.dumps(res['dbnet'])}")
    report["ocr"] = res
    crnn = res["crnn"]
    for name, ls in (("crnn captured", runs["captured"]["losses"]),
                     ("crnn eager", runs["eager"]["losses"]),
                     ("dbnet", res["dbnet"]["run"]["losses"])):
        if not (all(np.isfinite(ls)) and ls[-1] < ls[0]):
            raise AssertionError(f"ocr {name}: losses not finite and "
                                 f"falling: {ls}")
    if runs["captured"]["losses"] != runs["eager"]["losses"]:
        raise AssertionError(f"ocr: captured CRNN losses differ from eager: "
                             f"{runs['captured']['losses']} vs "
                             f"{runs['eager']['losses']}")
    for name, chk in (("crnn", crnn["cpu_check"]),
                      ("dbnet", res["dbnet"]["cpu_check"])):
        if not chk["rel_diff"] <= OCR_CPU_REL:
            raise AssertionError(f"ocr {name}: the card's first loss is not "
                                 f"the CPU's: {chk}")
    if not res["lstm"]["max_abs_diff_vs_cudnn"] <= LSTM_CUDNN_ATOL:
        raise AssertionError(f"ocr: the LSTM differs from cuDNN's: "
                             f"{res['lstm']}")
    ctc = res["ctc"]
    if not (ctc["finite_rows"] == OCR_B
            and ctc["max_abs_diff_vs_library"] <= CTC_LIBRARY_ATOL
            and ctc["max_abs_grad_diff_vs_library"] <= CTC_GRAD_ATOL):
        raise AssertionError(f"ocr: ctc_loss differs from F.ctc_loss: {ctc}")
    if not (runs["captured"]["fused_optimizer_launches"] > 0
            and res["dbnet"]["run"]["fused_optimizer_launches"] > 0):
        raise AssertionError("ocr: the fused optimizer kernel was not "
                             "launched")
    return res


# -- phase 6: MoE training ------------------------------------------------------

MOE_LAYERS = 5    # the dense layer and 4 MoE layers, each with all 64
#                   experts; the published 28 layers (16.4 B params) would
#                   need 262 GB at 16 B/param
# the 5-layer bf16 model's loss and layer-1 expert and router grads through
# the grouped-GEMM kernel vs through its plain version, same weights and
# batch: layer 1's routing is equal in both runs (its input does not pass
# a grouped product); each product's bf16 output may differ by one ulp,
# which compounds through the 4 MoE layers and moves some tokens of the
# later layers to other experts (measured on the H100: loss 1.1e-4 apart,
# grads cosine >= 0.99995, layers 2-4 routed differently; the limits are
# ~10x and ~20x those gaps)
MOE_LOSS_ATOL, MOE_GRAD_MIN_COS = 1e-3, 0.999


def moe_config():
    """DeepSeek-MoE-16B at published width (huggingface.co/deepseek-ai/
    deepseek-moe-16b-base config.json), depth cut to MOE_LAYERS; routing
    keeps the JAX package's semantics (GShard capacity 1.25 with drops,
    Switch aux loss, no top-k renormalisation)."""
    from paddle_tpu_torch.models import MoEConfig
    return MoEConfig(vocab_size=102400, hidden_size=2048,
                     intermediate_size=10944, num_hidden_layers=MOE_LAYERS,
                     num_attention_heads=16, num_key_value_heads=16,
                     max_position_embeddings=4096, rms_norm_eps=1e-6,
                     rope_theta=10000.0, num_experts=64,
                     num_experts_per_tok=6, moe_intermediate_size=1408,
                     num_shared_experts=2, first_k_dense_replace=1,
                     capacity_factor=1.25, aux_loss_alpha=0.001,
                     dtype="bfloat16")


def active_matmul_params(cfg) -> int:
    """The matmul params one token passes through (bench.py:230's N for a
    sparse model): every layer's attention, the dense layers' MLP, in each
    MoE layer the router, the shared experts and top_k of the routed
    experts, and the LM head; the embedding lookup is no matmul."""
    h, hd = cfg.hidden_size, cfg.hidden_size // cfg.num_attention_heads
    attn = h * hd * (2 * cfg.num_attention_heads
                     + 2 * cfg.num_key_value_heads)
    m = cfg.moe_intermediate_size
    moe = (3 * h * m * (cfg.num_experts_per_tok + cfg.num_shared_experts)
           + h * cfg.num_experts)
    n_dense = cfg.first_k_dense_replace
    return (cfg.num_hidden_layers * attn
            + n_dense * 3 * h * cfg.intermediate_size
            + (cfg.num_hidden_layers - n_dense) * moe + h * cfg.vocab_size)


@contextlib.contextmanager
def plain_gmm(gg):
    """Route the grouped products (forward and dx) to the plain version
    on the card."""
    saved = gg.gmm_kernel
    gg.gmm_kernel = gg.gmm_plain
    try:
        yield
    finally:
        gg.gmm_kernel = saved


@contextlib.contextmanager
def record_routing(mo, routes):
    """Append each MoE layer's (idx, counts) to ``routes`` as it routes."""
    saved = mo.route_topk

    def rec(*args):
        out = saved(*args)
        routes.append((out[0].detach(), out[2].detach()))
        return out
    mo.route_topk = rec
    try:
        yield
    finally:
        mo.route_topk = saved


def routing_stats(routes, tokens, top_k):
    """Per MoE layer: choices dropped by capacity, min and max counts."""
    return [dict(dropped=tokens * top_k - int(c.sum()), min=int(c.min()),
                 max=int(c.max())) for _, c in routes]


def kernel_vs_plain_moe(torch, model, crit, ids):
    """Loss and the first MoE layer's expert and router grads through the
    grouped-GEMM kernel and through its plain version; the first MoE
    layer's routing must be equal."""
    from paddle_tpu_torch.ops.kernels import grouped_gemm as gg
    from paddle_tpu_torch.ops.kernels import moe as mo
    layer = model.model.layers[1].mlp.moe
    res = []
    for plain in (False, True):
        routes = []
        with plain_gmm(gg) if plain else contextlib.nullcontext(), \
                record_routing(mo, routes):
            loss = crit(model(ids), ids)
            loss.backward()
        res.append((float(loss.detach()),
                    {n: p.grad.float().clone()
                     for n, p in layer.named_parameters()}, routes))
        model.zero_grad(set_to_none=True)
        del loss
    (lk, gk, rk), (lp, gp, rp) = res
    cos = {n: float(torch.nn.functional.cosine_similarity(
        gk[n].flatten(), gp[n].flatten(), dim=0)) for n in gk}
    same = [bool(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))
            for a, b in zip(rk, rp)]
    out = dict(loss_kernels=lk, loss_plain=lp, loss_abs_diff=abs(lk - lp),
               grad_cosine_min=min(cos.values()), grad_cosine=cos,
               routing_equal_by_layer=same,
               routing=routing_stats(rk, ids.numel(),
                                     model.config.num_experts_per_tok))
    if not same[0]:
        raise AssertionError("the first MoE layer routes differently through "
                             "the kernel and the plain version")
    if not (abs(lk - lp) <= MOE_LOSS_ATOL
            and min(cos.values()) >= MOE_GRAD_MIN_COS):
        raise AssertionError(f"MoE kernel vs plain: {out}")
    return out


MOE_EAGER_STEPS = 6


def moe_spread(losses, eager, graphs):
    """The captured MoE run's first MOE_EAGER_STEPS losses against two
    eager loops': each within the two eager losses of its step widened by
    their spread (atomics reorder the expert sums run to run), floored at
    1e-4 of the loss (for steps where the two eager runs happen to
    agree)."""
    a, b = eager[0]["losses"], eager[1]["losses"]
    worst = []
    for k in range(MOE_EAGER_STEPS):
        band = max(abs(a[k] - b[k]), 1e-4 * abs(a[k]))
        lo, hi = min(a[k], b[k]) - band, max(a[k], b[k]) + band
        worst.append(max(lo - losses[k], losses[k] - hi, 0.0))
    out = dict(eager_spread=[abs(x - y) for x, y in zip(a, b)],
               captured_minus_eager=[c - x for c, x in zip(losses, a)],
               outside_band=worst, graphs=len(graphs),
               capture_s=[g["capture_s"] for g in graphs],
               pool_bytes=[g["pool_bytes"] for g in graphs],
               eager={k: eager[0][k] for k in ("tokens_per_s", "step_ms_p50",
                                               "step_ms_p99",
                                               "peak_mem_gib")})
    if max(worst) > 0 or len(graphs) != 1:
        raise AssertionError(f"captured MoE run outside the eager spread: "
                             f"{out}")
    return out


def phase_moe_train(torch, seed, report):
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (MoEForCausalLM,
                                         MoEPretrainingCriterion)
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import moe as mo
    from paddle_tpu_torch.optimizer import AdamW

    cfg = moe_config()
    ids = lcg_ids(torch, TRAIN_B, TRAIN_S, cfg.vocab_size)
    free_card(torch)

    def build():
        gen = torch.Generator(device="cuda").manual_seed(seed)
        model = MoEForCausalLM(cfg, device="cuda", generator=gen)
        return model, MoEPretrainingCriterion(cfg, model), AdamW(
            learning_rate=1e-4, weight_decay=0.01,
            parameters=model.parameters(),
            grad_clip=ClipGradByGlobalNorm(1.0))
    # two eager loops: the expert products' index_add_ atomics are not
    # bitwise, so the captured run is held to their spread
    eager = [eager_train_run(torch, build, ids, MOE_EAGER_STEPS)
             for _ in range(2)]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = MoEForCausalLM(cfg, device="cuda", generator=gen)
    crit = MoEPretrainingCriterion(cfg, model)
    n_params = sum(p.numel() for p in model.parameters())
    n_active = active_matmul_params(cfg)
    n_moe = cfg.num_hidden_layers - cfg.first_k_dense_replace
    log(f"moe model: DeepSeek-MoE-16B width, {cfg.num_hidden_layers} layers "
        f"({n_moe} MoE x {cfg.num_experts} experts, top {cfg.num_experts_per_tok}"
        f", {cfg.num_shared_experts} shared), {n_params / 1e9:.3f} B params, "
        f"{n_active / 1e9:.3f} B active matmul params (bf16, seed {seed}) "
        f"built in {time.perf_counter() - t0:.1f} s")
    res = {"layers": cfg.num_hidden_layers, "params": n_params,
           "active_matmul_params": n_active, "batch": TRAIN_B,
           "seq": TRAIN_S, "capacity": mo.moe_capacity(
               TRAIN_B * TRAIN_S, cfg.num_experts_per_tok, cfg.num_experts,
               cfg.capacity_factor)}
    res["kernel_vs_plain"] = kernel_vs_plain_moe(torch, model, crit, ids)
    log(f"moe kernels vs plain (loss, layer-1 expert and router grads, "
        f"routing): {json.dumps(res['kernel_vs_plain'])}")

    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    train = TrainStep(model, crit, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, step_s = [], []
    for i in range(TRAIN_STEPS):   # probe, capture, then 10 timed replays
        ts = time.perf_counter()
        loss = train((ids,), (ids,))
        torch.cuda.synchronize()
        if i >= 2:
            step_s.append(time.perf_counter() - ts)
        losses.append(float(loss))
    counts = kernels.launch_counts()
    res["launches"] = counts
    res["capture_vs_eager"] = moe_spread(losses, eager, train.graphs())
    log(f"moe train: captured TrainStep vs two eager loops: "
        f"{json.dumps(res['capture_vs_eager'])}")
    per_step = 6 * n_moe          # 3 forward products and their 3 dx
    if counts["grouped_gemm"] != per_step * 12:
        raise AssertionError(f"grouped_gemm launched {counts['grouped_gemm']}"
                             f" times in 12 steps, want {per_step * 12}")
    for name in TRAINING_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"MoE training path")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"MoE training losses not finite and falling: "
                             f"{losses}")
    tok_s = TRAIN_B * TRAIN_S / float(np.mean(step_s))
    # bench.py:230's MFU with N the active matmul params:
    # 6 * N_active + 6 * seq * hidden * layers flops per token
    flops_tok = 6 * n_active + 6 * TRAIN_S * cfg.hidden_size \
        * cfg.num_hidden_layers
    res.update(losses=losses, tokens_per_s=tok_s,
               step_ms_p50=1e3 * float(np.percentile(step_s, 50)),
               step_ms_p99=1e3 * float(np.percentile(step_s, 99)),
               step_ms=[1e3 * x for x in step_s],
               mfu=tok_s * flops_tok / BF16_FLOPS_PER_S,
               flops_per_token=flops_tok,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               grouped_gemm_launches_per_step=counts["grouped_gemm"] / 12)
    log(f"moe train: losses {[round(x, 4) for x in losses]}")
    log(f"moe train: {tok_s:.1f} tokens/s, step p50 {res['step_ms_p50']:.1f} "
        f"ms p99 {res['step_ms_p99']:.1f} ms, mfu (active params) "
        f"{res['mfu']:.4f}, peak {res['peak_mem_gib']:.2f} GiB, launches "
        f"{counts} ({res['grouped_gemm_launches_per_step']:.0f} grouped_gemm "
        f"per step)")
    routes = []
    with torch.no_grad(), record_routing(mo, routes):
        model(ids)
    res["routing_after_training"] = routing_stats(
        routes, ids.numel(), cfg.num_experts_per_tok)
    log(f"moe routing per MoE layer at step 0: "
        f"{res['kernel_vs_plain']['routing']}; after 12 steps: "
        f"{res['routing_after_training']} (dropped = choices past capacity "
        f"{res['capacity']} of {ids.numel() * cfg.num_experts_per_tok})")
    prof = profile_call(torch, lambda: train((ids,), (ids,)), 1)
    if "all_kernels" in prof:
        prof["by_part_ms"] = categorize(prof.pop("all_kernels"),
                                        prof["device_busy_ms"])
    res["profile"] = prof
    log(f"moe train profile (one step): {json.dumps(prof)}")
    del model, opt, train, crit
    gc.collect()
    torch.cuda.empty_cache()
    report["moe_train"] = res
    return res


# -- phase eager_surface: Paddle's eager loop through the Tensor surface ------
EAGER_STEPS = 6
RANDOM_N = 1 << 24
CAPTURED_DRAW_N = 1 << 20
MOMENT_SE = 6.0          # the moments' limit in standard errors
WGAN_REL = 1e-5          # WGAN-GP penalty and grads, card vs CPU
_U = 1.0 / math.sqrt(12.0)
# name -> (draw(paddle, n), (mean, std) of the law, support (lo, hi))
RANDOM_DRAWS = {
    "rand": (lambda P, n: P.rand([n]), (0.5, _U), (0.0, 1.0)),
    "randn": (lambda P, n: P.randn([n]), (0.0, 1.0), None),
    "randint": (lambda P, n: P.randint(0, 10, [n]),
                (4.5, math.sqrt(99 / 12)), (0, 9)),
    "bernoulli": (lambda P, n: P.bernoulli(P.full([n], 0.3)),
                  (0.3, math.sqrt(0.21)), (0, 1)),
    # weights 1 : 2 : 3, made on the card (a host copy cannot be captured)
    "multinomial": (lambda P, n: P.multinomial(
        P.arange(1, 4, dtype="float32"), n, replacement=True),
        (4 / 3, math.sqrt(14 / 6 - 16 / 9)), (0, 2)),
}


def draw_stats(torch, t):
    """(n, mean, std, min, max) of a draw, reduced on its device."""
    d = t.as_subclass(torch.Tensor).double()
    return (d.numel(), float(d.mean()), float(d.std(unbiased=False)),
            float(d.min()), float(d.max()))


def moment_errors(name, stats):
    """The ways a draw's stats miss its law: mean beyond MOMENT_SE standard
    errors, std beyond that plus 5% (discrete or capped laws), support."""
    (mu, sd), support = RANDOM_DRAWS[name][1], RANDOM_DRAWS[name][2]
    n, m, s, lo, hi = stats
    errs = []
    if abs(m - mu) > MOMENT_SE * sd / math.sqrt(n):
        errs.append(f"{name}: mean {m} vs {mu}")
    if abs(s - sd) > MOMENT_SE * sd / math.sqrt(2 * n) + 0.05 * sd:
        errs.append(f"{name}: std {s} vs {sd}")
    if support is not None and (lo < support[0] or hi > support[1]):
        errs.append(f"{name}: [{lo}, {hi}] outside {support}")
    return errs


def wgan_gp(P, np_seed=3):
    """The reference's WGAN-GP penalty step (tests/test_double_grad.py:134)
    at its shapes, on ``set_device``'s device: the penalty and the critic's
    grads (None as zeros), as numpy."""
    rng = np.random.RandomState(np_seed)
    ws = [(rng.randn(*s) * 0.5).astype(np.float32)
          for s in ((4, 8), (8,), (8, 1), (1,))]

    def attr(w):
        return P.ParamAttr(initializer=P.nn.initializer.Assign(w))
    critic = P.nn.Sequential(
        P.nn.Linear(4, 8, weight_attr=attr(ws[0]), bias_attr=attr(ws[1])),
        P.nn.Tanh(),
        P.nn.Linear(8, 1, weight_attr=attr(ws[2]), bias_attr=attr(ws[3])))
    x = P.to_tensor(np.random.RandomState(0).randn(6, 4).astype(np.float32),
                    stop_gradient=False)
    (gx,) = P.grad(critic(x).sum(), x, create_graph=True)
    norm = (gx * gx).sum(axis=1).sqrt()
    penalty = ((norm - 1.0) ** 2).mean()
    penalty.backward()
    return [penalty.numpy()] + [
        np.zeros(tuple(p.shape), np.float32) if p.grad is None
        else p.grad.detach().cpu().numpy() for p in critic.parameters()]


def paddle_train_loop(torch, P, model, crit, opt, x, steps):
    """Paddle's canonical eager loop as user code: losses by ``item()``,
    seconds a step and the host's seconds until ``clear_grad`` returns
    (steps 2 on), and the last loss's ``numpy()``."""
    losses, step_s, host_s = [], [], []
    for i in range(steps):
        ts = time.perf_counter()
        loss = crit(model(x), x)
        loss.backward()
        opt.step()
        opt.clear_grad()
        th = time.perf_counter()
        losses.append(loss.item())
        if i >= 2:
            step_s.append(time.perf_counter() - ts)
            host_s.append(th - ts)
    return dict(losses=losses, step_s=step_s, host_s=host_s,
                last_numpy=loss.numpy().item(), last_item=losses[-1])


def random_on_card(torch, P, seed):
    """The random ops at RANDOM_N draws on the card: moments, the same
    bytes after the same seed with torch's global seed moved between, and
    each draw captured in a graph and replayed against the eager draws."""
    from paddle_tpu_torch.jit import jit_step
    P.seed(seed)
    first = {k: d(P, RANDOM_N) for k, (d, _, _) in RANDOM_DRAWS.items()}
    stats = {k: draw_stats(torch, v) for k, v in first.items()}
    errs = [e for k, st in stats.items() for e in moment_errors(k, st)]
    P.seed(seed)
    torch.manual_seed(seed + 12345)
    again = {k: d(P, RANDOM_N) for k, (d, _, _) in RANDOM_DRAWS.items()}
    same = {k: bool(torch.equal(first[k], again[k])) for k in first}
    del first, again
    captured = {}
    for k, (d, _, _) in RANDOM_DRAWS.items():
        P.seed(seed)
        eager = [d(P, CAPTURED_DRAW_N) for _ in range(4)]
        P.seed(seed)
        step = jit_step(lambda z, _d=d: _d(P, CAPTURED_DRAW_N) + z)
        zero = P.zeros([], dtype=eager[0].dtype)
        got = [step(zero) for _ in range(4)]
        captured[k] = dict(
            equal=[bool(torch.equal(a, b)) for a, b in zip(got, eager)],
            graphs=len(step.graphs()))
        del step, got, eager
    return dict(stats=stats, moment_errors=errs, same_bytes=same,
                captured=captured)


def phase_eager_surface(torch, seed, report):
    """Paddle's eager loop at Llama-3-8B's width through the Tensor
    surface, against the same steps over plain tensors, bit for bit."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         LlamaPretrainingCriterion)
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.optimizer import AdamW

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              num_hidden_layers=TRAIN_LAYERS)
    paddle.set_device("gpu")
    paddle.seed(seed)
    ids = paddle.randint(0, cfg.vocab_size, [TRAIN_B, TRAIN_S + 1],
                         dtype="int64")
    x = ids[:, :-1]            # the inputs; the criterion shifts the labels
    if not (isinstance(x, paddle.Tensor) and x.place == paddle.CUDAPlace(0)):
        raise AssertionError(f"randint and slicing gave {type(x)} on "
                             f"{x.place}")
    res = {"layers": cfg.num_hidden_layers, "batch": TRAIN_B,
           "seq": TRAIN_S, "steps": EAGER_STEPS}
    # the same steps over plain tensors: phase_train's eager baseline
    base = eager_llama_run(torch, cfg, seed, x.as_subclass(torch.Tensor),
                           EAGER_STEPS)
    free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = LlamaForCausalLM(cfg, device="cuda", generator=gen)
    crit = LlamaPretrainingCriterion(cfg)
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    run = paddle_train_loop(torch, paddle, model, crit, opt, x, EAGER_STEPS)
    counts = kernels.launch_counts()
    fp = bits_fingerprint(torch, train_state(model, opt))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tokens = TRAIN_B * TRAIN_S
    res["paddle_loop"] = dict(
        losses=run["losses"], steps_per_s=1.0 / float(np.mean(run["step_s"])),
        tokens_per_s=tokens / float(np.mean(run["step_s"])),
        host_ms_p50=1e3 * float(np.percentile(run["host_s"], 50)),
        step_ms_p50=1e3 * float(np.percentile(run["step_s"], 50)),
        peak_mem_gib=peak)
    res["plain_loop"] = dict(
        losses=base["losses"],
        steps_per_s=base["tokens_per_s"] / tokens,
        tokens_per_s=base["tokens_per_s"], host_ms_p50=base["host_ms_p50"],
        step_ms_p50=base["step_ms_p50"], peak_mem_gib=base["peak_mem_gib"])
    per_step = {k: counts[k] / EAGER_STEPS for k in TRAINING_KERNELS}
    res["launches"] = {k: counts[k] for k in TRAINING_KERNELS}
    res["launches_per_step"] = per_step
    # the autograd API at this width: paddle.grad against the accumulated
    # grad of the same step, a no_grad forward, numpy() against item()
    embed = model.llama.embed_tokens.weight
    logits = model(x)
    returns_tensor = isinstance(logits, paddle.Tensor)
    loss = crit(logits, x)
    (g,) = paddle.grad(loss, [embed], retain_graph=True)
    loss.backward()
    grad_equal = bool(torch.equal(g.as_subclass(torch.Tensor), embed.grad))
    opt.clear_grad()
    del g, loss, logits
    with paddle.no_grad():
        nograd_sg = model(x).stop_gradient
    res["checks"] = dict(
        losses_bitwise=run["losses"] == base["losses"],
        weights_bitwise=fp == base["fingerprint"],
        model_returns_tensor=returns_tensor,
        paddle_grad_equals_accumulated=grad_equal,
        no_grad_stop_gradient=bool(nograd_sg),
        numpy_equals_item=run["last_numpy"] == run["last_item"])
    del model, crit, opt, embed
    free_card(torch)
    log(f"eager_surface: Paddle loop vs plain loop: "
        f"{json.dumps({k: res[k] for k in ('paddle_loop', 'plain_loop')})}")
    log(f"eager_surface: checks {json.dumps(res['checks'])}, launches "
        f"{json.dumps(res['launches'])}")
    bad = [k for k, v in res["checks"].items() if v is not True]
    if bad:
        raise AssertionError(f"eager_surface: {bad} failed: "
                             f"{run['losses']} vs {base['losses']}")
    want = {"flash_attention_fwd": TRAIN_LAYERS,
            "flash_attention_dq": TRAIN_LAYERS,
            "flash_attention_dkv": TRAIN_LAYERS, "fused_optimizer": 1}
    if per_step != want:
        raise AssertionError(f"eager_surface: launches a step {per_step}, "
                             f"want {want}")
    rnd = random_on_card(torch, paddle, seed)
    res["random"] = rnd
    log(f"eager_surface: random ops at {RANDOM_N} draws: "
        f"{json.dumps(rnd)}")
    bad = rnd["moment_errors"] + [
        f"{k} not reproducible" for k, v in rnd["same_bytes"].items()
        if not v] + [f"{k} captured {v}" for k, v in rnd["captured"].items()
                     if not all(v["equal"]) or v["graphs"] != 1]
    if bad:
        raise AssertionError(f"eager_surface: random ops: {bad}")
    card = wgan_gp(paddle)
    paddle.set_device("cpu")
    try:
        cpu = wgan_gp(paddle)
    finally:
        paddle.set_device(None)
    rel = [float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
           for a, b in zip(card, cpu)]
    res["wgan_gp"] = dict(rel_err=rel, limit=WGAN_REL,
                          penalty=float(card[0]))
    log(f"eager_surface: WGAN-GP card vs CPU rel err {rel}")
    if not max(rel) <= WGAN_REL:
        raise AssertionError(f"eager_surface: WGAN-GP card vs CPU {rel}")
    report["eager_surface"] = res
    return res


# -- phase vision: paddle.vision's zoo trained on the card ----------------------

# BASELINE.md config 1 (bench.py:246-271): resnet18 on CIFAR-10 shapes,
# Momentum(lr 0.1, 0.9), at the chip batch
CIFAR_B, CIFAR_STEPS = 256, 12          # 2 warm-up steps and 10 timed
CIFAR_FIT_IMAGES, CIFAR_TEST_IMAGES = 10240, 1024
CIFAR_FIT_WORKERS = 2
CIFAR_MEAN, CIFAR_STD = [125.3, 123.0, 113.9], [63.0, 62.1, 66.7]
# PaddleClas ResNet50.yaml: Momentum 0.9, lr 0.1, L2Decay 1e-4; 224 x 224
R50_B, R50_SIZE, R50_STEPS = 64, 224, 12
R50_MACS = 4.1e9                        # multiply-adds an image, forward
# PaddleDetection yolov3_darknet53_270e_coco: Momentum 0.9, lr 0.001, L2
# 5e-4, 608 x 608, 80 classes, up to 50 gt boxes an image
YOLO_B, YOLO_SIZE, YOLO_STEPS, YOLO_GTS = 8, 608, 7, 50
YOLO_CLASSES = 80
VISION_CPU_REL = 1e-4                   # first-step loss, card vs CPU
VISION_CPU_ROWS = {"resnet18": 8, "resnet50": 4, "yolov3": 1}
YOLO_PREDICT_REL = 1e-4                 # kept boxes and scores, card vs CPU
ZOO_SIZE, ZOO_B = 224, 2
# the zoo's logits card vs CPU (cuDNN's algorithms against the CPU's over
# up to ~160 float32 layers), of the largest logit: at most 6.8e-6 on an
# H100 (MobileNetV3-Large)
ZOO_REL = 1e-4
ZOO = (("resnet18", {}), ("resnet50", {}), ("resnext50_32x4d", {}),
       ("wide_resnet50_2", {}), ("vgg16", dict(batch_norm=True)),
       ("alexnet", {}), ("mobilenet_v1", {}), ("mobilenet_v2", {}),
       ("mobilenet_v3_small", {}), ("mobilenet_v3_large", {}),
       ("squeezenet1_0", {}), ("squeezenet1_1", {}), ("densenet121", {}),
       ("shufflenet_v2_x1_0", {}), ("shufflenet_v2_swish", {}),
       ("googlenet", {}), ("inception_v3", {}), ("LeNet", {}))


def vision_mfu(run, macs, batch, peak):
    """Model FLOPs utilization: 3 passes x 2 FLOPs x ``macs`` an image
    (forward, and a backward of twice its work), over ``peak``."""
    return run["images_per_s"] * 3 * 2 * macs / peak


def fused_route(before, after, steps):
    """The fused optimizer's route counters over a run of ``steps``
    steps: every step fused, none on the per-parameter route."""
    d = {k: after[k] - before[k] for k in ("updates", "fallbacks")}
    d["buckets"] = after["buckets"]
    d["every_step_fused"] = d["fallbacks"] == 0 and d["updates"] >= steps
    return d


def vision_train(torch, build, inputs, labels, steps, batch, capture=True,
                 amp_level=None, profile=True):
    """``train_run`` with the fused optimizer's route counters and one
    profiled step more; returns the run's metrics and the ``TrainStep``."""
    from paddle_tpu_torch.optimizer import fused_counters
    before = dict(fused_counters)
    run, train = train_run(torch, build, inputs, labels, steps, "images",
                           batch, capture, amp_level)
    run["fused_route"] = fused_route(before, fused_counters, steps)
    if profile:
        prof = profile_call(torch, lambda: train(inputs, labels), 1)
        run["step_profile"] = {k: prof.get(k) for k in (
            "device_busy_ms", "wall_ms", "busy_share_of_wall", "launches",
            "top", "not_measured")}
    return run, train


def check_vision_runs(name, runs, bitwise=("captured", "eager"),
                      falling=()):
    """Finite losses everywhere, the fused route on every step, captured
    float32 bit for bit against eager, and ``falling`` runs falling."""
    for label, run in runs.items():
        ls = run["losses"]
        if not all(np.isfinite(ls)):
            raise AssertionError(f"{name} {label}: losses not finite: {ls}")
        if not (run["fused_route"]["every_step_fused"]
                and run["fused_optimizer_launches"] > 0):
            raise AssertionError(f"{name} {label}: the fused optimizer did "
                                 f"not take its route on every step: "
                                 f"{run['fused_route']}, launches "
                                 f"{run['fused_optimizer_launches']}")
    a, b = bitwise
    if runs[a]["losses"] != runs[b]["losses"]:
        raise AssertionError(f"{name}: {a} losses differ from {b}: "
                             f"{runs[a]['losses']} vs {runs[b]['losses']}")
    for label in falling:
        ls = runs[label]["losses"]
        if not ls[-1] < ls[0]:
            raise AssertionError(f"{name} {label}: losses not falling: {ls}")


def cifar_batch(torch, seed, b=None, device="cuda"):
    rng = np.random.RandomState(seed)
    b = b or CIFAR_B
    x = rng.randn(b, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 10, b).astype(np.int64)
    return [torch.from_numpy(a).to(device) for a in (x, y)]


def resnet_build(torch, seed, depth, classes, lr, wd=None):
    """``resnet{depth}`` from the seed, CrossEntropyLoss and Momentum."""
    import paddle_tpu_torch
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision import models
    paddle_tpu_torch.seed(seed)
    model = getattr(models, f"resnet{depth}")(num_classes=classes)
    return model, nn.CrossEntropyLoss(), Momentum(
        learning_rate=lr, momentum=0.9, parameters=model.parameters(),
        weight_decay=wd)


def write_cifar10(path, seed, n_train, n_test):
    """A CIFAR-10 python-version tar.gz from the seed: five training
    batches and a test batch of pickled dicts (``data`` [N, 3072] uint8
    CHW rows, ``labels``), the format ``vision.datasets.Cifar10`` reads."""
    import io
    import pickle
    import tarfile
    rng = np.random.RandomState(seed)
    per = n_train // 5
    with tarfile.open(path, "w:gz") as tar:
        for name, n in [(f"cifar-10-batches-py/data_batch_{i + 1}", per)
                        for i in range(5)] + [
                ("cifar-10-batches-py/test_batch", n_test)]:
            raw = pickle.dumps({
                b"data": rng.randint(0, 256, (n, 3072)).astype(np.uint8),
                b"labels": [int(v) for v in rng.randint(0, 10, n)]})
            info = tarfile.TarInfo(name)
            info.size = len(raw)
            tar.addfile(info, io.BytesIO(raw))
    return path


def cifar_fit(torch, seed):
    """``hapi.Model.fit`` for one epoch over ``vision.datasets.Cifar10``
    read from a CIFAR-10-format file written from the seed, with
    RandomCrop(32, 4), RandomHorizontalFlip, Normalize and Transpose in 2
    DataLoader worker processes, ``prepare(metrics=Accuracy())``, the step
    captured: images/s, the logged losses and accuracy, the route."""
    import tempfile
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.hapi import Model, callbacks
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.optimizer import fused_counters
    from paddle_tpu_torch.vision import datasets, transforms as T

    class Record(callbacks.Callback):
        def __init__(self):
            super().__init__()
            self.steps = []

        def on_train_batch_end(self, step, logs=None):
            self.steps.append((time.perf_counter(), logs["loss"],
                               logs["acc"]))

    with tempfile.TemporaryDirectory() as tmp:
        path = write_cifar10(os.path.join(tmp, "cifar-10-python.tar.gz"),
                             seed, CIFAR_FIT_IMAGES, CIFAR_TEST_IMAGES)
        tf = T.Compose([T.RandomCrop(32, padding=4),
                        T.RandomHorizontalFlip(),
                        T.Normalize(CIFAR_MEAN, CIFAR_STD,
                                    data_format="HWC"),
                        T.Transpose()])
        train = datasets.Cifar10(path, mode="train", transform=tf)
        test = datasets.Cifar10(path, mode="test", transform=T.Compose([
            T.Normalize(CIFAR_MEAN, CIFAR_STD, data_format="HWC"),
            T.Transpose()]))
        net, loss, opt = resnet_build(torch, seed, 18, 10, 0.1)
        model = Model(net)
        model.prepare(opt, loss, metrics=Accuracy())
        rec = Record()
        flags.set_flags({"step_capture": True})
        kernels.reset_launch_counts()
        before = dict(fused_counters)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model.fit(train, batch_size=CIFAR_B, epochs=1, shuffle=True,
                  num_workers=CIFAR_FIT_WORKERS, drop_last=True, verbose=0,
                  callbacks=[rec])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = len(rec.steps)
        launches = kernels.launch_counts()["fused_optimizer"]
        route = fused_route(before, fused_counters, steps)
        ev = model.evaluate(test, batch_size=CIFAR_B, verbose=0)
        cap = model._captured_step
        graphs = len(cap.graphs()) if cap is not None else 0
    times = [t for t, _, _ in rec.steps]
    warm = np.diff(times[1:]) if len(times) > 2 else [wall]
    res = dict(images=len(train), batch=CIFAR_B, steps=steps,
               workers=CIFAR_FIT_WORKERS, epoch_s=wall,
               images_per_s_epoch=steps * CIFAR_B / wall,
               images_per_s_steady=CIFAR_B / float(np.median(warm)),
               first_step_s=times[0] - t0 if times else None,
               losses=[round(float(l), 6) for _, l, _ in rec.steps],
               acc=[float(a) for _, _, a in rec.steps],
               eval={k: float(v) for k, v in ev.items()},
               peak_mem_gib=torch.cuda.max_memory_allocated()
               / 2 ** 30, fused_optimizer_launches=launches,
               fused_route=route, graphs=graphs)
    del model, net, opt, cap
    free_card(torch)
    return res


def momentum_on(torch, train):
    """The fused Momentum kernel over ResNet-50's float32 parameters (one
    bucket, L2 1e-4) twice: over fresh tensors, one allocation each
    (``fresh``), and over the run's own bucket (``own``): the model's
    parameters with the optimizer's velocity views into its padded flat
    buffer, as :func:`run_buckets_vs_plain` takes them. Each bit for bit
    against the plain version over three steps, timed beside the plain
    version, its bound and ``torch._fused_sgd_`` (momentum, weight decay)
    over the same tensors, with its chunk table's scalar rows (``main``
    fails the phase on any)."""
    from paddle_tpu_torch.ops.kernels import fused_optimizer as fo
    cfg = {"momentum": 0.9, "nesterov": False}
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    flush = lambda: scratch.zero_()  # noqa: E731  (> 50 MB L2)
    g = torch.Generator(device="cuda").manual_seed(7)
    opt = train.optimizer
    own = [p.detach() for p in opt._parameter_list]
    if any(m is not None for m in opt._masters) or any(
            s is None for s in opt._states):
        raise AssertionError("momentum_on: the run's optimizer keeps "
                             "masters or lacks state")
    n = sum(p.numel() for p in own)
    one = torch.ones((), device="cuda")
    sv = fo.pack_scalars(lr=one * 0.1, step=one * 2, inv=one, coeff=one,
                         found=one * 0, wd=one * 1e-4, inv_bc1=one,
                         inv_bc2=one)
    nbytes = 20 * n                 # p, g, v read; p, v written
    b_ms, b_by = bound(nbytes, 6 * n, F32_FLOPS_PER_S)
    layouts = {
        "fresh": ([p.clone() for p in own],
                  [{"velocity": torch.zeros_like(p)} for p in own]),
        "own": (own, opt._states)}
    res = dict(params=n, bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
               library="torch._fused_sgd_",
               **fused_plan_facts(torch, "momentum", cfg, "float32",
                                  "float32", fo.table_rows(own)[0]))
    for name, (ps, states) in layouts.items():
        grads = [torch.randn(p.shape, generator=g, device="cuda") * 1e-3
                 for p in ps]
        bucket = (ps, grads, states, [None] * len(ps))
        before = fo.unaligned_rows
        checked = fused_vs_plain(torch, "momentum", cfg, bucket, 0.1, 1e-4,
                                 1)
        plan = fo.plan_buckets("momentum", cfg, [
            (tuple(p.shape), "float32", "float32", None, 1e-4) for p in ps])
        b = plan.buckets[0]
        ms = time_ms(torch, lambda: fo.fused_bucket_kernel(
            "momentum", cfg, *bucket, sv, b), flush=flush)
        plain_ms = time_ms(torch, lambda: fo.fused_bucket_plain(
            "momentum", cfg, *bucket, sv), iters=3, flush=flush)
        bufs = [s["velocity"] for s in states]
        try:
            lib_ms = time_ms(torch, lambda: torch._fused_sgd_(
                ps, grads, bufs, weight_decay=1e-4, momentum=0.9, lr=0.1,
                dampening=0.0, nesterov=False, maximize=False,
                is_first_step=False), flush=flush)
        except (AttributeError, RuntimeError, TypeError) as e:
            lib_ms, why = None, f"{type(e).__name__}: {e}"
        else:
            why = None
        row = dict(buckets=len(plan.buckets), bitwise_equal=True,
                   checked_steps=checked, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_share=b_ms / ms,
                   unaligned_rows=fo.unaligned_rows - before)
        if why:
            row["library_not_measured"] = why
        res[name] = row
        del grads, bucket, bufs
    # the headline numbers: the run's own bucket, as training runs it
    res.update({k: res["own"][k] for k in ("ms", "plain_ms", "library_ms",
                                           "bitwise_equal",
                                           "checked_steps")})
    del layouts, own, scratch
    return res


def phase_vision_cifar(torch, seed, report):
    """BASELINE.md config 1 on the card: resnet18(num_classes=10),
    CrossEntropyLoss, Momentum(lr 0.1, 0.9) at b 256 x 3 x 32 x 32 float32
    through ``TrainStep``, captured and eager (bit for bit), the eager
    run's Momentum bucket against the plain version, the first loss
    against the CPU; then ``hapi.Model.fit`` for one epoch over
    ``vision.datasets.Cifar10``."""
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True   # convolution grads, bitwise
    try:
        x, y = cifar_batch(torch, seed)
        build = lambda: resnet_build(torch, seed, 18, 10, 0.1)  # noqa: E731
        res = dict(model="resnet18", classes=10, batch=CIFAR_B,
                   image=[3, 32, 32], steps=CIFAR_STEPS,
                   optimizer="Momentum(lr 0.1, momentum 0.9)")
        runs = {}
        for label, capture in (("captured", True), ("eager", False)):
            run, train = vision_train(torch, build, (x,), (y,), CIFAR_STEPS,
                                      CIFAR_B, capture)
            if not capture:
                run["optimizer_vs_plain"] = run_buckets_vs_plain(
                    torch, train, (x,), (y,))
            runs[label] = run
            del train
            free_card(torch)
            log(f"vision_cifar {label}: {json.dumps(run)}")
        res["runs"] = runs
        res["cpu_check"] = cpu_first_loss(torch, build, (x,), (y,),
                                          VISION_CPU_ROWS["resnet18"])
        res["fit"] = cifar_fit(torch, seed)
        log(f"vision_cifar fit: {json.dumps(res['fit'])}")
    finally:
        torch.backends.cudnn.deterministic = det
    report["vision_cifar"] = res
    check_vision_runs("vision_cifar", runs)
    fit = res["fit"]
    if not (fit["steps"] == CIFAR_FIT_IMAGES // CIFAR_B
            and all(np.isfinite(fit["losses"]))
            and fit["fused_route"]["every_step_fused"]
            and fit["fused_optimizer_launches"] > 0 and fit["graphs"] >= 1
            and 0.0 <= fit["acc"][-1] <= 1.0 and "acc" in fit["eval"]):
        raise AssertionError(f"vision_cifar: Model.fit over Cifar10 went "
                             f"wrong: {fit}")
    if not res["cpu_check"]["rel_diff"] <= VISION_CPU_REL:
        raise AssertionError(f"vision_cifar: the card's first loss is not "
                             f"the CPU's: {res['cpu_check']}")
    return res


def phase_vision_resnet50(torch, seed, report):
    """resnet50() (1000 classes) at 224 x 224, b 64, PaddleClas's recipe
    (Momentum 0.9, lr 0.1, L2 1e-4): float32 captured and eager (bit for
    bit), O2 bf16 captured (finite, falling), MFU; the fused Momentum
    kernel over ResNet-50's parameters; the first loss against the CPU."""
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        rng = np.random.RandomState(seed + 1)
        x = torch.from_numpy(rng.randn(R50_B, 3, R50_SIZE, R50_SIZE)
                             .astype(np.float32)).cuda()
        y = torch.from_numpy(rng.randint(0, 1000, R50_B)).cuda()
        build = lambda: resnet_build(torch, seed, 50, 1000, 0.1,  # noqa
                                     1e-4)
        res = dict(model="resnet50", classes=1000, batch=R50_B,
                   image=[3, R50_SIZE, R50_SIZE], steps=R50_STEPS,
                   optimizer="Momentum(lr 0.1, momentum 0.9, L2 1e-4)",
                   flops_per_image=3 * 2 * R50_MACS)
        runs = {}
        for label, capture, amp in (("captured", True, None),
                                    ("eager", False, None),
                                    ("o2_bf16", True, "O2")):
            run, train = vision_train(torch, build, (x,), (y,), R50_STEPS,
                                      R50_B, capture, amp)
            run["mfu"] = vision_mfu(run, R50_MACS, R50_B,
                                    BF16_FLOPS_PER_S if amp
                                    else F32_FLOPS_PER_S)
            runs[label] = run
            if label == "captured":
                res["momentum_kernel"] = momentum_on(torch, train)
            del train
            free_card(torch)
            log(f"vision_resnet50 {label}: {json.dumps(run)}")
        res["runs"] = runs
        res["cpu_check"] = cpu_first_loss(torch, build, (x,), (y,),
                                          VISION_CPU_ROWS["resnet50"])
    finally:
        torch.backends.cudnn.deterministic = det
    log(f"vision_resnet50: momentum kernel "
        f"{json.dumps(res['momentum_kernel'])}; cpu {res['cpu_check']}")
    report["vision_resnet50"] = res
    check_vision_runs("vision_resnet50", runs, falling=("o2_bf16",))
    if not res["cpu_check"]["rel_diff"] <= VISION_CPU_REL:
        raise AssertionError(f"vision_resnet50: the card's first loss is "
                             f"not the CPU's: {res['cpu_check']}")
    return res


def yolo_batch(torch, seed, device="cuda"):
    """Images and gts from the seed: 1 to 50 gt boxes an image (normalized
    cx, cy, w, h; the rest zero rows), labels over 80 classes, mixup
    scores 1."""
    rng = np.random.RandomState(seed + 2)
    x = rng.rand(YOLO_B, 3, YOLO_SIZE, YOLO_SIZE).astype(np.float32)
    box = np.zeros((YOLO_B, YOLO_GTS, 4), np.float32)
    lab = np.zeros((YOLO_B, YOLO_GTS), np.int64)
    for i in range(YOLO_B):
        n = rng.randint(1, YOLO_GTS + 1)
        box[i, :n, :2] = rng.uniform(0.05, 0.95, (n, 2))
        box[i, :n, 2:] = rng.uniform(0.02, 0.6, (n, 2))
        lab[i, :n] = rng.randint(0, YOLO_CLASSES, n)
    score = np.ones((YOLO_B, YOLO_GTS), np.float32)
    return [torch.from_numpy(a).to(device) for a in (x, box, lab, score)]


def yolo_build(torch, seed):
    """yolov3_darknet53(num_classes=80) from the seed, its loss over the
    three heads, and Momentum(lr 0.001, 0.9, L2 5e-4)."""
    import paddle_tpu_torch
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision import models
    paddle_tpu_torch.seed(seed)
    model = models.yolov3_darknet53(num_classes=YOLO_CLASSES)

    def loss(o1, o2, o3, box, label, score):
        return model.loss([o1, o2, o3], box, label, score)
    return model, loss, Momentum(learning_rate=0.001, momentum=0.9,
                                 parameters=model.parameters(),
                                 weight_decay=5e-4)


YOLO_PREDICT_PICK = (50, 200)           # candidates kept by the threshold
YOLO_BN_PASSES = 30                     # train-mode forwards before predict


def yolo_threshold(torch, model, x, size):
    """A score threshold for ``predict`` from the card's decoded scores
    of one image: in the widest relative gap between the 50th and the
    200th best (box, class) scores, so the candidate set does not hang on
    the last float32 bits (the card's and the CPU's convolutions round
    differently)."""
    from paddle_tpu_torch.ops.dispatcher import call_op
    with torch.no_grad():
        outs = model(x)
        scores = []
        for i, (out, mask) in enumerate(zip(outs, model.ANCHOR_MASKS)):
            anchors = [model.ANCHORS[2 * m + d] for m in mask for d in (0, 1)]
            scores.append(call_op("yolo_box", out, size, anchors=anchors,
                                  class_num=model.num_classes,
                                  conf_thresh=0.0,
                                  downsample_ratio=32 // 2 ** i)[1])
    top = torch.cat(scores, 1).flatten().topk(YOLO_PREDICT_PICK[1] + 1)[0]
    top = top.double().cpu().numpy()
    lo, hi = YOLO_PREDICT_PICK
    gaps = (top[lo - 1:hi] - top[lo:hi + 1]) / top[lo:hi + 1]
    k = lo - 1 + int(np.argmax(gaps))
    return float((top[k] + top[k + 1]) / 2), float(gaps.max()), k + 1


def yolo_predict_vs_cpu(torch, model, x):
    """``predict`` (yolo_box + multiclass_nms3) on one image on the card
    and, from the same weights, on the CPU, at a threshold from a gap in
    the card's scores: the kept detections. The BatchNorm statistics are
    first taken from the batch (train-mode forwards without grads): at
    their initial (0, 1) the untrained net's eval logits saturate every
    score at 1."""
    import copy
    size = torch.tensor([[YOLO_SIZE, YOLO_SIZE]], dtype=torch.int64)
    model.train()
    with torch.no_grad():
        for _ in range(YOLO_BN_PASSES):
            model(x)
    model.eval()
    thresh, gap, cands = yolo_threshold(torch, model, x[:1], size.cuda())
    t0 = time.perf_counter()
    with torch.no_grad():
        out, idx, num = model.predict(x[:1], size.cuda(),
                                      conf_thresh=thresh)
    card_s = time.perf_counter() - t0
    cpu_model = copy.deepcopy(model).cpu()
    with torch.no_grad():
        c_out, c_idx, c_num = cpu_model.predict(x[:1].cpu(), size,
                                                conf_thresh=thresh)
    del cpu_model
    out, idx, num = out.cpu(), idx.cpu(), num.cpu()
    same_sel = (torch.equal(num, c_num) and torch.equal(idx, c_idx)
                and torch.equal(out[:, 0], c_out[:, 0]))
    scale = float(c_out[:, 1:].abs().max()) if c_out.numel() else 1.0
    err = float((out[:, 1:] - c_out[:, 1:]).abs().max()) \
        if same_sel and out.numel() else None
    return dict(threshold=thresh, threshold_gap=gap, candidates=cands,
                kept=int(num[0]), kept_cpu=int(c_num[0]),
                same_labels_and_indices=bool(same_sel), max_abs_err=err,
                rel_err=None if err is None else err / max(scale, 1e-30),
                limit=YOLO_PREDICT_REL, predict_s=card_s,
                labels=[int(v) for v in out[:8, 0]])


def phase_vision_yolov3(torch, seed, report):
    """yolov3_darknet53(num_classes=80) at 608 x 608, b 8, up to 50 gts an
    image, PaddleDetection's recipe (Momentum 0.9, lr 0.001, L2 5e-4):
    2 + 5 steps captured and 2 + 5 eager, bit for bit; then ``predict``
    on the batch's first image on the card against the CPU on the seed's
    weights; the first loss against the CPU."""
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        x, box, lab, score = yolo_batch(torch, seed)
        build = lambda: yolo_build(torch, seed)  # noqa: E731
        res = dict(model="yolov3_darknet53", classes=YOLO_CLASSES,
                   batch=YOLO_B, image=[3, YOLO_SIZE, YOLO_SIZE],
                   steps=YOLO_STEPS, gts=[int((box[i, :, 2] > 0).sum())
                                          for i in range(YOLO_B)],
                   optimizer="Momentum(lr 0.001, momentum 0.9, L2 5e-4)")
        runs = {}
        for label, capture in (("captured", True), ("eager", False)):
            run, train = vision_train(torch, build, (x,),
                                      (box, lab, score), YOLO_STEPS, YOLO_B,
                                      capture)
            runs[label] = run
            del train
            free_card(torch)
            log(f"vision_yolov3 {label}: {json.dumps(run)}")
        res["runs"] = runs
        # the seed's weights: trained on one random batch, the objectness
        # sinks below float32's range within a few steps
        res["predict"] = yolo_predict_vs_cpu(torch, build()[0], x)
        free_card(torch)
        res["cpu_check"] = cpu_first_loss(torch, build, (x,),
                                          (box, lab, score),
                                          VISION_CPU_ROWS["yolov3"])
    finally:
        torch.backends.cudnn.deterministic = det
    log(f"vision_yolov3: predict {json.dumps(res['predict'])}; cpu "
        f"{res['cpu_check']}")
    report["vision_yolov3"] = res
    check_vision_runs("vision_yolov3", runs)
    p = res["predict"]
    if not (p["same_labels_and_indices"] and p["kept"] > 0
            and p["rel_err"] <= YOLO_PREDICT_REL):
        raise AssertionError(f"vision_yolov3: predict on the card differs "
                             f"from the CPU's: {p}")
    if not res["cpu_check"]["rel_diff"] <= VISION_CPU_REL:
        raise AssertionError(f"vision_yolov3: the card's first loss is not "
                             f"the CPU's: {res['cpu_check']}")
    return res


def _boxes_xyxy(rng, n, w, h, lo=8.0, hi=0.4):
    xy = rng.uniform(0, 1, (n, 2)) * [w * 0.8, h * 0.8]
    wh = rng.uniform(lo, 1, (n, 2)) * [w * hi, h * hi]
    wh = np.maximum(wh, lo)
    return np.concatenate([xy, np.minimum(xy + wh, [w - 1, h - 1])], 1) \
        .astype(np.float32)


def vision_op_cases(rng, tmpdir):
    """Each registry entry of the vision tranche at a size its models run,
    one case at a time: ``(name, (op, args, kwargs, rel))`` with numpy
    args, ``rel`` the limit of the largest difference card vs CPU over the
    output's largest value."""
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    u = lambda lo, hi, *s: rng.uniform(lo, hi, s).astype(np.float32)  # noqa
    F32, CONV = 1e-5, 1e-4
    yield "grid_sample", ("grid_sample", [f(8, 64, 128, 128),
                                        u(-1, 1, 8, 128, 128, 2)], {}, F32)
    yield "affine_grid", ("affine_grid", [f(8, 2, 3)],
                        dict(output_shape=[8, 64, 128, 128]), F32)
    yield "pixel_unshuffle", ("pixel_unshuffle", [f(8, 64, 128, 128)],
                            dict(downscale_factor=2), 0.0)
    yield "channel_shuffle", ("channel_shuffle", [f(64, 232, 14, 14)],
                            dict(groups=2), 0.0)
    yield "temporal_shift", ("temporal_shift", [f(64, 256, 56, 56)],
                           dict(seg_num=8), 0.0)
    yield "maxout", ("maxout", [f(32, 256, 28, 28)], dict(groups=2), 0.0)
    yield "pad3d", ("pad3d", [f(4, 64, 16, 56, 56)],
                  dict(paddings=[1] * 6, mode="reflect"), 0.0)
    yield "pool2d", ("pool2d", [f(64, 64, 112, 112)],
                   dict(kernel_size=[3, 3], strides=[2, 2], paddings=[1, 1],
                        ceil_mode=True), 0.0)
    yield "pool3d", ("pool3d", [f(16, 64, 16, 56, 56)],
                   dict(kernel_size=[2, 2, 2], strides=[2, 2, 2],
                        pooling_type="avg"), F32)
    x_idx = f(32, 64, 112, 112)
    yield "max_pool2d_with_index", ("max_pool2d_with_index", [x_idx],
                                  dict(kernel_size=[3, 3], strides=[2, 2],
                                       paddings=[1, 1]), 0.0)
    yield "max_pool3d_with_index", ("max_pool3d_with_index",
                                  [f(8, 64, 16, 56, 56)],
                                  dict(kernel_size=[2, 2, 2],
                                       strides=[2, 2, 2]), 0.0)
    flat = x_idx.reshape(32, 64, 56, 2, 56, 2).transpose(0, 1, 2, 4, 3, 5) \
        .reshape(32, 64, 56, 56, 4)
    arg = flat.argmax(-1)
    pos = ((np.arange(56)[:, None] * 2 + arg // 2) * 112
           + np.arange(56)[None, :] * 2 + arg % 2)
    yield "unpool", ("unpool", [flat.max(-1), pos.astype(np.int64)],
                   dict(kernel_size=[2, 2], strides=[2, 2],
                        output_size=[112, 112]), 0.0)
    yield "unpool3d", ("unpool3d", [f(4, 32, 8, 28, 28),
                                  (np.arange(8 * 28 * 28) * 8).reshape(
                                      1, 1, 8, 28, 28).repeat(4, 0)
                                  .repeat(32, 1).astype(np.int64)],
                     dict(kernel_size=[2, 2, 2], strides=[2, 2, 2],
                          output_size=[16, 56, 56]), 0.0)
    yield "fold", ("fold", [f(16, 64 * 9, 56 * 56)],
                 dict(output_sizes=[56, 56], kernel_sizes=[3, 3],
                      paddings=[1, 1]), F32)
    yield "fractional_max_pool2d", ("fractional_max_pool2d",
                                  [f(16, 64, 56, 56)],
                                  dict(output_size=[32, 32], random_u=0.4,
                                       return_mask=True), 0.0)
    yield "conv3d", ("conv3d", [f(16, 64, 16, 56, 56),
                              f(64, 64, 3, 3, 3) * 0.05],
                   dict(padding=[1, 1, 1]), CONV)
    yield "conv3d_transpose", ("conv3d_transpose",
                             [f(8, 64, 8, 28, 28), f(64, 32, 2, 2, 2) * 0.1],
                             dict(stride=[2, 2, 2]), CONV)
    yield "bilinear_interp", ("bilinear_interp", [f(16, 256, 64, 64)],
                            dict(scale_factor=2.0), F32)
    yield "bilinear_interp_down", ("bilinear_interp", [f(8, 3, 512, 512)],
                                 dict(size=[224, 224]), F32)
    yield "nearest_interp", ("nearest_interp", [f(8, 256, 38, 38)],
                           dict(scale_factor=2.0), 0.0)
    yield "bicubic_interp", ("bicubic_interp", [f(8, 3, 224, 224)],
                           dict(size=[299, 299]), F32)
    yield "linear_interp", ("linear_interp", [f(16, 64, 1000)],
                          dict(size=[2000], align_corners=True), F32)
    yield "trilinear_interp", ("trilinear_interp", [f(4, 32, 16, 56, 56)],
                             dict(scale_factor=2.0), F32)
    yield "spectral_norm", ("spectral_norm", [f(512, 512, 3, 3) * 0.02,
                                            f(512), f(4608)],
                          dict(power_iters=1), CONV)
    yield "segment_pool", ("segment_pool", [f(100000, 128), np.sort(
        rng.randint(0, 1000, 100000)).astype(np.int64)],
        dict(pooltype="MEAN"), CONV)
    yield "overlap_add", ("overlap_add", [f(16, 400, 512)],
                        dict(hop_length=128), F32)
    prior = _boxes_xyxy(rng, 8732, 300, 300) / 300
    yield "box_coder", ("box_coder", [prior, u(0.1, 0.2, 8732, 4),
                                    _boxes_xyxy(rng, 50, 300, 300) / 300],
                      {}, F32)
    yield "box_coder_decode", ("box_coder", [prior, u(0.1, 0.2, 8732, 4),
                                           f(8, 8732, 4) * 0.5],
                             dict(code_type="decode_center_size", axis=1),
                             F32)
    yield "roi_align", ("roi_align", [f(2, 256, 200, 304),
                                    _boxes_xyxy(rng, 512, 1216, 800),
                                    np.array([256, 256], np.int64)],
                      dict(pooled_height=7, pooled_width=7,
                           spatial_scale=0.25, sampling_ratio=2), F32)
    yield "roi_pool", ("roi_pool", [f(2, 256, 50, 76),
                                  _boxes_xyxy(rng, 128, 1216, 800),
                                  np.array([64, 64], np.int64)],
                     dict(pooled_height=7, pooled_width=7,
                          spatial_scale=1 / 16), 0.0)
    yield "prior_box", ("prior_box", [f(1, 512, 38, 38), f(1, 3, 300, 300)],
                      dict(min_sizes=[30.0], max_sizes=[60.0],
                           aspect_ratios=[2.0], flip=True, clip=True), 0.0)
    yield "batch_norm", ("batch_norm", [f(64, 256, 56, 56), f(256),
                                      u(0.5, 2, 256), f(256), f(256)], {},
                       CONV)
    anchors = [10, 13, 16, 30, 33, 23]
    yield "yolo_box", ("yolo_box", [f(8, 255, 76, 76),
                                  np.full((8, 2), 608, np.int64)],
                     dict(anchors=anchors, class_num=80,
                          downsample_ratio=8), F32)
    gt = np.zeros((8, 50, 4), np.float32)
    gt[:, :30, :2] = u(0.05, 0.95, 8, 30, 2)
    gt[:, :30, 2:] = u(0.01, 0.5, 8, 30, 2)
    yield "yolo_loss", ("yolo_loss", [f(8, 255, 76, 76), gt,
                                    rng.randint(0, 80, (8, 50)).astype(
                                        np.int64), np.ones((8, 50),
                                                           np.float32)],
                      dict(anchors=anchors + [30, 61, 62, 45, 59, 119, 116,
                                              90, 156, 198, 373, 326],
                           anchor_mask=[0, 1, 2], class_num=80,
                           downsample_ratio=8), F32)
    yield "deformable_conv", ("deformable_conv",
                            [f(4, 64, 56, 56), f(4, 18, 56, 56),
                             f(64, 64, 3, 3) * 0.05, u(0, 1, 4, 9, 56, 56)],
                            dict(paddings=[1, 1]), CONV)
    yield "psroi_pool", ("psroi_pool", [f(2, 21 * 49, 38, 50),
                                      _boxes_xyxy(rng, 300, 800, 600),
                                      np.array([150, 150], np.int64)],
                       dict(pooled_height=7, pooled_width=7,
                            output_channels=21, spatial_scale=1 / 16), F32)
    yb = _boxes_xyxy(rng, 22743, 608, 608)
    yield "multiclass_nms3", ("multiclass_nms3",
                            [np.stack([yb, yb[::-1]]),
                             u(0, 1, 2, 80, 22743) ** 4],
                            dict(score_threshold=0.3, nms_top_k=1000,
                                 keep_top_k=100, nms_threshold=0.45,
                                 background_label=-1), 0.0)
    yield "matrix_nms", ("matrix_nms", [np.stack([yb, yb[::-1]]),
                                      u(0, 1, 2, 80, 22743) ** 4],
                       dict(score_threshold=0.3, post_threshold=0.05,
                            nms_top_k=400, keep_top_k=100,
                            background_label=-1), 0.0)
    A, H, W = 15, 50, 76
    an = np.concatenate([u(0, 1000, H, W, A, 2),
                         u(0, 1000, H, W, A, 2) + 64], -1)
    yield "generate_proposals", ("generate_proposals",
                               [u(0, 1, 2, A, H, W), f(2, 4 * A, H, W) * 0.2,
                                np.array([[800, 1216], [800, 1216]],
                                         np.float32), an,
                                np.ones((H, W, A, 4), np.float32)], {}, 0.0)
    yield "distribute_fpn_proposals", ("distribute_fpn_proposals",
                                     [_boxes_xyxy(rng, 2000, 1216, 800),
                                      np.array([1000, 1000], np.int64)], {},
                                     0.0)
    yield "nms", ("nms", [_boxes_xyxy(rng, 2000, 608, 608), u(0, 1, 2000)],
                dict(iou_threshold=0.5), 0.0)
    path = os.path.join(tmpdir, "blob.bin")
    with open(path, "wb") as fh:
        fh.write(rng.randint(0, 256, 1 << 20).astype(np.uint8).tobytes())
    yield "read_file", ("read_file", [], dict(filename=path), 0.0)


# ops that run on the host (numpy) or read sizes on the host: timed once
VISION_HOST_OPS = {"segment_pool", "roi_pool", "prior_box", "psroi_pool",
                   "multiclass_nms3", "matrix_nms", "generate_proposals",
                   "distribute_fpn_proposals", "nms", "read_file"}


def card_vs_cpu(torch, label, fn, args, seed=0, grad=False):
    """``fn(*args)`` on the card and on the CPU (the port's default device
    set to it) from the same inputs: numpy arrays and tensors, alone or in
    lists, are made tensors on each device (the floating and complex ones
    leaves where ``grad``), anything else is passed as it is. Where
    ``grad``, one backward under the same seeded cotangent (complex for a
    complex output) through the floating and complex outputs. Returns
    ``(out_err, grad_err, card_args, card_outs)``: the largest difference
    over the largest value, of the outputs and of the inputs' gradients (a
    NaN on one side only counts inf); integer outputs must be equal."""
    def tensor(a, dev):
        t = torch.from_numpy(np.array(a)) if isinstance(a, np.ndarray) \
            else a.detach().clone()
        t = t.to(dev)
        if grad and (t.is_floating_point() or t.is_complex()):
            t.requires_grad_(True)
        return t

    def convert(a, dev):
        if isinstance(a, (np.ndarray, torch.Tensor)):
            return tensor(a, dev)
        if isinstance(a, list) and a and all(
                isinstance(v, (np.ndarray, torch.Tensor)) for v in a):
            return [tensor(v, dev) for v in a]
        return a

    def run(dev):
        ins = [convert(a, dev) for a in args]
        out = fn(*ins)
        out = list(out) if isinstance(out, (list, tuple)) else [out]
        grads = []
        if grad:
            crng = np.random.RandomState(seed)
            loss = 0
            for o in out:
                if not o.requires_grad:
                    continue
                c = np.asarray(crng.randn(*o.shape))
                if o.is_complex():
                    c = c + 1j * crng.randn(*o.shape)
                term = (o * torch.from_numpy(c.astype(
                    np.complex64 if o.is_complex() else np.float32)).to(
                        dev)).sum()
                loss = loss + (term.real if term.is_complex() else term)
            leaves = [t for a in ins for t in (a if isinstance(a, list)
                                               else [a])
                      if isinstance(t, torch.Tensor) and t.requires_grad]
            if leaves and torch.is_tensor(loss):
                grads = list(torch.autograd.grad(loss, leaves))
        return ins, [o.detach() for o in out], grads
    card_in, card, card_g = run(CARD)
    _, cpu, cpu_g = on_cpu_too(torch, lambda: run("cpu"))
    if len(card) != len(cpu) or len(card_g) != len(cpu_g):
        raise AssertionError(f"{label}: {len(card)} outputs and "
                             f"{len(card_g)} gradients on the card, "
                             f"{len(cpu)} and {len(cpu_g)} on the CPU")

    def worst(pairs):
        w = 0.0
        for a, b in pairs:
            a = a.cpu()
            if a.shape != b.shape:
                raise AssertionError(f"{label}: shapes {tuple(a.shape)} vs "
                                     f"{tuple(b.shape)}")
            if not (b.is_floating_point() or b.is_complex()):
                if not torch.equal(a, b):
                    raise AssertionError(f"{label}: integer outputs differ "
                                         f"card vs CPU")
                continue
            if b.numel():
                scale = max(float(b.abs().nan_to_num(0).max()), 1e-30)
                w = max(w, float((a - b).abs().nan_to_num(0).max()) / scale)
                if not torch.equal(torch.isnan(a), torch.isnan(b)):
                    w = float("inf")
        return w
    return (worst(zip(card, cpu)), worst(zip(card_g, cpu_g)), card_in,
            card)


def op_check(torch, label, name, op, args, kw, rel, seed=0, grad=False,
             host=False):
    """The registry op ``op`` card vs CPU (``card_vs_cpu``; ``rel_err`` the
    worse of the outputs' and the gradients' errors) and the card's ms:
    one call on the host clock where the op computes on the host or reads
    sizes there (``host``), else ``time_ms``'s median."""
    from paddle_tpu_torch.ops.dispatcher import call_op
    out_err, grad_err, card_in, card = card_vs_cpu(
        torch, f"{label} {name}", lambda *a: call_op(op, *a, **kw), args,
        seed, grad)

    def call():
        return call_op(op, *card_in, **kw)
    if host:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
    else:
        ms = time_ms(torch, call, iters=5)
    return dict(op=op, rel_err=max(out_err, grad_err), limit=rel, ms=ms,
                backward=grad, shape=list(card[0].shape) if card else [])


def zoo_vs_cpu(torch, seed, name, kw):
    """A zoo model built on the CPU from the seed, its float32 logits at
    224 x 224 (LeNet: 1 x 28 x 28), batch 2, eval mode, on the CPU and
    on the card: the largest difference over the largest logit."""
    import paddle_tpu_torch
    from paddle_tpu_torch.core.device import set_device
    from paddle_tpu_torch.vision import models
    rng = np.random.RandomState(seed + 5)
    shape = (1, 28, 28) if name == "LeNet" else (3, ZOO_SIZE, ZOO_SIZE)
    x = torch.from_numpy(rng.rand(ZOO_B, *shape).astype(np.float32))
    set_device("cpu")
    try:
        paddle_tpu_torch.seed(seed)
        model = getattr(models, name)(**kw).eval()
        with torch.no_grad():
            want = model(x)
    finally:
        set_device(None)
    model = model.cuda()
    with torch.no_grad():
        got = model(x.cuda()).cpu()
        ms = time_ms(torch, lambda: model(x.cuda()), iters=3)
    n = sum(p.numel() for p in model.parameters())
    del model
    rel = float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)
    return dict(params=n, logits=list(got.shape), rel_err=rel,
                limit=ZOO_REL, fwd_ms=ms)


def phase_vision_ops(torch, seed, report):
    """Every registry entry of the vision tranche (but ``decode_jpeg``,
    which needs PIL) on the card at a size its models run, held to the
    CPU run on the same inputs; then each zoo model's float32 forward at
    224 x 224, batch 2, held to the CPU."""
    import tempfile
    rng = np.random.RandomState(seed + 4)
    res = {"ops": {}, "zoo": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (op, args, kw, rel) in vision_op_cases(rng, tmp):
            res["ops"][name] = op_check(torch, "vision_ops", name, op,
                                        args, kw, rel,
                                        host=name in VISION_HOST_OPS)
            free_card(torch)
    log(f"vision_ops: {json.dumps(res['ops'])}")
    for name, kw in ZOO:
        res["zoo"][name] = zoo_vs_cpu(torch, seed, name, kw)
        free_card(torch)
    log(f"vision_ops zoo: {json.dumps(res['zoo'])}")
    report["vision_ops"] = res
    bad = {k: v for k, v in list(res["ops"].items()) + list(
        res["zoo"].items()) if not v["rel_err"] <= v["limit"]}
    if bad:
        raise AssertionError(f"vision_ops: card vs CPU beyond the limits: "
                             f"{bad}")
    from paddle_tpu_torch.ops import dispatcher
    from paddle_tpu_torch.ops.kernels import detection, extra_nn, vision_io
    mods = {extra_nn.__name__, detection.__name__, vision_io.__name__}
    # decode_jpeg needs PIL; viterbi_decode runs in phase text_viterbi
    entries = {n for n, k in dispatcher.KERNELS.items()
               if k.__module__ in mods} - {"decode_jpeg", "viterbi_decode"}
    missed = entries - {v["op"] for v in res["ops"].values()}
    if missed:
        raise AssertionError(f"vision_ops: entries not run: {missed}")
    return res


# -- audio, linalg, graph, Viterbi and the registry tranche -------------------

CARD = "cuda"      # the device these phases run on (a CPU rehearsal reads
                   # "cpu")


def timed_once(torch, fn):
    """``(fn(), ms)``: the first call's result (it also warms the library's
    handles and workspaces), then one more call between CUDA events (for
    calls of seconds, where ``time_ms``'s repeats cost too much)."""
    out = fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def kernel_launch_delta(kernels, before) -> dict:
    """Launches of the fourteen kernels since ``before`` (the audio, linalg,
    graph, Viterbi and registry-tranche phases fail on any: no TPU kernel
    is on their path)."""
    return {k: n - before.get(k, 0)
            for k, n in kernels.launch_counts().items() if n != before.get(k, 0)}


def on_cpu_too(torch, fn):
    """``fn()`` with the port's default device set to the CPU (layers and
    creation ops made there), then back to the one set before."""
    from paddle_tpu_torch.core.device import get_device, set_device
    prev = get_device()
    set_device("cpu")
    try:
        return fn()
    finally:
        set_device(prev)


def rel_max(torch, got, want) -> float:
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                  1e-30)


# PANNs CNN14's front end as PaddleSpeech's ESC-50 example configures it
AUDIO_SR = 32000
AUDIO_MEL = dict(n_fft=1024, hop_length=320, win_length=1024, window="hann",
                 n_mels=64, f_min=50.0, f_max=14000.0)
AUDIO_B, AUDIO_SECONDS = 64, 5
AUDIO_N_MFCC = 40
AUDIO_AMIN = 1e-10
AUDIO_DB_ATOL = 1e-3     # dB, card vs CPU, where power > 1e3 * amin
AUDIO_MFCC_REL = 1e-4    # of the largest |coefficient|, card vs CPU
ISTFT_REL = 1e-5         # istft(stft(x)) against x, of max |x|
ESC50_SR, ESC50_SECONDS, ESC50_CLASSES, ESC50_BATCH = 44100, 5, 50, 16


def audio_clips(rng, b, n, sr):
    """``b`` seeded clips of ``n`` samples: two tones and noise each."""
    t = np.arange(n, dtype=np.float64) / sr
    f = rng.uniform(80, 4000, (b, 2, 1))
    x = 0.3 * np.sin(2 * np.pi * f[:, 0] * t) + \
        0.2 * np.sin(2 * np.pi * f[:, 1] * t) + 0.05 * rng.randn(b, n)
    return x.astype(np.float32)


def write_esc50(root, rng):
    """50 ESC-50-format clips (5 s, 44.1 kHz, 16-bit mono WAV, one a class,
    fold 1 + class % 5) and ``meta/esc50.csv``, through ``audio.save``."""
    import csv
    from paddle_tpu_torch import audio
    os.makedirs(os.path.join(root, "meta"))
    os.makedirs(os.path.join(root, "audio"))
    rows = [["filename", "fold", "target", "category", "esc10", "src_file",
             "take"]]
    clips = audio_clips(rng, ESC50_CLASSES, ESC50_SR * ESC50_SECONDS,
                        ESC50_SR)
    for c in range(ESC50_CLASSES):
        fold = 1 + c % 5
        name = f"{fold}-{100000 + c}-A-{c}.wav"
        audio.save(os.path.join(root, "audio", name), clips[c:c + 1],
                   ESC50_SR)
        rows.append([name, str(fold), str(c), f"class{c}", "False",
                     str(100000 + c), "A"])
    with open(os.path.join(root, "meta", "esc50.csv"), "w", newline="") as f:
        csv.writer(f).writerows(rows)


def db_err(torch, got, want) -> float:
    """The largest dB difference where the power exceeds 1e3 * amin."""
    got, want = got.detach().cpu(), want.detach().cpu()
    big = want > 10 * math.log10(1e3 * AUDIO_AMIN)
    return float((got - want).abs()[big].max())


def phase_audio_frontend(torch, seed, report):
    """The audio path: a batch of seeded clips through ``LogMelSpectrogram``
    and ``MFCC`` on the card against the CPU, ``istft(stft(x))`` on the
    card, then ESC-50-format files through ``audio.datasets.ESC50`` and a
    DataLoader on the card, each clip held to the same clip run alone."""
    import tempfile
    from paddle_tpu_torch import audio, io, signal
    from paddle_tpu_torch.core.device import set_device
    from paddle_tpu_torch.ops import kernels
    set_device(CARD)
    before = kernels.launch_counts()
    rng = np.random.RandomState(seed + 20)
    res = {"config": dict(sr=AUDIO_SR, batch=AUDIO_B, seconds=AUDIO_SECONDS,
                          n_mfcc=AUDIO_N_MFCC, **AUDIO_MEL)}
    x = audio_clips(rng, AUDIO_B, AUDIO_SR * AUDIO_SECONDS, AUDIO_SR)
    xd = torch.from_numpy(x).to(CARD)

    def layers():
        return (audio.LogMelSpectrogram(sr=AUDIO_SR, amin=AUDIO_AMIN,
                                        **AUDIO_MEL),
                audio.MFCC(sr=AUDIO_SR, n_mfcc=AUDIO_N_MFCC, **AUDIO_MEL))
    logmel, mfcc = layers()
    with torch.no_grad():
        lm, mf = logmel(xd), mfcc(xd)
        torch.cuda.synchronize()
        res["logmel_ms"] = time_ms(torch, lambda: logmel(xd), iters=5)
        res["mfcc_ms"] = time_ms(torch, lambda: mfcc(xd), iters=5)
        c_logmel, c_mfcc = on_cpu_too(torch, layers)
        xc = torch.from_numpy(x)
        t0 = time.perf_counter()
        c_lm = c_logmel(xc)
        res["logmel_cpu_ms"] = 1e3 * (time.perf_counter() - t0)
        c_mf = c_mfcc(xc)
    res["logmel_shape"] = list(lm.shape)
    res["mfcc_shape"] = list(mf.shape)
    res["logmel_db_err"] = db_err(torch, lm, c_lm)
    res["mfcc_rel_err"] = rel_max(torch, mf, c_mf)
    res["clips_per_s"] = AUDIO_B / (res["logmel_ms"] / 1e3)
    win = audio.functional.get_window("hann", AUDIO_MEL["n_fft"])
    spec = signal.stft(xd, AUDIO_MEL["n_fft"], AUDIO_MEL["hop_length"],
                       window=win)
    back = signal.istft(spec, AUDIO_MEL["n_fft"], AUDIO_MEL["hop_length"],
                        window=win, length=xd.shape[-1])
    res["istft_rel_err"] = rel_max(torch, back, xd)
    res["stft_ms"] = time_ms(torch, lambda: signal.stft(
        xd, AUDIO_MEL["n_fft"], AUDIO_MEL["hop_length"], window=win),
        iters=5)
    res["istft_ms"] = time_ms(torch, lambda: signal.istft(
        spec, AUDIO_MEL["n_fft"], AUDIO_MEL["hop_length"], window=win),
        iters=5)
    del spec, back, lm, mf, c_lm, c_mf, xd
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "ESC-50-master")
        write_esc50(root, rng)
        ds = audio.datasets.ESC50(mode="train", split=1,
                                  feat_type="logmelspectrogram",
                                  data_dir=root, amin=AUDIO_AMIN,
                                  **AUDIO_MEL)
        loader = io.DataLoader(ds, batch_size=ESC50_BATCH, shuffle=False,
                               num_workers=0, places=CARD)
        alone = audio.LogMelSpectrogram(sr=ESC50_SR, amin=AUDIO_AMIN,
                                        **AUDIO_MEL)
        worst, n = 0.0, 0
        for feats, labels in loader:
            for f, lbl in zip(feats, labels):
                wave, sr = audio.load(ds.files[n])
                with torch.no_grad():
                    want = alone(wave.to(CARD))[0]
                worst = max(worst, db_err(torch, f, want))
                if int(lbl) != ds.labels[n] or sr != ESC50_SR:
                    raise AssertionError(f"audio_frontend: ESC50 clip {n} "
                                         f"label or sample rate wrong")
                n += 1
        # a second pass, timed whole: file reads, features, collation and
        # the copies to the card (the loader's thread prefetches)
        t0 = time.perf_counter()
        batches = 0
        for feats, _ in loader:
            batches += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res["esc50"] = dict(clips=n, batches=batches,
                            feature_shape=list(feats.shape[1:]),
                            device=str(feats.device), epoch_s=wall,
                            ms_per_batch=1e3 * wall / batches,
                            clips_per_s=n / wall, db_err_vs_alone=worst)
    res["kernel_launches"] = kernel_launch_delta(kernels, before)
    set_device(None)
    log(f"audio_frontend: {json.dumps(res)}")
    report["audio_frontend"] = res
    bad = []
    if not res["logmel_db_err"] <= AUDIO_DB_ATOL:
        bad.append("logmel card vs CPU")
    if not res["mfcc_rel_err"] <= AUDIO_MFCC_REL:
        bad.append("mfcc card vs CPU")
    if not res["istft_rel_err"] <= ISTFT_REL:
        bad.append("istft(stft(x))")
    if not res["esc50"]["db_err_vs_alone"] <= AUDIO_DB_ATOL:
        bad.append("ESC50 batches vs clips alone")
    if res["esc50"]["clips"] != 40 or not res["esc50"]["device"].startswith(
            CARD):
        bad.append("ESC50 split 1 (train) must give 40 clips on the card")
    if res["kernel_launches"]:
        bad.append(f"kernel_launches {res['kernel_launches']}")
    if bad:
        raise AssertionError(f"audio_frontend: beyond the limits: {bad}")
    return res


# the decompositions at the shapes their users run (float32)
LINALG_MLP = (4096, 14336)      # a Llama-3-8B MLP gradient (GaLore)
LINALG_SQ, LINALG_RHS = 4096, 64
LINALG_BATCH = (64, 256)
# float32: a backward-stable decomposition of an n x n' matrix moves its
# values and vectors by ~n eps (4096 x 1.2e-7 = 4.9e-4) of the largest;
# a product's residual by ~sqrt(n') eps (7e-6); cuSOLVER gesvd on an H100
# (700 W): residual 1.4e-5, orthogonality 1.0e-4, sigma^2 1.8e-4
LINALG_LIMITS = {            # each against float64 numpy of the same input
    "svd_values": 5e-4, "svd_reconstruction": 5e-5, "orthogonality": 5e-4,
    "qr_reconstruction": 1e-5, "eigh_values": 1e-4,
    "eigh_reconstruction": 1e-5, "solve": 1e-4, "det": 1e-3,
    "slogdet": 1e-3, "pinv": 1e-3, "lu_reconstruction": 1e-5}


def f64_rel(torch, a, b) -> float:
    """``|a - b| / |b|`` (Frobenius over the whole batch), in float64 on
    the card."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def orth_err(torch, q) -> float:
    q = q.double()
    eye = torch.eye(q.shape[-1], dtype=torch.float64, device=q.device)
    return float((q.mT @ q - eye).abs().max())


def phase_linalg(torch, seed, report):
    """``svd`` and ``qr`` of a Llama-3-8B MLP gradient's shape, ``eigh`` /
    ``eigvalsh`` of its Shampoo preconditioner (the 4096 x 4096 Gram
    matrix), ``solve`` / ``cholesky_solve`` / ``lstsq`` at 4096 with 64
    right-hand sides, and ``det``, ``slogdet``, ``pinv``, ``matrix_rank``,
    ``lu`` + ``lu_unpack`` over a batch of 64 matrices of 256 x 256, each
    held to its invariants and to float64 numpy, each timed."""
    from paddle_tpu_torch import linalg
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.dispatcher import call_op
    before = kernels.launch_counts()
    rng = np.random.RandomState(seed + 21)
    m, n = LINALG_MLP
    g_np = (rng.randn(m, n) / math.sqrt(n)).astype(np.float32)
    g = torch.from_numpy(g_np).to(CARD)
    errs, ms = {}, {}
    # the Gram matrix in float64 numpy: the reference for the singular
    # values (sigma^2) and the preconditioner's eigenvalues
    g64 = g_np.astype(np.float64)
    gram64 = g64 @ g64.T
    w64 = np.linalg.eigvalsh(gram64)
    (u, s, vh), ms["svd"] = timed_once(torch, lambda: linalg.svd(g))
    errs["svd_values"] = float(np.abs(np.sort(s.double().cpu().numpy() ** 2)
                                      - w64).max() / w64.max())
    errs["svd_reconstruction"] = f64_rel(torch, (u * s) @ vh, g)
    errs["svd_orthogonality"] = max(orth_err(torch, u), orth_err(torch,
                                                                 vh.mT))
    del u, s, vh
    (q, r), ms["qr"] = timed_once(torch, lambda: linalg.qr(g))
    errs["qr_reconstruction"] = f64_rel(torch, q @ r, g)
    errs["qr_orthogonality"] = orth_err(torch, q)
    errs["qr_lower_part"] = float(torch.tril(r, -1).abs().max())
    del q, r
    a = (g @ g.T).contiguous()                     # the preconditioner
    (w, v), ms["eigh"] = timed_once(torch, lambda: linalg.eigh(a))
    errs["eigh_values"] = float(np.abs(w.double().cpu().numpy() - w64).max()
                                / w64.max())
    errs["eigh_reconstruction"] = f64_rel(torch, (v * w) @ v.T, a)
    errs["eigh_orthogonality"] = orth_err(torch, v)
    wv, ms["eigvalsh"] = timed_once(torch, lambda: linalg.eigvalsh(a))
    errs["eigvalsh_vs_eigh"] = float((wv - w).abs().max() / w.abs().max())
    del v, w, g
    b_np = rng.randn(LINALG_SQ, LINALG_RHS).astype(np.float32)
    a64 = a.double().cpu().numpy()
    x64 = np.linalg.solve(a64, b_np.astype(np.float64))
    b = torch.from_numpy(b_np).to(CARD)
    chol = torch.linalg.cholesky(a)
    x64_t = torch.from_numpy(x64)
    sol = {"solve": lambda: linalg.solve(a, b),
           "cholesky_solve": lambda: linalg.cholesky_solve(b, chol),
           "lstsq": lambda: linalg.lstsq(a, b)[0]}
    for name, fn in sol.items():
        out, ms[name] = timed_once(torch, fn)
        errs[name] = f64_rel(torch, out.cpu(), x64_t)
    del a, b, chol
    bn, k = LINALG_BATCH
    mats_np = (np.eye(k) + 0.5 * rng.randn(bn, k, k) / math.sqrt(k)).astype(
        np.float32)
    mats = torch.from_numpy(mats_np).to(CARD)
    m64 = mats_np.astype(np.float64)
    sign64, logdet64 = np.linalg.slogdet(m64)
    det64 = sign64 * np.exp(logdet64)
    det = linalg.det(mats).double().cpu().numpy()
    errs["det"] = float((np.abs(det - det64) / np.abs(det64)).max())
    sign, logdet = linalg.slogdet(mats)
    errs["slogdet"] = float(np.abs(logdet.double().cpu().numpy()
                                   - logdet64).max())
    errs["slogdet_sign_mismatches"] = int(
        (sign.cpu().numpy() != sign64).sum())
    pinv64 = np.linalg.pinv(m64)
    errs["pinv"] = float(np.abs(linalg.pinv(mats).double().cpu().numpy()
                                - pinv64).max() / np.abs(pinv64).max())
    # matrix_rank over matrices of rank k - 8 - 8 * (i % 4): orthonormal
    # factors around singular values in [1, 2], so every rank is clear
    ranks = np.asarray([k - 8 - 8 * (i % 4) for i in range(bn)])

    def low_rank(rr):
        qa, _ = np.linalg.qr(rng.randn(k, rr))
        qb, _ = np.linalg.qr(rng.randn(k, rr))
        return ((qa * rng.uniform(1, 2, rr)) @ qb.T).astype(np.float32)
    low_np = np.stack([low_rank(rr) for rr in ranks])
    low = torch.from_numpy(low_np).to(CARD)
    got_rank = linalg.matrix_rank(low).cpu().numpy()
    # float64 singular values of the same float32 data, cut at the op's
    # float32 tolerance (the data's rounding lifts the zero ones to ~1e-7)
    s64 = np.linalg.svd(low_np.astype(np.float64), compute_uv=False)
    rank64 = (s64 > s64.max(-1, keepdims=True) * k *
              np.finfo(np.float32).eps).sum(-1)
    errs["matrix_rank_mismatches"] = int((got_rank != rank64).sum() +
                                         (got_rank != ranks).sum())
    lu, piv = linalg.lu(mats)
    p, l, uu = call_op("lu_unpack", lu, piv)
    errs["lu_reconstruction"] = f64_rel(torch, p @ l @ uu, mats)
    errs["lu_pivots_1_based"] = int(piv.min()) >= 1 and piv.dtype == \
        torch.int32
    ms.update(det=time_ms(torch, lambda: linalg.det(mats)),
              slogdet=time_ms(torch, lambda: linalg.slogdet(mats)),
              pinv=timed_once(torch, lambda: linalg.pinv(mats))[1],
              matrix_rank=timed_once(torch,
                                     lambda: linalg.matrix_rank(low))[1],
              lu=time_ms(torch, lambda: linalg.lu(mats)),
              lu_unpack=time_ms(torch, lambda: call_op("lu_unpack", lu,
                                                       piv)))
    res = {"shapes": dict(mlp=list(LINALG_MLP), square=LINALG_SQ,
                          rhs=LINALG_RHS, batch=list(LINALG_BATCH)),
           "errors": errs, "limits": LINALG_LIMITS, "ms": ms,
           "kernel_launches": kernel_launch_delta(kernels, before)}
    log(f"linalg: {json.dumps(res)}")
    report["linalg"] = res
    limits = dict(LINALG_LIMITS, svd_orthogonality=LINALG_LIMITS[
        "orthogonality"], qr_orthogonality=LINALG_LIMITS["orthogonality"],
        eigh_orthogonality=LINALG_LIMITS["orthogonality"],
        eigvalsh_vs_eigh=LINALG_LIMITS["eigh_values"],
        qr_lower_part=0.0, cholesky_solve=LINALG_LIMITS["solve"],
        lstsq=LINALG_LIMITS["solve"])
    bad = {k: v for k, v in errs.items() if k in limits
           and not v <= limits[k]}
    if errs["slogdet_sign_mismatches"] or errs["matrix_rank_mismatches"] \
            or not errs["lu_pivots_1_based"]:
        bad["counts"] = {k: errs[k] for k in (
            "slogdet_sign_mismatches", "matrix_rank_mismatches",
            "lu_pivots_1_based")}
    if res["kernel_launches"]:
        bad["kernel_launches"] = res["kernel_launches"]
    if bad:
        raise AssertionError(f"linalg: beyond the limits: {bad}")
    return res


# ogbn-arxiv's published scale (OGB node-property leaderboard)
GRAPH_N, GRAPH_E, GRAPH_D = 169343, 1166243, 128
GRAPH_SEEDS, GRAPH_FANOUTS = 1024, (25, 10)     # GraphSAGE's fanouts
GRAPH_REL = 1e-5        # float32 sums, card vs CPU, of the largest value


def graph_edges(rng):
    """A seeded directed graph of ogbn-arxiv's size: sources uniform,
    destinations heavy-tailed as a citation graph's in-degrees are (node
    ``N u^3`` for ``u`` uniform: a few thousand in-edges at the head, most
    nodes a handful)."""
    src = rng.randint(0, GRAPH_N, GRAPH_E).astype(np.int64)
    dst = (GRAPH_N * rng.rand(GRAPH_E) ** 3).astype(np.int64).clip(
        0, GRAPH_N - 1)
    return src, dst


def graph_csc(src, dst):
    """The CSC of the graph: ``(order, colptr)``, ``src[order]`` the
    in-neighbours of each node in turn."""
    order = np.argsort(dst, kind="stable")
    colptr = np.concatenate([[0], np.cumsum(np.bincount(
        dst, minlength=GRAPH_N))]).astype(np.int64)
    return order, colptr


def phase_graph(torch, seed, report):
    """Message passing over a seeded graph of ogbn-arxiv's size (169,343
    nodes, 1,166,243 edges, 128-d float32 features): ``send_u_recv`` under
    SUM, MEAN and MAX, ``send_ue_recv`` under MUL with per-edge weights and
    ``send_uv``, forward and backward, card against CPU; then GraphSAGE's
    two-hop sampling (fanouts 25 and 10 from 1024 seeds) with
    ``reindex_graph``, held by support and exactly."""
    from paddle_tpu_torch import geometric
    from paddle_tpu_torch.ops import kernels
    before = kernels.launch_counts()
    rng = np.random.RandomState(seed + 22)
    src_np, dst_np = graph_edges(rng)
    x = torch.from_numpy(rng.randn(GRAPH_N, GRAPH_D).astype(np.float32))
    w = torch.from_numpy(rng.rand(GRAPH_E).astype(np.float32))
    src, dst = torch.from_numpy(src_np), torch.from_numpy(dst_np)
    res = {"nodes": GRAPH_N, "edges": GRAPH_E, "dim": GRAPH_D,
           "max_in_degree": int(np.bincount(dst_np).max()), "ops": {}}
    cases = {
        "send_u_recv_sum": (lambda a, s, d: geometric.send_u_recv(
            a, s, d, "sum", GRAPH_N), (x, src, dst)),
        "send_u_recv_mean": (lambda a, s, d: geometric.send_u_recv(
            a, s, d, "mean", GRAPH_N), (x, src, dst)),
        "send_u_recv_max": (lambda a, s, d: geometric.send_u_recv(
            a, s, d, "max", GRAPH_N), (x, src, dst)),
        "send_ue_recv_mul": (lambda a, e, s, d: geometric.send_ue_recv(
            a, e, s, d, "mul", "sum", GRAPH_N), (x, w, src, dst)),
        "send_uv_add": (lambda a, b, s, d: geometric.send_uv(
            a, b, s, d, "add"), (x, x.flip(0), src, dst)),
    }
    for i, (name, (fn, ins)) in enumerate(cases.items()):
        t0 = time.perf_counter()
        out_err, grad_err, _, _ = card_vs_cpu(torch, f"graph {name}", fn,
                                              ins, seed + i, grad=True)
        t_check = time.perf_counter() - t0
        card_ins = [t.to(CARD) for t in ins]
        fwd = time_ms(torch, lambda: fn(*card_ins), iters=5)
        leaf = card_ins[0].clone().requires_grad_(True)
        out = fn(leaf, *card_ins[1:])
        ct = torch.ones_like(out)
        bwd = time_ms(torch, lambda: torch.autograd.grad(
            out, leaf, ct, retain_graph=True), iters=5)
        res["ops"][name] = dict(rel_err=out_err, grad_rel_err=grad_err,
                                limit=GRAPH_REL, fwd_ms=fwd, bwd_ms=bwd,
                                check_s=t_check)
        del out, leaf, card_ins
        free_card(torch)
    # GraphSAGE sampling over the CSC of the same graph
    order, colptr_np = graph_csc(src_np, dst_np)
    row = torch.from_numpy(src_np[order]).to(CARD)
    colptr = torch.from_numpy(colptr_np).to(CARD)
    eids = torch.from_numpy(order.astype(np.int64)).to(CARD)
    edge_keys = np.unique(dst_np * GRAPH_N + src_np)
    nodes = torch.from_numpy(rng.choice(GRAPH_N, GRAPH_SEEDS,
                                        replace=False).astype(np.int64)).to(
        CARD)
    hops, t_sample, t_reindex = [], 0.0, 0.0
    for k in GRAPH_FANOUTS:
        t0 = time.perf_counter()
        nb, cnt, e = geometric.sample_neighbors(row, colptr, nodes, k,
                                                eids=eids, return_eids=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        src_l, dst_l, out_nodes = geometric.reindex_graph(nodes, nb, cnt)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        t_sample += t1 - t0
        t_reindex += t2 - t1
        nd, nb_h, cnt_h = (nodes.cpu().numpy(), nb.cpu().numpy(),
                           cnt.cpu().numpy())
        owner = np.repeat(nd, cnt_h)
        deg = colptr_np[nd + 1] - colptr_np[nd]
        e_h = e.cpu().numpy()
        on = out_nodes.cpu().numpy()
        hop = dict(
            fanout=k, nodes=len(nd), sampled=len(nb_h),
            not_in_neighbour=int((~np.isin(owner * GRAPH_N + nb_h,
                                           edge_keys)).sum()),
            count_errors=int((cnt_h != np.minimum(deg, k)).sum()),
            repeated_edges=int(len(e_h) - len(np.unique(e_h))),
            edge_id_errors=int((src_np[e_h] != nb_h).sum() +
                               (dst_np[e_h] != owner).sum()),
            reindex_errors=int((on[src_l.cpu().numpy()] != nb_h).sum() +
                               (dst_l.cpu().numpy() != np.repeat(
                                   np.arange(len(nd)), cnt_h)).sum() +
                               (on[:len(nd)] != nd).sum()),
            out_nodes=len(on), on_card=str(nb.device).startswith(CARD))
        hops.append(hop)
        nodes = out_nodes
    res["sampling"] = dict(hops=hops, sample_ms=1e3 * t_sample,
                           reindex_ms=1e3 * t_reindex)
    res["kernel_launches"] = kernel_launch_delta(kernels, before)
    log(f"graph: {json.dumps(res)}")
    report["graph"] = res
    bad = {k: v for k, v in res["ops"].items()
           if not (v["rel_err"] <= GRAPH_REL and v["grad_rel_err"] <=
                   GRAPH_REL)}
    for h in hops:
        if any(h[k] for k in ("not_in_neighbour", "count_errors",
                              "repeated_edges", "edge_id_errors",
                              "reindex_errors")) or not h["on_card"]:
            bad[f"hop_{h['fanout']}"] = h
    if res["kernel_launches"]:
        bad["kernel_launches"] = res["kernel_launches"]
    if bad:
        raise AssertionError(f"graph: beyond the limits: {bad}")
    return res


# PaddleNLP's lexical-analysis example: 57 tags
VITERBI_B, VITERBI_S, VITERBI_TAGS = 64, 128, 57
VITERBI_TOL = 1e-4


def viterbi_margins(pot, trans, lens, bos_eos):
    """float64 numpy Viterbi: the best scores and, per row, the smallest
    margin between the best and the runner-up choice along the best path
    (the final tag and every back-pointer): a path with every margin over
    the tolerance is decided by the data, not by rounding."""
    b, s, n = pot.shape
    alpha = pot[:, 0] + (trans[n - 2][None] if bos_eos else 0)
    bps, gaps = [], []
    for t in range(1, s):
        sc = alpha[:, :, None] + trans[None]                # [b, i, j]
        top = np.sort(sc, axis=1)
        best = sc.argmax(1)
        live = (t < lens)[:, None]
        gaps.append(np.where(live, top[:, -1] - top[:, -2], np.inf))
        alpha = np.where(live, top[:, -1] + pot[:, t], alpha)
        bps.append(np.where(live, best, np.arange(n)[None]))
    if bos_eos:
        alpha = alpha + trans[:, n - 1][None]
    fin = np.sort(alpha, 1)
    margin = fin[:, -1] - fin[:, -2]
    tag = alpha.argmax(1)
    for bp, gap in zip(bps[::-1], gaps[::-1]):
        margin = np.minimum(margin, gap[np.arange(b), tag])
        tag = bp[np.arange(b), tag]
    return alpha.max(1), margin


def phase_text_viterbi(torch, seed, report):
    """CRF Viterbi decoding at PaddleNLP's lexical-analysis shape (batch 64
    x 128 tokens, 57 tags, lengths 1-128 from the seed) in both
    ``include_bos_eos_tag`` modes: scores card vs CPU within 1e-4, paths
    equal wherever the decision margin exceeds it; timed eager and under
    ``jit_step`` (one CUDA graph a call)."""
    from paddle_tpu_torch import text
    from paddle_tpu_torch.jit import jit_step
    from paddle_tpu_torch.ops import kernels
    before = kernels.launch_counts()
    rng = np.random.RandomState(seed + 23)
    pot_np = rng.randn(VITERBI_B, VITERBI_S, VITERBI_TAGS).astype(np.float32)
    trans_np = rng.randn(VITERBI_TAGS, VITERBI_TAGS).astype(np.float32)
    lens_np = rng.randint(1, VITERBI_S + 1, VITERBI_B).astype(np.int64)
    pot, trans, lens = (torch.from_numpy(a).to(CARD)
                        for a in (pot_np, trans_np, lens_np))
    res = {"shape": [VITERBI_B, VITERBI_S, VITERBI_TAGS],
           "lengths": [int(lens_np.min()), int(lens_np.max())]}
    bad = {}
    for bos_eos in (True, False):
        key = "bos_eos" if bos_eos else "plain"
        s, p = text.viterbi_decode(pot, trans, lens, bos_eos)
        cs, cp = text.viterbi_decode(*(torch.from_numpy(a) for a in (
            pot_np, trans_np, lens_np)), bos_eos)
        best64, margin = viterbi_margins(pot_np.astype(np.float64),
                                         trans_np.astype(np.float64),
                                         lens_np, bos_eos)
        decided = margin > VITERBI_TOL
        differ = (p.cpu() != cp).any(dim=1).numpy()
        step = jit_step(lambda a, b, c, _m=bos_eos: text.viterbi_decode(
            a, b, c, _m))
        outs = [step(pot, trans, lens) for _ in range(3)]
        r = dict(score_err=float((s.cpu() - cs).abs().max()),
                 score_err_f64=float(np.abs(s.cpu().double().numpy()
                                            - best64).max()),
                 decided_rows=int(decided.sum()),
                 path_mismatches_decided=int((differ & decided).sum()),
                 path_mismatches_undecided=int((differ & ~decided).sum()),
                 captured_equal=bool(all(torch.equal(o[1], p) and
                                         torch.equal(o[0], s)
                                         for o in outs)),
                 eager_ms=time_ms(torch, lambda: text.viterbi_decode(
                     pot, trans, lens, bos_eos), iters=5),
                 jit_step_ms=time_ms(torch, lambda: step(pot, trans, lens),
                                     iters=5))
        res[key] = r
        if not (r["score_err"] <= VITERBI_TOL and
                r["path_mismatches_decided"] == 0 and r["captured_equal"]):
            bad[key] = r
    res["kernel_launches"] = kernel_launch_delta(kernels, before)
    log(f"text_viterbi: {json.dumps(res)}")
    report["text_viterbi"] = res
    if res["kernel_launches"]:
        bad["kernel_launches"] = res["kernel_launches"]
    if bad:
        raise AssertionError(f"text_viterbi: beyond the limits: {bad}")
    return res


# the registry tranche's sizes: rows x width of the elementwise, norm and
# loss entries; the audio path's frames (clips x frames x n_fft); images;
# 3-D volumes; square matrices; embeddings (queries, keys, dim) for cdist;
# a matrix chain for multi_dot
TRANCHE = dict(b=64, w=4096, clips=16, frames=501, n_fft=1024, img=224,
               cube=64, sq=512, mat=256, emb=(1024, 1024, 64),
               chain=(2048, 512))


def registry_tranche_cases(rng):
    """Every entry of the 98 (linalg, fft, signal, the math tranches, graph,
    ``viterbi_decode``) that the phases above do not run, at a
    size its users run (``TRANCHE``): ``(name, (op, args, kwargs, rel))``
    with numpy args, ``rel`` the limit of the largest difference card vs
    CPU over the output's largest value."""
    T = TRANCHE
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    u = lambda lo, hi, *s: rng.uniform(lo, hi, s).astype(np.float32)  # noqa
    z = lambda *s: (rng.randn(*s) + 1j * rng.randn(*s)).astype(  # noqa
        np.complex64)
    i = lambda lo, hi, *s: rng.randint(lo, hi, s).astype(np.int64)  # noqa
    F32, DEC = 1e-5, 1e-4
    b, w, n_sq, n_mat = T["b"], T["w"], T["sq"], T["mat"]
    sq = f(n_sq, n_sq) / math.sqrt(n_sq) + 2 * np.eye(n_sq, dtype=np.float32)
    frames = f(T["clips"], T["frames"], T["n_fft"])
    bins = T["n_fft"] // 2 + 1
    spec = z(T["clips"], T["frames"], bins)
    img, cube = T["img"], T["cube"]
    # linalg
    yield "cond", ("cond", [sq], {}, DEC)
    yield "cov", ("cov", [f(128, w)], {}, DEC)
    yield "corrcoef", ("corrcoef", [f(128, w)], {}, DEC)
    m1, m2 = T["chain"]
    yield "multi_dot", ("multi_dot", [[f(m1, m2), f(m2, m1), f(m1, 64)]],
                        {}, DEC)
    raw = np.linalg.qr(f(4 * n_mat, n_mat).astype(np.float64), mode="raw")
    yield "householder_product", ("householder_product", [
        np.ascontiguousarray(raw[0].T).astype(np.float32),
        raw[1].astype(np.float32)], {}, DEC)
    yield "matrix_norm", ("matrix_norm", [f(16, n_mat, n_mat)],
                          dict(p="nuc"), DEC)
    yield "matrix_power", ("matrix_power", [sq], dict(n=5), DEC)
    yield "eig", ("eig", [f(n_mat, n_mat)], {}, 0.0)
    yield "eigvals", ("eigvals", [f(n_mat, n_mat)], {}, 0.0)
    # fft and friends over the audio path's frames, images and volumes
    yield "fft", ("fft", [frames], {}, F32)
    yield "ifft", ("ifft", [spec], {}, F32)
    yield "rfft", ("rfft", [frames], {}, F32)
    # random half spectra: their DC and Nyquist bins' imaginary parts are
    # dropped as the reference drops them (``linalg_fft.hermitian_half``)
    yield "irfft", ("irfft", [spec], dict(n=T["n_fft"]), F32)
    yield "hfft", ("hfft", [spec], dict(n=T["n_fft"]), F32)
    yield "ihfft", ("ihfft", [frames], {}, F32)
    ib = T["clips"]                  # images a batch
    yield "fft2", ("fft2", [f(ib, 3, img, img)], {}, F32)
    yield "ifft2", ("ifft2", [z(ib, 3, img, img)], {}, F32)
    yield "rfft2", ("rfft2", [f(ib, 3, img, img)], {}, F32)
    yield "irfft2", ("irfft2", [z(ib, 3, img, img // 2 + 1)], {}, F32)
    yield "fftn", ("fftn", [f(16, cube, cube, cube)], dict(axes=[1, 2, 3]),
                   F32)
    yield "ifftn", ("ifftn", [z(16, cube, cube, cube)],
                    dict(axes=[1, 2, 3]), F32)
    yield "fftshift", ("fftshift", [spec], dict(axes=[-1]), 0.0)
    yield "ifftshift", ("ifftshift", [spec], dict(axes=[-1]), 0.0)
    yield "fftfreq", ("fftfreq", [], dict(n=T["n_fft"], d=1 / 32000), F32)
    yield "rfftfreq", ("rfftfreq", [], dict(n=T["n_fft"], d=1 / 32000), F32)
    yield "fft_c2c", ("fft_c2c", [spec], {}, F32)
    yield "fft_r2c", ("fft_r2c", [frames], {}, F32)
    yield "fft_c2r", ("fft_c2r", [spec], dict(last_dim_size=T["n_fft"]),
                      F32)
    yield "frame", ("frame", [f(T["clips"], 320 * T["frames"])], dict(
        frame_length=T["n_fft"], hop_length=320), 0.0)
    # the extended tranche
    yield "nanquantile", ("nanquantile", [np.where(u(0, 1, b, w) < 0.1,
                                                   np.nan, f(b, w))],
                          dict(q=[0.1, 0.5, 0.9], axis=1), F32)
    yield "vander", ("vander", [u(-1, 1, w)], dict(n=16), F32)
    yield "trapezoid", ("trapezoid", [f(b, w)], dict(dx=0.01), F32)
    yield "polar", ("polar", [u(0, 2, b, w), f(b, w)], {}, F32)
    q, k, d = T["emb"]
    yield "cdist", ("cdist", [f(q, d), f(k, d)], {}, DEC)
    yield "crop", ("crop", [f(8, 3, 2 * img, 2 * img)], dict(
        shape=[8, 3, img, img], offsets=[0, 0, 16, 32]), 0.0)
    yield "block_diag", ("block_diag", [[f(128, 128) for _ in range(8)]],
                         {}, 0.0)
    yield "broadcast_tensors", ("broadcast_tensors", [[f(b, 1, 128),
                                                       f(1, 256, 128)]], {},
                                0.0)
    pair = [f(w, 64), f(w, 64)]
    for name in ("column_stack", "hstack", "vstack", "dstack", "row_stack"):
        yield name, (name, [pair], {}, 0.0)
    yield "atleast_1d", ("atleast_1d", [np.array(1.5, np.float32)], {}, 0.0)
    yield "atleast_2d", ("atleast_2d", [f(w)], {}, 0.0)
    yield "atleast_3d", ("atleast_3d", [f(n_sq, n_sq)], {}, 0.0)
    yield "diag_embed", ("diag_embed", [f(b, n_mat)], dict(offset=1), 0.0)
    yield "gather_tree", ("gather_tree", [i(0, 32000, 64, b // 2, 4),
                                          i(0, 4, 64, b // 2, 4)], {}, 0.0)
    # the round-2 math tranche
    x = f(b, w)
    yield "stanh", ("stanh", [x], {}, F32)
    yield "tanh_shrink", ("tanh_shrink", [x], {}, F32)
    yield "logspace", ("logspace", [], dict(start=-3, stop=3, num=w), F32)
    yield "complex", ("complex", [x, f(b, w)], {}, 0.0)
    yield "dist", ("dist", [x, f(b, w)], dict(p=3.0), DEC)
    yield "p_norm", ("p_norm", [x], dict(porder=3.0, axis=1), DEC)
    yield "frobenius_norm", ("frobenius_norm", [f(b, 64, 64)],
                             dict(axis=[1, 2]), DEC)
    yield "squared_l2_norm", ("squared_l2_norm", [x], {}, DEC)
    yield "clip_by_norm", ("clip_by_norm", [x], dict(max_norm=1.0), DEC)
    yield "add_n", ("add_n", [[x, f(b, w), f(b, w)]], {}, F32)
    yield "mean_all", ("mean_all", [x], {}, DEC)
    yield "label_smooth", ("label_smooth", [np.eye(1000, dtype=np.float32)[
        i(0, 1000, 256)]], dict(epsilon=0.1), F32)
    yield "huber_loss", ("huber_loss", [x, f(b, w)], {}, F32)
    yield "bce_loss", ("bce_loss", [u(0.01, 0.99, b, w), u(0, 1, b, w)], {},
                       F32)
    yield "kldiv_loss", ("kldiv_loss", [x, u(0.01, 1, b, w)],
                         dict(reduction="batchmean"), DEC)
    yield "log_loss", ("log_loss", [u(0.01, 0.99, w, 1), u(0, 1, w, 1)], {},
                       F32)
    yield "sigmoid_cross_entropy_with_logits", (
        "sigmoid_cross_entropy_with_logits",
        [x, (u(0, 1, b, w) > 0.5).astype(np.float32)], {}, F32)
    yield "accuracy", ("accuracy", [f(256, 1000), i(0, 1000, 256, 1)],
                       dict(k=5), 0.0)
    yield "is_empty", ("is_empty", [x], {}, 0.0)
    yield "fill_", ("fill_", [x.copy()], dict(value=0.5), 0.0)
    yield "assign_value", ("assign_value", [], dict(
        shape=[64, 64], dtype="float32", values=f(4096).tolist()), 0.0)
    runs = np.repeat(i(0, 50, w), i(1, 4, w))
    yield "unique_consecutive", ("unique_consecutive", [runs], dict(
        return_inverse=True, return_counts=True), 0.0)
    yield "repeat_interleave_with_tensor_index", (
        "repeat_interleave_with_tensor_index", [f(w, 64), i(0, 4, w)], {},
        0.0)
    yield "shard_index", ("shard_index", [i(0, 32000, w, 1)], dict(
        index_num=32000, nshards=8, shard_id=3), 0.0)
    yield "edit_distance", ("edit_distance", [i(0, 50, b, 32),
                                              i(0, 50, b, 32)], {}, 0.0)
    yield "view_dtype", ("view_dtype", [x], dict(dtype="int32"), 0.0)
    yield "set_value", ("set_value", [f(b, w), f(b // 2, w // 2)], dict(
        starts=[0, 0], ends=[b, w], steps=[2, 2], axes=[0, 1]), 0.0)
    yield "einsum", ("einsum", [[f(b, 128, 64), f(b, 64, 128)]],
                     dict(equation="bij,bjk->bik"), DEC)
    # the weighted sampler (the uniform one runs in the graph phase)
    yield "weighted_sample_neighbors", None


# entries the reference differentiates (ops.yaml: no ``backward: none``)
TRANCHE_GRAD = {
    "cond": False, "multi_dot": True, "matrix_norm": True,
    "householder_product": True,
    "matrix_power": True, "fft": True, "ifft": True, "rfft": True,
    "irfft": True, "hfft": True, "ihfft": True, "fft2": True, "ifft2": True,
    "rfft2": True, "irfft2": True, "fftn": True, "ifftn": True,
    "cdist": True, "block_diag": True, "column_stack": True, "hstack": True,
    "vstack": True, "dstack": True, "row_stack": True, "diag_embed": True,
    "stanh": True, "tanh_shrink": True, "dist": True, "p_norm": True,
    "frobenius_norm": True, "squared_l2_norm": True, "clip_by_norm": True,
    "add_n": True, "mean_all": True, "label_smooth": True,
    "huber_loss": True, "bce_loss": True, "kldiv_loss": True,
    "log_loss": True, "sigmoid_cross_entropy_with_logits": True,
    "set_value": True, "einsum": True}
# entries that compute on the host or read sizes there: timed once
TRANCHE_HOST_OPS = {"eig", "eigvals", "unique_consecutive",
                    "repeat_interleave_with_tensor_index", "edit_distance",
                    "weighted_sample_neighbors"}


def weighted_sampler_check(torch, seed):
    """``weighted_sample_neighbors`` over ogbn-arxiv's graph for 1024 nodes,
    25 each: by support, by count, by weight (a node's heaviest edges
    drawn more often)."""
    from paddle_tpu_torch import geometric
    rng = np.random.RandomState(seed + 24)
    src_np, dst_np = graph_edges(rng)
    order, colptr_np = graph_csc(src_np, dst_np)
    wt = rng.rand(GRAPH_E).astype(np.float32) + 1e-3
    nodes_np = rng.choice(GRAPH_N, GRAPH_SEEDS, replace=False)
    args = [torch.from_numpy(a).to(CARD) for a in (
        src_np[order], colptr_np, wt[order], nodes_np.astype(np.int64),
        order.astype(np.int64))]
    t0 = time.perf_counter()
    nb, cnt, e = geometric.weighted_sample_neighbors(
        *args[:4], sample_size=25, eids=args[4], return_eids=True)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    e_h, cnt_h = e.cpu().numpy(), cnt.cpu().numpy()
    owner = np.repeat(nodes_np, cnt_h)
    deg = colptr_np[nodes_np + 1] - colptr_np[nodes_np]
    errs = int((src_np[e_h] != nb.cpu().numpy()).sum() +
               (dst_np[e_h] != owner).sum() +
               (cnt_h != np.minimum(deg, 25)).sum() +
               (len(e_h) - len(np.unique(e_h))))
    # where a node has more than 25 in-edges, the drawn ones weigh more
    # than its average edge
    full = deg > 25
    mean_drawn = float(wt[e_h][np.repeat(full, cnt_h)].mean()) \
        if full.any() else 0.5
    return dict(op="weighted_sample_neighbors", rel_err=float(errs),
                limit=0.0, ms=ms, backward=False, shape=[len(e_h)],
                drawn_weight_mean=mean_drawn,
                on_card=str(nb.device).startswith(CARD))


# the extended tranche's entries in ops/kernels/math_ext.py
SLICE_MATH_EXT = {"nanquantile", "vander", "trapezoid", "polar", "cdist",
                  "crop", "block_diag", "broadcast_tensors", "column_stack",
                  "hstack", "vstack", "dstack", "row_stack", "atleast_1d",
                  "atleast_2d", "atleast_3d", "diag_embed", "gather_tree"}


def phase_registry_tranche(torch, seed, report):
    """Every other entry of the 98 on the card at a size its users
    run, held to the CPU run on the same inputs, with one backward where
    the reference differentiates the entry, and the card's ms."""
    from paddle_tpu_torch.core.device import set_device
    from paddle_tpu_torch.ops import dispatcher, kernels
    from paddle_tpu_torch.ops.kernels import (extra_math, graph, linalg_fft,
                                              math_ext)
    set_device(CARD)
    before = kernels.launch_counts()
    rng = np.random.RandomState(seed + 25)
    res = {}
    for k, (name, case) in enumerate(registry_tranche_cases(rng)):
        t0 = time.perf_counter()
        if case is None:
            res[name] = weighted_sampler_check(torch, seed)
        else:
            op, args, kw, rel = case
            res[name] = op_check(torch, "registry_tranche", name, op, args,
                                 kw, rel, seed + k,
                                 grad=TRANCHE_GRAD.get(op, False),
                                 host=name in TRANCHE_HOST_OPS)
        res[name]["wall_s"] = time.perf_counter() - t0
        free_card(torch)
    set_device(None)
    log(f"registry_tranche: {json.dumps(res)}")
    launched = kernel_launch_delta(kernels, before)
    report["registry_tranche"] = dict(ops=res, kernel_launches=launched)
    bad = {k: v for k, v in res.items() if not v["rel_err"] <= v["limit"]}
    w = res["weighted_sample_neighbors"]
    if not (w["on_card"] and w["drawn_weight_mean"] > 0.5):
        bad["weighted_sample_neighbors"] = w
    if launched:
        bad["kernel_launches"] = launched
    if bad:
        raise AssertionError(f"registry_tranche: card vs CPU beyond the "
                             f"limits: {bad}")
    # the 98 entries (97 names): run here or in the four phases before
    elsewhere = {"stft", "istft", "svd", "qr", "eigh", "eigvalsh", "solve",
                 "cholesky_solve", "lstsq", "det", "slogdet", "pinv",
                 "matrix_rank", "lu", "lu_unpack", "send_u_recv",
                 "send_ue_recv", "send_uv", "graph_sample_neighbors",
                 "reindex_graph", "viterbi_decode"}
    mods = {linalg_fft.__name__, extra_math.__name__, graph.__name__}
    entries = {n for n, k in dispatcher.KERNELS.items() if k.__module__ in
               mods} | SLICE_MATH_EXT | {"matrix_rank", "lu_unpack",
                                         "fft_c2c", "fft_r2c", "fft_c2r",
                                         "viterbi_decode"}
    missed = entries - elsewhere - {v["op"] for v in res.values()}
    if missed or len(entries) != 97:
        raise AssertionError(f"registry_tranche: entries not run: {missed} "
                             f"({len(entries)} of 97 names)")
    return res


# -- the registry's last single-device entries and QAT ------------------------

# the shapes the entries' users run (PERF.md section 4 names each source);
# ``check`` rows / tokens: where the CPU's half of a card-vs-CPU check
# would take seconds, the card's full-size call is timed and the check runs
# both devices on the leading rows
TRANCHE3 = dict(
    tokens=4096, check_tokens=256, check_rows=8,
    hidden=4096, inter=14336,                     # Llama-3-8B
    heads=32, kv_heads=8, head_dim=128, seq=2048, attn_b=2, check_heads=4,
    classes=85742, face_b=128,                   # ArcFace over MS1MV2
    vocab=128256, ids=(2, 2048),                  # Llama-3-8B's table
    experts=64, topk=6,                           # DeepSeek-MoE's gate
    opt=(4096, 14336), opt_check_rows=256,        # one Llama MLP weight
    int8_m=512, int8_check_m=128, outlier_share=0.001,
    lrn=(64, 96, 55, 55),                         # AlexNet's first LRN
    shuffle=(64, 116, 28, 28),                    # ShuffleNetV2 stage 2
    row_conv=(32, 500, 1024, 20),                 # DeepSpeech2 lookahead
    bert=(32 * 128, 768, 3072),                   # BERT-base FFN tokens
    hsig=(4096, 10000, 256),                      # word2vec batch, vocab
    deconv=(8, 128, 56, 56, 4),                   # depthwise upsampling
    act=(64, 256, 56, 56))                        # a ResNet-50 activation
TRANCHE3_F32, TRANCHE3_BF16 = 1e-5, 1e-2     # largest diff / largest value
TRANCHE3_MIXED = 1e-3   # bf16 params with float32 masters (bf16 rounding)


def tranche3_opt_cases(torch, rng):
    """The eleven optimizer op forms at one Llama MLP weight, float32 and
    bf16 with a float32 master: ``(name, op, time_args, check_args, kw,
    rel)``; the check runs the op on the weight's first rows."""
    T = TRANCHE3
    rows, cols = T["opt"]
    cr = T["opt_check_rows"]
    g = torch.Generator(device=CARD).manual_seed(int(rng.randint(1 << 30)))

    def card(scale=1.0, lo=None):
        t = torch.randn(rows, cols, generator=g, device=CARD) * scale
        return t.abs() if lo is not None else t
    P, G = card(), card(1e-3)
    M1, M2 = card(1e-3), card(1e-3, lo=0) ** 2
    lr = torch.full((1,), 1e-3, device=CARD)
    pows = [torch.full((1,), 0.9 ** 3, device=CARD),
            torch.full((1,), 0.999 ** 3, device=CARD)]
    n = torch.full((1,), 3.0, device=CARD)
    prev = torch.where(card() > 0, G, -G)
    rlr = card(1e-3, lo=0) + 1e-4
    rules = {
        "sgd_op": ([P, lr, G], {}, 3),
        "momentum_op": ([P, G, M1, lr], dict(
            regularization_method="l2_decay", regularization_coeff=1e-4), 4),
        "adam_op": ([P, G, lr, M1, M2, *pows], {}, 7),
        "adamw_op": ([P, G, lr, M1, M2, *pows], dict(coeff=0.01), 7),
        "adagrad_op": ([P, G, M2, lr], {}, 4),
        "adadelta_op": ([P, G, M2, M2 * 0.5, lr], {}, 5),
        "adamax_op": ([P, G, lr, M1, M1.abs(), pows[0]], {}, 6),
        "rmsprop_op": ([P, M2, G, M1, lr], dict(momentum=0.9), 6),
        "lamb_op": ([P, G, lr, M1, M2, *pows], dict(weight_decay=0.01), 7),
        "asgd_op": ([P, G, lr, M1, G * 0.5, n], {}, 6),
        "rprop_op": ([P, G, prev, rlr], {}, 4)}

    def check(args):
        return [a[:cr].cpu() if torch.is_tensor(a) and a.dim() == 2
                else a.cpu() if torch.is_tensor(a) else a for a in args]
    for op, (args, kw, master_at) in rules.items():
        yield f"{op}_float32", op, args, check(args), kw, TRANCHE3_F32
        mixed = [P.to(torch.bfloat16)] + list(args[1:])
        mixed += [None] * (master_at - len(mixed))
        mixed.insert(master_at, P)
        yield (f"{op}_bf16_master", op, mixed, check(mixed),
               dict(kw, multi_precision=True), TRANCHE3_MIXED)


def registry_tranche3_cases(torch, rng):
    """The other entries: ``(name, op, time_args, check_args or None (the
    same), kw, rel)``. The full-size inputs are drawn on the card; a check
    on fewer rows takes the leading rows (of the batch, tokens or heads)
    of the same tensors to the CPU."""
    T = TRANCHE3
    g = torch.Generator(device=CARD).manual_seed(int(rng.randint(1 << 30)))

    def f(*s, scale=1.0, dtype=torch.float32):
        return torch.randn(*s, generator=g, device=CARD, dtype=dtype) * scale

    def u(lo, hi, *s):
        return torch.rand(*s, generator=g, device=CARD) * (hi - lo) + lo

    def i(lo, hi, *s):
        return torch.randint(lo, hi, s, generator=g, device=CARD)

    def bf(*s, scale=1.0):
        return f(*s, scale=scale, dtype=torch.bfloat16)

    def head(n, *ts):
        """The first ``n`` rows of each tensor (lists too) on the CPU;
        other arguments as they are."""
        def one(t):
            if isinstance(t, list):
                return [one(v) for v in t]
            return t[:n].cpu() if torch.is_tensor(t) else t
        return [one(t) for t in ts]

    def cpu(*ts):
        return [t.cpu() if torch.is_tensor(t) else t for t in ts]
    F32, BF = TRANCHE3_F32, TRANCHE3_BF16
    tok, ct, cr = T["tokens"], T["check_tokens"], T["check_rows"]
    h, inter = T["hidden"], T["inter"]
    # the compat tranche
    x = f(*T["lrn"])
    yield ("lrn", "lrn", [x], head(cr, x), dict(n=5, k=2.0, alpha=1e-4,
                                                beta=0.75), F32)
    xs, idx = [f(tok, 1024) for _ in range(4)], i(0, 4, tok, 1)
    yield ("multiplex", "multiplex", [xs, idx], head(ct, xs, idx), {}, 0.0)
    yield ("fill_diagonal_tensor", "fill_diagonal_tensor",
           [f(32, 512, 512), f(32, 512)], None, dict(dim1=1, dim2=2), 0.0)
    a, b = f(tok, h), f(tok, h)
    yield "grad_add", "grad_add", [a, b], head(ct, a, b), {}, F32
    nt, d_in, d_ff = T["bert"]
    x, w, bias = f(32, 128, d_in), f(d_in, d_ff, scale=0.03), f(d_ff)
    yield ("fc", "fc", [x, w, bias], head(cr, x) + cpu(w, bias),
           dict(in_num_col_dims=2, activation_type="relu"), F32)
    yield ("identity_loss", "identity_loss", [f(64, 1000)], None, {}, F32)
    x = f(*T["shuffle"])
    yield ("shuffle_channel", "shuffle_channel", [x], head(cr, x),
           dict(group=2), 0.0)
    x = f(tok, 1024, scale=30.0)
    yield "soft_relu", "soft_relu", [x], head(ct, x), {}, F32
    xs = [f(tok, 512) for _ in range(4)]
    yield ("partial_sum", "partial_sum", [xs], head(ct, xs),
           dict(start_index=128, length=256), F32)
    yield ("bilinear", "bilinear", [f(1024, 128), f(1024, 128),
                                    f(64, 128, 128, scale=0.01), f(64)],
           None, {}, 1e-4)
    yield ("sequence_mask_op", "sequence_mask_op", [i(1, 2049, tok)], None,
           {}, 0.0)
    yield ("number_count", "number_count",
           [i(0, T["experts"], tok, T["topk"])], None,
           dict(upper_range=T["experts"]), 0.0)
    yield "seed_op", "seed_op", [], None, dict(seed=1234), 0.0
    yield ("full_batch_size_like", "full_batch_size_like", [f(tok, 2)],
           None, dict(shape=[1, 1024], value=0.5), 0.0)
    b, t, d, k = T["row_conv"]
    x, fil = f(b, t, d), f(k, d, scale=0.1)
    yield ("row_conv", "row_conv", [x, fil], head(cr, x) + cpu(fil), {},
           F32)
    a, b = f(tok, h), f(tok, h)
    yield ("fused_elemwise_add_activation", "fused_elemwise_add_activation",
           [a, b], head(ct, a, b), {}, F32)
    cos = u(-1, 1, T["face_b"], T["classes"])
    lab = i(0, T["classes"], T["face_b"])
    yield ("margin_cross_entropy", "margin_cross_entropy", [cos, lab],
           None, dict(margin1=1.0, margin2=0.5, margin3=0.0, scale=64.0),
           1e-4)
    hb, ncls, hd = T["hsig"]
    yield ("hsigmoid_loss", "hsigmoid_loss",
           [f(hb, hd), i(0, ncls, hb), f(ncls - 1, hd, scale=0.05),
            f(ncls - 1, 1, scale=0.05)], None, dict(num_classes=ncls), 1e-4)
    x = f(tok, h)
    yield "share_data", "share_data", [x], head(ct, x), {}, 0.0
    db, dc, dh, dw, dk = T["deconv"]
    x, w, bias = f(db, dc, dh, dw), f(dc, 1, dk, dk, scale=0.1), f(dc)
    yield ("depthwise_conv2d_transpose", "depthwise_conv2d_transpose",
           [x, w, bias], head(2, x) + cpu(w, bias),
           dict(stride=[2, 2], padding=[1, 1]), 1e-4)
    # amp, the c_* ops
    xs = [f(tok, h, scale=1024.0) for _ in range(4)]
    bad = [v.clone() for v in xs]
    bad[2][7, 9] = float("inf")
    scale = torch.tensor([1024.0], device=CARD)
    yield ("check_finite_and_unscale_op", "check_finite_and_unscale_op",
           [bad, scale], head(ct, bad) + cpu(scale), {}, F32)
    state = [torch.tensor(True, device=CARD),
             torch.tensor([65536.0], device=CARD),
             torch.tensor([7], dtype=torch.int32, device=CARD),
             torch.tensor([1], dtype=torch.int32, device=CARD)]
    yield ("update_loss_scaling_op", "update_loss_scaling_op",
           [xs] + state, head(ct, xs) + cpu(*state), {}, 0.0)
    x = f(tok, h)
    yield "c_identity", "c_identity", [x], head(ct, x), {}, 0.0
    yield "c_concat", "c_concat", [x], head(ct, x), dict(nranks=2), 0.0
    half = T["vocab"] // 2
    yield ("c_embedding", "c_embedding",
           [bf(half, h, scale=0.02), i(0, T["vocab"], *T["ids"])], None,
           dict(start_index=half), BF)
    # the fused ops at Llama-3-8B's widths, bf16
    s, nh, ch = T["seq"], T["heads"], T["check_heads"]
    sc = bf(T["attn_b"], nh, s, s, scale=4.0)
    mask = torch.where(u(0, 1, T["attn_b"], 1, s, s) > 0.1, 0.0, -1e4).to(
        torch.bfloat16)
    yield ("fused_softmax_mask", "fused_softmax_mask", [sc, mask],
           cpu(sc[:1, :ch], mask[:1]), {}, BF)
    yield ("fused_softmax_mask_upper_triangle",
           "fused_softmax_mask_upper_triangle", [sc], cpu(sc[:1, :ch]), {},
           BF)
    x, w, bias = bf(tok, h), bf(h, inter, scale=0.02), bf(inter, scale=0.02)
    yield ("fused_gemm_epilogue", "fused_gemm_epilogue", [x, w, bias],
           head(ct, x) + cpu(w, bias), dict(activation="gelu"), BF)
    act = bf(tok, inter)
    yield ("fused_bias_act", "fused_bias_act", [act, bias],
           head(ct, act) + cpu(bias), dict(act_method="gelu"), BF)
    dout = bf(tok, inter, scale=0.01)
    dw0, db0 = f(h, inter, scale=1e-3), f(inter, scale=1e-3)
    yield ("fused_linear_param_grad_add", "fused_linear_param_grad_add",
           [x, dout, dw0, db0], head(ct, x, dout) + cpu(dw0, db0), {}, 1e-4)
    kvh, hdim = T["kv_heads"], T["head_dim"]
    q = bf(T["attn_b"], s, nh, hdim)
    k, v = (bf(T["attn_b"], s, kvh, hdim) for _ in "kv")
    yield ("memory_efficient_attention", "memory_efficient_attention",
           [q, k, v], cpu(q[:1, :, :ch], k[:1, :, :ch * kvh // nh],
                          v[:1, :, :ch * kvh // nh]), dict(is_causal=True),
           BF)
    # quantization
    a = f(*T["act"])
    amax = (a.abs().max() * 0.8).reshape(())
    yield ("fake_quantize", "fake_quantize", [a, amax],
           head(2, a) + cpu(amax), {}, F32)
    m, cm = T["int8_m"], T["int8_check_m"]
    xq = f(m, h)
    cols = torch.from_numpy(rng.choice(h, max(1, int(h * T[
        "outlier_share"])), replace=False)).to(CARD)
    xq[:, cols] = 6.5 + u(0, 1, m, len(cols))
    xq = xq.to(torch.bfloat16)
    wq = torch.randint(-127, 128, (h, inter), generator=g, device=CARD,
                       dtype=torch.int8)
    sq = u(1e-4, 1.1e-3, inter)
    yield ("llm_int8_linear", "llm_int8_linear", [xq, wq, None, sq],
           head(cm, xq) + cpu(wq, None, sq), {}, BF)


# the entries the reference differentiates (``ops.yaml``: no ``backward:
# none``)
TRANCHE3_GRAD = {
    "lrn", "fill_diagonal_tensor", "grad_add", "fc", "identity_loss",
    "shuffle_channel", "soft_relu", "partial_sum", "bilinear", "row_conv",
    "fused_elemwise_add_activation", "margin_cross_entropy",
    "hsigmoid_loss", "depthwise_conv2d_transpose", "c_identity", "c_concat",
    "c_embedding", "fused_softmax_mask", "fused_softmax_mask_upper_triangle",
    "fused_gemm_epilogue", "fused_bias_act", "memory_efficient_attention",
    "fake_quantize"}
TRANCHE3_HOST_OPS = {"sequence_mask_op", "seed_op"}
TRANCHE3_PLANTED_INF = {"check_finite_and_unscale_op"}   # an inf input


def tranche3_check(torch, k, seed, name, op, time_args, check_args, kw,
                   rel):
    """``op_check`` on ``check_args`` (card vs CPU, one backward where the
    reference has one); where the check ran on fewer rows, the card's ms
    of the full-size call instead, its outputs finite."""
    from paddle_tpu_torch.ops.dispatcher import call_op
    res = op_check(torch, "registry_tranche3", name, op,
                   time_args if check_args is None else check_args, kw,
                   rel, seed + k, grad=op in TRANCHE3_GRAD,
                   host=op in TRANCHE3_HOST_OPS)
    if check_args is None:
        return res
    card_in = [a.to(CARD) if torch.is_tensor(a) else a for a in time_args]
    out = call_op(op, *card_in, **kw)
    outs = out if isinstance(out, (list, tuple)) else [out]
    finite = op in TRANCHE3_PLANTED_INF or all(
        bool(torch.isfinite(o.float()).all()) for o in outs
        if torch.is_tensor(o) and o.is_floating_point())
    res.update(check_shape=res["shape"], shape=list(outs[0].shape),
               check_ms=res["ms"], finite=finite,
               ms=time_ms(torch, lambda: call_op(op, *card_in, **kw),
                          iters=5))
    if not finite:
        res["rel_err"] = float("inf")
    return res


def lars_over_resnet50(torch, seed):
    """``lars_momentum_op`` over ResNet-50's 161 parameter tensors (the
    zoo's shapes, float32): each tensor's update card vs CPU, and the
    card's ms for the 161 calls of one step."""
    from paddle_tpu_torch.ops.dispatcher import call_op
    from paddle_tpu_torch.vision import models
    shapes = on_cpu_too(torch, lambda: [
        tuple(p.shape) for p in models.resnet50().parameters()])
    rng = np.random.RandomState(seed + 31)
    lr = np.array([0.1], np.float32)
    sets = [[rng.randn(*s).astype(np.float32) * 0.05,
             rng.randn(*s).astype(np.float32) * 1e-3,
             rng.randn(*s).astype(np.float32) * 1e-3, lr] for s in shapes]
    kw = dict(mu=0.9, lars_coeff=0.001, lars_weight_decay=5e-4)
    worst = 0.0
    for args in sets:
        err, _, _, _ = card_vs_cpu(
            torch, "lars_momentum_op",
            lambda *a: call_op("lars_momentum_op", *a, **kw), args)
        worst = max(worst, err)
    card = [[torch.from_numpy(a).to(CARD) for a in s] for s in sets]

    def step():
        for a in card:
            call_op("lars_momentum_op", *a, **kw)
    return dict(op="lars_momentum_op", rel_err=worst,
                limit=TRANCHE3_F32, ms=time_ms(torch, step, iters=3),
                backward=False, shape=[len(shapes)],
                elements=int(sum(int(np.prod(s)) for s in shapes)))


def khop_sampler_check(torch, seed):
    """``graph_khop_sampler`` over ogbn-arxiv's graph from 1024 seeds at
    GraphSAGE's fanouts 25 / 10: the card's run against the CPU's from the
    same host draws (the port's seed set before each), exactly; every
    edge a graph edge between its local ids, the seeds first."""
    import paddle_tpu_torch
    from paddle_tpu_torch.ops.dispatcher import call_op
    rng = np.random.RandomState(seed + 32)
    src_np, dst_np = graph_edges(rng)
    order, colptr_np = graph_csc(src_np, dst_np)
    nodes = rng.choice(GRAPH_N, GRAPH_SEEDS, replace=False).astype(np.int64)
    args = [src_np[order], colptr_np, nodes, order.astype(np.int64)]
    kw = dict(sample_sizes=list(GRAPH_FANOUTS), return_eids=True)

    def run(dev):
        paddle_tpu_torch.seed(seed)
        ts = [torch.from_numpy(a).to(dev) for a in args]
        return call_op("graph_khop_sampler", *ts, **kw)
    t0 = time.perf_counter()
    card = run(CARD)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    cpu = run("cpu")
    errs = sum(int(not torch.equal(a.cpu(), b)) for a, b in zip(card, cpu))
    src, dst, out_nodes, reindex, eids = (t.cpu().numpy() for t in card)
    errs += int((src_np[eids] != out_nodes[src]).sum() +
                (dst_np[eids] != out_nodes[dst]).sum() +
                (out_nodes[:len(nodes)] != nodes).sum() +
                (reindex != np.arange(len(nodes))).sum())
    return dict(op="graph_khop_sampler", rel_err=float(errs), limit=0.0,
                ms=ms, backward=False, shape=[len(src)],
                nodes=len(out_nodes), on_card=card[0].is_cuda)


def dropout_attention_check(torch, seed):
    """``memory_efficient_attention`` with dropout 0.1 at Llama-3-8B's
    attention width, b 2 x 2048, causal: the same draws under the same
    seed (bit for bit), other draws than dropout 0's output, finite; ms."""
    import paddle_tpu_torch
    from paddle_tpu_torch.ops.dispatcher import call_op
    T = TRANCHE3
    g = torch.Generator(device=CARD).manual_seed(seed)
    s, b = T["seq"], T["attn_b"]
    q = torch.randn(b, s, T["heads"], T["head_dim"], generator=g,
                    device=CARD, dtype=torch.bfloat16)
    k, v = (torch.randn(b, s, T["kv_heads"], T["head_dim"], generator=g,
                        device=CARD, dtype=torch.bfloat16) for _ in "kv")

    def run():
        return call_op("memory_efficient_attention", q, k, v,
                       dropout_p=0.1, is_causal=True)
    paddle_tpu_torch.seed(seed)
    a = run()
    paddle_tpu_torch.seed(seed)
    same = torch.equal(a, run())
    plain = call_op("memory_efficient_attention", q, k, v, is_causal=True)
    ok = same and not torch.equal(a, plain) and bool(
        torch.isfinite(a.float()).all())
    return dict(op="memory_efficient_attention", rel_err=0.0 if ok
                else float("inf"), limit=0.0, backward=False,
                shape=list(a.shape), dropout=0.1, repeat_equal=same,
                ms=time_ms(torch, run, iters=5))


def int8_product_check(torch, seed):
    """``llm_int8_linear``'s int8 product at ``gate_proj``'s shape (m 512,
    k 4096, n 14336) on the card: its ``torch._int_mm`` route against the
    float64 product of the same int8 codes (exact: every partial sum is an
    integer below 2**53), element for element, and the ms of each."""
    from paddle_tpu_torch.ops.kernels.quant import _int8_product
    T = TRANCHE3
    g = torch.Generator(device=CARD).manual_seed(seed + 33)
    xq = torch.randint(-127, 128, (T["int8_m"], T["hidden"]), generator=g,
                       device=CARD, dtype=torch.int8)
    w = torch.randint(-127, 128, (T["hidden"], T["inter"]), generator=g,
                      device=CARD, dtype=torch.int8)
    got = _int8_product(xq, w)
    want = torch.matmul(xq.double(), w.double())
    mism = int((got.double() != want).sum())
    return dict(op="llm_int8_linear", rel_err=float(mism), limit=0.0,
                backward=False, shape=list(got.shape),
                dtype=str(got.dtype).replace("torch.", ""),
                ms=time_ms(torch, lambda: _int8_product(xq, w)),
                float64_ms=time_ms(torch, lambda: torch.matmul(
                    xq.double(), w.double()), iters=3),
                max_abs=float(want.abs().max()))


def tranche3_entries():
    """The 46 entries of this tranche, by the modules that hold them."""
    from paddle_tpu_torch.ops import dispatcher
    from paddle_tpu_torch.ops.kernels import compat_tranche
    misc = {"sgd_op", "momentum_op", "adam_op", "adamw_op", "adagrad_op",
            "adadelta_op", "adamax_op", "rmsprop_op", "lamb_op", "asgd_op",
            "rprop_op", "check_finite_and_unscale_op",
            "update_loss_scaling_op", "c_identity", "c_concat",
            "c_embedding", "fused_softmax_mask",
            "fused_softmax_mask_upper_triangle", "fused_gemm_epilogue",
            "fused_bias_act", "fused_linear_param_grad_add",
            "memory_efficient_attention"}
    return {n for n, k in dispatcher.KERNELS.items()
            if k.__module__ == compat_tranche.__name__} | misc | {
        "fake_quantize", "llm_int8_linear"}


def phase_registry_tranche3(torch, seed, report):
    """Every entry of the compat tranche, the single-device op forms of
    ``ops.yaml:577-620`` and the two quantization ops on the card at a size
    its users run (TRANCHE3), held to the CPU on the same inputs, one
    backward where the reference differentiates the entry, and the card's
    ms; none may launch a kernel of the fourteen."""
    from paddle_tpu_torch.core.device import set_device
    from paddle_tpu_torch.ops import kernels
    set_device(CARD)
    before = kernels.launch_counts()
    rng = np.random.RandomState(seed + 30)
    res = {}
    try:
        cases = itertools.chain(tranche3_opt_cases(torch, rng),
                                registry_tranche3_cases(torch, rng))
        for k, (name, op, targs, cargs, kw, rel) in enumerate(cases):
            t0 = time.perf_counter()
            res[name] = tranche3_check(torch, k, seed, name, op, targs,
                                       cargs, kw, rel)
            res[name]["wall_s"] = time.perf_counter() - t0
            free_card(torch)
        for name, fn in (("lars_momentum_op", lars_over_resnet50),
                         ("llm_int8_product", int8_product_check),
                         ("graph_khop_sampler", khop_sampler_check),
                         ("memory_efficient_attention_dropout",
                          dropout_attention_check)):
            t0 = time.perf_counter()
            res[name] = fn(torch, seed)
            res[name]["wall_s"] = time.perf_counter() - t0
            free_card(torch)
    finally:
        set_device(None)
    log(f"registry_tranche3: {json.dumps(res)}")
    launched = kernel_launch_delta(kernels, before)
    report["registry_tranche3"] = dict(ops=res, kernel_launches=launched)
    bad = {k: v for k, v in res.items() if not v["rel_err"] <= v["limit"]}
    if launched:
        bad["kernel_launches"] = launched
    if bad:
        raise AssertionError(f"registry_tranche3: card vs CPU beyond the "
                             f"limits: {bad}")
    entries = tranche3_entries()
    missed = entries - {v["op"] for v in res.values()}
    if missed or len(entries) != 46:
        raise AssertionError(f"registry_tranche3: entries not run: {missed} "
                             f"({len(entries)} of 46)")
    return dict(ops=res, kernel_launches=launched)


# QAT of ResNet-50: phase vision_resnet50's recipe with the reference's
# default QuantConfig; PTQ calibration batches; card-vs-CPU limits
QAT_STEPS = 12                  # 2 warm-up + 10 timed, eager
QAT_PLAIN_STEPS = 4             # the plain model's eager yardstick
QAT_CPU_ROWS = 4                # images of the card-vs-CPU checks
QAT_PTQ_BATCHES = 4
QAT_LAYER_REL = 1e-4            # a layer's output, same input and state
QAT_SCALE_REL = 1e-6            # an observer's scale after that layer
QAT_FIRST_LOSS_REL = 0.05       # end to end, 2.3x the worst of seeds 0-7
                                # (0.40-2.18%, tools/qat_ab.py; PERF.md)
QAT_PTQ_REL = 1e-4              # converted net's logits, card vs CPU


def qat_build(torch, seed):
    """``resnet_build`` (resnet50, 1000 classes, Momentum 0.9, lr 0.1, L2
    1e-4) with every Conv2D and the Linear swapped for its QAT wrapper
    under the default ``QuantConfig``: the optimizer keeps the same
    parameters, now under ``<name>.inner``."""
    from paddle_tpu_torch import quantization
    model, loss, opt = resnet_build(torch, seed, 50, 1000, 0.1, 1e-4)
    return quantization.QAT().quantize(model), loss, opt


def qat_layers(model):
    from paddle_tpu_torch import quantization as q
    return [m for m in model.modules()
            if isinstance(m, (q.QuantedConv2D, q.QuantedLinear))]


def _obs_state(obs):
    v = getattr(obs, "_max", getattr(obs, "_ema", None))
    return None if v is None else v.detach().cpu()


def _set_obs_state(obs, v):
    setattr(obs, "_max" if hasattr(obs, "_max") else "_ema", v)


def qat_vs_cpu(torch, seed, x, y):
    """The QAT model's first forward (train mode) on QAT_CPU_ROWS images
    on the card, each quantized layer held to the CPU's copy of it on the
    card's input and observer state (teacher-forced: output and the new
    scales), and the first loss end to end, card vs CPU."""
    from paddle_tpu_torch.core.device import set_device
    card, loss_fn, _ = qat_build(torch, seed)
    set_device("cpu")
    try:
        cpu, cpu_loss_fn, _ = qat_build(torch, seed)
    finally:
        set_device(None)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    seen = []

    def pre(mod, args):
        seen.append([mod, args[0].detach().cpu(),
                     _obs_state(mod.weight_quanter),
                     _obs_state(mod.act_quanter)])

    def post(mod, args, out):
        seen[-1].append(out.detach().cpu())
    layers_card = qat_layers(card)
    hooks = [h for m in layers_card for h in (
        m.register_forward_pre_hook(pre), m.register_forward_hook(post))]
    rows = QAT_CPU_ROWS
    with torch.no_grad():
        card_loss = float(loss_fn(card(x[:rows]), y[:rows]))
        for h in hooks:
            h.remove()
        cpu_loss = float(cpu_loss_fn(cpu(x[:rows].cpu()), y[:rows].cpu()))
        twin = dict(zip(map(id, layers_card), qat_layers(cpu)))
        out_err = scale_err = 0.0
        for mod, inp, w_state, a_state, out in seen:
            c = twin[id(mod)]
            _set_obs_state(c.weight_quanter, w_state)
            _set_obs_state(c.act_quanter, a_state)
            want = c(inp)
            out_err = max(out_err, rel_max(torch, out, want))
            for a, b in ((mod.weight_quanter, c.weight_quanter),
                         (mod.act_quanter, c.act_quanter)):
                scale_err = max(scale_err, rel_max(torch, a.scale(),
                                                   b.scale()))
    del card, cpu
    free_card(torch)
    return dict(rows=rows, layers=len(seen), layer_out_rel=out_err,
                layer_scale_rel=scale_err, card_loss=card_loss,
                cpu_loss=cpu_loss,
                first_loss_rel=abs(card_loss - cpu_loss) / abs(cpu_loss))


def ptq_vs_cpu(torch, seed, rng):
    """PTQ of resnet50 from the seed: calibration on QAT_PTQ_BATCHES
    batches of R50_B images on the card, ``convert``; the int8 weights and
    dequantization scales against a CPU copy converted from the same
    weights, and the converted net's eval logits on QAT_CPU_ROWS images,
    card vs CPU; the card's ms for the calibration and a predict batch."""
    import paddle_tpu_torch
    from paddle_tpu_torch import quantization as q
    from paddle_tpu_torch.core.device import set_device
    from paddle_tpu_torch.vision import models

    def build():
        paddle_tpu_torch.seed(seed)
        return models.resnet50().eval()
    card = q.PTQ().quantize(build())
    set_device("cpu")
    try:
        cpu = q.PTQ().quantize(build())
    finally:
        set_device(None)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    batches = [torch.from_numpy(rng.rand(R50_B, 3, R50_SIZE, R50_SIZE)
                                .astype(np.float32)).cuda()
               for _ in range(QAT_PTQ_BATCHES)]
    ptq = q.PTQ()
    with torch.no_grad():
        t0 = time.perf_counter()
        for xb in batches:
            card(xb)
        torch.cuda.synchronize()
        calib_s = time.perf_counter() - t0
        ptq.convert(card)
        ptq.convert(cpu)
        pairs = list(zip(qat_layers(card), qat_layers(cpu)))
        mism = sum(int((a.int8_weight.cpu() != b.int8_weight).sum())
                   for a, b in pairs)
        scale_err = max(abs(a.dequant_scale - b.dequant_scale)
                        / b.dequant_scale for a, b in pairs)
        xb = batches[0]
        got = card(xb[:QAT_CPU_ROWS])
        want = cpu(xb[:QAT_CPU_ROWS].cpu())
        predict_ms = time_ms(torch, lambda: card(xb), iters=3)
    res = dict(layers=len(pairs), int8_mismatches=mism,
               dequant_scale_rel=scale_err,
               logits_rel=rel_max(torch, got, want), calib_batches=len(
                   batches), calib_s=calib_s, predict_ms_b64=predict_ms)
    del card, cpu, batches
    free_card(torch)
    return res


def observer_capture_check(torch, seed, x, y):
    """A QAT model's ``TrainStep`` with step capture on: its first call
    probes the step, where the first observer raises the reference's
    error; nothing is captured."""
    from paddle_tpu_torch import flags, quantization
    from paddle_tpu_torch.jit import TrainStep
    model, loss_fn, opt = qat_build(torch, seed)
    flags.set_flags({"step_capture": True})
    step = TrainStep(model, loss_fn, opt)
    try:
        step((x[:2],), (y[:2],))
    except RuntimeError as e:
        msg = str(e)
    else:
        msg = None
    graphs = len(step.graphs()) if hasattr(step, "graphs") else 0
    del step, model, opt
    free_card(torch)
    return dict(raised=msg == quantization.OBSERVER_TRACED_MESSAGE,
                message=msg, graphs=graphs)


QAT_PARTS = (("optimizer", ("bucket_kernel",)),
             ("convolution", ("conv", "implicit", "xmma", "cudnn", "sm90",
                              "sm80", "gemm", "cutlass", "winograd",
                              "dgrad", "wgrad", "fprop")),
             ("abs-max reductions", ("MaxNanFunctor", "MaxOps",
                                     "MinNanFunctor", "MinOps")),
             ("other reductions", ("reduce_kernel",)))


def qat_step_parts(prof):
    """A profiled step's device ms by part: the fused optimizer, the
    convolutions (cuDNN / cuBLAS), the observers' abs-max reductions, the
    other reductions (BatchNorm's statistics and their gradients, the
    loss), and the elementwise work (fake quantization's divide / round /
    clamp / multiply and its gradient mask, BatchNorm's normalization,
    ReLU, the adds); with each part's three largest kernels."""
    kernels = prof.get("all_kernels") or {}
    parts = {name: 0.0 for name, _ in QAT_PARTS}
    parts["elementwise"] = 0.0
    top = {name: [] for name in parts}
    for k, ms in kernels.items():
        part = next((name for name, keys in QAT_PARTS
                     if any(s in k for s in keys)), "elementwise")
        parts[part] += ms
        top[part].append((ms, k[:80]))
    return dict(ms=parts, top={k: [n for _, n in sorted(v)[::-1][:3]]
                               for k, v in top.items()})


def qat_host_syncs(torch, train, x, y):
    """One more forward and backward of the trained QAT model under
    ``torch.cuda.set_sync_debug_mode("error")``: the fake quantization,
    the observers and the layers read nothing of the card on the host.
    Returns None, or what raised."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        train.loss_fn(train.model(x), y).backward()
    except RuntimeError as e:
        return str(e)[:400]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return None


def profiled_eager_step(torch, train, x, y):
    """One more step of ``train`` with step capture off, profiled."""
    from paddle_tpu_torch import flags
    flags.set_flags({"step_capture": False})
    try:
        return profile_call(torch, lambda: train((x,), (y,)), 1)
    finally:
        flags.set_flags({"step_capture": True})


def phase_quant_qat(torch, seed, report):
    """Quantization-aware training of resnet50() at 224 x 224, b 64, on the
    card, eagerly (observers refuse capture): vision_resnet50's recipe
    with the default QuantConfig (activations EMAObserver, weights
    AbsmaxObserver, 8 bits) over 53 Conv2D and one Linear; 12 steps,
    images/s, step p50/p99, peak, losses, the fused Momentum launches (1
    a step), a profiled step by part, a forward and backward with no host
    sync, its quantized layers card vs CPU;
    then PTQ (calibrate, convert, card vs CPU) and the observer's refusal
    inside a captured step."""
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        rng = np.random.RandomState(seed + 40)
        x = torch.from_numpy(rng.randn(R50_B, 3, R50_SIZE, R50_SIZE)
                             .astype(np.float32)).cuda()
        y = torch.from_numpy(rng.randint(0, 1000, R50_B)).cuda()
        from paddle_tpu_torch.optimizer import fused_counters
        # the plain model's eager step, the yardstick of the QAT step
        base, train = train_run(
            torch, lambda: resnet_build(torch, seed, 50, 1000, 0.1, 1e-4),
            (x,), (y,), QAT_PLAIN_STEPS, "images", R50_B, capture=False)
        base["step_parts_ms"] = qat_step_parts(profiled_eager_step(
            torch, train, x, y))
        del train
        free_card(torch)
        before = dict(fused_counters)
        run, train = train_run(torch, lambda: qat_build(torch, seed), (x,),
                               (y,), QAT_STEPS, "images", R50_B,
                               capture=False)
        run["fused_route"] = fused_route(before, fused_counters, QAT_STEPS)
        run["step_profile"] = profiled_eager_step(torch, train, x, y)
        run["host_sync"] = qat_host_syncs(torch, train, x, y)
        layers = qat_layers(train.model)
        run["quantized_layers"] = dict(
            conv2d=sum(type(m).__name__ == "QuantedConv2D" for m in layers),
            linear=sum(type(m).__name__ == "QuantedLinear" for m in layers))
        run["step_parts_ms"] = qat_step_parts(run["step_profile"])
        run["step_profile"] = {k: run["step_profile"].get(k) for k in (
            "device_busy_ms", "wall_ms", "busy_share_of_wall", "launches",
            "top", "not_measured")}
        run["mfu"] = vision_mfu(run, R50_MACS, R50_B, F32_FLOPS_PER_S)
        del train, layers
        free_card(torch)
        log(f"quant_qat: {json.dumps(run)}")
        res = dict(model="resnet50", batch=R50_B, steps=QAT_STEPS,
                   config="QuantConfig() (EMAObserver / AbsmaxObserver, 8 "
                          "bits)", run=run, plain_eager={
                       k: base[k] for k in ("images_per_s", "step_ms_p50",
                                            "losses", "step_parts_ms")})
        res["cpu_check"] = qat_vs_cpu(torch, seed, x, y)
        res["ptq"] = ptq_vs_cpu(torch, seed, rng)
        res["capture"] = observer_capture_check(torch, seed, x, y)
    finally:
        torch.backends.cudnn.deterministic = det
    log(f"quant_qat checks: {json.dumps({k: res[k] for k in ('cpu_check', 'ptq', 'capture')})}")
    report["quant_qat"] = res
    ls = run["losses"]
    c, p = res["cpu_check"], res["ptq"]
    bad = []
    if not all(np.isfinite(ls)) or len(ls) != QAT_STEPS or not all(
            np.isfinite(res["plain_eager"]["losses"])):
        bad.append(f"losses {ls}, plain {res['plain_eager']['losses']}")
    if run["fused_optimizer_launches"] != QAT_STEPS or not \
            run["fused_route"]["every_step_fused"]:
        bad.append(f"fused Momentum launches "
                   f"{run['fused_optimizer_launches']} in {QAT_STEPS} steps, "
                   f"route {run['fused_route']}")
    if run["host_sync"] is not None:
        bad.append(f"a QAT forward / backward synced: {run['host_sync']}")
    if run["quantized_layers"] != dict(conv2d=53, linear=1):
        bad.append(f"quantized layers {run['quantized_layers']}")
    if not (c["layer_out_rel"] <= QAT_LAYER_REL
            and c["layer_scale_rel"] <= QAT_SCALE_REL
            and c["first_loss_rel"] <= QAT_FIRST_LOSS_REL
            and c["layers"] == 54):
        bad.append(f"card vs CPU {c}")
    if not (p["int8_mismatches"] == 0 and p["dequant_scale_rel"] <= 1e-6
            and p["logits_rel"] <= QAT_PTQ_REL and p["layers"] == 54):
        bad.append(f"PTQ card vs CPU {p}")
    if not res["capture"]["raised"]:
        bad.append(f"observer under capture {res['capture']}")
    if bad:
        raise AssertionError(f"quant_qat: {'; '.join(bad)}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--report",
                    default=os.path.join("chiprun_out",
                                         "chip_smoke_report.json"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: nothing to drive", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import paddle_tpu_torch  # noqa: F401
        from paddle_tpu_torch.ops.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the paddle_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    report = {"card": card_line(), "torch": torch.__version__,
              "cuda": torch.version.cuda}
    log(f"card: {report['card']} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda})")
    report["build_s"] = _build.build_all()
    log(f"build: {report['build_s']:.1f} s (nvcc, sm_90a, one process per "
        f"source)")
    for stem in ("ragged_paged_attention", "paged_attention",
                 "flash_attention", "flash_varlen", "fused_optimizer",
                 "grouped_gemm", "weight_only_gemm", "bcsr_spmm"):
        txt = _build.ptxas_report(stem) or ""
        for line in txt.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas[{stem}]: {line.strip()}")
    report["ptxas_tc"] = [
        row for stem in ("flash_attention", "flash_varlen", "grouped_gemm",
                         "weight_only_gemm", "bcsr_spmm", "paged_attention",
                         "ragged_paged_attention")
        for row in ptxas_tc_kernels(_build.ptxas_report(stem) or "")]
    for row in report["ptxas_tc"]:
        log(f"ptxas[{row['kernel']}]: {row['registers']} registers, "
            f"{row.get('spill_stores')} B spill stores, "
            f"{row.get('spill_loads')} B spill loads, "
            f"{row['smem_bytes']} B shared memory")

    from paddle_tpu_torch.ops.kernels import fused_optimizer as fo
    report["unaligned_rows"], report["phase_s"] = {}, {}

    def checked(tag, phase, *a):
        """``phase(*a)``, timed, then the fused optimizer's scalar rows in
        the chunk tables the phase built: a training path has none."""
        before, t0 = fo.unaligned_rows, time.perf_counter()
        out = phase(*a)
        report["phase_s"][tag] = time.perf_counter() - t0
        n = report["unaligned_rows"][tag] = fo.unaligned_rows - before
        if n:
            raise AssertionError(f"{tag}: {n} chunk-table rows of the fused "
                                 f"optimizer are not aligned to its "
                                 f"vector accesses")
        return out

    sd = (torch, args.seed, report)
    kern = checked("kernels", phase_kernels, *sd)
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    flush = lambda: scratch.zero_()  # noqa: E731  (> 50 MB L2)
    flash = checked("flash", phase_flash, *sd, flush)
    varlen = checked("flash_varlen", phase_flash_varlen, *sd, flush)
    fused = checked("fused_optimizer", phase_fused_optimizer, *sd, flush)
    lamb = checked("lamb_optimizer", phase_lamb_optimizer, *sd, flush)
    gmm = checked("grouped_gemm", phase_grouped_gemm, *sd, flush)
    int4_gemm = checked("int4_gemm", phase_int4_gemm, *sd, flush)
    bcsr = checked("bcsr", phase_bcsr, *sd, flush)
    del scratch
    torch.cuda.empty_cache()
    main_res, outs_bf16 = checked("main", phase_main, *sd)
    torch.cuda.empty_cache()          # the serving model is gone
    int4 = checked("int4_serve", phase_int4_serve, *sd, outs_bf16)
    train = checked("train", phase_train, *sd)
    torch.cuda.empty_cache()          # the Llama training model is gone
    layers = checked("train_layers", phase_train_layers, *sd, train)
    free_card(torch)
    eager_surface = checked("eager_surface", phase_eager_surface, *sd)
    train_amp = checked("train_amp", phase_train_amp, *sd)
    edges = checked("capture", phase_capture, *sd)
    free_card(torch)
    checked("layer_net", phase_layer_net, *sd)
    free_card(torch)
    bert = checked("bert_squad", phase_bert_squad, *sd)
    free_card(torch)
    ocr = checked("ocr", phase_ocr, *sd)
    free_card(torch)
    vision = {"cifar": checked("vision_cifar", phase_vision_cifar, *sd)}
    free_card(torch)
    vision["resnet50"] = checked("vision_resnet50", phase_vision_resnet50,
                                 *sd)
    free_card(torch)
    vision["yolov3"] = checked("vision_yolov3", phase_vision_yolov3, *sd)
    free_card(torch)
    for tag, phase in (("vision_ops", phase_vision_ops),
                       ("audio_frontend", phase_audio_frontend),
                       ("linalg", phase_linalg), ("graph", phase_graph),
                       ("text_viterbi", phase_text_viterbi),
                       ("registry_tranche", phase_registry_tranche),
                       ("registry_tranche3", phase_registry_tranche3)):
        checked(tag, phase, *sd)
        free_card(torch)
    qat = checked("quant_qat", phase_quant_qat, *sd)
    free_card(torch)
    moe = checked("moe_train", phase_moe_train, *sd)
    torch.cuda.empty_cache()          # the MoE model is gone
    checked("routes", phase_routes, *sd)
    log(f"fused_optimizer unaligned_rows by phase: "
        f"{json.dumps(report['unaligned_rows'])}")
    report["holds"] = dict(runs=len(HOLDS), cycles=sum(HOLDS),
                           at_least=sum(h == HOLD_CYCLES for h in HOLDS))
    log(f"seconds by phase: {json.dumps(report['phase_s'])}; timed runs' "
        f"holds: {json.dumps(report['holds'])}")
    report["capture"] = dict(
        serving={**main_res["capture_vs_eager"],
                 "int4": int4["capture_vs_eager"]},
        train=train["capture_vs_eager"], moe=moe["capture_vs_eager"],
        grad_scaler=edges["grad_scaler"], item=edges["item"],
        fit=edges["fit"])
    log(f"capture: {json.dumps(report['capture'])}")

    entries = []
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    sources = {
        "ragged_paged_attention": (
            "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
            "paddle_tpu/ops/kernels/pallas/ragged_paged_attention.py:115"),
        "paged_attention": (
            "paddle_tpu_torch/csrc/paged_attention.cu",
            "paddle_tpu/ops/kernels/pallas/paged_attention.py:76"),
        "flash_attention_fwd": (
            "paddle_tpu_torch/csrc/flash_attention.cu",
            "paddle_tpu/ops/kernels/pallas/flash_attention.py:126"),
        "flash_attention_dq": (
            "paddle_tpu_torch/csrc/flash_attention.cu",
            "paddle_tpu/ops/kernels/pallas/flash_attention.py:264"),
        "flash_attention_dkv": (
            "paddle_tpu_torch/csrc/flash_attention.cu",
            "paddle_tpu/ops/kernels/pallas/flash_attention.py:283"),
        "flash_varlen_fwd": (
            "paddle_tpu_torch/csrc/flash_varlen.cu",
            "paddle_tpu/ops/kernels/pallas/flash_varlen.py:266"),
        "flash_varlen_dq": (
            "paddle_tpu_torch/csrc/flash_varlen.cu",
            "paddle_tpu/ops/kernels/pallas/flash_varlen.py:304"),
        "flash_varlen_dkv": (
            "paddle_tpu_torch/csrc/flash_varlen.cu",
            "paddle_tpu/ops/kernels/pallas/flash_varlen.py:331"),
        "fused_optimizer": (
            "paddle_tpu_torch/csrc/fused_optimizer.cu",
            "paddle_tpu/ops/kernels/pallas/fused_optimizer.py:279"),
        "grouped_gemm": (
            "paddle_tpu_torch/csrc/grouped_gemm.cu",
            "paddle_tpu/ops/kernels/pallas/grouped_gemm.py:109"),
        "weight_only_int4_gemm": (
            "paddle_tpu_torch/csrc/weight_only_gemm.cu",
            "paddle_tpu/ops/kernels/pallas/weight_only_gemm.py:105"),
        "fused_optimizer_lamb_moments": (
            "paddle_tpu_torch/csrc/fused_optimizer.cu",
            "paddle_tpu/ops/kernels/pallas/fused_optimizer.py:343"),
        "fused_optimizer_lamb_apply": (
            "paddle_tpu_torch/csrc/fused_optimizer.cu",
            "paddle_tpu/ops/kernels/pallas/fused_optimizer.py:357"),
        "bcsr_spmm": (
            "paddle_tpu_torch/csrc/bcsr_spmm.cu",
            "paddle_tpu/ops/kernels/pallas/bcsr_spmm.py:93")}
    per_kernel = {
        "ragged_paged_attention": kern["ragged_paged_attention"],
        "paged_attention": kern["paged_attention"],
        "flash_attention_fwd": {k: v["fwd"] for k, v in flash.items()},
        "flash_attention_dq": {k: v["dq"] for k, v in flash.items()},
        "flash_attention_dkv": {k: v["dkv"] for k, v in flash.items()},
        "flash_varlen_fwd": {k: varlen[k]["fwd"] for k in VARLEN_LABELS},
        "flash_varlen_dq": {k: varlen[k]["dq"] for k in VARLEN_LABELS},
        "flash_varlen_dkv": {k: varlen[k]["dkv"] for k in VARLEN_LABELS},
        "fused_optimizer": {"bfloat16": fused},
        "grouped_gemm": {k: gmm[k] for k in ("bfloat16", "float32")},
        "weight_only_int4_gemm": {k: int4_gemm[k]
                                  for k in ("bfloat16", "float32")},
        "fused_optimizer_lamb_moments": {"bfloat16": lamb["moments"]},
        "fused_optimizer_lamb_apply": {"bfloat16": lamb["apply"]},
        "bcsr_spmm": {k: bcsr[k] for k in ("bfloat16", "float32")}}
    # each path's launches: the serving kernels from the serving run, the
    # Llama training kernels from the Llama training run, the grouped GEMM
    # from the MoE training run, the int4 GEMM from the int4 serving run
    # (counts reset before each)
    launched = {name: main_res["launches"][name] for name in SERVING_KERNELS}
    launched.update({name: train["launches"][name]
                     for name in TRAINING_KERNELS})
    launched["grouped_gemm"] = moe["launches"]["grouped_gemm"]
    launched.update(varlen["launches"])
    launched["weight_only_int4_gemm"] = \
        int4["serve"]["launches"]["weight_only_int4_gemm"]
    launched.update({name: train["lamb"]["launches"][name]
                     for name in LAMB_KERNELS})
    launched["bcsr_spmm"] = bcsr["launches"]
    # the scheduled mixed-precision path's own launches (phase 5b)
    launched_amp = {name: train_amp["launches"][name]
                    for name in TRAINING_KERNELS}
    for name, per in per_kernel.items():
        head = per["bfloat16"]
        e = {"name": name, "route": "cuda", "source": sources[name][0],
             "replaces": sources[name][1], "launches": launched[name]}
        if name == "fused_optimizer":
            e["launches_bert"] = {
                k: v["fused_optimizer_launches"]
                for k, v in bert["runs"].items()}
            e["launches_ocr"] = {
                "crnn": ocr["crnn"]["runs"]["captured"][
                    "fused_optimizer_launches"],
                "dbnet": ocr["dbnet"]["run"]["fused_optimizer_launches"]}
            # the float32 buckets of those paths, held to the plain version
            e["vs_plain_bert"] = bert["optimizer_vs_plain"]
            e["vs_plain_crnn"] = ocr["crnn"]["optimizer_vs_plain"]
            # the vision trainings' Momentum: launches per run, the route,
            # the resnet18 bucket against the plain version, the rule's
            # time over ResNet-50's parameters
            e["launches_vision"] = {
                f"{m}_{k}": v["fused_optimizer_launches"]
                for m, r in vision.items() for k, v in r["runs"].items()}
            e["launches_vision"]["cifar_fit"] = \
                vision["cifar"]["fit"]["fused_optimizer_launches"]
            e["vs_plain_resnet18_momentum"] = \
                vision["cifar"]["runs"]["eager"]["optimizer_vs_plain"]
            e["momentum_resnet50"] = vision["resnet50"]["momentum_kernel"]
            e["launches_quant_qat"] = qat["run"]["fused_optimizer_launches"]
        if name in SERVING_KERNELS:
            e["launches_serve_gang"] = {
                kv: main_res["serve_gang"][kv]["launches"].get(name, 0)
                for kv in ("bf16", "int8")}
        if name in launched_amp:
            e["launches_train_amp"] = launched_amp[name]
            e["launches_eager_surface"] = eager_surface["launches"][name]
            e["launches_train_layers"] = {
                b: layers[b]["launches"][name] for b in LAYER_BUILDS}
        e.update({k: head[k] for k in keys})
        for extra in ("library_bf16_weight_ms", "planted_fault_max_abs_err",
                      "padded_flash_ms", "library_bsr_ms",
                      "library_bsr_error", "three_product_floor_ms"):
            if extra in head:
                e[extra] = head[extra]
        # other dtypes: their numbers, the dq floor, and their main-path
        # launches where the phase counts them per dtype (varlen)
        for label, v in per.items():
            if label != "bfloat16" and isinstance(v, dict) and "ms" in v:
                e[label] = {k: v[k] for k in keys + (
                    "three_product_floor_ms", "launches") if k in v}
        entries.append(e)
    report["total_s"] = time.perf_counter() - t_start
    try:
        os.makedirs(os.path.dirname(args.report) or ".", exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    except OSError as e:
        log(f"report not written: {e}")
    log(f"total: {report['total_s']:.1f} s")
    print(json.dumps({"kernels": entries}), flush=True)
    log(report["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
