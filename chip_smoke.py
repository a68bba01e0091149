#!/usr/bin/env python3
"""Run the PyTorch port's serving, training and int8 serving slices, its
convolutional path, its ImageNet zoo, its fault-tolerant training, its
sequence path, its text-matching path and its serving host (Cluster
Serving and the metrics plane) on one CUDA GPU and check them.

    python3 chip_smoke.py

Phases, each of which raises on failure (the process then exits non-zero
and prints no result):

1. card: a CUDA GPU must be visible; prints its name and power limit;
2. build: compiles every CUDA kernel from ``csrc/`` (one nvcc per
   source, all started together), prints ptxas's register report, checks
   with ``cuobjdump -sass`` that every convolution function of
   ``int8_conv`` issues s8 ``wgmma`` (GMMA of type S8), none issues IMMA
   and none spills, and that the tensor-core
   kernels issue ``wgmma`` (HGMMA) of their input types: bf16 and f16 in
   the int8 matmul, bf16, f16 and tf32 in the flash forward (in every
   function of its tensor-core bodies, only of the function's own type:
   tf32 in the f32 ones, bf16 in the bf16 ones, f16 in the f16 ones; the
   chunked body's ptxas registers and spills get a line of their own),
   bf16, f16 and tf32 in the flash backward: the 16-bit body at head dims
   64 and 128 only of its own type, the f32 body and the chunked body
   (which widens 16-bit inputs exactly to f32) tf32;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the main paths give it, with the tolerance stated: the
   flash-attention forward (serving in f32, on 3xTF32 tensor cores, and
   bf16 with the padding bias, bf16 at head dim 128 and with dropout 0.1
   and the (m, l) statistics, causal with ragged lengths in both types,
   and training with dropout 0.1 and the statistics), the flash-attention
   backward (f32 on the tf32 tensor cores; its error also relative to the
   largest gradient; and bf16 with dropout 0.1 at the same shape, the
   bf16 training path's, also within 1.6e-2 of each output's largest
   gradient), both at head dims 192, 256, 384 and 512 (the
   chunked tensor-core forward and backward, f32 as 3xTF32, the backward
   within 1e-5 of the largest gradient) and with segment ids (2-4 packed
   sequences a row), f32 and bf16, beside SDPA with the equivalent mask;
   the f16 forward and backward at the f16 training path's shape (head
   dim 64, dropout 0.1 with the statistics) and at head dims 128, 192 and
   96 (every 16-bit body; the 16-bit backward at 64 and 128 also within
   2e-3 of each output's largest gradient), beside SDPA on f16,
   fused Adam's ``fused_update`` over the BERT-base parameter tree (one launch,
   every output bit for bit the plain version's), and the softmax
   cross-entropy forward and
   backward at the classifier head (8, 2) and an LM head (4096, 30522)
   (there also f16 logits, beside ``F.cross_entropy`` on f16), and the
   weight-only int8 matmul at BERT-base's six Dense shapes for one 8 x 512
   micro-batch, f32, bf16 and f16 x at all six, its weights from
   ``quantize_params_for_plan(params, int8_serving())`` on the seeded
   tree; and ``int8_conv`` (the calibrated layers' int8 x int8
   convolution with its fused f32 epilogue, which replaces no TPU kernel)
   bit for bit its plain version (int32 matmuls on the host CPU: CUDA has
   none; then the plain epilogue) in its int32 mode and its fused mode
   (with and without bias, with ReLU) at each distinct conv shape of
   ResNet-50 at 32 images and at 1 image (the split-K shapes), its fc,
   BERT's calibrated head, one rank-1 atrous and one rank-3 case, beside
   cuDNN's f32 convolution and ``torch._int_mm`` over an im2col copy, a
   split-K call replayed twice from one graph; and ``quantize_act`` (the
   activation quantization before it) bit for bit its plain version at
   each input shape of ResNet-50 at 32 images, on inputs with exact .5
   ties and +-127.5, beside ``torch.quantize_per_tensor``.  Times each
   kernel through its Python wrapper, its plain version
   and one PyTorch library call computing the same function (the
   yardstick only; the port never calls it) with CUDA events over calls
   issued one by one, and for the tensor-core kernels also the same calls
   replayed from one CUDA graph (and so are the backward and Adam);
   computes each kernel's bound from this run's inputs (for f32 x in the
   int8 matmul and for the f32 flash kernels at head dims that are
   multiples of 64, that of their route: three bf16 or tf32 products a
   value on the tensor cores, with the f32 CUDA-core figure beside it);
4. serving slice: BERT-base at full width (vocab 30522, 12 blocks of
   hidden 768, 12 heads, intermediate 3072, sequence 512) with a
   Dense(2, softmax) head, as a 4-input Model served by
   ``InferenceModel`` with random weights from a seed.  It answers
   requests of 1, 3, 8 and 2 records and one bf16 request, checks the
   outputs, holds two requests against the same model run on the CPU, and
   checks from the launch counters that every attention call went through
   the kernel; then times the 8-record bf16 request five more times (every
   ``InferenceModel`` here and below replays one captured CUDA graph per
   bucket, captured by ``warmup`` with the requests' dtypes);
5. training slice: the BERT-base classifier (Dense(2) logits, hidden and
   attention dropout 0.1) through ``compile(Adam(2e-5),
   "sparse_categorical_crossentropy_from_logits", ["accuracy"])``, ``fit``
   for 5 steps at batch 8 x 512 and ``evaluate`` (the per-batch eval step,
   captured, held against the same loop with the step uncaptured: the
   results bit for bit, 12 flash forwards and one cross-entropy a batch
   under replay, as after the bf16 and f16 fine-tunes); checks finite
   losses,
   that every attention and loss call went through its kernel and Adam
   through one launch a step covering every f32 leaf of >= 128 elements,
   that the loss falls when one batch is repeated at a higher learning
   rate, and holds the step-1 loss and gradients against the same model
   run on the CPU (2 blocks at full width, batch 2, hidden dropout 0,
   attention dropout 0.1: the dropout hash is the same on both devices);
   then the same classifier fine-tuned in bf16 mixed precision through
   ``fit(plan=mixed_precision())`` for 5 steps on the same data: the same
   launch counts, every flash launch on bf16 q/k/v (recorded by a wrapper
   around the launch functions that still calls them), f32 masters and
   Adam moments, finite losses, step 1's loss within 5% of the f32 step's,
   a loss that falls on a repeated batch, ``evaluate`` under the plan,
   and step 1 at 2 blocks on the card against the CPU under the same plan
   (two controls refused); then the same under ``plan="dp+f16"`` (f16
   compute copies, no loss scaling): the same launch counts, every flash
   launch on f16 q/k/v, finite losses, step 1 within 5% of f32's,
   ``evaluate`` under the plan, and the 2-block step against the CPU with
   its dq-zeroed control refused; logs the f32, bf16 and f16 host-clock
   step times;
6. int8 serving slice: BERT-base served weight-only int8
   (``optimize("int8")``, the 4-input model) and calibrated int8
   (``optimize("int8", calibration_data=...)`` with 16 seeded records, a
   single-input BERT-base over token ids: calibration takes one input
   array, as in the reference, and only the head Dense is a target), each
   answering requests of 1, 3 and 8 records held against the f32 model;
   the calibrated request 0 is held against the same calibrated model on
   the CPU (its head Dense runs ``quantize_act`` and ``int8_conv``, a
   1x1 over the rows).  Then ``quantized_matmul`` over all 50 quantized
   Dense kernels of BERT-base (48 encoder, pooler, head) under
   ``compile_step(..., plan=with_kernels(int8_serving()))``, which must
   launch the int8 kernel exactly 50 times and agree with the plain
   version, and under a plan that picks ``"xla"`` for
   ``serving.int8_matmul``, which must launch it no time; then
   ``quantized_matmul`` once on a (B, L, K) x and once on a transposed
   view, one launch each; then times the kernel route on the device and
   splits it by shape;
7. head dims above 128, at full width: the BERT-base classifier with 4
   heads (head dim 192: the chunked tensor-core forward and backward)
   fine-tuned through ``fit`` for 3 steps at batch 8 x 512 (12
   forward and 12 backward flash launches a step), and BERT-base with 2
   heads (head dim 384) answering one 8-record request through
   ``InferenceModel`` (12 launches);
8. captured training: every ``fit`` above runs through the compile
   plane (step 1 eager and captured into a CUDA graph, later steps
   replayed; the launch counts above are the replays'). Here BERT-base at
   full width with dropout 0.1, in f32, bf16 (``mixed_precision()``) and
   f16 (``"dp+f16"``): 5 steps of ``Estimator.train_step`` called eagerly,
   twice (the two runs must agree on every leaf, or the phase names the
   leaves that differ and fails), against 5 steps through ``fit``:
   losses, parameters and Adam moments bit for bit; 5 more replayed steps
   launch 12 + 12 flash, 1 Adam and 1 + 1 cross-entropy kernels a step;
   then under ``ZOO_STEPS_PER_DISPATCH``'s K=4, after ``warmup``, 8 steps
   in two dispatches equal 8 steps at K=1.  Logs the host clock a step,
   eager and captured, and each capture's and kernel build's seconds
   (``compile_stats()``);
9. captured serving: BERT-base at full width served from captures in
   f32, bf16, weight-only and calibrated int8 at buckets 1, 2, 4 and 8,
   each request bit for bit the eager forward; four threads sending their
   own 8-record request 20 times each to one bucket, each answer its
   request's eager one; 12 flash launches a replayed micro-batch;
   ``KerasNet.predict`` at batch 8 bit for bit ``InferenceModel``'s
   answer and ``predict_classes`` its argmax.  Logs the memory reserved
   after the warmups, the host clock of the 1-, 3-, 8- and 2-record f32
   requests and the 8-record bf16 request, eager and replayed, and what
   a graph pool holds at 1, 8 and 64 records (pools of their own, and
   one shared pool captured largest first);
10. lenet: LeNet-5 (28x28x1, 10 classes) through ``compile("adam",
   ...)`` and ``fit`` at batch 128 on a synthetic task (class = the
   quadrant of the largest mean) until the training accuracy passes 0.8:
   one fused Adam launch a step over its five kernels; ``evaluate`` on a
   held-out set, ``predict``, ``save``/``load`` with equal predictions;
11. resnet50_training: ResNet-50 (224x224x3, 1000 classes, random
   weights from the seed) with ``ResNet.imagenet_optimizer(batch_size=64)``
   at batch 64, f32, bf16 (``mixed_precision()``) and f16 (``"dp+f16"``,
   no loss scaling): ``fit`` at K=1 bit for bit ``train_step`` called
   eagerly (twice: cuDNN runs deterministic algorithms), K=4 bit for bit
   K=1 (f32 and bf16; parameters, momentum, BatchNorm state, losses); a
   replayed step's host clock, device time, idle share, images/s and
   bound; f16: step 1's loss within 5% of f32's, masters, momentum and
   moving statistics f32; on a fixed batch (f32 and f16) the loss falls
   and each step's rate (read back from the fc kernel's change and
   momentum) is the schedule's on the host; ``evaluate`` (accuracy,
   top-5) through the captured eval step, bit for bit the uncaptured one;
12. resnet50_serving: the trained ResNet-50 (its moving statistics set to
   one batch's first) through ``InferenceModel`` in f32 and bf16 at 1, 8
   and 32 images: each replay bit for bit its eager forward, finite rows
   summing to 1, bf16 within 0.02 of f32; latency, device time, idle
   share, images/s and bound of each request.  Logs each new phase's
   seconds and the memory reserved between phases;
13. inception_v1: Inception-v1 (224x224x3, 1000 classes) trained with the
   reference's recipe (SGD 0.065, momentum 0.9, weight decay 1e-4,
   warmup then epoch decay) at batch 128 in f32 and bf16: ``fit`` at K=1
   bit for bit ``train_step`` called eagerly, K=4 bit for bit K=1, a
   replayed step's host clock, device time, idle share and bound; on a
   fixed batch the loss falls and each rate is the schedule's; the
   captured ``evaluate`` bit for bit the uncaptured one; then served at
   1, 8 and 32 images in f32 and bf16, each replay bit for bit its eager
   forward, bf16 within 0.3 of f32 by ``logit_gap``;
14. inception_v1_adam: the port twin of the reference's
   ``test_trains_on_tiny_task`` (Inception-v1 at 64x64x3, ``"adam"``):
   the training accuracy passes 0.8 with one fused Adam launch a step;
   fused Adam bit for bit ``adam_leaf_reference`` at the full-width
   model's leaf shapes;
15. mobilenet_v2: 4 steps of ``fit`` at batch 64 in f32 bit for bit
   ``train_step`` called eagerly, a replayed step's times, each distinct
   depthwise layer's forward and backward device time (cuDNN
   deterministic, replayed from a CUDA graph);
   served at 1, 8 and 32 images in f32 and bf16 as Inception-v1;
16. zoo_serving: AlexNet (227), VGG-16, VGG-19, SqueezeNet, DenseNet-121,
   DenseNet-161, MobileNet and Inception-v3 (299) at full width, each
   answering one replayed 8-image f32 request bit for bit its eager
   forward, finite rows summing to 1; logs each model's parameter count,
   request time and peak memory;
17. bert_adamw: the BERT-base classifier under the reference's BERT
   optimizer, ``AdamWeightDecay(lr=2e-5, warmup_portion=0.1, total=50)``,
   f32 at 8 x 512: 5 steps through ``fit`` bit for bit 5 eager
   ``train_step`` calls (twice), 12 + 12 flash and 1 + 1 cross-entropy
   launches a replayed step and no Adam launch, each step's rate read back
   from the classifier kernel against the schedule on the host, step 1 at
   2 blocks against the CPU;
18. optimizers: LeNet-5 at batch 128 under ``RMSprop``, ``Adagrad``,
   ``Adadelta`` and ``Adamax``: 4 captured steps bit for bit the eager
   ones, a loss that falls on a fixed batch; a binary LeNet-5 head
   evaluated with ``["auc", "mae", "mse"]`` through the captured eval
   step, bit for bit the uncaptured one; every loss of the table and its
   gradient against the CPU;
19. resnet50_int8: ResNet-50 (moving statistics from one batch) served in
   calibrated int8 (``optimize("int8", calibration_data=...)`` on 32
   seeded images) at 1, 8 and 32 images: each replay bit for bit its eager
   forward, 54 ``quantize_act`` and 54 ``int8_conv`` launches a
   micro-batch (53 convolutions, the fc), no float64 convolution or
   matmul, request 0 against the same ``Int8Model`` on the CPU, argmax
   agreement and logit gap against f32, each request's times beside
   f32's, bf16's and the bound;
20. zoo_int8: Inception-v1 and MobileNet-v2 calibrated the same way, one
   replayed 8-image request each (MobileNet-v2's depthwise convolutions
   stay float);
21. fault_tolerant_fit: BERT-base from ``DISK_2`` shards and ResNet-50
   from a PMEM set, each fit uninterrupted, resumed mid-epoch by a fresh
   model (the first leg's snapshots after its first mid-epoch one
   dropped), and retried after an injected fault, bit for bit alike;
22. text_classifier, the sequence path's main path: the TextClassifier
   at news20 width (LSTM encoder 256 over 500 tokens of width 200, a
   20,000-word trainable table, 20 classes) through ``compile("adam",
   "sparse_categorical_crossentropy", ["accuracy"])``: ``fit`` at batch
   128 in f32 and bf16 (``mixed_precision()``), each bit for bit
   ``train_step`` called eagerly (twice), a replayed epoch's host clock,
   device time, idle share, device time a timestep, kernels a step (from
   a ``torch.profiler`` trace of one replay, with the five largest) and
   bound, one Adam launch a step; bf16's step 1 within 5% of f32's; the
   captured ``evaluate`` bit for bit the uncaptured one; a loss that falls
   on a fixed batch; step 1 against the CPU (8 records, dropout 0);
   requests of 1, 8 and 32 records in f32 and bf16 through
   ``InferenceModel`` (replays bit for bit the eager forward, rows finite
   and summing to 1, bf16 by the logit gap); the GRU and CNN encoders (3
   steps, one 8-record request each) and a frozen pretrained table (one
   8-record request, the table in the model's state);
23. recommenders: NeuralCF at MovieLens-1M's counts (6,040 users, 3,952
   items, 5 rating classes) and WideAndDeep with the repo example's
   columns, each 5 captured steps at batch 256 bit for bit the eager ones
   with a replayed epoch's times; NeuralCF's captured ``evaluate``, a
   loss that falls on a fixed batch, step 1 against the CPU and
   ``recommend_for_user`` over every item (the CPU's best ten);
   WideAndDeep one replayed 8-row request;
24. moe_transformer: a GPT-style ``TransformerLayer`` at Switch-Base-8's
   widths (vocabulary 40,990, sequence 512, 12 blocks of hidden 768, 12
   heads, 8 experts of 3,072, top-2 routing, capacity factor 1.25; about
   513 M parameters) with a pooled Dense(2) head, dropout 0.1, through
   ``compile(Adam(2e-5), "sparse_categorical_crossentropy_from_logits")``:
   ``fit`` at batch 8 x 512 in f32 and bf16 (each bit for bit the eager
   steps; a replayed epoch's times and launches: 12 + 12 flash, 1 Adam,
   1 + 1 cross-entropy a step), bf16's step 1 within 5% of f32's, the
   state's aux loss and drop fraction; under each remat policy (None,
   "full", "dots", "attn") an eager forward and backward's peak memory
   and one captured plus one replayed step bit for bit ``remat=None``'s,
   with each policy's fit peak, device time and flash forwards (a
   recompute adds 12 a step); a loss that falls on a fixed batch; step 1
   at 2 blocks (batch 2, attention dropout 0.1) against the CPU;
25. text_matching, the text-matching path's main path: a seeded
   question/answer corpus (one positive answer among five a question, a
   vocabulary reaching 20,000 words) written as CSV and read back through
   ``TextSet.read_csv`` and ``read_relations_csv``, tokenized, normalized,
   indexed and shaped; ``from_relation_pairs`` feeds KNRM at the JAX
   package's defaults (vocabulary 20,000, width 300, 21 kernels; question
   10 and answer 40 tokens) through ``compile("adam", "rank_hinge")`` and
   ``fit`` at batch 200 for 5 steps, bit for bit ``train_step`` called
   eagerly (twice); a replayed epoch's host clock, device time, idle
   share, kernels, launches (one Adam a step) and bound (FLOPs and Adam's
   bytes); ``evaluate_ndcg`` (k = 3, 5) and ``evaluate_map`` over 40
   held-out groups; requests of 1, 8 and 32 pairs through
   ``InferenceModel`` (replays bit for bit the eager forward); a loss that
   falls on a fixed batch; step 1 against the CPU;
26. autograd: ``examples/autograd``'s ``custom.py`` (a ``Lambda`` in a
   ``Model``, a mean-absolute-error ``CustomLoss`` of ``AutoGrad`` ops)
   and ``customloss.py`` (a ``Lambda`` in a ``Sequential``, a torch
   ``CustomLoss``), and a graph adding a trainable, then a frozen,
   (128,) ``Parameter`` to a Dense(256 -> 128) output: each 5 captured
   steps at batch 32 bit for bit the eager ones, the frozen value
   unchanged, a replayed epoch's times and launches (the examples' leaves
   are below the fused Adam kernel's 128 elements: none; the graphs one a
   step), a loss that falls on a fixed batch, step 1 against the CPU, one
   8-record request;
27. tfpark_text: ``NER`` (9 tags), ``SequenceTagger`` (45 POS, 23 chunk
   tags) and ``IntentEntity`` (7 intents, 9 entity tags) at their defaults
   (sequence 64, words of 12 characters, 20,000 words, 100 characters),
   each 3 captured steps at batch 32 on one label or a list of two, bit
   for bit the eager ones, a replayed epoch's times, launches (one Adam a
   step) and bound, a loss that falls on a fixed batch, step 1 against the
   CPU, one 8-record request with each head's rows summing to 1;
28. cluster_serving, the serving host's main path: BERT-base f32 at
   full width over token ids alone (a Cluster Serving record is one
   array: the BERT layer's single-input form), saved with
   ``KerasNet.save`` and loaded by ``ClusterServingHelper``, 64 records
   from ``InputQueue`` served by ``ClusterServing.run`` at batch 8
   serially (the bucket captured inside ``run``), pipelined and in claim
   mode over one ``InMemoryBroker``, pipelined over a ``FileBroker`` and
   serially again; ResNet-50 in calibrated int8 passed as
   ``ClusterServing(model=...)``, 64 (224, 224, 3) records at batch 16,
   pipelined over a ``FileBroker``.  Every record answered once through
   ``OutputQueue.query``; classes equal to direct
   ``InferenceModel.predict``'s, probabilities bit for bit where the
   micro-batch took the same bucket; 12 flash forwards a BERT
   micro-batch, 54 ``int8_conv`` and ``quantize_act`` launches a ResNet
   one; records a second against direct ``predict``, enqueue-to-result
   p50 and p99, the idle share of a served window from a torch.profiler
   trace of one more run (BERT serial and pipelined, ResNet-50
   pipelined) and the host's time by stage; then the registry: one TYPE line a family, record counters
   equal to what was served and predicted, ``record_device_memory()``
   reporting one device, a ``MetricsServer`` on port 0 answering its
   endpoints;
29. instrumented_fit: BERT-base fine-tuned 8 captured steps at batch 8
   with the metrics plane on and off from one seed: the step and record
   counters and one flight record a dispatch, the trained parameters and
   Adam moments bit for bit alike, replayed epochs' host clock a step on
   and off, and the instruments' own host cost a dispatch;
30. tfpark_bert, tfpark's estimator plane's main path: BERT-base (f32,
   dropout 0.1, Adam) fine-tuned through ``TFEstimator.train`` as
   ``BERTSquad`` at 12 x 384 (20 steps, one epoch), then ``predict``
   (start and end rows summing to 1) and ``evaluate``; ``BERTNER`` at 8 x
   512 with 9 tags (10 steps) and its per-token accuracy;
   ``BERTClassifier`` at 32 x 128 (10 steps, no flash launch: the dense
   attention under 256 tokens), whose ``save_init_checkpoint``
   warm-starts a ``BERTSquad`` encoder with no leaf missed; 12 flash
   forwards with statistics and 12 backwards a step, one Adam a step, 12
   forwards a predict batch; the flash forward with dropout and
   statistics and the backward against their plain versions at 12 x 384
   and 8 x 512; each kind's step 1, loss and gradients, against the CPU
   (2 blocks, batch 2, hidden dropout 0, attention dropout 0.1 on the
   flash route); each epoch traced, read in a steady window (the card's
   clock, busy time and idle share, the host's dispatch cadence);
31. tfpark_gan: ``GANEstimator`` on a DCGAN-sized pair (28 x 28 x 1,
   64-d noise) at batch 64, 40 phase-steps (one captured step a phase,
   one Adam launch a phase-step), step 1 against the CPU, each group's
   Adam counting its own phases, 40 more replayed under a trace (the
   card's clock, busy time and idle share), ``generate`` from the
   checkpoint equal to ``generate`` in memory;
32. model_import, the importers' main path: the seeded ResNet-50 through
   ``export_onnx`` and ``Net.load_onnx``, a captured ``InferenceModel``
   request of 32 images whose logits are within 1e-4 of the native
   net's (of each row's range) and bit for bit its eager run, 3 Adam
   fine-tune steps; BVLC AlexNet's deploy prototxt with a seeded
   caffemodel through ``Net.load_caffe``, a captured predict of 32
   images of 227 x 227 whose logits are within 1e-4 of the CPU's, 2
   Adam fine-tune steps; a ``TorchNet`` in a ``Sequential``, its captured
   predict bit for bit its eager forward; ``TFNet``'s ``ImportError``
   without TensorFlow;
33. summary: ``phase seconds`` of every phase (each also logged as it
   ends), a ``kernels`` JSON line (the seven TPU kernels: the flash
   forward with its statistics, the TPU's ``attention_stats``, has a row
   of its own; and ``int8_conv`` and ``quantize_act``, which replace
   none; launches by path, the sequence, text-matching and Cluster
   Serving paths' included), then the result line ``{"ok": true,
   "device": {...}}`` last.

Needs one GPU, nvcc, and nothing from the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SEED = 20261016
SEQ = 512
BERT_BASE = dict(vocab=30522, hidden_size=768, n_block=12, n_head=12,
                 seq_len=SEQ, intermediate_size=3072, type_vocab=2)
REQUEST_SIZES = (1, 3, 8, 2)
CPU_CHECKED = (0, 3)          # requests held against the CPU run
F32_TOL = 1e-4                # kernel vs plain, f32 math on both sides
BF16_TOL = 2e-2               # bf16 kernel vs plain run in f32
# f16 kernel vs plain run in f32: f16 rounds P and the output to 11
# significant bits (a step of at most 2**-9 below 4) against bf16's 8
F16_TOL = 4e-3
CPU_TOL = 1e-4                # GPU vs CPU serving outputs (probabilities)
BF16_SERVE_TOL = 0.1          # bf16 vs f32 serving outputs (probabilities)
# backward kernel vs plain, relative to the largest gradient when that
# exceeds 1: both sum 512-long f32 products, in different orders
BWD_TOL = 2e-4
# the f32 backward on the tensor cores (3xTF32) vs plain, relative to each
# output's largest gradient
F32_BWD_TOL = 1e-5
ADAM_TOL = 1e-6               # relative to the leaf's largest value
XENT_TOL = 1e-5               # f32 sums over the vocab in different orders
# f16 logits: loss and lse as f32 (XENT_TOL); dx in f16, within a step of
# it (2**-11 relative below 1) of the plain version's f16 dx
XENT_F16_TOL = 2e-3
DROPOUT = 0.1
TRAIN_BATCH, TRAIN_STEPS = 8, 5
# the head dims of the kernel phase's extra cases; the full-width paths at
# head dims above 128: fine-tuning with 4 heads (D=192) and serving with 2
# (D=384)
NEW_HEAD_DIMS = (192, 256, 384, 512)
D192_HEADS, D192_STEPS = 4, 3
D384_HEADS, D384_RECORDS = 2, 8
# GPU vs CPU training step at 2 blocks: loss relative, gradients relative
# to each leaf's largest value (f32 on both sides; cuBLAS, MKL and the
# kernels sum in different orders)
TRAIN_CPU_TOL = 1e-3
# the bf16 training step on the GPU vs the CPU under the same plan (2
# blocks, batch 2), loss relative.  Gradients: each leaf's relative L2
# distance between the two devices' bf16 gradients within twice the CPU
# bf16 gradient's own distance from the f32 one, plus 1e-2.  Both round
# every stored activation and gradient to bf16 (2**-9 relative) from f32
# sums taken in different orders, so each lies about as far from the f32
# gradient as the other (independent errors: sqrt(2) times apart); bias
# and embedding gradients sum ~1,000 terms in bf16 and lie furthest
# (type_embed ~0.24 at this width on the CPU).  Two controls run each
# time and must fail the check: the card's step with the bf16 backward's
# dq zeroed, and with attention dropout off
BF16_TRAIN_CPU_TOL = 1e-2
# bf16 vs f32 step-1 loss: the reference's bound for a bf16 trajectory
# against the f32 one (tests/test_precision.py); the f16 phase is held to
# the same bound
BF16_F32_LOSS_TOL = 0.05
# the 16-bit backward at head dims 64 and 128 (16-bit wgmma, P t and dS
# rounded to the input type) vs its plain version on the same inputs,
# relative to each output's largest gradient, however small: four units of
# roundoff of the type, 8 (bf16) or 11 (f16) significant bits
# (tests/test_torch_bwd16_order.py)
BWD16_TOP_TOL = {"bfloat16": 4 * 2.0 ** -8, "float16": 4 * 2.0 ** -11}
# the f16 training step on the GPU vs the CPU under the same plan: the bf16
# rule (each leaf within twice the CPU f16 gradient's own distance from
# f32) with a floor of 2e-3, four f16 steps (2**-11 relative): a leaf whose
# CPU f16 gradient sits on the f32 one still differs from the card's by
# the rounding of sums taken in another order.  One control must fail it:
# the card's step with the f16 backward's dq zeroed
F16_GRAD_FLOOR = 2e-3
# the f16 flash cases of the kernel phase: the f16 training path's shape
# (head dim 64, dropout 0.1), head dim 128, one chunked head dim (192) and
# one off 64 (96, the CUDA-core bodies)
F16_FLASH_CASES = ((64, DROPOUT), (128, 0.0), (192, 0.0), (96, 0.0))
# int8 matmul vs its plain version, relative L2: f32 sums in another
# order; bf16 x is held against the plain version in f32, so the bf16
# rounding of the output (2**-9 relative) dominates
INT8_F32_TOL = 1e-5
INT8_BF16_TOL = 1e-2
# f16 x: W converted to f16 on chip, f16 products; the output's f16
# rounding (2**-12 relative) and the f32 accumulator kept over all of K
INT8_F16_TOL = 2e-3
# quantized_matmul on a (B, L, K) x and on a transposed view: one launch
# each, through the flattened (M, K) operand; (B, L) of x
INT8_ANY_X = (4, SEQ)
# int8 serving vs the f32 model (probabilities): each weight rounds by up
# to half a step of 1/127 of its column's largest magnitude, through 12
# blocks
INT8_SERVE_TOL = 0.05
# calibrated request on the GPU vs the same calibrated model on the CPU:
# one activation that rounds to the neighbouring int8 step moves a logit
# by act_scale x w_scale (~1e-4 here)
INT8_CPU_TOL = 1e-3
INT8_REQUESTS = (1, 3, 8)
N_CALIB = 16
# the quantized Dense kernels of the BERT-base classifier: 4 per block, the
# pooler and the head
DENSE_KERNELS = r"(qkv|proj|fc|out|pooler)_kernel$|^dense_0/kernel$"
KERNELS = ("flash_attention_fwd", "flash_attention_bwd", "fused_adam",
           "fused_softmax_xent", "int8_matmul", "int8_conv")
# the kernels on the integer tensor cores, and the functions of each that
# must issue s8 wgmma (GMMA of type S8 in SASS, IGMMA on Hopper) and no
# warp-level IMMA
S8_GMMA_FUNCTIONS = {"int8_conv": ("16int8_conv_kernel",)}
# the tensor-core kernels and the wgmma input types their machine code must
# show: the f32 flash bodies run tf32 (3xTF32), bf16 bf16, f16 f16 (the
# chunked backward widens 16-bit inputs to f32, exactly, and runs tf32)
TENSOR_CORE_KERNELS = {"int8_matmul": ("BF16", "F16"),
                       "flash_attention_fwd": ("BF16", "F16", "TF32"),
                       "flash_attention_bwd": ("BF16", "F16", "TF32")}
# kernel functions whose every wgmma must be of one input type, by the
# identifier (and template type) in their mangled names: the flash
# backward's f32 body at head dims 64 and 128 (bwd_kernel, f32 only) and
# its chunked body (every other multiple of 64, all input types) tf32, its
# 16-bit body at 64 and 128 (bwd16_kernel) bf16 and f16; the flash
# forward's f32 bodies (head dims 64 and 128, and the chunked body) tf32,
# its bf16 and f16 instances (the whole-tile body at 64 and 128, the
# chunked body) bf16 and f16; the int8 matmul's f16 instance f16 (W
# converted to f16) and its bf16 and f32 instances bf16.  An f16 function
# that issued a bf16 product would fail here.  The CUDA-core bodies
# (bwd_simt_kernel, flash_fwd_simt_kernel) take the head dims that are not
# multiples of 64
TF32_FUNCTIONS = {"flash_attention_bwd": ("10bwd_kernel",
                                          "15bwd_wide_kernel"),
                  "flash_attention_fwd": ("21flash_fwd_tf32_kernel",
                                          "21flash_fwd_wide_kernelIf")}
BF16_FUNCTIONS = {"flash_attention_fwd":
                  ("22flash_fwd_wgmma_kernelI13__nv_bfloat16",
                   "21flash_fwd_wide_kernelI13__nv_bfloat16"),
                  "flash_attention_bwd":
                  ("12bwd16_kernelI13__nv_bfloat16",),
                  "int8_matmul": ("18int8_matmul_kernelI13__nv_bfloat16",
                                  "18int8_matmul_kernelIf")}
F16_FUNCTIONS = {"flash_attention_fwd":
                 ("22flash_fwd_wgmma_kernelI6__half",
                  "21flash_fwd_wide_kernelI6__half"),
                 "flash_attention_bwd": ("12bwd16_kernelI6__half",),
                 "int8_matmul": ("18int8_matmul_kernelI6__half",)}
# the input-type suffixes of HGMMA in SASS; one with none of them takes
# f16 (the default type, which cuobjdump does not spell out).  ptxas adds
# a no-op HGMMA (destination RZ, predicate off) to some functions; it
# computes nothing and is left out
HGMMA_TYPES = ("TF32", "BF16", "E4M3", "E5M2", "S8", "U8")
HGMMA_NOOP = r"HGMMA\.\S+ RZ,"

# the chunked forward: its ptxas registers and spills get a line of their
# own
WIDE_FWD = "21flash_fwd_wide_kernel"
REPLACES = {
    "flash_attention_fwd":
        "analytics_zoo_tpu/ops/pallas/flash_attention.py:216",
    "attention_stats":
        "analytics_zoo_tpu/ops/pallas/flash_attention.py:182",
    "flash_attention_bwd":
        "analytics_zoo_tpu/ops/pallas/flash_attention.py:458",
    "fused_adam": "analytics_zoo_tpu/ops/pallas/fused_adam.py:109",
    "softmax_xent_fwd":
        "analytics_zoo_tpu/ops/pallas/fused_softmax_xent.py:159",
    "softmax_xent_bwd":
        "analytics_zoo_tpu/ops/pallas/fused_softmax_xent.py:192",
    "int8_matmul": "analytics_zoo_tpu/ops/pallas/int8_matmul.py:92",
    # no TPU kernel: the reference's calibrated conv is a lax convolution
    # with int32 accumulation, which PyTorch has no CUDA op for, and its
    # activation quantization is jnp
    "int8_conv": "none (no pl.pallas_call: the reference's _int8_conv, "
                 "analytics_zoo_tpu/pipeline/inference/quantize.py:282, "
                 "is lax.conv_general_dilated with int32 sums)",
    "quantize_act": "none (no pl.pallas_call: the reference's "
                    "_quantize_act, analytics_zoo_tpu/pipeline/inference/"
                    "quantize.py:263, is jnp)",
}
# Published H100 SXM peaks (dense): HBM bytes/s and FLOP/s per input type
# (f32 outside the tensor cores; tf32, bf16 and f16 on them).
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "tfloat32": 494.7e12, "bfloat16": 989e12,
              "float16": 989e12, "int8": 1979e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA GPU is visible")
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(line)
    return line


def build_kernels() -> None:
    from analytics_zoo_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    report = build.build(KERNELS)
    log(f"build: {time.perf_counter() - t0:.1f} s for {sorted(report)}")
    for name, r in report.items():
        rows = ptxas_report(r["log"])
        for fn, regs, spilled in rows:
            log(f"  {name}: {fn}: {regs} registers, {spilled} bytes spilled")
        wide = [(regs, spilled) for fn, regs, spilled in rows
                if WIDE_FWD in fn]
        if wide:
            log(f"ptxas {name} flash_fwd_wide_kernel: {len(wide)} "
                f"instances, registers {min(w[0] for w in wide)}-"
                f"{max(w[0] for w in wide)}, most bytes spilled "
                f"{max(w[1] for w in wide)}")
    # the tensor-core kernels must issue wgmma: HGMMA in their machine code
    from pathlib import Path

    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    for name, types in TENSOR_CORE_KERNELS.items():
        sass = subprocess.run([str(cuobjdump), "-sass",
                               str(build.library_path(name))], check=True,
                              capture_output=True, text=True).stdout
        hgmma = [ln.strip() for ln in sass.splitlines() if "HGMMA" in ln
                 and hgmma_type(ln)]
        by_type = {t: [ln for ln in hgmma if hgmma_type(ln) == t]
                   for t in types}
        log(f"sass {name}: {len(hgmma)} HGMMA instructions; "
            + "; ".join(f"{t} {len(v)}, e.g. {v[0] if v else '-'}"
                        for t, v in by_type.items()))
        missing = [t for t, v in by_type.items() if not v]
        if missing:
            raise AssertionError(f"{name} issues no {missing} wgmma "
                                 "(no HGMMA of that type)")
        check_functions(name, sass, TF32_FUNCTIONS, "TF32")
        check_functions(name, sass, BF16_FUNCTIONS, "BF16")
        check_functions(name, sass, F16_FUNCTIONS, "F16")
    # the int8 kernels' convolution functions must issue s8 wgmma, none
    # of their functions IMMA, and nothing may spill
    for name, parts in S8_GMMA_FUNCTIONS.items():
        sass = subprocess.run([str(cuobjdump), "-sass",
                               str(build.library_path(name))], check=True,
                              capture_output=True, text=True).stdout
        counts, imma = {}, 0
        for block in sass.split("Function : ")[1:]:
            fn, _, body = block.partition("\n")
            lines = body.splitlines()
            imma += sum("IMMA" in ln for ln in lines)
            if any(part in fn for part in parts):
                counts[fn.strip()] = sum(
                    "GMMA" in ln and ".S8" in ln for ln in lines)
        s8 = [ln.strip() for ln in sass.splitlines()
              if "GMMA" in ln and ".S8" in ln]
        spilled = {fn: sp for fn, _, sp in ptxas_report(
            report[name]["log"])} if name in report else {}
        log(f"sass {name}: {len(s8)} s8 GMMA instructions in {len(counts)} "
            f"convolution functions {sorted(counts.values())}, e.g. "
            f"{s8[0] if s8 else '-'}; IMMA {imma}; bytes spilled "
            f"{sorted(spilled.values())}")
        if not counts or not all(counts.values()) or imma \
                or any(spilled.values()):
            raise AssertionError(f"{name}: a convolution function issues no "
                                 f"s8 wgmma, or IMMA remains ({imma}), or a "
                                 f"function spills: {counts} {spilled}")


def hgmma_type(line: str):
    """The input type of one HGMMA line of ``cuobjdump -sass``: its type
    suffix, or F16 where it has none of HGMMA_TYPES; None for a no-op."""
    import re

    if re.search(HGMMA_NOOP, line):
        return None
    return next((t for t in HGMMA_TYPES if f".{t}" in line), "F16")


def ptxas_report(text: str) -> list:
    """(kernel function, registers, spill store and load bytes) of each
    kernel function in ``ptxas -v`` output."""
    import re

    rows, fn, spilled = [], None, 0
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spilled = int(m.group(1)) + int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn:
            rows.append((fn, int(m.group(1)), spilled))
            fn = None
    return rows


def check_functions(name: str, sass: str, table: dict, kind: str) -> None:
    """Every kernel function of ``table[name]`` in the library's
    ``cuobjdump -sass`` listing issues HGMMA of input type ``kind`` (TF32,
    BF16 or F16) and none of another type (no-ops aside), and each named
    body has at least one function."""
    parts = table.get(name, ())
    functions = {}
    for block in sass.split("Function : ")[1:]:
        fn, _, body = block.partition("\n")
        kinds = [hgmma_type(ln) for ln in body.splitlines() if "HGMMA" in ln]
        functions[fn.strip()] = (kinds.count(kind), sum(
            k not in (kind, None) for k in kinds), kinds.count(None))
    for part in parts:
        mine = {fn: v for fn, v in functions.items() if part in fn}
        log(f"sass {name} {part}: {len(mine)} functions, {kind} HGMMA "
            f"{sorted(n for n, _, _ in mine.values())}, of another type "
            f"{sum(o for _, o, _ in mine.values())}, no-ops "
            f"{sum(z for _, _, z in mine.values())}")
        if not mine or not all(n and not o for n, o, _ in mine.values()):
            raise AssertionError(f"{name}: a {part} function issues no "
                                 f"{kind} wgmma, or one of another type: "
                                 f"{mine}")


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn`` over ``reps`` runs, after warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def padding_bias(b: int, lk: int, gen: np.random.Generator):
    """(B, 1, 1, Lk) BERT mask bias, made as the BERT layer makes it; the
    last row is fully masked, like a bucket's zero padding record."""
    lengths = gen.integers(64, lk + 1, b)
    keep = (np.arange(lk)[None, :] < lengths[:, None]).astype(np.float32)
    keep[-1] = 0.0
    return ((1.0 - keep) * np.finfo(np.float32).min)[:, None, None, :]


def attention_inputs(b, h, lq, lk, d, gen, device):
    """q, k, v as split_heads views of fused projections, as the model
    hands them to the kernel (non-contiguous rows)."""
    import torch

    def heads(n):
        x = torch.from_numpy(gen.normal(size=(b, n, 3 * h * d)).astype(
            np.float32)).to(device)
        return [t.reshape(b, n, h, d).transpose(1, 2)
                for t in torch.chunk(x, 3, dim=-1)]

    q = heads(lq)[0]
    _, k, v = heads(lk)
    return q, k, v


def kernel_phase(dev) -> dict:
    import torch
    import torch.nn.functional as F

    from analytics_zoo_tpu_torch.ops.cuda import flash_attention as fa

    gen = np.random.default_rng(SEED)
    b, h, l, d = 8, 12, SEQ, 64
    q, k, v = attention_inputs(b, h, l, l, d, gen, dev)
    bias_np = padding_bias(b, l, gen)
    bias = torch.from_numpy(bias_np).to(dev)
    scale = 1.0 / np.sqrt(d)
    live_keys = int((bias_np[:, 0, 0, :] == 0).sum())  # summed over batch
    entry = {"name": "flash_attention_fwd", "route": "cuda",
             "source": "analytics_zoo_tpu_torch/csrc/flash_attention_fwd.cu",
             "replaces": "analytics_zoo_tpu/ops/pallas/flash_attention.py"
                         ":216"}
    per_dtype = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        qq, kk, vv = (t.to(dtype) for t in (q, k, v))
        got = fa.flash_attention(qq, kk, vv, False, scale, bias=bias)
        want = fa.attention_reference(qq.float(), kk.float(), vv.float(),
                                      False, scale, bias=bias)
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        log(f"kernel {name} B={b} H={h} L={l} D={d} padded bias: "
            f"max|d| {err:.3e} (tol {tol:g}); fully masked row max "
            f"{got[-1].float().abs().max().item():.1e}")
        if not err <= tol or not torch.isfinite(got.float()).all():
            raise AssertionError(f"flash kernel {name} disagrees: {err}")
        if got[-1].float().abs().max().item() != 0.0:
            raise AssertionError("fully masked row is not zero")
        lib_bias = bias.to(dtype)
        times = graph_timed(
            lambda: fa.flash_attention(qq, kk, vv, False, scale, bias=bias),
            lambda: fa.attention_reference(qq, kk, vv, False, scale,
                                           bias=bias),
            lambda: F.scaled_dot_product_attention(
                qq, kk, vv, attn_mask=lib_bias, scale=scale))
        # least time for the same work: q, k, v, out and the bias moved
        # once; the two products over the (query, live key) pairs only
        nbytes = 4 * b * h * l * d * qq.element_size() + bias.numel() * 4
        flops = 4.0 * h * l * live_keys * d
        per_dtype[name] = dict(times, max_abs_err=err,
                               **route_bound(nbytes, flops, name, d))
        log(f"kernel {name}: {fmt_row(per_dtype[name])} ({nbytes / 1e6:.1f}"
            f" MB, {flops / 1e9:.2f} GFLOP)")

    # bf16 at head dim 128 (hidden 768 as 6 heads), padding bias
    q8, k8, v8 = (t.to(torch.bfloat16) for t in
                  attention_inputs(b, 6, l, l, 128, gen, dev))
    per_dtype["bf16_d128"] = flash_bf16_case(
        "bf16 D=128", q8, k8, v8, bias, 1.0 / np.sqrt(128), live_keys)
    # bf16 with dropout 0.1 and the (m, l) statistics, BERT-base shape
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    per_dtype["bf16_dropout_stats"] = flash_bf16_case(
        f"bf16 dropout {DROPOUT} + stats", qb, kb, vb, bias, scale,
        live_keys, dropout=DROPOUT)

    # end-aligned causal with lq != lk and a ragged lk, both dtypes
    qc, kc, vc = attention_inputs(2, h, 448, 500, d, gen, dev)
    causal_err = 0.0
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        qq, kk, vv = (t.to(dtype) for t in (qc, kc, vc))
        got = fa.flash_attention(qq, kk, vv, True, scale)
        want = fa.attention_reference(qq.float(), kk.float(), vv.float(),
                                      True, scale)
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        log(f"kernel causal lq=448 lk=500 {dtype}: max|d| {err:.3e} "
            f"(tol {tol:g})")
        if not err <= tol:
            raise AssertionError(f"causal flash kernel disagrees: {err}")
        if dtype == torch.float32:
            causal_err = err
    entry.update(per_dtype["float32"])
    entry["max_abs_err"] = max(per_dtype["float32"]["max_abs_err"],
                               causal_err)
    entry["bf16"] = per_dtype["bfloat16"]
    entry["bf16_d128"] = per_dtype["bf16_d128"]
    entry["bf16_dropout_stats"] = per_dtype["bf16_dropout_stats"]
    return entry


def flash_bf16_case(label, q, k, v, bias, scale, live_keys,
                    dropout=0.0) -> dict:
    """One bf16 flash-forward case against the plain version run in f32
    (out, and with dropout also m and l, within BF16_TOL; the fully masked
    last record exactly zero), timed beside the plain version and SDPA."""
    import torch
    import torch.nn.functional as F

    from analytics_zoo_tpu_torch.ops.cuda import flash_attention as fa

    b, h, l, d = q.shape
    seed = (0x2545F491, 0x9E3779B9) if dropout else None
    stats = dropout > 0.0
    got, m, lsum = fa._flash_cuda(q, k, v, False, scale, bias, dropout,
                                  seed, stats=stats)
    want, w_m, w_l = fa.attention_reference(
        q.float(), k.float(), v.float(), False, scale, bias, dropout, seed,
        True)
    torch.cuda.synchronize()
    errs = [(got.float() - want).abs().max().item()]
    if stats:
        errs += [(m - w_m).abs().max().item(),
                 ((lsum - w_l).abs() / w_l.abs().clamp_min(1.0)).max().item()]
    masked = got[-1].float().abs().max().item()
    log(f"kernel {label} B={b} H={h} L={l} D={d} padded bias: max|d| "
        + ", ".join(f"{e:.3e}" for e in errs)
        + f" (out{', m, l rel' if stats else ''}; tol {BF16_TOL:g}); fully "
        f"masked row max {masked:.1e}")
    if not max(errs) <= BF16_TOL or masked != 0.0 \
            or not torch.isfinite(got.float()).all():
        raise AssertionError(f"flash kernel {label} disagrees: {errs}")
    lib_q, lib_k, lib_v = (t.contiguous() for t in (q, k, v))
    lib_bias = bias.to(torch.bfloat16)
    row = graph_timed(
        lambda: fa._flash_cuda(q, k, v, False, scale, bias, dropout, seed,
                               stats=stats),
        lambda: fa.attention_reference(q, k, v, False, scale, bias, dropout,
                                       seed, stats),
        lambda: F.scaled_dot_product_attention(
            lib_q, lib_k, lib_v, attn_mask=lib_bias, dropout_p=dropout,
            scale=scale))
    nbytes = 4 * b * h * l * d * 2 + bias.numel() * 4 \
        + (2 * b * h * l * 4 if stats else 0)
    row.update(bound(nbytes, 4.0 * h * l * live_keys * d, "bfloat16"))
    row["max_abs_err"] = max(errs)
    log(f"kernel {label}: {row['ms']:.4f} ms (graph {row['graph_ms']:.4f}), "
        f"plain {row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms "
        f"(graph {row['library_graph_ms']:.4f}), bound {row['bound_ms']:.4f}"
        f" ms ({row['bound_by']})")
    return row


def graph_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn`` over ``reps`` runs captured in one CUDA
    graph and replayed: the launches without the host's Python between
    them, which at these sizes can take longer than a kernel."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    return ms


def timed(fn, plain, library) -> dict:
    """CUDA-event times of calls issued one by one: the kernel through its
    Python wrapper (``ms``), its plain version and the library call."""
    return {"ms": cuda_ms(fn), "plain_ms": cuda_ms(plain),
            "library_ms": None if library is None else cuda_ms(library)}


def graph_timed(fn, plain, library) -> dict:
    """``timed``, and beside it the device times of the same three calls
    replayed from one CUDA graph each (``graph_ms``, ``plain_graph_ms``,
    ``library_graph_ms``), which leave out the host time between calls."""
    row = timed(fn, plain, library)
    row.update(graph_ms=graph_ms(fn), plain_graph_ms=graph_ms(plain),
               library_graph_ms=None if library is None
               else graph_ms(library))
    return row


def library_call(make):
    """``make()``'s library call, or None where the library does not take
    these inputs (SDPA's kernels at some head dims): the yardstick is then
    "none".  ``make`` builds the call and runs it once."""
    import torch

    try:
        call = make()
        call()
        torch.cuda.synchronize()
        return call
    except RuntimeError as e:
        log(f"  library call: none ({str(e).splitlines()[0][:100]})")
        return None


def route_bound(nbytes: float, flops: float, dtype: str, d: int) -> dict:
    """The bound of the flash route the kernel takes: the f32 tensor-core
    bodies (forward and backward at every multiple of 64) count three tf32
    products a value, with the f32 CUDA-core figure beside
    (``bound_cuda_core_ms``); bf16 counts at the bf16 tensor-core rate, an
    f32 CUDA-core body at the f32 rate."""
    if dtype == "float32" and d % 64 == 0:
        row = bound(nbytes, 3 * flops, "tfloat32")
        row["bound_cuda_core_ms"] = bound(nbytes, flops)["bound_ms"]
        return row
    return bound(nbytes, flops, dtype)


def fmt_row(row: dict) -> str:
    """A timed row: kernel, plain and library ms (eager, and graph where
    timed), and the bound."""
    def ms(x):
        return "none" if x is None else f"{x:.4f}"

    def pair(key, lib=False):
        graph = "library_graph_ms" if lib else key.replace("ms", "graph_ms")
        return (f"{ms(row[key])}" + (f" (graph {ms(row[graph])})"
                                     if graph in row else ""))

    cc = (f"; f32 on CUDA cores {row['bound_cuda_core_ms']:.4f}"
          if "bound_cuda_core_ms" in row else "")
    return (f"{pair('ms')} ms, plain {pair('plain_ms')}, library "
            f"{pair('library_ms', True)}, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}{cc})")


def bound(nbytes: float, flops: float, dtype: str = "float32") -> dict:
    """The least time for the work: bytes at the HBM rate, operations at
    the input type's peak; the larger one bounds."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def rel_err(got, want) -> float:
    """max |got - want| over max(1, max |want|)."""
    return ((got.float() - want.float()).abs().max()
            / max(1.0, want.float().abs().max().item())).item()


def top_err(got, want) -> float:
    """max |got - want| over max |want|: relative to the largest gradient
    however small it is (``rel_err`` holds gradients below 1 to an
    absolute bound)."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def sdpa_backward(q, k, v, g, bias, scale):
    """One PyTorch call for SDPA's backward on these inputs: the backward op
    of the memory-efficient attention kernel (SDPA's choice for f32 with a
    float mask), fed its own forward's outputs; no dropout.  Unlike
    ``torch.autograd.grad``, a CUDA graph can capture it."""
    import torch

    q, k, v = (t.detach().contiguous() for t in (q, k, v))
    mask = bias.to(q.dtype).expand(q.shape[0], q.shape[1], q.shape[2],
                                   k.shape[2])
    out, lse, seed, offset = \
        torch.ops.aten._scaled_dot_product_efficient_attention(
            q, k, v, mask, True, 0.0, False, scale=scale)
    g = g.to(q.dtype).contiguous()

    def call():
        return torch.ops.aten._scaled_dot_product_efficient_attention_backward(
            g, q, k, v, mask, out, lse, seed, offset, 0.0,
            [True, True, True, False], False, scale=scale)

    return call


def flash_train_check(b: int, l: int, dev, gen) -> dict:
    """The flash forward with dropout DROPOUT and its (m, l) statistics,
    then the backward, f32 at (b, 12, l, 64) with the padding bias, each
    held against its plain version on the same inputs: the forward's
    output and m within F32_TOL, l relative; each gradient within BWD_TOL
    relative; the fully masked row all zeros.  Raises where one
    disagrees.  Returns the inputs, the forward's outputs and the
    errors."""
    import torch

    from analytics_zoo_tpu_torch.ops.cuda import flash_attention as fa

    h, d = 12, 64
    q, k, v = attention_inputs(b, h, l, l, d, gen, dev)
    g = torch.from_numpy(gen.normal(size=(b, h, l, d)).astype(np.float32)
                         ).to(dev)
    bias_np = padding_bias(b, l, gen)
    bias = torch.from_numpy(bias_np).to(dev)
    scale = 1.0 / np.sqrt(d)
    seed = (0x2545F491, 0x9E3779B9)

    out, m, lsum = fa._flash_cuda(q, k, v, False, scale, bias, DROPOUT,
                                  seed, stats=True)
    w_out, w_m, w_l = fa.attention_reference(q, k, v, False, scale, bias,
                                             DROPOUT, seed, True)
    torch.cuda.synchronize()
    errs = [(out - w_out).abs().max().item(),
            (m - w_m).abs().max().item(),
            ((lsum - w_l).abs() / w_l.abs().clamp_min(1.0)).max().item()]
    log(f"kernel fwd train B={b} H={h} L={l} D={d} (dropout {DROPOUT}, "
        f"stats): max|d| out {errs[0]:.3e}, m {errs[1]:.3e}, l (rel) "
        f"{errs[2]:.3e} (tol {F32_TOL:g}); fully masked row max "
        f"{out[-1].abs().max().item():.1e}")
    if not max(errs) <= F32_TOL or out[-1].abs().max().item() != 0.0:
        raise AssertionError(f"flash forward with dropout disagrees at "
                             f"B={b} L={l}: {errs}")

    args = (q, k, v, g, out, m, lsum, False, scale, bias, DROPOUT, seed)
    got = fa._flash_bwd_cuda(*args)
    want = fa.attention_bwd_reference(*args)
    torch.cuda.synchronize()
    err = max(rel_err(x, y) for x, y in zip(got[:3], want[:3]))
    abs_err = max((x - y).abs().max().item()
                  for x, y in zip(got[:3], want[:3]))
    # the f32 error relative to the largest gradient of each output
    top_f32 = max(top_err(x, y) for x, y in zip(got[:3], want[:3]))
    masked = max(x[-1].abs().max().item() for x in got[:3])
    log(f"kernel bwd B={b} H={h} L={l} D={d} padded bias, dropout "
        f"{DROPOUT}: max|d| {abs_err:.3e}, relative {err:.3e} "
        f"(tol {BWD_TOL:g}), relative to the largest gradient "
        f"{top_f32:.3e}; fully masked row grads max {masked:.1e}")
    if not err <= BWD_TOL or masked != 0.0 \
            or not all(torch.isfinite(x).all() for x in got[:3]):
        raise AssertionError(f"flash backward disagrees at B={b} L={l}: "
                             f"{err}")
    return {"q": q, "k": k, "v": v, "g": g, "bias": bias,
            "bias_np": bias_np, "scale": scale, "seed": seed, "out": out,
            "args": args, "fwd_err": max(errs), "bwd_abs_err": abs_err,
            "top": top_f32}


def flash_train_phase(dev, fwd_entry) -> dict:
    """The flash forward with dropout and statistics, and the backward,
    at the BERT-base training shape with the padding bias."""
    import torch
    import torch.nn.functional as F

    from analytics_zoo_tpu_torch.ops.cuda import flash_attention as fa

    gen = np.random.default_rng(SEED + 2)
    b, h, l, d = 8, 12, SEQ, 64
    c = flash_train_check(b, l, dev, gen)
    q, k, v, g, bias = c["q"], c["k"], c["v"], c["g"], c["bias"]
    scale, seed, out = c["scale"], c["seed"], c["out"]
    live_keys = int((c["bias_np"][:, 0, 0, :] == 0).sum())
    lib_q, lib_k, lib_v = (t.contiguous() for t in (q, k, v))
    train = graph_timed(
        lambda: fa._flash_cuda(q, k, v, False, scale, bias, DROPOUT, seed,
                               stats=True),
        lambda: fa.attention_reference(q, k, v, False, scale, bias,
                                       DROPOUT, seed, True),
        lambda: F.scaled_dot_product_attention(
            lib_q, lib_k, lib_v, attn_mask=bias, dropout_p=DROPOUT,
            scale=scale))
    fwd_bytes = 4 * b * h * l * d * 4 + bias.numel() * 4 + 2 * b * h * l * 4
    train.update(route_bound(fwd_bytes, 4.0 * h * l * live_keys * d,
                             "float32", d))
    train["max_abs_err"] = c["fwd_err"]
    fwd_entry["train"] = train
    fwd_entry["max_abs_err"] = max(fwd_entry["max_abs_err"], c["fwd_err"])
    log(f"kernel fwd train: {fmt_row(train)}")

    args = c["args"]
    entry = {"name": "flash_attention_bwd", "route": "cuda",
             "source": "analytics_zoo_tpu_torch/csrc/flash_attention_bwd.cu",
             "replaces": REPLACES["flash_attention_bwd"],
             "max_abs_err": c["bwd_abs_err"],
             "rel_to_largest_grad": c["top"]}
    entry.update(graph_timed(
        lambda: fa._flash_bwd_cuda(*args),
        lambda: fa.attention_bwd_reference(*args),
        sdpa_backward(q, k, v, g, bias, scale)))
    # q, k, v, dO, O, m, l and the bias read once; dq, dk, dv written once;
    # five (query, live key, D) products, three tf32 products a value on
    # the kernel's route, with the f32 CUDA-core figure beside it
    nbytes = (5 * b * h * l * d * 4 + 2 * b * h * l * 4 + bias.numel() * 4
              + 3 * b * h * l * d * 4)
    flops = 10.0 * h * l * live_keys * d
    entry.update(bound(nbytes, 3 * flops, "tfloat32"))
    entry["bound_cuda_core_ms"] = bound(nbytes, flops)["bound_ms"]
    log(f"kernel bwd: {entry['ms']:.4f} ms (graph {entry['graph_ms']:.4f}),"
        f" plain {entry['plain_ms']:.4f} ms, sdpa backward "
        f"{entry['library_ms']:.4f} ms (graph "
        f"{entry['library_graph_ms']:.4f}), bound {entry['bound_ms']:.4f} ms"
        f" ({entry['bound_by']}; f32 on CUDA cores "
        f"{entry['bound_cuda_core_ms']:.4f} ms)")

    # bf16 with dropout at the same shape: the bf16 training path's 12
    # launches a step, against the plain version run in f32
    qb, kb, vb, gb = (t.to(torch.bfloat16) for t in (q, k, v, g))
    outb, mb, lb = fa._flash_cuda(qb, kb, vb, False, scale, bias, DROPOUT,
                                  seed, stats=True)
    bargs = (qb, kb, vb, gb, outb, mb, lb, False, scale, bias, DROPOUT,
             seed)
    got = fa._flash_bwd_cuda(*bargs)
    want = fa.attention_bwd_reference(
        qb.float(), kb.float(), vb.float(), gb.float(), outb.float(), mb, lb,
        False, scale, bias, DROPOUT, seed)
    torch.cuda.synchronize()
    err = max(rel_err(x, y) for x, y in zip(got[:3], want[:3]))
    top = max(top_err(x, y) for x, y in zip(got[:3], want[:3]))
    masked = max(x[-1].float().abs().max().item() for x in got[:3])
    log(f"kernel bwd bf16 B={b} H={h} L={l} D={d} padded bias, dropout "
        f"{DROPOUT}: relative {err:.3e} (tol {BF16_TOL:g}), relative to "
        f"the largest gradient {top:.3e} (tol "
        f"{BWD16_TOP_TOL['bfloat16']:g}); fully masked row grads max "
        f"{masked:.1e}")
    if not err <= BF16_TOL or not top <= BWD16_TOP_TOL["bfloat16"] \
            or masked != 0.0 \
            or not all(torch.isfinite(x.float()).all() for x in got[:3]):
        raise AssertionError(f"bf16 flash backward disagrees: {err}, {top} "
                             "of the largest gradient")
    row = graph_timed(
        lambda: fa._flash_bwd_cuda(*bargs),
        lambda: fa.attention_bwd_reference(*bargs),
        library_call(lambda: sdpa_backward(qb, kb, vb, gb, bias, scale)))
    row["max_abs_err"] = max((x.float() - y).abs().max().item()
                             for x, y in zip(got[:3], want[:3]))
    row["rel_to_largest_grad"] = top
    row.update(route_bound(8 * b * h * l * d * 2 + 2 * b * h * l * 4
                           + bias.numel() * 4, flops, "bfloat16", d))
    entry["bf16_train"] = row
    log(f"kernel bwd bf16 train: {fmt_row(row)}")
    return entry


def packed_segments(b: int, n: int, gen: np.random.Generator):
    """(B, n) int32 ids of 2 to 4 packed sequences a row, and the number of
    (query, key) pairs they leave live."""
    ids = np.zeros((b, n), np.int32)
    for row in range(b):
        cuts = np.sort(gen.choice(np.arange(1, n), gen.integers(1, 4),
                                  replace=False))
        ids[row] = np.searchsorted(cuts, np.arange(n), side="right")
    return ids, sum(int((np.bincount(r) ** 2).sum()) for r in ids)


def flash_case(d, dtype, dev, gen, segments=False, dropout=0.0):
    """The forward and the backward at head dim d (hidden 768 as 768 // d
    heads) at B=8, L=512, with the padding bias or with packed segment ids
    (2-4 sequences a row), each against its plain version and timed beside
    SDPA: its forward with the bias, or the equivalent boolean mask; its
    memory-efficient backward op with the same mask as a float bias, no
    dropout.  With ``dropout`` the forward also returns its (m, l)
    statistics (held against the plain version's) and both kernels drop
    with the hash, as on the training path.  Returns (forward row,
    backward row)."""
    import torch
    import torch.nn.functional as F

    from analytics_zoo_tpu_torch.ops.cuda import flash_attention as fa

    b, l, h = 8, SEQ, 768 // d
    name = str(dtype).split(".")[1]
    label = f"{name} D={d} H={h} " + ("segment ids" if segments
                                      else "padded bias")
    q, k, v = (t.to(dtype) for t in attention_inputs(b, h, l, l, d, gen,
                                                      dev))
    g = torch.from_numpy(gen.normal(size=(b, h, l, d)).astype(
        np.float32)).to(dev, dtype)
    scale = 1.0 / np.sqrt(d)
    seg, bias = {}, None
    if segments:
        ids, pairs = packed_segments(b, l, gen)
        ids = torch.from_numpy(ids).to(dev)
        seg = {"q_seg": ids, "kv_seg": ids}
        keep = ids[:, None, :, None] == ids[:, None, None, :]
        lib_mask = keep
        lib_bias = torch.where(keep, 0.0, torch.finfo(torch.float32).min)
        extra = 2 * b * l * 4  # the ids, read once
    else:
        bias_np = padding_bias(b, l, gen)
        bias = torch.from_numpy(bias_np).to(dev)
        pairs = l * int((bias_np[:, 0, 0, :] == 0).sum())
        lib_mask = lib_bias = bias.to(dtype)
        extra = bias.numel() * 4
    tol = {torch.float32: F32_TOL, torch.bfloat16: BF16_TOL,
           torch.float16: F16_TOL}[dtype]
    bwd_tol = BWD_TOL if dtype == torch.float32 else tol
    esize = q.element_size()
    seed = (0x2545F491, 0x9E3779B9) if dropout else None
    stats = dropout > 0.0
    if dropout:
        label += f", dropout {dropout} + stats"

    got, m, lsum = fa._flash_cuda(q, k, v, False, scale, bias, dropout,
                                  seed, stats=stats, **seg)
    want, w_m, w_l = fa.attention_reference(
        q.float(), k.float(), v.float(), False, scale, bias, dropout, seed,
        True, **seg)
    torch.cuda.synchronize()
    errs = [(got.float() - want).abs().max().item()]
    if stats:
        errs += [(m - w_m).abs().max().item(),
                 ((lsum - w_l).abs() / w_l.abs().clamp_min(1.0)).max().item()]
    err = max(errs)
    log(f"kernel fwd {label}: max|d| " + ", ".join(f"{e:.3e}" for e in errs)
        + f" (out{', m, l rel' if stats else ''}; tol {tol:g})")
    if not err <= tol or not torch.isfinite(got.float()).all():
        raise AssertionError(f"flash forward {label} disagrees: {errs}")
    lq, lk, lv = (t.contiguous() for t in (q, k, v))
    fwd = graph_timed(
        lambda: fa._flash_cuda(q, k, v, False, scale, bias, dropout, seed,
                               stats=stats, **seg),
        lambda: fa.attention_reference(q, k, v, False, scale, bias, dropout,
                                       seed, stats, **seg),
        library_call(lambda: lambda: F.scaled_dot_product_attention(
            lq, lk, lv, attn_mask=lib_mask, dropout_p=dropout, scale=scale)))
    fwd["max_abs_err"] = err
    fwd.update(route_bound(4 * b * h * l * d * esize + extra
                           + (2 * b * h * l * 4 if stats else 0),
                           4.0 * h * d * pairs, name, d))
    log(f"kernel fwd {label}: {fmt_row(fwd)}")

    out, m, lsum = fa._flash_cuda(q, k, v, False, scale, bias, dropout, seed,
                                  stats=True, **seg)
    args = (q, k, v, g, out, m, lsum, False, scale, bias, dropout, seed)
    grads = fa._flash_bwd_cuda(*args, **seg)
    want = fa.attention_bwd_reference(
        q.float(), k.float(), v.float(), g.float(), out.float(), m, lsum,
        False, scale, bias, dropout, seed, **seg)
    torch.cuda.synchronize()
    rel = max(rel_err(x, y) for x, y in zip(grads[:3], want[:3]))
    top = max(top_err(x, y) for x, y in zip(grads[:3], want[:3]))
    # the f32 chunked tensor-core body (head dims above 128) is held to
    # 1e-5 of each output's largest gradient, as the D 64 backward is in
    # the cuda tests; the 16-bit body (head dims 64 and 128) to
    # BWD16_TOP_TOL
    top_tol = (F32_BWD_TOL if dtype == torch.float32 and d > 128
               and d % 64 == 0 else
               BWD16_TOP_TOL[name] if dtype != torch.float32
               and d in (64, 128) else None)
    log(f"kernel bwd {label}: relative {rel:.3e} (tol {bwd_tol:g}), "
        f"relative to the largest gradient {top:.3e}"
        + (f" (tol {top_tol:g})" if top_tol else ""))
    if not rel <= bwd_tol or not all(torch.isfinite(x.float()).all()
                                     for x in grads[:3]) \
            or (top_tol and not top <= top_tol):
        raise AssertionError(f"flash backward {label} disagrees: {rel}, "
                             f"{top} of the largest gradient")
    bwd = graph_timed(
        lambda: fa._flash_bwd_cuda(*args, **seg),
        lambda: fa.attention_bwd_reference(*args, **seg),
        library_call(lambda: sdpa_backward(q, k, v, g, lib_bias, scale)))
    bwd.update(max_abs_err=max((x.float() - y).abs().max().item()
                               for x, y in zip(grads[:3], want[:3])),
               rel_to_largest_grad=top)
    bwd.update(route_bound(8 * b * h * l * d * esize + 2 * b * h * l * 4
                           + extra, 10.0 * h * d * pairs, name, d))
    log(f"kernel bwd {label}: {fmt_row(bwd)}")
    return fwd, bwd


def flash_dims_phase(dev, fwd_entry, bwd_entry) -> None:
    """The head dims of the two full-width paths above 128 and two more
    (192, 256, 384, 512) and segment ids at D=64, f32 and bf16, forward
    and backward; rows go into the two kernels' entries as
    ``<dtype>_d<D>`` and ``<dtype>_segments``."""
    import torch

    gen = np.random.default_rng(SEED + 9)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for key, d, segments in [(f"{name}_d{d}", d, False)
                                 for d in NEW_HEAD_DIMS] + [
                                     (f"{name}_segments", 64, True)]:
            fwd, bwd = flash_case(d, dtype, dev, gen, segments)
            fwd_entry[key], bwd_entry[key] = fwd, bwd
            if dtype == torch.float32:
                fwd_entry["max_abs_err"] = max(fwd_entry["max_abs_err"],
                                               fwd["max_abs_err"])
                bwd_entry["max_abs_err"] = max(bwd_entry["max_abs_err"],
                                               bwd["max_abs_err"])


def flash_f16_phase(dev, fwd_entry, bwd_entry) -> None:
    """The f16 instances of the forward and the backward: at the f16
    training path's shape (B8 H12 L512 D64, padding bias, dropout 0.1 with
    the statistics), at head dim 128, at 192 (the chunked bodies) and at 96
    (the CUDA-core bodies), each against its plain version run in f32 and
    timed beside SDPA on f16; rows go into the two kernels' entries as
    ``f16_train`` and ``f16_d<D>``."""
    import torch

    gen = np.random.default_rng(SEED + 11)
    for d, dropout in F16_FLASH_CASES:
        key = "f16_train" if dropout else f"f16_d{d}"
        fwd_entry[key], bwd_entry[key] = flash_case(
            d, torch.float16, dev, gen, dropout=dropout)


def adam_parity(dev, leaf_shapes, tag: str):
    """``fused_update`` (one launch over every kernel leaf) on random
    (g, mu, nu) leaves of ``leaf_shapes`` on the card, held bit for bit
    against ``adam_leaf_reference`` leaf by leaf; raises unless they agree.
    Returns (leaves, kernel leaves, scalars, max relative error, bit
    identical, launches, leaves launched)."""
    import torch

    from analytics_zoo_tpu_torch.ops.cuda import fused_adam as fad

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand(shape, scale):
        return torch.randn(shape, generator=gen, device=dev) * scale

    leaves = [(rand(s, 1e-3), rand(s, 1e-4), rand(s, 1e-8).abs())
              for s in leaf_shapes]
    kernel = [t[0].numel() >= fad.MIN_KERNEL_LEAF for t in leaves]
    kernel_leaves = [t for t, k in zip(leaves, kernel) if k]
    gs, mus, nus = (list(x) for x in zip(*leaves))
    scalars = torch.tensor([2e-5, 0.9, 0.999, 1e-8, 1 - 0.9 ** 3,
                            1 - 0.999 ** 3], dtype=torch.float32, device=dev)
    before = fad.launch_count, fad.leaf_count
    got = fad.fused_update(gs, mus, nus, scalars)
    launches = fad.launch_count - before[0]
    leaf_launched = fad.leaf_count - before[1]
    err, same = 0.0, True
    for i, (g, mu, nu) in enumerate(leaves):
        if not kernel[i]:
            continue
        want = fad.adam_leaf_reference(g, mu, nu, scalars)
        for x, y in zip((got[0][i], got[1][i], got[2][i]), want):
            same = same and torch.equal(x, y)
            err = max(err, ((x - y).abs().max()
                            / y.abs().max().clamp_min(1e-30)).item())
    n = sum(t[0].numel() for t in kernel_leaves)
    sizes = sorted({t[0].numel() for t in kernel_leaves})
    log(f"kernel adam ({tag}): {len(kernel_leaves)} leaves of "
        f"{len(leaves)}, {n / 1e6:.3f} M parameters (kernel leaves of "
        f"{sizes[0]}..{sizes[-1]} elements; "
        f"{sum(k % 4 != 0 for k in sizes)} size(s) not a multiple of 4), "
        f"{launches} launch(es) for {leaf_launched} leaves per step: bit "
        f"for bit the plain version's outputs: {same}; max relative |d| "
        f"{err:.3e} (tol {ADAM_TOL:g})")
    if not (same and err <= ADAM_TOL) or launches != 1 \
            or leaf_launched != len(kernel_leaves):
        raise AssertionError(f"fused adam ({tag}) disagrees: {err}, "
                             f"{launches} launches, {leaf_launched} leaves")
    return (leaves, kernel_leaves, scalars, err, same, launches,
            leaf_launched)


def adam_phase(dev, leaf_shapes) -> dict:
    """Fused Adam over the BERT-base parameter tree: ``fused_update``, the
    call the training step makes, one launch for every kernel leaf, held
    against its plain version and timed."""
    import torch

    from analytics_zoo_tpu_torch.ops.cuda import fused_adam as fad

    (leaves, kernel_leaves, scalars, err, same, launches,
     leaf_launched) = adam_parity(dev, leaf_shapes, "BERT-base")
    gs, mus, nus = (list(x) for x in zip(*leaves))
    n = sum(t[0].numel() for t in kernel_leaves)
    params = [torch.zeros(s, device=dev, requires_grad=True)
              for s in leaf_shapes]
    for p, (g, _, _) in zip(params, leaves):
        p.grad = g
    lib = torch.optim.Adam(params, lr=2e-5, fused=True)
    lib_graph = torch.optim.Adam(params, lr=2e-5, fused=True,
                                 capturable=True)
    entry = {"name": "fused_adam", "route": "cuda",
             "source": "analytics_zoo_tpu_torch/csrc/fused_adam.cu",
             "replaces": REPLACES["fused_adam"], "max_abs_err": err,
             "bit_identical": same, "launches_per_step": launches,
             "leaves_per_step": leaf_launched}

    def step():
        return fad.fused_update(gs, mus, nus, scalars)

    def plain():
        return [fad.adam_leaf_reference(*t, scalars) for t in kernel_leaves]

    entry.update(timed(step, plain, lib.step))
    entry.update(graph_ms=graph_ms(step), plain_graph_ms=graph_ms(plain),
                 library_graph_ms=graph_ms(lib_graph.step))
    entry.update(bound(24.0 * n, 12.0 * n))
    log(f"kernel adam: {entry['ms']:.4f} ms per step (graph "
        f"{entry['graph_ms']:.4f}), plain {entry['plain_ms']:.4f} ms, torch "
        f"fused Adam {entry['library_ms']:.4f} ms (graph, capturable "
        f"{entry['library_graph_ms']:.4f}), bound {entry['bound_ms']:.4f} ms")
    return entry


def xent_phase(dev) -> list:
    """Softmax cross-entropy forward and backward at the classifier head
    (the main path's shape) and at an LM head, and the f16 instances at the
    LM head (loss and lse in f32 within XENT_TOL, dx in f16 within
    XENT_F16_TOL of the plain version on the same f16 logits, timed beside
    ``F.cross_entropy`` on f16)."""
    import torch
    import torch.nn.functional as F

    from analytics_zoo_tpu_torch.ops.cuda import fused_softmax_xent as fx

    fwd = {"name": "softmax_xent_fwd", "route": "cuda",
           "source": "analytics_zoo_tpu_torch/csrc/fused_softmax_xent.cu",
           "replaces": REPLACES["softmax_xent_fwd"], "max_abs_err": 0.0}
    bwd = dict(fwd, name="softmax_xent_bwd",
               replaces=REPLACES["softmax_xent_bwd"])
    gen = np.random.default_rng(SEED + 3)
    for key, (b, v), dtype in (("head", (TRAIN_BATCH, 2), torch.float32),
                               ("lm_head", (4096, 30522), torch.float32),
                               ("f16_lm_head", (4096, 30522),
                                torch.float16)):
        x = torch.from_numpy((gen.normal(size=(b, v)) * 3).astype(
            np.float32)).to(dev, dtype)
        labels = torch.from_numpy(gen.integers(0, v, b)).to(dev)
        g = torch.from_numpy(gen.normal(size=b).astype(np.float32)).to(dev)
        loss, lse = fx._fwd_cuda(x, labels)
        dx = fx._bwd_cuda(x, labels, lse, g)
        w_loss, w_lse = fx.xent_reference(x, labels)
        w_dx = fx.xent_bwd_reference(x, labels, w_lse, g)
        torch.cuda.synchronize()
        e_f = max(((loss - w_loss).abs() / w_loss.abs().clamp_min(1)).max(
        ).item(), ((lse - w_lse).abs() / w_lse.abs().clamp_min(1)).max(
        ).item())
        e_b = (dx.float() - w_dx.float()).abs().max().item()
        b_tol = XENT_TOL if dtype == torch.float32 else XENT_F16_TOL
        log(f"kernel xent {key} ({b}, {v}) {dtype}: fwd max rel|d| "
            f"{e_f:.3e} (tol {XENT_TOL:g}), bwd max|d| {e_b:.3e} (tol "
            f"{b_tol:g})")
        if not (e_f <= XENT_TOL and e_b <= b_tol) or dx.dtype != dtype:
            raise AssertionError(f"softmax xent disagrees at {key}")
        xr = x.detach().clone().requires_grad_()
        lib_loss = F.cross_entropy(xr, labels, reduction="none")
        nbytes = b * v * x.element_size()
        f_row = timed(lambda: fx._fwd_cuda(x, labels),
                      lambda: fx.xent_reference(x, labels),
                      lambda: F.cross_entropy(x, labels, reduction="none"))
        f_row.update(bound(nbytes + 4 * b * 4, 3.0 * b * v))
        b_row = timed(lambda: fx._bwd_cuda(x, labels, lse, g),
                      lambda: fx.xent_bwd_reference(x, labels, lse, g),
                      lambda: torch.autograd.grad(lib_loss, xr, g.to(dtype),
                                                  retain_graph=True))
        b_row.update(bound(2 * nbytes + 4 * b * 4, 4.0 * b * v))
        f_row["max_abs_err"], b_row["max_abs_err"] = e_f, e_b
        for entry, row in ((fwd, f_row), (bwd, b_row)):
            if dtype == torch.float32:
                entry["max_abs_err"] = max(entry["max_abs_err"],
                                           row["max_abs_err"])
            if key == "head":
                entry.update({k: row[k] for k in row if k != "max_abs_err"})
            else:
                entry[key] = row
            log(f"kernel {entry['name']} {key} ({b}, {v}): {row['ms']:.4f} "
                f"ms, plain {row['plain_ms']:.4f} ms, library "
                f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms")
    return [fwd, bwd]


def bert_model(n_head=BERT_BASE["n_head"]):
    from analytics_zoo_tpu_torch.pipeline.api.keras import Input, Model
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import BERT, Dense

    ins = [Input((SEQ,)) for _ in range(4)]
    _, pooled = BERT(**dict(BERT_BASE, n_head=n_head))(ins)
    return Model(ins, Dense(2, activation="softmax")(pooled))


# the dtypes of a request's four inputs (``requests_of``), with which
# ``InferenceModel.warmup`` captures the buckets requests use
REQ_DTYPES = [np.int32, np.int32, np.int32, np.float32]


def requests_of(n: int, gen: np.random.Generator):
    """n records of real lengths 64-512: token ids, segment types,
    positions and the attention mask."""
    lengths = gen.integers(64, SEQ + 1, n)
    split = (lengths * gen.uniform(0.3, 0.7, n)).astype(np.int64)
    pos = np.arange(SEQ)[None, :]
    mask = (pos < lengths[:, None]).astype(np.float32)
    ids = gen.integers(1, BERT_BASE["vocab"], (n, SEQ)) * mask
    types = ((pos >= split[:, None]) & (mask > 0)).astype(np.int32)
    return [ids.astype(np.int32), types,
            np.tile(pos.astype(np.int32), (n, 1)), mask]


def requests(gen: np.random.Generator):
    return [requests_of(n, gen) for n in REQUEST_SIZES]


def tree_leaves_of_bert():
    """The BERT-base classifier's parameter leaves (on the CPU)."""
    from analytics_zoo_tpu_torch.common.engine import make_generator
    from analytics_zoo_tpu_torch.common.utils import tree_leaves

    return tree_leaves(bert_classifier(BERT_BASE["n_block"], DROPOUT,
                                       DROPOUT).init_params(
        make_generator(SEED)))


def slice_phase(card_line: str) -> int:
    import torch

    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.ops.cuda import flash_attention as fa
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

    init_zoo_context(seed=SEED, device="cuda")
    t0 = time.perf_counter()
    net = bert_model()
    net.build_params()
    im = InferenceModel().from_keras_net(net)
    im.warmup([(SEQ,)] * 4, dtype=REQ_DTYPES, batch_sizes=REQUEST_SIZES)
    im_bf16 = InferenceModel().from_keras_net(net).optimize("bf16")
    im_bf16.warmup([(SEQ,)] * 4, dtype=REQ_DTYPES,
                   batch_sizes=REQUEST_SIZES)
    torch.cuda.synchronize()
    log(f"slice: BERT-base built and warmed up in "
        f"{time.perf_counter() - t0:.1f} s")
    reqs = requests(np.random.default_rng(SEED + 1))

    fa.launch_count = 0  # main path: from here to the read below
    outs, f32_launches = [], 0
    for i, xs in enumerate(reqs):
        t0 = time.perf_counter()
        out = im.predict(xs)
        ms = (time.perf_counter() - t0) * 1e3
        f32_launches = fa.launch_count
        outs.append(out)
        log(f"request {i}: {len(out)} records in {ms:.2f} ms "
            f"({card_line})")
        if out.shape != (len(xs[0]), 2) or not np.isfinite(out).all():
            raise AssertionError(f"request {i}: bad output {out.shape}")
        if not np.allclose(out.sum(axis=1), 1.0, atol=1e-5):
            raise AssertionError(f"request {i}: rows do not sum to 1")
    t0 = time.perf_counter()
    bf16_out = im_bf16.predict(reqs[2])
    ms = (time.perf_counter() - t0) * 1e3
    launches = fa.launch_count  # end of the main path
    blocks = BERT_BASE["n_block"]
    log(f"bf16 request: {len(bf16_out)} records in {ms:.2f} ms; "
        f"flash launches: {f32_launches} f32 + {launches - f32_launches} "
        f"bf16 (expected {blocks} per micro-batch)")
    if f32_launches != blocks * len(reqs) or launches != blocks * (
            len(reqs) + 1):
        raise AssertionError(f"flash launches {f32_launches}/{launches}: "
                             "attention did not run through the kernel")
    # the 8-record bf16 request again, after the counted path: host clock
    again = []
    for _ in range(5):
        t0 = time.perf_counter()
        im_bf16.predict(reqs[2])
        again.append((time.perf_counter() - t0) * 1e3)
    log(f"bf16 request, 5 more runs: {', '.join(f'{t:.2f}' for t in again)}"
        f" ms (median {float(np.median(again)):.2f}; {card_line})")
    bf16_err = float(np.abs(bf16_out - outs[2]).max())
    log(f"bf16 vs f32 outputs: max|d| {bf16_err:.3e} "
        f"(tol {BF16_SERVE_TOL:g})")
    if not np.isfinite(bf16_out).all() or not bf16_err <= BF16_SERVE_TOL \
            or not np.allclose(bf16_out.sum(axis=1), 1.0, atol=1e-2):
        raise AssertionError("bf16 request disagrees with f32")

    # the same model (same seed, same weights) on the CPU, plain versions
    cpu = bert_model()
    cpu.build_params(device="cpu")
    cpu_im = InferenceModel().from_keras_net(cpu)
    for i in CPU_CHECKED:
        err = float(np.abs(cpu_im.predict(reqs[i]) - outs[i]).max())
        log(f"request {i} vs CPU: max|d| {err:.3e} (tol {CPU_TOL:g})")
        if not err <= CPU_TOL:
            raise AssertionError(f"request {i} disagrees with the CPU run")
    return launches


def bert_classifier(n_block, hidden_drop, attn_drop,
                    n_head=BERT_BASE["n_head"]):
    """BERT with a Dense(2) logits head, fine-tuned as users of BERT do."""
    from analytics_zoo_tpu_torch.pipeline.api.keras import Input, Model
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import BERT, Dense

    ins = [Input((SEQ,)) for _ in range(4)]
    cfg = dict(BERT_BASE, n_block=n_block, n_head=n_head,
               hidden_p_drop=hidden_drop, attn_p_drop=attn_drop)
    _, pooled = BERT(**cfg)(ins)
    return Model(ins, Dense(2)(pooled))


def counters() -> dict:
    from analytics_zoo_tpu_torch.ops.cuda import flash_attention as fa
    from analytics_zoo_tpu_torch.ops.cuda import fused_adam as fad
    from analytics_zoo_tpu_torch.ops.cuda import fused_softmax_xent as fx
    from analytics_zoo_tpu_torch.ops.cuda import int8_conv as ic8
    from analytics_zoo_tpu_torch.ops.cuda import int8_matmul as im8

    return {"flash_attention_fwd": fa.launch_count,
            "flash_attention_bwd": fa.bwd_launch_count,
            "fused_adam": fad.launch_count,
            "softmax_xent_fwd": fx.fwd_launch_count,
            "softmax_xent_bwd": fx.bwd_launch_count,
            "int8_matmul": im8.launch_count,
            "int8_conv": ic8.launch_count,
            "quantize_act": ic8.quantize_launch_count}


def reset_counters() -> None:
    from analytics_zoo_tpu_torch.ops.cuda import flash_attention as fa
    from analytics_zoo_tpu_torch.ops.cuda import fused_adam as fad
    from analytics_zoo_tpu_torch.ops.cuda import fused_softmax_xent as fx
    from analytics_zoo_tpu_torch.ops.cuda import int8_conv as ic8
    from analytics_zoo_tpu_torch.ops.cuda import int8_matmul as im8

    fa.launch_count = fa.bwd_launch_count = 0
    fad.launch_count = fad.leaf_count = 0
    fx.fwd_launch_count = fx.bwd_launch_count = 0
    im8.launch_count = 0
    ic8.launch_count = ic8.quantize_launch_count = 0


def train_data(n: int, gen: np.random.Generator):
    x = requests_of(n, gen)
    return x, gen.integers(0, 2, n).astype(np.int32)


def training_phase(card_line: str) -> tuple[dict, dict]:
    """The f32 fine-tuning path: its launch counts, and its warm-up step's
    loss and host-clock step time for the bf16 phase."""
    import torch

    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.common.engine import step_generator
    from analytics_zoo_tpu_torch.common.utils import tree_leaves
    from analytics_zoo_tpu_torch.ops.cuda import fused_adam as fad
    from analytics_zoo_tpu_torch.pipeline.api.keras.objectives import (
        get_loss,
    )
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import Adam
    from analytics_zoo_tpu_torch.pipeline.estimator import Estimator
    from analytics_zoo_tpu_torch.pipeline.estimator.estimator import (
        _to_device,
    )

    init_zoo_context(seed=SEED, device="cuda")
    gen = np.random.default_rng(SEED + 4)
    t0 = time.perf_counter()
    net = bert_classifier(BERT_BASE["n_block"], DROPOUT, DROPOUT)
    net.build_params()
    net.compile(optimizer=Adam(2e-5),
                loss="sparse_categorical_crossentropy_from_logits",
                metrics=["accuracy"])
    n = TRAIN_BATCH * TRAIN_STEPS
    x, y = train_data(n, gen)
    warm = [a[:TRAIN_BATCH] for a in x]
    net.fit(warm, y[:TRAIN_BATCH], batch_size=TRAIN_BATCH, nb_epoch=1)
    torch.cuda.synchronize()
    first_loss = net._estimator.loss_log[0][1]
    log(f"training: BERT-base classifier built and one warm-up step in "
        f"{time.perf_counter() - t0:.1f} s (step 1 loss {first_loss:.6f})")
    kernel_leaves = sum(
        1 for t in tree_leaves(net.params)
        if t.dtype == torch.float32 and t.numel() >= fad.MIN_KERNEL_LEAF)

    reset_counters()  # main path: from here to the read below
    t0 = time.perf_counter()
    net.fit(x, y, batch_size=TRAIN_BATCH, nb_epoch=1)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    launches = counters()  # end of the main path
    adam_leaves = fad.leaf_count
    est = net._estimator
    losses = [v for _, v in est.loss_log[-TRAIN_STEPS:]]
    log(f"training: {TRAIN_STEPS} steps at batch {TRAIN_BATCH} x {SEQ}: "
        f"{step_ms:.1f} ms per step ({card_line}); losses "
        + ", ".join(f"{v:.4f}" for v in losses))
    blocks = BERT_BASE["n_block"]
    expected = {"flash_attention_fwd": blocks * TRAIN_STEPS,
                "flash_attention_bwd": blocks * TRAIN_STEPS,
                "fused_adam": TRAIN_STEPS,  # one launch a step
                "softmax_xent_fwd": TRAIN_STEPS,
                "softmax_xent_bwd": TRAIN_STEPS,
                "int8_matmul": 0, "int8_conv": 0,
                "quantize_act": 0}
    log(f"training launches: {launches} (expected {expected}); Adam leaves "
        f"through the kernel: {adam_leaves} (expected {kernel_leaves} f32 "
        f"leaves of >= {fad.MIN_KERNEL_LEAF} x {TRAIN_STEPS} steps)")
    if launches != expected or adam_leaves != kernel_leaves * TRAIN_STEPS:
        raise AssertionError("a training call did not run through its "
                             "kernel")
    if len(losses) != TRAIN_STEPS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"training losses not finite: {losses}")
    res = net.evaluate(x, y, batch_size=TRAIN_BATCH)
    log(f"evaluate: {res}")
    if not (np.isfinite(res["loss"]) and 0.0 <= res["accuracy"] <= 1.0):
        raise AssertionError(f"bad evaluate result {res}")
    captured_eval("f32", net._estimator, x, y, card_line)

    # one batch the model has not seen, repeated at a higher learning rate
    # (fresh Adam moments): the loss falls
    fresh_x, fresh_y = train_data(TRAIN_BATCH, gen)
    net.compile(optimizer=Adam(5e-5),
                loss="sparse_categorical_crossentropy_from_logits")
    net.fit(fresh_x, fresh_y, batch_size=TRAIN_BATCH, nb_epoch=10)
    rep = [v for _, v in net._estimator.loss_log]
    log("repeated batch at lr 5e-5: " + ", ".join(f"{v:.4f}" for v in rep))
    if not min(rep[-3:]) < rep[0]:
        raise AssertionError(f"the loss did not fall: {rep}")

    # step 1 on the GPU against the same model on the CPU: 2 blocks at full
    # width, batch 2, hidden dropout 0, attention dropout on
    xs, ys = train_data(2, gen)
    batch = {"x": xs, "y": ys}
    results = []
    for device in ("cuda", "cpu"):
        small = bert_classifier(2, 0.0, DROPOUT)
        small.build_params(rng=torch.Generator().manual_seed(SEED),
                           device=device)
        est = Estimator(small, loss=get_loss(
            "sparse_categorical_crossentropy_from_logits"))
        loss, grads, _ = est.loss_and_grads(
            small.params, small.state, _to_device(batch, small.device),
            step_generator(SEED, 0, small.device))
        results.append((loss.item(), [g.cpu() for g in tree_leaves(grads)]))
    (g_loss, g_grads), (c_loss, c_grads) = results
    loss_err = abs(g_loss - c_loss) / abs(c_loss)
    grad_err = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                   .item() for a, b in zip(g_grads, c_grads))
    log(f"training step 1 vs CPU (2 blocks, batch 2, attention dropout "
        f"{DROPOUT}): loss {g_loss:.6f} vs {c_loss:.6f} (rel {loss_err:.2e})"
        f", grads max rel to leaf max {grad_err:.2e} (tol "
        f"{TRAIN_CPU_TOL:g})")
    if not (loss_err <= TRAIN_CPU_TOL and grad_err <= TRAIN_CPU_TOL):
        raise AssertionError("the GPU training step disagrees with the CPU")
    return launches, {"step_ms": step_ms, "first_loss": first_loss,
                      "cpu_grads": c_grads}


def training_bf16_phase(card_line: str, f32: dict) -> dict:
    """The f32 phase's classifier, weights and batches fine-tuned in bf16
    mixed precision through ``fit(plan=mixed_precision())``: bf16 compute
    copies of the f32 masters, so every flash launch takes bf16 q/k/v,
    while Adam and the cross-entropy stay f32.  Two controls must fail the
    card-against-CPU gradient check: dq zeroed, attention dropout off."""
    import torch

    from analytics_zoo_tpu_torch.parallel import mixed_precision

    return training_mixed_phase(card_line, f32, mixed_precision(),
                                torch.bfloat16, BF16_TRAIN_CPU_TOL,
                                ("dq zeroed", "attention dropout off"),
                                repeat=True)


def training_f16_phase(card_line: str, f32: dict) -> dict:
    """The same fine-tuning under ``plan="dp+f16"``: f16 compute copies of
    the f32 masters, every flash launch on f16 q/k/v, no loss scaling (the
    reference has none); Adam and the cross-entropy stay f32.  One control
    must fail the gradient check: dq zeroed."""
    import torch

    from analytics_zoo_tpu_torch.parallel.plan import resolve_plan

    return training_mixed_phase(card_line, f32, resolve_plan("dp+f16"),
                                torch.float16, F16_GRAD_FLOOR,
                                ("dq zeroed",), repeat=False)


def training_mixed_phase(card_line: str, f32: dict, plan, dtype, floor,
                         controls, repeat) -> dict:
    """The f32 phase's classifier, weights and batches fine-tuned for
    TRAIN_STEPS steps through ``fit(plan=plan)``, a plan that computes in
    ``dtype`` (bf16 or f16): the launch counts, every flash launch on
    ``dtype`` q/k/v, f32 masters and moments, finite losses, step 1's loss
    within 5% of the f32 step's, ``evaluate`` under the plan, with
    ``repeat`` a loss that falls on a repeated batch, and the 2-block step
    on the card against the CPU under the plan (each gradient leaf within
    twice the CPU gradient's own distance from f32, plus ``floor``), with
    each of ``controls`` refused.  Returns the path's launch counts."""
    import torch

    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.common.engine import step_generator
    from analytics_zoo_tpu_torch.common.utils import tree_leaves
    from analytics_zoo_tpu_torch.feature.dataset import FeatureSet
    from analytics_zoo_tpu_torch.ops.cuda import flash_attention as fa
    from analytics_zoo_tpu_torch.ops.cuda import fused_adam as fad
    from analytics_zoo_tpu_torch.parallel import compile_step
    from analytics_zoo_tpu_torch.pipeline.api.keras.metrics import (
        get_metric,
    )
    from analytics_zoo_tpu_torch.pipeline.api.keras.objectives import (
        get_loss,
    )
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import Adam
    from analytics_zoo_tpu_torch.pipeline.estimator import Estimator
    from analytics_zoo_tpu_torch.pipeline.estimator.estimator import (
        _to_device,
    )

    tag = {torch.bfloat16: "bf16", torch.float16: "f16"}[dtype]
    loss_name = "sparse_categorical_crossentropy_from_logits"
    init_zoo_context(seed=SEED, device="cuda")
    gen = np.random.default_rng(SEED + 4)  # the f32 phase's batches
    net = bert_classifier(BERT_BASE["n_block"], DROPOUT, DROPOUT)
    net.build_params()  # the f32 phase's weights: same seed
    net.compile(optimizer=Adam(2e-5), loss=loss_name, metrics=["accuracy"])
    n = TRAIN_BATCH * TRAIN_STEPS
    x, y = train_data(n, gen)
    # every flash launch the step's Python makes (its eager run and its
    # capture; replays run none) records its q/k/v dtypes, then launches
    seen = {"fwd": [], "bwd": []}
    launch_fwd, launch_bwd = fa._flash_cuda, fa._flash_bwd_cuda

    def record_fwd(q, k, v, *args, **kwargs):
        seen["fwd"].append((q.dtype, k.dtype, v.dtype))
        return launch_fwd(q, k, v, *args, **kwargs)

    def record_bwd(q, k, v, *args, **kwargs):
        seen["bwd"].append((q.dtype, k.dtype, v.dtype))
        return launch_bwd(q, k, v, *args, **kwargs)

    fa._flash_cuda, fa._flash_bwd_cuda = record_fwd, record_bwd
    net.fit([a[:TRAIN_BATCH] for a in x], y[:TRAIN_BATCH],
            batch_size=TRAIN_BATCH, nb_epoch=1, plan=plan)
    torch.cuda.synchronize()
    first_loss = net._estimator.loss_log[0][1]
    loss_gap = abs(first_loss - f32["first_loss"]) / abs(f32["first_loss"])
    log(f"training {tag}: step 1 loss {first_loss:.6f} vs f32 "
        f"{f32['first_loss']:.6f} (rel {loss_gap:.2e}, tol "
        f"{BF16_F32_LOSS_TOL:g})")
    if not loss_gap <= BF16_F32_LOSS_TOL:
        raise AssertionError(f"the {tag} step-1 loss is not within 5% of "
                             "f32")
    kernel_leaves = sum(
        1 for t in tree_leaves(net.params)
        if t.dtype == torch.float32 and t.numel() >= fad.MIN_KERNEL_LEAF)

    reset_counters()  # this training path: from here to the read below
    t0 = time.perf_counter()
    net.fit(x, y, batch_size=TRAIN_BATCH, nb_epoch=1, plan=plan)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    launches = counters()  # end of the path
    fa._flash_cuda, fa._flash_bwd_cuda = launch_fwd, launch_bwd
    adam_leaves = fad.leaf_count
    est = net._estimator
    losses = [v for _, v in est.loss_log[-TRAIN_STEPS:]]
    log(f"training {tag}: {TRAIN_STEPS} steps at batch {TRAIN_BATCH} x "
        f"{SEQ}: {step_ms:.1f} ms per step against f32's "
        f"{f32['step_ms']:.1f} ({card_line}); losses "
        + ", ".join(f"{v:.4f}" for v in losses))
    blocks = BERT_BASE["n_block"]
    expected = {"flash_attention_fwd": blocks * TRAIN_STEPS,
                "flash_attention_bwd": blocks * TRAIN_STEPS,
                "fused_adam": TRAIN_STEPS, "softmax_xent_fwd": TRAIN_STEPS,
                "softmax_xent_bwd": TRAIN_STEPS, "int8_matmul": 0,
                "int8_conv": 0,
                "quantize_act": 0}
    qkv = (dtype,) * 3
    log(f"training {tag} launches: {launches} (expected {expected}); flash "
        f"launches made by the step's eager run and its capture on {tag} "
        f"q/k/v: {seen['fwd'].count(qkv)} of {len(seen['fwd'])} forward, "
        f"{seen['bwd'].count(qkv)} of {len(seen['bwd'])} backward; Adam "
        f"leaves {adam_leaves} (expected {kernel_leaves} x {TRAIN_STEPS})")
    if launches != expected or adam_leaves != kernel_leaves * TRAIN_STEPS:
        raise AssertionError(f"a {tag} training call did not run through "
                             "its kernel")
    if seen["fwd"] != [qkv] * (2 * blocks) \
            or seen["bwd"] != [qkv] * (2 * blocks):
        raise AssertionError(f"a flash launch of the {tag} path was not "
                             f"{tag}")
    wide = [t.dtype for t in tree_leaves(net.params)
            + tree_leaves(est._opt_state.mu) + tree_leaves(est._opt_state.nu)
            if t.is_floating_point()]
    if set(wide) != {torch.float32}:
        raise AssertionError(f"masters or moments left f32: {set(wide)}")
    if len(losses) != TRAIN_STEPS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"{tag} training losses not finite: {losses}")
    want_record = {"name": plan.name, "dtype_policy": f".*={tag}"}
    if est._plan_record != want_record:
        raise AssertionError(f"bad plan record {est._plan_record}")

    # evaluate under the plan (an Estimator that holds it), and as
    # Model.evaluate does after fit(plan=...): under the model's own plan,
    # in f32, as in the reference
    low_est = Estimator(net, loss=get_loss(loss_name),
                        metrics=[get_metric("accuracy")], plan=plan)
    low_eval = low_est.evaluate(FeatureSet.of(x, y), batch_size=TRAIN_BATCH)
    f32_eval = net.evaluate(x, y, batch_size=TRAIN_BATCH)
    eval_gap = abs(low_eval["loss"] - f32_eval["loss"]) / f32_eval["loss"]
    log(f"evaluate under {plan.name}: {low_eval}; in f32: {f32_eval} (loss"
        f" rel {eval_gap:.2e}, tol {BF16_F32_LOSS_TOL:g})")
    for res in (low_eval, f32_eval):
        if not (np.isfinite(res["loss"]) and 0.0 <= res["accuracy"] <= 1.0):
            raise AssertionError(f"bad evaluate result {res}")
    if not eval_gap <= BF16_F32_LOSS_TOL:
        raise AssertionError(f"{tag} evaluate is not within 5% of f32")
    captured_eval(tag, low_est, x, y, card_line)

    # one unseen batch (drawn in every phase, so that the 2-record batch
    # below is the f32 phase's), repeated at a higher learning rate: the
    # loss falls
    fresh_x, fresh_y = train_data(TRAIN_BATCH, gen)
    if repeat:
        net.compile(optimizer=Adam(5e-5), loss=loss_name)
        net.fit(fresh_x, fresh_y, batch_size=TRAIN_BATCH, nb_epoch=10,
                plan=plan)
        rep = [v for _, v in net._estimator.loss_log]
        log(f"{tag} repeated batch at lr 5e-5: "
            + ", ".join(f"{v:.4f}" for v in rep))
        if not min(rep[-3:]) < rep[0]:
            raise AssertionError(f"the {tag} loss did not fall: {rep}")

    # step 1 on the GPU against the same model on the CPU under the plan:
    # 2 blocks at full width, batch 2, hidden dropout 0, attention dropout
    xs, ys = train_data(2, gen)
    batch = {"x": xs, "y": ys}

    def step1(device, attn_drop=DROPOUT):
        small = bert_classifier(2, 0.0, attn_drop)
        small.build_params(rng=torch.Generator().manual_seed(SEED),
                           device=device)
        est = Estimator(small, loss=get_loss(loss_name))
        loss, grads, _ = compile_step(est.loss_and_grads, plan,
                                      capture=False)(
            small.params, small.state, _to_device(batch, small.device),
            step_generator(SEED, 0, small.device),
            est.compute_casts(plan, small.params))
        return loss.item(), [g.cpu() for g in tree_leaves(grads)]

    (g_loss, g_grads), (c_loss, c_grads) = step1("cuda"), step1("cpu")
    if not all(g.dtype == torch.float32 for g in g_grads + c_grads):
        raise AssertionError(f"{tag} step gradients are not f32")

    def bound_ratios(grads):
        """Per leaf: the card's relative L2 distance from the CPU gradient
        under the plan over its bound (twice the CPU gradient's own
        distance from f32, + floor); the check holds every ratio <= 1."""
        return [rel_l2(a, b) / (2 * rel_l2(b, w) + floor)
                for a, b, w in zip(grads, c_grads, f32["cpu_grads"])]

    loss_err = abs(g_loss - c_loss) / abs(c_loss)
    gaps = [rel_l2(a, b) for a, b in zip(g_grads, c_grads)]
    own = [rel_l2(b, w) for b, w in zip(c_grads, f32["cpu_grads"])]
    ratios = bound_ratios(g_grads)
    worst = int(np.argmax(ratios))
    log(f"{tag} training step 1 vs CPU (2 blocks, batch 2, attention "
        f"dropout {DROPOUT}): loss {g_loss:.6f} vs {c_loss:.6f} (rel "
        f"{loss_err:.2e}, tol {BF16_TRAIN_CPU_TOL:g}); grads, relative L2 "
        f"card vs CPU: max {max(gaps):.2e}, median "
        f"{float(np.median(gaps)):.2e}; CPU {tag} vs f32: max {max(own):.2e}"
        f", median {float(np.median(own)):.2e}; closest to its bound: leaf "
        f"{worst}, {ratios[worst]:.3f} of it (bound 2 x the CPU {tag} "
        f"gradient's distance from f32 + {floor:g})")
    if not loss_err <= BF16_TRAIN_CPU_TOL or max(ratios) > 1.0:
        raise AssertionError(f"the {tag} GPU step disagrees with the CPU")

    # controls the gradient check must refuse: the card's step with the
    # backward's dq zeroed, and (bf16) with its attention dropout off
    def no_dq(*args, **kwargs):
        dq, dk, dv, dbias = launch_bwd(*args, **kwargs)
        return torch.zeros_like(dq), dk, dv, dbias

    for name in controls:
        if name == "dq zeroed":
            fa._flash_bwd_cuda = no_dq
            grads = step1("cuda")[1]
            fa._flash_bwd_cuda = launch_bwd
        else:
            grads = step1("cuda", attn_drop=0.0)[1]
        ratios = bound_ratios(grads)
        over = sum(r > 1.0 for r in ratios)
        log(f"{tag} gradient check, control {name!r}: {over} of "
            f"{len(ratios)} leaves over their bound, largest "
            f"{max(ratios):.3f} of it (must be refused)")
        if not over:
            raise AssertionError(f"the {tag} gradient check passed the "
                                 f"{name!r} control")
    return launches


CAPTURE_STEPS, K_STEPS, K = 5, 8, 4  # the captured-training phase


def named_leaves(tree, prefix="") -> list:
    """(path, leaf) pairs of a tree, in the port's visiting order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in named_leaves(v, f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        fields = getattr(tree, "_fields", range(len(tree)))
        return [x for k, v in zip(fields, tree)
                for x in named_leaves(v, f"{prefix}/{k}")]
    return [(prefix, tree)]


def differing(a, b) -> list:
    """Paths of the leaves where two trees of one structure differ."""
    import torch

    return [p for (p, u), (_, v) in zip(named_leaves(a), named_leaves(b))
            if not torch.equal(u, v)]


def eager_steps(net, plan, x, y, steps, batch=TRAIN_BATCH, shuffle=True):
    """``Estimator.train_step`` called step by step (the uncaptured
    yardstick), from the model's weights and state and a fresh optimizer
    state over the ``steps`` batches of (x, y) that one epoch of ``fit``
    takes (``shuffle=False``: in their order): (parameters, optimizer
    state and model state after the steps, losses, host ms a step)."""
    import torch

    from analytics_zoo_tpu_torch.common.engine import step_generator
    from analytics_zoo_tpu_torch.common.utils import tree_map
    from analytics_zoo_tpu_torch.feature.dataset import FeatureSet
    from analytics_zoo_tpu_torch.parallel import compile_step
    from analytics_zoo_tpu_torch.pipeline.estimator.estimator import (
        _to_device,
    )

    est = net._make_estimator()
    plan = est._resolve_plan(plan)
    step = compile_step(est.train_step, plan, capture=False)
    params = tree_map(torch.clone, net.params)
    opt = est.optimizer.init(params)
    state = tree_map(torch.clone, net.state)
    casts = est.compute_casts(plan, params)
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, b in enumerate(FeatureSet.of(x, y).batches(
            batch, shuffle=shuffle, seed=SEED, epoch=1, drop_last=True)):
        params, opt, state, loss = step(
            params, opt, state, step_generator(SEED, i, net.device),
            _to_device(b, net.device), casts)
        losses.append(loss)
    losses = torch.stack(losses).tolist()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    return {"params": params, "opt": opt, "state": state}, losses, ms


def captured_training_phase(card_line: str) -> tuple[dict, dict]:
    """``fit`` through the captured train step against the eager step,
    BERT-base at full width with dropout 0.1, in f32, bf16
    (``mixed_precision()``) and f16 (``"dp+f16"``): from one state, 5 steps
    of ``Estimator.train_step`` called eagerly (twice: the two runs must
    agree on every leaf) and 5 steps through ``fit`` (the first eager and
    captured, four replays) must give the same losses, parameters and
    Adam moments bit for bit; 5 more replayed steps launch 12 + 12 flash,
    1 Adam and 1 + 1 cross-entropy kernels a step.  Then bf16 under
    ``ZOO_STEPS_PER_DISPATCH``'s K=4: ``warmup`` (the K=1 and the K=4
    captures on fresh buffers), 8 steps (two replays of 4) equal to 8
    steps at K=1.  Logs the host clock a step, eager and captured, and
    each capture's seconds.  Returns the replayed steps' launch counts and
    the captured host clocks."""
    import torch

    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.common.compile_cache import compile_stats
    from analytics_zoo_tpu_torch.parallel import mixed_precision
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import Adam

    gen = np.random.default_rng(SEED + 9)
    x, y = train_data(TRAIN_BATCH * K_STEPS, gen)
    blocks = BERT_BASE["n_block"]
    per_step = {"flash_attention_fwd": blocks, "flash_attention_bwd": blocks,
                "fused_adam": 1, "softmax_xent_fwd": 1,
                "softmax_xent_bwd": 1, "int8_matmul": 0, "int8_conv": 0,
                "quantize_act": 0}

    def fresh(k=1):
        init_zoo_context(seed=SEED, device="cuda", steps_per_dispatch=k)
        net = bert_classifier(blocks, DROPOUT, DROPOUT)
        net.build_params()
        net.compile(optimizer=Adam(2e-5),
                    loss="sparse_categorical_crossentropy_from_logits")
        return net

    launches, host = {}, {}
    for tag, plan in (("f32", None), ("bf16", mixed_precision()),
                      ("f16", "dp+f16")):
        net = fresh()
        cx = [a[:TRAIN_BATCH * CAPTURE_STEPS] for a in x]
        cy = y[:TRAIN_BATCH * CAPTURE_STEPS]
        first, l_first, _ = eager_steps(net, plan, cx, cy, CAPTURE_STEPS)
        want, l_want, eager_ms = eager_steps(net, plan, cx, cy,
                                             CAPTURE_STEPS)
        drift = differing(first, want)
        if drift or l_first != l_want:
            log(f"captured training {tag}: two eager runs differ at "
                f"{drift[:8]} ({len(drift)} leaves); losses {l_first} / "
                f"{l_want}")
            raise AssertionError(f"the eager {tag} step is not "
                                 "deterministic")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(cx, cy, batch_size=TRAIN_BATCH, nb_epoch=1, plan=plan)
        torch.cuda.synchronize()
        first_fit_ms = (time.perf_counter() - t0) * 1e3
        est = net._estimator
        losses = [v for _, v in est.loss_log]
        got = {"params": net.params, "opt": est._opt_state}
        off = differing(got, want)
        log(f"captured training {tag}: {CAPTURE_STEPS} steps through fit "
            f"(step 1 eager and captured, then replays) against "
            f"train_step eagerly: losses equal {losses == l_want}, "
            f"{len(named_leaves(got)) - len(off)} of "
            f"{len(named_leaves(got))} parameter and Adam leaves equal bit "
            f"for bit{'; differ: ' + str(off[:8]) if off else ''}")
        if losses != l_want or off:
            raise AssertionError(f"the captured {tag} step is not the eager "
                                 "step")
        reset_counters()  # the replayed steps: from here to the read below
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(cx, cy, batch_size=TRAIN_BATCH, nb_epoch=1, plan=plan)
        torch.cuda.synchronize()
        host[tag] = (time.perf_counter() - t0) * 1e3 / CAPTURE_STEPS
        counted = counters()  # end of the replayed steps
        launches = {k: launches.get(k, 0) + v for k, v in counted.items()}
        expected = {k: v * CAPTURE_STEPS for k, v in per_step.items()}
        log(f"captured training {tag}: host clock {host[tag]:.2f} ms a "
            f"replayed step, {eager_ms:.2f} eager ({card_line}); the first "
            f"fit (eager step 1, the capture, 4 replays) {first_fit_ms:.0f}"
            f" ms; launches under replay {counted} (expected {expected})")
        if counted != expected:
            raise AssertionError(f"the {tag} replays did not count their "
                                 "kernels")

    # K-step dispatch: K=4 over 8 steps (warmed up first) against K=1
    ref = fresh(1)
    ref.fit(x, y, batch_size=TRAIN_BATCH, nb_epoch=1,
            plan=mixed_precision())
    net = fresh(K)
    net._estimator = net._make_estimator()
    warm = net._estimator.warmup({"x": [a[:TRAIN_BATCH] for a in x],
                                  "y": y[:TRAIN_BATCH]},
                                 plan=mixed_precision())
    reset_counters()  # the K=4 dispatches: from here to the read below
    net.fit(x, y, batch_size=TRAIN_BATCH, nb_epoch=1,
            plan=mixed_precision())
    torch.cuda.synchronize()
    counted = counters()
    kl = [v for _, v in net._estimator.loss_log]
    rl = [v for _, v in ref._estimator.loss_log]
    off = differing({"p": net.params, "o": net._estimator._opt_state},
                    {"p": ref.params, "o": ref._estimator._opt_state})
    log(f"captured training bf16, K={K}: warmup {warm}; {K_STEPS} steps in "
        f"{K_STEPS // K} dispatches against K=1: losses equal {kl == rl}, "
        f"leaves differing {off[:8]}; launches {counted}")
    if kl != rl or off or counted != {k: v * K_STEPS
                                      for k, v in per_step.items()}:
        raise AssertionError(f"K={K} is not K=1")
    stats = compile_stats()
    log("compile plane: " + "; ".join(
        f"{label} {row['misses']} miss(es) "
        f"[{', '.join(f'{t:.2f}' for t in row['seconds'])} s], "
        f"{row['hits']} hit(s)" for label, row in sorted(stats.items())))
    return launches, host


def training_d192_phase(card_line: str) -> dict:
    """BERT-base's width with 4 heads (head dim 192: the chunked
    tensor-core forward and backward) fine-tuned through ``fit`` for 3
    steps at batch 8 x 512 in f32, dropout 0.1: every step launches 12
    forward and 12 backward flash kernels."""
    import torch

    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import Adam

    init_zoo_context(seed=SEED, device="cuda")
    gen = np.random.default_rng(SEED + 7)
    net = bert_classifier(BERT_BASE["n_block"], DROPOUT, DROPOUT,
                          n_head=D192_HEADS)
    net.build_params()
    net.compile(optimizer=Adam(2e-5),
                loss="sparse_categorical_crossentropy_from_logits")
    x, y = train_data(TRAIN_BATCH * D192_STEPS, gen)
    net.fit([a[:TRAIN_BATCH] for a in x], y[:TRAIN_BATCH],
            batch_size=TRAIN_BATCH, nb_epoch=1)  # warm-up, not counted
    torch.cuda.synchronize()

    reset_counters()  # head-dim-192 training path: from here to the read
    t0 = time.perf_counter()
    net.fit(x, y, batch_size=TRAIN_BATCH, nb_epoch=1)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / D192_STEPS
    launches = counters()  # end of the path
    losses = [v for _, v in net._estimator.loss_log[-D192_STEPS:]]
    blocks = BERT_BASE["n_block"]
    expected = {"flash_attention_fwd": blocks * D192_STEPS,
                "flash_attention_bwd": blocks * D192_STEPS,
                "fused_adam": D192_STEPS, "softmax_xent_fwd": D192_STEPS,
                "softmax_xent_bwd": D192_STEPS, "int8_matmul": 0,
                "int8_conv": 0,
                "quantize_act": 0}
    log(f"training at head dim 192 ({D192_HEADS} heads): {D192_STEPS} steps"
        f" at batch {TRAIN_BATCH} x {SEQ}: {step_ms:.1f} ms per step "
        f"({card_line}); losses " + ", ".join(f"{v:.4f}" for v in losses)
        + f"; launches {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError("a head-dim-192 training call did not run "
                             "through its kernel")
    if len(losses) != D192_STEPS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"head-dim-192 losses not finite: {losses}")
    return launches


def serving_d384_phase(card_line: str) -> dict:
    """BERT-base's width with 2 heads (head dim 384, the chunked
    tensor-core forward) served through ``InferenceModel``: one 8-record
    request, 12 flash launches."""
    import torch

    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

    init_zoo_context(seed=SEED, device="cuda")
    net = bert_model(n_head=D384_HEADS)
    net.build_params()
    im = InferenceModel().from_keras_net(net)
    im.warmup([(SEQ,)] * 4, dtype=REQ_DTYPES, batch_sizes=(D384_RECORDS,))
    xs = requests_of(D384_RECORDS, np.random.default_rng(SEED + 8))
    torch.cuda.synchronize()

    reset_counters()  # head-dim-384 serving path: from here to the read
    t0 = time.perf_counter()
    out = im.predict(xs)
    ms = (time.perf_counter() - t0) * 1e3
    launches = counters()  # end of the path
    log(f"serving at head dim 384 ({D384_HEADS} heads): {len(out)} records "
        f"in {ms:.2f} ms ({card_line}); launches {launches}")
    if out.shape != (D384_RECORDS, 2) or not np.isfinite(out).all() \
            or not np.allclose(out.sum(axis=1), 1.0, atol=1e-5):
        raise AssertionError(f"head-dim-384 request: bad output {out}")
    if launches["flash_attention_fwd"] != BERT_BASE["n_block"] \
            or launches["flash_attention_bwd"] != 0:
        raise AssertionError("head-dim-384 attention did not run through "
                             "the kernel")
    return launches


# the captured-serving phase: the buckets whose replays are held against
# the eager forward, the four-thread check, the request sizes timed eager
# and replayed, and the buckets whose graph memory pools are measured
SERVE_BUCKETS = (1, 2, 4, 8)
THREADS, THREAD_REQUESTS = 4, 20
HOST_REPEATS = 5
POOL_BUCKETS = (1, 8, 64)
# the launch counts of the captured evaluations (tag -> counts), filled by
# the training phases
EVAL_LAUNCHES: dict = {}


def captured_eval(tag: str, est, x, y, card_line: str) -> dict:
    """``est.evaluate`` over (x, y) at batch TRAIN_BATCH: its first call
    captured the eval step, this one replays it.  The results must equal
    bit for bit those of the same loop with the step uncaptured, and the
    replays must launch 12 flash forwards and one cross-entropy a batch.
    Records the replays' launch counts in ``EVAL_LAUNCHES[tag]``."""
    import torch

    from analytics_zoo_tpu_torch.feature.dataset import FeatureSet
    from analytics_zoo_tpu_torch.parallel import compile_step

    plan = est._resolve_plan()
    params, state = est.model.params, est.model.state
    fs = FeatureSet.of(x, y)
    eager = est._evaluate_with(
        params, state, fs, TRAIN_BATCH, est.compute_casts(plan, params),
        step=compile_step(est.eval_step, plan, label="eval_step_eager",
                          capture=False))
    reset_counters()  # the replayed evaluation: from here to the read
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = est.evaluate(fs, batch_size=TRAIN_BATCH)
    ms = (time.perf_counter() - t0) * 1e3
    counted = counters()  # end of the replayed evaluation
    batches = -(-len(y) // TRAIN_BATCH)
    expected = dict({k: 0 for k in counted},
                    flash_attention_fwd=BERT_BASE["n_block"] * batches,
                    softmax_xent_fwd=batches)
    log(f"captured eval {tag}: {batches} batches replayed in {ms:.2f} ms "
        f"({card_line}); {got} against the uncaptured step's {eager}"
        f" (equal: {got == eager}); launches {counted} (expected "
        f"{expected})")
    if got != eager:
        raise AssertionError(f"the captured {tag} eval is not the eager one")
    if counted != expected:
        raise AssertionError(f"the captured {tag} eval did not count its "
                             "kernels")
    EVAL_LAUNCHES[tag] = counted
    return counted


def eager_predict(im, xs):
    """What ``InferenceModel.predict`` ran before its forward was captured:
    one micro-batch padded to its bucket, copied up, the model's forward
    run eagerly, the outputs copied back."""
    from analytics_zoo_tpu_torch.pipeline.inference.inference_model import (
        _bucket,
    )

    n = len(xs[0])
    b = _bucket(n, im.max_batch)
    ts = [torch_from(np.concatenate(
        [a, np.zeros((b - n,) + a.shape[1:], a.dtype)]), im._net.device)
        for a in xs]
    out = im._forward_fn()(im._params, im._state, ts)
    if isinstance(out, (list, tuple)):  # one array a head
        return [o.cpu().numpy()[:n] for o in out]
    return out.cpu().numpy()[:n]


def torch_from(a, device):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def pool_sizes(im, gen, share: bool) -> list:
    """The bytes each of the POOL_BUCKETS f32 captures of ``im``'s forward
    adds to ``torch.cuda.memory_reserved()`` (the eager run's memory given
    back first), each in a pool of its own (a capture group of its own),
    or all in one shared pool, captured largest first as ``warmup`` does
    (returned in POOL_BUCKETS' order)."""
    import torch

    from analytics_zoo_tpu_torch.parallel import CaptureGroup, compile_step

    fwd = im._forward_fn()
    group = CaptureGroup() if share else None
    steps, sizes = [], {}
    for b in sorted(POOL_BUCKETS, reverse=share):
        xs = [torch_from(a, "cuda") for a in requests_of(b, gen)]
        step = compile_step(fwd, label=f"pool_b{b}", ref_argnums=(0, 1),
                            group=group or CaptureGroup())
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved()
        step(im._params, im._state, xs)
        torch.cuda.synchronize()
        del xs
        torch.cuda.empty_cache()
        sizes[b] = torch.cuda.memory_reserved() - before
        steps.append(step)  # the capture holds its pool while it lives
    del steps
    torch.cuda.empty_cache()
    return [sizes[b] for b in POOL_BUCKETS]


def captured_serving_phase(card_line: str) -> dict:
    """``InferenceModel.predict`` through its captured buckets, BERT-base
    at full width, sequence 512: f32, bf16, weight-only int8 (the 4-input
    model) and calibrated int8 (the token-ids model) warmed up at buckets
    1, 2, 4 and 8; a request of each bucket's size must equal the eager
    forward bit for bit; four threads each send their own 8-record request
    20 times to the f32 model and get its eager answer each time; the
    replays launch 12 flash forwards a micro-batch; ``KerasNet.predict`` at
    batch 8 equals the f32 model's 8-record answer bit for bit and
    ``predict_classes`` its argmax.  Logs the memory reserved after the
    warmups, what each capture's graph pool holds at 1, 8 and 64 records
    (pools of their own and one shared pool), and the host clock of the
    1-, 3-, 8- and 2-record f32 requests and the 8-record bf16 request,
    eager and replayed.  Returns the replays' launch counts."""
    import gc
    import threading

    import torch

    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.common.compile_cache import compile_stats
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

    init_zoo_context(seed=SEED, device="cuda")
    gen = np.random.default_rng(SEED + 10)
    net, tok_net = bert_model(), bert_tokens_model()
    net.build_params()
    tok_net.build_params()
    calib = requests_of(N_CALIB, gen)[0]
    models = {
        "f32": InferenceModel().from_keras_net(net),
        "bf16": InferenceModel().from_keras_net(net).optimize("bf16"),
        "int8 weight-only": InferenceModel().from_keras_net(net).optimize(
            "int8"),
        "int8 calibrated": InferenceModel().from_keras_net(tok_net).optimize(
            "int8", calibration_data=calib)}
    torch.cuda.synchronize()
    gc.collect()  # the earlier phases' captures and models
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    for tag, im in models.items():
        if tag == "int8 calibrated":
            im.warmup([(SEQ,)], dtype=np.int32, batch_sizes=SERVE_BUCKETS)
        else:
            im.warmup([(SEQ,)] * 4, dtype=REQ_DTYPES,
                      batch_sizes=SERVE_BUCKETS)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    stats = compile_stats()
    log(f"captured serving: {len(models)} models x {len(SERVE_BUCKETS)} "
        f"buckets warmed up (captured) in {warm_s:.1f} s; memory reserved "
        f"after warmup {torch.cuda.memory_reserved()} B, "
        f"{torch.cuda.memory_reserved() - before} B more than with the "
        f"models' weights alone ({card_line}); captures: " + "; ".join(
            f"{b}: {stats[b]['misses']} miss(es) "
            f"[{', '.join(f'{t:.2f}' for t in stats[b]['seconds'])} s]"
            for b in sorted(stats) if b.startswith("inference_b")))

    def pick(tag, r):
        return r[0] if tag == "int8 calibrated" else r

    reqs = {b: requests_of(b, gen) for b in SERVE_BUCKETS}
    thread_reqs = [requests_of(8, gen) for _ in range(THREADS)]
    # the eager answers first: their launches are not the replays'
    want = {(tag, b): eager_predict(im, [pick(tag, reqs[b])]
                                    if tag == "int8 calibrated"
                                    else reqs[b])
            for tag, im in models.items() for b in SERVE_BUCKETS}
    thread_want = [eager_predict(models["f32"], r) for r in thread_reqs]
    torch.cuda.synchronize()

    reset_counters()  # captured serving: from here to the read below
    got = {(tag, b): im.predict(pick(tag, reqs[b]))
           for tag, im in models.items() for b in SERVE_BUCKETS}
    wrong = []
    start = threading.Barrier(THREADS)

    def send(i):
        start.wait()
        for _ in range(THREAD_REQUESTS):
            if not np.array_equal(models["f32"].predict(thread_reqs[i]),
                                  thread_want[i]):
                wrong.append(i)

    threads = [threading.Thread(target=send, args=(i,))
               for i in range(THREADS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    thread_s = time.perf_counter() - t0
    launches = counters()  # end of captured serving
    for (tag, b), out in got.items():
        same = np.array_equal(out, want[tag, b])
        log(f"captured serving {tag}, bucket {b}: replay equal to the eager "
            f"forward bit for bit: {same} (max|d| "
            f"{float(np.abs(out - want[tag, b]).max()):.3e})")
        if not same:
            raise AssertionError(f"the {tag} bucket-{b} replay is not the "
                                 "eager forward")
    replays = len(got) + THREADS * THREAD_REQUESTS
    # the calibrated model's int8 layers (its Dense head) run quantize_act
    # and int8_conv
    int8_layers = len(models["int8 calibrated"]._int8_model.weights_t)
    int8_replays = int8_layers * sum(tag == "int8 calibrated"
                                     for tag, _ in got)
    expected = dict({k: 0 for k in launches},
                    flash_attention_fwd=BERT_BASE["n_block"] * replays,
                    int8_conv=int8_replays, quantize_act=int8_replays)
    log(f"captured serving: {THREADS} threads x {THREAD_REQUESTS} 8-record "
        f"requests on one bucket in {thread_s:.2f} s, {len(wrong)} answers "
        f"not their request's eager answer; launches under replay "
        f"{launches} (expected {expected}: {BERT_BASE['n_block']} flash a "
        f"micro-batch x {replays})")
    if wrong:
        raise AssertionError(f"concurrent requests got other answers: "
                             f"threads {sorted(set(wrong))}")
    if launches != expected:
        raise AssertionError("a replayed request did not count its kernels")

    # KerasNet.predict (the predict_step program) against InferenceModel on
    # the same weights and the same 8 records
    kp = [net.predict(reqs[8], batch_size=8) for _ in range(2)]
    classes = net.predict_classes(reqs[8], batch_size=8)
    same = all(np.array_equal(k, got["f32", 8]) for k in kp)
    log(f"KerasNet.predict at batch 8 (captured, then replayed) against "
        f"InferenceModel.predict: equal bit for bit {same}; predict_classes "
        f"{classes.tolist()}")
    if not same or not np.array_equal(classes, np.argmax(kp[0], axis=-1)):
        raise AssertionError("KerasNet.predict disagrees with "
                             "InferenceModel.predict")

    # the host clock of a request, eager (the forward as predict ran it
    # before) and replayed, interleaved
    f32, bf16 = models["f32"], models["bf16"]
    cases = [(f"f32 {n} records", f32, requests_of(n, gen))
             for n in REQUEST_SIZES]
    cases.append(("bf16 8 records", bf16, reqs[8]))
    times = {name: {"eager": [], "replayed": []} for name, _, _ in cases}
    for _ in range(HOST_REPEATS):
        for name, im, xs in cases:
            for kind, run in (("eager", eager_predict),
                              ("replayed", InferenceModel.predict)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(im, xs)
                times[name][kind].append((time.perf_counter() - t0) * 1e3)
    for name, row in times.items():
        log(f"request host clock, {name}: eager "
            f"{', '.join(f'{t:.3f}' for t in row['eager'])} ms (median "
            f"{float(np.median(row['eager'])):.3f}); replayed "
            f"{', '.join(f'{t:.3f}' for t in row['replayed'])} ms (median "
            f"{float(np.median(row['replayed'])):.3f}; {card_line})")

    own = pool_sizes(f32, gen, share=False)
    shared = pool_sizes(f32, gen, share=True)
    log(f"graph memory pools of the f32 forward at {POOL_BUCKETS} records x "
        f"{SEQ}: own pools {own} B (sum {sum(own)}); one shared pool, "
        f"captured largest first, {shared} B more each (sum {sum(shared)})")
    return launches


def rel_l2(got, want) -> float:
    """||got - want|| / ||want|| over the whole tensor, in f32."""
    diff = got.float() - want.float()
    return (diff.norm() / want.float().norm().clamp_min(1e-30)).item()


def int8_weights(dev) -> dict:
    """The 50 quantized Dense kernels of the serving BERT-base (48 encoder,
    the pooler and the head), by leaf path, on ``dev``: the seeded tree
    through ``quantize_params_for_plan(params, int8_serving())``."""
    import re

    from analytics_zoo_tpu_torch.common.engine import make_generator
    from analytics_zoo_tpu_torch.common.utils import tree_map
    from analytics_zoo_tpu_torch.parallel import int8_serving
    from analytics_zoo_tpu_torch.parallel.partition import (
        leaf_path_name,
        tree_map_with_path,
    )
    from analytics_zoo_tpu_torch.pipeline.inference.quantize import (
        QuantizedTensor,
        quantize_params_for_plan,
    )

    params = tree_map(lambda t: t.to(dev),
                      bert_model().init_params(make_generator(SEED)))
    out = {}

    def pick(path, leaf):
        name = leaf_path_name(path)
        if isinstance(leaf, QuantizedTensor) and re.search(DENSE_KERNELS,
                                                           name):
            out[name] = leaf
        return leaf

    tree_map_with_path(pick, quantize_params_for_plan(params, int8_serving()))
    if len(out) != 4 * BERT_BASE["n_block"] + 2:
        raise AssertionError(f"expected 50 quantized Dense kernels, got "
                             f"{len(out)}")
    return out


def int8_rows(path: str) -> int:
    """Rows of the activations a Dense kernel sees for one 8 x 512
    micro-batch: every token in the encoder, one per record after it."""
    return 8 if "pooler" in path or path.startswith("dense_0") else 8 * SEQ


def int8_kernel_phase(dev, weights) -> dict:
    """The int8 matmul kernel against its plain version at BERT-base's six
    Dense shapes, f32, bf16 and f16 x at all six."""
    import torch

    from analytics_zoo_tpu_torch.ops.cuda import int8_matmul as im8

    gen = np.random.default_rng(SEED + 5)
    shapes = [(label, f"bert_0/blocks/0/{label}_kernel")
              for label in ("qkv", "proj", "fc", "out")]
    shapes += [("pooler", "bert_0/pooler_kernel"), ("head", "dense_0/kernel")]
    rows, errs = [], []
    for label, path in shapes:
        qt = weights[path]
        values, scale = qt.values, qt.scale.reshape(-1)
        (k, n), m = values.shape, int8_rows(path)
        x = torch.from_numpy(gen.normal(size=(m, k)).astype(np.float32)
                             ).to(dev)
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            name = str(dtype).split(".")[1]
            xx = x.to(dtype)
            got = im8.int8_matmul(xx, values, scale)
            want = im8._reference(xx.float(), values, scale)
            torch.cuda.synchronize()
            rel = rel_l2(got, want)
            abs_err = (got.float() - want).abs().max().item()
            tol = {torch.float32: INT8_F32_TOL, torch.bfloat16: INT8_BF16_TOL,
                   torch.float16: INT8_F16_TOL}[dtype]
            log(f"kernel int8 {label} ({m}, {k}, {n}) {name}: relative L2 "
                f"{rel:.3e} (tol {tol:g}), max|d| {abs_err:.3e}")
            if not rel <= tol or got.dtype != dtype \
                    or not torch.isfinite(got.float()).all():
                raise AssertionError(f"int8 matmul {label} {name} disagrees:"
                                     f" {rel}")
            wdeq = values.to(dtype) * scale.to(dtype)
            row = {"shape": label, "m": m, "k": k, "n": n, "dtype": name,
                   "rel_l2": rel, "max_abs_err": abs_err}
            row.update(graph_timed(
                lambda: im8.int8_matmul(xx, values, scale),
                lambda: im8._reference(xx, values, scale),
                lambda: xx @ wdeq))
            # x, W (1 byte), the scale and the output moved once; 2 M K N
            # operations at bf16's tensor-core peak, three times over for
            # f32 x (the kernel's route: three bf16 products a value), with
            # the f32 CUDA-core figure beside it
            esize = xx.element_size()
            nbytes = m * k * esize + k * n + 4 * n + m * n * esize
            flops = 2.0 * m * k * n
            cc = ""
            if dtype == torch.float32:
                row.update(bound(nbytes, 3 * flops, "bfloat16"))
                row["bound_cuda_core_ms"] = bound(nbytes, flops)["bound_ms"]
                cc = f"; f32 on CUDA cores {row['bound_cuda_core_ms']:.4f} ms"
            else:
                row.update(bound(nbytes, flops, name))
            log(f"kernel int8 {label} {name}: {row['ms']:.4f} ms (graph "
                f"{row['graph_ms']:.4f}), plain {row['plain_ms']:.4f} ms, "
                f"dequantize+matmul {row['library_ms']:.4f} ms (graph "
                f"{row['library_graph_ms']:.4f}), bound {row['bound_ms']:.4f}"
                f" ms ({row['bound_by']}{cc})")
            rows.append(row)
            if dtype == torch.float32:
                errs.append(abs_err)
    blocks = BERT_BASE["n_block"]
    passes = {}
    for name in ("float32", "bfloat16", "float16"):
        by = {r["shape"]: r for r in rows if r["dtype"] == name}
        keys = ["ms", "graph_ms", "plain_ms", "library_ms",
                "library_graph_ms", "bound_ms"]
        keys += ["bound_cuda_core_ms"] if name == "float32" else []
        passes[name] = {key: blocks * sum(by[s][key] for s in
                                          ("qkv", "proj", "fc", "out"))
                        + by["pooler"][key] + by["head"][key]
                        for key in keys}
        log(f"kernel int8 {name}, one BERT-base pass (12 blocks, pooler, "
            f"head): {passes[name]['ms']:.3f} ms (graph "
            f"{passes[name]['graph_ms']:.3f}), bound "
            f"{passes[name]['bound_ms']:.3f} ms, dequantize+matmul "
            f"{passes[name]['library_ms']:.3f} ms (graph "
            f"{passes[name]['library_graph_ms']:.3f})")
    per_pass = passes["float32"]
    f32 = {r["shape"]: r for r in rows if r["dtype"] == "float32"}
    entry = {"name": "int8_matmul", "route": "cuda",
             "source": "analytics_zoo_tpu_torch/csrc/int8_matmul.cu",
             "replaces": REPLACES["int8_matmul"], "max_abs_err": max(errs)}
    entry.update({k: f32["qkv"][k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")})
    entry["shapes"] = rows
    entry["f32_pass"] = per_pass
    entry["bf16_pass"] = passes["bfloat16"]
    entry["f16_pass"] = passes["float16"]
    return entry


def any_x_check(qt) -> None:
    """``quantized_matmul`` under the int8 kernel plan on a (B, L, K) x and
    on a transposed (M, K) view of the same values: one kernel launch each
    (x flattened into one contiguous operand), the output in x's leading
    dims, within INT8_F32_TOL of dequantize-then-matmul."""
    import torch

    from analytics_zoo_tpu_torch.ops.cuda import int8_matmul as im8
    from analytics_zoo_tpu_torch.parallel import (
        compile_step,
        int8_serving,
        with_kernels,
    )
    from analytics_zoo_tpu_torch.pipeline.inference.quantize import (
        quantized_matmul,
    )

    gen = np.random.default_rng(SEED + 8)
    (k, n), dev = qt.values.shape, qt.values.device
    x = torch.from_numpy(gen.normal(size=INT8_ANY_X + (k,)).astype(
        np.float32)).to(dev)
    xt = x.reshape(-1, k).t().contiguous().t()  # the values, column-major
    want = x.reshape(-1, k) @ qt.dequantize()
    step = compile_step(lambda t: quantized_matmul(t, qt),
                        with_kernels(int8_serving()), label="int8_any_x")
    for tag, xx in (("(B, L, K)", x), ("transposed (M, K)", xt)):
        before = im8.launch_count
        out = step(xx)
        torch.cuda.synchronize()
        launched = im8.launch_count - before
        rel = rel_l2(out.reshape(want.shape), want)
        log(f"int8 quantized_matmul on a {tag} x {tuple(xx.shape)} "
            f"(contiguous: {xx.is_contiguous()}): {launched} launch(es), "
            f"output {tuple(out.shape)}, relative L2 {rel:.3e} from "
            f"dequantize+matmul (tol {INT8_F32_TOL:g})")
        if launched != 1 or tuple(out.shape) != tuple(xx.shape[:-1]) + (n,) \
                or not rel <= INT8_F32_TOL:
            raise AssertionError(f"quantized_matmul on a {tag} x disagrees")


# ---------------------------------------------------------------------------
# the calibrated int8 layer's kernels (csrc/int8_conv.cu): ``int8_conv``
# at ResNet-50's distinct conv shapes and its fc (a 1x1 over the rows) at
# INT8_CONV_BATCHES images, BERT's calibrated head (a 1x1 over 8 rows), one
# rank-1 atrous and one rank-3 case; ``quantize_act`` at ResNet-50's input
# shapes.  The convolution's plain version sums int32 matmuls, which CUDA
# has not: it runs on the host CPU, on copies of the same int8 operands
# (unpadded: the kernel takes the channels padded to 16)
INT8_CONV_BATCHES = (32, 1)
INT8_CONV_EXTRA = (
    ("bert_head", 8, (1,), 768, 2, (1,), (1,), (1,), ((0, 0),), 0),
    ("atrous_1d", 8, (512,), 64, 64, (3,), (1,), (2,), ((2, 2),), 0),
    ("conv_3d", 4, (8, 28, 28), 32, 64, (3, 3, 3), (1, 2, 2), (1, 1, 1),
     ((1, 1), (0, 1), (0, 1)), 0),
)
# the fused modes held against the plain epilogue: (bias, relu)
INT8_FUSED_MODES = ((False, False), (True, False), (True, True))
# the split-K shape replayed twice from one graph: ResNet-50's last 3x3
# at one image
SPLIT_K_CASE = ("3x3/1 512->512 at 7, 1 image", 1, (7, 7), 512, 512,
                (3, 3), (1, 1), (1, 1), ((1, 1), (1, 1)), 0)


def resnet50_int8_shapes(batch: int) -> list:
    """(label, images, spatial, cin, cout, kernel, strides, dilation, pads,
    count in the net) of each distinct conv of ResNet-50 at ``batch``
    images (224x224x3, pads as ``_int8_conv`` pads it) and its fc."""
    from analytics_zoo_tpu_torch.models import ResNet
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.conv import (
        _ConvND,
    )
    from analytics_zoo_tpu_torch.pipeline.inference.quantize import (
        _conv_pads,
    )

    net = ResNet.image_net(50, classes=RESNET_CLASSES,
                           input_shape=RESNET_SHAPE)
    seen = {}
    for layer in net.layers:
        shape = tuple(layer._build_shape) if isinstance(
            layer, (_ConvND, Dense)) else None
        if isinstance(layer, _ConvND):
            key = (shape[:-1], shape[-1], layer.nb_filter,
                   layer.kernel_size, layer.subsample, layer.dilation,
                   _conv_pads(layer, shape[:-1]))
        elif isinstance(layer, Dense):
            key = ((1,), shape[-1], layer.output_dim, (1,), (1,), (1,),
                   ((0, 0),))
        else:
            continue
        seen[key] = seen.get(key, 0) + 1
    out = []
    for (spatial, cin, cout, ks, st, dil, pads), count in seen.items():
        label = ("fc" if spatial == (1,) else
                 f"{'x'.join(map(str, ks))}/{st[0]} {cin}->{cout} at "
                 f"{spatial[0]}")
        if batch == 1:
            label += ", 1 image"
        out.append((label, batch, spatial, cin, cout, ks, st, dil, pads,
                    count))
    return out


def epilogue_operands(cout: int, gen):
    """An epilogue's mult (act_scale * w_scale sized) and bias, f32, with
    every 7th channel's mult 0 and bias -0 (a negative sum there gives -0,
    which ReLU turns to +0)."""
    import torch

    mult = (np.float32(0.0123) * gen.uniform(1e-3, 1e-2, cout).astype(
        np.float32)).astype(np.float32)
    bias = gen.standard_normal(cout, dtype=np.float32)
    mult[::7] = 0.0
    bias[::7] = -0.0
    return torch.from_numpy(mult), torch.from_numpy(bias)


def int8_conv_case(dev, case, gen) -> dict:
    """One shape: the kernel on padded operands against its plain version
    on the unpadded ones, bit for bit, in the int32 mode and in each fused
    mode of INT8_FUSED_MODES; the fused mode the calibrated ResNet-50 runs
    (mult alone) timed through the wrapper and from a graph, beside its
    bound, the plain version's host time and two yardsticks the port never
    calls: cuDNN's f32 convolution and ``torch._int_mm`` over an im2col
    copy of the padded operands."""
    import torch
    import torch.nn.functional as F

    from analytics_zoo_tpu_torch.ops.cuda import int8_conv as ic8

    label, n, spatial, cin, cout, ks, st, dil, pads, count = case
    r = len(spatial)
    x = torch.from_numpy(gen.integers(-127, 128, (n,) + spatial + (cin,),
                                      dtype=np.int8))
    w = torch.from_numpy(gen.integers(-127, 128, ks + (cin, cout),
                                      dtype=np.int8))
    w_t = ic8.conv_weight_t(w)
    cp = ic8.padded_channels(cin)
    xd = F.pad(x, (0, cp - cin)).to(dev)
    wd = ic8.conv_weight_t(w, pad=True).to(dev)
    mult, bias = epilogue_operands(cout, gen)
    md, bd = mult.to(dev), bias.to(dev)
    tk = ic8.new_tickets(dev)
    args = (ks, st, dil, pads)
    got = ic8.int8_conv(xd, wd, *args, tickets=tk)
    fused = {mode: ic8.int8_conv(xd, wd, *args, mult=md,
                                 bias=bd if mode[0] else None, relu=mode[1],
                                 tickets=tk)
             for mode in INT8_FUSED_MODES}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = ic8.int8_conv_reference(x, w_t, *args)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = (got.cpu().long() - want.long()).abs().max().item()
    unequal = [mode for mode, y in fused.items() if not torch.equal(
        y.cpu().view(torch.int32), ic8.int8_epilogue_reference(
            want, mult, bias if mode[0] else None, mode[1]).view(
                torch.int32))]
    out = tuple(got.shape[1:-1])
    m, k = n * int(np.prod(out)), wd.shape[1]
    bn, split, _ = ic8.plan(m, k, cout, int(np.prod(ks)))
    log(f"kernel int8_conv {label} ({n} x {spatial} x {cin} (padded {cp}) "
        f"-> {out} x {cout}, K {k}; tile 128 x {bn}, K split {split}): "
        f"int32 sums equal to the plain version bit for bit {err == 0}; "
        f"fused (bias, relu) modes not bit for bit: {unequal}")
    if err != 0 or got.dtype != torch.int32 or unequal:
        raise AssertionError(f"int8_conv {label} disagrees with its plain "
                             f"version: max |d| {err}, fused {unequal}")
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    xcf = F.pad(x.to(dev).float().permute(0, r + 1, *range(1, r + 1)), flat)
    wcf = w_t.to(dev).float().reshape(cout, *ks, cin).permute(
        0, r + 1, *range(1, r + 1)).contiguous()
    conv = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[r]

    def im2col_int_mm():
        xp = F.pad(xd, [0, 0] + flat)
        cols = torch.cat([xp[(slice(None),) + tuple(
            slice(i * d, i * d + (o - 1) * s + 1, s)
            for i, d, o, s in zip(tap, dil, out, st))]
            for tap in np.ndindex(*ks)], dim=-1)
        return torch._int_mm(cols.reshape(m, k), wd.t())

    def call():
        return ic8.int8_conv(xd, wd, *args, mult=md, tickets=tk)

    mm = library_call(lambda: im2col_int_mm)
    row = {"shape": label, "count": count, "m": m, "k": k, "n": cout,
           "tile_n": bn, "split": split, "ms": cuda_ms(call),
           "graph_ms": graph_ms(call), "plain_ms": plain_ms,
           "library_ms": cuda_ms(lambda: conv(xcf, wcf, stride=st,
                                              dilation=dil)),
           "int_mm_ms": None if mm is None else cuda_ms(mm),
           "max_abs_err": err}
    if mm is not None:
        row["int_mm_equal"] = bool(torch.equal(mm().reshape(got.shape),
                                               got))
    # the function's bound, over the unpadded operands: x and the kernel
    # (one byte an element) read once, mult read once, the f32 output
    # written once; 2 M (taps Cin) Cout operations at the int8 tensor-core
    # peak.  The same over the padded operands the kernel reads is the
    # padding's cost, kept beside it
    row.update(bound(x.numel() + w_t.numel() + 4 * cout + 4 * m * cout,
                     2.0 * m * w_t.shape[1] * cout, "int8"))
    row["padded_bound_ms"] = bound(
        xd.numel() + wd.numel() + 4 * cout + 4 * m * cout,
        2.0 * m * k * cout, "int8")["bound_ms"]
    int_mm = "none" if mm is None else f"{row['int_mm_ms']:.4f} ms"
    log(f"kernel int8_conv {label}: {row['ms']:.4f} ms (graph "
        f"{row['graph_ms']:.4f}), plain {plain_ms:.1f} ms on the host CPU, "
        f"cuDNN f32 {row['library_ms']:.4f} ms, im2col + _int_mm {int_mm}, "
        f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}; over the "
        f"padded operands {row['padded_bound_ms']:.4f})")
    return row


def split_k_replay(dev, gen) -> None:
    """SPLIT_K_CASE captured once with tickets of its own (no memset in
    the graph) and replayed twice: both replays give the plain sums, so
    the last block of each tile set its ticket back to 0.  Then the same
    call on two streams at once, each with its own tickets, as two
    calibrated models' layers would run: every result the plain sums."""
    import torch
    import torch.nn.functional as F

    from analytics_zoo_tpu_torch.ops.cuda import int8_conv as ic8

    label, n, spatial, cin, cout, ks, st, dil, pads, _ = SPLIT_K_CASE
    x = torch.from_numpy(gen.integers(-127, 128, (n,) + spatial + (cin,),
                                      dtype=np.int8))
    w = torch.from_numpy(gen.integers(-127, 128, ks + (cin, cout),
                                      dtype=np.int8))
    want = ic8.int8_conv_reference(x, ic8.conv_weight_t(w), ks, st, dil,
                                   pads)
    xd = F.pad(x, (0, ic8.padded_channels(cin) - cin)).to(dev)
    wd = ic8.conv_weight_t(w, pad=True).to(dev)
    split = ic8.plan(n * int(np.prod(want.shape[1:-1])), wd.shape[1],
                     cout, int(np.prod(ks)))[1]
    tk = ic8.new_tickets(dev)
    ic8.int8_conv(xd, wd, ks, st, dil, pads, tickets=tk)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ic8.int8_conv(xd, wd, ks, st, dil, pads, tickets=tk)
    equal = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        equal.append(torch.equal(out.cpu(), want))
    del graph
    log(f"kernel int8_conv split-K ({label}, K split {split}): two replays "
        f"of one graph equal to the plain sums {equal}")
    if split < 2 or not all(equal):
        raise AssertionError("a split-K replay disagrees: the tickets did "
                             "not reset")
    streams = [torch.cuda.Stream() for _ in range(2)]
    tickets = [ic8.new_tickets(dev) for _ in streams]
    outs = []
    for st_ in streams:
        st_.wait_stream(torch.cuda.current_stream())
    for _ in range(16):
        for st_, tk_ in zip(streams, tickets):
            with torch.cuda.stream(st_):
                outs.append(ic8.int8_conv(xd, wd, ks, st, dil, pads,
                                          tickets=tk_))
    torch.cuda.synchronize()
    bad = sum(not torch.equal(o.cpu(), want) for o in outs)
    log(f"kernel int8_conv split-K on two streams at once, tickets of "
        f"their own: {len(outs) - bad} of {len(outs)} results equal to the "
        f"plain sums")
    if bad:
        raise AssertionError(f"split-K on two streams: {bad} results "
                             "disagree")


def quantize_inputs(shape, scale, gen):
    """f32 activations of ``shape`` at ``scale`` whose first values are
    exact .5 ties of the quotient (both parities) and whose last are
    +-127.5, past the clamp and -0."""
    import torch

    x = (gen.standard_normal(shape, dtype=np.float32) * 40 * scale).astype(
        np.float32)
    ties = (np.arange(-130, 130) + 0.5).astype(np.float32) * np.float32(
        scale)
    flat = x.reshape(-1)
    flat[:ties.size] = ties[:flat.size]
    flat[-4:] = np.array(
        [127.5, -127.5, 1e4, -0.0], np.float32) * np.float32(scale)
    return torch.from_numpy(x)


def quantize_case(dev, shape, count, gen) -> dict:
    """``quantize_act`` at one input shape: bit for bit its plain version
    on the card (the reference's f32 division by the scale tensor, round,
    clamp and cast, then the channel padding), timed through the wrapper
    and from a graph beside its bound (4 bytes read and 1 written an
    output, the padding included), its plain version's time and
    ``torch.quantize_per_tensor`` (clamps to [-128, 127] and multiplies by
    the reciprocal: not bit for bit the reference; unpadded)."""
    import torch

    from analytics_zoo_tpu_torch.ops.cuda import int8_conv as ic8

    scale = 0.0371
    xd = quantize_inputs(shape, scale, gen).to(dev)
    sd = torch.tensor(scale, dtype=torch.float32, device=dev)
    cp = ic8.padded_channels(shape[-1])
    got = ic8.quantize_act(xd, sd, cp)
    want = ic8.quantize_act_reference(xd, sd, cp)
    err = (got.long() - want.long()).abs().max().item()
    if err != 0:
        raise AssertionError(f"quantize_act at {shape} disagrees with its "
                             f"plain version: max |d| {err}")

    def call():
        return ic8.quantize_act(xd, sd, cp)

    def plain():
        return ic8.quantize_act_reference(xd, sd, cp)

    lib = library_call(lambda: lambda: torch.quantize_per_tensor(
        xd, scale, 0, torch.qint8))
    row = {"shape": "x".join(map(str, shape)), "count": count,
           "ms": cuda_ms(call), "graph_ms": graph_ms(call),
           "plain_ms": cuda_ms(plain), "plain_graph_ms": graph_ms(plain),
           "library_ms": None if lib is None else cuda_ms(lib),
           "max_abs_err": err}
    # the function's bound: 4 bytes read and 1 written an input element;
    # the padding channels' bytes are the design's cost, kept beside it
    row.update(bound(5 * xd.numel(), 0.0))
    row["padded_bound_ms"] = bound(4 * xd.numel() + got.numel(),
                                   0.0)["bound_ms"]
    lib_ms = "none" if lib is None else f"{row['library_ms']:.4f} ms"
    log(f"kernel quantize_act {row['shape']} (padded to {cp}; {count} in "
        f"the net): bit for bit its plain version True; {row['ms']:.4f} ms "
        f"(graph {row['graph_ms']:.4f}), plain {row['plain_ms']:.4f} ms "
        f"(graph {row['plain_graph_ms']:.4f}), quantize_per_tensor {lib_ms},"
        f" bound {row['bound_ms']:.4f} ms ({row['bound_by']}; with the "
        f"padding {row['padded_bound_ms']:.4f})")
    return row


def pass_total(rows: list, keys) -> dict:
    """Each key summed over ``rows`` times their count in the net (None
    where a row has none), and the bound's kind where most of it lies."""
    net = [r for r in rows if r["count"]]
    total = {key: sum(r[key] * r["count"] for r in net
                      if r.get(key) is not None)
             if any(r.get(key) is not None for r in net) else None
             for key in keys}
    ops_ms = sum(r["bound_ms"] * r["count"] for r in net
                 if r["bound_by"] == "operations")
    total["bound_by"] = "operations" if 2 * ops_ms >= total["bound_ms"] \
        else "bytes"
    total["calls"] = sum(r["count"] for r in net)
    return total


def int8_conv_kernel_phase(dev) -> tuple[dict, dict]:
    """``int8_conv`` against its plain version bit for bit, in the int32
    and the fused modes, at each distinct conv shape of ResNet-50 at each
    of INT8_CONV_BATCHES images, its fc, BERT's calibrated head, one
    rank-1 atrous and one rank-3 case, each timed (``int8_conv_case``); a
    split-K call replayed twice from one graph; ``quantize_act`` at each
    input shape of ResNet-50's int8 layers at 32 images
    (``quantize_case``).  The ResNet-50 pass (each shape times its count
    in the net) is each entry's headline."""
    import torch

    t_phase = time.perf_counter()
    # the cuDNN yardstick in full f32, as the port's context runs it
    torch.backends.cudnn.allow_tf32 = False
    gen = np.random.default_rng(SEED + 70)
    batch, *others = INT8_CONV_BATCHES
    rows = [int8_conv_case(dev, case, gen) for case in
            resnet50_int8_shapes(batch) + list(INT8_CONV_EXTRA)]
    more = {n: [int8_conv_case(dev, case, gen)
                for case in resnet50_int8_shapes(n)] for n in others}
    split_k_replay(dev, gen)
    keys = ("ms", "graph_ms", "plain_ms", "library_ms", "bound_ms",
            "padded_bound_ms", "int_mm_ms")
    total = pass_total(rows, keys)
    passes = {n: pass_total(r, keys) for n, r in more.items()}
    for n, t in [(batch, total)] + list(passes.items()):
        log(f"kernel int8_conv, one ResNet-50 pass at {n} image(s) "
            f"({t['calls']} calls, fused mode): {t['ms']:.3f} ms (graph "
            f"{t['graph_ms']:.3f}), bound {t['bound_ms']:.3f} ms "
            f"({t['bound_by']}; over the padded operands "
            f"{t['padded_bound_ms']:.3f}), plain {t['plain_ms']:.0f} ms on "
            f"the host CPU, cuDNN f32 {t['library_ms']:.3f} ms; im2col + _int_mm "
            f"{t['int_mm_ms'] or 0:.3f} ms over the calls its shape rules "
            f"take")
    # quantize_act at the inputs of the net's int8 layers
    inputs = {}
    for case in resnet50_int8_shapes(batch):
        _, n, spatial, cin, *_, count = case
        key = (n,) + (spatial if spatial != (1,) else ()) + (cin,)
        inputs[key] = inputs.get(key, 0) + count
    qrows = [quantize_case(dev, shape, count, gen)
             for shape, count in inputs.items()]
    qtotal = pass_total(qrows, ("ms", "graph_ms", "plain_ms",
                                "plain_graph_ms", "library_ms", "bound_ms",
                                "padded_bound_ms"))
    log(f"kernel quantize_act, one ResNet-50 pass at {batch} images "
        f"({qtotal['calls']} calls): {qtotal['ms']:.3f} ms (graph "
        f"{qtotal['graph_ms']:.3f}), bound {qtotal['bound_ms']:.3f} ms "
        f"({qtotal['bound_by']}; with the padding "
        f"{qtotal['padded_bound_ms']:.3f}), plain {qtotal['plain_ms']:.3f} ms (graph "
        f"{qtotal['plain_graph_ms']:.3f}), quantize_per_tensor "
        f"{qtotal['library_ms'] or 0:.3f} ms; phase int8_conv_kernel: "
        f"{time.perf_counter() - t_phase:.1f} s")
    entry = {"name": "int8_conv", "route": "cuda",
             "source": "analytics_zoo_tpu_torch/csrc/int8_conv.cu",
             "replaces": REPLACES["int8_conv"],
             "max_abs_err": max(r["max_abs_err"] for r in rows),
             "plain_device": "host cpu (no int32 matmul on CUDA)",
             "pass": f"ResNet-50 at {batch} images, {total['calls']} calls, "
                     "fused mode (mult)",
             **total, "shapes": rows,
             "passes": {n: {**passes[n], "shapes": more[n]} for n in more}}
    qentry = {"name": "quantize_act", "route": "cuda",
              "source": "analytics_zoo_tpu_torch/csrc/int8_conv.cu",
              "replaces": REPLACES["quantize_act"],
              "max_abs_err": max(r["max_abs_err"] for r in qrows),
              "library": "torch.quantize_per_tensor (reciprocal multiply, "
                         "[-128, 127]: not bit for bit)",
              "pass": f"ResNet-50 at {batch} images, {qtotal['calls']} "
                      "calls",
              **qtotal, "shapes": qrows}
    return entry, qentry


def bert_tokens_model():
    """BERT-base over token ids alone, with the Dense(2, softmax) head: the
    one-input model that calibrated int8 takes."""
    from analytics_zoo_tpu_torch.pipeline.api.keras import Input, Model
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import BERT, Dense

    ids = Input((SEQ,))
    _, pooled = BERT(**BERT_BASE)(ids)
    return Model(ids, Dense(2, activation="softmax")(pooled))


def check_probs(tag, out, n, want, tol):
    err = float(np.abs(out - want).max())
    if out.shape != (n, 2) or not np.isfinite(out).all() \
            or not np.allclose(out.sum(axis=1), 1.0, atol=1e-5):
        raise AssertionError(f"{tag}: bad output {out.shape}")
    if not err <= tol:
        raise AssertionError(f"{tag}: max|d| {err} from f32 (tol {tol})")
    return err


def int8_serving_phase(card_line: str, weights, int8_entry) -> dict:
    """Weight-only and calibrated int8 serving of BERT-base, and the
    int8_matmul kernel route over its 50 Dense kernels; returns the launch
    counts of the path and records the route's time, split by shape from
    the kernel phase's rows, in ``int8_entry["kernel_route"]``."""
    import torch

    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.common.utils import tree_map
    from analytics_zoo_tpu_torch.ops.cuda import int8_matmul as im8
    from analytics_zoo_tpu_torch.ops.cuda import kernel_invocation_counts
    from analytics_zoo_tpu_torch.parallel import (
        compile_step,
        int8_serving,
        with_kernels,
    )
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    from analytics_zoo_tpu_torch.pipeline.inference.quantize import (
        Int8Model,
        QuantizedTensor,
        quantized_matmul,
    )

    dev = next(iter(weights.values())).values.device
    init_zoo_context(seed=SEED, device=dev.type)
    gen = np.random.default_rng(SEED + 6)
    t0 = time.perf_counter()
    net, tok_net = bert_model(), bert_tokens_model()
    net.build_params()
    tok_net.build_params()
    calib = requests_of(N_CALIB, gen)[0]
    f32_im = InferenceModel().from_keras_net(net)
    f32_tok = InferenceModel().from_keras_net(tok_net)
    w8 = InferenceModel().from_keras_net(net).optimize("int8")
    cal = InferenceModel().from_keras_net(tok_net).optimize(
        "int8", calibration_data=calib)
    w8.warmup([(SEQ,)] * 4, dtype=REQ_DTYPES, batch_sizes=INT8_REQUESTS)
    cal.warmup([(SEQ,)], dtype=np.int32, batch_sizes=INT8_REQUESTS)
    reqs = [requests_of(n, gen) for n in INT8_REQUESTS]
    want = [f32_im.predict(r) for r in reqs]
    want_tok = [f32_tok.predict(r[0]) for r in reqs]
    scales = cal._int8_model.act_scales
    log(f"int8 serving: models built, calibrated on {N_CALIB} records and "
        f"warmed up in {time.perf_counter() - t0:.1f} s; calibrated "
        f"targets {sorted(scales)} (activation scales {scales})")
    # one seeded activation per (rows, K) of the Dense kernels
    acts = {key: torch.from_numpy(gen.normal(size=key).astype(np.float32)
                                  ).to(dev)
            for key in sorted({(int8_rows(p), qt.values.shape[0])
                               for p, qt in weights.items()})}
    torch.cuda.synchronize()

    reset_counters()  # int8 serving main path: from here to the read below
    outs = {}
    for tag, im, pick, refs in (("weight-only", w8, lambda r: r, want),
                                ("calibrated", cal, lambda r: r[0],
                                 want_tok)):
        for i, r in enumerate(reqs):
            t0 = time.perf_counter()
            out = im.predict(pick(r))
            ms = (time.perf_counter() - t0) * 1e3
            err = check_probs(f"int8 {tag} request {i}", out, len(r[0]),
                              refs[i], INT8_SERVE_TOL)
            outs[tag, i] = out
            log(f"int8 {tag} request {i}: {len(out)} records in {ms:.2f} ms "
                f"({card_line}); max|d| from f32 {err:.3e} (tol "
                f"{INT8_SERVE_TOL:g})")
    flash = counters()["flash_attention_fwd"]

    def route():
        return {p: quantized_matmul(
                    acts[(int8_rows(p), qt.values.shape[0])], qt)
                for p, qt in weights.items()}

    kernel_route = compile_step(route, with_kernels(int8_serving()),
                                label="int8_kernel_route")
    xla_route = compile_step(
        route, with_kernels(int8_serving(),
                            (("serving.int8_matmul", "xla"),)),
        label="int8_xla_route")
    before = kernel_invocation_counts()["int8_matmul"]
    t0 = time.perf_counter()
    got = kernel_route()
    torch.cuda.synchronize()
    route_ms = (time.perf_counter() - t0) * 1e3
    mid = kernel_invocation_counts()["int8_matmul"]
    xla = xla_route()
    torch.cuda.synchronize()
    after = kernel_invocation_counts()["int8_matmul"]
    launches = counters()  # end of the int8 serving main path
    log(f"int8 kernel route: {len(got)} quantized_matmul calls in "
        f"{route_ms:.2f} ms ({card_line}); int8_matmul counts {before} -> "
        f"{mid} (kernel route) -> {after} (xla route)")
    if mid["kernel"] - before["kernel"] != len(weights) \
            or mid["plain"] != before["plain"] or after != mid:
        raise AssertionError("quantized_matmul did not route through the "
                             "int8 kernel exactly once per Dense kernel")
    route_err = xla_err = 0.0
    for p, qt in weights.items():
        x = acts[(int8_rows(p), qt.values.shape[0])]
        plain = im8._reference(x, qt.values, qt.scale.reshape(-1))
        route_err = max(route_err, rel_l2(got[p], plain))
        xla_err = max(xla_err, rel_l2(xla[p], plain))
    log(f"int8 kernel route vs plain: relative L2 {route_err:.3e}; xla "
        f"(dequantize) route {xla_err:.3e} (tol {INT8_F32_TOL:g})")
    if not (route_err <= INT8_F32_TOL and xla_err <= INT8_F32_TOL):
        raise AssertionError("an int8 route disagrees with the plain version")
    any_x_check(weights["bert_0/blocks/0/qkv_kernel"])
    route_dev_ms = cuda_ms(kernel_route, reps=10)
    calls = {}
    for p in weights:
        label = ("head" if p.startswith("dense_0") else "pooler"
                 if "pooler" in p else p.rsplit("/", 1)[-1][:-len("_kernel")])
        calls[label] = calls.get(label, 0) + 1
    f32 = {r["shape"]: r for r in int8_entry["shapes"]
           if r["dtype"] == "float32"}
    by_shape = {lb: {"calls": c, "ms": c * f32[lb]["ms"],
                     "graph_ms": c * f32[lb]["graph_ms"]}
                for lb, c in calls.items()}
    int8_entry["kernel_route"] = {"host_ms": route_ms,
                                  "device_ms": route_dev_ms,
                                  "by_shape": by_shape}
    log(f"int8 kernel route: {route_dev_ms:.3f} ms on the device per pass "
        f"(CUDA events, 10 passes; {card_line}); by shape from the kernel "
        "phase (through the wrapper; graph): "
        + ", ".join(f"{lb} {v['calls']} x = {v['ms']:.3f}; "
                    f"{v['graph_ms']:.3f} ms" for lb, v in by_shape.items()))
    blocks = BERT_BASE["n_block"]
    expected_flash = 2 * blocks * len(INT8_REQUESTS)
    int8_layers = len(cal._int8_model.weights_t) * len(INT8_REQUESTS)
    log(f"int8 serving launches: {launches} (expected flash "
        f"{expected_flash}, int8_matmul {len(weights)}, int8_conv and "
        f"quantize_act {int8_layers})")
    if flash != expected_flash or launches["flash_attention_fwd"] != flash \
            or launches["int8_matmul"] != len(weights) \
            or launches["int8_conv"] != int8_layers \
            or launches["quantize_act"] != int8_layers:
        raise AssertionError("an int8 serving call did not run through its "
                             "kernel")

    # the calibrated request 0 against the same calibrated model (its
    # activation scales and int8 kernels) on the CPU, plain versions
    cpu = bert_tokens_model()
    cpu.build_params(device="cpu")
    cpu_q = Int8Model(cpu, tree_map(
        lambda l: QuantizedTensor(l.values.cpu(), l.scale.cpu(), l.axis)
        if isinstance(l, QuantizedTensor) else l.cpu(),
        cal._int8_model.qparams), scales)
    err = float(np.abs(cpu_q.predict(reqs[0][0], batch_size=1)
                       - outs["calibrated", 0]).max())
    log(f"calibrated request 0 vs CPU: max|d| {err:.3e} (tol "
        f"{INT8_CPU_TOL:g})")
    if not err <= INT8_CPU_TOL:
        raise AssertionError("the calibrated request disagrees with the CPU")
    return launches


# ---------------------------------------------------------------------------
# the convolutional path: LeNet-5 and ResNet-50
# ---------------------------------------------------------------------------
# LeNet-5 on the quadrant task (class = the 14x14 quadrant of the largest
# mean): fit at batch 128 until the training set's accuracy passes 0.8
LENET_N, LENET_HELD_OUT, LENET_BATCH = 8192, 1024, 128
LENET_MAX_EPOCHS, LENET_ACC = 10, 0.8
# steps of the LeNet-5 check of the captured Adam step against the plain
# per-leaf update
LENET_CHECK_STEPS = 4
# ResNet-50 at 224x224x3, 1000 classes: RESNET_STEPS steps a fit at batch
# 64 (the synthetic set's epoch, so the recipe's steps per epoch), K=1 and
# K=4; the fixed-batch run takes FIXED_STEPS steps with a warmup of 5
RESNET_BATCH, RESNET_STEPS, RESNET_K, FIXED_STEPS = 64, 8, 4, 8
RESNET_SHAPE, RESNET_CLASSES = (224, 224, 3), 1000
RESNET_REQUESTS = (1, 8, 32)
# the rate a step applied (the fc kernel's change against its momentum
# trace, least squares) vs the schedule evaluated on the host, relative to
# the recipe's peak rate: p + u rounds each element to ~1e-4 of u
RATE_TOL = 1e-3
# bf16 vs f32 serving (probabilities; moving statistics from one batch):
# the bounds tests/test_torch_conv_models.py states for ResNet-50, on the
# largest difference of a probability, and on ``logit_gap`` for every model
# served in both (tests/test_torch_imagenet_zoo.py holds the zoo to it)
RESNET_BF16_SERVE_TOL = 0.02
BF16_LOGIT_TOL = 0.3


def quadrant_task(n: int, gen: np.random.Generator):
    x = gen.standard_normal((n, 28, 28, 1), dtype=np.float32)
    q = np.stack([x[:, :14, :14, 0].mean((1, 2)),
                  x[:, :14, 14:, 0].mean((1, 2)),
                  x[:, 14:, :14, 0].mean((1, 2)),
                  x[:, 14:, 14:, 0].mean((1, 2))], axis=1)
    return x, q.argmax(axis=1).astype(np.int32)


def logit_gap(p, q) -> float:
    """Rows of probabilities ``p`` against ``q`` as the logits they come
    from: the largest, over rows, of the L2 distance between the two rows'
    log-probabilities, each centred on its mean (the logits up to a
    row's constant), relative to the centred log-probabilities of
    ``q``."""
    lp, lq = (np.log(np.maximum(np.asarray(a, np.float64), 1e-30))
              for a in (p, q))
    lp = lp - lp.mean(-1, keepdims=True)
    lq = lq - lq.mean(-1, keepdims=True)
    return float((np.linalg.norm(lp - lq, axis=-1) / np.maximum(
        np.linalg.norm(lq, axis=-1), 1e-30)).max())


def free_device_memory(tag: str) -> None:
    """Collect the models and captures no one holds any more, give their
    memory back, and log what stays reserved and the peak so far."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"memory {tag}: reserved {torch.cuda.memory_reserved()} B, peak "
        f"reserved {torch.cuda.max_memory_reserved()} B")


def lenet_phase(card_line: str) -> tuple[dict, float]:
    """LeNet-5 (28x28x1, 10 classes) through ``compile("adam", ...)`` and
    ``fit`` at batch 128 until the training accuracy passes 0.8: one fused
    Adam launch a step over its five kernels (the biases take the plain
    update, as in the reference), no other kernel; then ``evaluate`` on a
    held-out set, ``predict``, and ``save``/``load`` with equal
    predictions.  Then the kernel at LeNet's own leaves, whose
    150-element conv kernel takes the kernel's scalar tail: ``adam_parity``
    at their shapes, and LENET_CHECK_STEPS steps of a fresh LeNet through
    ``fit`` (the captured in-place step) bit for bit ``train_step`` called
    eagerly with the plain update on every leaf (``optimizer.adam`` ->
    ``"xla"``): losses, parameters and both moments.  Returns the fit's
    launch counts and the kernel's largest relative error there."""
    import tempfile

    import torch

    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.models import build_lenet
    from analytics_zoo_tpu_torch.ops.cuda import fused_adam as fad
    from analytics_zoo_tpu_torch.parallel import with_kernels
    from analytics_zoo_tpu_torch.pipeline.api.keras import KerasNet

    t_phase = time.perf_counter()
    init_zoo_context(seed=SEED, device="cuda")
    gen = np.random.default_rng(SEED + 20)
    x, y = quadrant_task(LENET_N, gen)
    xv, yv = quadrant_task(LENET_HELD_OUT, gen)
    net = build_lenet()
    net.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
                metrics=["accuracy"])
    reset_counters()  # the LeNet fit: from here to the read below
    accs, epoch_ms = [], []
    while len(accs) < LENET_MAX_EPOCHS and (not accs or accs[-1]
                                            <= LENET_ACC):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(x, y, batch_size=LENET_BATCH, nb_epoch=1)
        torch.cuda.synchronize()
        epoch_ms.append((time.perf_counter() - t0) * 1e3)
        accs.append(net.evaluate(x, y, batch_size=LENET_BATCH)["accuracy"])
    counted = counters()  # end of the LeNet fit
    leaves = fad.leaf_count
    steps = net._estimator.global_step
    kernel_leaves = sum(t.numel() >= fad.MIN_KERNEL_LEAF
                        for t in (v for p in net.params.values()
                                  for v in p.values()))
    losses = [v for _, v in net._estimator.loss_log]
    held = net.evaluate(xv, yv, batch_size=LENET_BATCH)
    p1 = net.predict(xv, batch_size=LENET_BATCH)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/lenet.model"
        net.save(path)
        p2 = KerasNet.load(path).predict(xv, batch_size=LENET_BATCH)
    steps_per_epoch = LENET_N // LENET_BATCH
    log(f"lenet: {len(accs)} epoch(s), {steps} steps at batch "
        f"{LENET_BATCH}: training accuracy {accs} (> {LENET_ACC}), loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; held-out {held}; epoch host "
        f"clock {', '.join(f'{t:.1f}' for t in epoch_ms)} ms (the last "
        f"{epoch_ms[-1] / steps_per_epoch:.3f} ms a step, "
        f"{LENET_BATCH * steps_per_epoch / epoch_ms[-1] * 1e3:.0f} "
        f"images/s; {card_line}); launches {counted}, fused Adam leaves "
        f"{leaves} ({kernel_leaves} kernel leaves a step)")
    expected = dict({k: 0 for k in counted}, fused_adam=steps)
    if accs[-1] <= LENET_ACC or counted != expected \
            or leaves != kernel_leaves * steps:
        raise AssertionError(f"lenet: accuracy {accs}, launches {counted} "
                             f"(expected {expected}), leaves {leaves}")
    same = np.array_equal(p1, p2)
    log(f"lenet: predict {p1.shape}, rows sum to 1 within "
        f"{float(np.abs(p1.sum(-1) - 1).max()):.2e}; after save/load "
        f"equal bit for bit {same}")
    if not (np.isfinite(p1).all() and same
            and np.allclose(p1.sum(-1), 1.0, rtol=1e-5)):
        raise AssertionError("lenet: predictions wrong or changed by "
                             "save/load")
    err = adam_parity(torch.device("cuda"),
                      [tuple(t.shape) for p in net.params.values()
                       for t in p.values()], "LeNet-5")[3]
    chk = build_lenet()
    chk.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
                metrics=["accuracy"])
    chk.build_params()
    n = LENET_CHECK_STEPS * LENET_BATCH
    want, l_want, _ = eager_steps(
        chk, with_kernels(None, (("optimizer.adam", "xla"),)), x[:n],
        y[:n], LENET_CHECK_STEPS, LENET_BATCH)
    before = fad.launch_count
    chk.fit(x[:n], y[:n], batch_size=LENET_BATCH, nb_epoch=1)
    launched = fad.launch_count - before
    l_got = [v for _, v in chk._estimator.loss_log]
    off = differing(trained(chk), want)
    log(f"lenet: {LENET_CHECK_STEPS} steps through fit (the captured step, "
        f"{launched} fused Adam launches) against train_step eagerly with "
        f"the plain update: losses equal {l_got == l_want}, "
        f"{len(named_leaves(want)) - len(off)} of {len(named_leaves(want))} "
        f"parameter and moment leaves equal bit for bit"
        f"{'; differ: ' + str(off[:8]) if off else ''}")
    if off or l_got != l_want or launched != LENET_CHECK_STEPS:
        raise AssertionError("lenet: the captured Adam step is not the plain "
                             "per-leaf update")
    log(f"phase lenet: {time.perf_counter() - t_phase:.1f} s")
    return counted, err


def conv_flops(net) -> tuple[float, float]:
    """(forward, training) FLOPs of one image through ``net``'s conv
    (dense and depthwise) and Dense layers (at every position of a
    sequence): 2 x the multiply-adds;
    training adds the weight gradients (as many as the forward) and the
    input gradients (as many, but for the first layer, whose input needs
    none)."""
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        Dense,
        DepthwiseConvolution2D,
    )
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.conv import (
        _ConvND,
    )

    fwd, first = [], None
    for layer in net.layers:
        if isinstance(layer, _ConvND):
            shape = tuple(layer._build_shape)
            out = layer.compute_output_shape((None,) + shape)
            fwd.append(2.0 * np.prod(out[1:-1]) * np.prod(layer.kernel_size)
                       * shape[-1] * layer.nb_filter)
        elif isinstance(layer, DepthwiseConvolution2D):
            out = layer.compute_output_shape(
                (None,) + tuple(layer._build_shape))
            fwd.append(2.0 * np.prod(out[1:]) * np.prod(layer.kernel_size))
        elif isinstance(layer, Dense):
            fwd.append(2.0 * np.prod(layer._build_shape) * layer.output_dim)
        else:
            continue
        first = fwd[0] if first is None else first
    forward = float(sum(fwd))
    return forward, 3 * forward - first


def graph_of(step):
    """The CUDA graph of a planned step's one capture."""
    return next(e for e in step._exes.values() if e is not None).graph


def replay_ms(graph, reps: int = 5) -> float:
    """Device time of one replay of ``graph``, back to back (CUDA
    events): the step or request without the host's work around it."""
    import torch

    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def resnet_net(weights, k: int = 1, steps_per_epoch: int = RESNET_STEPS):
    """ResNet-50 with the given (params, state) (copies) on the card,
    compiled with the recipe (``imagenet_optimizer(batch_size=64)``) under
    a context with K steps a dispatch."""
    from analytics_zoo_tpu_torch.models import ResNet

    return zoo_net(
        lambda: ResNet.image_net(50, classes=RESNET_CLASSES,
                                 input_shape=RESNET_SHAPE),
        weights, ResNet.imagenet_optimizer(batch_size=RESNET_BATCH,
                                           steps_per_epoch=steps_per_epoch),
        k)


def trained(net) -> dict:
    """A model's trained trees as the eager yardstick holds them."""
    return {"params": net.params, "opt": net._estimator._opt_state,
            "state": net.state}


def param_count(net) -> int:
    return sum(t.numel() for p in net.params.values() for t in p.values())


def zoo_net(build, weights, optimizer, k: int = 1):
    """``build()`` with the given (params, state) (copies) on the card,
    compiled with ``optimizer`` under a context with K steps a dispatch."""
    import torch

    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.common.utils import tree_map

    ctx = init_zoo_context(seed=SEED, device="cuda", steps_per_dispatch=k)
    net = build()
    net.device = ctx.device
    net.params = tree_map(torch.clone, weights[0])
    net.state = tree_map(torch.clone, weights[1])
    net.compile(optimizer=optimizer, loss="sparse_categorical_crossentropy",
                metrics=["accuracy", "top5_accuracy"])
    return net


def captured_fit_check(tag, net, plan, x, y, steps, batch) -> list:
    """``train_step`` called eagerly twice (the two runs must agree on
    every leaf: cuDNN runs deterministic algorithms), then ``fit`` at K=1
    (step 1 eager and captured, then replays) bit for bit the eager run:
    losses, parameters, momentum and model state.  Returns the losses."""
    import torch

    first, l_first, eager_ms = eager_steps(net, plan, x, y, steps, batch)
    want, l_want, eager_ms2 = eager_steps(net, plan, x, y, steps, batch)
    drift = differing(first, want)
    log(f"{tag}: two eager runs of {steps} steps: "
        f"{len(named_leaves(want)) - len(drift)} of {len(named_leaves(want))} "
        f"leaves equal, losses equal {l_first == l_want}; eager host clock "
        f"{eager_ms:.2f} / {eager_ms2:.2f} ms a step")
    if drift or l_first != l_want:
        log(f"{tag}: differ at {drift[:8]}")
        raise AssertionError(f"the eager {tag} step is not deterministic")
    del first
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.fit(x, y, batch_size=batch, nb_epoch=1, plan=plan)
    torch.cuda.synchronize()
    fit_ms = (time.perf_counter() - t0) * 1e3
    losses = [v for _, v in net._estimator.loss_log]
    off = differing(trained(net), want)
    log(f"{tag}: {steps} steps through fit (K=1: step 1 eager and "
        f"captured, then replays; {fit_ms:.0f} ms) against train_step "
        f"eagerly: losses equal {losses == l_want} ({losses[0]:.4f} .. "
        f"{losses[-1]:.4f}), {len(named_leaves(want)) - len(off)} of "
        f"{len(named_leaves(want))} parameter, momentum and state leaves "
        f"equal bit for bit{'; differ: ' + str(off[:8]) if off else ''}")
    if losses != l_want or off:
        raise AssertionError(f"the captured {tag} step is not the eager "
                             "step")
    return losses


def train_checks(tag, make, plan, x, y, steps, batch, k, flops, peak,
                 card_line):
    """``make(K)``, a compiled model from one set of weights with K steps a
    dispatch, trained for one epoch of ``steps`` batches under ``plan``:
    ``captured_fit_check`` at K=1, a replayed step's times
    (``replayed_step``), then K=``k`` bit for bit K=1 (``k`` None: no
    K-step run).  Returns the K=1 model, its train captures dropped, and
    its losses."""
    import torch

    from analytics_zoo_tpu_torch.common.utils import tree_map

    net = make(1)
    losses = captured_fit_check(tag, net, plan, x, y, steps, batch)
    k1 = tree_map(torch.clone, trained(net))
    replayed_step(tag, net, plan, x, y, batch, steps, flops, peak, card_line)
    net._estimator._steps.clear()  # the train captures and their pool
    if k is None:
        return net, losses
    knet = make(k)
    knet.fit(x, y, batch_size=batch, nb_epoch=1, plan=plan)
    kl = [v for _, v in knet._estimator.loss_log]
    off = differing(trained(knet), k1)
    log(f"{tag}, K={k}: {steps} steps in {steps // k} dispatches against "
        f"K=1: losses equal {kl == losses}, leaves differing {off[:8]}")
    if kl != losses or off:
        raise AssertionError(f"{tag}: K={k} is not K=1")
    return net, losses


def captured_eval_check(tag, net, x, y, batch) -> None:
    """``evaluate`` through the captured eval step (its capture, then a
    replay) bit for bit the uncaptured per-batch step."""
    from analytics_zoo_tpu_torch.feature.dataset import FeatureSet
    from analytics_zoo_tpu_torch.parallel import compile_step

    est = net._estimator
    plan = est._resolve_plan()
    eager = est._evaluate_with(
        net.params, net.state, FeatureSet.of(x, y), batch,
        est.compute_casts(plan, net.params),
        step=compile_step(est.eval_step, plan, label="eval_step_eager",
                          capture=False))
    first = net.evaluate(x, y, batch_size=batch)  # captures
    got = net.evaluate(x, y, batch_size=batch)    # replays
    log(f"{tag} captured eval: {got}; the capture's {first}; uncaptured "
        f"{eager} (equal: {got == eager == first})")
    if not got == eager == first or "accuracy" not in got or not all(
            0.0 <= got[k] <= 1.0 for k in got if k != "loss"):
        raise AssertionError(f"the captured {tag} eval is not the eager "
                             "one")


def replayed_step(tag, net, plan, x, y, batch, steps, flops, peak,
                  card_line) -> None:
    """The host clock of a replayed epoch a step, one replay's device time
    and the idle share, against the step's bound."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.fit(x, y, batch_size=batch, nb_epoch=1, plan=plan)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    est = net._estimator
    dev_ms = replay_ms(graph_of(est._train_step_for(1,
                                                    est._resolve_plan(plan))))
    bound_ms = batch * flops[1] / peak * 1e3
    log(f"{tag} step (batch {batch}, replayed): host clock {host_ms:.2f} "
        f"ms, device {dev_ms:.2f} ms, idle "
        f"{max(0.0, 1 - dev_ms / host_ms):.1%}, "
        f"{batch / host_ms * 1e3:.1f} images/s ({batch / dev_ms * 1e3:.1f} "
        f"on the device time); bound {bound_ms:.2f} ms ({batch} x "
        f"{flops[1] / 1e9:.2f} GFLOP at {peak / 1e12:.0f} TFLOP/s; device "
        f"time {bound_ms / dev_ms:.1%} of it) ({card_line})")


def serve_zoo_model(tag, net, shape, sizes, gen, flops, card_line,
                    precisions=("f32", "bf16")) -> dict:
    """``net`` served (``serve_requests``) one seeded standard normal
    request of each size of image ``shape``.  Returns the launch counts of
    the replayed requests, the requests and the replays' outputs by
    (precision, size)."""
    reqs = {n: gen.standard_normal((n,) + shape, dtype=np.float32)
            for n in sizes}
    launches, got = serve_requests(tag, net, reqs, flops, card_line,
                                   precisions)
    return launches, reqs, got


def serve_requests(tag, net, reqs, flops, card_line,
                   precisions=("f32", "bf16"), unit="images",
                   softmax=True) -> tuple:
    """``net`` through ``InferenceModel`` in each precision for each
    request of ``reqs`` (records -> an array, or a list of arrays for a
    model of several inputs), each bucket warmed up (captured) with the
    requests' shapes and dtypes: each replay (every head of a model of
    several outputs) bit for bit its eager forward, finite, with
    ``softmax`` rows summing to 1, bf16 within BF16_LOGIT_TOL of f32 by
    ``logit_gap``; the host clock (median of HOST_REPEATS), device time,
    idle share and records/s of each request beside its bound.  Returns
    the launch counts of the replayed requests and the replays' outputs
    by (precision, size)."""
    import torch

    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

    sizes = list(reqs)
    lists = {n: r if isinstance(r, list) else [r] for n, r in reqs.items()}
    first = lists[sizes[0]]
    models = {"f32": InferenceModel().from_keras_net(net)}
    if "bf16" in precisions:
        models["bf16"] = InferenceModel().from_keras_net(net).optimize(
            "bf16")
    t0 = time.perf_counter()
    for im in models.values():
        im.warmup([a.shape[1:] for a in first],
                  dtype=[a.dtype for a in first], batch_sizes=sizes)
    torch.cuda.synchronize()
    log(f"{tag} serving: {len(models)} model(s) x {len(sizes)} bucket(s) "
        f"warmed up (captured) in {time.perf_counter() - t0:.1f} s")
    want = {(p, n): eager_predict(im, lists[n])
            for p, im in models.items() for n in sizes}
    torch.cuda.synchronize()
    reset_counters()  # this model's serving path: to the read below
    got = {(p, n): im.predict(reqs[n])
           for p, im in models.items() for n in sizes}
    launches = counters()  # end of this model's serving path
    for (p, n), out in got.items():
        heads = out if isinstance(out, list) else [out]
        wants = want[p, n] if isinstance(out, list) else [want[p, n]]
        same = len(heads) == len(wants) and all(
            np.array_equal(a, b) for a, b in zip(heads, wants))
        sums = max(float(np.abs(o.sum(-1) - 1).max()) for o in heads) \
            if softmax else 0.0
        log(f"{tag} serving {p}, {n} {unit}: "
            f"{[o.shape for o in heads]}, replay equal to the eager "
            f"forward bit for bit: {same}"
            + (f"; rows sum to 1 within {sums:.2e}" if softmax else ""))
        if not same or not all(np.isfinite(o).all() and len(o) == n
                               for o in heads) \
                or sums > (1e-4 if p == "f32" else 1e-2):
            raise AssertionError(f"{tag} {p} serving of {n} is wrong")
    if "bf16" in models:
        gaps = [logit_gap(got["bf16", n], got["f32", n]) for n in sizes]
        diffs = [float(np.abs(got["bf16", n] - got["f32", n]).max())
                 for n in sizes]
        log(f"{tag} serving bf16 vs f32 at {'/'.join(map(str, sizes))} "
            f"{unit}: logit gap {', '.join(f'{g:.4f}' for g in gaps)} "
            f"(tol {BF16_LOGIT_TOL}); max |d| "
            f"{', '.join(f'{d:.3e}' for d in diffs)}")
        if max(gaps) > BF16_LOGIT_TOL:
            raise AssertionError(f"{tag} bf16 serving is too far from f32")
    for p, im in models.items():
        peak = PEAK_FLOPS["float32" if p == "f32" else "bfloat16"]
        for n in sizes:
            host = []
            for _ in range(HOST_REPEATS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                im.predict(reqs[n])
                host.append((time.perf_counter() - t0) * 1e3)
            key = tuple((a.shape, str(a.dtype)) for a in lists[n])
            dev = replay_ms(graph_of(im._steps[key].step))
            med = float(np.median(host))
            log(f"{tag} request {p}, {n} {unit}: host clock "
                f"{', '.join(f'{t:.3f}' for t in host)} ms (median "
                f"{med:.3f}), device {dev:.3f} ms, idle "
                f"{max(0.0, 1 - dev / med):.1%}, {n / med * 1e3:.1f} "
                f"{unit}/s; bound {n * flops[0] / peak * 1e3:.4g} ms "
                f"({card_line})")
    return launches, got


def rates_on_a_fixed_batch(tag, net, kernel_path, x, y, batch, steps,
                           sched_opt, plan=None) -> None:
    """``steps`` one-step fits on one batch under ``plan``: the loss falls,
    and each step's rate (read back from a kernel's change and momentum
    trace, least squares) is the schedule's on the host within RATE_TOL
    of the peak rate."""
    import torch

    layer, leaf = kernel_path
    peak_lr = sched_opt.learning_rate
    rates = []
    for i in range(steps):
        before = net.params[layer][leaf].clone()
        net.fit(x, y, batch_size=batch, nb_epoch=1, plan=plan)
        after = net.params[layer][leaf]
        trace = net._estimator._opt_state.trace[layer][leaf]
        got = (-((after - before).double() * trace.double()).sum()
               / (trace.double() ** 2).sum().clamp_min(1e-300)).item()
        want = float(sched_opt._lr(torch.tensor(i, dtype=torch.int32)))
        rates.append((got, want))
    losses = [v for _, v in net._estimator.loss_log]
    worst = max(abs(g - w) for g, w in rates) / peak_lr
    log(f"{tag} fixed batch, {steps} steps: losses "
        f"{', '.join(f'{v:.4f}' for v in losses)}; rates applied on the card "
        f"(from {layer}'s {leaf}) {', '.join(f'{g:.6f}' for g, _ in rates)} "
        f"against the schedule on the host "
        f"{', '.join(f'{w:.6f}' for _, w in rates)}: worst {worst:.2e} of "
        f"the peak {peak_lr}")
    if not losses[-1] < losses[0] or worst > RATE_TOL \
            or int(net._estimator._opt_state.count) != steps:
        raise AssertionError(f"{tag} fixed batch: the loss did not fall or "
                             "a step's rate is not the schedule's")


def resnet_training_phase(card_line: str, x, y, weights, flops) -> dict:
    """ResNet-50 fine-tuned with the recipe in f32, bf16
    (``mixed_precision()``) and f16 (``"dp+f16"``, no loss scaling, as
    the reference) at batch 64: ``fit`` at K=1 (step 1 eager and
    captured, then replays) bit for bit ``train_step`` called eagerly
    (parameters, momentum, BatchNorm state, losses; the eager run twice),
    K=4 bit for bit K=1 (f32 and bf16); the host clock, the device time
    and the idle share of a replayed step against its bound.  f16: step
    1's loss within BF16_F32_LOSS_TOL of the f32 step's, the masters,
    momentum and moving statistics f32.  Then a fixed batch, f32 and f16:
    the loss falls and each step's rate is the schedule's on the host.
    Then ``evaluate`` (accuracy, top-5) through the captured eval step,
    bit for bit the uncaptured one.  Returns the launch counts and the
    trained f32 model."""
    import torch

    from analytics_zoo_tpu_torch.common.utils import tree_leaves
    from analytics_zoo_tpu_torch.parallel import mixed_precision

    t_phase = time.perf_counter()
    reset_counters()  # the ResNet-50 training path: to the read below
    served, first = None, {}
    for tag, plan, peak, k in (
            ("f32", None, PEAK_FLOPS["float32"], RESNET_K),
            ("bf16", mixed_precision(), PEAK_FLOPS["bfloat16"], RESNET_K),
            ("f16", "dp+f16", PEAK_FLOPS["float16"], None)):
        t0 = time.perf_counter()
        net, losses = train_checks(
            f"resnet50 {tag}", lambda k: resnet_net(weights, k), plan, x, y,
            RESNET_STEPS, RESNET_BATCH, k, flops, peak, card_line)
        first[tag] = losses[0]
        if tag == "f16":
            kept = {name: sorted({str(t.dtype) for t in tree_leaves(tree)})
                    for name, tree in (
                        ("params", net.params),
                        ("momentum", net._estimator._opt_state.trace),
                        ("moving statistics", net.state))}
            rel = abs(first["f16"] - first["f32"]) / abs(first["f32"])
            log(f"resnet50 f16: step 1 loss {first['f16']:.6f} against f32 "
                f"{first['f32']:.6f} (rel {rel:.2e}, tol "
                f"{BF16_F32_LOSS_TOL}); dtypes kept {kept}; no loss scaling"
                f" (finite losses {all(np.isfinite(losses))})")
            if rel > BF16_F32_LOSS_TOL or not all(np.isfinite(losses)) \
                    or any(v != ["torch.float32"] for v in kept.values()):
                raise AssertionError("the f16 ResNet-50 step is off the "
                                     "f32 one or keeps a 16-bit state")
        if tag == "f32":
            served = net
        del net
        free_device_memory(f"after resnet50 {tag}")
        log(f"resnet50 training {tag}: {time.perf_counter() - t0:.1f} s")

    # a fixed batch: the loss falls; each step's rate against the host's
    from analytics_zoo_tpu_torch.models import ResNet

    for tag, plan in (("f32", None), ("f16", "dp+f16")):
        fixed = resnet_net(weights, steps_per_epoch=1)
        rates_on_a_fixed_batch(
            f"resnet50 {tag}", fixed, ("fc", "kernel"), x[:RESNET_BATCH],
            y[:RESNET_BATCH], RESNET_BATCH, FIXED_STEPS,
            ResNet.imagenet_optimizer(batch_size=RESNET_BATCH,
                                      steps_per_epoch=1), plan)
        del fixed
    torch.cuda.synchronize()

    captured_eval_check("resnet50", served, x, y, RESNET_BATCH)
    launches = counters()  # end of the ResNet-50 training path
    log(f"resnet50 training launches {launches} (SGD, cuDNN and plain "
        f"torch: no kernel of the table); phase resnet50_training: "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches, served


def resnet_serving_phase(card_line: str, net, initial, gen,
                         flops) -> dict:
    """The trained ResNet-50 served by ``InferenceModel`` in f32 and bf16
    at 1, 8 and 32 images a request (``serve_zoo_model``: each replay bit
    for bit its eager forward, bf16 within BF16_LOGIT_TOL of f32 by
    ``logit_gap``, each request's times), bf16 also within
    RESNET_BF16_SERVE_TOL of f32 on the largest probability difference;
    the same gaps of the untrained model (``initial``: (params, state)) on
    the same requests, eagerly.  The served model's moving statistics are
    first set to one batch's (``recalibrate_batchnorm``): a few steps
    leave them near (0, 1), under which 53 layers saturate the softmax,
    and a served ResNet holds converged ones."""
    import torch

    from analytics_zoo_tpu_torch.common.utils import tree_map
    from analytics_zoo_tpu_torch.models import ResNet
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        recalibrate_batchnorm,
    )
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

    t_phase = time.perf_counter()
    calib = gen.standard_normal((RESNET_BATCH,) + RESNET_SHAPE,
                                dtype=np.float32)
    recalibrate_batchnorm(net, calib)
    launches, reqs, got = serve_zoo_model(
        "resnet50", net, RESNET_SHAPE, RESNET_REQUESTS, gen, flops,
        card_line)

    def gaps(out):
        """(max |d|, logit_gap, top-1 agreement, largest f32 probability)
        of bf16 against f32 at each request size."""
        return {n: (float(np.abs(out["bf16", n] - out["f32", n]).max()),
                    logit_gap(out["bf16", n], out["f32", n]),
                    float(np.mean(out["bf16", n].argmax(-1)
                                  == out["f32", n].argmax(-1))),
                    float(out["f32", n].max()))
                for n in RESNET_REQUESTS}

    # the untrained model, recalibrated on the same batch, on the same
    # requests: what training adds to the gap
    fresh = ResNet.image_net(50, classes=RESNET_CLASSES,
                             input_shape=RESNET_SHAPE)
    fresh.device = net.device
    fresh.params = tree_map(torch.clone, initial[0])
    fresh.state = tree_map(torch.clone, initial[1])
    recalibrate_batchnorm(fresh, calib)
    base = {"f32": InferenceModel().from_keras_net(fresh)}
    base["bf16"] = InferenceModel().from_keras_net(fresh).optimize("bf16")
    untrained = gaps({(tag, n): eager_predict(im, [reqs[n]])
                      for tag, im in base.items() for n in RESNET_REQUESTS})
    del fresh, base
    served = gaps(got)
    for tag, g in (("trained", served), ("untrained", untrained)):
        log(f"resnet50 serving bf16 vs f32, {tag} model, at "
            f"{'/'.join(map(str, RESNET_REQUESTS))} image(s): max |d| "
            f"{', '.join(f'{v[0]:.3e}' for v in g.values())} (tol "
            f"{RESNET_BF16_SERVE_TOL}); logit gap "
            f"{', '.join(f'{v[1]:.4f}' for v in g.values())} (tol "
            f"{BF16_LOGIT_TOL}); top-1 agreement "
            f"{', '.join(f'{v[2]:.3f}' for v in g.values())}; largest f32 "
            f"probability {', '.join(f'{v[3]:.4f}' for v in g.values())}")
    if max(v[0] for v in served.values()) > RESNET_BF16_SERVE_TOL \
            or max(v[1] for v in served.values()) > BF16_LOGIT_TOL:
        raise AssertionError("ResNet-50 bf16 serving is too far from f32")
    log(f"resnet50 serving launches {launches}; phase resnet50_serving: "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


def resnet50_phases(card_line: str) -> tuple[dict, dict]:
    """ResNet-50 (``ResNet.image_net(50)``, 224x224x3, 1000 classes,
    random weights from the seed): the training phase, then serving the
    trained model.  Returns both paths' launch counts."""
    import torch

    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.models import ResNet

    free_device_memory("before resnet50 (the earlier phases freed)")
    torch.cuda.reset_peak_memory_stats()
    init_zoo_context(seed=SEED, device="cuda")
    net = ResNet.image_net(50, classes=RESNET_CLASSES,
                           input_shape=RESNET_SHAPE)
    net.build_params()
    weights = (net.params, net.state)
    flops = conv_flops(net)
    gen = np.random.default_rng(SEED + 30)
    n = RESNET_BATCH * RESNET_STEPS
    x = gen.standard_normal((n,) + RESNET_SHAPE, dtype=np.float32)
    y = gen.integers(0, RESNET_CLASSES, n).astype(np.int32)
    log(f"resnet50: {param_count(net)} parameters, "
        f"{flops[0] / 1e9:.2f} GFLOP an image forward, "
        f"{flops[1] / 1e9:.2f} a training step's image; {n} images of "
        f"{RESNET_SHAPE} ({x.nbytes} B, {x.nbytes // RESNET_STEPS} a batch)")
    training, served = resnet_training_phase(card_line, x, y, weights,
                                             flops)
    del x, y, net
    free_device_memory("after resnet50 training")
    serving = resnet_serving_phase(card_line, served, weights, gen, flops)
    free_device_memory("after resnet50 serving")
    return training, serving


# ---------------------------------------------------------------------------
# The ImageNet zoo at full width, random weights from the seed, synthetic
# images.  Inception-v1 (224x224x3, 1000 classes) with the reference's
# recipe (examples/inception/train.py: SGD 0.065, momentum 0.9, weight
# decay 1e-4, linear warmup over 2 epochs, then 0.1 at epochs 30 and 60)
# at batch 128, INCEPTION_STEPS steps a fit (the synthetic set's epoch);
# the fixed-batch run takes FIXED_STEPS steps with an epoch of
# INCEPTION_FIXED_EPOCH steps (a warmup over 2 * that)
INCEPTION_BATCH, INCEPTION_STEPS, INCEPTION_K = 128, 8, 4
INCEPTION_FIXED_EPOCH = 4
ZOO_SHAPE, ZOO_CLASSES = (224, 224, 3), 1000
ZOO_REQUESTS = (1, 8, 32)
# the port twin of the reference's test_trains_on_tiny_task: Inception-v1
# at 64x64x3, 2 classes, "adam", 8 epochs of 32 images at batch 8
ADAM_TWIN_N, ADAM_TWIN_BATCH, ADAM_TWIN_EPOCHS, ADAM_TWIN_ACC = 32, 8, 8, 0.8
# MobileNet-v2 (224x224x3, 1000 classes): MOBILENET_STEPS steps at batch 64
MOBILENET_BATCH, MOBILENET_STEPS = 64, 4
# the other builders: one replayed 8-image f32 request each
ZOO_REQUEST = 8


def zoo_builders() -> list:
    """(name, builder, input shape) of the zoo's other full-width models."""
    from analytics_zoo_tpu_torch.models import imagenet_zoo as z
    from analytics_zoo_tpu_torch.models import inception_v3

    return [("alexnet", z.alexnet, (227, 227, 3)),
            ("vgg16", lambda: z.vgg(16), ZOO_SHAPE),
            ("vgg19", lambda: z.vgg(19), ZOO_SHAPE),
            ("squeezenet", z.squeezenet, ZOO_SHAPE),
            ("densenet121", lambda: z.densenet(121), ZOO_SHAPE),
            ("densenet161", lambda: z.densenet(161), ZOO_SHAPE),
            ("mobilenet", z.mobilenet, ZOO_SHAPE),
            ("inception_v3", inception_v3, (299, 299, 3))]


def inception_optimizer(steps_per_epoch: int):
    """The reference's Inception-v1 recipe (examples/inception/train.py)."""
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import (
        SGD,
        warmup_epoch_decay,
    )

    sched = warmup_epoch_decay(warmup_steps=2 * steps_per_epoch,
                               steps_per_epoch=steps_per_epoch,
                               boundaries_epochs=(30, 60), decay=0.1)
    return SGD(lr=0.065, momentum=0.9, weight_decay=1e-4, schedule=sched)


def inception_phases(card_line: str) -> tuple[dict, dict, list]:
    """Inception-v1 (``Inception.v1(classes=1000)``, 224x224x3) trained
    with the reference's recipe at batch 128 in f32 and bf16
    (``mixed_precision()``): ``fit`` at K=1 bit for bit ``train_step``
    called eagerly, K=4 bit for bit K=1, a replayed step's host clock,
    device time, idle share and bound; on a fixed batch the loss falls and
    each rate is the schedule's; ``evaluate`` through the captured eval
    step, bit for bit the uncaptured one.  Then the trained f32 model
    served at 1, 8 and 32 images in f32 and bf16.  Returns the training
    and serving paths' launch counts and the model's leaf shapes."""
    import torch

    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.models import Inception
    from analytics_zoo_tpu_torch.parallel import mixed_precision

    t_phase = time.perf_counter()
    free_device_memory("before inception_v1")
    torch.cuda.reset_peak_memory_stats()
    init_zoo_context(seed=SEED, device="cuda")
    net = Inception.v1(classes=ZOO_CLASSES, input_shape=ZOO_SHAPE)
    net.build_params()
    weights = (net.params, net.state)
    shapes = [tuple(t.shape) for p in net.params.values() for t in p.values()]
    flops = conv_flops(net)
    gen = np.random.default_rng(SEED + 40)
    n = INCEPTION_BATCH * INCEPTION_STEPS
    x = gen.standard_normal((n,) + ZOO_SHAPE, dtype=np.float32)
    y = gen.integers(0, ZOO_CLASSES, n).astype(np.int32)
    log(f"inception_v1: {param_count(net)} parameters in {len(shapes)} "
        f"leaves, {flops[0] / 1e9:.2f} GFLOP an image forward, "
        f"{flops[1] / 1e9:.2f} a training step's image; {n} images of "
        f"{ZOO_SHAPE}")

    def build():
        return Inception.v1(classes=ZOO_CLASSES, input_shape=ZOO_SHAPE)

    reset_counters()  # the Inception-v1 training path: to the read below
    served = None
    for tag, plan, peak in (("f32", None, PEAK_FLOPS["float32"]),
                            ("bf16", mixed_precision(),
                             PEAK_FLOPS["bfloat16"])):
        net, _ = train_checks(
            f"inception_v1 {tag}",
            lambda k: zoo_net(build, weights,
                              inception_optimizer(INCEPTION_STEPS), k),
            plan, x, y, INCEPTION_STEPS, INCEPTION_BATCH, INCEPTION_K, flops,
            peak, card_line)
        if tag == "f32":
            served = net
        del net
        free_device_memory(f"after inception_v1 {tag}")

    fixed = zoo_net(build, weights, inception_optimizer(INCEPTION_FIXED_EPOCH))
    rates_on_a_fixed_batch(
        "inception_v1", fixed, ("loss3/classifier", "kernel"),
        x[:INCEPTION_BATCH], y[:INCEPTION_BATCH], INCEPTION_BATCH,
        FIXED_STEPS, inception_optimizer(INCEPTION_FIXED_EPOCH))
    del fixed

    captured_eval_check("inception_v1", served, x, y, INCEPTION_BATCH)
    training = counters()  # end of the Inception-v1 training path
    served._estimator._steps.clear()
    free_device_memory("after inception_v1 training")
    log(f"inception_v1 training launches {training} (SGD, cuDNN and plain "
        f"torch: no kernel of the table); phase inception_v1_training: "
        f"{time.perf_counter() - t_phase:.1f} s; peak memory allocated "
        f"{torch.cuda.max_memory_allocated()} B")
    t_phase = time.perf_counter()
    serving = serve_zoo_model("inception_v1", served, ZOO_SHAPE,
                              ZOO_REQUESTS, gen, flops, card_line)[0]
    del served
    free_device_memory("after inception_v1 serving")
    log(f"inception_v1 serving launches {serving}; phase "
        f"inception_v1_serving: {time.perf_counter() - t_phase:.1f} s")
    return training, serving, shapes


def inception_adam_phase(card_line: str, shapes) -> tuple[dict, float]:
    """The port twin of the reference's ``test_trains_on_tiny_task``:
    Inception-v1 at 64x64x3, 2 classes, no dropout, ``"adam"`` at batch 8
    for 8 epochs of 32 images (channel 0 lifted by the label): the
    training accuracy passes 0.8, with one fused Adam launch a step over
    every kernel leaf.  Then ``adam_parity`` at the full-width model's
    leaf shapes (``shapes``).  Returns the fit's launch counts and the
    kernel's largest relative error there."""
    import torch

    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.models import Inception
    from analytics_zoo_tpu_torch.ops.cuda import fused_adam as fad

    t_phase = time.perf_counter()
    init_zoo_context(seed=0, device="cuda")
    net = Inception.v1(classes=2, input_shape=(64, 64, 3), has_dropout=False)
    rng = np.random.default_rng(0)
    n = ADAM_TWIN_N
    x = np.zeros((n, 64, 64, 3), np.float32)
    y = rng.integers(0, 2, size=(n,)).astype(np.int32)
    x[np.arange(n), :, :, 0] += y[:, None, None] * 1.0
    net.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
                metrics=["accuracy"])
    reset_counters()  # the Inception-v1 Adam path: to the read below
    net.fit(x, y, batch_size=ADAM_TWIN_BATCH, nb_epoch=ADAM_TWIN_EPOCHS)
    counted = counters()  # end of the Inception-v1 Adam path
    leaves = fad.leaf_count
    res = net.evaluate(x, y, batch_size=ADAM_TWIN_BATCH)
    steps = net._estimator.global_step
    kernel_leaves = sum(t.numel() >= fad.MIN_KERNEL_LEAF
                        for p in net.params.values() for t in p.values())
    losses = [v for _, v in net._estimator.loss_log]
    log(f"inception_v1 adam (64x64x3, 2 classes): {steps} steps, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, {res} (> {ADAM_TWIN_ACC}); "
        f"launches {counted}, fused Adam leaves {leaves} ({kernel_leaves} "
        f"kernel leaves a step)")
    expected = dict({k: 0 for k in counted}, fused_adam=steps)
    if res["accuracy"] <= ADAM_TWIN_ACC or counted != expected \
            or leaves != kernel_leaves * steps:
        raise AssertionError(f"inception_v1 adam: {res}, launches {counted} "
                             f"(expected {expected}), leaves {leaves}")
    err = adam_parity(torch.device("cuda"), shapes,
                      "Inception-v1 at full width")[3]
    log(f"phase inception_v1_adam: {time.perf_counter() - t_phase:.1f} s")
    return counted, err


def depthwise_times(net, batch: int, card_line: str) -> None:
    """Device time of each distinct depthwise layer of ``net`` at
    ``batch``: its convolution (``F.conv2d``, ``groups=in``) and that
    convolution's backward (``aten.convolution_backward``: the input and
    kernel gradients), each replayed from a CUDA graph (``graph_ms``; cuDNN
    deterministic, as every run of the port), and their sums over the
    layers."""
    import torch
    import torch.nn.functional as F

    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        DepthwiseConvolution2D,
    )
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.conv import (
        pad_same,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    seen: dict = {}
    for layer in net.layers:
        if isinstance(layer, DepthwiseConvolution2D):
            key = (tuple(layer._build_shape), layer.subsample)
            seen.setdefault(key, [layer, 0])[1] += 1
    total_f = total_b = 0.0
    for (shape, stride), (layer, count) in seen.items():
        h, w, c = shape
        x = pad_same(torch.randn((batch, c, h, w), generator=gen,
                                 device=dev), layer.kernel_size, stride)
        x = x.contiguous(memory_format=torch.channels_last)
        k = net.params[layer.name]["depthwise_kernel"].permute(3, 2, 0, 1)
        y = F.conv2d(x, k, stride=stride, groups=c)
        g = torch.randn(y.shape, generator=gen, device=dev).contiguous(
            memory_format=torch.channels_last)

        def fwd():
            return F.conv2d(x, k, stride=stride, groups=c)

        def bwd():
            return torch.ops.aten.convolution_backward(
                g, x, k, None, list(stride), [0, 0], [1, 1], False, [0, 0],
                c, [True, True, False])

        f, b = graph_ms(fwd), graph_ms(bwd)
        total_f += f * count
        total_b += b * count
        log(f"mobilenet_v2 depthwise {shape} stride {stride} x{count}: "
            f"forward {f:.3f} ms, backward {b:.3f} ms at batch {batch}")
    log(f"mobilenet_v2 depthwise, all {sum(c for _, c in seen.values())} "
        f"layers at batch {batch}: forward {total_f:.2f} ms, backward "
        f"{total_b:.2f} ms of device time (cuDNN deterministic; "
        f"{card_line})")


def mobilenet_v2_phases(card_line: str) -> tuple[dict, dict]:
    """MobileNet-v2 (``mobilenet_v2()``, 224x224x3, 1000 classes): 4
    steps of ``fit`` in f32 at batch 64 (SGD, momentum 0.9) bit for bit
    ``train_step`` called eagerly, a replayed step's times, the depthwise
    layers' forward and backward times; then served (moving statistics
    set to one batch's) at 1, 8 and 32 images in f32 and bf16.  Returns
    the training and serving paths' launch counts."""
    import torch

    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.models.imagenet_zoo import mobilenet_v2
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        recalibrate_batchnorm,
    )
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import SGD

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    init_zoo_context(seed=SEED, device="cuda")
    net = mobilenet_v2()
    net.build_params()
    weights = (net.params, net.state)
    flops = conv_flops(net)
    gen = np.random.default_rng(SEED + 50)
    n = MOBILENET_BATCH * MOBILENET_STEPS
    x = gen.standard_normal((n,) + ZOO_SHAPE, dtype=np.float32)
    y = gen.integers(0, ZOO_CLASSES, n).astype(np.int32)
    log(f"mobilenet_v2: {param_count(net)} parameters, "
        f"{flops[0] / 1e9:.3f} GFLOP an image forward, {flops[1] / 1e9:.3f} "
        f"a training image")

    def sgd():
        return SGD(lr=0.045, momentum=0.9, weight_decay=4e-5)

    reset_counters()  # the MobileNet-v2 training path: to the read below
    tnet = zoo_net(mobilenet_v2, weights, sgd())
    captured_fit_check("mobilenet_v2 f32", tnet, None, x, y,
                       MOBILENET_STEPS, MOBILENET_BATCH)
    replayed_step("mobilenet_v2 f32", tnet, None, x, y, MOBILENET_BATCH,
                  MOBILENET_STEPS, flops, PEAK_FLOPS["float32"], card_line)
    training = counters()  # end of the MobileNet-v2 training path
    depthwise_times(tnet, MOBILENET_BATCH, card_line)
    tnet._estimator._steps.clear()
    del tnet
    free_device_memory("after mobilenet_v2 training")
    log(f"mobilenet_v2 training launches {training}; phase "
        f"mobilenet_v2_training: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    recalibrate_batchnorm(net, gen.standard_normal(
        (MOBILENET_BATCH,) + ZOO_SHAPE, dtype=np.float32))
    serving = serve_zoo_model("mobilenet_v2", net, ZOO_SHAPE, ZOO_REQUESTS,
                              gen, flops, card_line)[0]
    del net
    free_device_memory("after mobilenet_v2 serving")
    log(f"mobilenet_v2 serving launches {serving}; phase "
        f"mobilenet_v2_serving: {time.perf_counter() - t_phase:.1f} s; peak "
        f"memory allocated {torch.cuda.max_memory_allocated()} B")
    return training, serving


def zoo_serving_phase(card_line: str) -> dict:
    """The other builders at full width (``zoo_builders``), random weights
    from the seed (moving statistics set to one batch's): each serves one
    replayed ZOO_REQUEST-image f32 request, bit for bit its eager forward,
    finite rows summing to 1.  Logs each model's parameter count, request
    time and peak memory.  Returns the path's launch counts."""
    import torch

    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        recalibrate_batchnorm,
    )

    t_phase = time.perf_counter()
    gen = np.random.default_rng(SEED + 60)
    total = {k: 0 for k in counters()}
    for name, build, shape in zoo_builders():
        t0 = time.perf_counter()
        free_device_memory(f"before {name}")
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        init_zoo_context(seed=SEED, device="cuda")
        net = build()
        net.build_params()
        if net.state:
            recalibrate_batchnorm(net, gen.standard_normal(
                (ZOO_REQUEST,) + shape, dtype=np.float32))
        flops = conv_flops(net)
        launches = serve_zoo_model(name, net, shape, (ZOO_REQUEST,), gen,
                                   flops, card_line, precisions=("f32",))[0]
        total = {k: total[k] + launches[k] for k in total}
        log(f"{name} ({shape}): {param_count(net)} parameters, "
            f"{flops[0] / 1e9:.2f} GFLOP an image forward; peak memory "
            f"allocated {torch.cuda.max_memory_allocated() - held} B above "
            f"the {held} B held before it; {time.perf_counter() - t0:.1f} s")
        del net
    free_device_memory("after the zoo")
    log(f"zoo serving launches {total}; phase zoo_serving: "
        f"{time.perf_counter() - t_phase:.1f} s")
    return total


# ---------------------------------------------------------------------------
# Calibrated int8 serving of conv nets (the role of the reference's
# examples/vnni/perf.py): ResNet-50 (moving statistics set to one batch's)
# calibrated on INT8_CALIB seeded images through ``optimize("int8",
# calibration_data=...)``, its 53 convolutions and its fc on the
# ``int8_conv`` kernel; Inception-v1 and MobileNet-v2 calibrated the same
# way, one ZOO_REQUEST-image request each
INT8_CALIB = 32
RESNET_INT8_LAUNCHES = 54


def f64_ops(fn) -> list:
    """The names of the ops ``fn()`` runs on a float64 tensor (an input
    or an output), in order."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves as leaves

    seen = []

    class Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if any(isinstance(t, torch.Tensor) and t.dtype == torch.float64
                   for t in leaves((args, kwargs, out))):
                seen.append(str(func))
            return out

    with Watch():
        fn()
    return seen


def resnet50_int8_phase(card_line: str) -> dict:
    """ResNet-50 (224x224x3, 1000 classes, random weights from the seed,
    moving statistics set to one batch's) served in calibrated int8
    through ``InferenceModel().from_keras_net(net).optimize("int8",
    calibration_data=...)``, ``warmup`` and ``predict`` at 1, 8 and 32
    images: each replay bit for bit its eager forward, finite rows
    summing to 1, RESNET_INT8_LAUNCHES ``quantize_act`` and as many
    ``int8_conv`` launches a replayed micro-batch (53 convolutions and the
    fc) and no other kernel of the table, no float64 convolution or matmul
    in an eager forward; request 0 against the same ``Int8Model`` (its
    qparams and activation scales) on the CPU within INT8_CPU_TOL; argmax
    agreement and ``logit_gap`` against the f32 model printed (no bound:
    how far calibrated int8 moves a random net is the reference's
    algorithm's, which the CPU tests hold the port to); each request's
    host clock, device time, idle share and images/s beside the f32 and
    bf16 requests' and the bound.  Returns the path's launch counts."""
    import torch

    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.common.utils import tree_map
    from analytics_zoo_tpu_torch.models import ResNet
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        recalibrate_batchnorm,
    )
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    from analytics_zoo_tpu_torch.pipeline.inference.quantize import (
        Int8Model,
        QuantizedTensor,
    )

    t_phase = time.perf_counter()
    free_device_memory("before resnet50_int8")
    init_zoo_context(seed=SEED, device="cuda")
    gen = np.random.default_rng(SEED + 80)
    net = ResNet.image_net(50, classes=RESNET_CLASSES,
                           input_shape=RESNET_SHAPE)
    net.build_params()
    recalibrate_batchnorm(net, gen.standard_normal(
        (RESNET_BATCH,) + RESNET_SHAPE, dtype=np.float32))
    flops = conv_flops(net)
    calib = gen.standard_normal((INT8_CALIB,) + RESNET_SHAPE,
                                dtype=np.float32)
    t0 = time.perf_counter()
    models = {"f32": InferenceModel().from_keras_net(net),
              "bf16": InferenceModel().from_keras_net(net).optimize("bf16"),
              "int8": InferenceModel().from_keras_net(net).optimize(
                  "int8", calibration_data=calib)}
    qm = models["int8"]._int8_model
    cal_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for im in models.values():
        im.warmup([RESNET_SHAPE], dtype=np.float32,
                  batch_sizes=RESNET_REQUESTS)
    torch.cuda.synchronize()
    log(f"resnet50_int8: calibrated on {INT8_CALIB} images in {cal_s:.1f} s "
        f"({len(qm.act_scales)} scales, {len(qm.weights_t)} int8 kernels "
        f"held as (Cout, K) copies); f32, bf16 and int8 warmed up (captured) "
        f"at {RESNET_REQUESTS} in {time.perf_counter() - t0:.1f} s")
    if len(qm.weights_t) != RESNET_INT8_LAUNCHES:
        raise AssertionError(f"expected {RESNET_INT8_LAUNCHES} int8 layers, "
                             f"got {sorted(qm.weights_t)}")
    reqs = {n: gen.standard_normal((n,) + RESNET_SHAPE, dtype=np.float32)
            for n in RESNET_REQUESTS}
    want = {n: eager_predict(models["int8"], [reqs[n]])
            for n in RESNET_REQUESTS}
    wide = [op for op in f64_ops(lambda: eager_predict(
        models["int8"], [reqs[1]])) if "conv" in op or "mm" in op]
    torch.cuda.synchronize()
    reset_counters()  # the calibrated ResNet-50 path: to the read below
    got = {n: models["int8"].predict(reqs[n]) for n in RESNET_REQUESTS}
    launches = counters()  # end of the calibrated ResNet-50 path
    expected = dict({k: 0 for k in launches},
                    int8_conv=RESNET_INT8_LAUNCHES * len(RESNET_REQUESTS),
                    quantize_act=RESNET_INT8_LAUNCHES * len(RESNET_REQUESTS))
    log(f"resnet50_int8 launches {launches} (expected {expected}); float64 "
        f"convolutions or matmuls in an eager forward: {wide}")
    if launches != expected or wide:
        raise AssertionError("the calibrated ResNet-50 did not run its "
                             "int8 layers on quantize_act and int8_conv "
                             "alone")
    f32 = {n: models["f32"].predict(reqs[n]) for n in RESNET_REQUESTS}
    for n in RESNET_REQUESTS:
        out = got[n]
        same = np.array_equal(out, want[n])
        sums = float(np.abs(out.sum(-1) - 1).max())
        agree = float(np.mean(out.argmax(-1) == f32[n].argmax(-1)))
        log(f"resnet50_int8 {n} image(s): {out.shape}, replay equal to the "
            f"eager forward bit for bit {same}; rows sum to 1 within "
            f"{sums:.2e}; against f32: argmax agreement {agree:.3f}, logit "
            f"gap {logit_gap(out, f32[n]):.4f}, max |d| "
            f"{float(np.abs(out - f32[n]).max()):.3e}")
        if not same or not np.isfinite(out).all() or sums > 1e-4 \
                or out.shape != (n, RESNET_CLASSES):
            raise AssertionError(f"calibrated ResNet-50 serving of {n} is "
                                 "wrong")
    # request 0 against the same Int8Model on the CPU
    cpu = ResNet.image_net(50, classes=RESNET_CLASSES,
                           input_shape=RESNET_SHAPE)
    cpu.device = torch.device("cpu")
    cpu.params = tree_map(lambda t: t.cpu(), net.params)
    cpu.state = tree_map(lambda t: t.cpu(), net.state)
    cpu_q = Int8Model(cpu, tree_map(
        lambda l: QuantizedTensor(l.values.cpu(), l.scale.cpu(), l.axis)
        if isinstance(l, QuantizedTensor) else l.cpu(), qm.qparams),
        qm.act_scales)
    t0 = time.perf_counter()
    n0 = RESNET_REQUESTS[0]
    err = float(np.abs(cpu_q.predict(reqs[n0], batch_size=n0)
                       - got[n0]).max())
    log(f"resnet50_int8 request 0 ({n0} image) vs the same Int8Model on the "
        f"CPU ({time.perf_counter() - t0:.1f} s there): max|d| {err:.3e} "
        f"(tol {INT8_CPU_TOL:g})")
    if not err <= INT8_CPU_TOL:
        raise AssertionError("the calibrated ResNet-50 request disagrees "
                             "with the CPU")
    del cpu, cpu_q
    for tag, im in models.items():
        peak = PEAK_FLOPS[{"int8": "int8", "bf16": "bfloat16"}.get(
            tag, "float32")]
        for n in RESNET_REQUESTS:
            host = []
            for _ in range(HOST_REPEATS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                im.predict(reqs[n])
                host.append((time.perf_counter() - t0) * 1e3)
            key = ((reqs[n].shape, str(reqs[n].dtype)),)
            dev = replay_ms(graph_of(im._steps[key].step))
            med = float(np.median(host))
            log(f"resnet50_int8 request {tag}, {n} image(s): host clock "
                f"{', '.join(f'{t:.3f}' for t in host)} ms (median "
                f"{med:.3f}), device {dev:.3f} ms, idle "
                f"{max(0.0, 1 - dev / med):.1%}, {n / med * 1e3:.1f} "
                f"images/s; bound {n * flops[0] / peak * 1e3:.3f} ms "
                f"({flops[0] / 1e9:.2f} GFLOP an image at "
                f"{peak / 1e12:.0f} T/s) ({card_line})")
    del models, net
    free_device_memory("after resnet50_int8")
    log(f"phase resnet50_int8: {time.perf_counter() - t_phase:.1f} s")
    return launches


def zoo_int8_phase(card_line: str) -> dict:
    """Inception-v1 and MobileNet-v2 (224x224x3, 1000 classes, moving
    statistics set to one batch's) calibrated on ZOO_REQUEST seeded images
    and served one replayed ZOO_REQUEST-image request each: bit for bit its
    eager forward, finite rows summing to 1, one ``quantize_act`` and one
    ``int8_conv`` launch per int8 layer.  MobileNet-v2's depthwise
    convolutions are no targets and stay float (as in the reference); its
    1x1 convolutions run int8.
    Returns the path's launch counts."""
    import torch

    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.models import Inception
    from analytics_zoo_tpu_torch.models.imagenet_zoo import mobilenet_v2
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        DepthwiseConvolution2D,
        recalibrate_batchnorm,
    )
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

    t_phase = time.perf_counter()
    gen = np.random.default_rng(SEED + 90)
    total = {k: 0 for k in counters()}
    for name, build in (("inception_v1", lambda: Inception.v1(
            classes=ZOO_CLASSES, input_shape=ZOO_SHAPE)),
                        ("mobilenet_v2", mobilenet_v2)):
        init_zoo_context(seed=SEED, device="cuda")
        net = build()
        net.build_params()
        if net.state:
            recalibrate_batchnorm(net, gen.standard_normal(
                (ZOO_REQUEST,) + ZOO_SHAPE, dtype=np.float32))
        im = InferenceModel().from_keras_net(net).optimize(
            "int8", calibration_data=gen.standard_normal(
                (ZOO_REQUEST,) + ZOO_SHAPE, dtype=np.float32))
        hooked = sorted(im._int8_model.weights_t)
        depthwise = [ly.name for ly in net.layers
                     if isinstance(ly, DepthwiseConvolution2D)]
        im.warmup([ZOO_SHAPE], dtype=np.float32, batch_sizes=[ZOO_REQUEST])
        x = gen.standard_normal((ZOO_REQUEST,) + ZOO_SHAPE, dtype=np.float32)
        want = eager_predict(im, [x])
        torch.cuda.synchronize()
        reset_counters()  # this model's calibrated request: to the read
        got = im.predict(x)
        launches = counters()  # end of this model's calibrated request
        total = {k: total[k] + launches[k] for k in total}
        same = np.array_equal(got, want)
        sums = float(np.abs(got.sum(-1) - 1).max())
        log(f"{name} int8: {len(hooked)} int8 layers, {len(depthwise)} "
            f"depthwise layers kept float ({sorted(set(depthwise) & set(hooked))}"
            f" hooked); {ZOO_REQUEST}-image request equal to the eager "
            f"forward bit for bit {same}, rows sum to 1 within {sums:.2e}; "
            f"launches {launches}")
        expected = dict({k: 0 for k in launches}, int8_conv=len(hooked),
                        quantize_act=len(hooked))
        if not same or sums > 1e-4 or not np.isfinite(got).all() \
                or launches != expected or set(depthwise) & set(hooked) \
                or not hooked:
            raise AssertionError(f"calibrated {name} serving is wrong")
        del net, im
        free_device_memory(f"after {name} int8")
    log(f"zoo int8 launches {total}; phase zoo_int8: "
        f"{time.perf_counter() - t_phase:.1f} s ({card_line})")
    return total


# ---------------------------------------------------------------------------
# BERT-base fine-tuned under the reference's BERT optimizer:
# ``AdamWeightDecay(lr=2e-5, warmup_portion=0.1, total=50)`` (optax
# adamw, weight decay 0.01 on every leaf, epsilon 1e-6, a warmup over 5
# steps then a linear decay), f32, 5 captured steps at 8 x 512
ADAMW = dict(lr=2e-5, warmup_portion=0.1, total=50)


def adamw_rate(net, path, before) -> float:
    """The rate the last step applied to the leaf at ``path``: its change
    against the direction the step computed from the new moments and the
    old value (least squares, float64)."""
    import torch

    opt = net._estimator.optimizer
    state = net._estimator._opt_state
    layer, leaf = path
    t = int(state.count)
    mu, nu = (getattr(state, f)[layer][leaf].double() for f in ("mu", "nu"))
    d = (mu / (1 - opt.b1 ** t)) / (torch.sqrt(nu / (1 - opt.b2 ** t))
                                    + opt.eps) + opt.weight_decay \
        * before.double()
    delta = net.params[layer][leaf].double() - before.double()
    return (-(delta * d).sum() / (d * d).sum().clamp_min(1e-300)).item()


def bert_adamw_phase(card_line: str) -> dict:
    """The BERT-base classifier through ``compile(AdamWeightDecay(...),
    "sparse_categorical_crossentropy_from_logits", ["accuracy"])``, f32:
    5 steps through ``fit`` (step 1 eager and captured, then replays) bit
    for bit 5 ``train_step`` calls made eagerly (twice); 5 more replayed
    steps launch 12 + 12 flash and 1 + 1 cross-entropy kernels a step and
    no Adam kernel (the reference's kernel plane takes only ``Adam``); on
    one repeated batch each step's rate, read back from the classifier
    kernel's change and the moments, is the schedule's on the host; then
    step 1 at 2 blocks (batch 2, attention dropout on) against the CPU:
    the loss, the moments and the parameters within TRAIN_CPU_TOL of each
    leaf's largest value (the warmup gives step 1 the rate 0, so the
    parameters stay where they were and the moments carry the step).
    Returns the replayed steps' launch counts."""
    import torch

    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.common.engine import step_generator
    from analytics_zoo_tpu_torch.common.utils import tree_leaves
    from analytics_zoo_tpu_torch.parallel import compile_step
    from analytics_zoo_tpu_torch.pipeline.api.keras.objectives import (
        get_loss,
    )
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import (
        AdamWeightDecay,
    )
    from analytics_zoo_tpu_torch.pipeline.estimator import Estimator
    from analytics_zoo_tpu_torch.pipeline.estimator.estimator import (
        _to_device,
    )

    t_phase = time.perf_counter()
    free_device_memory("before bert_adamw")
    gen = np.random.default_rng(SEED + 100)
    blocks = BERT_BASE["n_block"]
    x, y = train_data(TRAIN_BATCH * CAPTURE_STEPS, gen)

    def fresh(n_block=blocks, hidden=DROPOUT, device="cuda"):
        init_zoo_context(seed=SEED, device=device)
        net = bert_classifier(n_block, hidden, DROPOUT)
        net.build_params()
        net.compile(optimizer=AdamWeightDecay(**ADAMW),
                    loss="sparse_categorical_crossentropy_from_logits",
                    metrics=["accuracy"])
        return net

    net = fresh()
    first, l_first, _ = eager_steps(net, None, x, y, CAPTURE_STEPS)
    want, l_want, eager_ms = eager_steps(net, None, x, y, CAPTURE_STEPS)
    drift = differing(first, want)
    if drift or l_first != l_want:
        raise AssertionError(f"the eager AdamW step is not deterministic: "
                             f"{drift[:8]}")
    del first
    net.fit(x, y, batch_size=TRAIN_BATCH, nb_epoch=1)
    est = net._estimator
    losses = [v for _, v in est.loss_log]
    off = differing({"params": net.params, "opt": est._opt_state}, want)
    log(f"bert_adamw: {CAPTURE_STEPS} steps through fit against train_step "
        f"eagerly: losses equal {losses == l_want} "
        f"({', '.join(f'{v:.4f}' for v in losses)}), "
        f"{len(named_leaves(want)) - len(off)} of {len(named_leaves(want))} "
        f"parameter and moment leaves equal bit for bit"
        f"{'; differ: ' + str(off[:8]) if off else ''}")
    if losses != l_want or off:
        raise AssertionError("the captured AdamW step is not the eager step")
    del want
    reset_counters()  # the replayed AdamW steps: to the read below
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.fit(x, y, batch_size=TRAIN_BATCH, nb_epoch=1)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / CAPTURE_STEPS
    launches = counters()  # end of the replayed AdamW steps
    per_step = {"flash_attention_fwd": blocks, "flash_attention_bwd": blocks,
                "fused_adam": 0, "softmax_xent_fwd": 1,
                "softmax_xent_bwd": 1, "int8_matmul": 0, "int8_conv": 0,
                "quantize_act": 0}
    expected = {k: v * CAPTURE_STEPS for k, v in per_step.items()}
    dev_ms = replay_ms(graph_of(est._train_step_for(1,
                                                    est._resolve_plan())))
    log(f"bert_adamw: replayed step host clock {host_ms:.2f} ms, device "
        f"{dev_ms:.2f} ms, idle {max(0.0, 1 - dev_ms / host_ms):.1%}, "
        f"{eager_ms:.2f} ms eager ({card_line}); launches {launches} "
        f"(expected {expected})")
    if launches != expected:
        raise AssertionError("the AdamW replays did not count their kernels")
    del net
    free_device_memory("after bert_adamw fit")

    # one repeated batch, one step a fit: each step's rate against the
    # schedule on the host
    net = fresh()
    opt = net._compiled["optimizer"]
    xb, yb = [a[:TRAIN_BATCH] for a in x], y[:TRAIN_BATCH]
    path = ("dense_0", "kernel")
    rates = []
    for i in range(FIXED_STEPS):
        before = net.params[path[0]][path[1]].clone()
        net.fit(xb, yb, batch_size=TRAIN_BATCH, nb_epoch=1)
        host = ADAMW["lr"] * float(opt.schedule(torch.tensor(i)))
        rates.append((adamw_rate(net, path, before), host))
    rep = [v for _, v in net._estimator.loss_log]
    worst = max(abs(g - w) for g, w in rates) / ADAMW["lr"]
    log(f"bert_adamw fixed batch, {FIXED_STEPS} steps: losses "
        f"{', '.join(f'{v:.4f}' for v in rep)}; rates applied on the card "
        f"{', '.join(f'{g:.3e}' for g, _ in rates)} against the schedule on "
        f"the host {', '.join(f'{w:.3e}' for _, w in rates)}: worst "
        f"{worst:.2e} of the peak {ADAMW['lr']}")
    if worst > RATE_TOL or not np.all(np.isfinite(rep)):
        raise AssertionError("a step's AdamW rate is not the schedule's")
    del net
    free_device_memory("after bert_adamw fixed batch")

    # step 1 at 2 blocks on the card against the CPU
    xs, ys = train_data(2, gen)
    batch = {"x": xs, "y": ys}
    results = []
    for device in ("cuda", "cpu"):
        small = bert_classifier(2, 0.0, DROPOUT)
        small.build_params(rng=torch.Generator().manual_seed(SEED),
                           device=device)
        est = Estimator(small, optimizer=AdamWeightDecay(**ADAMW),
                        loss=get_loss(
                            "sparse_categorical_crossentropy_from_logits"))
        step = compile_step(est.train_step, est._resolve_plan(),
                            capture=False)
        params, opt_state, _, loss = step(
            small.params, est.optimizer.init(small.params), small.state,
            step_generator(SEED, 0, small.device),
            _to_device(batch, small.device), est.compute_casts(
                est._resolve_plan(), small.params))
        results.append((float(loss), [t.cpu() for t in tree_leaves(
            (params, opt_state.mu, opt_state.nu))]))
    (g_loss, g_leaves), (c_loss, c_leaves) = results
    loss_err = abs(g_loss - c_loss) / abs(c_loss)
    leaf_err = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                   .item() for a, b in zip(g_leaves, c_leaves))
    log(f"bert_adamw step 1 vs CPU (2 blocks, batch 2): loss {g_loss:.6f} "
        f"vs {c_loss:.6f} (rel {loss_err:.2e}), parameters and moments max "
        f"rel to leaf max {leaf_err:.2e} (tol {TRAIN_CPU_TOL:g}); phase "
        f"bert_adamw: {time.perf_counter() - t_phase:.1f} s")
    if not (loss_err <= TRAIN_CPU_TOL and leaf_err <= TRAIN_CPU_TOL):
        raise AssertionError("the AdamW step on the card disagrees with the "
                             "CPU")
    return launches


# ---------------------------------------------------------------------------
# The rest of the optimizers, metrics and losses: LeNet-5 at batch 128 on
# the quadrant task under each optimizer, OPT_STEPS captured steps; a
# binary LeNet-5 head evaluated with ``["auc", "mae", "mse"]``; every loss
# of the reference's table on a seeded (64, 10) batch against the CPU
OPT_STEPS, OPT_BATCH, OPT_FIXED_STEPS = 4, 128, 6
LOSS_CPU_TOL = 1e-6


def optimizer_builders() -> list:
    from analytics_zoo_tpu_torch.pipeline.api.keras import optimizers as o

    return [("rmsprop", lambda: o.RMSprop(1e-3)),
            ("adagrad", lambda: o.Adagrad(1e-2)),
            ("adadelta", lambda: o.Adadelta()),
            ("adamax", lambda: o.Adamax(2e-3))]


def loss_inputs(name, gen):
    """(y_true, y_pred) of a loss's domain, (64, 10) (the ranking hinge's
    (64, 1)), as numpy."""
    logits = gen.normal(size=(64, 10)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    labels = gen.integers(0, 10, 64).astype(np.int32)
    if name.startswith("sparse"):
        return labels, logits if "logits" in name else probs
    if name == "categorical_crossentropy":
        return np.eye(10, dtype=np.float32)[labels], probs
    if name in ("kld", "kullback_leibler_divergence"):
        return gen.random((64, 10)).astype(np.float32), probs
    if name == "binary_crossentropy":
        return gen.integers(0, 2, (64, 10)).astype(np.float32), \
            gen.uniform(0.01, 0.99, (64, 10)).astype(np.float32)
    if name == "binary_crossentropy_from_logits":
        return gen.integers(0, 2, (64, 10)).astype(np.float32), logits
    if name in ("hinge", "squared_hinge"):
        return np.sign(gen.normal(size=(64, 10))).astype(np.float32), logits
    if name == "poisson":
        return gen.poisson(2.0, (64, 10)).astype(np.float32), \
            np.exp(logits).astype(np.float32)
    if name in ("msle", "mean_squared_logarithmic_error"):
        return np.abs(logits) * 3, gen.random((64, 10)).astype(np.float32)
    if name == "rank_hinge":
        return np.ones((64, 1), np.float32), logits[:, :1]
    return gen.normal(size=(64, 10)).astype(np.float32), logits


def losses_against_the_cpu(gen, card="cuda") -> float:
    """Every loss of the table and its gradient (of the mean, with respect
    to the predictions) on the device ``card`` against the same call on
    the CPU: the largest error relative to each value's largest
    magnitude."""
    import torch

    from analytics_zoo_tpu_torch.pipeline.api.keras import objectives as o

    worst = {}
    for name in sorted(o._LOSSES):
        y_true, y_pred = loss_inputs(name, gen)
        out = []
        for device in (card, "cpu"):
            p = torch.from_numpy(y_pred).to(device).requires_grad_(True)
            val = o.get_loss(name)(torch.from_numpy(y_true).to(device), p)
            (g,) = torch.autograd.grad(val.mean(), p)
            out.append((val.detach().cpu(), g.cpu()))
        (gv, gg), (cv, cg) = out
        worst[name] = max(((a - b).abs().max() / b.abs().max().clamp_min(
            1e-30)).item() for a, b in ((gv, cv), (gg, cg)))
    log(f"losses on the card vs the CPU (value and gradient, relative to "
        f"the largest): worst {max(worst.values()):.2e} (tol "
        f"{LOSS_CPU_TOL:g}) over {len(worst)} names; "
        + ", ".join(f"{k} {v:.1e}" for k, v in worst.items()))
    if max(worst.values()) > LOSS_CPU_TOL:
        raise AssertionError("a loss on the card disagrees with the CPU")
    return max(worst.values())


def optimizers_phase(card_line: str) -> dict:
    """LeNet-5 (28x28x1, 10 classes) at batch OPT_BATCH under each of
    ``RMSprop``, ``Adagrad``, ``Adadelta`` and ``Adamax``: OPT_STEPS steps
    through ``fit`` (step 1 eager and captured, then replays) bit for bit
    ``train_step`` called eagerly, and on a fixed batch a loss lower after
    OPT_FIXED_STEPS steps than before.  A binary LeNet-5 head
    (``Dense(1, sigmoid)``, ``"binary_crossentropy"``) evaluated with
    ``["auc", "mae", "mse"]`` through the captured eval step, bit for bit
    the uncaptured one, after one epoch under ``"rmsprop"``.  Every loss
    of the table against the CPU.
    Returns the path's launch counts."""
    import torch

    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.feature.dataset import FeatureSet
    from analytics_zoo_tpu_torch.models import build_lenet
    from analytics_zoo_tpu_torch.parallel import compile_step
    from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        Convolution2D,
        Dense,
        Flatten,
        MaxPooling2D,
    )

    t_phase = time.perf_counter()
    gen = np.random.default_rng(SEED + 110)
    x, y = quadrant_task(OPT_BATCH * OPT_STEPS, gen)
    reset_counters()  # the optimizers path: to the read below
    for name, make in optimizer_builders():
        init_zoo_context(seed=SEED, device="cuda")
        net = build_lenet()
        net.compile(optimizer=make(), loss="sparse_categorical_crossentropy")
        net.build_params()
        want, l_want, eager_ms = eager_steps(net, None, x, y, OPT_STEPS,
                                             OPT_BATCH)
        net.fit(x, y, batch_size=OPT_BATCH, nb_epoch=1)
        losses = [v for _, v in net._estimator.loss_log]
        got = {"params": net.params, "opt": net._estimator._opt_state,
               "state": net.state}
        off = differing(got, want)
        fixed = build_lenet()
        fixed.compile(optimizer=make(),
                      loss="sparse_categorical_crossentropy")
        fixed.build_params()
        xb, yb = x[:OPT_BATCH], y[:OPT_BATCH]
        before = fixed.evaluate(xb, yb, batch_size=OPT_BATCH)["loss"]
        fixed.fit(xb, yb, batch_size=OPT_BATCH, nb_epoch=OPT_FIXED_STEPS)
        after = fixed.evaluate(xb, yb, batch_size=OPT_BATCH)["loss"]
        log(f"optimizers {name}: {OPT_STEPS} steps through fit against "
            f"train_step eagerly ({eager_ms:.2f} ms a step): losses equal "
            f"{losses == l_want}, {len(named_leaves(want)) - len(off)} of "
            f"{len(named_leaves(want))} parameter and state leaves equal bit "
            f"for bit{'; differ: ' + str(off[:8]) if off else ''}; fixed "
            f"batch loss {before:.4f} -> {after:.4f} after "
            f"{OPT_FIXED_STEPS} steps")
        if losses != l_want or off or not after < before:
            raise AssertionError(f"the captured {name} step is not the eager "
                                 "step, or the loss did not fall")
    # the binary head: AUC, MAE and MSE through the captured eval step
    init_zoo_context(seed=SEED, device="cuda")
    head = Sequential()
    head.add(Convolution2D(6, 5, 5, activation="tanh", border_mode="same",
                           input_shape=(28, 28, 1)))
    head.add(MaxPooling2D())
    head.add(Convolution2D(16, 5, 5, activation="tanh"))
    head.add(MaxPooling2D())
    head.add(Flatten())
    head.add(Dense(120, activation="tanh"))
    head.add(Dense(84, activation="tanh"))
    head.add(Dense(1, activation="sigmoid"))
    head.compile(optimizer="rmsprop", loss="binary_crossentropy",
                 metrics=["auc", "mae", "mse"])
    head.build_params()
    yb = (y % 2).astype(np.float32)[:, None]
    head.fit(x, yb, batch_size=OPT_BATCH, nb_epoch=1)
    est = head._estimator
    plan = est._resolve_plan()
    eager = est._evaluate_with(
        head.params, head.state, FeatureSet.of(x, yb), OPT_BATCH,
        est.compute_casts(plan, head.params),
        step=compile_step(est.eval_step, plan, label="eval_step_eager",
                          capture=False))
    first = head.evaluate(x, yb, batch_size=OPT_BATCH)  # captures
    got = head.evaluate(x, yb, batch_size=OPT_BATCH)    # replays
    log(f"optimizers binary head: captured eval {got}; the capture's "
        f"{first}; uncaptured {eager} (equal: {got == eager == first})")
    if not got == eager == first or not 0.0 <= got["auc"] <= 1.0:
        raise AssertionError("the captured AUC/MAE/MSE eval is not the "
                             "eager one")
    launches = counters()  # end of the optimizers path
    losses_against_the_cpu(gen)
    torch.cuda.synchronize()
    log(f"optimizers launches {launches} (no kernel of the table: the "
        f"updates are multi-tensor passes); phase optimizers: "
        f"{time.perf_counter() - t_phase:.1f} s ({card_line})")
    return launches


# ---------------------------------------------------------------------------
# Fault-tolerant training: checkpoints, mid-epoch resume and retry, with
# the data tiers.  BERT-base (bf16 mixed precision, Adam 2e-5, dropout
# 0.1, batch 8) fed from .npz shards (DISK_2) and ResNet-50 (bf16, the
# ImageNet SGD recipe, batch 64) fed from a memory-mapped (PMEM) array
# set, each FT_STEPS steps an epoch, two epochs, FT_K steps a dispatch
# (ZOO_STEPS_PER_DISPATCH): an uninterrupted fit, a fit resumed mid-epoch
# by a fresh model and estimator (its first leg's snapshots after the first
# mid-epoch one dropped, as if the process had died there: an end trigger
# stops a fit only at an epoch boundary, as in the reference), and a fit
# retried after an injected fault must end bit for bit alike.
FT_STEPS, FT_K, FT_EVERY = 5, 2, 3
FT_SHARDS = 4


def ft_crash_after_first_mid_epoch_save(ck: str) -> int:
    """Removes every snapshot in ``ck`` after the first one taken inside an
    epoch (its step not a multiple of FT_STEPS); returns that step."""
    import os

    tags = sorted(int(f[len("ckpt-"):-len(".pkl")]) for f in os.listdir(ck)
                  if f.startswith("ckpt-") and f.endswith(".pkl"))
    keep = next(t for t in tags if t % FT_STEPS)
    for t in tags:
        if t > keep:
            os.remove(os.path.join(ck, f"ckpt-{t}.pkl"))
    log(f"fault tolerant: snapshots {tags} in {ck}; kept up to step {keep}")
    return keep


def ft_trees(net) -> dict:
    """A trained model's parameters, optimizer state and model state."""
    return {"params": net.params, "opt": net._estimator._opt_state,
            "state": net.state}


def ft_same(tag, got, want, resumed_from: int) -> None:
    """``got`` (a resumed or retried model) against ``want`` (the
    uninterrupted one): the losses from the resume point on, every leaf of
    the parameters, optimizer state and model state, and the step count,
    bit for bit."""
    ge, we = got._estimator, want._estimator
    gl, wl = dict(ge.loss_log), dict(we.loss_log)
    tail = {i: v for i, v in wl.items() if i > resumed_from}
    off = differing(ft_trees(got), ft_trees(want))
    same_losses = {i: v for i, v in gl.items() if i > resumed_from} == tail
    log(f"fault tolerant {tag}: resumed after step {resumed_from}; "
        f"losses of steps {sorted(tail)} equal {same_losses}; "
        f"{len(named_leaves(ft_trees(want))) - len(off)} of "
        f"{len(named_leaves(ft_trees(want)))} parameter, optimizer and "
        f"model-state leaves equal bit for bit"
        f"{'; differ: ' + str(off[:8]) if off else ''}; steps "
        f"{ge.global_step} / {we.global_step}")
    if not same_losses or off or ge.global_step != we.global_step:
        raise AssertionError(f"the {tag} fit is not the uninterrupted fit")


def ft_fit(net, fs, batch, plan, ckpt=None, tb=None, **kw):
    """``train`` of a fresh estimator of ``net`` (checkpointed into
    ``ckpt``, summaries into ``tb``), timed: (estimator, seconds)."""
    import torch

    if ckpt is not None:
        net.set_checkpoint(ckpt)
    if tb is not None:
        net.set_tensorboard(tb, "fault_tolerant")
    est = net._make_estimator()
    net._estimator = est
    kw.setdefault("nb_epoch", 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est.train(fs, batch_size=batch, plan=plan, **kw)
    torch.cuda.synchronize()
    return est, time.perf_counter() - t0


def ft_saves(tag, ck, card_line) -> None:
    """A checkpointer's snapshot bytes, the caller's stall and the
    writer's seconds per save."""
    log(f"fault tolerant {tag} saves ({ck.path}): bytes "
        f"{ck.bytes}; caller's stall "
        f"{[round(s * 1e3, 2) for s in ck.stall_seconds]} ms; writer "
        f"{[round(s, 3) for s in ck.write_seconds]} s ({card_line})")


def ft_step_times(tag, make, sets, batch, plan, tmp, card_line) -> dict:
    """The host clock of a step (one epoch of FT_STEPS, after a warm
    epoch) from each set of ``sets`` ({tier: FeatureSet}), then from the
    resident set with a save at the epoch's last step and boundary
    (SeveralIteration(FT_STEPS)), asynchronous and inline; the device time
    of a step from the K-step capture's replay, and the idle share."""
    import os
    import shutil

    import torch

    from analytics_zoo_tpu_torch.common.triggers import SeveralIteration
    from analytics_zoo_tpu_torch.pipeline.estimator.estimator import (
        _Checkpointer,
    )

    net = make()
    est, _ = ft_fit(net, sets["array"], batch, plan, nb_epoch=1)
    dev_ms = replay_ms(graph_of(est._train_step_for(
        FT_K, est._resolve_plan(plan)))) / FT_K
    out = {}
    rows = [(tier, fs, None) for tier, fs in sets.items()]
    rows += [("array, saves async", sets["array"], "1"),
             ("array, saves inline", sets["array"], "0")]
    for tier, fs, mode in rows:
        est._ckpt = None
        trigger = None
        if mode is not None:
            os.environ["ZOO_ASYNC_CHECKPOINT"] = mode
            est._ckpt = _Checkpointer(os.path.join(tmp,
                                                   f"{tag}_saves{mode}"))
            trigger = SeveralIteration(FT_STEPS)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            est.train(fs, batch_size=batch, nb_epoch=1, plan=plan,
                      checkpoint_trigger=trigger)
            torch.cuda.synchronize()
            host = (time.perf_counter() - t0) * 1e3 / FT_STEPS
        finally:
            os.environ.pop("ZOO_ASYNC_CHECKPOINT", None)
        out[tier] = host
        saves = ""
        if est._ckpt is not None:
            ck = est._ckpt
            saves = (f"; {len(ck.bytes)} saves of {ck.bytes} B, stall "
                     f"{[round(s * 1e3, 2) for s in ck.stall_seconds]} ms, "
                     f"writer {[round(s, 3) for s in ck.write_seconds]} s")
        log(f"fault tolerant {tag} step from {tier}: host clock "
            f"{host:.2f} ms, device {dev_ms:.2f} ms, idle "
            f"{max(0.0, 1 - dev_ms / host):.1%}{saves} ({card_line})")
        if mode is not None:
            shutil.rmtree(est._ckpt.path)
    return out


def ft_bert(tmp, card_line) -> dict:
    """BERT-base's parts (a), (b), (c) and the step times; returns the
    resumed steps' kernel launches."""
    import os
    import shutil

    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.common.triggers import SeveralIteration
    from analytics_zoo_tpu_torch.feature.dataset import FeatureSet
    from analytics_zoo_tpu_torch.parallel import mixed_precision
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import Adam

    gen = np.random.default_rng(SEED + 90)
    n = TRAIN_BATCH * FT_STEPS
    x, y = train_data(n, gen)
    paths = []
    for i, rows in enumerate(np.array_split(np.arange(n), FT_SHARDS)):
        p = os.path.join(tmp, f"bert{i}.npz")
        np.savez(p, y=y[rows], **{f"x{j}": a[rows] for j, a in enumerate(x)})
        paths.append(p)
    calls, fail_at = [], set()

    def loader(path):
        """The shards' four inputs and labels; raises once where asked."""
        calls.append(path)
        if len(calls) in fail_at:
            fail_at.discard(len(calls))
            raise RuntimeError(f"injected loader fault at load {len(calls)}")
        d = np.load(path)
        return {"x": [d[f"x{j}"] for j in range(4)], "y": d["y"]}

    def disk():
        return FeatureSet.from_shards(paths, "DISK_2", loader=loader)

    def fresh():
        init_zoo_context(seed=SEED, device="cuda")
        net = bert_classifier(BERT_BASE["n_block"], DROPOUT, DROPOUT)
        net.build_params()
        net.compile(optimizer=Adam(2e-5),
                    loss="sparse_categorical_crossentropy_from_logits")
        return net

    plan = mixed_precision()
    blocks = BERT_BASE["n_block"]
    per_step = {"flash_attention_fwd": blocks, "flash_attention_bwd": blocks,
                "fused_adam": 1, "softmax_xent_fwd": 1,
                "softmax_xent_bwd": 1, "int8_matmul": 0, "int8_conv": 0,
                "quantize_act": 0}
    every = SeveralIteration
    # (a) uninterrupted, with summaries
    full = fresh()
    reset_counters()  # (a): to the read below
    est_a, sec = ft_fit(full, disk(), TRAIN_BATCH, plan,
                        os.path.join(tmp, "a"), os.path.join(tmp, "tb"),
                        checkpoint_trigger=every(FT_EVERY))
    counted = counters()
    steps = 2 * FT_STEPS
    tb = [(s, v) for s, v, _ in est_a._writers[0].read_scalar("Loss")]
    want_tb = [(i, float(np.float32(v))) for i, v in est_a.loss_log]
    log(f"fault tolerant bert (a): {steps} steps in {sec:.1f} s from "
        f"DISK_2 shards, K={FT_K}; Loss summaries read back equal loss_log "
        f"{tb == want_tb} ({len(tb)}); Throughput "
        f"{[(s, round(v, 1)) for s, v, _ in est_a._writers[0].read_scalar('Throughput')]}"
        f"; launches {counted}")
    if tb != want_tb or [i for i, _ in est_a.loss_log] != list(
            range(1, steps + 1)):
        raise AssertionError("the Loss summaries are not loss_log")
    if counted != {k: v * steps for k, v in per_step.items()}:
        raise AssertionError("the uninterrupted fit did not count its "
                             "kernels")
    ft_saves("bert (a), async", est_a._ckpt, card_line)
    # (b) resumed mid-epoch by a fresh model and estimator; the saves
    # inline
    os.environ["ZOO_ASYNC_CHECKPOINT"] = "0"
    try:
        leg1 = fresh()
        est1, _ = ft_fit(leg1, disk(), TRAIN_BATCH, plan,
                         os.path.join(tmp, "b"),
                         checkpoint_trigger=every(FT_EVERY))
        ft_saves("bert (b) leg 1, inline", est1._ckpt, card_line)
        del leg1, est1
        ft_crash_after_first_mid_epoch_save(os.path.join(tmp, "b"))
        leg2 = fresh()
        reset_counters()  # the resumed steps: to the read below
        est2, _ = ft_fit(leg2, disk(), TRAIN_BATCH, plan,
                         os.path.join(tmp, "b"),
                         checkpoint_trigger=every(FT_EVERY))
        counted = counters()
        ft_saves("bert (b) leg 2, inline", est2._ckpt, card_line)
    finally:
        os.environ.pop("ZOO_ASYNC_CHECKPOINT", None)
    resumed = steps - len(est2.loss_log)
    ft_same("bert (b)", leg2, full, resumed)
    expected = {k: v * (steps - resumed) for k, v in per_step.items()}
    log(f"fault tolerant bert (b): launches over the {steps - resumed} "
        f"resumed steps {counted} (expected {expected})")
    if counted != expected:
        raise AssertionError("the resumed steps did not launch their "
                             "kernels")
    del leg2, est2
    shutil.rmtree(os.path.join(tmp, "b"))
    free_device_memory("after fault tolerant bert (b)")
    # (c) a loader fault mid-epoch 2, retried from LATEST: the fault is
    # set at the second load the set makes in epoch 2
    probe_calls = []

    def probe(path):
        probe_calls.append(path)
        d = np.load(path)
        return {"x": [d[f"x{j}"] for j in range(4)], "y": d["y"]}

    probe_set = FeatureSet.from_shards(paths, "DISK_2", loader=probe)
    probe_set.num_samples  # sizing loads each shard once
    for _ in probe_set.batches(TRAIN_BATCH, seed=SEED, epoch=1):
        pass
    before = len(probe_calls)
    for _ in probe_set.batches(TRAIN_BATCH, seed=SEED, epoch=2):
        pass
    fail_at.add(before + min(2, len(probe_calls) - before))
    calls.clear()
    os.environ["ZOO_FAILURE_RETRY_TIMES"] = "1"
    try:
        retried = fresh()
        est_c, _ = ft_fit(retried, disk(), TRAIN_BATCH, plan,
                          os.path.join(tmp, "c"),
                          checkpoint_trigger=every(FT_EVERY))
    finally:
        os.environ.pop("ZOO_FAILURE_RETRY_TIMES", None)
    log(f"fault tolerant bert (c): the loader raised at load "
        f"{before + min(2, len(probe_calls) - before)} of {len(calls)}; "
        f"pending faults {sorted(fail_at)}")
    if fail_at:
        raise AssertionError("the injected fault did not happen")
    ft_same("bert (c)", retried, full, 0)
    ft_saves("bert (c), async", est_c._ckpt, card_line)
    del retried, est_c
    shutil.rmtree(os.path.join(tmp, "c"))
    shutil.rmtree(os.path.join(tmp, "a"))
    free_device_memory("after fault tolerant bert (c)")
    times = ft_step_times(
        "bert", fresh, {"array": FeatureSet.of(x, y), "DISK_2": disk()},
        TRAIN_BATCH, plan, tmp, card_line)
    del full, est_a
    free_device_memory("after fault tolerant bert")
    return {"launches": counted, "times": times}


class FaultOnce:
    """A feature set that raises a RuntimeError once, at ``(epoch,
    batch)``, and otherwise yields ``base``'s batches."""

    def __init__(self, base, epoch: int, batch: int):
        self.base, self.at, self.raised = base, (epoch, batch), False

    @property
    def num_samples(self):
        return self.base.num_samples

    def steps_per_epoch(self, batch_size, drop_last=True):
        return self.base.steps_per_epoch(batch_size, drop_last)

    def batches(self, batch_size, **kw):
        b = kw.get("start_batch", 0)
        for batch in self.base.batches(batch_size, **kw):
            if (kw.get("epoch"), b) == self.at and not self.raised:
                self.raised = True
                raise RuntimeError("injected fault")
            b += 1
            yield batch


def ft_resnet(tmp, card_line) -> dict:
    """ResNet-50's parts: (a) uninterrupted, saving every FT_EVERY steps
    and at each epoch boundary; (b) resumed mid-epoch; (c) a fault in
    epoch 2 retried; ``load_checkpoint`` of (a)'s last snapshot into a
    fresh model evaluates as the trained model; the step times from the
    PMEM set against the resident one."""
    import os
    import shutil

    import torch

    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.common.triggers import (
        EveryEpoch,
        SeveralIteration,
    )
    from analytics_zoo_tpu_torch.feature.dataset import FeatureSet
    from analytics_zoo_tpu_torch.models import ResNet
    from analytics_zoo_tpu_torch.parallel import mixed_precision

    gen = np.random.default_rng(SEED + 91)
    n = RESNET_BATCH * FT_STEPS
    x = gen.standard_normal((n,) + RESNET_SHAPE, dtype=np.float32)
    y = gen.integers(0, RESNET_CLASSES, n).astype(np.int32)
    pmem = FeatureSet.array(x, y, memory_type="PMEM", spool_dir=tmp)
    log(f"fault tolerant resnet50: {n} images ({x.nbytes} B) spilled to "
        f"{pmem._spool.name}, memory-mapped: {type(pmem.xs[0]).__name__}")

    def fresh():
        init_zoo_context(seed=SEED, device="cuda")
        net = ResNet.image_net(50, classes=RESNET_CLASSES,
                               input_shape=RESNET_SHAPE)
        net.build_params()
        net.compile(optimizer=ResNet.imagenet_optimizer(
            batch_size=RESNET_BATCH, steps_per_epoch=FT_STEPS),
            loss="sparse_categorical_crossentropy",
            metrics=["accuracy", "top5_accuracy"])
        return net

    plan = mixed_precision()
    steps = 2 * FT_STEPS
    full = fresh()
    est_a, sec = ft_fit(full, pmem, RESNET_BATCH, plan,
                        os.path.join(tmp, "ra"),
                        checkpoint_trigger=SeveralIteration(FT_EVERY)
                        | EveryEpoch())
    log(f"fault tolerant resnet50 (a): {steps} steps in {sec:.1f} s from "
        f"the PMEM set, K={FT_K}; moving statistics, momentum and the "
        f"step count {int(est_a._opt_state.count)} kept")
    ft_saves("resnet50 (a), async", est_a._ckpt, card_line)
    leg1 = fresh()
    ft_fit(leg1, pmem, RESNET_BATCH, plan, os.path.join(tmp, "rb"),
           checkpoint_trigger=SeveralIteration(FT_EVERY) | EveryEpoch())
    del leg1
    ft_crash_after_first_mid_epoch_save(os.path.join(tmp, "rb"))
    leg2 = fresh()
    est2, _ = ft_fit(leg2, pmem, RESNET_BATCH, plan,
                     os.path.join(tmp, "rb"),
                     checkpoint_trigger=SeveralIteration(FT_EVERY)
                     | EveryEpoch())
    ft_same("resnet50 (b)", leg2, full, steps - len(est2.loss_log))
    del leg2, est2
    shutil.rmtree(os.path.join(tmp, "rb"))
    os.environ["ZOO_FAILURE_RETRY_TIMES"] = "1"
    try:
        retried = fresh()
        faulty = FaultOnce(pmem, epoch=2, batch=3)
        ft_fit(retried, faulty, RESNET_BATCH, plan, os.path.join(tmp, "rc"),
               checkpoint_trigger=SeveralIteration(FT_EVERY) | EveryEpoch())
    finally:
        os.environ.pop("ZOO_FAILURE_RETRY_TIMES", None)
    if not faulty.raised:
        raise AssertionError("the injected fault did not happen")
    ft_same("resnet50 (c)", retried, full, 0)
    del retried
    shutil.rmtree(os.path.join(tmp, "rc"))
    free_device_memory("after fault tolerant resnet50 (c)")
    loaded = fresh()
    loaded.load_checkpoint(os.path.join(tmp, "ra"))
    want = full.evaluate(x[:2 * RESNET_BATCH], y[:2 * RESNET_BATCH],
                         batch_size=RESNET_BATCH)
    got = loaded.evaluate(x[:2 * RESNET_BATCH], y[:2 * RESNET_BATCH],
                          batch_size=RESNET_BATCH)
    log(f"fault tolerant resnet50: load_checkpoint into a fresh model "
        f"evaluates {got}, the trained model {want}")
    if got != want:
        raise AssertionError("load_checkpoint does not reproduce evaluate")
    del loaded, full, est_a
    shutil.rmtree(os.path.join(tmp, "ra"))
    free_device_memory("after fault tolerant resnet50 (a)")
    times = ft_step_times(
        "resnet50", fresh, {"array": FeatureSet.of(x, y), "PMEM": pmem},
        RESNET_BATCH, plan, tmp, card_line)
    torch.cuda.synchronize()
    pmem._spool.cleanup()
    free_device_memory("after fault tolerant resnet50")
    return times


def fault_tolerant_phase(card_line: str) -> dict:
    """The ``fault_tolerant_fit`` phase: BERT-base, then ResNet-50, under
    ``ZOO_STEPS_PER_DISPATCH=FT_K``, in one temporary directory that is
    removed at the end.  Returns the BERT part's resumed launches."""
    import os
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="zoo_fault_tolerant_")
    usage = shutil.disk_usage(tmp)
    log(f"fault tolerant: working in {tmp} ({usage.free / 2**30:.1f} GiB "
        f"free of {usage.total / 2**30:.1f})")
    saved_k = os.environ.get("ZOO_STEPS_PER_DISPATCH")
    os.environ["ZOO_STEPS_PER_DISPATCH"] = str(FT_K)
    try:
        bert = ft_bert(tmp, card_line)
        ft_resnet(tmp, card_line)
    finally:
        if saved_k is None:
            os.environ.pop("ZOO_STEPS_PER_DISPATCH", None)
        else:
            os.environ["ZOO_STEPS_PER_DISPATCH"] = saved_k
        shutil.rmtree(tmp, ignore_errors=True)
    return bert["launches"]


# ---------------------------------------------------------------------------
# The sequence path: the TextClassifier at news20's width (the reference's
# defaults: sequence 500, encoder 256, vocabulary 20000; 20 classes, GloVe-200
# tokens), the recommenders at MovieLens-1M's counts, and a GPT-style
# TransformerLayer at Switch-Base-8's widths (d_model 768, d_ff 3072, 12
# heads, 8 experts; top-2 routing, the JAX package's default)
# ---------------------------------------------------------------------------
TEXT = dict(class_num=20, token_length=200, sequence_length=500,
            encoder="lstm", encoder_output_dim=256, vocab_size=20000)
TEXT_BATCH, TEXT_STEPS, TEXT_OTHER_STEPS = 128, 5, 3
TEXT_REQUESTS = (1, 8, 32)
ML1M_USERS, ML1M_ITEMS, ML1M_RATINGS = 6040, 3952, 5
REC_BATCH, REC_STEPS = 256, 5
MOE = dict(vocab=40990, seq_len=512, n_block=12, n_head=12,
           hidden_size=768, moe_experts=8, moe_top_k=2,
           moe_capacity_factor=1.25)
MOE_BATCH, MOE_STEPS = 8, 3
MOE_POLICIES = (None, "full", "dots", "attn")
SEQ_CPU_TOL = 1e-3


def seq_flops(net) -> tuple[float, float]:
    """(forward, training) FLOPs of one record through ``net``'s recurrent
    (a Bidirectional's two), convolution and Dense layers: 2 x the
    multiply-adds; training three times the forward (the table's gradient
    needs every input gradient)."""
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        Bidirectional,
    )
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.recurrent import (
        _RNNBase,
    )

    def rnn(layer):
        t, f = layer._build_shape
        units = layer.output_dim * layer.units_per_gate
        return 2.0 * t * (f + layer.output_dim) * units

    fwd = conv_flops(net)[0]
    for layer in net.layers:
        if isinstance(layer, _RNNBase):
            fwd += rnn(layer)
        elif isinstance(layer, Bidirectional):
            fwd += rnn(layer.forward_layer) + rnn(layer.backward_layer)
    return fwd, 3 * fwd


def moe_flops(batch: int, remat=None) -> tuple[float, float]:
    """(forward, training) FLOPs of one MoE transformer step at ``batch``:
    the projections, causal attention (half the square), the router, the
    dense one-hot dispatch and combine einsums over (E, C) slots, and the
    expert products over E x batch x C slots, 2 x the multiply-adds;
    training three times the forward, plus one forward of the blocks
    recomputed under remat."""
    import math

    d, m, e, k = (MOE["hidden_size"], 4 * MOE["hidden_size"],
                  MOE["moe_experts"], MOE["moe_top_k"])
    s = MOE["seq_len"]
    t = batch * s
    cap = min(s, math.ceil(MOE["moe_capacity_factor"] * k * s / e))
    block = (2.0 * t * d * 4 * d            # qkv and the output projection
             + 2.0 * batch * s * s * d      # QK^T and PV, causal
             + 2.0 * t * d * e              # router
             + 2 * 2.0 * t * e * cap * d    # dispatch and combine
             + 2 * 2.0 * e * batch * cap * d * m)  # the experts
    fwd = MOE["n_block"] * block + 2.0 * batch * d * 2
    return fwd, 3 * fwd + (MOE["n_block"] * block if remat else 0.0)


def device_kernels(graph) -> tuple[int, list]:
    """The CUDA kernels one replay of ``graph`` runs, from a torch.profiler
    trace (memory copies and sets left out; 0 where the trace shows no
    device activity), and the five kernel names with the most device time
    as (name, calls, ms)."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    calls, us = collections.Counter(), collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and "Memcpy" not in e.name and "Memset" not in e.name:
            calls[e.name] += 1
            us[e.name] += e.device_time_total
    top = [(name[:60], calls[name], us[name] / 1e3)
           for name, _ in us.most_common(5)]
    return sum(calls.values()), top


def seq_step(tag, net, plan, x, y, batch, steps, flops, peak, card_line,
             timesteps=None, nbytes=0.0) -> dict:
    """One more epoch of ``fit`` (every step a replay): its launch counts
    (returned), the host clock a step, one replay's device time, the idle
    share, the kernels a replay runs, records/s and the step's bound (the
    larger of its FLOPs at ``peak`` and ``nbytes`` at the memory rate);
    with ``timesteps`` also the device time per timestep."""
    import torch

    reset_counters()  # this epoch: from here to the read below
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.fit(x, y, batch_size=batch, nb_epoch=1, plan=plan)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    launches = counters()  # end of this epoch
    est = net._estimator
    graph = graph_of(est._train_step_for(1, est._resolve_plan(plan)))
    dev_ms = replay_ms(graph)
    kernels, top = device_kernels(graph)
    bound_ms = max(batch * flops[1] / peak, nbytes / PEAK_BYTES) * 1e3
    per_t = (f", {dev_ms * 1e3 / timesteps:.1f} us of device time a "
             f"timestep ({timesteps})" if timesteps else "")
    by_bytes = (f", {nbytes / 1e6:.1f} MB at {PEAK_BYTES / 1e12:.2f} TB/s "
                f"{nbytes / PEAK_BYTES * 1e3:.4f} ms" if nbytes else "")
    log(f"{tag} step (batch {batch}, replayed): host clock {host_ms:.2f} "
        f"ms, device {dev_ms:.2f} ms, idle "
        f"{max(0.0, 1 - dev_ms / host_ms):.1%}{per_t}; "
        f"{kernels if kernels else 'not measured'} kernels a step; "
        f"{batch / host_ms * 1e3:.1f} records/s; bound {bound_ms:.4f} ms "
        f"({batch} x {flops[1] / 1e9:.3f} GFLOP at {peak / 1e12:.0f} "
        f"TFLOP/s {batch * flops[1] / peak * 1e3:.4f} ms{by_bytes}; device "
        f"time {bound_ms / dev_ms:.1%} of it); launches {launches}, "
        f"{ {k: v / steps for k, v in launches.items() if v} } a step "
        f"({card_line})")
    log(f"{tag} step's largest kernels (name, calls, ms of one replay): "
        + "; ".join(f"{n} x{c} {ms:.2f}" for n, c, ms in top))
    return {"launches": launches, "host_ms": host_ms, "dev_ms": dev_ms}


def add_launches(total: dict, launches: dict) -> dict:
    return {k: total.get(k, 0) + v for k, v in launches.items()}


def expect_launches(tag, launches, **expected) -> None:
    want = dict({k: 0 for k in launches}, **expected)
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches}, expected {want}")


def falling_loss(tag, net, optimizer, loss, x, y, batch, epochs) -> None:
    """``epochs`` one-step fits on one batch with a fresh optimizer: the
    loss falls."""
    net.compile(optimizer=optimizer, loss=loss)
    net.fit(x[:batch] if not isinstance(x, list) else
            [a[:batch] for a in x], y[:batch] if not isinstance(y, list)
            else [a[:batch] for a in y], batch_size=batch, nb_epoch=epochs)
    rep = [v for _, v in net._estimator.loss_log]
    log(f"{tag} on a fixed batch: " + ", ".join(f"{v:.4f}" for v in rep))
    if not (np.all(np.isfinite(rep)) and min(rep[-2:]) < rep[0]):
        raise AssertionError(f"{tag}: the loss did not fall: {rep}")


def against_the_cpu(tag, make, loss, batch, gen_seed, drop_off=()) -> None:
    """Step 1's loss (``loss``, by name) and gradients of ``make()`` (a
    net) on the card against the same weights and batch on the CPU: the
    loss within
    SEQ_CPU_TOL relative, each gradient leaf within SEQ_CPU_TOL of its
    largest value.  Layers of type ``drop_off`` get dropout 0 (their masks
    come from the device's generator)."""
    import torch

    from analytics_zoo_tpu_torch.common.engine import (
        get_zoo_context,
        step_generator,
    )
    from analytics_zoo_tpu_torch.common.utils import tree_leaves
    from analytics_zoo_tpu_torch.pipeline.api.keras.objectives import (
        get_loss,
    )
    from analytics_zoo_tpu_torch.pipeline.estimator import Estimator
    from analytics_zoo_tpu_torch.pipeline.estimator.estimator import (
        _to_device,
    )

    results = []
    for device in (get_zoo_context().device, "cpu"):
        net = make()
        for layer in net.layers:
            if type(layer).__name__ in drop_off:
                layer.p = 0.0
        net.build_params(rng=torch.Generator().manual_seed(gen_seed),
                         device=device)
        est = Estimator(net, loss=get_loss(loss))
        value, grads, _ = est.loss_and_grads(
            net.params, net.state, _to_device(batch, net.device),
            step_generator(SEED, 0, net.device))
        results.append((value.item(),
                        [g.cpu() for g in tree_leaves(grads)]))
    (g_loss, g_grads), (c_loss, c_grads) = results
    loss_err = abs(g_loss - c_loss) / abs(c_loss)
    grad_err = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                   .item() for a, b in zip(g_grads, c_grads))
    log(f"{tag} step 1 vs CPU: loss {g_loss:.6f} vs {c_loss:.6f} (rel "
        f"{loss_err:.2e}), grads max rel to leaf max {grad_err:.2e} (tol "
        f"{SEQ_CPU_TOL:g})")
    if not (loss_err <= SEQ_CPU_TOL and grad_err <= SEQ_CPU_TOL):
        raise AssertionError(f"{tag}: the card's step disagrees with the "
                             "CPU's")


def text_classifier_phase(card_line: str) -> dict:
    """The slice's main path: the TextClassifier (LSTM encoder) at news20
    width through ``compile("adam", ...)``, ``fit`` at batch 128 in f32
    and bf16 (each captured fit bit for bit ``train_step`` called
    eagerly, twice; a replayed epoch's times and launches: one Adam a
    step), ``evaluate`` captured against uncaptured, a loss that falls on
    a fixed batch, step 1 against the CPU (8 records, the head's dropout
    at 0), requests of 1, 8 and 32 records in f32 and bf16; then the GRU
    and CNN encoders (3 steps, one 8-record request each) and a frozen
    pretrained table (one 8-record request, the table in state).  Returns
    the path's launch counts."""
    import torch

    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.models import TextClassifier
    from analytics_zoo_tpu_torch.parallel import mixed_precision

    def build(**kw):
        init_zoo_context(seed=SEED, device="cuda")
        tc = TextClassifier(**dict(TEXT, **kw))
        tc.model.build_params()
        tc.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
                   metrics=["accuracy"])
        return tc

    gen = np.random.default_rng(SEED + 80)
    n, t = TEXT_BATCH * TEXT_STEPS, TEXT["sequence_length"]
    x = gen.integers(0, TEXT["vocab_size"], (n, t)).astype(np.int32)
    y = gen.integers(0, TEXT["class_num"], n).astype(np.int32)
    total, first = {}, {}
    for tag, plan, peak in (("f32", None, PEAK_FLOPS["float32"]),
                            ("bf16", mixed_precision(),
                             PEAK_FLOPS["bfloat16"])):
        tc = build()
        flops = seq_flops(tc.model)
        losses = captured_fit_check(f"text_classifier {tag}", tc.model, plan,
                                    x, y, TEXT_STEPS, TEXT_BATCH)
        first[tag] = losses[0]
        if not np.all(np.isfinite(losses)):
            raise AssertionError(f"text_classifier {tag} losses {losses}")
        step = seq_step(f"text_classifier {tag}", tc.model, plan, x, y,
                        TEXT_BATCH, TEXT_STEPS, flops, peak, card_line,
                        timesteps=t)
        expect_launches(f"text_classifier {tag}", step["launches"],
                        fused_adam=TEXT_STEPS)
        total = add_launches(total, step["launches"])
        if tag == "f32":
            captured_eval_check("text_classifier", tc.model, x, y,
                                TEXT_BATCH)
            reqs = {r: x[:r] for r in TEXT_REQUESTS}
            launches, _ = serve_requests("text_classifier", tc.model, reqs,
                                         flops, card_line, unit="records")
            total = add_launches(total, launches)
            falling_loss("text_classifier", tc.model, "adam",
                         "sparse_categorical_crossentropy", x, y,
                         TEXT_BATCH, 5)
        tc.model._estimator = None
        del tc
        free_device_memory(f"after text_classifier {tag}")
    gap = abs(first["bf16"] - first["f32"]) / abs(first["f32"])
    log(f"text_classifier step 1: bf16 {first['bf16']:.6f} vs f32 "
        f"{first['f32']:.6f} (rel {gap:.2e}, tol 5%)")
    if gap > 0.05:
        raise AssertionError("text_classifier bf16 step 1 is not within 5% "
                             "of f32")
    against_the_cpu("text_classifier", lambda: TextClassifier(**TEXT).model,
                    "sparse_categorical_crossentropy",
                    {"x": x[:8], "y": y[:8]}, SEED, drop_off=("Dropout",))
    for encoder in ("gru", "cnn"):
        tc = build(encoder=encoder)
        m = TEXT_BATCH * TEXT_OTHER_STEPS
        tc.fit(x[:m], y[:m], batch_size=TEXT_BATCH, nb_epoch=1)
        flops = seq_flops(tc.model)
        step = seq_step(f"text_classifier {encoder}", tc.model, None, x[:m],
                        y[:m], TEXT_BATCH, TEXT_OTHER_STEPS, flops,
                        PEAK_FLOPS["float32"], card_line,
                        timesteps=t if encoder == "gru" else None)
        expect_launches(f"text_classifier {encoder}", step["launches"],
                        fused_adam=TEXT_OTHER_STEPS)
        launches, _ = serve_requests(f"text_classifier {encoder}", tc.model,
                                     {8: x[:8]}, flops, card_line,
                                     precisions=("f32",), unit="records")
        total = add_launches(add_launches(total, step["launches"]),
                             launches)
        del tc
        free_device_memory(f"after text_classifier {encoder}")
    table = gen.standard_normal((TEXT["vocab_size"], TEXT["token_length"]),
                                dtype=np.float32)
    tc = build(embedding_weights=table, train_embed=False)
    held = tc.model.state["embedding"]["embeddings"]
    if "embedding" in tc.model.params or not torch.equal(
            held.cpu(), torch.from_numpy(table)):
        raise AssertionError("the frozen table is not the model's state")
    launches, _ = serve_requests("text_classifier frozen table", tc.model,
                                 {8: x[:8]}, seq_flops(tc.model), card_line,
                                 precisions=("f32",), unit="records")
    del tc
    free_device_memory("after text_classifier")
    return add_launches(total, launches)


def recommenders_phase(card_line: str) -> dict:
    """NeuralCF at MovieLens-1M's counts (6,040 users, 3,952 item ids,
    ratings as 5 classes, the JAX package's default widths) through
    ``fit`` at batch 256 (captured, bit for bit the eager steps; a replayed
    epoch's times and launches), ``evaluate`` captured against uncaptured,
    a loss that falls on a fixed batch, step 1 against the CPU, and
    ``recommend_for_user`` over every item (rows finite, summing to 1; the
    ranking the CPU's); WideAndDeep with the repo example's columns the
    same way for 5 steps and one 8-row request.  Returns the launch
    counts."""
    import torch

    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.common.utils import tree_map
    from analytics_zoo_tpu_torch.models import (
        ColumnFeatureInfo,
        NeuralCF,
        WideAndDeep,
        to_wide_deep_features,
    )

    gen = np.random.default_rng(SEED + 90)
    n = REC_BATCH * REC_STEPS
    x = [gen.integers(0, ML1M_USERS, n).astype(np.int32),
         gen.integers(0, ML1M_ITEMS, n).astype(np.int32)]
    y = gen.integers(0, ML1M_RATINGS, n).astype(np.int32)
    loss = "sparse_categorical_crossentropy"

    def ncf():
        return NeuralCF(ML1M_USERS, ML1M_ITEMS, class_num=ML1M_RATINGS)

    init_zoo_context(seed=SEED, device="cuda")
    model = ncf()
    model.model.build_params()
    model.compile(optimizer="adam", loss=loss, metrics=["accuracy"])
    flops = conv_flops(model.model)
    captured_fit_check("neural_cf", model.model, None, x, y, REC_STEPS,
                       REC_BATCH)
    step = seq_step("neural_cf", model.model, None, x, y, REC_BATCH,
                    REC_STEPS, flops, PEAK_FLOPS["float32"], card_line)
    expect_launches("neural_cf", step["launches"], fused_adam=REC_STEPS)
    total = dict(step["launches"])
    captured_eval_check("neural_cf", model.model, x, y, REC_BATCH)
    items = np.arange(ML1M_ITEMS)
    pairs = [np.full_like(items, 7), items]  # recommend_for_user's inputs
    model.predict(pairs, batch_size=1024)  # captures its batch shapes
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recs = model.recommend_for_user(7, items, max_items=10)
    ms = (time.perf_counter() - t0) * 1e3
    total = add_launches(total, counters())
    probs = model.predict(pairs, batch_size=1024)
    cpu = ncf()
    cpu.model.build_params(device="cpu")
    cpu.model.params = tree_map(lambda a: a.cpu(), model.model.params)
    scores = cpu.predict_user_item_pair(np.stack(pairs, axis=1))
    top = [i for i, _ in recs]
    sums = float(np.abs(probs.sum(-1) - 1).max())
    log(f"neural_cf recommend_for_user over {ML1M_ITEMS} items: {ms:.2f} ms "
        f"({card_line}); top 10 {top}, the CPU's "
        f"{list(np.argsort(-scores)[:10])}; rows sum to 1 within "
        f"{sums:.2e}")
    # the card's top 10 are the CPU's best ten up to rounding
    if not (np.allclose([v for _, v in recs], scores[top], rtol=1e-5,
                        atol=1e-7)
            and min(v for _, v in recs) >= np.sort(scores)[-10] - 1e-6
            and np.isfinite(probs).all() and sums <= 1e-4):
        raise AssertionError("neural_cf recommendations are wrong")
    falling_loss("neural_cf", model.model, "adam", loss, x, y, REC_BATCH, 5)
    against_the_cpu("neural_cf", lambda: ncf().model, loss,
                    {"x": [a[:REC_BATCH] for a in x], "y": y[:REC_BATCH]},
                    SEED)
    del model, cpu

    info = ColumnFeatureInfo(
        wide_base_cols=["user", "item"], wide_base_dims=[40, 60],
        wide_cross_cols=["genre"], wide_cross_dims=[4],
        indicator_cols=["genre"], indicator_dims=[4],
        embed_cols=["user", "item"], embed_in_dims=[40, 60],
        embed_out_dims=[8, 8], continuous_cols=["age"])
    rows = {"user": gen.integers(0, 40, n), "item": gen.integers(0, 60, n),
            "genre": gen.integers(0, 4, n),
            "age": gen.standard_normal(n).astype(np.float32)}
    feats = to_wide_deep_features(rows, info)
    labels = gen.integers(0, 2, n).astype(np.int32)
    init_zoo_context(seed=SEED, device="cuda")
    wnd = WideAndDeep("wide_n_deep", 2, info)
    wnd.model.build_params()
    wnd.compile(optimizer="adam", loss=loss, metrics=["accuracy"])
    flops = conv_flops(wnd.model)
    captured_fit_check("wide_and_deep", wnd.model, None, feats, labels,
                       REC_STEPS, REC_BATCH)
    step = seq_step("wide_and_deep", wnd.model, None, feats, labels,
                    REC_BATCH, REC_STEPS, flops, PEAK_FLOPS["float32"],
                    card_line)
    expect_launches("wide_and_deep", step["launches"], fused_adam=REC_STEPS)
    launches, _ = serve_requests("wide_and_deep", wnd.model,
                                 {8: [f[:8] for f in feats]}, flops,
                                 card_line, precisions=("f32",),
                                 unit="rows")
    del wnd
    free_device_memory("after the recommenders")
    return add_launches(add_launches(total, step["launches"]), launches)


def moe_transformer(n_block=MOE["n_block"], **kw):
    """TransformerLayer (MOE's widths) -> GlobalAveragePooling1D ->
    Dense(2) logits, as a graph Model over token ids."""
    from analytics_zoo_tpu_torch.pipeline.api.keras import Input, Model
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        Dense,
        GlobalAveragePooling1D,
        TransformerLayer,
    )

    tok = Input((MOE["seq_len"],))
    h = TransformerLayer(**dict(MOE, n_block=n_block, **kw))(tok)
    return Model(tok, Dense(2)(GlobalAveragePooling1D()(h)))


def moe_transformer_phase(card_line: str) -> dict:
    """The MoE transformer (about 513 M parameters, dropout 0.1) through
    ``compile(Adam(2e-5), "sparse_categorical_crossentropy_from_logits")``
    and ``fit`` at batch 8 x 512 in f32 and bf16 (each captured fit bit for
    bit ``train_step`` called eagerly, twice; a replayed epoch's times and
    launches: 12 + 12 flash, 1 Adam, 1 + 1 cross-entropy a step), bf16's
    step 1 within 5% of f32's, the state's aux loss and drop fraction;
    then one captured and one replayed step under each remat policy from
    the same weights, bit for bit ``remat=None``'s (losses and parameters),
    with each policy's peak memory, device time and flash forwards (the
    recompute adds forwards); a loss that falls on a fixed batch; step 1
    at 2 blocks (batch 2, hidden and embedding dropout 0) against the CPU.
    Returns the launch counts."""
    import torch

    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.common.engine import step_generator
    from analytics_zoo_tpu_torch.common.utils import tree_leaves, tree_map
    from analytics_zoo_tpu_torch.parallel import mixed_precision
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import Adam
    from analytics_zoo_tpu_torch.pipeline.estimator.estimator import (
        _to_device,
    )

    loss = "sparse_categorical_crossentropy_from_logits"
    blocks = MOE["n_block"]
    gen = np.random.default_rng(SEED + 100)
    n = MOE_BATCH * MOE_STEPS
    x = gen.integers(0, MOE["vocab"], (n, MOE["seq_len"])).astype(np.int32)
    y = gen.integers(0, 2, n).astype(np.int32)
    t0 = time.perf_counter()
    init_zoo_context(seed=SEED, device="cuda")
    net = moe_transformer()
    net.build_params()
    weights = (tree_map(torch.clone, net.params),
               tree_map(torch.clone, net.state))
    count = sum(t.numel() for t in tree_leaves(net.params))
    log(f"moe_transformer: {count} parameters built in "
        f"{time.perf_counter() - t0:.1f} s")
    del net

    def model(remat=None):
        ctx = init_zoo_context(seed=SEED, device="cuda")
        m = moe_transformer(remat=remat)
        m.device = ctx.device
        m.params = tree_map(torch.clone, weights[0])
        m.state = tree_map(torch.clone, weights[1])
        m.compile(optimizer=Adam(2e-5), loss=loss, metrics=["accuracy"])
        return m

    def moe_state(m):
        (st,) = [v for v in m.state.values() if "moe_aux_loss" in v]
        return {k: float(v) for k, v in st.items()}

    per_step = dict(flash_attention_fwd=blocks, flash_attention_bwd=blocks,
                    fused_adam=1, softmax_xent_fwd=1, softmax_xent_bwd=1)
    total, first = {}, {}
    for tag, plan, peak in (("f32", None, PEAK_FLOPS["float32"]),
                            ("bf16", mixed_precision(),
                             PEAK_FLOPS["bfloat16"])):
        m = model()
        losses = captured_fit_check(f"moe_transformer {tag}", m, plan, x, y,
                                    MOE_STEPS, MOE_BATCH)
        first[tag] = losses[0]
        step = seq_step(f"moe_transformer {tag}", m, plan, x, y, MOE_BATCH,
                        MOE_STEPS, (0.0, moe_flops(MOE_BATCH)[1]
                                    / MOE_BATCH), peak, card_line)
        expect_launches(f"moe_transformer {tag}", step["launches"],
                        **{k: v * MOE_STEPS for k, v in per_step.items()})
        total = add_launches(total, step["launches"])
        st = moe_state(m)
        log(f"moe_transformer {tag} state after the steps: {st}")
        if not (0.9 <= st["moe_aux_loss"] <= MOE["moe_experts"]
                and 0.0 <= st["moe_drop_fraction"] < 1.0
                and np.all(np.isfinite(losses))):
            raise AssertionError(f"moe_transformer {tag}: state {st}, "
                                 f"losses {losses}")
        m._estimator = None
        del m
        free_device_memory(f"after moe_transformer {tag}")
    gap = abs(first["bf16"] - first["f32"]) / abs(first["f32"])
    log(f"moe_transformer step 1: bf16 {first['bf16']:.6f} vs f32 "
        f"{first['f32']:.6f} (rel {gap:.2e}, tol 5%)")
    if gap > 0.05:
        raise AssertionError("moe_transformer bf16 step 1 is not within 5% "
                             "of f32")

    # per policy: one eager forward and backward's peak above what is
    # held, then one captured and one replayed step
    want = None
    for policy in MOE_POLICIES:
        m = model(remat=policy)
        batch = _to_device({"x": x[:MOE_BATCH], "y": y[:MOE_BATCH]},
                           m.device)
        est = m._make_estimator()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        value, grads, _ = est.loss_and_grads(
            m.params, m.state, batch, step_generator(SEED, 0, m.device))
        torch.cuda.synchronize()
        fb_bytes = torch.cuda.max_memory_allocated() - held
        del value, grads, est
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()  # this policy's two steps: to the read below
        m.fit(x[:2 * MOE_BATCH], y[:2 * MOE_BATCH], batch_size=MOE_BATCH,
              nb_epoch=1)
        torch.cuda.synchronize()
        launches = counters()  # end of this policy's steps
        peak_bytes = torch.cuda.max_memory_allocated()
        est = m._estimator
        dev_ms = replay_ms(graph_of(est._train_step_for(
            1, est._resolve_plan())))
        got = ([v for _, v in est.loss_log],
               [t.cpu() for t in tree_leaves(m.params)])
        log(f"moe_transformer remat={policy}: an eager forward and "
            f"backward peak {fb_bytes} B above the {held} B held; the fit's "
            f"peak allocated {peak_bytes} B, device {dev_ms:.2f} ms a step, "
            f"launches {launches} ({card_line})")
        fwd = blocks * (2 if policy else 1)
        expect_launches(f"moe_transformer remat={policy}", launches,
                        **dict({k: 2 * v for k, v in per_step.items()},
                               flash_attention_fwd=2 * fwd))
        total = add_launches(total, launches)
        if want is None:
            want = got
        else:
            same = got[0] == want[0] and all(
                torch.equal(a, b) for a, b in zip(got[1], want[1]))
            log(f"moe_transformer remat={policy} against remat=None: losses "
                f"{got[0]} / {want[0]}, parameters equal bit for bit: "
                f"{same}")
            if not same:
                raise AssertionError(f"remat={policy} is not remat=None")
        m._estimator = None
        del m, est
        free_device_memory(f"after remat={policy}")

    m = model()
    falling_loss("moe_transformer", m, Adam(5e-5), loss, x, y, MOE_BATCH, 6)
    del m
    free_device_memory("after the moe_transformer fixed batch")
    against_the_cpu(
        "moe_transformer (2 blocks, batch 2, attention dropout 0.1)",
        lambda: moe_transformer(n_block=2, hidden_drop=0.0,
                                embedding_drop=0.0),
        loss, {"x": x[:2], "y": y[:2]}, SEED)
    return total


# ---------------------------------------------------------------------------
# The text-matching path: KNRM at the JAX package's defaults (vocabulary
# 20,000, width 300, 21 kernels) and the upstream qa_ranker example's
# lengths (question 10, answer 40; batch 200), fed from CSV files through
# TextSet; the autograd examples and Parameter graphs; the tfpark text
# taggers at their defaults (sequence 64, words of 12 characters).
# ---------------------------------------------------------------------------
KNRM_ARGS = dict(text1_length=10, text2_length=40, vocab_size=20000,
                 embed_size=300, kernel_num=21, target_mode="ranking")
KNRM_BATCH, KNRM_STEPS = 200, 5
# one positive answer among KNRM_PER_Q a question: (KNRM_PER_Q - 1)
# (positive, negative) pairs, two rows each
KNRM_PER_Q = 5
KNRM_TRAIN_Q = KNRM_BATCH * KNRM_STEPS // (2 * (KNRM_PER_Q - 1))
KNRM_HELD_Q = 40
KNRM_REQUESTS = (1, 8, 32)
AG_BATCH, AG_STEPS = 32, 5
TAG_BATCH, TAG_STEPS, TAG_REQUEST = 32, 3, 8
# the taggers' defaults: sequence 64, words of 12 characters
TAG_SEQ, TAG_WLEN, TAG_WORDS, TAG_CHARS = 64, 12, 20000, 100
TAGGERS = {
    # CoNLL-2003's BIO tag set
    "ner": ("NER", dict(num_entities=9, word_vocab_size=TAG_WORDS,
                        char_vocab_size=TAG_CHARS)),
    # the Penn Treebank's 45 POS tags, CoNLL-2000's 23 chunk tags
    "sequence_tagger": ("SequenceTagger", dict(
        num_pos_labels=45, num_chunk_labels=23, word_vocab_size=TAG_WORDS)),
    # SNIPS's 7 intents, 9 entity tags
    "intent_entity": ("IntentEntity", dict(
        num_intents=7, num_entities=9, word_vocab_size=TAG_WORDS,
        char_vocab_size=TAG_CHARS)),
}


def adam_bytes(net) -> float:
    """The bytes one Adam step must move over ``net``'s f32 parameters:
    the parameter, its gradient and both moments read, the parameter and
    both moments written (7 x 4 bytes a parameter)."""
    from analytics_zoo_tpu_torch.common.utils import tree_leaves

    return 28.0 * sum(t.numel() for t in tree_leaves(net.params))


def qa_corpus(tmp, gen):
    """Writes ``questions.csv``, ``answers.csv`` (uri,text) and
    ``relations.csv`` (id1,id2,label with a header) shaped as
    ``examples/qaranker/train.py``'s ``load_relations``: each question has
    one positive answer, which repeats its key token and three of its
    words, among KNRM_PER_Q; the filler words cycle through seeded
    permutations of 20,000 words, so the vocabulary reaches 20,000.
    Returns the three paths."""
    import os

    n_q = KNRM_TRAIN_Q + KNRM_HELD_Q
    vocab = KNRM_ARGS["vocab_size"]
    stream = np.concatenate([gen.permutation(vocab) for _ in range(2)])
    pos = [0]

    def words(k):
        out = stream[pos[0]:pos[0] + k]
        pos[0] += k
        return [f"w{i}" for i in out]

    qs, ans, rels = [], [], []
    q_len, a_len = KNRM_ARGS["text1_length"], KNRM_ARGS["text2_length"]
    for qi in range(n_q):
        body = words(q_len - 3)
        qs.append((f"q{qi}", " ".join(["what", "is", f"key{qi}"] + body)))
        for ai in range(KNRM_PER_Q):
            uri = f"a{qi}_{ai}"
            if ai == 0:
                text = ["the", "answer", f"key{qi}"] + body[:3] + words(
                    a_len - 6)
            else:
                other = int(gen.integers(n_q))
                text = ["some", "text", f"key{other}"] + words(a_len - 3)
            ans.append((uri, " ".join(text)))
            rels.append((f"q{qi}", uri, int(ai == 0)))
    paths = [os.path.join(tmp, f) for f in
             ("questions.csv", "answers.csv", "relations.csv")]
    for path, rows in zip(paths[:2], (qs, ans)):
        with open(path, "w") as f:
            f.writelines(f"{u},{t}\n" for u, t in rows)
    with open(paths[2], "w") as f:
        f.write("id1,id2,label\n")
        f.writelines(f"{a},{b},{c}\n" for a, b, c in rels)
    return paths


def knrm_flops(batch_rows: int = 1) -> tuple[float, float]:
    """(forward, training) FLOPs of KNRM on one (question, answer) pair:
    the cosine matrix (2 x Lq x Ld x E, and the norms), the kernel pooling
    (about 7 operations a kernel and entry) and the score; training three
    times the forward."""
    lq, ld = KNRM_ARGS["text1_length"], KNRM_ARGS["text2_length"]
    e, k = KNRM_ARGS["embed_size"], KNRM_ARGS["kernel_num"]
    fwd = (2.0 * lq * ld * e + 3.0 * (lq + ld) * e + 7.0 * k * lq * ld
           + 2.0 * k)
    return batch_rows * fwd, 3 * batch_rows * fwd


def falling_pairs(tag, net, x, y, batch, steps) -> None:
    """``steps`` eager Adam steps (a fresh optimizer state) on the first
    ``batch`` rows of (x, y) in their order: the loss falls.  ``fit``
    shuffles its rows, as the reference's does, and so pairs
    ``rank_hinge``'s positives and negatives at random; here the pairs
    stay whole."""
    _, rep, _ = eager_steps(
        net, None, [np.concatenate([a[:batch]] * steps) for a in x],
        np.concatenate([y[:batch]] * steps), steps, batch, shuffle=False)
    log(f"{tag} on a fixed batch, pairs whole: "
        + ", ".join(f"{v:.4f}" for v in rep))
    if not (np.all(np.isfinite(rep)) and rep[-1] < rep[0]):
        raise AssertionError(f"{tag}: the loss did not fall: {rep}")


def text_matching_phase(card_line: str) -> dict:
    """The slice's main path: a seeded question/answer corpus written as
    CSV and read back through ``TextSet.read_csv``/``read_relations_csv``,
    tokenized, normalized, indexed (``word2idx`` over both sides, the
    20,000 most frequent words) and shaped; ``from_relation_pairs`` feeds
    KNRM (``compile("adam", "rank_hinge")``) at batch 200 for one epoch of
    5 steps, captured, bit for bit ``train_step`` called eagerly (twice);
    a replayed epoch's times, launches (one Adam a step) and bound; step 1
    against the CPU; ``evaluate_ndcg`` (k = 3, 5) and ``evaluate_map`` over the held-out
    groups; requests of 1, 8 and 32 pairs through ``InferenceModel``; a
    loss that falls on a fixed batch of whole pairs.  Returns the path's
    launch counts."""
    import shutil
    import tempfile

    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.feature.text import (
        TextSet,
        read_relations_csv,
    )
    from analytics_zoo_tpu_torch.models import KNRM

    gen = np.random.default_rng(SEED + 110)
    tmp = tempfile.mkdtemp(prefix="zoo_qa_")
    try:
        t0 = time.perf_counter()
        q_csv, a_csv, r_csv = qa_corpus(tmp, gen)
        q_set, a_set = TextSet.read_csv(q_csv), TextSet.read_csv(a_csv)
        rels = read_relations_csv(r_csv)
        vocab = KNRM_ARGS["vocab_size"]
        corpus = TextSet(q_set.features + a_set.features).tokenize() \
            .normalize().word2idx(max_words_num=vocab - 1)
        q_set = TextSet(q_set.features, corpus.word_index).shape_sequence(
            KNRM_ARGS["text1_length"])
        a_set = TextSet(a_set.features, corpus.word_index).shape_sequence(
            KNRM_ARGS["text2_length"])
        n_train = KNRM_TRAIN_Q * KNRM_PER_Q
        qa, da, y = TextSet.from_relation_pairs(rels[:n_train], q_set,
                                                a_set)
        groups = TextSet.from_relation_lists(rels[n_train:], q_set, a_set)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    top = max(int(qa.max()), int(da.max()))
    log(f"text_matching: {len(q_set)} questions, {len(a_set)} answers, "
        f"{len(rels)} relations read from CSV; {len(corpus.word_index)} "
        f"words indexed, ids up to {top}; pairs {qa.shape} / {da.shape}, "
        f"{len(groups)} held-out groups; {time.perf_counter() - t0:.1f} s")
    if qa.shape != (KNRM_BATCH * KNRM_STEPS, KNRM_ARGS["text1_length"]) \
            or top != vocab - 1 or len(groups) != KNRM_HELD_Q:
        raise AssertionError("the text pipeline did not give the expected "
                             "arrays")
    x = [qa, da]

    def build():
        init_zoo_context(seed=SEED, device="cuda")
        m = KNRM(**KNRM_ARGS)
        m.model.build_params()
        m.compile(optimizer="adam", loss="rank_hinge")
        return m

    knrm = build()
    losses = captured_fit_check("knrm", knrm.model, None, x, y, KNRM_STEPS,
                                KNRM_BATCH)
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"knrm losses {losses}")
    flops = knrm_flops()
    step = seq_step("knrm", knrm.model, None, x, y, KNRM_BATCH, KNRM_STEPS,
                    flops, PEAK_FLOPS["float32"], card_line,
                    nbytes=adam_bytes(knrm.model))
    expect_launches("knrm", step["launches"], fused_adam=KNRM_STEPS)
    total = dict(step["launches"])
    qd = [(g[0], g[1]) for g in groups]
    labels = [g[2] for g in groups]
    reset_counters()  # the evaluation's predicts: to the read below
    t0 = time.perf_counter()
    metrics = {f"ndcg@{k}": knrm.evaluate_ndcg(qd, labels, k=k)
               for k in (3, 5)}
    metrics["map"] = knrm.evaluate_map(qd, labels)
    ms = (time.perf_counter() - t0) * 1e3
    total = add_launches(total, counters())
    log(f"knrm on {len(groups)} held-out groups of {KNRM_PER_Q}: "
        f"{metrics} in {ms:.1f} ms ({card_line})")
    if not all(0.0 <= v <= 1.0 for v in metrics.values()):
        raise AssertionError(f"knrm metrics {metrics}")
    reqs = {n: [qa[:n], da[:n]] for n in KNRM_REQUESTS}
    launches, _ = serve_requests("knrm", knrm.model, reqs, flops, card_line,
                                 precisions=("f32",), unit="pairs",
                                 softmax=False)
    total = add_launches(total, launches)
    falling_pairs("knrm", knrm.model, x, y, KNRM_BATCH, 5)
    del knrm
    free_device_memory("after knrm")
    against_the_cpu("knrm", lambda: KNRM(**KNRM_ARGS).model, "rank_hinge",
                    {"x": [qa[:KNRM_BATCH], da[:KNRM_BATCH]],
                     "y": y[:KNRM_BATCH]}, SEED)
    return total


def autograd_phase(card_line: str) -> dict:
    """``examples/autograd``'s two programs at their widths (custom.py:
    4 features, Dense(1), a Lambda adding one, mean absolute error as a
    ``CustomLoss`` of ``AutoGrad`` ops, Adam(0.05); customloss.py: a
    Lambda scaling 2 features to 2x - 1, Dense(1), a torch
    mean-absolute-error ``CustomLoss``), and a graph whose output adds a
    trainable ``Parameter`` (256 features, Dense(128) plus a (128,)
    parameter, then ``l2_normalize``), and the same graph with the
    ``Parameter`` frozen: each 5 steps at batch 32 through ``fit``,
    captured, bit for bit ``train_step`` called eagerly (twice), a replayed
    epoch's launches (the examples' leaves are below the fused Adam
    kernel's 128 elements, as in the reference's gate: none; the graphs
    one a step), the frozen value unchanged, a loss that falls on a fixed
    batch, step 1 against the CPU, one 8-record request.  Returns the
    path's launch counts."""
    import torch

    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.pipeline.api import autograd as A
    from analytics_zoo_tpu_torch.pipeline.api.keras import (
        Input,
        Model,
        Sequential,
    )
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import Adam

    gen = np.random.default_rng(SEED + 120)
    n = AG_BATCH * AG_STEPS

    def mae(y_true, y_pred):
        return A.mean(A.abs(y_true - y_pred), axis=1)

    def torch_mae(y_true, y_pred):
        return torch.mean(torch.abs(y_true - y_pred), dim=1)

    def custom():
        inp = Input(shape=(4,))
        return Model(inp, A.Lambda(lambda v: v + 1.0)(Dense(1)(inp)))

    def customloss():
        m = Sequential()
        m.add(A.Lambda(lambda t: t * 2.0 - 1.0, input_shape=(2,)))
        m.add(Dense(1))
        return m

    def parameter_graph(trainable):
        def make():
            x = Input(shape=(256,))
            w = A.Parameter((128,), trainable=trainable, name="offset")()
            return Model(x, A.l2_normalize(Dense(128)(x) + w))
        return make

    x4 = gen.normal(size=(n, 4)).astype(np.float32)
    x2 = gen.uniform(0, 1, (n, 2)).astype(np.float32)
    xp = gen.normal(size=(n, 256)).astype(np.float32)
    yp = gen.normal(size=(n, 128)).astype(np.float32)
    cases = [
        ("custom.py", custom, A.CustomLoss(mae, [1]), Adam(lr=0.05), x4,
         (x4 @ gen.normal(size=(4, 1)).astype(np.float32) + 1.0)
         .astype(np.float32), 0),
        ("customloss.py", customloss, A.CustomLoss(torch_mae),
         Adam(lr=0.05), x2,
         ((2 * x2).sum(1) + 0.4).reshape(n, 1).astype(np.float32), 0),
        ("trainable Parameter", parameter_graph(True), "mse", Adam(1e-3),
         xp, yp, 1),
        ("frozen Parameter", parameter_graph(False), "mse", Adam(1e-3), xp,
         yp, 1),
    ]
    total = {}
    for tag, make, loss, opt, x, y, adam in cases:
        init_zoo_context(seed=SEED, device="cuda")
        net = make()
        net.build_params()
        net.compile(optimizer=opt, loss=loss)
        frozen = {k: v.clone() for k, v in net.state.get("offset",
                                                          {}).items()}
        losses = captured_fit_check(f"autograd {tag}", net, None, x, y,
                                    AG_STEPS, AG_BATCH)
        step = seq_step(f"autograd {tag}", net, None, x, y, AG_BATCH,
                        AG_STEPS, seq_flops(net), PEAK_FLOPS["float32"],
                        card_line, nbytes=adam_bytes(net))
        expect_launches(f"autograd {tag}", step["launches"],
                        fused_adam=adam * AG_STEPS)
        total = add_launches(total, step["launches"])
        if frozen and not torch.equal(net.state["offset"]["value"],
                                      frozen["value"]):
            raise AssertionError("the frozen Parameter moved")
        log(f"autograd {tag}: losses {losses[0]:.5f} .. {losses[-1]:.5f}; "
            f"parameters {sorted(net.params)}, state {sorted(net.state)}"
            + ("; the frozen value unchanged bit for bit" if frozen else ""))
        launches, _ = serve_requests(f"autograd {tag}", net, {8: x[:8]},
                                     seq_flops(net), card_line,
                                     precisions=("f32",), unit="records",
                                     softmax=False)
        total = add_launches(total, launches)
        falling_loss(f"autograd {tag}", net, Adam(0.05 if adam == 0
                                                  else 1e-3),
                     loss, x, y, AG_BATCH, 5)
        against_the_cpu(f"autograd {tag}", make, loss,
                        {"x": x[:AG_BATCH], "y": y[:AG_BATCH]}, SEED)
        del net
    free_device_memory("after autograd")
    return total


def tfpark_text_phase(card_line: str) -> dict:
    """The tfpark text taggers at their defaults (sequence 64, words of 12
    characters, a 20,000-word vocabulary, 100 characters): ``NER`` (9
    tags), ``SequenceTagger`` (45 POS and 23 chunk tags, two heads, words
    only) and ``IntentEntity`` (7 intents, 9 entity tags, two heads), each
    3 steps at batch 32 through ``fit`` on one label or a list of two,
    captured, bit for bit ``train_step`` called eagerly (twice); a
    replayed epoch's times, launches (one Adam a step) and bound; a loss
    that falls on a fixed batch; step 1 against the CPU (8 records,
    dropout 0); one 8-record request, each head's rows summing to 1.
    Returns the path's launch counts."""
    import analytics_zoo_tpu_torch.tfpark.text.keras as K
    from analytics_zoo_tpu_torch import init_zoo_context

    gen = np.random.default_rng(SEED + 130)
    n = TAG_BATCH * TAG_STEPS
    words = gen.integers(1, TAG_WORDS, (n, TAG_SEQ)).astype(np.int32)
    chars = gen.integers(1, TAG_CHARS, (n, TAG_SEQ, TAG_WLEN)) \
        .astype(np.int32)
    total = {}
    for tag, (cls, kw) in TAGGERS.items():
        def make(cls=cls, kw=kw):
            init_zoo_context(seed=SEED, device="cuda")
            return getattr(K, cls)(**kw)

        m = make()
        m.model.build_params()
        x = words if tag == "sequence_tagger" else [words, chars]
        if tag == "ner":
            y = (words % 9).astype(np.int32)
        elif tag == "sequence_tagger":
            y = [(words % 45).astype(np.int32), (words % 23).astype(np.int32)]
        else:
            y = [(words[:, 0] % 7).astype(np.int32),
                 (words % 9).astype(np.int32)]
        losses = captured_fit_check(tag, m.model, None, x, y, TAG_STEPS,
                                    TAG_BATCH)
        if not np.all(np.isfinite(losses)):
            raise AssertionError(f"{tag} losses {losses}")
        flops = seq_flops(m.model)
        step = seq_step(tag, m.model, None, x, y, TAG_BATCH, TAG_STEPS,
                        flops, PEAK_FLOPS["float32"], card_line,
                        timesteps=TAG_SEQ, nbytes=adam_bytes(m.model))
        expect_launches(tag, step["launches"], fused_adam=TAG_STEPS)
        total = add_launches(total, step["launches"])
        xs = x if isinstance(x, list) else [x]
        launches, _ = serve_requests(
            tag, m.model, {TAG_REQUEST: [a[:TAG_REQUEST] for a in xs]},
            flops, card_line, precisions=("f32",), unit="records")
        total = add_launches(total, launches)
        loss = m.model._compiled["loss"]
        falling_loss(tag, m.model, "adam", loss, x, y, TAG_BATCH, 5)
        del m
        free_device_memory(f"after {tag}")
        against_the_cpu(
            tag, lambda make=make: make().model, loss,
            {"x": [a[:8] for a in xs] if len(xs) > 1 else xs[0][:8],
             "y": [a[:8] for a in y] if isinstance(y, list) else y[:8]},
            SEED, drop_off=("Dropout",))
    return total


# the cluster_serving phase: BERT-base served from the stream at batch 8
# in each mode, ResNet-50 in calibrated int8 at batch 16
CS_RECORDS, CS_BERT_BATCH, CS_RESNET_BATCH = 64, 8, 16
CS_TOL = 1e-5  # a record served in another bucket than direct predict's
CS_TIMEOUT = 300.0  # seconds a run may take to answer its records


class BatchLog:
    """A model behind ``ClusterServing`` that notes the micro-batch size
    each record was predicted in (by the digest of its bytes), so the
    phase knows which answers must equal direct ``predict`` bit for bit
    (the same bucket) and which within CS_TOL."""

    def __init__(self, model):
        self.model, self.size = model, {}

    def predict(self, x, batch_size=None):
        for row in x:
            self.size[digest(row)] = len(x)
        return self.model.predict(x, batch_size=batch_size)


def digest(a) -> str:
    import hashlib

    return hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest()


def serve_stream(tag, server, db, records, card_line, run_kwargs):
    """Enqueue ``records`` through ``InputQueue`` under fresh uris, serve
    them with ``server.run(max_records=len(records), **run_kwargs)`` while
    a client thread polls ``OutputQueue.query`` for each uri and notes
    when its answer lands; checks that every record is answered exactly
    once (``run`` serves exactly that many, every uri has an answer, the
    stream is empty, the ``zoo_serving_records_total`` counter moved by
    that many).  Returns ({uri: answer}, the uris in order, timings)."""
    import threading

    from analytics_zoo_tpu_torch.metrics import get_registry, get_tracer
    from analytics_zoo_tpu_torch.serving import InputQueue, OutputQueue

    iq, oq = InputQueue(broker=db), OutputQueue(broker=db)
    uris = [f"{tag.replace(' ', '-')}-{i}" for i in range(len(records))]
    served_before = counter_value(get_registry(), "zoo_serving_records_total")
    t_enq = {}
    for uri, rec in zip(uris, records):
        t_enq[uri] = time.perf_counter()
        iq.enqueue(uri, rec)
    answers, t_done = {}, {}
    stop = threading.Event()

    def poll():
        pending = list(uris)
        while pending and not stop.is_set():
            left = []
            for uri in pending:
                res = oq.query(uri)
                if res is None:
                    left.append(uri)
                else:
                    t_done[uri] = time.perf_counter()
                    answers[uri] = res
            pending = left
            # a sweep every 2 ms: the poller takes the GIL from the
            # server's threads for as short as it can
            time.sleep(0.002)

    poller = threading.Thread(target=poll, daemon=True)
    get_tracer().clear()
    poller.start()
    t0 = time.perf_counter()
    served = server.run(max_records=len(records), idle_timeout=CS_TIMEOUT,
                        **run_kwargs)
    t_run = time.perf_counter() - t0
    poller.join(timeout=CS_TIMEOUT)
    stop.set()
    spans = {}
    for ev in get_tracer().events():
        spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur"] / 1e3
    moved = counter_value(get_registry(), "zoo_serving_records_total") \
        - served_before
    backlog = db.xlen(server.stream)
    if served != len(records) or len(answers) != len(records) \
            or moved != len(records) or backlog:
        raise AssertionError(
            f"cluster_serving {tag}: served {served}, answered "
            f"{len(answers)}, counted {moved} of {len(records)} records; "
            f"{backlog} left in the stream")
    lat = np.array([t_done[u] - t_enq[u] for u in uris]) * 1e3
    window = max(t_done.values()) - t0
    out = {"run_s": t_run, "window_s": window,
           "rate": len(records) / window,
           "p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)), "spans_ms": spans}
    log(f"cluster_serving {tag}: {len(records)} records answered once "
        f"each; run() {t_run * 1e3:.1f} ms, run start to "
        f"last answer {window * 1e3:.1f} ms = {out['rate']:.1f} records/s; "
        f"enqueue-to-result p50 {out['p50_ms']:.1f} ms, p99 "
        f"{out['p99_ms']:.1f} ms; host spans "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in sorted(spans.items()))
        + f" ({card_line})")
    return answers, uris, out


def counter_value(reg, name, **labels) -> float:
    """The value of one counter child (0 when it has no sample yet)."""
    for fam in reg.collect():
        if fam.name == name:
            for lab, child in fam.samples():
                if lab == labels:
                    return child.get()
    return 0.0


def check_answers(tag, answers, uris, records, want, sizes, direct_batch,
                  top_n, prefix="cluster_serving"):
    """Each answer's top-``top_n`` classes equal those of direct
    ``predict`` (``want``), and its probabilities bit for bit where the
    record was served in a micro-batch of ``direct_batch`` (the same
    bucket), else within CS_TOL.  Returns (records served in the same
    bucket, the largest difference)."""
    same, worst = 0, 0.0
    for uri, rec, row in zip(uris, records, want):
        got = answers[uri]
        top = np.argsort(row)[::-1][:top_n]
        if [c for c, _ in got] != [int(c) for c in top]:
            raise AssertionError(f"{prefix} {tag}: {uri} classes "
                                 f"{[c for c, _ in got]} != {list(top)}")
        diff = max(abs(p - float(row[c])) for c, p in got)
        worst = max(worst, diff)
        if sizes[digest(rec)] == direct_batch:
            same += 1
            if diff != 0.0:
                raise AssertionError(f"{prefix} {tag}: {uri} served "
                                     f"in the same bucket differs by {diff}")
        elif not diff <= CS_TOL:
            raise AssertionError(f"{prefix} {tag}: {uri} differs by "
                                 f"{diff} (tol {CS_TOL:g})")
    log(f"{prefix} {tag}: classes equal direct predict's; "
        f"{same} of {len(uris)} records in its bucket, bit for bit; "
        f"largest difference {worst:.3e}")
    return same, worst


def direct_rate(im, x, batch, card_line, tag,
                prefix="cluster_serving") -> float:
    """Records a second through ``InferenceModel.predict`` at ``batch``
    over the same records (median of 3, each ending on the host)."""
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        im.predict(x, batch_size=batch)
        times.append(time.perf_counter() - t0)
    rate = len(x) / float(np.median(times))
    log(f"{prefix} {tag}: direct predict at batch {batch}: "
        f"{rate:.1f} records/s ({card_line})")
    return rate


def idle_share(tag, server, db, records, card_line, run_kwargs) -> float:
    """Serve ``records`` once more (``serve_stream``: every record answered
    once) under a torch.profiler trace of the card's activity, and return
    the idle share of that served window: 1 - the union of the traced
    kernels' and copies' device intervals / the host clock from ``run``'s
    start to the last answer.  The trace's own host cost falls inside the
    window.  NaN, logged as not measured, when the trace shows no device
    activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, out = serve_stream(tag, server, db, records, card_line,
                                 run_kwargs)
        torch.cuda.synchronize()
    busy_us, n_spans = device_union_us(cuda_spans(prof))
    window_ms = out["window_s"] * 1e3
    if not n_spans:
        log(f"cluster_serving {tag}: idle share not measured (the trace "
            f"shows no device activity) ({card_line})")
        return float("nan")
    idle = max(0.0, 1 - busy_us / 1e3 / window_ms)
    log(f"cluster_serving {tag}: device busy {busy_us / 1e3:.1f} ms "
        f"({n_spans} traced kernels and copies) over a "
        f"{window_ms:.1f} ms served window: idle {idle:.1%} "
        f"({card_line})")
    return idle


def host_split(tag, server, records, db, batch) -> int:
    """The host's time by stage for ``records``, stages the reference has
    no span for: the broker read of their records (``xread`` on a stream
    of their own), their serial decode, ``np.stack`` and ``predict`` of
    each micro-batch of ``batch`` (what the ``zoo.serving.predict`` span
    holds), and the batched write-back of their answers (``hset_many``,
    one broker round-trip).  Returns the records predicted."""
    from analytics_zoo_tpu_torch.serving.client import (
        RESULT_PREFIX,
        encode_ndarray,
    )

    for i, r in enumerate(records):
        db.xadd("split", {"uri": f"split-{i}", "image": encode_ndarray(r)})
    t0 = time.perf_counter()
    recs = db.xread("split", len(records))
    read = time.perf_counter() - t0
    db.ack("split", recs[-1][0])
    t0 = time.perf_counter()
    uris, arrs = server._decode_records(recs)
    decode = time.perf_counter() - t0
    stack = predict = 0.0
    outs = []
    for i in range(0, len(arrs), batch):
        t0 = time.perf_counter()
        x = np.stack(arrs[i:i + batch])
        t1 = time.perf_counter()
        outs.extend(server.model.predict(x))
        stack, predict = stack + t1 - t0, predict + time.perf_counter() - t1
    writes = [(RESULT_PREFIX + u, server._postprocess(u, o))
              for u, o in zip(uris, outs)]
    t0 = time.perf_counter()
    db.hset_many(writes)
    write = time.perf_counter() - t0
    for key, _ in writes:
        db.delete(key)
    log(f"cluster_serving {tag} host split for {len(records)} records: "
        f"broker read {read * 1e3:.1f} ms, decode {decode * 1e3:.1f} ms "
        f"({decode / len(records) * 1e3:.3f} ms a record, serial), "
        f"np.stack {stack * 1e3:.1f} ms, predict {predict * 1e3:.1f} ms "
        f"({-(-len(records) // batch)} micro-batches of {batch}), "
        f"write-back {write * 1e3:.1f} ms")
    return len(records)


def parse_prometheus(text) -> dict:
    """{family: type} from a Prometheus exposition; raises on a family
    with two TYPE lines or a sample of no declared family."""
    types = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ")
            if name in types:
                raise AssertionError(f"two TYPE lines for {name}")
            types[name] = kind
        elif line and not line.startswith("#"):
            name = line.split("{")[0].split(" ")[0]
            base = name
            for suffix in ("_bucket", "_sum", "_count"):
                if name.endswith(suffix) and \
                        types.get(name[:-len(suffix)]) == "histogram":
                    base = name[:-len(suffix)]
            if base not in types:
                raise AssertionError(f"sample {name} of no TYPE line")
            float(line.rsplit(" ", 1)[1])
    return types


def cluster_serving_phase(card_line: str) -> tuple[dict, dict]:
    """Cluster Serving on the card: brokers, client, ``ClusterServing`` in
    its serial, pipelined and claim modes, and the metrics plane.

    (a) BERT-base f32 at full width over token ids alone (the BERT
    layer's single-input form: a Cluster Serving record is one array, so
    positions are made and there are no type ids or mask) with a
    Dense(2, softmax) head, saved with ``KerasNet.save`` and loaded by
    ``ClusterServingHelper(model_path=..., batch_size=8, top_n=2,
    data_shape=(512,), log_dir=tmp)``; 64 int32 records served with
    ``run(max_records=64)`` over one ``InMemoryBroker``, serially (its
    first micro-batch captures bucket 8 inside ``run``), pipelined and in
    claim mode (``owner`` set, with a serve log), then pipelined over a
    ``FileBroker``, then serially again (warm).  Every record answered
    once; top-2 classes equal to ``InferenceModel.predict`` at batch 8,
    probabilities bit for bit in the same bucket, else within CS_TOL;
    12 flash launches a micro-batch.
    (b) ResNet-50 in calibrated int8 (as ``resnet50_int8_phase``) passed
    as ``ClusterServing(model=...)``: 64 (224, 224, 3) f32 records at
    batch 16, pipelined over a ``FileBroker`` twice (the bucket captured
    inside the first ``run``); top-5 classes equal direct ``predict``'s
    at 16; RESNET_INT8_LAUNCHES ``int8_conv`` and
    ``quantize_act`` launches a micro-batch.
    (c) The registry after (a) and (b): one TYPE line a family, the
    serving and inference record counters equal to the records served and
    predicted, ``record_device_memory() == 1``, a ``MetricsServer`` on
    port 0 answering ``/metrics /varz /healthz /flightz /telemetryz``
    with 200.
    Logs records a second against direct ``predict`` at the same batch,
    enqueue-to-result p50 and p99, the idle share of one more served run
    of each kind under a trace of the card (``idle_share``) and the
    host's time by stage.  Returns the path's launch counts."""
    import os
    import shutil
    import tempfile
    import urllib.request

    import torch

    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.metrics import (
        MetricsRegistry,
        MetricsServer,
        get_registry,
        prometheus_text,
        record_device_memory,
        set_registry,
        snapshot,
    )
    from analytics_zoo_tpu_torch.models import ResNet
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        recalibrate_batchnorm,
    )
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    from analytics_zoo_tpu_torch.serving import (
        ClusterServing,
        ClusterServingHelper,
        FileBroker,
        InMemoryBroker,
    )

    t_phase = time.perf_counter()
    free_device_memory("before cluster_serving")
    prev = set_registry(MetricsRegistry())  # this phase's counts alone
    tmp = tempfile.mkdtemp(prefix="zoo-cluster-serving-")
    launches = {}
    predicted = served = 0

    def counted(fn):
        reset_counters()  # one served run: to the read below
        out = fn()
        torch.cuda.synchronize()
        for k, v in counters().items():  # end of the served run
            launches[k] = launches.get(k, 0) + v
        return out

    try:
        # (a) BERT-base over token ids
        init_zoo_context(seed=SEED, device="cuda")
        gen = np.random.default_rng(SEED + 220)
        path = os.path.join(tmp, "bert_base.model")
        net = bert_tokens_model()
        net.build_params()
        t0 = time.perf_counter()
        net.save(path)
        del net
        helper = ClusterServingHelper(
            model_path=path, batch_size=CS_BERT_BATCH, top_n=2,
            data_shape=(SEQ,), log_dir=tmp)
        mem = InMemoryBroker()
        first = ClusterServing(helper=helper, broker=mem)
        im = first.model
        log(f"cluster_serving bert: saved and loaded through "
            f"ClusterServingHelper in {time.perf_counter() - t0:.1f} s")
        ids = gen.integers(1, BERT_BASE["vocab"],
                           (CS_RECORDS, SEQ)).astype(np.int32)
        recs = list(ids)
        log_path = os.path.join(tmp, "serve.log")
        runs = {}
        for tag, db, kwargs, owner in (
                ("bert serial", mem, {"pipelined": False}, None),
                ("bert pipelined", mem, {}, None),
                ("bert claim", mem, {}, "replica-0"),
                ("bert pipelined file", FileBroker(os.path.join(
                    tmp, "spool")), {}, None),
                ("bert serial warm", mem, {"pipelined": False}, None)):
            server = first if tag == "bert serial" else ClusterServing(
                helper=helper, model=im, broker=db, owner=owner,
                serve_log=log_path if owner else None)
            server.model = BatchLog(im)
            answers, uris, out = counted(lambda: serve_stream(
                tag, server, db, recs, card_line, kwargs))
            served += CS_RECORDS
            runs[tag] = (answers, uris, out, server.model.size)
            if owner:
                with open(log_path) as f:
                    lines = f.read().split()
                if sorted(lines[1::2]) != sorted(uris) or \
                        set(lines[0::2]) != {owner}:
                    raise AssertionError(
                        f"cluster_serving bert claim: the serve log is not "
                        f"each uri once: {lines[:6]} ... ({len(lines)})")
        bert_launches = dict(launches)
        want = im.predict(ids, batch_size=CS_BERT_BATCH)
        predicted += CS_RECORDS
        for tag, (answers, uris, out, sizes) in runs.items():
            check_answers(tag, answers, uris, recs, want, sizes,
                          CS_BERT_BATCH, 2)
        micro = len(runs) * CS_RECORDS // CS_BERT_BATCH
        expect = dict({k: 0 for k in bert_launches},
                      flash_attention_fwd=BERT_BASE["n_block"] * micro)
        log(f"cluster_serving bert launches {bert_launches} (expected "
            f"{expect}: 12 flash forwards a micro-batch of 8)")
        if bert_launches != expect:
            raise AssertionError("cluster_serving bert did not run its "
                                 "attention on the flash kernel")
        rate = direct_rate(im, ids, CS_BERT_BATCH, card_line, "bert")
        predicted += 3 * CS_RECORDS
        for tag, (_, _, out, _) in runs.items():
            log(f"cluster_serving {tag}: {out['rate']:.1f} records/s "
                f"against direct predict's {rate:.1f} "
                f"({out['rate'] / rate:.2f}x)")
        for tag, kwargs in (("bert serial traced", {"pipelined": False}),
                            ("bert pipelined traced", {})):
            idle_share(tag, ClusterServing(helper=helper, model=im,
                                           broker=mem),
                       mem, recs, card_line, kwargs)
            served += CS_RECORDS
        predicted += host_split("bert", first, recs[:CS_BERT_BATCH * 2],
                                mem, CS_BERT_BATCH)
        del first, server, im, runs
        free_device_memory("after cluster_serving bert")

        # (b) ResNet-50 in calibrated int8
        init_zoo_context(seed=SEED, device="cuda")
        gen = np.random.default_rng(SEED + 221)
        rn = ResNet.image_net(50, classes=RESNET_CLASSES,
                              input_shape=RESNET_SHAPE)
        rn.build_params()
        recalibrate_batchnorm(rn, gen.standard_normal(
            (RESNET_BATCH,) + RESNET_SHAPE, dtype=np.float32))
        calib = gen.standard_normal((INT8_CALIB,) + RESNET_SHAPE,
                                    dtype=np.float32)
        int8 = InferenceModel().from_keras_net(rn).optimize(
            "int8", calibration_data=calib)
        images = gen.standard_normal((CS_RECORDS,) + RESNET_SHAPE,
                                     dtype=np.float32)
        fb = FileBroker(os.path.join(tmp, "spool-resnet"))
        server = ClusterServing(model=BatchLog(int8), broker=fb,
                                batch_size=CS_RESNET_BATCH, top_n=5,
                                data_shape=RESNET_SHAPE, log_dir=tmp)
        before = dict(launches)
        rn_runs = {}
        for tag in ("resnet50 int8 pipelined file",
                    "resnet50 int8 pipelined file warm"):
            server.model = BatchLog(int8)
            answers, uris, out = counted(lambda: serve_stream(
                tag, server, fb, list(images), card_line, {}))
            served += CS_RECORDS
            rn_runs[tag] = (answers, uris, out, server.model.size)
        rn_launches = {k: v - before.get(k, 0) for k, v in launches.items()}
        want = int8.predict(images, batch_size=CS_RESNET_BATCH)
        predicted += CS_RECORDS
        for tag, (answers, uris, out, sizes) in rn_runs.items():
            check_answers(tag, answers, uris, list(images), want, sizes,
                          CS_RESNET_BATCH, 5)
        per = RESNET_INT8_LAUNCHES * len(rn_runs) * (
            CS_RECORDS // CS_RESNET_BATCH)
        expect = dict({k: 0 for k in rn_launches}, int8_conv=per,
                      quantize_act=per)
        log(f"cluster_serving resnet50 int8 launches {rn_launches} "
            f"(expected {expect})")
        if rn_launches != expect:
            raise AssertionError("cluster_serving resnet50 int8 did not run "
                                 "its layers on int8_conv and quantize_act")
        rate = direct_rate(int8, images, CS_RESNET_BATCH, card_line,
                           "resnet50 int8")
        predicted += 3 * CS_RECORDS
        for tag, (_, _, out, _) in rn_runs.items():
            log(f"cluster_serving {tag}: {out['rate']:.1f} records/s "
                f"against direct predict's {rate:.1f} "
                f"({out['rate'] / rate:.2f}x)")
        server.model = int8
        idle_share("resnet50 int8 pipelined file traced", server, fb,
                   list(images), card_line, {})
        served += CS_RECORDS
        predicted += host_split("resnet50 int8", server,
                                list(images[:CS_RESNET_BATCH]), fb,
                                CS_RESNET_BATCH)
        del server, int8, rn

        # (c) the telemetry of (a) and (b)
        reg = get_registry()
        types = parse_prometheus(prometheus_text(reg))
        got = {"zoo_serving_records_total": counter_value(
            reg, "zoo_serving_records_total"),
            "zoo_inference_records_total": counter_value(
                reg, "zoo_inference_records_total")}
        wanted = {"zoo_serving_records_total": served,
                  "zoo_inference_records_total": served + predicted}
        devices = record_device_memory()
        mem_gauges = {f"{s['name']}{s.get('labels', {})}": s["value"]
                      for s in snapshot(reg)["samples"]
                      if s["name"].startswith("zoo_device_")}
        srv = MetricsServer(port=0).start()
        codes = {}
        try:
            for ep in ("/metrics", "/varz", "/healthz", "/flightz",
                       "/telemetryz"):
                with urllib.request.urlopen(srv.url + ep, timeout=10) as r:
                    codes[ep] = r.status
                    r.read()
        finally:
            srv.stop()
        log(f"cluster_serving telemetry: {len(types)} families, one TYPE "
            f"line each; counters {got} (expected {wanted}); "
            f"record_device_memory() = {devices}, {mem_gauges}; "
            f"endpoints {codes}")
        if got != wanted or devices != 1 or \
                set(codes.values()) != {200}:
            raise AssertionError("cluster_serving telemetry is wrong")
    finally:
        set_registry(prev)
        shutil.rmtree(tmp, ignore_errors=True)
    free_device_memory("after cluster_serving")
    log(f"phase cluster_serving: {time.perf_counter() - t_phase:.1f} s")
    return launches



# the instrumented fit: BERT-base steps a fit, replayed fits timed on each
# side, and instrument calls timed
FIT_STEPS, FIT_REPEATS, INSTRUMENT_CALLS = 8, 5, 2000


def instrument_cost_us(enabled: bool) -> float:
    """Host microseconds of one dispatch's instruments as the fit loop
    makes them (``StepMetrics.record_step``, the heartbeat, a ``step``
    flight record, ``StragglerDetector.observe`` and a span), with the
    registry, tracer and flight recorder on or off, over
    INSTRUMENT_CALLS calls."""
    from analytics_zoo_tpu_torch.metrics import (
        FlightRecorder,
        HealthRegistry,
        MetricsRegistry,
        StepMetrics,
        StragglerDetector,
        Tracer,
        span,
    )

    sm = StepMetrics(MetricsRegistry(enabled=enabled))
    health, tracer = HealthRegistry(), Tracer(enabled=enabled)
    flight = FlightRecorder(enabled=enabled)
    straggler = StragglerDetector()
    health.register("train_loop", stale_after=600.0)
    t0 = time.perf_counter()
    for i in range(INSTRUMENT_CALLS):
        with span("zoo.train.step_dispatch", tracer=tracer):
            pass
        sm.record_step(1e-4, 2e-4, 3e-3, 8, steps=1)
        health.heartbeat("train_loop")
        flight.record("step", loop="train", step=i, epoch=0,
                      data_wait_s=1e-4, dispatch_s=2e-4, step_s=3e-3)
        straggler.observe(3e-3)
    return (time.perf_counter() - t0) / INSTRUMENT_CALLS * 1e6


def instrumented_fit_phase(card_line: str) -> dict:
    """(d) of the cluster_serving phase: BERT-base at full width (dropout
    0.1) through ``compile(Adam(2e-5), ...)`` and a captured ``fit`` of
    FIT_STEPS steps at batch 8, twice from one seed: once with the
    metrics plane on (a fresh registry, tracer and flight recorder) and
    once with it off (``ZOO_METRICS=0``'s disabled registry, ``ZOO_TRACE=0``
    and ``ZOO_FLIGHT=0``'s).  ``zoo_train_steps_total`` and
    ``zoo_train_records_total`` equal what was trained, there is one
    ``step`` flight record a dispatch, and the trained parameters and Adam
    moments are bit for bit those of the fit with the plane off; each
    model then fits the same epoch FIT_REPEATS times more, replayed, in
    turns, and the median host clock a step on less off is logged beside
    the instruments' own host cost a step.  Returns the replayed steps' launch counts."""
    import torch

    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.metrics import (
        FlightRecorder,
        MetricsRegistry,
        Tracer,
        set_flight_recorder,
        set_registry,
        set_tracer,
    )
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import Adam

    t_phase = time.perf_counter()
    free_device_memory("before instrumented_fit")
    gen = np.random.default_rng(SEED + 222)
    x, y = train_data(TRAIN_BATCH * FIT_STEPS, gen)
    planes = {}
    for tag, on in (("on", True), ("off", False)):
        planes[tag] = (MetricsRegistry(enabled=on), Tracer(enabled=on),
                       FlightRecorder(enabled=on))
    saved = (set_registry(planes["on"][0]), set_tracer(planes["on"][1]),
             set_flight_recorder(planes["on"][2]))

    def plane(tag):
        reg, tracer, flight = planes[tag]
        set_registry(reg)
        set_tracer(tracer)
        set_flight_recorder(flight)

    nets, host, launches = {}, {"on": [], "off": []}, {}
    try:
        for tag in ("on", "off"):
            plane(tag)
            init_zoo_context(seed=SEED, device="cuda")
            net = bert_classifier(BERT_BASE["n_block"], DROPOUT, DROPOUT)
            net.build_params()
            net.compile(optimizer=Adam(2e-5),
                        loss="sparse_categorical_crossentropy_from_logits")
            net.fit(x, y, batch_size=TRAIN_BATCH, nb_epoch=1)
            nets[tag] = net
        reg = planes["on"][0]
        steps = counter_value(reg, "zoo_train_steps_total")
        records = counter_value(reg, "zoo_train_records_total")
        flights = len(planes["on"][2].events("step"))
        off = differing(
            {"p": nets["on"].params, "o": nets["on"]._estimator._opt_state},
            {"p": nets["off"].params,
             "o": nets["off"]._estimator._opt_state})
        log(f"instrumented fit: {FIT_STEPS} captured steps with the plane "
            f"on: zoo_train_steps_total {steps}, zoo_train_records_total "
            f"{records}, {flights} step flight records; parameters and "
            f"Adam moments against the fit with the plane off: "
            f"{'bit for bit' if not off else 'differ at ' + str(off[:8])}")
        if steps != FIT_STEPS or records != FIT_STEPS * TRAIN_BATCH \
                or flights != FIT_STEPS or off:
            raise AssertionError("the instrumented fit is wrong")
        for rep in range(FIT_REPEATS):
            # alternate which side goes first: host clocks drift
            for tag in ("on", "off") if rep % 2 == 0 else ("off", "on"):
                plane(tag)
                if rep == 0 and tag == "on":
                    reset_counters()  # the replayed steps: to the read below
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                nets[tag].fit(x, y, batch_size=TRAIN_BATCH, nb_epoch=1)
                torch.cuda.synchronize()
                host[tag].append((time.perf_counter() - t0) * 1e3
                                 / FIT_STEPS)
                if rep == 0 and tag == "on":
                    launches = counters()  # end of the replayed steps
        off = differing(
            {"p": nets["on"].params, "o": nets["on"]._estimator._opt_state},
            {"p": nets["off"].params,
             "o": nets["off"]._estimator._opt_state})
        blocks = BERT_BASE["n_block"]
        expect = dict({k: 0 for k in launches},
                      flash_attention_fwd=blocks * FIT_STEPS,
                      flash_attention_bwd=blocks * FIT_STEPS,
                      fused_adam=FIT_STEPS, softmax_xent_fwd=FIT_STEPS,
                      softmax_xent_bwd=FIT_STEPS)
        cost = {tag: instrument_cost_us(tag == "on") for tag in ("on", "off")}
        on, offh = float(np.median(host["on"])), float(np.median(host["off"]))
        log(f"instrumented fit: replayed epochs, host clock a step with "
            f"the plane on {', '.join(f'{t:.3f}' for t in host['on'])} ms, "
            f"off {', '.join(f'{t:.3f}' for t in host['off'])} ms: on less "
            f"off {on - offh:+.3f} ms a step (medians); the instruments' "
            f"own host cost {cost['on']:.2f} us a dispatch on, "
            f"{cost['off']:.2f} us off; launches {launches} (expected "
            f"{expect}); still bit for bit after both: {not off} "
            f"({card_line})")
        if launches != expect or off:
            raise AssertionError("the instrumented fit's replays are wrong")
    finally:
        set_registry(saved[0])
        set_tracer(saved[1])
        set_flight_recorder(saved[2])
    del nets
    free_device_memory("after instrumented_fit")
    log(f"phase instrumented_fit: {time.perf_counter() - t_phase:.1f} s")
    return launches


# the image data plane: npz and TFRecord shards, the host transforms on the
# native library, the prefetch pool and autotune, uint8 batches normalized
# inside the captured step, and ImageClassifier
DP_SHARDS, DP_PER_SHARD = 16, 96           # 1536 (224, 224, 3) npz images
DP_TF_SHARDS, DP_TF_PER_SHARD = 8, 128     # 1024 (256, 256, 3) raw records
DP_SKIP = 4                                # dispatches before the window
DP_TF_SIDE = 256
DP_WORKERS = 4
DP_NATIVE_BATCH = 64
IMAGENET_MEAN = (123.68, 116.779, 103.939)
IMAGENET_STD = (58.393, 57.12, 57.375)
AT_SHARDS, AT_PER_SHARD, AT_BATCH, AT_EPOCHS = 16, 96, 16, 4
AT_SHARD_SLEEP_S, AT_RECORD_SLEEP_S = 0.015, 0.0002
AT_K_LADDER = (1, 2, 4, 8, 16)
CLF_IMAGES, CLF_SIDE = 32, 300
CLF_PROB_TOL = 1e-4


class _NoCv2:
    """``import cv2`` raises inside the block, as on a host without it:
    the image ops take their numpy paths."""

    def __enter__(self):
        self.saved = sys.modules.get("cv2", _NoCv2)
        sys.modules["cv2"] = None
        return self

    def __exit__(self, *exc):
        if self.saved is _NoCv2:
            sys.modules.pop("cv2", None)
        else:
            sys.modules["cv2"] = self.saved
        return False


def stream_digest(batches) -> tuple[str, int]:
    """A sha256 over every array of every batch in order, and the count."""
    import hashlib

    h, n = hashlib.sha256(), 0
    for b in batches:
        for k in sorted(b):
            for a in (b[k] if isinstance(b[k], list) else [b[k]]):
                a = np.ascontiguousarray(a)
                h.update(f"{k}{a.dtype}{a.shape}".encode())
                h.update(a.tobytes())
        n += 1
    return h.hexdigest(), n


def host_ms(fn, reps: int = 3) -> float:
    """The best host clock of ``reps`` calls of ``fn``, in ms."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def native_checks(card_line: str) -> None:
    """(a): the host library built from the port's copy and loaded, then
    crc32c, the crop-and-flip batch assembly and the bilinear resize held
    against their numpy paths (bit for bit; the resize within 1, its own
    contract), and each timed on a 64-image batch."""
    from analytics_zoo_tpu_torch import native
    from analytics_zoo_tpu_torch.feature.image import transforms as tf
    from analytics_zoo_tpu_torch.tensorboard import record

    t0 = time.perf_counter()
    lib = native.build_native(force=True)
    if lib is None or native.lib is None:
        raise AssertionError("the native host library did not build or "
                             "load from analytics_zoo_tpu_torch/native")
    log(f"image data plane (a): native library built in "
        f"{time.perf_counter() - t0:.1f} s and loaded from {lib.path}")
    gen = np.random.default_rng(SEED + 230)
    blob = gen.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()
    crc_ok = all(lib.crc32c(b) == record._crc32c_py(b)
                 for b in (b"", b"a", blob[:7], blob[:4097], blob))
    src = [gen.integers(0, 256, (DP_TF_SIDE, DP_TF_SIDE, 3), dtype=np.uint8)
           for _ in range(DP_NATIVE_BATCH)]
    side = RESNET_SHAPE[0]
    crop_rng = np.random.default_rng(SEED + 231)
    offsets = crop_rng.integers(0, DP_TF_SIDE - side + 1,
                                (DP_NATIVE_BATCH, 2)).astype(np.int32)
    flips = crop_rng.random(DP_NATIVE_BATCH) < 0.5

    def assemble():
        return tf.assemble_crop_batch(src, side, side, offsets=offsets,
                                      flips=flips)

    nat = assemble()
    ms_nat = host_ms(assemble)
    native.lib = None
    try:
        ref = assemble()
        ms_np = host_ms(assemble)
    finally:
        native.lib = lib
    big = np.stack([gen.integers(0, 256, (CLF_SIDE, CLF_SIDE, 3),
                                 dtype=np.uint8)
                    for _ in range(DP_NATIVE_BATCH)])
    r_nat = tf.resize_batch(big, 256, 256)
    r_ms_nat = host_ms(lambda: tf.resize_batch(big, 256, 256))
    op = tf.ImageResize(256, 256)
    with _NoCv2():
        r_np = np.stack([op(im) for im in big])
        r_ms_np = host_ms(lambda: [op(im) for im in big], reps=1)
    resize_diff = int(np.abs(r_nat.astype(np.int16)
                             - r_np.astype(np.int16)).max())
    log(f"image data plane (a): crc32c equal to the Python table {crc_ok}; "
        f"assemble_batch of {DP_NATIVE_BATCH} {DP_TF_SIDE}x{DP_TF_SIDE} "
        f"images to {side} with flips equal bit for bit "
        f"{np.array_equal(nat, ref)}: {ms_nat:.2f} ms on C++ threads, "
        f"{ms_np:.2f} ms numpy; resize_bilinear of {DP_NATIVE_BATCH} "
        f"{CLF_SIDE}x{CLF_SIDE} to 256 within {resize_diff} of ImageResize's "
        f"numpy path: {r_ms_nat:.2f} ms on C++ threads, {r_ms_np:.2f} ms "
        f"numpy ({card_line})")
    if not crc_ok or not np.array_equal(nat, ref) or resize_diff > 1:
        raise AssertionError("the native host library disagrees with the "
                             "numpy paths")


def write_image_shards(tmp, gen):
    """The seeded shards: DP_SHARDS npz of uint8 (224, 224, 3) images with
    int32 labels, and DP_TF_SHARDS TFRecords of raw uint8 (256, 256, 3)
    records.  Returns (npz paths, tfrecord paths, all npz images, labels)."""
    import os

    from analytics_zoo_tpu_torch.feature.tfrecord import (
        encode_example,
        write_tfrecord_file,
    )

    for sub in ("npz", "tfrecord"):
        os.makedirs(os.path.join(tmp, sub), exist_ok=True)
    npz, xs, ys = [], [], []
    for i in range(DP_SHARDS):
        x = gen.integers(0, 256, (DP_PER_SHARD,) + RESNET_SHAPE,
                         dtype=np.uint8)
        y = gen.integers(0, RESNET_CLASSES, DP_PER_SHARD).astype(np.int32)
        path = os.path.join(tmp, "npz", f"train-{i:02d}.npz")
        np.savez(path, x=x, y=y)
        npz.append(path)
        xs.append(x)
        ys.append(y)
    tfr = []
    for i in range(DP_TF_SHARDS):
        path = os.path.join(tmp, "tfrecord", f"raw-{i:02d}.tfrecord")
        write_tfrecord_file(path, [
            encode_example({
                "image/raw": gen.integers(
                    0, 256, (DP_TF_SIDE, DP_TF_SIDE, 3),
                    dtype=np.uint8).tobytes(),
                "image/class/label": [int(gen.integers(RESNET_CLASSES))]})
            for _ in range(DP_TF_PER_SHARD)])
        tfr.append(path)
    return npz, tfr, np.concatenate(xs), np.concatenate(ys)


def raw_record(fm):
    """A TFRecord's raw pixels and label (the card has no JPEG decoder)."""
    return (np.frombuffer(fm["image/raw"][0], np.uint8).reshape(
        DP_TF_SIDE, DP_TF_SIDE, 3), np.int32(fm["image/class/label"][0]))


def normalize_on_device(fs):
    """``fs`` with the ImageNet normalization attached on the device: the
    uint8 batch crosses to the card and becomes f32 inside the step."""
    import torch

    from analytics_zoo_tpu_torch.common.engine import get_zoo_context

    device = get_zoo_context().device
    mean = torch.tensor(IMAGENET_MEAN, device=device)
    inv = 1.0 / torch.tensor(IMAGENET_STD, device=device)
    return fs.transform_on_device(
        lambda b: {**b, "x": (b["x"].float() - mean) * inv})


def stream_identity(npz, tfr, chain_ops, card_line):
    """(b): the npz stream through imagenet_feature_set and from_shards as
    DISK_2, serial against 4 prefetch workers; the TFRecord stream with the
    random crop and flip, serial against one worker."""
    import os

    from analytics_zoo_tpu_torch.feature.dataset import FeatureSet
    from analytics_zoo_tpu_torch.feature.imagenet import imagenet_feature_set

    kw = dict(batch_size=RESNET_BATCH, shuffle=True, seed=SEED, epoch=1)
    disk2 = FeatureSet.from_shards(npz, memory_type="DISK_2")
    t0 = time.perf_counter()
    serial = stream_digest(disk2.batches(**kw))
    t_serial = time.perf_counter() - t0
    via_dir = stream_digest(imagenet_feature_set(os.path.dirname(npz[0]))
                            .batches(**kw))
    t0 = time.perf_counter()
    pooled = stream_digest(disk2.prefetch(depth=4, workers=DP_WORKERS)
                           .batches(**kw))
    t_pooled = time.perf_counter() - t0
    tf_set = FeatureSet.from_tfrecord(tfr, raw_record, "DISK_2").transform(
        chain_ops[0] >> chain_ops[1])
    digests = []
    for workers in (None, 1):
        for op in chain_ops:
            op._counter = 0
        src = tf_set if workers is None else tf_set.prefetch(4, workers)
        digests.append(stream_digest(src.batches(**kw)))
    for op in chain_ops:
        op._counter = 0
    alone = {}
    for name, src in (("npz", disk2), ("tfrecord", tf_set)):
        t0 = time.perf_counter()
        n = sum(1 for _ in src.batches(**kw))
        alone[name] = (time.perf_counter() - t0) * 1e3 / n
    log(f"image data plane (b): one thread alone, the batches only (no "
        f"digest, no fit): npz DISK_2 {alone['npz']:.2f} ms a batch, "
        f"TFRecord crop+flip {alone['tfrecord']:.2f} ms a batch "
        f"({card_line})")
    log(f"image data plane (b): npz DISK_2 stream {serial[1]} batches "
        f"serial {serial[0][:16]} ({t_serial * 1e3:.0f} ms), "
        f"imagenet_feature_set {via_dir[0][:16]}, {DP_WORKERS} prefetch "
        f"workers {pooled[0][:16]} ({t_pooled * 1e3:.0f} ms); TFRecord "
        f"crop+flip {digests[0][1]} batches serial {digests[0][0][:16]}, "
        f"one worker {digests[1][0][:16]} ({card_line})")
    if not (serial == via_dir == pooled) or digests[0] != digests[1]:
        raise AssertionError("the prefetched streams are not the serial "
                             "ones")
    return disk2, tf_set


def cuda_spans(prof) -> list:
    """(name, start, end) in us of the card's kernels and copies in a
    finished torch.profiler trace, its GPU user annotations (the spans of
    ``record_function``) left out; read from the raw kineto events, since
    building the event tree of a long trace takes seconds."""
    import torch

    return [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation()]


def device_union_us(spans, lo: float = -float("inf"),
                    hi: float = float("inf")) -> tuple[float, int]:
    """The union of ``spans`` (:func:`cuda_spans`) clipped to [``lo``,
    ``hi``] us, and the count of those that reach into it."""
    inside = sorted((max(a, lo), min(b, hi)) for _, a, b in spans
                    if b > lo and a < hi)
    busy, reach = 0.0, None
    for a, b in inside:
        if reach is None or a > reach:
            busy, reach = busy + b - a, b
        elif b > reach:
            busy, reach = busy + b - reach, b
    return busy, len(inside)


def card_window(spans, skip: int) -> dict:
    """The card's side of a traced run of steps that each end in one fused
    Adam kernel (:func:`cuda_spans`), after its first ``skip``: from the
    end of step ``skip``'s Adam kernel to the end of the last one, so
    that work queued before the window stays outside it; the clock a step
    there, the busy ms (the union of the kernels and copies) and the idle
    share.  A kernel the trace drops counts as a gap of two steps."""
    adam = sorted(b for name, _, b in spans if "adam_multi_kernel" in name)
    if len(adam) < skip + 2:
        raise AssertionError(f"the trace holds {len(adam)} fused Adam "
                             f"kernels, fewer than {skip + 2}")
    lo, hi = adam[skip - 1], adam[-1]
    busy, _ = device_union_us(spans, lo, hi)
    gaps = np.diff(adam[skip - 1:])
    on_card = int(sum(max(1, round(g / np.median(gaps))) for g in gaps))
    return {"adam_traced": len(adam), "card_steps": on_card,
            "card_ms": (hi - lo) / 1e3 / on_card,
            "busy_ms": busy / 1e3 / on_card, "idle": 1 - busy / (hi - lo)}


def steady_window(spans, records, skip: int, steps: int) -> dict:
    """The steady part of a fit of ``steps`` steps, after its first
    ``skip``: the data plane's start (the pool, the first shard loads, the
    feeder's fill) and the first dispatches are outside it.  On the host,
    from the fit's ``step`` flight records (one a dispatch, taken as it
    ends): the clock a step from the ``skip``-th record to the last, and
    the medians of the dispatch span (``zoo.train.step_dispatch``) and
    of the wait for data.  On the card, from a trace of the same fit:
    :func:`card_window`."""
    if len(records) != steps:
        raise AssertionError(f"{len(records)} step records, expected "
                             f"{steps}")
    later = records[skip:]
    return {"steps": len(later),
            "host_ms": (records[-1]["mono"] - records[skip - 1]["mono"])
            * 1e3 / len(later),
            "span_ms": float(np.median([r["dispatch_s"] for r in later]))
            * 1e3,
            "wait_ms": float(np.median([r["data_wait_s"] for r in later]))
            * 1e3,
            **card_window(spans, skip)}


def uint8_fit(tag, make, fs, steps, plan, card_line, env=None) -> dict:
    """A fresh model (``make()``) whose train step ``warmup`` captures on
    ``fs``'s first batch, then trained one epoch on ``fs`` under ``plan``
    with ``env`` set (the prefetch knobs), every step a replay, under a
    torch.profiler trace of the card.  Logs, over the epoch's steady
    window (:func:`steady_window`, after DP_SKIP steps), the card's clock
    a step (one step's end to the next's) and images/s, its busy time and
    idle share, the host's dispatch cadence, the fit thread's dispatch
    span and its wait for data; the whole epoch's clock a step, the data
    plane's start included; one replay's device time and the bytes a step sends to the
    card.  The trace's own cost falls inside the window.  Returns the
    trained model, its Adam launches and the numbers."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    from analytics_zoo_tpu_torch.metrics import get_flight_recorder
    from analytics_zoo_tpu_torch.ops.cuda import fused_adam as fad

    t_fit = time.perf_counter()
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    flight = get_flight_recorder()
    batch = next(iter(fs.batches(RESNET_BATCH, shuffle=False)))
    try:
        net = make()
        net._estimator = net._make_estimator()
        before = fad.launch_count
        net._estimator.warmup(batch, device_transform=fs.device_transform,
                              plan=plan)
        torch.cuda.synchronize()
        flight.clear()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            net.fit(fs, batch_size=RESNET_BATCH, nb_epoch=1, plan=plan)
            torch.cuda.synchronize()
            epoch = (time.perf_counter() - t0) * 1e3 / steps
        adam = fad.launch_count - before
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    t_trace = time.perf_counter()
    win = steady_window(cuda_spans(prof),
                        [r for r in flight.events("step")
                         if r.get("loop") == "train"], DP_SKIP, steps)
    t_trace = time.perf_counter() - t_trace
    est = net._estimator
    graph = graph_of(est._train_step_for(1, est._resolve_plan(plan),
                                         fs.device_transform))
    dev = replay_ms(graph)
    h2d = sum(np.asarray(v).nbytes for v in batch.values())
    log(f"image data plane (c) {tag}: steady window after {DP_SKIP} "
        f"steps: on the card a step every {win['card_ms']:.2f} ms over "
        f"{win['card_steps']} steps, "
        f"{RESNET_BATCH / win['card_ms'] * 1e3:.1f} images/s, busy "
        f"{win['busy_ms']:.2f} ms a step, idle {win['idle']:.1%} (traced; "
        f"{win['adam_traced']} of {steps} Adam kernels in the trace); on "
        f"the host a dispatch every {win['host_ms']:.2f} ms over "
        f"{win['steps']}, the fit thread's dispatch span "
        f"{win['span_ms']:.2f} ms, wait for data {win['wait_ms']:.3f} ms "
        f"(medians); the whole epoch {epoch:.2f} ms a "
        f"step (start-up included); one replay {dev:.2f} ms; {h2d} B to "
        f"the card a step ({batch['x'].dtype} x); fused Adam launches "
        f"{adam} over the warmup's step and {steps} steps; "
        f"{time.perf_counter() - t_fit:.1f} s, {t_trace:.1f} s of it "
        f"reading the trace ({card_line})")
    if adam != steps + 1:
        raise AssertionError(f"{tag}: {adam} Adam launches, expected "
                             f"{steps + 1}")
    return {"net": net, "step_ms": win["card_ms"], "dev_ms": dev,
            "adam": adam, "idle": win["idle"]}


def resnet_from_shards(disk2, tf_set, chain_ops, x, y, card_line) -> int:
    """(c): ResNet-50 bf16 under Adam from the npz shards with the
    normalization inside the captured step, prefetch off and with 4
    workers, bit for bit; the f32 host-normalized resident set as the
    yardstick; the TFRecord crop+flip chain off and with one worker, bit
    for bit.  Returns the fused Adam launches."""
    import torch

    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.common.utils import tree_map
    from analytics_zoo_tpu_torch.feature.dataset import FeatureSet
    from analytics_zoo_tpu_torch.models import ResNet
    from analytics_zoo_tpu_torch.parallel import mixed_precision

    init_zoo_context(seed=SEED, device="cuda")
    first = ResNet.image_net(50, classes=RESNET_CLASSES,
                             input_shape=RESNET_SHAPE)
    first.build_params()
    weights = (first.params, first.state)

    def make():
        ctx = init_zoo_context(seed=SEED, device="cuda")
        net = ResNet.image_net(50, classes=RESNET_CLASSES,
                               input_shape=RESNET_SHAPE)
        net.device = ctx.device
        net.params = tree_map(torch.clone, weights[0])
        net.state = tree_map(torch.clone, weights[1])
        net.compile(optimizer="adam",
                    loss="sparse_categorical_crossentropy")
        return net

    plan = mixed_precision()
    steps = DP_SHARDS * DP_PER_SHARD // RESNET_BATCH
    npz_set = normalize_on_device(disk2)
    runs = {}
    for tag, env in (("npz, prefetch off", {"ZOO_PREFETCH_WORKERS": "0"}),
                     (f"npz, {DP_WORKERS} prefetch workers",
                      {"ZOO_PREFETCH_WORKERS": str(DP_WORKERS)})):
        runs[tag] = uint8_fit(tag, make, npz_set, steps, plan, card_line,
                              env)
    (ta, a), (tb, b) = runs.items()
    same = (a["net"]._estimator.loss_log == b["net"]._estimator.loss_log,
            differing(trained(a["net"]), trained(b["net"])))
    log(f"image data plane (c): {ta} against {tb}: losses equal "
        f"{same[0]}, parameters, Adam moments and BatchNorm state "
        f"{'bit for bit' if not same[1] else 'differ at ' + str(same[1][:8])}")
    if not same[0] or same[1]:
        raise AssertionError("ResNet-50 from shards differs with prefetch")
    losses = [v for _, v in a["net"]._estimator.loss_log]
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"ResNet-50 from shards: losses {losses}")
    launches = a["adam"] + b["adam"] + another_transform(
        a["net"], disk2, steps, plan, card_line)
    del runs, a, b
    free_device_memory("after image data plane npz fits")
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    host_set = FeatureSet.of((x.astype(np.float32) - mean) / std, y)
    yard = uint8_fit("f32 host-normalized resident set (yardstick)", make,
                     host_set, steps, plan, card_line)
    launches += yard["adam"]
    del yard, host_set
    free_device_memory("after image data plane yardstick")
    tf_steps = DP_TF_SHARDS * DP_TF_PER_SHARD // RESNET_BATCH
    tf_norm = normalize_on_device(tf_set)
    runs = {}
    for tag, env in (("TFRecord crop+flip, prefetch off",
                      {"ZOO_PREFETCH_WORKERS": "0"}),
                     ("TFRecord crop+flip, one prefetch worker",
                      {"ZOO_PREFETCH_WORKERS": "1"})):
        for op in chain_ops:
            op._counter = 0
        runs[tag] = uint8_fit(tag, make, tf_norm, tf_steps, plan, card_line,
                              env)
    (ta, a), (tb, b) = runs.items()
    off = differing(trained(a["net"]), trained(b["net"]))
    same = a["net"]._estimator.loss_log == b["net"]._estimator.loss_log
    log(f"image data plane (c): {ta} against {tb}: losses equal {same}, "
        f"trees {'bit for bit' if not off else 'differ at ' + str(off[:8])}")
    if not same or off:
        raise AssertionError("ResNet-50 from TFRecords differs with "
                             "prefetch")
    launches += a["adam"] + b["adam"]
    del runs, a, b, first, weights
    free_device_memory("after image data plane TFRecord fits")
    return launches


def another_transform(net, fs, steps, plan, card_line) -> int:
    """One more epoch of a trained model on the same shards under another
    device transform (x / 255): a new train step, captured anew, while the
    old transform's capture is left as it was.  Returns the Adam
    launches."""
    import torch

    from analytics_zoo_tpu_torch.feature.dataset import FeatureSet
    from analytics_zoo_tpu_torch.ops.cuda import fused_adam as fad

    est = net._estimator
    resolved = est._resolve_plan(plan)
    old = est._train_step_for(1, resolved, fs.device_transform)
    old_exes = dict(old._exes)
    other = FeatureSet.from_shards(fs.paths, "DISK_2").transform_on_device(
        lambda b: {**b, "x": b["x"].float() * (1.0 / 255)})
    before = fad.launch_count
    net.fit(other, batch_size=RESNET_BATCH, nb_epoch=1, plan=plan)
    torch.cuda.synchronize()
    new = est._train_step_for(1, resolved, other.device_transform)
    fresh = new is not old and any(e is not None
                                   for e in new._exes.values())
    kept = old._exes == old_exes
    launched = fad.launch_count - before
    losses = [v for _, v in est.loss_log[-steps:]]
    log(f"image data plane (c): another transform on the trained model: "
        f"its own capture {fresh}, the first transform's capture "
        f"untouched {kept}, losses finite {bool(np.isfinite(losses).all())}, "
        f"Adam launches {launched} over {steps} steps ({card_line})")
    if not (fresh and kept and np.isfinite(losses).all()):
        raise AssertionError("another device transform did not capture "
                             "anew")
    if launched != steps:
        raise AssertionError(f"another transform: {launched} Adam "
                             f"launches, expected {steps}")
    return launched


class _SlowShards:
    """A shard loader that sleeps AT_SHARD_SLEEP_S before ``np.load``, and
    a per-record transform that sleeps AT_RECORD_SLEEP_S: host work the
    autotune controller can see and grow the pool against."""

    @staticmethod
    def load(path):
        time.sleep(AT_SHARD_SLEEP_S)
        data = np.load(path)
        return {k: data[k] for k in data.files}

    @staticmethod
    def record(img):
        time.sleep(AT_RECORD_SLEEP_S)
        return img


def pool_bytes() -> dict:
    """Bytes of device memory each private pool (CUDA graph pool) holds,
    from the allocator's snapshot; {} where it does not say."""
    import collections

    import torch

    out = collections.Counter()
    for seg in torch.cuda.memory_snapshot():
        pool = seg.get("segment_pool_id")
        if pool is not None and tuple(pool) != (0, 0):
            out[tuple(pool)] += seg["total_size"]
    return dict(out)


def ladder_launches() -> int:
    """The fused Adam launches of the K ladder's warmups: each warmup at K
    dispatches the K=1 step and the K-step one once (one dispatch when K
    is 1), each step one launch, whether the dispatch is a capture's eager
    run or a replay."""
    return sum(sum({1, k}) for k in AT_K_LADDER)


def image_plane_launches() -> int:
    """The fused Adam launches the phase's fits must make, one a step:
    the warmup's step and an epoch of each ResNet-50 fit from the npz
    shards (prefetch off, DP_WORKERS workers, the f32 yardstick), one
    epoch under another transform, the warmup's step and an epoch of each
    TFRecord fit (off, one worker), the autotuned and the untuned LeNet-5,
    and the K ladder's warmups."""
    npz = DP_SHARDS * DP_PER_SHARD // RESNET_BATCH
    tfr = DP_TF_SHARDS * DP_TF_PER_SHARD // RESNET_BATCH
    lenet = AT_EPOCHS * AT_SHARDS * AT_PER_SHARD // AT_BATCH
    return (3 * (npz + 1) + npz + 2 * (tfr + 1) + 2 * lenet
            + ladder_launches())


def autotune_lenet(tmp, card_line) -> int:
    """(d): LeNet-5 under Adam from npz shards with a slow loader, through
    ``fit(autotune=True)``: the loss trajectory equals the untuned K=1
    fit's; the zoo_autotune_* gauges, the decision log, the K values
    captured and the graph pools' bytes.  Then one capture at each K of
    the ladder through ``warmup`` and the reserved bytes each adds.
    Returns the fused Adam launches."""
    import os

    import torch

    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.feature.autotune import AutotuneController
    from analytics_zoo_tpu_torch.feature.common import FnPreprocessing
    from analytics_zoo_tpu_torch.feature.dataset import FeatureSet
    from analytics_zoo_tpu_torch.metrics import get_registry, prometheus_text
    from analytics_zoo_tpu_torch.models import build_lenet
    from analytics_zoo_tpu_torch.ops.cuda import fused_adam as fad

    gen = np.random.default_rng(SEED + 232)
    paths = []
    for i in range(AT_SHARDS):
        path = os.path.join(tmp, f"lenet-{i:02d}.npz")
        np.savez(path, x=gen.integers(0, 256, (AT_PER_SHARD, 28, 28, 1),
                                      dtype=np.uint8),
                 y=gen.integers(0, 10, AT_PER_SHARD).astype(np.int32))
        paths.append(path)

    def fit(autotune):
        ctx = init_zoo_context({"autotune_interval": 0.05}, seed=SEED,
                               device="cuda")
        net = build_lenet()
        net.build_params(rng=torch.Generator().manual_seed(SEED),
                         device=ctx.device)
        net.compile(optimizer="adam",
                    loss="sparse_categorical_crossentropy")
        fs = FeatureSet.from_shards(paths, "DISK_2", loader=_SlowShards.load)
        fs = fs.transform(FnPreprocessing(_SlowShards.record))
        fs = fs.transform_on_device(
            lambda b: {**b, "x": b["x"].float() * (1.0 / 255)})
        ctrl = AutotuneController.from_config(ctx.config) if autotune \
            else False
        before = fad.launch_count
        t0 = time.perf_counter()
        net.fit(fs, batch_size=AT_BATCH, nb_epoch=AT_EPOCHS, autotune=ctrl)
        torch.cuda.synchronize()
        return (net, ctrl, fad.launch_count - before,
                time.perf_counter() - t0)

    plain, _, l_plain, s_plain = fit(False)
    tuned, ctrl, l_tuned, s_tuned = fit(True)
    ctrl.stop()
    steps = AT_EPOCHS * AT_SHARDS * AT_PER_SHARD // AT_BATCH
    same = plain._estimator.loss_log == tuned._estimator.loss_log
    gauges = [line for line in prometheus_text(get_registry()).splitlines()
              if line.startswith("zoo_autotune")]
    est = tuned._estimator
    ks = sorted(k[0] for k in est._steps if k[0] is not None)
    pools = pool_bytes()
    log(f"image data plane (d): autotuned LeNet-5 over {steps} steps "
        f"({s_tuned:.1f} s, untuned {s_plain:.1f} s): loss trajectory "
        f"equal to K=1's {same}; Adam launches {l_tuned} / {l_plain}; "
        f"controller {ctrl.current()}")
    log(f"image data plane (d): gauges {gauges}")
    log(f"image data plane (d): decisions "
        + json.dumps([{k: d[k] for k in ('knob', 'old', 'new', 'reason')}
                      for d in ctrl.decision_log()]))
    log(f"image data plane (d): K values captured {ks}; graph pools' bytes "
        f"{sorted(pools.values()) if pools else 'not reported'}")
    if not same or l_tuned != steps or l_plain != steps:
        raise AssertionError("the autotuned fit is not the K=1 fit")
    sizes = {}
    warm = build_lenet()
    warm.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    warm.build_params()
    warm._estimator = warm._make_estimator()
    batch = {"x": np.zeros((AT_BATCH, 28, 28, 1), np.float32),
             "y": np.zeros(AT_BATCH, np.int32)}
    before = fad.launch_count
    for k in AT_K_LADDER:
        torch.cuda.synchronize()
        pools = pool_bytes()
        warm._estimator.warmup(batch, steps_per_dispatch=k)
        torch.cuda.synchronize()
        sizes[k] = sum(b for p, b in pool_bytes().items() if p not in pools)
    warm_launches = fad.launch_count - before
    log(f"image data plane (d): bytes of the graph pool each K's capture "
        f"through warmup makes: {sizes}; its {warm_launches} Adam launches, "
        f"expected {ladder_launches()} ({card_line})")
    if warm_launches != ladder_launches():
        raise AssertionError(f"the K ladder's warmups: {warm_launches} "
                             f"Adam launches, expected {ladder_launches()}")
    launched = l_plain + l_tuned + warm_launches
    del plain, tuned, warm
    return launched


def image_classifier_check(card_line: str) -> None:
    """(e): ImageClassifier("resnet-50") answers predict_image_set on 32
    seeded uint8 (300, 300, 3) images through its default chain (resize
    256, center crop 224, ImageChannelNormalize on the native library):
    the top-5 labels equal those of the same weights on the CPU and the
    probabilities within CLF_PROB_TOL.  The moving statistics are set to
    the batch's first (recalibrate_batchnorm), so the softmax is not
    saturated."""
    import torch

    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.common.utils import tree_map
    from analytics_zoo_tpu_torch.feature.image import ImageSet
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.normalization \
        import recalibrate_batchnorm
    from analytics_zoo_tpu_torch.models.image.imageclassification import (
        ImageClassifier,
    )

    try:
        import cv2
        path = f"cv2 {cv2.__version__}"
    except ImportError:
        path = "numpy (no cv2 on this host)"
    try:
        import PIL
        pil = f"PIL {PIL.__version__} importable"
    except ImportError:
        pil = "no PIL on this host"
    gen = np.random.default_rng(SEED + 233)
    images = ImageSet.from_arrays(
        gen.integers(0, 256, (CLF_IMAGES, CLF_SIDE, CLF_SIDE, 3),
                     dtype=np.uint8))
    init_zoo_context(seed=SEED, device="cuda")
    clf = ImageClassifier("resnet-50")
    t0 = time.perf_counter()
    x = images.transform(clf.config.preprocessing()).to_feature_set().xs[0]
    chain_ms = (time.perf_counter() - t0) * 1e3 / CLF_IMAGES
    clf.model.build_params()
    recalibrate_batchnorm(clf.model, x)
    clf.predict_image_set(images)  # the capture of the request
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = clf.predict_image_set(images)
    pred_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    clf.model.predict(x, batch_size=CLF_IMAGES)
    fwd_ms = (time.perf_counter() - t0) * 1e3
    init_zoo_context(seed=SEED, device="cpu")
    ref = ImageClassifier("resnet-50")
    ref.model.device = torch.device("cpu")
    ref.model.params = tree_map(lambda t: t.cpu(), clf.model.params)
    ref.model.state = tree_map(lambda t: t.cpu(), clf.model.state)
    want = ref.predict_image_set(images)
    labels = [[n for n, _ in row] for row in got] == \
        [[n for n, _ in row] for row in want]
    err = max(abs(p - q) for g, w in zip(got, want)
              for (_, p), (_, q) in zip(g, w))
    log(f"image data plane (e): ImageClassifier('resnet-50') on "
        f"{CLF_IMAGES} {CLF_SIDE}x{CLF_SIDE} images: the chain (resize by "
        f"{path}, crop, native normalize; {pil}) {chain_ms:.2f} ms an image "
        f"on the host; predict_image_set {pred_ms:.1f} ms, of it the "
        f"model's predict {fwd_ms:.1f} ms; top-5 labels equal the "
        f"CPU's {labels}, probabilities within {err:.2e} (tol "
        f"{CLF_PROB_TOL:g}); top-1 of the first {got[0][0]} ({card_line})")
    init_zoo_context(seed=SEED, device="cuda")
    if not labels or err > CLF_PROB_TOL:
        raise AssertionError("ImageClassifier on the card disagrees with "
                             "the CPU")


def image_data_plane_phase(card_line: str) -> dict:
    """The host data plane and ImageClassifier on the card: (a) the native
    host library, (b) stream identity serial against prefetched, (c)
    ResNet-50 bf16 under Adam from uint8 npz and TFRecord shards with the
    normalization inside the captured step, (d) autotune on LeNet-5, (e)
    ImageClassifier against the CPU.  Returns the phase's launch counts
    (fused Adam: one a step of every fit)."""
    import tempfile

    from analytics_zoo_tpu_torch.feature.image import (
        ImageHFlip,
        ImageRandomCrop,
    )

    t_phase = time.perf_counter()
    parts = {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        parts[name] = round(time.perf_counter() - t0, 1)
        return out

    free_device_memory("before image_data_plane")
    part("native", native_checks, card_line)
    reset_counters()  # the data plane's fits: from here to the read below
    with tempfile.TemporaryDirectory() as tmp:
        gen = np.random.default_rng(SEED + 234)
        npz, tfr, x, y = part("write", write_image_shards, tmp, gen)
        log(f"image data plane: wrote {len(npz)} npz shards "
            f"({x.nbytes} B of uint8 images) and {len(tfr)} TFRecord "
            f"shards in {parts['write']} s")
        chain = (ImageRandomCrop(*RESNET_SHAPE[:2]), ImageHFlip())
        disk2, tf_set = part("streams", stream_identity, npz, tfr, chain,
                             card_line)
        adam = part("resnet", resnet_from_shards, disk2, tf_set, chain, x,
                    y, card_line)
        adam += part("autotune", autotune_lenet, tmp, card_line)
    launches = counters()  # end of the data plane's fits
    if adam != image_plane_launches():
        raise AssertionError(f"image_data_plane: {adam} Adam launches "
                             f"counted by its fits, expected "
                             f"{image_plane_launches()}")
    expect_launches("image_data_plane", launches,
                    fused_adam=image_plane_launches())
    part("classifier", image_classifier_check, card_line)
    free_device_memory("after image_data_plane")
    log(f"phase image_data_plane: {time.perf_counter() - t_phase:.1f} s "
        f"(seconds by part: {parts})")
    return launches


# the serving fleet plane: a ModelRouter of two tenants (thread replicas)
# and a process-mode fleet scraped into an SLO engine
ROUTER_RECORDS = 128         # a tenant's overload wave
ROUTER_FIRST = 96            # the wave's first burst; the rest after a pause
ROUTER_BATCH = 8
ROUTER_SPECS = "bert=100,ssd=400"   # name=slo_p99_ms (ZOO_SERVING_MODELS)
ROUTER_MAX_REPLICAS = 3
ROUTER_INTERVAL = 0.1        # seconds a fleet and router tick
ROUTER_BACKLOG = 64          # admission's backlog limit a tenant
ROUTER_IDLE_S = 20.0         # the longest idle gap to wait for scale-down
SSD_SHAPE = (300, 300, 3)
VOC_NAMES = ("aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car",
             "cat", "chair", "cow", "diningtable", "dog", "horse",
             "motorbike", "person", "pottedplant", "sheep", "sofa", "train",
             "tvmonitor")


class BucketLog:
    """A replica's view of a tenant's shared ``InferenceModel``: notes the
    micro-batch size each record was predicted in (by the digest of its
    bytes) and counts the predict calls, for every replica of the tenant."""

    def __init__(self, model, sizes, calls):
        import threading

        self.model, self.sizes, self.calls = model, sizes, calls
        self._lock = threading.Lock()

    def predict(self, x, batch_size=None):
        with self._lock:
            self.calls.append(len(x))
            for row in x:
                self.sizes[digest(row)] = len(x)
        return self.model.predict(x, batch_size=batch_size)


def offer_wave(name, inq, records, prefix, t_enq, rejections, pause):
    """Enqueue ``records`` under ``prefix-i`` in two bursts (ROUTER_FIRST,
    then the rest after ``pause`` seconds); a record the front door sheds
    raises the typed ``ServingRejected`` at enqueue, is noted and offered
    again after its retry-after hint (at most 0.2 s)."""
    from analytics_zoo_tpu_torch.serving import ServingRejected

    for i, rec in enumerate(records):
        if i == ROUTER_FIRST:
            time.sleep(pause)
        uri = f"{prefix}-{i}"
        while True:
            try:
                inq.enqueue(uri, rec)
            except ServingRejected as e:
                rejections.append((name, e.reason, e.retry_after_s))
                time.sleep(min(max(e.retry_after_s, 0.005), 0.2))
                continue
            t_enq[uri] = time.perf_counter()
            break


def changes(samples) -> list:
    """(seconds, value) change points of a sampled series."""
    out = []
    for t, v in samples:
        if not out or out[-1][1] != v:
            out.append((round(t, 2), v))
    return out


def fleet_host_split(tag, server, records, db, batch, owner) -> None:
    """A tenant's host time by stage for ``records`` on a stream of their
    own: the broker claim (``claim``), the decode, ``predict`` of each
    micro-batch of ``batch`` (what the ``zoo.serving.predict`` span holds)
    and the batched write-back (``hset_many``) with the release."""
    from analytics_zoo_tpu_torch.serving.client import (
        RESULT_PREFIX,
        encode_ndarray,
    )

    for i, r in enumerate(records):
        db.xadd("split", {"uri": f"split-{i}", "image": encode_ndarray(r)})
    t0 = time.perf_counter()
    recs = db.claim("split", owner, len(records), lease_ms=60_000)
    claim = time.perf_counter() - t0
    t0 = time.perf_counter()
    uris, arrs = server._decode_records(recs)
    decode = time.perf_counter() - t0
    predict, outs = 0.0, []
    for i in range(0, len(arrs), batch):
        t0 = time.perf_counter()
        outs.extend(server.model.predict(np.stack(arrs[i:i + batch])))
        predict += time.perf_counter() - t0
    t0 = time.perf_counter()
    writes = [(RESULT_PREFIX + u, server._postprocess(u, o))
              for u, o in zip(uris, outs)]
    db.hset_many(writes)
    db.release("split", owner, [r[0] for r in recs], done=True)
    write = time.perf_counter() - t0
    for key, _ in writes:
        db.delete(key)
    log(f"fleet_router {tag} host split for {len(records)} records: claim "
        f"{claim * 1e3:.1f} ms, decode {decode * 1e3:.1f} ms "
        f"({decode / len(records) * 1e3:.3f} ms a record), predict "
        f"{predict * 1e3:.1f} ms ({-(-len(records) // batch)} micro-batches "
        f"of {batch}), encode + write-back + release {write * 1e3:.1f} ms")


def router_tenants(gen):
    """The two tenants' shared models and waves: BERT-base f32 over token
    ids (``bert_tokens_model``, 512 tokens) and SSD300-VGG16 with the 20
    VOC classes, f32, each in an ``InferenceModel`` warmed up at the
    bucket of ROUTER_BATCH; ROUTER_RECORDS records each."""
    import torch

    from analytics_zoo_tpu_torch.models.image.objectdetection import (
        ObjectDetector,
    )
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

    bert = bert_tokens_model()
    bert.build_params()
    det = ObjectDetector("ssd-vgg16-300", class_names=VOC_NAMES)
    det.model.build_params()
    models = {"bert": InferenceModel().from_keras_net(bert),
              "ssd": InferenceModel().from_keras_net(det.model)}
    records = {
        "bert": list(gen.integers(1, BERT_BASE["vocab"],
                                  (ROUTER_RECORDS, SEQ)).astype(np.int32)),
        "ssd": list(gen.uniform(-1.0, 1.0, (ROUTER_RECORDS,) + SSD_SHAPE)
                    .astype(np.float32))}
    buckets = [b for b in (1, 2, 4, 8, 16) if b <= ROUTER_BATCH]
    for name, im in models.items():
        pools, t0 = pool_bytes(), time.perf_counter()
        im.warmup([records[name][0].shape],
                  dtype=[records[name][0].dtype], batch_sizes=buckets)
        torch.cuda.synchronize()
        grown = sum(v - pools.get(k, 0) for k, v in pool_bytes().items())
        log(f"fleet_router: {name} warmed up (captured) at buckets "
            f"{buckets} in {time.perf_counter() - t0:.1f} s; its graph pool "
            f"{grown} B (thread replicas share these captures: no pool "
            f"bytes per replica)")
    return models, records, det


def check_tenant_answers(name, answers, uris, records, want, sizes):
    """BERT's top-2 answers (classes equal, probabilities bit for bit in
    the direct bucket, else within CS_TOL) through ``check_answers``;
    SSD's raw (8732, 25) tensors bit for bit where the record was served
    in a micro-batch of ROUTER_BATCH (the direct bucket), else within
    CS_TOL of the answer's largest magnitude."""
    if name == "bert":
        return check_answers(name, answers, uris, records, want, sizes,
                             ROUTER_BATCH, 2, prefix="fleet_router")
    same, worst = 0, 0.0
    for uri, rec, row in zip(uris, records, want):
        got = np.asarray(answers[uri])
        if got.shape != row.shape or not np.isfinite(got).all():
            raise AssertionError(f"fleet_router ssd: {uri} answer "
                                 f"{got.shape} is not {row.shape}, finite")
        diff = float(np.abs(got - row).max() / max(np.abs(row).max(),
                                                     1e-30))
        worst = max(worst, diff)
        if sizes[digest(rec)] == ROUTER_BATCH:
            same += 1
            if not np.array_equal(got, row):
                raise AssertionError(f"fleet_router ssd: {uri} served in the "
                                     f"direct bucket differs by {diff}")
        elif not diff <= CS_TOL:
            raise AssertionError(f"fleet_router ssd: {uri} differs by "
                                 f"{diff} (tol {CS_TOL:g})")
    log(f"fleet_router ssd: raw outputs equal direct predict's; {same} of "
        f"{len(uris)} records in its bucket, bit for bit; largest "
        f"difference {worst:.3e} of the answer's largest magnitude")
    return same, worst


def fleet_router_phase(card_line: str) -> dict:
    """The serving fleet plane's main path on the card: a ``ModelRouter``
    built by ``from_config`` from ``ZOO_SERVING_MODELS``-style specs
    (ROUTER_SPECS), ``admission=True`` and the ``fleet_*`` knobs, over an
    ``InMemoryBroker`` in thread mode, serving two tenants at full width:
    ``bert`` (BERT-base f32, 512 tokens) and ``ssd`` (SSD300-VGG16, the
    20 VOC classes, f32), batch ROUTER_BATCH, 1 to ROUTER_MAX_REPLICAS
    replicas each, every replica of a tenant on one shared
    ``InferenceModel``.  Each tenant gets an overload wave of
    ROUTER_RECORDS records (two bursts, both tenants at once, under a
    torch.profiler trace of the card), then an idle gap until both fleets
    are back at one replica.

    Checks: every accepted record answered exactly once (the serve log,
    the answers, the empty streams); each answer equal to direct
    ``predict`` at ROUTER_BATCH (``check_tenant_answers``); rejections
    only the typed ``ServingRejected``; each scaler scaled up and back
    down; 12 flash forwards a BERT predict call.  Logs records/s against
    direct predict, enqueue-to-result p50 / p99, the replica counts over
    time, the scalers' and router's decisions, the admission verdicts, the
    served window's idle share and each tenant's host split.  Returns the
    path's launch counts."""
    import os
    import shutil
    import tempfile
    import threading

    import torch
    from torch.profiler import ProfilerActivity, profile

    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.common.engine import ZooConfig
    from analytics_zoo_tpu_torch.serving import (
        ClusterServingHelper,
        InMemoryBroker,
        InputQueue,
        ModelRouter,
        OutputQueue,
    )

    t_phase = time.perf_counter()
    free_device_memory("before fleet_router")
    init_zoo_context(seed=SEED, device="cuda")
    gen = np.random.default_rng(SEED + 240)
    models, records, _ = router_tenants(gen)
    sizes = {n: {} for n in models}
    calls = {n: [] for n in models}
    tmp = tempfile.mkdtemp(prefix="zoo-fleet-router-")
    serve_log = os.path.join(tmp, "serve.log")
    cfg = ZooConfig(serving_models=ROUTER_SPECS, admission=True,
                    fleet_min_replicas=1,
                    fleet_max_replicas=ROUTER_MAX_REPLICAS,
                    fleet_interval=ROUTER_INTERVAL)
    db = InMemoryBroker()

    def helper(spec, verdict):
        return ClusterServingHelper(
            batch_size=ROUTER_BATCH, top_n=2 if spec.name == "bert" else 0,
            data_shape=records[spec.name][0].shape, log_dir=tmp)

    router = ModelRouter.from_config(
        cfg, db, model_factory=lambda spec: BucketLog(
            models[spec.name], sizes[spec.name], calls[spec.name]),
        helper_factory=helper, serve_log=serve_log,
        admission_kwargs={"backlog_limit": ROUTER_BACKLOG,
                          "interval": ROUTER_INTERVAL / 5})
    t_enq, t_done, answers, rejections = {}, {}, {}, []
    replicas = {n: [] for n in models}
    stop = threading.Event()
    try:
        router.start()
        t0 = [time.perf_counter()]  # the wave's start, set below

        def monitor():
            while not stop.is_set():
                now = time.perf_counter() - t0[0]
                for n in models:
                    replicas[n].append(
                        (now, router.controller(n).replica_count()))
                time.sleep(0.02)

        def collect(want):
            oq = OutputQueue(broker=db)
            while len(answers) < want and not stop.is_set():
                got = oq.dequeue()
                now = time.perf_counter()
                for uri, res in got.items():
                    if uri in answers:
                        raise AssertionError(f"fleet_router: {uri} "
                                             "answered twice")
                    answers[uri], t_done[uri] = res, now
                time.sleep(0.002)

        threads = [threading.Thread(target=monitor, daemon=True),
                   threading.Thread(target=collect, daemon=True,
                                    args=(2 * ROUTER_RECORDS,))]
        threads += [threading.Thread(
            target=offer_wave, daemon=True,
            args=(n, InputQueue(broker=db, model=n), records[n], n, t_enq,
                  rejections, 2 * ROUTER_INTERVAL / 5)) for n in models]
        reset_counters()  # the router's served path: to the read below
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t_wave = t0[0] = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads[1:]:
                th.join(timeout=CS_TIMEOUT)
            t_last = time.perf_counter()
            torch.cuda.synchronize()
        launches = counters()  # end of the router's served path
        if len(answers) != 2 * ROUTER_RECORDS:
            raise AssertionError(f"fleet_router: {len(answers)} of "
                                 f"{2 * ROUTER_RECORDS} records answered")
        deadline = time.perf_counter() + ROUTER_IDLE_S
        while time.perf_counter() < deadline and any(
                router.controller(n).replica_count() > 1 for n in models):
            time.sleep(0.05)
        router.tick()
        final = {n: router.controller(n).replica_count() for n in models}
        decisions = {n: router.controller(n).decision_log() for n in models}
        admitted = {n: router.admission(n).decision_log() for n in models}
        router_log = router.decision_log()
        leftover = {n: db.xlen(router.tenant(n).stream) for n in models}
    finally:
        stop.set()
        router.stop()
    busy_us, n_spans = device_union_us(cuda_spans(prof))
    window_ms = (t_last - t_wave) * 1e3
    log(f"fleet_router: served window {window_ms:.1f} ms for "
        f"{2 * ROUTER_RECORDS} records of two tenants; device busy "
        f"{busy_us / 1e3:.1f} ms ({n_spans} traced kernels and copies): idle "
        + (f"{max(0.0, 1 - busy_us / 1e3 / window_ms):.1%}" if n_spans
           else "not measured (the trace shows no device activity)")
        + f" ({card_line})")
    with open(serve_log) as f:
        lines = [ln.split() for ln in f.read().splitlines()]
    served = sorted(u for _, u in lines)
    if served != sorted(answers) or leftover != {n: 0 for n in models}:
        raise AssertionError(f"fleet_router: the serve log is not each "
                             f"accepted uri once ({len(served)} lines, "
                             f"{len(answers)} answers; left {leftover})")
    for n in models:
        uris = [f"{n}-{i}" for i in range(ROUTER_RECORDS)]
        want = models[n].predict(np.stack(records[n]),
                                 batch_size=ROUTER_BATCH)
        check_tenant_answers(n, answers, uris, records[n], want, sizes[n])
        lat = np.array([t_done[u] - t_enq[u] for u in uris]) * 1e3
        span = max(t_done[u] for u in uris) - min(t_enq[u] for u in uris)
        rate = direct_rate(models[n], np.stack(records[n]), ROUTER_BATCH,
                           card_line, n, prefix="fleet_router")
        owners = sorted({o for o, u in lines if u.startswith(n + "-")})
        log(f"fleet_router {n}: {ROUTER_RECORDS} records in "
            f"{span * 1e3:.1f} ms = {ROUTER_RECORDS / span:.1f} records/s "
            f"against direct predict's {rate:.1f} "
            f"({ROUTER_RECORDS / span / rate:.2f}x); enqueue-to-result p50 "
            f"{np.percentile(lat, 50):.1f} ms, p99 "
            f"{np.percentile(lat, 99):.1f} ms; {len(calls[n])} predict calls "
            f"(micro-batches {sorted(set(calls[n]))}); served by "
            f"{len(owners)} replicas; replica counts over time (s, n) "
            f"{changes(replicas[n])} ({card_line})")
        log(f"fleet_router {n} scaler decisions: " + "; ".join(
            f"{d['action']} {d['old']}->{d['new']} {d['reason']} est_p99 "
            f"{d['est_p99_ms']} ms depth {d['queue_depth']}"
            for d in decisions[n]))
        log(f"fleet_router {n} admission verdicts: " + "; ".join(
            f"{d['state']} ({d['reason']}) backlog {d['backlog']} retry "
            f"{d['retry_after_ms']} ms" for d in admitted[n])
            + f"; {sum(1 for r in rejections if r[0] == n)} offers refused "
            f"with ServingRejected")
        acts = [d["action"] for d in decisions[n]]
        if "up" not in acts or final[n] != 1 or "down" not in acts:
            raise AssertionError(f"fleet_router {n}: the scaler did not "
                                 f"scale up and back down: {acts}")
    log("fleet_router router decisions: " + "; ".join(
        f"{d['model']} {d['action']}" + (f" {d.get('old')}->{d.get('new')}"
                                         if d["action"] == "scale" else "")
        for d in router_log))
    expect_launches("fleet_router", launches,
                    flash_attention_fwd=BERT_BASE["n_block"]
                    * len(calls["bert"]))
    log(f"fleet_router launches {launches}: "
        f"{BERT_BASE['n_block']} flash forwards x {len(calls['bert'])} "
        f"BERT predict calls")
    init_zoo_context(seed=SEED, device="cuda")
    fleet_host_split("bert", _split_server(models["bert"], tmp),
                     records["bert"][:2 * ROUTER_BATCH], InMemoryBroker(),
                     ROUTER_BATCH, "split-bert")
    fleet_host_split("ssd", _split_server(models["ssd"], tmp),
                     records["ssd"][:2 * ROUTER_BATCH], InMemoryBroker(),
                     ROUTER_BATCH, "split-ssd")
    shutil.rmtree(tmp, ignore_errors=True)
    del models, router
    free_device_memory("after fleet_router")
    log(f"phase fleet_router: {time.perf_counter() - t_phase:.1f} s")
    return launches


def _split_server(model, tmp):
    from analytics_zoo_tpu_torch.serving import ClusterServing, InMemoryBroker

    return ClusterServing(model=model, broker=InMemoryBroker(),
                          batch_size=ROUTER_BATCH, log_dir=tmp)


PROC_WAVE = 96               # records of the warm and the SIGKILL waves
PROC_TIMED = 384             # records of a timed wave
PROC_REPEATS = 3             # timed waves with two and with one process
PROC_LEASE_MS = 3000
PROC_SCRAPE_S = 0.5          # the scraper's poll interval
PROC_STALE_S = 2.0           # a target is stale after this long unanswered
PROC_SPAWN_S = 240.0         # the longest a replica may take to answer
PROC_BACKEND = "kernel"      # zoo_kernel_invocations' backend of a launch


def sample_value(store_or_samples, name, **labels) -> float | None:
    """The value of one sample of a scraped snapshot (a list of mergeable
    samples), or None."""
    for s in store_or_samples:
        if s["name"] == name and all(
                (s.get("labels") or {}).get(k) == v
                for k, v in labels.items()):
            return s.get("value", s.get("count"))
    return None


def replica_snapshots(scraper) -> dict:
    """Each target's latest ``/telemetryz`` samples, pulled directly."""
    import json
    import urllib.request

    out = {}
    for name, tgt in scraper.healthz()["targets"].items():
        try:
            with urllib.request.urlopen(tgt["url"] + "/telemetryz",
                                        timeout=5) as r:
                out[name] = json.loads(r.read().decode())["samples"]
        except OSError:
            out[name] = None
    return out


def same_top(a, b) -> bool:
    """Two top-N answers ([[class, prob], ...]) agree: the same classes,
    the probabilities within CS_TOL."""
    return [c for c, _ in a] == [c for c, _ in b] and all(
        abs(p - q) <= CS_TOL for (_, p), (_, q) in zip(a, b))


def process_wave(tag, inq, oq, ids, prefix, answered, card_line,
                 during=None, linger=0.0, twice=None) -> tuple[dict, float]:
    """Enqueue ``ids`` under ``prefix-i`` while ``during()`` (if given)
    runs on a thread of its own, collect every answer once it has
    returned and the records are enqueued, then go on dequeuing for
    ``linger`` seconds after the last.  An answer to a uri of another wave
    raises, and so does one to a uri already answered (in this wave or in
    ``answered``) unless ``twice`` (a dict) is given, the uri is in
    ``twice["allowed"]`` and the two answers agree (:func:`same_top`);
    such a uri is added to ``twice["seen"]``.  Returns {uri: answer} and
    the records/s from the first enqueue to the last answer."""
    import threading

    want = {f"{prefix}-{i}" for i in range(len(ids))}
    got = {}

    def take():
        for uri, res in oq.dequeue().items():
            first = got.get(uri, answered.get(uri))
            if first is not None:
                if twice is None or uri not in twice["allowed"] \
                        or not same_top(first, res):
                    raise AssertionError(f"fleet_process {tag}: {uri} "
                                         f"answered twice: {first}, {res}")
                twice["seen"].append(uri)
                continue
            if uri not in want:
                raise AssertionError(f"fleet_process {tag}: an answer to "
                                     f"{uri}, not of this wave")
            got[uri] = res

    failed = []

    def run_during():
        try:
            during()
        except BaseException as e:  # raised again below
            failed.append(e)

    side = threading.Thread(target=run_during, daemon=True) \
        if during is not None else None
    if side is not None:
        side.start()
    t0 = time.perf_counter()
    for i, rec in enumerate(ids):
        inq.enqueue(f"{prefix}-{i}", rec)
    if side is not None:
        side.join()
        if failed:
            raise failed[0]
    deadline = t0 + CS_TIMEOUT
    while len(got) < len(ids) and time.perf_counter() < deadline:
        take()
        time.sleep(0.005)
    span = time.perf_counter() - t0
    if len(got) != len(ids):
        raise AssertionError(f"fleet_process {tag}: {len(got)} of "
                             f"{len(ids)} answered")
    end = time.perf_counter() + linger
    while time.perf_counter() < end:
        take()
        time.sleep(0.05)
    log(f"fleet_process {tag}: {len(ids)} records in {span * 1e3:.1f} ms "
        f"from the first enqueue to the last answer = "
        f"{len(ids) / span:.1f} records/s"
        + (f"; dequeued {linger:.1f} s more" if linger else "")
        + f" ({card_line})")
    return got, len(ids) / span


def claimed_uris(sdir, owner) -> set:
    """The uris of the records ``owner`` holds claims on in a
    ``FileBroker`` stream directory (``.c-<rid>.json`` next to
    ``<rid>.json``); a claim or record that goes while the directory is
    read (a batch being committed or requeued) is left out."""
    import os

    out = set()
    for n in os.listdir(sdir):
        if not (n.startswith(".c-") and n.endswith(".json")):
            continue
        try:
            with open(os.path.join(sdir, n)) as f:
                if owner not in f.read():
                    continue
            with open(os.path.join(sdir, n[3:])) as f:
                out.add(json.load(f)["uri"])
        except (OSError, ValueError, KeyError):
            continue
    return out


def fleet_process_phase(card_line: str) -> dict:
    """A process-mode fleet on the card: ``FleetController(mode="process")``
    over a ``FileBroker`` with 2 replicas (``python -m
    analytics_zoo_tpu_torch.serving.fleet --replica --metrics-port 0``,
    each its own CUDA context on the card) serving a BERT-base f32 (512
    tokens, batch 8) saved to a temporary directory; a ``VarzScraper`` over
    ``fleet_varz_targets`` fills a ``TimeSeriesStore`` and a
    ``TelemetryAggregator``, ticks an ``SloEngine(default_slos(...))``, and
    a ``FederatedSignalSource`` feeds the controller's scaler.

    Sequence: spawn and a probe record (seconds from spawn to the first
    answer, the kernels found built: each replica's
    ``zoo_compile_cache_hits_total{label=kernel_flash_attention_fwd}`` is
    1, a library an nvcc run built would record no hit); a warm wave and
    PROC_REPEATS timed waves of PROC_TIMED records with two replicas; a
    wave during which one replica is killed with SIGKILL while it holds
    claims (the survivor serves its records after the lease expires; the
    phase dequeues one lease longer); PROC_REPEATS timed waves with the
    one survivor; then a supervision tick replaces the dead replica.
    Checks: every record answered once (an answer twice raises), the
    serve log each uri at most once and every uri but those the victim
    held claims on when it was killed; the dead target stale in the
    scraper's
    ``/healthz`` rollup and in the aggregator; a live replica's flash
    launches 12 a predict call.  Logs records/s with two and one process,
    each process's device memory and the alert transitions.  Returns the
    replicas' flash launches (their scraped ``zoo_kernel_invocations``)."""
    import os
    import shutil
    import signal
    import tempfile

    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.metrics import (
        MetricsServer,
        SloEngine,
        TelemetryAggregator,
        TimeSeriesStore,
        VarzScraper,
        default_slos,
        fleet_varz_targets,
    )
    from analytics_zoo_tpu_torch.metrics.health import HealthRegistry
    from analytics_zoo_tpu_torch.serving import (
        ClusterServingHelper,
        FileBroker,
        FleetController,
        InputQueue,
        OutputQueue,
        SloScaler,
    )
    from analytics_zoo_tpu_torch.serving.client import INPUT_STREAM
    from analytics_zoo_tpu_torch.serving.scaler import FederatedSignalSource

    t_phase = time.perf_counter()
    free_device_memory("before fleet_process")
    init_zoo_context(seed=SEED, device="cuda")
    tmp = tempfile.mkdtemp(prefix="zoo-fleet-process-")
    path = os.path.join(tmp, "bert_base.model")
    net = bert_tokens_model()
    net.build_params()
    net.save(path)
    del net
    free_device_memory("fleet_process: model saved")
    spool = os.path.join(tmp, "spool")
    db = FileBroker(spool)
    serve_log = os.path.join(tmp, "serve.log")
    gen = np.random.default_rng(SEED + 250)
    health = HealthRegistry()
    store, agg = TimeSeriesStore(), TelemetryAggregator(
        stale_after=PROC_STALE_S)
    engine = SloEngine(store, default_slos(
        slo_p99_ms=500.0, heartbeat_stale_s=PROC_STALE_S, short_window=2.0,
        long_window=6.0))
    scraper = VarzScraper(aggregator=agg, store=store, engine=engine,
                          interval=PROC_SCRAPE_S, stale_after=PROC_STALE_S,
                          health=health, discover=fleet_varz_targets(db))
    helper = ClusterServingHelper(
        model_path=path, batch_size=CS_BERT_BATCH, top_n=2,
        data_shape=(SEQ,), lease_ms=PROC_LEASE_MS, log_dir=tmp)
    ctrl = FleetController(
        helper, "dir:" + spool, mode="process", serve_log=serve_log,
        scaler=SloScaler(slo_p99_ms=500.0, min_replicas=2, max_replicas=2),
        interval=3600.0, replica_metrics=True,
        signal_source=FederatedSignalSource(store, db, INPUT_STREAM,
                                            scraper=scraper))
    inq, oq = InputQueue(broker=db), OutputQueue(broker=db)
    # the replicas log into the phase's directory and import the package
    # from this checkout whatever their working directory
    root = os.path.dirname(os.path.abspath(__file__))
    env = {"ZOO_SERVING_LOG_DIR": tmp,
           "PYTHONPATH": os.pathsep.join(
               p for p in (root, os.environ.get("PYTHONPATH")) if p)}
    env_saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    answered = {}
    try:
        t0 = time.perf_counter()
        ctrl.start()
        inq.enqueue("probe-0", np.asarray(gen.integers(
            1, BERT_BASE["vocab"], SEQ), np.int32))
        while not answered and time.perf_counter() - t0 < PROC_SPAWN_S:
            answered.update(oq.dequeue())
            time.sleep(0.01)
        first = time.perf_counter() - t0
        if not answered:
            raise AssertionError("fleet_process: no replica answered")
        deadline = time.perf_counter() + PROC_SPAWN_S
        while len(fleet_varz_targets(db)()) < 2 \
                and time.perf_counter() < deadline:
            time.sleep(0.1)
        scraper.poll_once()
        scraper.start()
        log(f"fleet_process: spawn to the first answer {first:.1f} s (a "
            f"warm replica: torch, the saved model, the kernel libraries "
            f"found built, the probe's bucket captured) ({card_line})")
        owners = ctrl.owners()

        def wave(tag, prefix, n, during=None, linger=0.0, twice=None):
            ids = list(gen.integers(1, BERT_BASE["vocab"], (n, SEQ))
                       .astype(np.int32))
            got, rate = process_wave(tag, inq, oq, ids, prefix, answered,
                                     card_line, during, linger, twice)
            answered.update(got)
            return rate

        def timed(tag, prefix):
            rates = [wave(f"{tag}, wave {i + 1} of {PROC_REPEATS}",
                          f"{prefix}{i}", PROC_TIMED)
                     for i in range(PROC_REPEATS)]
            log(f"fleet_process {tag}: {PROC_REPEATS} waves of "
                f"{PROC_TIMED} records, records/s min "
                f"{min(rates):.1f}, median {float(np.median(rates)):.1f}, "
                f"max {max(rates):.1f} ({card_line})")
            return rates

        wave("two processes, first wave (their other buckets captured)",
             "warm", PROC_WAVE)
        rates = {"two": timed("two processes", "two")}
        snaps = replica_snapshots(scraper)
        hits = {n: sample_value(s or [], "zoo_compile_cache_hits_total",
                                label="kernel_flash_attention_fwd")
                for n, s in snaps.items()}
        log(f"fleet_process: replicas {sorted(snaps)}; "
            f"kernel_flash_attention_fwd library hits {hits} (a library "
            f"found built is a hit; an nvcc run records none)")
        if len(hits) != 2 or set(hits.values()) != {1}:
            raise AssertionError("fleet_process: a replica did not load the "
                                 "flash kernel's built library (a hit)")
        victim = next(r for r in ctrl._replicas if r.owner == owners[-1])
        sdir = os.path.join(spool, "stream-" + INPUT_STREAM)

        claimed = set()  # every record the victim was seen to claim
        # the victim may write a batch's answers and die before its
        # release (the commit): the survivor serves that batch again once
        # the lease expires, and its client reads a second answer
        twice = {"allowed": claimed, "seen": []}

        def kill_mid_batch():
            # read the victim's claims over and over from before the
            # wave's first enqueue, and kill it once it holds some: a
            # batch it commits just before the kill was read while it
            # was claimed; one it claimed after the last reading is read
            # once it is dead
            deadline = time.perf_counter() + 30
            held, readings = set(), 0
            while not held and time.perf_counter() < deadline:
                held = claimed_uris(sdir, victim.owner)
                claimed.update(held)
                readings += 1
            os.kill(victim.proc.pid, signal.SIGKILL)
            victim.proc.wait()
            after = claimed_uris(sdir, victim.owner)
            claimed.update(after)
            log(f"fleet_process: killed {victim.owner} with SIGKILL while "
                f"it held claims on {sorted(held)} (read {readings} times; "
                f"after the kill {sorted(after)})")
            if not held:
                raise AssertionError("fleet_process: the victim held no "
                                     "claim within 30 s")

        wave("with a SIGKILL mid-batch (lease expiry included)", "kill",
             PROC_WAVE, kill_mid_batch, linger=PROC_LEASE_MS / 1e3,
             twice=twice)
        log(f"fleet_process: answered twice {sorted(twice['seen'])}, each "
            f"a record the killed replica was seen to claim, the two "
            f"answers agreeing (its answers written, it died before the "
            f"release; the survivor served them again after the lease)")
        rates["one"] = timed("one process", "one")
        late = oq.dequeue()
        if late:
            raise AssertionError(f"fleet_process: answers after the last "
                                 f"wave: {sorted(late)}")
        two, one = rates["two"], rates["one"]
        log(f"fleet_process records/s, two processes {min(two):.1f}-"
            f"{max(two):.1f}, one {min(one):.1f}-{max(one):.1f}: "
            + ("the ranges overlap" if min(two) <= max(one)
               and min(one) <= max(two) else
               "two faster" if min(two) > max(one) else "one faster")
            + f" ({card_line})")
        time.sleep(PROC_STALE_S + 2 * PROC_SCRAPE_S)
        hz = scraper.healthz()
        merged = agg.merged(include_driver=False)
        stale = {n: t["healthy"] for n, t in hz["targets"].items()}
        log(f"fleet_process: scraper health {stale} (overall "
            f"{hz['healthy']}); aggregator sources "
            f"{ {s: v.get('stale') for s, v in merged['sources'].items()} }")
        dead = [n for n in hz["targets"] if victim.owner in n]
        dead_src = [k for k in merged["sources"] if victim.owner in k]
        if not dead or hz["targets"][dead[0]]["healthy"] or hz["healthy"] \
                or not dead_src or not merged["sources"][dead_src[0]][
                    "stale"]:
            raise AssertionError("fleet_process: the dead replica is not "
                                 "stale in /healthz and the aggregator")
        srv = MetricsServer(port=0, health=health).start()
        try:
            code = urllib_status(srv.url + "/healthz")
        finally:
            srv.stop()
        if code != 503:
            raise AssertionError(f"fleet_process: /healthz answered {code} "
                                 "with a dead target")
        ctrl._tick()  # supervision replaces the dead replica
        snaps = replica_snapshots(scraper)
        per = {}
        for n, s in snaps.items():
            if s is None:
                continue
            fl = sample_value(s, "zoo_kernel_invocations",
                              kernel="flash_attention_fwd",
                              backend=PROC_BACKEND)
            pc = sample_value(s, "zoo_serving_predict_seconds")
            used = sample_value(s, "zoo_device_bytes_in_use")
            peak = sample_value(s, "zoo_device_peak_bytes_in_use")
            per[n] = (fl, pc, used, peak)
        final = {}
        for labels in store.label_sets("zoo_kernel_invocations"):
            if labels.get("kernel") == "flash_attention_fwd" \
                    and labels.get("backend") == PROC_BACKEND:
                pts = store._select("zoo_kernel_invocations", labels)
                final[labels["host"]] = pts[0].points[-1][1]
        launches = int(sum(final.values()))
        memory = {}
        for name in ("zoo_device_bytes_in_use",
                     "zoo_device_peak_bytes_in_use"):
            for labels in store.label_sets(name):
                pts = store._select(name, labels)[0].points
                memory.setdefault(labels["host"], []).append(int(pts[-1][1]))
        log(f"fleet_process per live replica (flash launches, predict "
            f"calls, device bytes in use, peak): {per}; every replica's "
            f"last scrape: flash launches {final}, device bytes in use and "
            f"peak {memory} ({card_line})")
        for n, (fl, pc, used, peak) in per.items():
            if pc and fl != BERT_BASE["n_block"] * pc:
                raise AssertionError(f"fleet_process {n}: {fl} flash "
                                     f"launches for {pc} predict calls")
        log("fleet_process alert transitions: " + "; ".join(
            f"{d['slo']} {d['state']} (short {d['short_burn']}, long "
            f"{d['long_burn']})" for d in engine.decision_log()))
        log("fleet_process controller decisions: " + "; ".join(
            f"{d['action']} {d['old']}->{d['new']} {d['reason']} hosts "
            f"{d.get('hosts')}" for d in ctrl.decision_log()))
    finally:
        scraper.stop()
        ctrl.stop()
        for k, v in env_saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    with open(serve_log) as f:
        lines = [ln.split() for ln in f.read().splitlines()]
    uris = [u for _, u in lines]
    # the writer commits a batch (release done) and then appends its
    # lines, as the reference's does: a SIGKILL between the two leaves a
    # committed, answered batch of the dead replica without its lines,
    # which it was seen to claim
    unlogged = sorted(set(answered) - set(uris))
    if len(uris) != len(set(uris)) or not set(uris) <= set(answered) \
            or not set(unlogged) <= claimed or db.xlen(INPUT_STREAM):
        raise AssertionError(f"fleet_process: the serve log is not each "
                             f"record once ({len(uris)} lines, "
                             f"{len(answered)} answers, unlogged "
                             f"{unlogged})")
    log(f"fleet_process: {len(uris)} of {len(answered)} answered records "
        f"in the serve log once each, by "
        f"{sorted({o for o, _ in lines})}; answered without a line "
        f"{unlogged}, of the {len(claimed)} the killed replica was seen to "
        f"claim (a batch it committed before its serve-log append)")
    shutil.rmtree(tmp, ignore_errors=True)
    free_device_memory("after fleet_process")
    log(f"phase fleet_process: {time.perf_counter() - t_phase:.1f} s")
    return {"flash_attention_fwd": launches}


def urllib_status(url) -> int:
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


# SSD300 on the card: a synthetic VOC devkit through PascalVoc and the
# port's SSD pipelines, fit at the SSD paper's batch in f32 and bf16
SSD_TRAIN, SSD_VAL = 640, 16          # images of the synthetic devkit
SSD_SRC = (240, 320)                  # their (height, width)
SSD_RES = 300                         # the pipelines' square resolution
SSD_BATCH = 32                        # 20 steps an epoch
SSD_WORKERS = 4                       # prefetch workers of the fits
SSD_CPU_TOL = 1e-3                    # step 1's loss, card against CPU
SSD_LOSS_REPS = 5


def write_voc_devkit(root, n, gen, image_set="train", start=0):
    """``n`` JPEGs of SSD_SRC under ``root/VOC2007`` with 1-3 filled boxes
    each, drawn in a colour of their VOC class, and their XML annotations
    and image-set list: the layout ``PascalVoc`` reads."""
    import os

    from PIL import Image

    base = os.path.join(root, "VOC2007")
    for d in ("Annotations", "JPEGImages", os.path.join("ImageSets",
                                                        "Main")):
        os.makedirs(os.path.join(base, d), exist_ok=True)
    h, w = SSD_SRC
    colours = gen.integers(0, 256, (len(VOC_NAMES), 3))
    ids = []
    for i in range(start, start + n):
        idx = f"{i:06d}"
        ids.append(idx)
        img = gen.integers(0, 64, (h, w, 3)).astype(np.uint8)
        objs = []
        for _ in range(int(gen.integers(1, 4))):
            c = int(gen.integers(len(VOC_NAMES)))
            bw, bh = int(gen.integers(w // 6, w // 2)), \
                int(gen.integers(h // 6, h // 2))
            x0, y0 = int(gen.integers(0, w - bw)), int(gen.integers(0, h - bh))
            img[y0:y0 + bh, x0:x0 + bw] = colours[c]
            objs.append(f"<object><name>{VOC_NAMES[c]}</name><difficult>0"
                        f"</difficult><bndbox><xmin>{x0}</xmin><ymin>{y0}"
                        f"</ymin><xmax>{x0 + bw - 1}</xmax><ymax>"
                        f"{y0 + bh - 1}</ymax></bndbox></object>")
        Image.fromarray(img).save(os.path.join(base, "JPEGImages",
                                               idx + ".jpg"), quality=90)
        with open(os.path.join(base, "Annotations", idx + ".xml"), "w") as f:
            f.write(f"<annotation><size><width>{w}</width><height>{h}"
                    f"</height></size>{''.join(objs)}</annotation>")
    with open(os.path.join(base, "ImageSets", "Main", image_set + ".txt"),
              "w") as f:
        f.write("\n".join(ids) + "\n")


def ssd_net(seed, device=None):
    """A fresh ``ObjectDetector("ssd-vgg16-300")`` over the 20 VOC classes
    with weights drawn from a CPU generator seeded ``seed`` onto ``device``
    (default: the context's), so the card and the CPU get the same
    weights."""
    import torch

    from analytics_zoo_tpu_torch.models.image.objectdetection import (
        ObjectDetector,
    )

    det = ObjectDetector("ssd-vgg16-300", class_names=VOC_NAMES)
    det.model.build_params(rng=torch.Generator().manual_seed(seed),
                           device=device)
    return det


def ssd_step1_vs_cpu(batch, card_line) -> None:
    """Step 1's loss (the MultiBox loss of the initial weights on one
    training batch) on the card, in f32 and under ``mixed_precision()``'s
    bf16 compute, against the same weights and batch on the CPU in f32:
    f32 within SSD_CPU_TOL relative, bf16 within BF16_F32_LOSS_TOL of the
    card's f32."""
    import torch

    from analytics_zoo_tpu_torch.common.engine import (
        cast_floats,
        get_zoo_context,
    )
    from analytics_zoo_tpu_torch.parallel.plan import mixed_precision
    from analytics_zoo_tpu_torch.pipeline.estimator import Estimator
    from analytics_zoo_tpu_torch.pipeline.estimator.estimator import (
        _cast_params,
    )

    losses = {}
    t0 = time.perf_counter()
    for tag, device, plan in (("cuda f32", get_zoo_context().device, None),
                              ("cuda bf16", get_zoo_context().device,
                               mixed_precision()),
                              ("cpu f32", "cpu", None)):
        det = ssd_net(SEED + 262, device)
        net = det.model
        est = Estimator(net, loss=det.loss(), plan=plan)
        casts = est.compute_casts(est._resolve_plan(), net.params)
        x = torch.from_numpy(batch["x"]).to(device)
        y = torch.from_numpy(batch["y"]).to(device)
        with torch.no_grad():
            preds, _ = net.forward(_cast_params(net.params, casts),
                                   cast_floats(x, casts[1]),
                                   state=net.state)
            losses[tag] = est.loss.mean(y, preds.float()).item()
        del det, net, est
    rel = abs(losses["cuda f32"] - losses["cpu f32"]) / abs(losses["cpu f32"])
    rel16 = abs(losses["cuda bf16"] - losses["cuda f32"]) / \
        abs(losses["cuda f32"])
    log(f"ssd step 1 (batch {SSD_BATCH}): loss on the card f32 "
        f"{losses['cuda f32']:.6f}, bf16 {losses['cuda bf16']:.6f}; on the "
        f"CPU f32 {losses['cpu f32']:.6f}; card f32 vs CPU rel {rel:.2e} "
        f"(tol {SSD_CPU_TOL:g}), bf16 vs f32 rel {rel16:.2e} (tol "
        f"{BF16_F32_LOSS_TOL}); {time.perf_counter() - t0:.1f} s "
        f"({card_line})")
    if not (rel <= SSD_CPU_TOL and rel16 <= BF16_F32_LOSS_TOL):
        raise AssertionError("ssd: step 1's loss disagrees with the CPU's")


def loss_groups_ms(det, y_pred, y_true, card_line) -> None:
    """Device ms of the MultiBox loss's parts at the fit's shapes, each
    alone under torch.profiler (the sum of its kernels over SSD_LOSS_REPS
    calls): matching (IoU, the bipartite loop of max_boxes rounds, argmax
    and gathers), the box targets and smooth-L1, the log-softmax
    cross-entropy, the hard-negative mining (two stable argsorts), the
    whole loss, and the loss with its backward."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from analytics_zoo_tpu_torch.models.image.objectdetection import (
        encode_boxes,
        match_priors,
    )
    from analytics_zoo_tpu_torch.models.image.objectdetection.multibox_loss import (  # noqa: E501
        _smooth_l1,
    )

    loss = det.loss()
    center, corner = loss.priors_on(y_pred.device)
    conf, matched = match_priors(y_true[..., :4], y_true[..., 4].long(),
                                 corner)
    pos = conf > 0
    logits = y_pred[..., 4:]
    ce = -torch.gather(torch.log_softmax(logits, -1), -1,
                       conf[..., None])[..., 0]
    yp = y_pred.detach().requires_grad_(True)

    def mining():
        neg = torch.where(pos, -torch.inf, ce)
        order = torch.argsort(-neg, dim=1, stable=True)
        rank = torch.argsort(order, dim=1, stable=True)
        return rank < (3 * pos.sum(1))[:, None]

    def backward():
        loss(y_true, yp).mean().backward()

    groups = {
        "matching": lambda: match_priors(y_true[..., :4],
                                         y_true[..., 4].long(), corner),
        "targets + smooth L1": lambda: _smooth_l1(
            y_pred[..., :4] - encode_boxes(matched, center)),
        "cross-entropy": lambda: -torch.gather(
            torch.log_softmax(logits, -1), -1, conf[..., None]),
        "mining": mining,
        "whole loss": lambda: loss(y_true, y_pred),
        "loss + backward": backward,
    }
    out = {}
    for name, fn in groups.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(SSD_LOSS_REPS):
                fn()
            torch.cuda.synchronize()
        spans = cuda_spans(prof)
        out[name] = (sum(b - a for _, a, b in spans) / 1e3 / SSD_LOSS_REPS,
                     len(spans) // SSD_LOSS_REPS)
    log(f"ssd MultiBox loss by group at batch {y_pred.shape[0]}, "
        f"{y_pred.shape[1]} priors, {y_true.shape[1]} boxes (device ms, "
        f"kernels a call; torch.profiler): " + "; ".join(
            f"{k} {ms:.3f} ({n})" for k, (ms, n) in out.items())
        + f" ({card_line})")


def ssd_chain_split(train, card_line) -> None:
    """``ssd_train_set``'s batches alone on the host, on one thread: one
    batch of SSD_BATCH through ``batches`` as the fit's producer thread
    makes it (a ``RoiFeatureSet`` is no ``TransformedFeatureSet``, so the
    prefetch stage has no pooled map stage: its producer thread runs the
    whole chain), and the same records' time by stage (the JPEG decode,
    each op of the chain, the padding and ``np.stack``)."""
    from PIL import Image

    t0 = time.perf_counter()
    next(iter(train.batches(SSD_BATCH, shuffle=True, seed=SEED, epoch=1)))
    batch_ms = (time.perf_counter() - t0) * 1e3
    stages = train.chain.stages
    took = {"decode": 0.0, **{type(op).__name__: 0.0 for op in stages}}
    for ri in range(SSD_BATCH):
        rec = train.records[ri]
        t0 = time.perf_counter()
        with Image.open(rec["path"]) as im:
            image = np.asarray(im.convert("RGB"))
        took["decode"] += time.perf_counter() - t0
        r = {"image": image,
             "boxes": np.asarray(rec["boxes"], np.float32).reshape(-1, 4),
             "classes": np.asarray(rec.get("classes", []), np.float32),
             "difficult": np.asarray(rec.get(
                 "difficult", np.zeros(len(rec["boxes"]))), np.float32),
             "_rng": np.random.default_rng(SEED + ri)}
        for op in stages:
            t0 = time.perf_counter()
            r = op.transform(r)
            took[type(op).__name__] += time.perf_counter() - t0
    total = sum(took.values())
    log(f"ssd training chain alone on one thread: a batch of {SSD_BATCH} "
        f"through ssd_train_set.batches {batch_ms:.1f} ms = "
        f"{SSD_BATCH / batch_ms * 1e3:.1f} images/s; by stage over "
        f"{SSD_BATCH} records (ms an image): " + ", ".join(
            f"{k} {v * 1e3 / SSD_BATCH:.2f}" for k, v in took.items())
        + f"; the stages' sum {total * 1e3 / SSD_BATCH:.2f} ({card_line})")


def ssd_fit(tag, det, train, plan, card_line) -> dict:
    """``det``'s train step captured by ``Estimator.warmup`` on the set's
    first batch, then one epoch of ``train`` under ``plan`` (every step a
    replay, the prefetch stage on) under a torch.profiler trace of the
    card; the steady window after DP_SKIP steps (:func:`steady_window`:
    the card's clock a step, images/s, its busy time and idle share, the
    host's dispatch cadence, the fit thread's dispatch span and its wait
    for data); one replay's device time and the convolutions' bound.
    Returns the losses and the steps (the warmup's included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from analytics_zoo_tpu_torch.metrics import get_flight_recorder

    t_fit = time.perf_counter()
    net = det.model
    steps = train.num_samples // SSD_BATCH
    flight = get_flight_recorder()
    net._estimator = net._make_estimator()
    est = net._estimator
    est.warmup(next(iter(train.batches(SSD_BATCH, shuffle=False))),
               device_transform=train.device_transform, plan=plan)
    torch.cuda.synchronize()
    flight.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        net.fit(train, batch_size=SSD_BATCH, nb_epoch=1, plan=plan)
        torch.cuda.synchronize()
        epoch = (time.perf_counter() - t0) * 1e3 / steps
    win = steady_window(cuda_spans(prof),
                        [r for r in flight.events("step")
                         if r.get("loop") == "train"], DP_SKIP, steps)
    losses = [v for _, v in est.loss_log[-steps:]]
    dev_ms = replay_ms(graph_of(est._train_step_for(
        1, est._resolve_plan(plan), train.device_transform)))
    flops = conv_flops(net)
    peak = PEAK_FLOPS["float32" if plan is None else "bfloat16"]
    bound_ms = SSD_BATCH * flops[1] / peak * 1e3
    log(f"ssd {tag} fit (batch {SSD_BATCH}, {steps} steps, prefetch on "
        f"with {SSD_WORKERS} workers): steady window after {DP_SKIP} "
        f"steps: on the card a step every {win['card_ms']:.2f} ms over "
        f"{win['card_steps']} steps, "
        f"{SSD_BATCH / win['card_ms'] * 1e3:.1f} images/s, busy "
        f"{win['busy_ms']:.2f} ms a step, idle {win['idle']:.1%} (traced; "
        f"{win['adam_traced']} of {steps} Adam kernels in the trace); on "
        f"the host a dispatch every {win['host_ms']:.2f} ms over "
        f"{win['steps']}, the fit thread's dispatch span "
        f"{win['span_ms']:.2f} ms, wait for data {win['wait_ms']:.2f} ms "
        f"(medians); the whole epoch {epoch:.2f} ms a step (start-up "
        f"included); one replay {dev_ms:.2f} ms; bound {bound_ms:.2f} ms "
        f"({SSD_BATCH} x {flops[1] / 1e9:.1f} GFLOP of convolutions at "
        f"{peak / 1e12:.0f} TFLOP/s; a replay {bound_ms / dev_ms:.1%} of "
        f"it); losses " + ", ".join(f"{v:.4f}" for v in losses)
        + f"; {time.perf_counter() - t_fit:.1f} s ({card_line})")
    if not (np.all(np.isfinite(losses)) and max(losses[-2:]) < losses[0]):
        raise AssertionError(f"ssd {tag}: the loss did not fall: {losses}")
    return {"steps": steps + 1, "losses": losses}


def ssd_phase(card_line: str) -> dict:
    """SSD300-VGG16 on the card.  A synthetic VOC devkit (SSD_TRAIN +
    SSD_VAL JPEGs of SSD_SRC with 1-3 boxes of known classes, XML
    annotations) read by ``PascalVoc`` into the port's ``ssd_train_set`` /
    ``ssd_val_set`` (300x300, the reference's augmentation chain); the
    training chain alone on the host (``ssd_chain_split``);
    ``ObjectDetector("ssd-vgg16-300").compile(Adam)`` fit one epoch at
    batch SSD_BATCH, captured, in f32 and under ``mixed_precision()``,
    read in a steady window (``ssd_fit``; one fused Adam launch a step, the
    loss falling); step 1's loss against the CPU (``ssd_step1_vs_cpu``);
    the loss's matching and mining by group; ``predict_image_set`` at 1
    and 8 images (a request's device ms from its captured bucket, the
    decode on the card and the NMS on the host) and ``PascalVocEvaluator``
    over the validation set.  Its mAP is the synthetic devkit's; a VOC
    score waits for the dataset in the repository.  Returns the fits'
    launch counts."""
    import tempfile

    import torch

    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.feature.image.roi import (
        ssd_train_set,
        ssd_val_set,
    )
    from analytics_zoo_tpu_torch.models.image.objectdetection import (
        PascalVoc,
        PascalVocEvaluator,
    )
    from analytics_zoo_tpu_torch.models.image.objectdetection.postprocess import (  # noqa: E501
        decode_predictions,
        nms_decoded,
    )
    from analytics_zoo_tpu_torch.parallel.plan import mixed_precision
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import Adam
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

    t_phase = time.perf_counter()
    free_device_memory("before ssd")
    init_zoo_context({"prefetch_workers": SSD_WORKERS}, seed=SEED,
                     device="cuda")
    gen = np.random.default_rng(SEED + 260)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_voc_devkit(tmp, SSD_TRAIN, gen, "train")
        write_voc_devkit(tmp, SSD_VAL, gen, "val", start=SSD_TRAIN)
        train_recs = PascalVoc(tmp, "2007", "train").roidb(read_image=False)
        val_recs = PascalVoc(tmp, "2007", "val").roidb()
        log(f"ssd: synthetic VOC devkit of {SSD_TRAIN} + {SSD_VAL} JPEGs "
            f"{SSD_SRC} written and indexed in "
            f"{time.perf_counter() - t0:.1f} s; "
            f"{sum(len(r['boxes']) for r in train_recs)} training boxes")
        train = ssd_train_set(train_recs, resolution=SSD_RES, max_boxes=8,
                              label_offset=-1)
        val = ssd_val_set(val_recs, resolution=SSD_RES, max_boxes=8,
                          label_offset=-1)
        first = next(iter(train.batches(SSD_BATCH, shuffle=False)))
        ssd_chain_split(train, card_line)
        ssd_step1_vs_cpu(first, card_line)
        launches, steps = {}, 0
        fitted = None
        for tag, plan in (("f32", None), ("bf16", mixed_precision())):
            det = ssd_net(SEED + 261)
            det.compile(Adam(lr=1e-4))
            reset_counters()  # this fit: to the read below
            res = ssd_fit(tag, det, train, plan, card_line)
            torch.cuda.synchronize()
            launches = add_launches(launches, counters())  # end of the fit
            steps += res["steps"]
            # the fit's captured step holds its graph pool (tens of GB at
            # batch 32): free it before the next fit
            det.model._estimator = None
            if plan is None:
                fitted = det
            else:
                del det
            free_device_memory(f"ssd after the {tag} fit")
        expect_launches("ssd", launches, fused_adam=steps)
        log(f"ssd launches {launches}: one fused Adam launch a step over "
            f"{steps} steps")
        dev = fitted.model.device
        y_true = torch.from_numpy(first["y"]).to(dev)
        with torch.no_grad():
            y_pred, _ = fitted.model.forward(
                fitted.model.params, torch.from_numpy(first["x"]).to(dev),
                state=fitted.model.state)
        loss_groups_ms(fitted, y_pred, y_true, card_line)
        val_batches = list(val.batches(8, shuffle=False, drop_last=False))
        val_x = np.concatenate([b["x"] for b in val_batches])
        gts = [dict(boxes=row[row[:, 4] >= 0][:, :4],
                    classes=row[row[:, 4] >= 0][:, 4])
               for b in val_batches for row in b["y"]]
        im = InferenceModel().from_keras_net(fitted.model)
        im.warmup([val_x.shape[1:]], dtype=[val_x.dtype], batch_sizes=[1, 8])
        for n in (1, 8):
            x = val_x[:n]
            host = []
            for _ in range(HOST_REPEATS):
                t0 = time.perf_counter()
                dets = fitted.predict_image_set(x, conf_threshold=0.3)
                host.append((time.perf_counter() - t0) * 1e3)
            raw = torch.from_numpy(im.predict(x)).to(fitted.model.device)
            priors = torch.as_tensor(np.asarray(fitted.priors, np.float32),
                                     device=raw.device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            boxes, scores = decode_predictions(raw, priors)
            boxes, scores = boxes.cpu().numpy(), scores.cpu().numpy()
            decode_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            again = nms_decoded(boxes, scores, 0.3)
            nms_ms = (time.perf_counter() - t0) * 1e3
            key = ((x.shape, str(x.dtype)),)
            dev = replay_ms(graph_of(im._steps[key].step))
            flops = conv_flops(fitted.model)
            same = [len(d["scores"]) for d in dets] == \
                [len(d["scores"]) for d in again]
            log(f"ssd request of {n}: predict_image_set host "
                f"{float(np.median(host)):.2f} ms (median of {HOST_REPEATS})"
                f", the request's device {dev:.3f} ms (bound "
                f"{n * flops[0] / PEAK_FLOPS['float32'] * 1e3:.3f} ms), "
                f"the decode on the card with its copy of boxes and scores "
                f"to the host {decode_ms:.2f} ms, the NMS on the host "
                f"{nms_ms:.2f} ms (host clock); "
                f"{sum(len(d['scores']) for d in dets)} detections, the "
                f"same through InferenceModel: {same} ({card_line})")
            if len(dets) != n or not all(
                    np.isfinite(d["boxes"]).all() for d in dets):
                raise AssertionError(f"ssd: predict_image_set of {n} is "
                                     "wrong")
        dets = fitted.predict_image_set(val_x, conf_threshold=0.01)
        ev = PascalVocEvaluator(VOC_NAMES).evaluate(dets, gts)
        present = {k: round(v, 4) for k, v in ev["AP"].items()
                   if v == v}
        log(f"ssd PascalVocEvaluator on the synthetic devkit's {len(gts)} "
            f"validation images (not VOC: VOC2007 is not in the "
            f"repository): mAP {ev['mAP']:.4f} over {len(present)} classes "
            f"present ({card_line})")
        if not 0.0 <= ev["mAP"] <= 1.0:
            raise AssertionError("ssd: the mAP is not a fraction")
        del fitted, im
    free_device_memory("after ssd")
    log(f"phase ssd: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# tfpark's estimator plane and the model importers: the tfpark_bert,
# tfpark_gan and model_import phases
# ---------------------------------------------------------------------------

# google-research/bert README's SQuAD 1.1 run (max_seq_length=384,
# train_batch_size=12): 20 steps as one epoch of 240 records
SQUAD_SEQ, SQUAD_BATCH, SQUAD_STEPS = 384, 12, 20
# CoNLL-2003's tag set (9 entities), 8 x 512, 10 steps
NER_SEQ, NER_BATCH, NER_STEPS, NER_TAGS = 512, 8, 10, 9
# run_classifier's defaults (max_seq_length=128, train_batch_size=32)
CLF_SEQ, CLF_BATCH, CLF_STEPS = 128, 32, 10
EST_CPU_TOL = 1e-3            # step 1's loss and grads, card against CPU
ZERO_GRAD = 1e-6              # a gradient leaf this far under the largest: 0
GAN_BATCH, GAN_STEPS, GAN_NOISE, GAN_RECORDS = 64, 40, 64, 640
IMPORT_BATCH = 32
IMPORT_RESNET_SHAPE = (224, 224, 3)
# ONNX ResNet-50 / Caffe AlexNet: the logits under the softmax (each
# row's shift taken out), relative to the row's logit range
IMPORT_TOL = 1e-4
IMPORT_LR = 1e-5              # the imported nets' fine-tune rate (Adam)
ALEXNET_DEPLOY = """
name: "AlexNet"
input: "data"
input_shape { dim: 10 dim: 3 dim: 227 dim: 227 }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 96 kernel_size: 11 stride: 4 } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "norm1" type: "LRN" bottom: "conv1" top: "norm1"
  lrn_param { local_size: 5 alpha: 0.0001 beta: 0.75 } }
layer { name: "pool1" type: "Pooling" bottom: "norm1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layer { name: "conv2" type: "Convolution" bottom: "pool1" top: "conv2"
  convolution_param { num_output: 256 pad: 2 kernel_size: 5 group: 2 } }
layer { name: "relu2" type: "ReLU" bottom: "conv2" top: "conv2" }
layer { name: "norm2" type: "LRN" bottom: "conv2" top: "norm2"
  lrn_param { local_size: 5 alpha: 0.0001 beta: 0.75 } }
layer { name: "pool2" type: "Pooling" bottom: "norm2" top: "pool2"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layer { name: "conv3" type: "Convolution" bottom: "pool2" top: "conv3"
  convolution_param { num_output: 384 pad: 1 kernel_size: 3 } }
layer { name: "relu3" type: "ReLU" bottom: "conv3" top: "conv3" }
layer { name: "conv4" type: "Convolution" bottom: "conv3" top: "conv4"
  convolution_param { num_output: 384 pad: 1 kernel_size: 3 group: 2 } }
layer { name: "relu4" type: "ReLU" bottom: "conv4" top: "conv4" }
layer { name: "conv5" type: "Convolution" bottom: "conv4" top: "conv5"
  convolution_param { num_output: 256 pad: 1 kernel_size: 3 group: 2 } }
layer { name: "relu5" type: "ReLU" bottom: "conv5" top: "conv5" }
layer { name: "pool5" type: "Pooling" bottom: "conv5" top: "pool5"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layer { name: "fc6" type: "InnerProduct" bottom: "pool5" top: "fc6"
  inner_product_param { num_output: 4096 } }
layer { name: "relu6" type: "ReLU" bottom: "fc6" top: "fc6" }
layer { name: "drop6" type: "Dropout" bottom: "fc6" top: "fc6"
  dropout_param { dropout_ratio: 0.5 } }
layer { name: "fc7" type: "InnerProduct" bottom: "fc6" top: "fc7"
  inner_product_param { num_output: 4096 } }
layer { name: "relu7" type: "ReLU" bottom: "fc7" top: "fc7" }
layer { name: "drop7" type: "Dropout" bottom: "fc7" top: "fc7"
  dropout_param { dropout_ratio: 0.5 } }
layer { name: "fc8" type: "InnerProduct" bottom: "fc7" top: "fc8"
  inner_product_param { num_output: 1000 } }
layer { name: "prob" type: "Softmax" bottom: "fc8" top: "prob" }
"""
# BVLC AlexNet's blob shapes (weights, biases) per layer
ALEXNET_BLOBS = {"conv1": (96, 3, 11, 11), "conv2": (256, 48, 5, 5),
                 "conv3": (384, 256, 3, 3), "conv4": (384, 192, 3, 3),
                 "conv5": (256, 192, 3, 3), "fc6": (4096, 9216),
                 "fc7": (4096, 4096), "fc8": (1000, 4096)}


def tfpark_tokens(n: int, seq: int, gen: np.random.Generator) -> dict:
    """``bert_input_fn``'s dict of n records of real lengths seq/2-seq:
    token ids, segment types (a question then its context), positions
    and the attention mask."""
    lengths = gen.integers(seq // 2, seq + 1, n)
    split = (lengths * gen.uniform(0.2, 0.4, n)).astype(np.int64)
    pos = np.arange(seq)[None, :]
    mask = (pos < lengths[:, None]).astype(np.int32)
    ids = gen.integers(1, BERT_BASE["vocab"], (n, seq)) * mask
    types = ((pos >= split[:, None]) & (mask > 0)).astype(np.int32)
    return {"input_ids": ids.astype(np.int32), "token_type_ids": types,
            "position_ids": np.tile(pos.astype(np.int32), (n, 1)),
            "input_mask": mask}


def tfpark_labels(kind: str, data: dict, gen: np.random.Generator):
    ids = data["input_ids"]
    if kind == "squad":  # an answer span inside the context
        lengths = data["input_mask"].sum(-1)
        start = gen.integers(1, lengths // 2)
        return np.stack([start, start + gen.integers(0, 20, len(ids))],
                        1).astype(np.int32)
    if kind == "ner":
        return (ids % NER_TAGS).astype(np.int32)
    return (ids[:, 1] % 2).astype(np.int32)


def tfpark_estimator(kind, drop=DROPOUT, attn_drop=None, n_block=None,
                     init_checkpoint=None):
    """A BERT-base estimator of tfpark's text family, Adam as in the
    reference's examples, hidden dropout ``drop`` and attention dropout
    ``attn_drop`` (default ``drop``)."""
    from analytics_zoo_tpu_torch.tfpark.text.estimator import (
        BERTClassifier,
        BERTNER,
        BERTSquad,
    )

    cfg = dict(BERT_BASE, hidden_p_drop=drop,
               attn_p_drop=drop if attn_drop is None else attn_drop,
               optimizer="adam", init_checkpoint=init_checkpoint)
    if n_block is not None:
        cfg["n_block"] = n_block
    if kind == "squad":
        return BERTSquad(**cfg)
    if kind == "ner":
        return BERTNER(NER_TAGS, dropout=drop, **cfg)
    return BERTClassifier(2, dropout=drop, **cfg)


def tfpark_step1_vs_cpu(kind, seq, gen) -> None:
    """Step 1 of a 2-block estimator of ``kind`` at batch 2 x ``seq``,
    hidden dropout 0, on the card against the same weights and batch on
    the CPU: the loss (relative) and every gradient (relative to its
    leaf's largest), within EST_CPU_TOL; a leaf whose gradient on the CPU
    is under ZERO_GRAD of the largest is zero but for rounding, and must
    be so on the card.  At 256 tokens and more the
    attention takes the flash route, whose dropout mask is the kernel's
    position hash on both devices, so attention dropout is DROPOUT there;
    below it the dense route draws its mask from the device's generator,
    so attention dropout is 0."""
    import torch

    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.common.engine import step_generator
    from analytics_zoo_tpu_torch.common.utils import tree_leaves
    from analytics_zoo_tpu_torch.pipeline.estimator.estimator import (
        _to_device,
    )
    from analytics_zoo_tpu_torch.tfpark.estimator import _MergedFeatureSet
    from analytics_zoo_tpu_torch.tfpark.text.estimator import bert_input_fn

    attn = DROPOUT if seq >= 256 else 0.0
    data = tfpark_tokens(2, seq, gen)
    fn = bert_input_fn({**data, "labels": tfpark_labels(kind, data, gen)},
                       seq)
    got = []
    for device in ("cuda", "cpu"):
        init_zoo_context(seed=SEED, device=device)
        est = tfpark_estimator(kind, drop=0.0, attn_drop=attn, n_block=2)
        fs = est._to_feature_set(fn())
        est._ensure_built(fs, "train")
        net = est._train_net
        net.build_params(rng=torch.Generator().manual_seed(SEED),
                         device=device)
        batch = next(_MergedFeatureSet(fs).batches(2, shuffle=False))
        loss, grads, _ = est._training_estimator().loss_and_grads(
            net.params, net.state, _to_device(batch, net.device),
            step_generator(SEED, 0, net.device))
        got.append((loss.item(), [g.cpu() for g in tree_leaves(grads)]))
    (g_loss, g_grads), (c_loss, c_grads) = got
    loss_err = abs(g_loss - c_loss) / abs(c_loss)
    # leaves whose gradient is zero but for rounding (a shift that the
    # softmax over tokens does not see: the SQuAD heads' biases, the last
    # LayerNorm's beta under them) are held to zero on the card too
    top = max(b.abs().max().item() for b in c_grads)
    live = [b.abs().max().item() > ZERO_GRAD * top for b in c_grads]
    grad_err = max(((a - b).abs().max() / b.abs().max()).item()
                   for a, b, on in zip(g_grads, c_grads, live) if on)
    zero_err = max([a.abs().max().item() / top
                    for a, on in zip(g_grads, live) if not on] or [0.0])
    log(f"tfpark_bert {kind} step 1 (2 blocks at full width, batch 2 x "
        f"{seq}, hidden dropout 0, attention dropout {attn}) vs CPU: loss "
        f"{g_loss:.6f} vs {c_loss:.6f} (rel {loss_err:.2e}), grads max rel "
        f"to leaf max {grad_err:.2e} over {sum(live)} leaves (tol "
        f"{EST_CPU_TOL:g}); {len(live) - sum(live)} leaves zero on the CPU "
        f"(under {ZERO_GRAD:g} of the largest gradient, {top:.3e}), on the "
        f"card at most {zero_err:.2e} of it")
    if not (loss_err <= EST_CPU_TOL and grad_err <= EST_CPU_TOL
            and zero_err <= ZERO_GRAD and len(g_grads) == len(c_grads)):
        raise AssertionError(f"tfpark_bert {kind}: the card's step 1 "
                             "disagrees with the CPU's")


def estimator_train(tag, est, fn, steps, batch, card_line) -> dict:
    """``est.train(fn, steps=steps)`` over one epoch of exactly ``steps``
    steps (step 1 eager and captured, then replays) under a torch.profiler
    trace of the card: finite losses, ``steps`` steps; the steady window
    after DP_SKIP steps (:func:`steady_window`: the card's clock a step,
    its busy time and idle share, the host's dispatch cadence and the
    fit thread's dispatch span).  The trace's own cost falls inside the
    window.  Returns the launch counts of the call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from analytics_zoo_tpu_torch.metrics import get_flight_recorder

    flight = get_flight_recorder()
    reset_counters()
    torch.cuda.synchronize()
    flight.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        est.train(fn, steps=steps, batch_size=batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = counters()
    inner = est._estimator
    losses = [v for _, v in inner.loss_log]
    if inner.global_step != steps or len(losses) != steps \
            or not np.all(np.isfinite(losses)):
        raise AssertionError(f"{tag}: {inner.global_step} steps, losses "
                             f"{losses}")
    win = steady_window(cuda_spans(prof),
                        [r for r in flight.events("step")
                         if r.get("loop") == "train"], DP_SKIP, steps)
    log(f"{tag}: {steps} steps at batch {batch} through TFEstimator.train "
        f"in {wall:.2f} s (the set-up, step 1's eager run and capture and "
        f"the hand-over to the predict net included), losses "
        f"{losses[0]:.4f} .. {losses[-1]:.4f}; steady window after "
        f"{DP_SKIP} steps: on the card a step every {win['card_ms']:.2f} "
        f"ms over {win['card_steps']} steps, "
        f"{batch / win['card_ms'] * 1e3:.1f} records/s, busy "
        f"{win['busy_ms']:.2f} ms a step, idle {win['idle']:.1%} (traced; "
        f"{win['adam_traced']} of {steps} Adam kernels in the trace); on "
        f"the host a dispatch every {win['host_ms']:.2f} ms over "
        f"{win['steps']}, the dispatch span {win['span_ms']:.2f} ms "
        f"(median); launches {launches} ({card_line})")
    return launches


def tfpark_bert_phase(card_line: str) -> dict:
    """tfpark's BERT estimators fine-tuning BERT-base (f32, dropout 0.1,
    Adam) through ``TFEstimator.train``: ``BERTSquad`` at 12 x 384 (20
    steps, one epoch of 240 records), then ``predict`` (start and end rows
    summing to 1) and ``evaluate``; ``BERTNER`` at 8 x 512 with 9 tags (10
    steps) and its per-token accuracy; ``BERTClassifier`` at 32 x 128 (10
    steps) with no flash launch (sequences under 256 take the dense
    attention), whose ``save_init_checkpoint`` warm-starts a
    ``BERTSquad`` encoder with no leaf missed.  Each training epoch is
    read in a steady window of a trace (:func:`estimator_train`).  The
    flash forward with dropout and statistics and the backward held
    against their plain versions at the two training shapes
    (:func:`flash_train_check`); each kind's step 1, loss and gradients,
    against the CPU (:func:`tfpark_step1_vs_cpu`).  Launches: 12 flash
    forwards with statistics and 12 backwards a training step, one Adam a
    step, 12 forwards a predict batch.  Returns the path's launch counts,
    with the statistics forwards under ``attention_stats``, and the
    kernels' largest errors at the path's shapes."""
    import os
    import tempfile

    import torch

    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.tfpark.text.estimator import bert_input_fn
    from analytics_zoo_tpu_torch.convert import sorted_leaves

    t_phase = time.perf_counter()
    gen = np.random.default_rng(SEED + 140)
    checks = [flash_train_check(b, seq, torch.device("cuda"), gen)
              for b, seq in ((SQUAD_BATCH, SQUAD_SEQ), (NER_BATCH, NER_SEQ))]
    errs = {"flash_attention_fwd": max(c["fwd_err"] for c in checks),
            "flash_attention_bwd": max(c["bwd_abs_err"] for c in checks)}
    del checks
    for kind, seq in (("squad", SQUAD_SEQ), ("ner", NER_SEQ),
                      ("classifier", CLF_SEQ)):
        tfpark_step1_vs_cpu(kind, seq, gen)
    free_device_memory("after the tfpark_bert CPU checks")
    total, stats = {}, 0
    blocks = BERT_BASE["n_block"]
    with tempfile.TemporaryDirectory() as tmp:
        # BERTSquad: train, predict, evaluate
        init_zoo_context(seed=SEED, device="cuda")
        n = SQUAD_BATCH * SQUAD_STEPS
        data = tfpark_tokens(n, SQUAD_SEQ, gen)
        fn = bert_input_fn({**data, "labels": tfpark_labels("squad", data,
                                                             gen)},
                           SQUAD_SEQ)
        est = tfpark_estimator("squad")
        launches = estimator_train("tfpark_bert squad", est, fn,
                                   SQUAD_STEPS, SQUAD_BATCH, card_line)
        expect_launches("tfpark_bert squad train", launches,
                        flash_attention_fwd=blocks * SQUAD_STEPS,
                        flash_attention_bwd=blocks * SQUAD_STEPS,
                        fused_adam=SQUAD_STEPS)
        total, stats = add_launches(total, launches), \
            stats + launches["flash_attention_fwd"]
        reset_counters()
        t0 = time.perf_counter()
        start_p, end_p = est.predict(fn, batch_size=SQUAD_BATCH)
        torch.cuda.synchronize()
        predict_ms = (time.perf_counter() - t0) * 1e3
        launches = counters()
        expect_launches("tfpark_bert squad predict", launches,
                        flash_attention_fwd=blocks * SQUAD_STEPS)
        total = add_launches(total, launches)
        rows = np.concatenate([start_p.sum(-1), end_p.sum(-1)])
        log(f"tfpark_bert squad predict of {n} records at batch "
            f"{SQUAD_BATCH}: {predict_ms:.0f} ms host clock (the captures "
            f"included), start and end rows sum to 1 within "
            f"{np.abs(rows - 1).max():.2e}; launches {launches} "
            f"({card_line})")
        if start_p.shape != (n, SQUAD_SEQ) or np.abs(rows - 1).max() > 1e-4:
            raise AssertionError("tfpark_bert squad: predictions are wrong")
        reset_counters()
        out = est.evaluate(fn, [])
        launches = counters()
        n_pred = -(-n // 32)  # evaluate's predict batches of 32
        expect_launches("tfpark_bert squad evaluate", launches,
                        flash_attention_fwd=blocks * (n_pred + 1))
        total = add_launches(total, launches)
        log(f"tfpark_bert squad evaluate: loss {out['loss']:.4f}; launches "
            f"{launches}")
        if not np.isfinite(out["loss"]):
            raise AssertionError("tfpark_bert squad: evaluate's loss")
        del est, start_p, end_p
        free_device_memory("after BERTSquad")

        # BERTNER: train, evaluate per-token accuracy
        n = NER_BATCH * NER_STEPS
        data = tfpark_tokens(n, NER_SEQ, gen)
        fn = bert_input_fn({**data, "labels": tfpark_labels("ner", data,
                                                             gen)},
                           NER_SEQ)
        est = tfpark_estimator("ner")
        launches = estimator_train("tfpark_bert ner", est, fn, NER_STEPS,
                                   NER_BATCH, card_line)
        expect_launches("tfpark_bert ner train", launches,
                        flash_attention_fwd=blocks * NER_STEPS,
                        flash_attention_bwd=blocks * NER_STEPS,
                        fused_adam=NER_STEPS)
        total, stats = add_launches(total, launches), \
            stats + launches["flash_attention_fwd"]
        reset_counters()
        out = est.evaluate(fn, ["accuracy"])
        launches = counters()
        expect_launches("tfpark_bert ner evaluate", launches,
                        flash_attention_fwd=blocks * (-(-n // 32) + 1))
        total = add_launches(total, launches)
        log(f"tfpark_bert ner evaluate: per-token accuracy "
            f"{out['accuracy']:.4f} (9 tags), loss {out['loss']:.4f}; "
            f"launches {launches}")
        if not (0.0 <= out["accuracy"] <= 1.0 and np.isfinite(out["loss"])):
            raise AssertionError("tfpark_bert ner: evaluate is wrong")
        del est
        free_device_memory("after BERTNER")

        # BERTClassifier at 128: the dense attention, and a warm start
        n = CLF_BATCH * CLF_STEPS
        data = tfpark_tokens(n, CLF_SEQ, gen)
        fn = bert_input_fn({**data, "labels": tfpark_labels(
            "classifier", data, gen)}, CLF_SEQ)
        est = tfpark_estimator("classifier")
        launches = estimator_train("tfpark_bert classifier", est, fn,
                                   CLF_STEPS, CLF_BATCH, card_line)
        expect_launches("tfpark_bert classifier train", launches,
                        fused_adam=CLF_STEPS)
        total = add_launches(total, launches)
        probs = est.predict(fn, batch_size=CLF_BATCH)
        if probs.shape != (n, 2) or \
                np.abs(probs.sum(-1) - 1).max() > 1e-5:
            raise AssertionError("tfpark_bert classifier: predictions")
        path = os.path.join(tmp, "bert_init.npz")
        est.save_init_checkpoint(path)
        want = [t.cpu() for t in sorted_leaves(
            est._train_net.params[est.bert.name])]
        del est
        squad = tfpark_estimator("squad", init_checkpoint=path)
        sdata = tfpark_tokens(SQUAD_BATCH, SQUAD_SEQ, gen)
        squad._ensure_built(squad._to_feature_set(bert_input_fn(
            {**sdata, "labels": tfpark_labels("squad", sdata, gen)},
            SQUAD_SEQ)()), "train")
        got = sorted_leaves(squad._train_net.params[squad.bert.name])
        same = sum(torch.equal(a.cpu(), b) for a, b in zip(got, want))
        log(f"tfpark_bert: the classifier's save_init_checkpoint "
            f"warm-started a BERTSquad encoder: {same} of {len(want)} "
            f"leaves restored bit for bit")
        if same != len(want) or len(got) != len(want):
            raise AssertionError("tfpark_bert: the warm start missed leaves")
        del squad
    free_device_memory("after tfpark_bert")
    total["attention_stats"] = stats
    log(f"phase tfpark_bert: {time.perf_counter() - t_phase:.1f} s")
    return total, errs


def dcgan_fns():
    """A DCGAN-sized pair for 28 x 28 x 1: the generator takes 64-d noise
    through Dense(7*7*128), Reshape and two stride-2 Deconvolution2D (to
    14 x 14 x 64, then 28 x 28 x 1 with tanh); the discriminator two
    stride-2 Convolution2D of 64 and 128 (LeakyReLU 0.2), Flatten and
    Dense(1)."""
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        Convolution2D,
        Deconvolution2D,
        Dense,
        Flatten,
        LeakyReLU,
        Reshape,
    )

    def generator_fn(z):
        h = Reshape((7, 7, 128))(Dense(7 * 7 * 128, activation="relu")(z))
        h = Deconvolution2D(64, 4, 4, subsample=(2, 2), border_mode="same",
                            activation="relu")(h)
        return Deconvolution2D(1, 4, 4, subsample=(2, 2),
                               border_mode="same", activation="tanh")(h)

    def discriminator_fn(x):
        h = LeakyReLU(0.2)(Convolution2D(64, 4, 4, subsample=(2, 2),
                                         border_mode="same")(x))
        h = LeakyReLU(0.2)(Convolution2D(128, 4, 4, subsample=(2, 2),
                                         border_mode="same")(h))
        return Dense(1)(Flatten()(h))

    return generator_fn, discriminator_fn


def dcgan(model_dir):
    import torch.nn.functional as F

    from analytics_zoo_tpu_torch.tfpark import GANEstimator

    g, d = dcgan_fns()
    return GANEstimator(
        g, d, lambda f: F.softplus(-f),
        lambda r, f: F.softplus(-r) + F.softplus(f), "adam", "adam",
        generator_steps=1, discriminator_steps=1, model_dir=model_dir)


def gan_data(gen):
    """(noise, real): 64-d Gaussian noise and 28 x 28 x 1 images in
    [-1, 1], each a Gaussian bump at a random place."""
    noise = gen.normal(size=(GAN_RECORDS, GAN_NOISE)).astype(np.float32)
    yy, xx = np.mgrid[0:28, 0:28]
    cy, cx = gen.uniform(6, 22, (2, GAN_RECORDS, 1, 1))
    real = 2 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 18.0) - 1
    return noise, real[..., None].astype(np.float32)


def tfpark_gan_phase(card_line: str) -> dict:
    """``GANEstimator`` on a DCGAN-sized pair (28 x 28 x 1, 64-d noise) at
    batch 64, Adam on both groups, d_steps = g_steps = 1: GAN_STEPS
    phase-steps, each one captured step of its phase (one Adam launch a
    phase-step), step 1's loss within 1e-3 of the CPU's (the same seeded
    weights and batch) and each group's Adam counting its own phases;
    then GAN_STEPS more, every one a replay, under a torch.profiler trace
    of the card, read after DP_SKIP phase-steps (:func:`card_window`) and
    beside the call's host clock a phase-step; ``generate`` from the
    checkpoint equal to ``generate`` in memory.  Returns the path's
    launch counts."""
    import os
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from analytics_zoo_tpu_torch import init_zoo_context

    t_phase = time.perf_counter()
    noise, real = gan_data(np.random.default_rng(SEED + 150))
    with tempfile.TemporaryDirectory() as tmp:
        init_zoo_context(seed=SEED, device="cpu")
        cpu = dcgan(os.path.join(tmp, "cpu"))
        cpu.train((noise, real), steps=1, batch_size=GAN_BATCH)
        init_zoo_context(seed=SEED, device="cuda")
        est = dcgan(os.path.join(tmp, "card"))
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        est.train((noise, real), steps=GAN_STEPS, batch_size=GAN_BATCH)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counters()
        expect_launches("tfpark_gan", launches, fused_adam=GAN_STEPS)
        first = list(est.losses)
        err = abs(first[0] - cpu.losses[0]) / abs(cpu.losses[0])
        counts = (int(est._d_opt_state.count), int(est._g_opt_state.count))
        log(f"tfpark_gan step 1 (the discriminator's phase) vs CPU: loss "
            f"{first[0]:.6f} vs {cpu.losses[0]:.6f} (rel {err:.2e}, tol "
            f"{EST_CPU_TOL:g}); {GAN_STEPS} phase-steps at batch "
            f"{GAN_BATCH} in {wall:.2f} s (the two first eager and "
            f"captured), losses d {first[0]:.4f} .. {first[-2]:.4f}, g "
            f"{first[1]:.4f} .. {first[-1]:.4f}; Adam counts {counts}")
        if not err <= EST_CPU_TOL \
                or counts != (GAN_STEPS // 2, GAN_STEPS // 2) \
                or not np.all(np.isfinite(first)):
            raise AssertionError(f"tfpark_gan: step 1 or the phase counts "
                                 f"{counts} are wrong")
        reset_counters()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            est.train((noise, real), steps=2 * GAN_STEPS,
                      batch_size=GAN_BATCH)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3 / GAN_STEPS
        more = counters()
        expect_launches("tfpark_gan traced", more, fused_adam=GAN_STEPS)
        launches = add_launches(launches, more)
        win = card_window(cuda_spans(prof), DP_SKIP)
        counts = (int(est._d_opt_state.count), int(est._g_opt_state.count))
        log(f"tfpark_gan: {GAN_STEPS} more phase-steps, every one a replay, "
            f"in {host_ms:.3f} ms a phase-step on the host clock (the "
            f"call's, the checkpoint's write included); steady window "
            f"after {DP_SKIP}: on the card a phase-step every "
            f"{win['card_ms']:.3f} ms over {win['card_steps']}, busy "
            f"{win['busy_ms']:.3f} ms a phase-step, idle {win['idle']:.1%} "
            f"(traced; {win['adam_traced']} of {GAN_STEPS} Adam kernels in "
            f"the trace); losses d {est.losses[-2]:.4f}, g "
            f"{est.losses[-1]:.4f} at the end; Adam counts {counts}; "
            f"launches {launches} ({card_line})")
        if counts != (GAN_STEPS, GAN_STEPS) \
                or not np.all(np.isfinite(est.losses)):
            raise AssertionError(f"tfpark_gan: the traced call's phase "
                                 f"counts {counts} or losses")
        z = noise[:GAN_BATCH]
        mem = est.generate(z)
        again = dcgan(os.path.join(tmp, "card")).generate(z)
        log(f"tfpark_gan: generate from the checkpoint equal to generate in "
            f"memory: {np.array_equal(mem, again)} ({mem.shape}, range "
            f"{mem.min():.3f} .. {mem.max():.3f})")
        if not np.array_equal(mem, again) or mem.shape != (GAN_BATCH, 28,
                                                            28, 1):
            raise AssertionError("tfpark_gan: the checkpoint's samples")
        del est, cpu
    free_device_memory("after tfpark_gan")
    log(f"phase tfpark_gan: {time.perf_counter() - t_phase:.1f} s")
    return launches


def logit_err(got, want) -> float:
    """The largest difference between the logits under two softmax
    outputs, relative to each row's range of ``want``'s logits.  The
    logits are the log-probabilities with each row's shift (the one thing
    a softmax loses) taken out: ``(log got - log want)`` less its row
    mean.  NaN where a probability is 0 or not finite."""
    with np.errstate(divide="ignore", invalid="ignore"):
        a = np.log(np.asarray(got, np.float64))
        b = np.log(np.asarray(want, np.float64))
        d = a - b
        d -= d.mean(-1, keepdims=True)
        err = np.abs(d).max(-1) / (b.max(-1) - b.min(-1))
    return float(err.max()) if np.all(np.isfinite(err)) else float("nan")


def caffe_blob(arr) -> bytes:
    from analytics_zoo_tpu_torch.pipeline.api.onnx.proto import (
        _put_bytes,
        _put_varint,
    )

    out, shape = bytearray(), bytearray()
    for d in arr.shape:
        _put_varint(shape, 1, d)
    _put_bytes(out, 7, bytes(shape))
    _put_bytes(out, 5, np.ascontiguousarray(arr, np.float32).tobytes())
    return bytes(out)


def caffemodel_bytes(blobs: dict) -> bytes:
    """A binary NetParameter holding ``blobs`` ({layer: [arrays]}), written
    with the port's wire codec (caffe.proto's field numbers)."""
    from analytics_zoo_tpu_torch.pipeline.api.onnx.proto import _put_bytes

    out = bytearray()
    _put_bytes(out, 1, b"AlexNet")
    for name, arrs in blobs.items():
        layer = bytearray()
        _put_bytes(layer, 1, name.encode())
        for a in arrs:
            _put_bytes(layer, 7, caffe_blob(a))
        _put_bytes(out, 100, bytes(layer))
    return bytes(out)


def import_finetune(tag, net, x, y, steps, card_line) -> dict:
    """``steps`` Adam(IMPORT_LR) steps of ``net`` at batch IMPORT_BATCH through
    ``fit`` (one epoch): finite losses and one Adam launch a step for each
    256 of its f32 leaves of at least 128 elements."""
    import torch

    from analytics_zoo_tpu_torch.common.utils import tree_leaves
    from analytics_zoo_tpu_torch.ops.cuda import fused_adam as fad
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import Adam

    net.compile(optimizer=Adam(lr=IMPORT_LR),
                loss="sparse_categorical_crossentropy")
    kernel_leaves = sum(1 for t in tree_leaves(net.params)
                        if t.dtype == torch.float32
                        and t.numel() >= fad.MIN_KERNEL_LEAF)
    per_step = -(-kernel_leaves // fad.TABLE_LEAVES)
    reset_counters()
    t0 = time.perf_counter()
    net.fit(x[:IMPORT_BATCH * steps], y[:IMPORT_BATCH * steps],
            batch_size=IMPORT_BATCH, nb_epoch=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters()
    losses = [v for _, v in net._estimator.loss_log]
    log(f"{tag} fine-tune: {steps} Adam steps at batch {IMPORT_BATCH} in "
        f"{wall:.2f} s (step 1 eager and captured), losses "
        f"{[round(v, 4) for v in losses]}; {kernel_leaves} kernel leaves, "
        f"{per_step} launch(es) a step; launches {launches} ({card_line})")
    expect_launches(f"{tag} fine-tune", launches,
                    fused_adam=steps * per_step)
    if len(losses) != steps or not np.all(np.isfinite(losses)):
        raise AssertionError(f"{tag}: the fine-tune's losses {losses}")
    return launches


def model_import_phase(card_line: str) -> dict:
    """The importers on the card.  ONNX: the port's seeded ResNet-50 (its
    moving statistics from one batch) through ``export_onnx``, then
    ``Net.load_onnx``, served by a captured ``InferenceModel`` request of
    32 images (NCHW), whose logits are within IMPORT_TOL of the native
    ResNet-50's on the same images (:func:`logit_err`) and the replay
    bit for bit its eager run, then 3 Adam
    fine-tune steps at 32.  Caffe: BVLC AlexNet's deploy prototxt (written
    here: a public architecture) with seeded weights written as a
    caffemodel, through ``Net.load_caffe``, a captured predict of 32
    images of 227 x 227 whose logits are within IMPORT_TOL of the same
    files' on the CPU, then 2
    Adam fine-tune steps.  A ``TorchNet`` inside a ``Sequential``: its
    captured predict bit for bit its eager forward.  ``TFNet`` raises the
    reference's ``ImportError`` where TensorFlow is absent.  Returns the
    path's launch counts."""
    import os
    import tempfile

    import torch

    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.models import ResNet
    from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.normalization \
        import recalibrate_batchnorm
    from analytics_zoo_tpu_torch.pipeline.api.net import Net, TFNet, TorchNet
    from analytics_zoo_tpu_torch.pipeline.api.onnx import (
        OnnxNet,
        export_onnx,
        proto,
    )
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

    t_phase = time.perf_counter()
    gen = np.random.default_rng(SEED + 160)
    total = {}
    init_zoo_context(seed=SEED, device="cuda")

    # ONNX: ResNet-50 out and back in
    native = ResNet.image_net(50, input_shape=IMPORT_RESNET_SHAPE)
    native.build_params()
    x = gen.uniform(-1, 1, (3 * IMPORT_BATCH,) + IMPORT_RESNET_SHAPE
                    ).astype(np.float32)
    recalibrate_batchnorm(native, x[:IMPORT_BATCH])
    t0 = time.perf_counter()
    data = export_onnx(native)
    export_s = time.perf_counter() - t0
    graph = proto.decode_model(data).graph
    ops = sorted({n.op_type for n in graph.nodes})
    log(f"model_import onnx: ResNet-50 exported in {export_s:.2f} s: "
        f"{len(data)} bytes, {len(graph.nodes)} nodes ({', '.join(ops)}), "
        f"{len(graph.initializers)} initializers")
    onnx_net = Net.load_onnx(data)
    if not isinstance(onnx_net, OnnxNet) or len(graph.nodes) != 176:
        raise AssertionError("model_import onnx: the exported graph")
    m = Sequential()
    m.add(onnx_net)
    m.build_params()
    x_nchw = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    batch = x_nchw[:IMPORT_BATCH]
    want = native.predict(x[:IMPORT_BATCH], batch_size=IMPORT_BATCH)
    im = InferenceModel().from_keras_net(m)
    im.warmup([batch.shape[1:]], batch_sizes=[IMPORT_BATCH])
    reset_counters()
    got = im.predict(batch)
    eager = eager_predict(im, [batch])
    err = logit_err(got, want)
    key = ((batch.shape, str(batch.dtype)),)
    dev = replay_ms(graph_of(im._steps[key].step), reps=3)
    log(f"model_import onnx: a captured InferenceModel request of "
        f"{IMPORT_BATCH} against the native ResNet-50: logits max err "
        f"{err:.2e} of the row's range (tol {IMPORT_TOL:g}), probabilities "
        f"max abs err {np.abs(got - want).max():.2e} (top probability "
        f"{got.max():.4f}), the replay bit for bit its eager run: "
        f"{np.array_equal(got, eager)}; device {dev:.2f} ms a request "
        f"({card_line})")
    if not err <= IMPORT_TOL or not np.array_equal(got, eager):
        raise AssertionError("model_import onnx: the imported ResNet-50 "
                             "disagrees")
    total = add_launches(total, counters())
    del im, native
    free_device_memory("after the ONNX request")
    y = gen.integers(0, 1000, len(x_nchw)).astype(np.int32)
    total = add_launches(total, import_finetune(
        "model_import onnx ResNet-50", m, x_nchw, y, 3, card_line))
    del m, onnx_net, x, x_nchw
    free_device_memory("after the ONNX fine-tune")

    # Caffe: AlexNet's deploy prototxt and a seeded caffemodel
    blobs = {}
    for name, shape in ALEXNET_BLOBS.items():
        fan_in = int(np.prod(shape[1:]))
        blobs[name] = [
            (gen.normal(size=shape) * np.sqrt(2.0 / fan_in)).astype(
                np.float32),
            (gen.normal(size=shape[0]) * 0.01).astype(np.float32)]
    x = gen.uniform(-1, 1, (2 * IMPORT_BATCH, 3, 227, 227)).astype(
        np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        def_path = os.path.join(tmp, "deploy.prototxt")
        model_path = os.path.join(tmp, "alexnet.caffemodel")
        with open(def_path, "w") as f:
            f.write(ALEXNET_DEPLOY)
        with open(model_path, "wb") as f:
            f.write(caffemodel_bytes(blobs))
        del blobs
        outs = []
        for device in ("cpu", "cuda"):
            m = Sequential()
            m.add(Net.load_caffe(def_path, model_path))
            m.build_params(device=device)
            if device == "cuda":
                reset_counters()
            t0 = time.perf_counter()
            outs.append(m.predict(x[:IMPORT_BATCH], batch_size=IMPORT_BATCH))
            ms = (time.perf_counter() - t0) * 1e3
        dev = replay_ms(graph_of(m._predict_fn[1]), reps=3)
        err = logit_err(outs[1], outs[0])
        log(f"model_import caffe: AlexNet ({len(m.layers[0].layers)} "
            f"layers after the train-only ones, groups of 2 on conv2, conv4 "
            f"and conv5, LRN after conv1 and conv2) predict of "
            f"{IMPORT_BATCH} images of 227 x 227 on the card "
            f"({ms:.0f} ms host clock with the capture, device {dev:.2f} ms "
            f"a replay) against the CPU: logits max err {err:.2e} of the "
            f"row's range (tol {IMPORT_TOL:g}), probabilities max abs err "
            f"{np.abs(outs[1] - outs[0]).max():.2e} (top probability "
            f"{outs[1].max():.4f}) ({card_line})")
        if not err <= IMPORT_TOL or outs[1].shape != (IMPORT_BATCH, 1000):
            raise AssertionError("model_import caffe: AlexNet disagrees with "
                                 "the CPU")
        total = add_launches(total, counters())
        y = gen.integers(0, 1000, len(x)).astype(np.int32)
        total = add_launches(total, import_finetune(
            "model_import caffe AlexNet", m, x, y, 2, card_line))
        del m, x
    free_device_memory("after the Caffe AlexNet")

    # TorchNet inside a Sequential: captured predict against eager
    torch.manual_seed(SEED)
    module = torch.nn.Sequential(
        torch.nn.Conv2d(3, 32, 3, padding=1), torch.nn.ReLU(),
        torch.nn.Conv2d(32, 64, 3, stride=2, padding=1), torch.nn.ReLU(),
        torch.nn.AdaptiveAvgPool2d(1), torch.nn.Flatten())
    m = Sequential()
    m.add(TorchNet.from_pytorch(module, input_shape=(3, 32, 32)))
    m.add(Dense(10, activation="softmax"))
    m.build_params()
    xt = gen.normal(size=(16, 3, 32, 32)).astype(np.float32)
    reset_counters()
    m.predict(xt, batch_size=16)  # the eager run and the capture
    replayed = m.predict(xt, batch_size=16)
    with torch.no_grad():
        eager, _ = m.forward(m.params, torch.from_numpy(xt).cuda(),
                             state=m.state)
    same = np.array_equal(replayed, eager.cpu().numpy())
    log(f"model_import torchnet: a captured predict of a TorchNet and a "
        f"Dense bit for bit its eager forward: {same}; the module's "
        f"parameters stay out of the tree: {list(m.params)}")
    if not same or list(m.params) != ["dense_0"]:
        raise AssertionError("model_import: TorchNet's captured predict")
    total = add_launches(total, counters())
    try:
        import tensorflow  # noqa: F401
        log("model_import tfnet: TensorFlow is installed here; TFNet runs "
            "on the host, uncaptured (the CPU tests hold it)")
    except ImportError:
        net = TFNet(lambda t: t, input_shape=(4,))
        try:
            net.ensure_built((4,))
        except ImportError as e:
            log(f"model_import tfnet: no TensorFlow here, TFNet raises the "
                f"reference's ImportError: {e}")
        else:
            raise AssertionError("model_import: TFNet built without TF")
    del m
    free_device_memory("after model_import")
    log(f"phase model_import: {time.perf_counter() - t_phase:.1f} s")
    return total


def main() -> int:
    import torch

    seconds = {}

    def phase(name, fn, *args):
        """``fn(*args)``, its seconds logged and kept under ``name``."""
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        log(f"phase seconds {name}: {seconds[name]:.1f}")
        return out

    card_line = card()
    dev = torch.device("cuda")
    phase("build", build_kernels)
    fwd = phase("kernels_flash_fwd", kernel_phase, dev)
    bwd = phase("kernels_flash_bwd", flash_train_phase, dev, fwd)
    phase("kernels_flash_dims", flash_dims_phase, dev, fwd, bwd)
    phase("kernels_flash_f16", flash_f16_phase, dev, fwd, bwd)
    shapes = [tuple(t.shape) for t in tree_leaves_of_bert()]
    adam = phase("kernels_adam", adam_phase, dev, shapes)
    xent = phase("kernels_xent", xent_phase, dev)
    weights = int8_weights(dev)
    int8 = phase("kernels_int8_matmul", int8_kernel_phase, dev, weights)
    conv8, quant8 = phase("kernels_int8_conv", int8_conv_kernel_phase, dev)
    # the forward with its (m, l) statistics: the TPU's attention_stats,
    # one kernel with row 1, launched with statistics wherever a gradient
    # is needed (the training path)
    stats = {"name": "attention_stats", "route": "cuda",
             "source": fwd["source"], "replaces": REPLACES["attention_stats"],
             **fwd["train"]}
    entries = [fwd, stats, bwd, adam] + xent + [int8, conv8, quant8]
    reset_counters()  # serving main path: counted inside slice_phase
    serving = {"flash_attention_fwd": phase("serving", slice_phase,
                                            card_line)}
    training, f32_training = phase("training", training_phase, card_line)
    training_bf16 = phase("training_bf16", training_bf16_phase, card_line,
                          f32_training)
    training_f16 = phase("training_f16", training_f16_phase, card_line,
                         f32_training)
    int8_serving = phase("int8_serving", int8_serving_phase, card_line,
                         weights, int8)
    training_d192 = phase("training_d192", training_d192_phase, card_line)
    serving_d384 = phase("serving_d384", serving_d384_phase, card_line)
    captured, _ = phase("captured_training", captured_training_phase,
                        card_line)
    serving_captured = phase("captured_serving", captured_serving_phase,
                             card_line)
    bert_adamw = phase("bert_adamw", bert_adamw_phase, card_line)
    lenet, lenet_err = phase("lenet", lenet_phase, card_line)
    adam["max_abs_err"] = max(adam["max_abs_err"], lenet_err)
    optimizers = phase("optimizers", optimizers_phase, card_line)
    resnet_training, resnet_serving = phase("resnet50", resnet50_phases,
                                            card_line)
    resnet_int8 = phase("resnet50_int8", resnet50_int8_phase, card_line)
    inc_training, inc_serving, inc_shapes = phase(
        "inception_v1", inception_phases, card_line)
    inc_adam, inc_err = phase("inception_v1_adam", inception_adam_phase,
                              card_line, inc_shapes)
    adam["max_abs_err"] = max(adam["max_abs_err"], inc_err)
    mnv2_training, mnv2_serving = phase("mobilenet_v2", mobilenet_v2_phases,
                                        card_line)
    zoo_serving = phase("zoo_serving", zoo_serving_phase, card_line)
    zoo_int8 = phase("zoo_int8", zoo_int8_phase, card_line)
    fault_tolerant = phase("fault_tolerant_fit", fault_tolerant_phase,
                           card_line)
    text = phase("text_classifier", text_classifier_phase, card_line)
    recommenders = phase("recommenders", recommenders_phase, card_line)
    moe = phase("moe_transformer", moe_transformer_phase, card_line)
    text_matching = phase("text_matching", text_matching_phase, card_line)
    autograd = phase("autograd", autograd_phase, card_line)
    tfpark_text = phase("tfpark_text", tfpark_text_phase, card_line)
    cluster = phase("cluster_serving", cluster_serving_phase, card_line)
    inst_fit = phase("instrumented_fit", instrumented_fit_phase, card_line)
    data_plane = phase("image_data_plane", image_data_plane_phase, card_line)
    fleet_router = phase("fleet_router", fleet_router_phase, card_line)
    fleet_process = phase("fleet_process", fleet_process_phase, card_line)
    ssd = phase("ssd", ssd_phase, card_line)
    tfpark_bert, tfpark_errs = phase("tfpark_bert", tfpark_bert_phase,
                                     card_line)
    for entry, key in ((fwd, "flash_attention_fwd"),
                       (stats, "flash_attention_fwd"),
                       (bwd, "flash_attention_bwd")):
        entry["max_abs_err"] = max(entry["max_abs_err"], tfpark_errs[key])
    tfpark_gan = phase("tfpark_gan", tfpark_gan_phase, card_line)
    model_import = phase("model_import", model_import_phase, card_line)
    eval_captured = {k: sum(c.get(k, 0) for c in EVAL_LAUNCHES.values())
                     for k in counters()}
    for entry in entries:
        name = entry["name"]
        paths = {"serving": serving.get(name, 0),
                 "training": training.get(name, 0),
                 "training_bf16": training_bf16.get(name, 0),
                 "training_f16": training_f16.get(name, 0),
                 "int8_serving": int8_serving.get(name, 0),
                 "training_d192": training_d192.get(name, 0),
                 "serving_d384": serving_d384.get(name, 0),
                 "training_captured": captured.get(name, 0),
                 "serving_captured": serving_captured.get(name, 0),
                 "eval_captured": eval_captured.get(name, 0),
                 "training_lenet": lenet.get(name, 0),
                 "resnet50_training": resnet_training.get(name, 0),
                 "resnet50_serving": resnet_serving.get(name, 0),
                 "inception_v1_training": inc_training.get(name, 0),
                 "inception_v1_serving": inc_serving.get(name, 0),
                 "inception_v1_adam": inc_adam.get(name, 0),
                 "mobilenet_v2_training": mnv2_training.get(name, 0),
                 "mobilenet_v2_serving": mnv2_serving.get(name, 0),
                 "zoo_serving": zoo_serving.get(name, 0),
                 "bert_adamw": bert_adamw.get(name, 0),
                 "optimizers": optimizers.get(name, 0),
                 "resnet50_int8": resnet_int8.get(name, 0),
                 "zoo_int8": zoo_int8.get(name, 0),
                 "fault_tolerant_fit": fault_tolerant.get(name, 0),
                 "text_classifier": text.get(name, 0),
                 "recommenders": recommenders.get(name, 0),
                 "moe_transformer": moe.get(name, 0),
                 "text_matching": text_matching.get(name, 0),
                 "autograd": autograd.get(name, 0),
                 "tfpark_text": tfpark_text.get(name, 0),
                 "cluster_serving": cluster.get(name, 0),
                 "instrumented_fit": inst_fit.get(name, 0),
                 "image_data_plane": data_plane.get(name, 0),
                 "fleet_router": fleet_router.get(name, 0),
                 "fleet_process": fleet_process.get(name, 0),
                 "ssd": ssd.get(name, 0),
                 "tfpark_bert": tfpark_bert.get(name, 0),
                 "tfpark_gan": tfpark_gan.get(name, 0),
                 "model_import": model_import.get(name, 0)}
        if name == "attention_stats":
            # training launches the forward with its statistics
            paths = dict({p: 0 for p in paths},
                         training=training["flash_attention_fwd"],
                         training_bf16=training_bf16["flash_attention_fwd"],
                         training_f16=training_f16["flash_attention_fwd"],
                         training_d192=training_d192["flash_attention_fwd"],
                         training_captured=captured["flash_attention_fwd"],
                         bert_adamw=bert_adamw["flash_attention_fwd"],
                         fault_tolerant_fit=fault_tolerant[
                             "flash_attention_fwd"],
                         moe_transformer=moe["flash_attention_fwd"],
                         instrumented_fit=inst_fit["flash_attention_fwd"],
                         tfpark_bert=tfpark_bert["attention_stats"])
        entry["launches"] = sum(paths.values())
        entry["launches_by_path"] = paths
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    log("phase seconds: " + json.dumps(
        {k: round(v, 1) for k, v in seconds.items()}))
    log(json.dumps({"kernels": [
        {**{k: e[k] for k in keys}, **{k: v for k, v in e.items()
                                         if k not in keys}}
        for e in entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
