#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and hold its kernels to their
plain versions.

    python3 chip_smoke.py

``--phase 32`` and ``--phase 33`` run that phase alone, ``--native-ops``
times the native codec's ops by thread count against numpy's,
``--host-line [ROOT]`` times a numpy-input party's steps on the native
codec and on numpy, or on the package of the checkout at ROOT (all
three below).

Needs one CUDA card and ``nvcc``; exits non-zero, with no result line,
when ``torch.cuda.is_available()`` is false or the port's package is not
beside this script. Phases, any failure ending the run with a traceback:

1. device and build: the card's name and power limit, then the kernels
   built from ``split_learning_tpu_torch/csrc`` (build seconds printed);
2. fused cross-entropy (K1: one forward launch, one backward launch)
   against its plain version over N in {1, 32, 64, 1000, 4096} x C in
   {10, 256, 1000} (C 10 is the CNN's and the classifier's) and the LM
   training path's [65536, 256] logits, float32 and bf16: the loss within
   1e-5 of it, the float32 gradient within 1e-6 and within 1e-5 of its
   largest entry, the bf16 gradient within one bf16 ulp; two runs
   bit-identical; a +inf or NaN logit, an all -inf row and a label
   outside [0, C) each give a NaN loss and leave the other rows as the
   plain version's;
3. multi-tensor SGD (K2) against its plain version on the split CNN's 6
   leaves, the LM's 54 and 300 leaves of mixed odd sizes (every third not
   16-byte aligned), without and with momentum, over five steps:
   bit-identical, each step one launch;
4. the main path: ``FusedSplitTrainer`` on ``cuda`` with the full-width
   split CNN, batch 64, synthetic MNIST, 30 steps. Launch counts are
   reset just before and read just after; each kernel must have run
   exactly once per step. The loss must fall, a CPU twin started from
   the same parameters must agree on the first three losses, and the CLI
   (``launch.run.main``) must train five steps and return 0;
5. times with CUDA events: kernel, plain version and one PyTorch library
   call computing the same function, at the main path's shapes, beside
   the least time the card could take (``bound_ms``); K1 also at the LM's
   [65536, 256] and in bf16, with a profiler window showing one device
   kernel per forward; the main path's
   median step time, and a ``torch.profiler`` window of 20 more steps
   giving the device's idle share and its time by kernel;
6. flash attention (forward) against its plain version over T in {1, 63,
   64, 65, 1000, 1024, 2048}, D in {16, 24, 64, 100, 128, 256} (24 and
   100 are padded to the next tile width; 100 in bf16 has rows that are
   not 16-byte aligned and takes the kernel's scalar loads), B*H in {1,
   16}, non-causal, causal and causal+strict, float32 and bfloat16, plus
   strided q/k/v views (D 40 aligned, D 50 not, in either dtype) and the
   training shape (B 64, T 1024, H 2, D 128, causal): O and LSE within
   2e-5 (float32: the 3xTF32 products and the tile loop's order against
   one dense float32 softmax) and within 1.6e-2 / 1e-3 (bfloat16: the
   plain version rounds P to bf16 where the kernel does, so what is left
   is two bf16 ulps of an |o| below 2), row 0 of a strict mask o = 0
   and lse = NEG_BIG;
7. the serving path at full width: the split causal LM (bf16, d_model
   256, 2 heads, vocab 256, depths 1 + 2, max_len 2048, attn="flash")
   from a seeded init. Launch counts reset before and read after each
   of: ``greedy_generate`` at batch 8, prompt 1024, 256 new tokens, KV
   cache (exactly 3 flash launches, one per block); the same with
   ``kv_cache=False`` and 16 new tokens (exactly 3 x 16);
   ``sample_generate`` (temperature 0.8, top-k 40, top-p 0.9: tokens in
   the vocabulary, the same seed gives the same tokens); ``evaluate`` on
   ``synthetic_lm`` at seq_len 1024 (finite perplexity, 3 launches per
   batch). A float32 CPU twin from the same parameters: prefill logits
   within 1e-4, and each of 32 greedy tokens of the card within 1e-4 of
   the CPU row's max logit;
8. times at the prefill shape (B 8, T 1024, H 2, D 128, causal) and at
   the training shape (B 64), bf16 and float32: kernel, plain,
   ``F.scaled_dot_product_attention`` and the bound (operations over the
   bf16 tensor-core peak, or for float32 inputs over the TF32 peak / 3,
   the three products of the 3xTF32 split); prefill ms, KV-decode and
   re-forward tokens/s, and a ``torch.profiler`` window over one KV
   generate;
9. the flash-attention backward (K6: its delta, dK/dV and dQ launches)
   against its plain version over the forward's T, D, B*H and masks,
   float32 and bfloat16, without and with an LSE cotangent, plus the
   strided views and the training shape (B 64, T 1024, H 2, D 128,
   causal): every gradient within ``FA_BWD_TOL`` of the largest plain
   entry (float32 2e-5: the 3xTF32 products and the tile loop's
   summation order against one dense float32 sum per product; bf16
   8e-3: two bf16 ulps of that entry, both sides rounding P and dS to
   bf16 and then float32 sums), strict row 0 dQ = 0; autograd
   through ``flash_attention_with_lse`` against autograd of dense
   attention, and two runs giving bit-identical dQ, dK, dV;
10. the training path at full width: ``FusedSplitTrainer`` on ``cuda``
   with the split causal LM (float32, d_model 256, 2 heads, vocab 256,
   depths 1 + 2, max_len 2048, attn="flash"), ``synthetic_lm`` at
   seq_len 1024, batch 64, 30 steps of SGD at lr 0.1, momentum 0.9.
   Launch counts reset before and read after: per step exactly 3 K5
   and 3 of each K6 launch, one K1 pair and one K2 launch (54 leaves). The loss must fall; a float32 CPU twin on the first 2 rows
   of the first 3 batches agrees with the card on the same rows: losses
   within ``TWIN_TOL``, each leaf's summed update within
   ``TWIN_UPDATE_TOL`` of its largest entry (or of a floor, for leaves
   whose exact gradient is zero), and the same twin with the
   plain backward's dQ planted as zero must fail that bound; the CLI
   trains ``transformer_lm`` (flash) for 5 steps
   at a small size, and the classifier ``transformer`` at T 256, batch
   64, for 5 steps at full width, each with exact launch counts;
11. times at the training shape (B 64, T 1024, H 2, D 128, causal,
   float32 and bf16; bounds as in phase 8): each K6 launch, the whole
   backward, its plain version, ``torch.linalg.vecdot`` for the delta launch and the backward
   of ``F.scaled_dot_product_attention`` (``torch.autograd.grad`` on a
   retained graph) for the whole, beside the bound; the
   step's median ms over steps 6-30, tokens/s, and a
   ``torch.profiler`` window of 10 steps.
12. the wire kernels against their plain versions: K3's amax/quantize
   (one cooperative launch writing {amax, scale} ahead of q) and
   dequantize, K4's magnitude fold (``magnitudes()``) and K4's five
   select launches (the codec's whole topk8 encode), over sizes 1, 7, 8,
   9, 32 and 288 (stage A's leaves, phase 23's bottom sync), 127, 4099,
   the U-shaped CNN's hop 2 ([64, 9216], phase 20), the CNN cut
   (1,384,448), the generate cut ([8, 1040, 256]) and the LM cut ([64,
   1024, 256]) and phase 27's three ResNet-18 cuts at a microbatch of
   32 (2,097,152, 1,048,576 and 524,288), random, all-equal, all-zero
   and exact-half inputs, float32 and bf16, densities 0.01 (index form),
   0.1 (bitmap), 0.2 (phase 27's controller's next rung) and 1.0,
   without a residual and with one at decay 1.0
   and 0.5: buffers, q, x', x_eff, m, the new residual and the flag
   bit-equal; the codec's frames from the card byte-equal to the host
   codec's numpy path on the same values, the residuals bit-equal; one
   NaN or infinity refused by both codecs. K4 rebuilt keeping the last
   ties instead of the first must change both all-equal probe frames;
13. the two-party path at full width: ``SplitClientTrainer`` over
   ``LocalTransport(ServerRuntime)`` on ``cuda``, the split CNN at batch
   64, 30 steps in each of ``none``, ``int8`` and ``topk8`` (density
   0.1). Launch counts reset before and read after each: per step
   exactly 1 K1f, 1 K1b and 2 K2 (client and server), plus for int8 2
   K3 amax/quantize and 2 dequantize launches, for topk8 2 of each of
   K4's five select launches. Every card encode makes exactly one host
   sync (counted with ``torch.cuda.set_sync_debug_mode``). At steps 1-3
   of int8 and topk8 each direction's cut tensor and EF residual are
   copied to the host and encoded there: the frames must be byte-equal
   to the card's, with an exact-half probe tensor beside them. The same
   check with K3 rebuilt with ``roundf`` in place of ``rintf`` must
   fail. A CPU twin of the ``none`` run agrees on 5 losses within 1e-4;
14. times at the CNN cut, the generate cut and the LM cut, float32: K3's
   launch against ``torch.amax`` + ``torch.quantize_per_tensor``, the
   dequantize against ``torch.dequantize``, the magnitude fold against
   ``torch.abs``, the whole topk8 encode (with and without the
   residual) against the old one (magnitude kernel, ``select_topk``,
   K3, scatter) and ``torch.topk`` alone, K4's five launches by name
   from a profiler window, each beside its bound; K2 at the LM's 54
   leaves (one launch); the two-party step's median ms (steps 6-30), wire bytes per
   step and a profiler window of 5 steps per mode;
15. split-party LM decode at full width: ``generate_remote`` on ``cuda``
   with the split causal LM (float32, d_model 256, 2 heads, vocab 256,
   depths 1 + 2, max_len 2048, attn="flash") at batch 8, prompt 1024,
   16 new tokens over ``LocalTransport(ServerRuntime)`` with compress
   None, ``none``, ``int8`` and ``topk8`` (density 0.1). Launch counts
   reset before and read after each: exactly 3 K5 per token plus the
   wire launches of two frames per token. None and ``none`` give the
   local re-forward decode's tokens; for int8 and topk8 a second,
   untimed run holds the first 3 tokens' hops to the host codec (frame
   twin) with one host sync per encode, and gives the same tokens.
   Tokens/s and wire bytes per token per mode;
16. the two-party path over HTTP at full width: phase 13's parties from
   the same init, the server a ``SplitHTTPServer`` on 127.0.0.1:0 in a
   thread of this process, the client over ``HttpTransport``, 30 steps
   in each of ``none``, ``int8`` and ``topk8``. Launch counts reset
   before and read after each: phase 13's counts per step; one host
   sync per card encode on either side, with the frame twin at steps
   1-3; the frame bytes of each direction phase 13's plus the HTTP
   frame's own keys (step, client id, wire mode; the echoed step), to
   the byte; the first 5 losses within 1e-4 of phase 13's. Median step
   ms beside phase 13's and a profiler window of 5 steps per mode
   (idle share, memcpy). Then the chaos twin in ``int8`` and ``topk8``:
   server-side ``drop_resp=0.2,corrupt=0.1,http500=0.1,drop_req=0.1``
   at seed 0, the client retrying behind a circuit breaker: no batch
   dropped, the server's /health step 29, one replay hit per fault after
   apply, every retried request frame byte-equal to its first attempt,
   the losses within 1e-5 of a clean HTTP run's (both runs with cuDNN's
   deterministic convolutions: its default backward sums in a varying
   order);
17. split-party inference and the CLI over HTTP: ``evaluate_remote`` on
   phase 16's ``none`` parties over the synthetic MNIST test split at
   batch 64 equals ``evaluate`` of the composed parameters (accuracy
   equal, loss within 1e-5 relative), and over ``int8`` the local int8
   wire's (the same frames; a CPU twin's loss is recorded beside it);
   ``generate_remote`` with phase 15's LM over HTTP in ``none``,
   ``int8`` and ``topk8``:
   exactly 3 K5 per token plus two frames' wire launches, phase 15's
   tokens; then ``launch.run serve --port 0 --device cuda`` as a
   subprocess, ``launch.run.main(["train", "--transport", "http",
   ...])`` against the URL of its ``[serve]`` line (5 int8 steps at lr
   0.02: rc 0, a falling loss, the client's launches), and SIGINT to
   the server (rc 0). Every wait has a timeout;
18. K2 on bf16 leaves, and the fused LM in bf16 at phase 10's width: K2
   alone on mixed float32/bf16 leaf lists (the bf16 LM's 54 leaves,
   whose ``pos`` table is bf16, and 300 leaves of odd sizes alternating
   the dtypes, every third a view one element off its vector alignment),
   momentum 0 and 0.9, five steps: bit-identical to the plain version,
   one launch a step; its time at the bf16 LM's 54 leaves beside
   ``torch.optim.SGD(fused=True)`` and the bound (a bf16 leaf moves 2 +
   2 + 2 bytes and an 8-byte trace read and write). Then
   ``FusedSplitTrainer`` on ``cuda`` with the split causal LM in bf16
   (``synthetic_lm``, batch 64, T 1024, 30 steps) under SGD (lr 0.1,
   momentum 0.9) and under AdamW (lr 3e-4, weight decay 0.1), each with
   a 5-step warmup, a cosine decay to 0 at step 30 and clipping at a
   global norm of 1.0. Launch counts reset before and read after each:
   per step exactly 3 K5, 3 of each K6 launch, one K1 pair, and one K2
   launch under SGD, none under AdamW. The loss must fall, the leaves
   keep their dtypes (float32, the ``pos`` table bf16), and a bf16 CPU
   twin on the first 2 rows of the first 3 batches agrees on those
   rows' losses within two bf16 ulps at the loss's magnitude
   (:func:`bf16_loss_tol` derives it). Median step ms over steps 6-30
   and tokens/s beside phase 10's float32 step, and a profiler window
   of 5 steps per optimizer;
19. the two-party LM at full width: ``SplitClientTrainer`` over
   ``LocalTransport(ServerRuntime)`` with phase 18's LM (the client owns
   the embedding and block 0, the server blocks 1-2 and the head; the
   cut [64, 1024, 256]), AdamW with phase 18's schedule and clipping, in
   float32 and bf16 over ``none``, ``int8`` and ``topk8`` (density 0.1),
   30 steps each. Launch counts reset before and read after each: per
   step exactly 3 K5 and 3 of each K6 launch (client 1, server 2), one
   K1 pair (server), no K2, plus 2 K3 quantize and 2 dequantize launches
   for int8, 2 of each K4s launch for topk8. One host sync per card
   encode; the bf16 frame twin at steps 1-3 of int8 and topk8 (the host
   codec on the same values, widened); a float32 ``none`` CPU twin on
   the first 2 rows of 5 batches within 1e-4. Median step ms, tokens/s,
   frame bytes per step and a profiler window of 5 steps per run. Then
   ``launch.run serve --dtype bfloat16 --optimizer adamw ... --device
   cuda`` as a subprocess, and ``train --transport http`` with the same
   flags (warmup 2, decay 10, clip 1.0, lr 3e-3, int8) for 5 steps
   against it: both rc 0, a falling loss, the client's launches exact
   (its block's K5 and K6, its int8 encode and decode).
20. the U-shaped CNN: ``USplitClientTrainer`` over
   ``LocalTransport(ServerRuntime(mode="u_split"))`` at batch 64, 30
   steps in each of ``none``, ``int8`` and ``topk8``. Launch counts
   reset before and read after each: per step exactly the client's K1
   pair and 2 K2 (A and C), the server's 1 K2 (its own ops counted
   apart), plus four frames' wire launches (4 K3 quantize and 4
   dequantize, or 4 of each K4s launch). The loss falls; frame bytes per
   hop and direction, median step ms and a profiler window per mode; a
   CPU twin of each mode (its hops through the host codec) agrees on 2
   losses within 1e-4 (``none``) or 1e-3 (``int8``, ``topk8``);
21. the U-shaped LM at full width (d_model 256, 2 heads, vocab 256,
   depths 1 + 2, ``attn="flash"``), bf16 under AdamW with phase 18's
   schedule and clipping, batch 64, T 1024, 20 steps in each of
   ``int8``, ``topk8`` and ``none``: per step exactly the client's 1 K5,
   1 of each K6 launch and the K1 pair, the server's 4 K5 (hop 1 and
   hop 2's recompute) and 2 of each K6 launch (counted apart), no K2,
   and four frames' wire launches; the loss falls; a bf16 CPU twin on
   the first 2 rows of 3 batches within :func:`bf16_loss_tol`;
22. federated training over HTTP: a ``SplitHTTPServer`` thread in
   front of ``ServerRuntime(mode="federated", num_clients=2)`` on the
   card and two ``FederatedClientTrainer``s on ``HttpTransport`` in two
   threads, the CNN at batch 64, 2 epochs of 20 steps on disjoint
   halves: exactly the K1 pair and one K2 per client step; after each
   epoch both clients' parameters bit-identical and within 1e-6 of the
   mean of their pre-sync parameters, computed on the card; the
   aggregate round trip ms and its bytes each way;
23. ``MultiClientSplitRunner``: 4 clients against one ``ServerRuntime``
   over ``LocalTransport`` ``topk8``, a ``topk8`` bottom sync every 2
   rounds, 10 rounds, round-robin and then ``concurrent=True``: exact
   launches (per round the K1 pair 4, K2 8, each K4s launch 8; per
   compressed sync 5 x 2 leaves x 4 clients, none on the first), the
   bottoms equal after each sync, the handshakes, the sync byte
   counters and the round ms. Then ``serve --mode u_split`` with phase
   19's LM flags as a subprocess and ``train --mode u_split --transport
   http`` against it for 5 int8 steps (the client's launches exact: 1
   K5 and 1 of each K6, the K1 pair, 2 int8 encodes and decodes a
   step), and ``train --mode federated --transport local`` on the CNN
   (the K1 pair and one K2 a step): rc 0 and a falling loss each;
24. checkpoints and what loads them, through the CLI: phase 18's bf16
   AdamW LM at full width trains 20 steps with ``--checkpoint-every
   10``, against 10 steps and ``--resume`` for 10 more (the resumed
   losses within 2 bf16 ulps, bit-equality reported; per resumed step
   exactly 3 K5, 3 of each K6, the K1 pair, no K2; the ms each save
   blocked the loop, the write's ms, the step's bytes, the restore's
   ms); ``eval`` of that checkpoint against ``evaluate()`` of the live
   trainer's parameters within 1e-5 relative (examples/s), ``generate``
   of 64 tokens with the KV cache (3 K5: the prefill) and without (3 K5
   a token) equal to ``greedy_generate`` of the live parameters, and
   ``generate --server-url`` against ``serve --resume`` of it (the
   client's K5 and its int8 encode and decode a token); the two-party
   CNN over HTTP per wire mode, 5 steps against ``serve
   --checkpoint-every 1`` (a subprocess), a stop, ``serve --resume``,
   the in-flight step's frame replayed byte for byte and ``train
   --resume`` for 5 more, within phase 20's twin tolerances of 10
   uninterrupted steps (topk8: clearing both ledgers moves the series);
   a resumed client against a fresh server exits 3; ``train
   --prefetch 2`` against ``--prefetch 0`` on the CNN (the same losses
   bit for bit under deterministic cuDNN, both median step ms, a
   profiler window with the batch copies on a stream of their own);
   then the card tests of these pieces.
25. the server under many clients. (a) Coalescing: 4 clients of
   ``MultiClientSplitRunner(concurrent=True)`` (the split CNN, batch 64,
   float32, SGD lr 0.01) against one server on the card, on the local
   wire (``none``, ``int8``) and over HTTP (``int8``), with the server
   serialized, coalescing 4 in a 2 ms window, and continuous: round ms,
   mean occupancy, flush reasons and exact launches (the server's K1
   pair and K2 once a group, each client's K2 and the wire's once a
   step); one group of four through ``_dispatch_group`` on the card
   (exactly one K1 forward, one backward, one K2) and on the CPU, within
   1e-4. (b) 2BP: the CNN coupled, at lag 0 and at lag 2 (the reply's
   round trip as the client sees it, the step, per step K1 twice and
   the server's K2 once, the queue never deeper than the lag, lag 0
   within 1e-4 of the coupled series); the bf16 AdamW LM two-party on
   ``topk8``, coupled and at lag 1 (step ms; the server's K5 and each
   K6 launch 2 a step coupled, 4 decoupled). (c) The pipelined client on
   the CNN over HTTP on ``int8``: depth 1 bit-equal to
   ``SplitClientTrainer`` under deterministic cuDNN, then depths 1, 2
   and 4 against ``serve --allow-out-of-order`` (a subprocess): ms a
   step; the bf16 LM on ``topk8`` at depth 2 (the client's K5 twice a
   step: its backward recomputes the forward). (d) Admission over HTTP:
   2 tenants, tenant 0 at 2 steps/s: its client gets 429s with
   ``Retry-After``, retries, completes every step, and the counters are
   the clients'. Then the card tests of these pieces.
26. the image families on synthetic CIFAR-10 (no CIFAR-10 files are in
   the repository). K5 and K6 non-causal against their plain versions
   at the ViT's shapes ([8, 49, 4, 16]: MNIST's defaults, a ragged T;
   [128, 64, 4, 16]: CIFAR-10's; [128, 64, 6, 64]: ViT-S), float32 and
   bf16, with their times beside SDPA's and the bound. ResNet-18 through
   ``launch.run.main(["train", "--model", "resnet18", "--dataset",
   "cifar10", ...])`` at batch 128 for 30 steps, float32 and bf16, SGD:
   exactly one K1 pair and one K2 a step; step ms (median of steps
   6-30, from the loss records' host times), images/s; a trainer of the
   same config: its FLOPs a step (``FusedSplitTrainer.step_flops``) beside
   the bound and a profiler window with the device's shares of conv,
   norm and layout-copy kernels; a CPU twin of 3 steps at batch 16 from
   the trained state, each step from one state on both devices (losses
   within :data:`IMG_TWIN_TOL`, bf16 within :func:`bf16_loss_tol`; each
   step's update within :data:`IMG_UPDATE_TOL`, bf16 within
   :data:`IMG_BF16_UPDATE_FACTOR` times its own rounding). ResNet-18's two
   parties in one process at batch 128 on ``none`` and ``int8``, 10
   steps: the server's K1 pair and K2 inside its ``split_step``, the
   client's K2 and two frames' wire launches a step, exactly; one host
   sync per card encode, the frame twin at steps 1-3, frame bytes each
   way, a CPU twin from the parties' trained state. ViT-S (d_model 384,
   6 heads, 2 +
   10 blocks, patch 4) in bf16 under AdamW with a warmup, cosine decay
   and clipping through the CLI, as the ResNet: exactly 12 K5, 12 of
   each K6 launch and one K1 pair a step. The default ViT's two parties
   on ``topk8`` (K5/K6 on both: the client's 1 a step, the server's 2).
   Then the card tests of these pieces.
27. the K-stage chain (``runtime/stage.py``, ``runtime/pipeline_runner.py``,
   ``transport/device.py``, ``transport/density.py``). ``resnet18_4stage``
   (the hub's stem and layer1; layer2, layer3 and the head as
   ``StageRuntime`` parties) at batch 128, M 4, plain SGD, lag 0, on
   ``DeviceTransport`` in float32 and bf16 for 8 GPipe steps: exactly
   2M K1 pairs (the last stage's loss hops and its deferred apply's
   recompute) and S K2 (the hub and a deferred apply a stage) a step, no
   hop payload on the host, step ms beside phase 26's fused step, the
   measured bubble beside the ideal 3/7, a profiler window; 1F1B
   bit-equal to GPipe (3 steps from one init, deterministic cuDNN); a
   CPU twin of 2 steps at batch 16, each from one state on both devices
   (phase 26's bounds). The same chain on ``LocalTransport`` with
   ``int8``, then ``topk8`` under the adaptive controller (4 steps each):
   (4S - 6) M packs and decodes a step (K3q/K3d, or K4s's five select
   launches a pack) and the wires' bytes; the controller's decisions on
   the card and on the CPU from one init (3 steps at batch 32). Then
   ``split_cnn_chain3`` over HTTP on ``int8``: two ``serve --role
   stage`` parties in this process (``launch.run.serve_party``, port 0)
   and ``launch.run.main(["train", "--stages", "3", ...])`` for 12
   steps at batch 64, M 4, with exact launch counts and a falling loss.
   Then the card tests of these pieces.
28. observability (``obs/``, ``utils/flops.py``, ``utils/profiling.py``,
   ``tracking/mlflow_rest.py``, the CLI's flags). (a) Phase 18's bf16
   AdamW LM through ``launch.run train`` for 12 steps a run, every
   observability flag off, on (``--trace``, ``--profile-dir``,
   ``--flight``, ``--tracking mlflow`` against a stdlib MLflow stub in
   a process of its own), on, off, then twice with all but
   ``--profile-dir``:
   losses bit-equal and launches equal (phase 18's a step) across the
   six, one ``loss`` a step and a finished run
   in the stub, the device trace naming K1, K5 and K6, the flight dump;
   ``FusedSplitTrainer.step_flops`` (no launch) and the MFU against the
   card's bf16 peak at the flags-off step time, and the flags' overhead
   from the pairs, every run timed by the same clock (the loop's loss
   log, ``_StepClock``). (b) ``serve --trace --flight --telemetry`` as a
   subprocess and the ``int8`` CNN client with ``--flight --trace``
   here for 60 steps: ``GET /telemetry`` scraped mid-run until a window
   holds steps (a rate, dispatch p50/p99), ``GET /debug/flight``, the
   server's ``fatal:sigterm`` dump and the client's exit dump joined by
   trace ID step by step, the server's Chrome trace with a non-null
   ``split_step`` MFU (written on SIGTERM), and both processes'
   launches (phase 16's a step). (c) ``resnet18_4stage`` on
   ``DeviceTransport`` for 3 steps through the CLI with
   ``--telemetry-port 0 --trace``: the fleet view names a bottleneck
   party, each stage's MFU is non-null, launches as phase 27's.
29. the fused trainer's ``--scan-steps`` and ``--remat``, server
   replicas and autoscaling (``runtime/fused.py``, ``core/stage.py``,
   ``runtime/replica.py``, ``runtime/autoscale.py``,
   ``runtime/fleet.py``, ``obs/dispatch_debug.py``). (a) Phase 18's bf16
   AdamW LM through ``launch.run train`` for 12 steps stepwise and with
   ``--scan-steps 4``, the dispatch watchdog on: losses bit-equal,
   launches phase 18's a step both ways, one sanctioned host read a
   step stepwise and one a chunk scanned, no watchdog violation; then
   ``--scan-steps 8 --checkpoint-every 6``: JAX's cap warning and saves
   at steps 6 and 12. (b) The same LM with ``--remat`` (losses within
   1e-6 relative, K5 6 launches a step against 3) and ResNet-18 fused in
   float32 at batch 128 for 10 steps with and without ``--remat``: peak
   memory (``max_memory_allocated``) and step ms both ways. (c) ``serve
   --replicas 2 --replica-sync-every 5 --compress int8`` built by the
   CLI in this process, 4 ``int8`` HTTP clients on threads for 10 steps:
   after the first 5 (20 group steps, a sync) the replicas' parameters
   are bit-equal; in the second half the replica of client 0 is killed
   mid-run, once with ``--handoff live`` and once ``checkpoint``: every
   (client, step) applied once group-wide, a re-sent request of a dead
   replica's client served its original reply byte for byte, every
   client's 10 losses finite, phase 16's launches a client step, the
   flight recorder holding ``fl_route``, ``fl_replica_death`` and
   ``fl_handoff_*``. (d) The fleet harness (``runtime/fleet.py``'s
   runnable face, FLEET_ARGS): 64 clients, 4 tenants, burst arrivals,
   continuous batching, against a group under ``--autoscale`` (min 1,
   max 3): at least one scale-up and one scale-down, no dropped step,
   no scale event failed (the pump's and the per-step hook's fault
   counts 0), the per-tenant p99s, no watchdog violation. (e) The
   watchdog itself: the CNN's fused trainer bit-equal with it off and
   on, and a host sync planted in the step scope and one in a custom
   ``autograd.Function``'s backward each counted as unexpected.
30. the device mesh (``parallel/``), n ranks virtual on card 0 (and on
   distinct cards where there are n; the phase prints which). First K5
   and K6 (with an LSE cotangent) at the ring block [64, 256, 2, 128]
   (causal, strict causal, non-causal) and the Ulysses shape [64, 1024,
   1, 128], bf16, against their plain versions, timed beside SDPA. (a)
   Phase 18's bf16 AdamW LM with ``attn="ring_flash"`` through
   ``FusedSplitTrainer`` on a ``seq 4`` mesh: 5 steps, each from its
   state on it and on the unsharded ``attn="flash"`` trainer, losses
   within two bf16 ulps, launches a step K5 48 and each K6 launch 48
   (striped: 3 blocks x 4 ranks x 4 hops), K1f 4, K1b 4 (once a seq
   rank, on its rows: the step is T-partitioned); a CPU twin on 2
   rows; one causal ring call at the contiguous layout (10 of each) and
   the striped (16). (b) The same LM with ``attn="ulysses"`` at ``seq
   2`` on K5/K6 (6 of each a step, K1 2). (c) The fused CNN on a ``data 4``
   mesh, 12 steps, each from one state against the unsharded step
   (within 1e-4 relative), the replicas bit-equal after every step, K1
   and K2 4 a step. (d) ``PipelinedTrainer`` with ``resnet18_4stage``,
   batch 128, M 4, 4 pipe ranks, float32, 3 steps each from one state
   against ``FusedSplitTrainer`` at 4 microbatches (rtol 1e-4, atol
   1e-5). (e) ``train --attn ring_flash`` without ``--seq-parallel``:
   JAX's warning, K5 3 a step; ``--seq-parallel 4`` on fewer than 4
   cards exits 2 with the mesh message.
31. the model axis (tensor parallelism: ``parallel/tensor.py``, the
   sharded parties), every mesh of virtual ranks on card 0. First K5 and
   K6 at a model rank's shape [64, 1024, 1, 128] (bf16, causal) against
   their plain versions, timed beside SDPA. (a) Phase 18's bf16 AdamW LM
   through ``train --model-parallel 2`` (``SLT_CUDA_RANKS=2``) for 3
   steps: K5 and each K6 launch 6, K1f 1, K1b 1, K2 0 a step; then 4
   steps in this process, each from the sharded trainer's state on it
   and on the unsharded one (losses within two bf16 ulps), a rank's
   parameter bytes at most 0.75 of the whole, a CPU twin. (b) The fused
   CNN at batch 64 at ``model 2``, ``model 4`` (the fc row parallel) and
   ``data 2 x model 2`` against the unsharded step from one state (rtol
   1e-4, atol 1e-5): K1 once a data row, K2 once a rank a step;
   ResNet-18 at batch 128, ``model 2``: at most 0.6 of the bytes a rank,
   its steps against the unsharded ones. (c) ``serve --mesh-data 2
   --mesh-model 2`` over HTTP (``none``) against a CNN client at batch
   64, against the unsharded server (rtol 1e-4, atol 5e-4), its /health
   ``mesh`` and its ``gather_bytes``; ``train --transport local
   --mesh-data 2 --mesh-model 2`` paired with the flat run; a coalesced
   group padded to the ``data`` multiple. (d) ``split_cnn_chain3`` on the
   device wire, its middle stage at ``data 2 x model 2``, against the
   flat chain, with no host copy on a hop.
32. the native host codec (``native/``) and the concurrency checker
   (``analysis/``). (a) ``native/slt_codec.cc`` built from nothing with
   this machine's g++ (seconds printed); the frames of the CNN cut [64,
   26, 26, 32] and the LM cut [64, 1024, 256] (float32, seeded) in
   ``int8`` and ``topk8`` at 0.1 without and with EF (two steps) from
   the native codec, the ``SLT_NO_NATIVE=1`` numpy line and the card
   (K3; K4s's five launches), and their decodes (the card's on the
   card), byte-equal; host ms per MB to encode and to decode, native
   against numpy, the median of 20, with ``os.cpu_count()``. (b)
   ``python -m split_learning_tpu_torch.analysis`` over the port and
   this script, one sweep of every ``--check`` scenario cut to 20
   schedules each (the CPU tests sweep each at its own budget) and
   every ``--crash`` scenario at its own budget, five subprocesses at
   once: rc 0, no finding, the schedules explored and the sweeps the
   cut stopped short, seconds. (c) phase 25's coalesced 4-client CNN
   round (``coalesce_max`` 4, an SLO, the clients enqueued in a fixed
   order so every group is the same) for 4 rounds in two subprocesses
   at once, ``SLT_LOCK_DEBUG=1`` and unset: the loss series bit-equal,
   no watchdog violation, ``RequestCoalescer._cond``,
   ``AdmissionController._lock`` and ``_GroupD2H._lock`` instrumented
   (none with the watchdog off), K1 and K2 each round as phase 25's
   coalesced round. Each part prints its line with the card.
33. the ``seq`` axis as JAX lays it out (``parallel/tensor.py``
   ``SeqBlocks``: every op of the step but the attention on a rank's T/n
   tokens) composed with the ``model`` axis, ``model 2 x seq 2`` on
   virtual ranks of card 0. (a) K5 and K6 (with an LSE cotangent) on a
   ring block of one model rank's head, [64, 512, 1, 128] bf16, causal,
   strict and non-causal, and K1 on one seq rank's rows, [32768, 256]
   bf16, against their plain versions, timed beside SDPA and
   ``F.cross_entropy``. (b) Phase 18's bf16 AdamW LM with ``ring_flash``
   and ``ulysses`` through ``train --model-parallel 2 --seq-parallel 2``
   (``SLT_CUDA_RANKS=4``, 2 steps) and through ``FusedSplitTrainer`` (3
   steps, each from its state on it and on the unsharded flash trainer:
   losses within 1e-4, step ms paired): launches a step as
   ``PERF.md`` predicts them (striped ``ring_flash``: K5 and each K6
   launch 24, 3 blocks x 2 model x 2 seq ranks x 2 hops; K1f and K1b 2);
   forward hooks on the first step: every Dense and LayerNorm call, and
   the cut tensor's blocks, hold T/2 tokens; an SGD leg (K2 once a
   model rank a step); ``ring_flash``'s CPU twin. (c) The crossover:
   dense ``full_attention`` against K5+K6, forward and backward, causal,
   H 2, D 128, T 16 to 4096 with B*T 65536, bf16 and float32; the T
   from which flash wins beside ``FLASH_SPEED_T``; ``attn="auto"`` on
   the LM launches K5/K6 at that T and none below it.
   ``--phase 33`` runs it alone (``chiprun_out/p33.json``).

Output, last lines: one JSON object with a record per kernel, one JSON
object with the main path's step time, one with the serving path's
times, one with the LM training path's, one with the two-party path's,
one with split-party decode's, one with the HTTP wire's (``http``), one
with phases 18-19 (``train_lm_bf16``, ``two_party_lm``), one with
phases 20-23 (``u_split``, ``u_split_lm``, ``federated``,
``multi_client``, ``cli``), one with phase 24 (``checkpoint``), one
with phase 25 (``many_clients``), one with phase 26 (``image``), one
with phase 27 (``chain``), one with phase 28 (``obs``), one with
phase 29 (``fleet``), one with phase 30 (``mesh``), one with phase 31
(``model_axis``), one with phase 32 (``analysis_native``), one with
phase 33 (``seq_model``), the
``nvidia-smi`` name and power limit, and ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# (memory bytes/s, float32 FLOP/s outside the tensor cores, bf16 and TF32
# dense tensor-core FLOP/s) by the nvidia-smi name; NVIDIA data sheets,
# dense rates without sparsity at the full power limit
_CARD_PEAKS = (
    ("H100 80GB HBM3", 3.35e12, 67e12, 989e12, 495e12),   # H100 SXM
    ("H100 NVL", 3.9e12, 60e12, 835e12, 417e12),
    ("H100 PCIe", 2.0e12, 51e12, 756e12, 378e12),
    ("H200", 4.8e12, 67e12, 989e12, 495e12),
)

BATCH, STEPS, LR = 64, 30, 0.01
CE_SHAPES_N = (1, 32, 64, 1000, 4096)
CE_SHAPES_C = (10, 256, 1000)   # C 10: the CNN's and the classifier's
CE_LM = (65536, 256)            # the LM training path's [B*T, V] logits
CE_LOSS_RTOL, CE_GRAD_RTOL = 1e-5, 1e-5
CE_PROFILE_CALLS = 10
CNN_LEAF_SHAPES = ((32, 1, 3, 3), (32,), (64, 32, 3, 3), (64,), (10, 9216),
                   (10,))
# flash attention: shapes held to the plain version, and the serving path
FA_T = (1, 63, 64, 65, 1000, 1024, 2048)
FA_D = (16, 24, 64, 100, 128, 256)
FA_BH = ((1, 1), (8, 2))
FA_MASKS = ((False, False), (True, False), (True, True))
FA_STRIDED_D = (40, 50)   # packed views: 16-byte aligned rows, and not
FA_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1.6e-2, 1e-3)}  # (O, LSE)
LM = dict(model="transformer_lm", mode="split", vocab=256, d_model=256,
          num_heads=2, client_depth=1, server_depth=2, max_len=2048,
          attn="flash")
SERVE_B, SERVE_P, SERVE_NEW, REFWD_NEW, TWIN_B, TWIN_NEW = 8, 1024, 256, 16, 2, 32
N_BLOCKS = LM["client_depth"] + LM["server_depth"]
# flash backward: the forward's grid, and the tolerance times the largest
# entry of the plain version's gradient (at least 1)
FA_BWD_TOL = {"float32": 2e-5, "bfloat16": 8e-3}
# the training path: the serving LM's widths in float32
TRAIN_B, TRAIN_T, TRAIN_STEPS, TRAIN_LR, TRAIN_MU = 64, 1024, 30, 0.1, 0.9
LM_LEAVES, SGD_MANY = 54, 300   # K2: one launch for each leaf count
TRAIN_SHAPE = (TRAIN_B, TRAIN_T, LM["num_heads"],
               LM["d_model"] // LM["num_heads"])   # attention's [B, T, H, D]
TWIN_ROWS, TWIN_STEPS, TWIN_TOL = 2, 3, 1e-4
# the twin's summed parameter updates, per leaf, relative to its largest
# entry: float32 GEMMs and reductions summed in another order on the card.
# A leaf whose updates are all below TWIN_UPDATE_FLOOR of the model's
# largest is held to that instead: the key projections' bias has a zero
# gradient in exact arithmetic (softmax ignores a per-row shift of the
# scores), so both sides move it by rounding noise alone
TWIN_UPDATE_TOL, TWIN_UPDATE_FLOOR = 1e-3, 1e-3
# the two-party path: the cut tensors the wire kernels see, and the modes
CNN_CUT = (BATCH, 26, 26, 32)
LM_CUT = (TRAIN_B, TRAIN_T, LM["d_model"])
# split-party decode at full width: batch 8, prompt 1024, 16 new tokens;
# each hop carries the [8, 1040, 256] cut (and the logits back)
DEC_B, DEC_P, DEC_NEW = 8, 1024, 16
GEN_CUT = (DEC_B, DEC_P + DEC_NEW, LM["d_model"])
# the U-shaped CNN's hop 2 (the trunk's features down, their gradient
# up), and the leaves of stage A that the multi-client topk8 bottom sync
# encodes (its 3x3x1x32 kernel and its bias); phases 20 and 23 check
# that these are the sizes they launch at
U_CNN_HOP2 = (BATCH, 9216)
A_LEAVES = (288, 32)
# the ResNet-18 chain of phase 27 at a microbatch of CHAIN_B / CHAIN_M:
# its three cuts (NHWC; stage 0 -> 1, 1 -> 2, and the loss wire 2 -> 3),
# which phase 27 checks are the shapes its hop wires pack
CHAIN_B, CHAIN_M, CHAIN_S = 128, 4, 4
CHAIN_CUT_FEATURES = ((32, 32, 64), (16, 16, 128), (8, 8, 256))
CHAIN_CUTS = tuple((CHAIN_B // CHAIN_M, *f) for f in CHAIN_CUT_FEATURES)
WIRE_SIZES = (1, 7, 8, 9, *A_LEAVES, 127, 4099, math.prod(U_CNN_HOP2),
              math.prod(CNN_CUT), math.prod(GEN_CUT), math.prod(LM_CUT),
              *map(math.prod, CHAIN_CUTS))
WIRE_INPUTS = ("random", "ties", "zeros", "halves")
# 0.2: the adaptive controller's rung above its start, where phase 27's
# topk8 chain moves
WIRE_DENSITIES = (0.01, 0.1, 0.2, 1.0)
WIRE_MODES, DENSITY, EF_DECAY = ("none", "int8", "topk8"), 0.1, 0.5
DEC_MODES = (None, "none", "int8", "topk8")
FRAME_TWIN_STEPS, WIRE_TWIN_STEPS, PROFILE_STEPS = 3, 5, 5
# the HTTP wire (phases 16-17): every socket wait has this timeout; the
# chaos twin's server-side faults, at a fixed seed, in these modes, and
# its losses against the clean HTTP run's; evaluate_remote against
# evaluate (JAX's tests/test_split_inference.py tolerance); the CLI run's
# lr (the default 0.01 rises over the first 5 steps at seed 0)
HTTP_TIMEOUT, CLI_START_TIMEOUT = 60.0, 180.0
CHAOS_SPEC = "drop_resp=0.2,corrupt=0.1,http500=0.1,drop_req=0.1"
CHAOS_SEED, CHAOS_MODES, CHAOS_LOSS_TOL = 0, ("int8", "topk8"), 1e-5
HTTP_EVAL_RTOL, CLI_LR = 1e-5, 0.02
# phases 18-19: the LM as its users configure it. bf16 (and float32 for
# the two-party pair), SGD at phase 10's lr and momentum or AdamW, both
# behind a linear warmup, a cosine decay to 0 at step 30 and clipping at
# a global norm of 1.0. The CLI run over HTTP: 5 steps, warmup 2, decay 10
LM_SCHEDULE = dict(warmup_steps=5, decay_steps=TRAIN_STEPS, grad_clip_norm=1.0)
LM_OPTIMS = {"sgd": dict(lr=TRAIN_LR, momentum=TRAIN_MU),
             "adamw": dict(optimizer="adamw", lr=3e-4, weight_decay=0.1)}
TP_LM_DTYPES = ("float32", "bfloat16")
LM_CLI_LR = 3e-3
# planted faults, each a copy of one source with one expression replaced:
# K3 rounding halves away from zero, K4 keeping the last ties
# phases 20-23: the U-shaped CNN and LM (the LM in bf16 under phase 18's
# AdamW schedule), federated training over HTTP (2 clients, 2 epochs of
# 20 steps), the multi-client runner (4 clients, topk8, a bottom sync
# every 2 rounds, 10 rounds); the CPU twins' steps
U_LM = dict(LM, mode="u_split")
U_LM_MODES, U_LM_STEPS, U_TWIN_STEPS = ("int8", "topk8", "none"), 20, 2
U_TWIN_TOL = {"none": 1e-4, "int8": 1e-3, "topk8": 1e-3}
FED_EPOCHS, FED_STEPS = 2, 20
MC_CLIENTS, MC_ROUNDS, MC_SYNC_EVERY = 4, 10, 2
# phase 24: checkpoints and what loads them. The fused LM (phase 18's
# bf16 AdamW schedule) trains CKPT_K steps, saves, and resumes for CKPT_K
# more, against 2 * CKPT_K uninterrupted; the two-party CNN over HTTP
# does CKPT_TP_K and CKPT_TP_K more per wire mode, with phase 20's twin
# tolerances; eval within CKPT_EVAL_RTOL of evaluate(); generate decodes
# CKPT_GEN_NEW tokens locally and CKPT_REMOTE_NEW over HTTP; prefetch
# runs CKPT_PREFETCH_STEPS two-party CNN steps per depth
CKPT_K, CKPT_TP_K, CKPT_EVAL_RTOL = 10, 5, 1e-5
CKPT_GEN_NEW, CKPT_REMOTE_NEW, CKPT_PROMPT = 64, 16, 16
CKPT_TP_TOL = {"none": 1e-4, "int8": 1e-3, "topk8": 1e-3}
CKPT_PREFETCH_STEPS, CKPT_PREFETCH_DEPTH = 30, 2
CARD_TEST_FILTER = "checkpoint or prefetch or resume"
CARD_TEST_TIMEOUT = 600
# phase 25: the server under many clients. Coalescing: 4 concurrent
# clients, 10 rounds, per leg (wire, compress) and server config; the
# group's CPU twin within GROUP_TWIN_TOL. 2BP: the CNN at each lag (and
# lag 0 within TWO_BP_LAG0_TOL of the coupled series), the bf16 LM at
# lag TWO_BP_LM_LAG. The pipelined client: the CNN over HTTP at each
# depth after PIPE_WARMUP steps, depth 1 bit-equal to the synchronous
# client over PIPE_TWIN_STEPS; the bf16 LM at depth PIPE_LM_DEPTH.
# Admission: 2 tenants over HTTP, tenant 0 held to ADMIT_QUOTA[0] steps/s
MANY_CLIENTS, MANY_ROUNDS, MANY_WINDOW_MS = 4, 10, 2.0
MANY_LEGS = (("local", "none"), ("local", "int8"), ("http", "int8"))
MANY_CONFIGS = (
    ("serialized", {}),
    ("window", dict(coalesce_max=MANY_CLIENTS,
                    coalesce_window_ms=MANY_WINDOW_MS)),
    ("continuous", dict(coalesce_max=MANY_CLIENTS, batching="continuous")))
GROUP_TWIN_TOL = 1e-4
TWO_BP_STEPS, TWO_BP_LAGS, TWO_BP_LAG0_TOL = 30, (0, 2), 1e-4
TWO_BP_LM_LAG, TWO_BP_LM_STEPS = 1, 10
PIPE_DEPTHS, PIPE_STEPS, PIPE_WARMUP, PIPE_TWIN_STEPS = (1, 2, 4), 30, 5, 10
PIPE_LM_DEPTH, PIPE_LM_STEPS = 2, 10
ADMIT_STEPS, ADMIT_QUOTA, ADMIT_RETRIES = 6, (2.0, 1000.0), 20
MANY_CARD_TEST_FILTER = "many_clients"
# phase 26: the image families on CIFAR-10 (synthetic: no CIFAR-10 files
# are in the repository). ResNet-18 fused (float32, bf16) and two-party
# (none, int8) at IMG_B; ViT-S (d 384, 6 heads, 2 + 10 blocks, patch 4:
# T 64) in bf16 under AdamW (lr 1e-3, warmup 5, cosine to step 30, clip
# 1.0); the default ViT two-party on topk8. CPU twins: the first
# IMG_TWIN_STEPS steps at batch IMG_TWIN_B from one init. K5/K6 are held
# to their plain versions, non-causal, at VIT_FA_SHAPES ([B, T, H, D]:
# MNIST's defaults, CIFAR-10's defaults, ViT-S at IMG_B)
IMG_B, IMG_STEPS, IMG_TWIN_B, IMG_TWIN_STEPS = 128, 30, 16, 3
IMG_TP_STEPS = 10
VIT_FA_SHAPES = ((8, 49, 4, 16), (IMG_B, 64, 4, 16), (IMG_B, 64, 6, 64))
VIT_S = dict(d_model=384, num_heads=6, client_depth=2, server_depth=10)
VIT_S_OPT = ["--optimizer", "adamw", "--lr", "1e-3", "--weight-decay",
             "0.05", "--warmup-steps", "5", "--decay-steps", str(IMG_STEPS),
             "--grad-clip-norm", "1.0"]
# the twins: each of IMG_TWIN_STEPS steps runs on the card and on the CPU
# from one state, the card's (a free-running pair drifts apart through
# ReLU kinks that float32 rounding flips: ResNet-18's third loss moved
# by 1.9e-3 on the none wire and 6.2e-3 on int8, from run to run). The
# loss of every step within phase 20's wire tolerance (float32) or
# bf16_loss_tol (bf16); the step's update, summed over the whole model,
# within IMG_UPDATE_TOL of the CPU's in relative L2 distance (float32:
# tests/test_torch_port_resnet_train.py's bar), or for bf16 within
# IMG_BF16_UPDATE_FACTOR times the distance of the CPU's bf16 update
# from its float32 one from the same state (two independent bf16
# roundings are about sqrt(2) times one apart)
IMG_TWIN_TOL = U_TWIN_TOL
IMG_UPDATE_TOL, IMG_BF16_UPDATE_FACTOR = 2e-2, 3.0
IMG_CARD_TEST_FILTER = "image"
# kernel classes of a profiler window, by lower-case name fragments
IMG_CLASSES = {
    "conv": ("conv", "xmma", "fprop", "dgrad", "wgrad", "implicit_gemm",
             "cudnn"),
    # ATen's GroupNorm (ResNet-18) and LayerNorm (ViT) kernels
    "norm": ("group_norm", "groupnorm", "rowwisemoments", "fusedparams",
             "gammabeta", "layer_norm", "internalgradients"),
    "flash": ("flash",),
    "gemm": ("gemm", "cutlass", "sm90_"),
    "layout_copy": ("copy", "nchwtonhwc", "nhwctonchw", "transpose"),
    "memcpy": ("memcpy",)}
# phase 27: the K-stage chain. resnet18_4stage (the hub's stem and
# layer1; layer2, layer3 and the head as stage parties) at CHAIN_B with
# CHAIN_M microbatches, plain SGD at LR, lag 0. On DeviceTransport in
# float32 and bf16: GPipe over CHAIN_STEPS (step ms, a profiler window,
# the measured bubble beside the ideal (S-1)/(M+S-1)); 1F1B against
# GPipe bit for bit over CHAIN_EQ_STEPS from one init under
# deterministic cuDNN; a CPU twin of CHAIN_TWIN_STEPS steps at
# CHAIN_TWIN_B, each step from one state on both devices (phase 26's
# bounds). On LocalTransport in float32: int8, then topk8 under the
# adaptive controller, CHAIN_WIRE_STEPS each (wire launches and bytes a
# step); the controller's decisions against a CPU run of CHAIN_DC_STEPS
# at CHAIN_DC_B from one init (a window a step). Then split_cnn_chain3
# over HTTP (int8): two serve --role stage parties in this process
# (launch.run.serve_party) and launch.run.main(["train", "--stages",
# "3", ...]) for CNN_CHAIN_STEPS at CNN_CHAIN_B.
CHAIN_STEPS, CHAIN_EQ_STEPS, CHAIN_WIRE_STEPS, CHAIN_PROFILE_STEPS = (
    8, 3, 4, 3)
CHAIN_TWIN_B, CHAIN_TWIN_STEPS = 16, 2
CHAIN_DC_B, CHAIN_DC_STEPS = 32, 3
CHAIN_WIRE_TWIN_PACKS = 2   # twinned packs (and decodes) a wire and key
CNN_CHAIN_B, CNN_CHAIN_STEPS = 64, 12
CHAIN_CARD_TEST_FILTER = "chain"
CHAIN_STEP_TIMEOUT = 120.0   # a step that does not drain fails the phase
# phase 28: observability. (a) the bf16 AdamW LM of phase 18 through the
# CLI for OBS_STEPS steps a run, the runs of OBS_LM_RUNS; (b) the HTTP pair of
# phase 16 with serve --trace --flight --telemetry (windows of
# OBS_TEL_INTERVAL_S, latency SLO OBS_SLO_MS) as a subprocess and the
# int8 client with --flight --trace for OBS_HTTP_STEPS steps; (c) the
# chain of phase 27 on DeviceTransport for OBS_CHAIN_STEPS steps with
# --telemetry-port 0. The CUDA kernels a device trace must name
OBS_STEPS, OBS_HTTP_STEPS, OBS_CHAIN_STEPS = 12, 60, 3
# (a)'s runs in order: the pairs give the flags' overhead, the last two
# every flag but --profile-dir
OBS_LM_RUNS = ("off", "on", "on", "off", "on_no_profiler",
               "on_no_profiler")
OBS_TEL_INTERVAL_S, OBS_SLO_MS = 0.5, 1000.0
OBS_TRACE_KERNELS = {"K1": ("ce_fwd_kernel", "ce_bwd_kernel"),
                     "K5": ("flash_fwd_kernel",),
                     "K6": ("flash_bwd_delta_kernel", "flash_bwd_dkv_kernel",
                            "flash_bwd_dq_kernel")}
# phase 29: this slice. (a) phase 18's bf16 AdamW LM through the CLI for
# FLEET_LM_STEPS steps stepwise and with --scan-steps SCAN_N (the cap:
# --scan-steps SCAN_CAP[0] --checkpoint-every SCAN_CAP[1]); (b) the LM
# and ResNet-18 (fused, float32, batch IMG_B, REMAT_IMG_STEPS steps) with
# and without --remat; (c) serve --replicas 2 --replica-sync-every
# REPL_SYNC in this process, REPL_CLIENTS int8 HTTP clients on threads
# (REPL_STEPS steps each, a kill of one replica after REPL_KILL_AT
# steps of the second half), once per handoff mode; (d) the fleet
# harness's burst fleet against a group under --autoscale; (e) host
# syncs planted under the dispatch watchdog
FLEET_LM_STEPS, SCAN_N, SCAN_CAP = 12, 4, (8, 6)
REMAT_IMG_STEPS = 10
REMAT_REL_TOL = 1e-6   # the LM's losses: bit-equal, or within this
REPL_CLIENTS, REPL_STEPS, REPL_SYNC, REPL_KILL_AT = 4, 10, 5, 4
# (d): fleet_sim's batch of 8 rows a client: a handoff carries each moved
# client's replay entries through the sidecar (base64 JSON), about 1 MB
# an entry at 8 rows of the CNN cut, 7 MB at 64
FLEET_ARGS = ["--clients", "64", "--tenants", "4", "--steps", "4",
              "--arrival", "burst", "--rate", "0.5", "--burst-size", "2",
              "--batching", "continuous", "--coalesce-max", "4",
              "--batch", "8", "--workers", "16", "--autoscale",
              "--autoscale-min", "1", "--autoscale-max", "3",
              "--autoscale-cooldown-s", "0.2", "--telemetry-interval-s",
              "0.3", "--slo-ms", "5", "--gate-dropped-steps",
              "--gate-autoscale"]
# phase 30: the device mesh, n ranks virtual on card 0 (and on distinct
# cards where the machine has n). (a) phase 18's bf16 AdamW LM with
# attn="ring_flash" on a seq MESH_SEQ mesh, MESH_LM_STEPS steps each from
# its state on it and on the unsharded flash trainer (losses within two
# bf16 ulps), a CPU twin of MESH_TWIN_STEPS steps on TWIN_ROWS rows, one
# attention call per layout; (b) the same LM with attn="ulysses" at seq
# MESH_ULY on K5/K6; (c) the fused CNN on a data MESH_DATA mesh,
# MESH_CNN_STEPS steps; (d) PipelinedTrainer, resnet18_4stage, batch
# MESH_PIPE_B, M MESH_PIPE_M, MESH_STAGES pipe ranks, MESH_PIPE_STEPS
# steps against the fused trainer (JAX's bar, tests/test_pipeline.py:45);
# (e) the CLI. MESH_FA_SHAPES: K5/K6 at the ring block and Ulysses shapes
MESH_SEQ, MESH_ULY, MESH_DATA, MESH_STAGES = 4, 2, 4, 4
MESH_LM_STEPS, MESH_TWIN_STEPS, MESH_CLI_STEPS = 5, 2, 3
MESH_CNN_STEPS, MESH_CNN_RTOL = 12, 1e-4
MESH_PIPE_B, MESH_PIPE_M, MESH_PIPE_STEPS = 128, 4, 3
MESH_PIPE_TOL = (1e-4, 1e-5)   # (rtol, atol)
_RING_BLOCK = (TRAIN_B, TRAIN_T // MESH_SEQ, 2, 128)
MESH_FA_SHAPES = (   # label, shape, causal, strict, an LSE cotangent
    ("ring block causal", _RING_BLOCK, True, False, True),
    ("ring block strict", _RING_BLOCK, True, True, True),
    ("ring block non-causal", _RING_BLOCK, False, False, True),
    ("ulysses causal", (TRAIN_B, TRAIN_T, 1, 128), True, False, False))
# phase 31: the model axis (tensor parallelism), ranks virtual on card 0.
# (a) phase 18's bf16 AdamW LM at model TP_MODEL through the CLI for
# TP_CLI_STEPS steps, then TP_LM_STEPS steps each from the sharded
# trainer's state on it and on the unsharded one, a CPU twin of
# TP_TWIN_STEPS steps on TWIN_ROWS rows; (b) the fused CNN at the
# (data, model) shapes of TP_CNN_SHAPES for TP_CNN_STEPS steps, and
# ResNet-18 at batch IMG_B at model 2; (c) the sharded server (serve over
# HTTP and train --transport local at data 2 x model 2, TP_SERVER_STEPS
# steps; a coalesced group of TP_PAD_B rows on a data TP_PAD_DATA mesh);
# (d) split_cnn_chain3 on the device wire, its middle stage at data 2 x
# model 2, TP_CHAIN_STEPS steps. TP_FA_SHAPES: K5/K6 where a model rank
# attends its one head of the LM's two
TP_MODEL, TP_CLI_STEPS, TP_LM_STEPS, TP_TWIN_STEPS = 2, 3, 4, 2
TP_CNN_SHAPES, TP_CNN_STEPS = ((1, 2), (1, 4), (2, 2)), 5
TP_FUSED_TOL, TP_SERVER_TOL = (1e-4, 1e-5), (1e-4, 5e-4)   # (rtol, atol)
TP_LM_BYTES_BAR, TP_IMG_BYTES_BAR = 0.75, 0.6
TP_SERVER_STEPS, TP_PAD_DATA, TP_PAD_B, TP_CHAIN_STEPS = 5, 4, 2, 4
TP_FA_SHAPES = (("model rank causal",
                 (TRAIN_B, TRAIN_T, LM["num_heads"] // TP_MODEL,
                  LM["d_model"] // LM["num_heads"]), True, False, False),)
# phase 32: the native host codec and the concurrency checker. (a) the
# frames of NATIVE_CUTS (float32, seeded) in int8 and topk8 at DENSITY
# (without and with EF, NATIVE_EF_STEPS steps) from the native codec, the
# SLT_NO_NATIVE numpy line and the card (K3, K4s), byte-equal; host ms
# per MB, native against numpy, the median of NATIVE_REPS. (b) the lint
# over the port, one sweep of every --check scenario cut to
# ANALYSIS_CHECK_BUDGET schedules (the CPU tests sweep each at its own
# budget) and every --crash scenario at its own budget, five
# subprocesses at once, within ANALYSIS_TIMEOUT_S. (c)
# phase 25's coalesced MANY_CLIENTS-client CNN round for WATCHDOG_ROUNDS
# rounds in two subprocesses, SLT_LOCK_DEBUG=1 and unset, the clients
# enqueued in a fixed order (a group fills before WATCHDOG_WINDOW_MS)
NATIVE_CUTS = (("cnn_cut", CNN_CUT), ("lm_cut", LM_CUT))
NATIVE_REPS, NATIVE_EF_STEPS = 20, 2
HOST_LINE_WARM, HOST_LINE_STEPS = 2, 20
ANALYSIS_TIMEOUT_S, ANALYSIS_CHECK_BUDGET = 400, 20
WATCHDOG_ROUNDS, WATCHDOG_WINDOW_MS, WATCHDOG_SLO_MS = 4, 60_000.0, 60_000.0
WATCHDOG_LOCKS = ("RequestCoalescer._cond", "AdmissionController._lock",
                  "_GroupD2H._lock")
# phase 33: the seq axis as JAX lays it out (T-partitioned activations
# through the whole step), composed with the model axis: model SM_MODEL x
# seq SM_SEQ, ranks virtual on card 0. (a) K5/K6 on a ring block of one
# model rank's heads (SM_FA_SHAPES) and K1 on one seq rank's rows
# (SM_CE), against their plain versions; (b) phase 18's bf16 AdamW LM
# with ring_flash and with ulysses, through the CLI for SM_CLI_STEPS
# steps and through FusedSplitTrainer for SM_LM_STEPS steps each from the
# sharded trainer's state on it and on the unsharded flash trainer
# (losses within SM_LOSS_TOL), forward hooks on the first step; an SGD
# leg of SM_SGD_STEPS steps (K2); ring_flash's CPU twin; (c) the
# crossover: dense full_attention against K5+K6, forward and backward,
# causal, at SM_CROSS_T with B*T = SM_CROSS_TOKENS in bf16 and float32,
# then attn="auto" on both sides of FLASH_SPEED_T (launches counted)
SM_MODEL, SM_SEQ = 2, 2
SM_CLI_STEPS, SM_LM_STEPS, SM_SGD_STEPS, SM_TWIN_STEPS = 2, 3, 2, 1
SM_LOSS_TOL = 1e-4
_SM_BLOCK = (TRAIN_B, TRAIN_T // SM_SEQ, LM["num_heads"] // SM_MODEL,
             LM["d_model"] // LM["num_heads"])
SM_FA_SHAPES = (   # label, shape, causal, strict, an LSE cotangent
    ("seq x model block causal", _SM_BLOCK, True, False, True),
    ("seq x model block strict", _SM_BLOCK, True, True, True),
    ("seq x model block non-causal", _SM_BLOCK, False, False, True))
SM_CE = (TRAIN_B * TRAIN_T // SM_SEQ, LM["vocab"])
SM_CROSS_T, SM_CROSS_TOKENS, SM_CROSS_REPS = (16, 32, 64, 128, 256, 512,
                                              1024, 2048, 4096), 65536, 10
SM_AUTO_B = 2
PLANTS = {
    "quantize_roundf": ("quantize.cu", "rintf(", "roundf("),
    "topk_select_ties_high": (
        "topk_select.cu", "return min(r, need);",
        "return r > eq_total - need ? r - (eq_total - need) : 0u;"),
}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_peaks(name: str):
    for key, bw, fp32, bf16, tf32 in _CARD_PEAKS:
        if key in name:
            return bw, fp32, bf16, tf32, key
    _, bw, fp32, bf16, tf32 = _CARD_PEAKS[0]
    return (bw, fp32, bf16, tf32,
            f"H100 SXM (assumed; {name!r} is not in the table)")


def bound(nbytes: float, ops: float, bw: float, fp32: float):
    t_bytes, t_ops = nbytes / bw, ops / fp32
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def device_ms(torch, fn, reps: int = 100) -> float:
    """Median device time of one call of ``fn``, from CUDA events.

    A long sleep kernel holds the stream while the host enqueues every
    call, so each event pair brackets the device's work for that call and
    not the host's time to launch it."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda._sleep(int(2e8))
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def profile_window(torch, run, n: int, per: str = "step",
                   classes=None) -> dict:
    """Device busy share of ``run()`` (``n`` units of work) and the device
    time by kernel per unit, from ``torch.profiler``; ``None`` figures
    where the profiler recorded no device activity. ``classes`` maps a
    label to lower-case name fragments: the share of the device time of
    the kernels whose names hold one (the first label that matches)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.end - e.time_range.start)
    busy_us = sum(by_name.values())
    copy_us = sum(us for name, us in by_name.items() if "Memcpy" in name)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    rec = {
        f"{per}s": n, "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3 if by_name else None,
        "device_idle_share": 1 - busy_us / wall_us if by_name else None,
        f"memcpy_ms_per_{per}": copy_us / 1e3 / n if by_name else None,
        f"device_ms_per_{per}_by_kernel": {
            name[:80]: us / 1e3 / n for name, us in top}}
    if classes and by_name:
        shares = {label: 0.0 for label in (*classes, "other")}
        for name, us in by_name.items():
            low = name.lower()
            label = next((lb for lb, frags in classes.items()
                          if any(f in low for f in frags)), "other")
            shares[label] += us / busy_us
        rec["device_share_by_class"] = shares
    return rec


def profile_steps(torch, trainer, data) -> dict:
    """:func:`profile_window` over ``train_step`` on each batch."""
    def run():
        for x, y in data:
            trainer.train_step(x, y)
    return profile_window(torch, run, len(data))


def host_ms(torch, fn, reps: int = 3) -> float:
    """Median host-clock time of ``fn()`` ending in a synchronise."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def start_planted_builds():
    """Start one ``nvcc`` per planted fault of :data:`PLANTS` (beside the
    real build) into ``build/torch_kernels/planted/``. Returns ``{name:
    (process, library path)}``."""
    import subprocess

    from split_learning_tpu_torch.ops import common
    out_dir = common.BUILD_DIR / "planted"
    out_dir.mkdir(parents=True, exist_ok=True)
    builds = {}
    for name, (source, real, fault) in PLANTS.items():
        src = (common.CSRC_DIR / source).read_text()
        check(src.count(real) == 1, f"{source}: expected one {real!r}")
        planted = out_dir / f"{name}.cu"
        planted.write_text(src.replace(real, fault))
        lib = out_dir / f"{name}.so"
        builds[name] = (subprocess.Popen(
            [common._nvcc(), *common.NVCC_FLAGS, "-I", str(common.CSRC_DIR),
             "-o", str(lib), str(planted)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), lib)
    return builds


def planted_lib(builds, name):
    """The planted build ``name`` of :func:`start_planted_builds`, loaded."""
    import ctypes
    proc, lib = builds[name]
    _, err = proc.communicate()
    check(proc.returncode == 0, f"planted build {name} failed: {err[-2000:]}")
    return ctypes.CDLL(str(lib))


class SyncCount:
    """Counts the host syncs PyTorch makes inside the block (its sync
    debug mode warns on each: D2H copies, ``.item()``, ``nonzero``)."""

    def __init__(self, torch):
        self.torch, self.n = torch, 0

    def __enter__(self):
        import warnings
        self._catch = warnings.catch_warnings(record=True)
        self._seen = self._catch.__enter__()
        warnings.simplefilter("always")
        self.torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        self.torch.cuda.set_sync_debug_mode("default")
        self.n = sum("synchronizing CUDA operation" in str(w.message)
                     for w in self._seen)
        self._catch.__exit__(*exc)


def ce_inputs(torch, dev, gen, n, c, dtype):
    x = (3.0 * torch.randn(n, c, device=dev, generator=gen)).to(dtype)
    y = torch.randint(0, c, (n,), device=dev, generator=gen)
    return x, y


def bf16_ulps(torch, a, b) -> int:
    """Largest distance of two bf16 tensors in units in the last place."""
    def ordered(t):
        i = t.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(a) - ordered(b)).abs().max().item())


def ce_checks(torch, dev, gen) -> dict:
    """Phase 2: K1 against its plain version over the N x C grid and the
    LM's logits, float32 and bf16, two runs bit-identical; then the NaN
    rows. Returns the largest errors by dtype."""
    from split_learning_tpu_torch.ops.cross_entropy import (
        ce_backward_cuda, ce_backward_plain, ce_forward_cuda,
        ce_forward_plain)
    g_one = torch.ones((), device=dev)
    cases = [(n, c) for n in CE_SHAPES_N for c in CE_SHAPES_C] + [CE_LM]
    err = {"float32": dict(loss=0.0, grad=0.0, grad_lm=0.0),
           "bfloat16": dict(loss=0.0, grad_ulps=0)}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        for n, c in cases:
            what = f"CE N={n} C={c} {name}"
            x, y = ce_inputs(torch, dev, gen, n, c, dtype)
            runs = []
            for _ in range(2):
                loss, lse = ce_forward_cuda(x, y)
                runs.append((loss, lse, ce_backward_cuda(x, y, lse, g_one)))
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(*runs)),
                  f"{what}: two runs differ")
            loss_k, _, grad_k = runs[0]
            loss_p, lse_p = ce_forward_plain(x, y)
            grad_p = ce_backward_plain(x, y, lse_p, g_one)
            d = abs(loss_k.item() - loss_p.item())
            check(d <= CE_LOSS_RTOL * abs(loss_p.item()),
                  f"{what}: loss {loss_k.item()} vs {loss_p.item()}")
            err[name]["loss"] = max(err[name]["loss"], d)
            if dtype == torch.float32:
                # entries are at most 1/N: hold them to the largest one
                # too (float32 rounding of the exp and of the row LSE)
                e = (grad_k - grad_p).abs().max().item()
                scale = grad_p.abs().max().item()
                check(e <= 1e-6 and e <= CE_GRAD_RTOL * scale,
                      f"{what}: grad abs {e} (largest {scale})")
                key = "grad_lm" if (n, c) == CE_LM else "grad"
                err[name][key] = max(err[name][key], e)
            else:
                # both round one float32 value to bf16; it differs only in
                # its last float32 bits
                u = bf16_ulps(torch, grad_k, grad_p)
                check(u <= 1, f"{what}: grad {u} bf16 ulps apart")
                err[name]["grad_ulps"] = max(err[name]["grad_ulps"], u)
    # +inf, NaN, an all -inf row and labels outside [0, C): a NaN loss;
    # the other rows as the plain version's
    for c in (10, 256):
        x0, y0 = ce_inputs(torch, dev, gen, 8, c, torch.float32)
        for fault in ("inf", "nan", "all_neg_inf", "label_neg", "label_c"):
            x, y = x0.clone(), y0.clone()
            if fault == "inf":
                x[3, c // 2] = float("inf")
            elif fault == "nan":
                x[3, c - 1] = float("nan")
            elif fault == "all_neg_inf":
                x[3] = float("-inf")
            else:
                y[3] = -1 if fault == "label_neg" else c
            loss, lse = ce_forward_cuda(x, y)
            grad = ce_backward_cuda(x, y, lse, g_one)
            loss_p, lse_p = ce_forward_plain(x, y)
            grad_p = ce_backward_plain(x, y, lse_p, g_one)
            rows = torch.arange(8, device=dev) != 3
            check(loss.isnan().item() and loss_p.isnan().item(),
                  f"CE C={c} {fault}: loss {loss.item()}, plain "
                  f"{loss_p.item()}")
            check(bool(torch.isfinite(lse[rows]).all()) and
                  (lse[rows] - lse_p[rows]).abs().max().item() <= 1e-5 and
                  (grad[rows] - grad_p[rows]).abs().max().item() <= 1e-6,
                  f"CE C={c} {fault}: the other rows moved")
    err["cases"] = 2 * len(cases)
    return err


def ce_times(torch, dev, gen, bw, fp32) -> dict:
    """Phase 5's K1 times at the CNN's [64, 10] and the LM's [65536, 256]
    logits, float32 and bf16: kernel, plain, ``F.cross_entropy`` forward
    and its autograd backward, the bound, and from a profiler window of
    CE_PROFILE_CALLS calls each launch's device kernels (one a call) and
    their own duration."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    from split_learning_tpu_torch.ops.cross_entropy import (
        ce_backward_cuda, ce_backward_plain, ce_forward_cuda,
        ce_forward_plain)
    g_one = torch.ones((), device=dev)
    out = {}
    for cut, (n, c) in (("cnn", (BATCH, 10)), ("lm", CE_LM)):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            x, y = ce_inputs(torch, dev, gen, n, c, dtype)
            _, lse = ce_forward_cuda(x, y)
            xr = x.clone().requires_grad_(True)
            lib_loss = F.cross_entropy(xr, y)
            logits_b = n * c * x.element_size()
            fwd_b = logits_b + n * 8 + n * 4 + 4   # + labels, lse, loss
            bwd_b = 2 * logits_b + n * 8 + n * 4 + 4   # + g
            f_ms, f_by = bound(fwd_b, 4 * n * c, bw, fp32)
            b_ms, b_by = bound(bwd_b, 4 * n * c, bw, fp32)
            # each call's device kernels, and their own time, from the
            # profiler: one kernel a call, and its duration without the
            # launch and event gaps that CUDA-event times include
            prof_of = {}
            for part, kernel, fn in (
                    ("fwd", "ce_fwd_kernel", lambda: ce_forward_cuda(x, y)),
                    ("bwd", "ce_bwd_kernel",
                     lambda: ce_backward_cuda(x, y, lse, g_one))):
                # an idle device when tracing starts: a first kernel that
                # raced the profiler's start went unrecorded once. A window
                # in which the profiler traced no device activity at all
                # (it happened once, on the third window of a run), or
                # fewer kernels than the calls launched (one of ten, once),
                # measured nothing whole: it is taken again, at most twice,
                # and counted; the check below holds the window used
                for attempt in range(3):
                    torch.cuda.synchronize()
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        torch.cuda.synchronize()
                        for _ in range(CE_PROFILE_CALLS):
                            fn()
                        torch.cuda.synchronize()
                    kernels, busy_us = {}, 0.0
                    for e in prof.events():
                        if e.device_type == torch.autograd.DeviceType.CUDA:
                            kernels[e.name] = kernels.get(e.name, 0) + 1
                            busy_us += e.time_range.end - e.time_range.start
                    if sum(kernels.values()) >= CE_PROFILE_CALLS:
                        break
                    print(f"[k1] {part} {cut} {name}: the profiler traced "
                          f"{sum(kernels.values())} kernels of "
                          f"{CE_PROFILE_CALLS} calls; window taken again",
                          flush=True)
                check(sum(kernels.values()) == CE_PROFILE_CALLS and
                      all(kernel in k for k in kernels),
                      f"K1 {part} {cut} {name}: {CE_PROFILE_CALLS} calls "
                      f"ran the device kernels {kernels}")
                prof_of[part] = dict(
                    profiler_windows_retaken=attempt,
                    device_kernels_per_call=sum(kernels.values())
                    / CE_PROFILE_CALLS,
                    kernel_ms_profiler=busy_us / 1e3 / CE_PROFILE_CALLS)
            out[cut, name] = dict(
                shape=[n, c], fwd=dict(
                    ms=device_ms(torch, lambda: ce_forward_cuda(x, y)),
                    plain_ms=device_ms(torch, lambda: ce_forward_plain(x, y)),
                    library_ms=device_ms(torch,
                                         lambda: F.cross_entropy(x, y)),
                    bytes=fwd_b, bound_ms=f_ms, bound_by=f_by,
                    **prof_of["fwd"]),
                bwd=dict(
                    ms=device_ms(torch, lambda: ce_backward_cuda(
                        x, y, lse, g_one)),
                    plain_ms=device_ms(torch, lambda: ce_backward_plain(
                        x, y, lse, g_one)),
                    library_ms=device_ms(torch, lambda: torch.autograd.grad(
                        lib_loss, xr, retain_graph=True)),
                    bytes=bwd_b, bound_ms=b_ms, bound_by=b_by,
                    **prof_of["bwd"]))
            del xr, lib_loss
            fwd, bwd = out[cut, name]["fwd"], out[cut, name]["bwd"]
            print(f"[k1] {cut} [{n}, {c}] {name}: fwd {fwd['ms']:.5f} ms "
                  f"(kernel {fwd['kernel_ms_profiler']:.5f}, bound "
                  f"{f_ms:.5f}, F.cross_entropy {fwd['library_ms']:.5f}), "
                  f"bwd {bwd['ms']:.5f} (kernel "
                  f"{bwd['kernel_ms_profiler']:.5f}, bound {b_ms:.5f}, "
                  f"autograd {bwd['library_ms']:.5f})", flush=True)
    return out


def sgd_checks(torch, dev, gen, lm_shapes) -> None:
    """Phase 3: K2 bit-identical to its plain version over five steps, at
    momentum 0 and 0.9, on the CNN's 6 leaves, the LM's 54 and SGD_MANY
    leaves of mixed odd sizes (every third a view 4 bytes off a 16-byte
    boundary), each step one launch."""
    from split_learning_tpu_torch.ops.common import LAUNCHES
    from split_learning_tpu_torch.ops.sgd import (
        NAME as SGD, sgd_step_cuda, sgd_step_plain)
    rs = np.random.RandomState(SGD_MANY)
    many = [(int(v),) for v in rs.randint(1, 3000, SGD_MANY)]
    for label, shapes in (("CNN", CNN_LEAF_SHAPES), ("LM", lm_shapes),
                          ("mixed", many)):
        def leaves():
            out = []
            for i, sh in enumerate(shapes):
                if label == "mixed" and i % 3 == 0:
                    out.append(torch.randn(math.prod(sh) + 1, device=dev,
                                           generator=gen)[1:].view(sh))
                else:
                    out.append(torch.randn(sh, device=dev, generator=gen))
            return out
        for mu in (0.0, 0.9):
            p_k = leaves()
            p_p = [t.clone() for t in p_k]
            m_k = [torch.zeros_like(t) for t in p_k] if mu else None
            m_p = [torch.zeros_like(t) for t in p_k] if mu else None
            for _ in range(5):
                grads = leaves()
                LAUNCHES.reset()
                sgd_step_cuda(p_k, grads, m_k, LR, mu)
                torch.cuda.synchronize()
                check(LAUNCHES.snapshot() == {SGD: 1},
                      f"SGD launches for {len(shapes)} leaves: "
                      f"{LAUNCHES.snapshot()}")
                sgd_step_plain(p_p, grads, m_p, LR, mu)
            for a, b in zip(p_k + (m_k or []), p_p + (m_p or [])):
                check(torch.equal(a, b), f"SGD {label} mu={mu}: not "
                      f"bit-identical (max abs {(a - b).abs().max().item()})")


def wire_input(torch, dev, gen, n, kind, dtype):
    """A flat test tensor of ``n`` values on the card."""
    if kind == "random":
        x = 3.0 * torch.randn(n, device=dev, generator=gen)
    elif kind == "ties":
        x = torch.full((n,), 0.7, device=dev)
    elif kind == "zeros":
        x = torch.zeros(n, device=dev)
    else:
        # exact halves k + 0.5 at scale 1 (amax 127): rint and roundf differ
        x = (torch.arange(n, device=dev) % 254).float() - 126.5
        x[n // 2] = 127.0
    return x.to(dtype)


def _k_of(n, density):
    return max(1, min(n, math.ceil(density * n)))


def wire_kernel_checks(torch, dev, gen, planted):
    """Phase 12: K3 and K4 against their plain versions on the card, the
    codec's card frames against the host codec's, and K4's planted
    tie-break fault."""
    from split_learning_tpu_torch.ops import quantize as qmod
    from split_learning_tpu_torch.ops import topk as kmod
    from split_learning_tpu_torch.transport import codec
    errs = {qmod.QUANT: 0.0, qmod.DEQUANT: 0.0, kmod.NAME: 0.0,
            **{name: 0.0 for name in kmod.SELECT_LAUNCHES}}
    n_cases = frames = 0

    def same(a, b, names, what):
        """Bit-equal (so each launch's max abs error stays 0)."""
        if a.dtype == b.dtype and torch.equal(a, b):
            return
        a, b = a.cpu().double(), b.cpu().double()
        raise RuntimeError(
            f"chip_smoke check failed: {names} {what}: not bit-equal (max "
            f"abs {(a - b).abs().max().item()})")

    for dtype in (torch.float32, torch.bfloat16):
        for n in WIRE_SIZES:
            for kind in WIRE_INPUTS:
                what = f"n={n} {kind} {dtype}"
                x = wire_input(torch, dev, gen, n, kind, dtype)
                res = 0.5 * torch.randn(n, device=dev, generator=gen)
                n_out = qmod.tile_rows(n) * qmod.LANE
                for size in (n, n_out):
                    buf = qmod.q8_encode_cuda(x, size)
                    same(buf, qmod.q8_encode_plain(x, size), qmod.QUANT, what)
                stats, q = qmod.q8_views(buf)
                scale = stats[1].item()
                same(qmod.dequantize_cuda(q, scale),
                     qmod.dequantize_plain(q, scale), qmod.DEQUANT, what)
                for r in (None, res):
                    for a, b in zip(kmod.fold_magnitudes_cuda(x, r, EF_DECAY),
                                    kmod.fold_magnitudes_plain(x, r,
                                                               EF_DECAY)):
                        same(a, b, kmod.NAME, what)
                # the same values through the host codec's numpy path (a
                # bf16 tensor as its float32 values, the frame's dtype
                # named as the card's; the CPU tests hold the CPU tensor
                # path of bf16 to that)
                host = x.float().cpu().numpy()
                res_h = res.cpu().numpy()
                name = str(dtype).replace("torch.", "")

                def host_frame(d):
                    return codec.encode(dict(d, dtype=name))

                check(codec.encode(codec.q8_compress(x))
                      == host_frame(codec.q8_compress(host)),
                      f"q8 frame {what}")
                frames += 1
                for density in WIRE_DENSITIES:
                    k = _k_of(n, density)
                    for r, decay in ((None, 1.0), (res, 1.0), (res, EF_DECAY)):
                        for keep in ((True, False) if r is None else (True,)):
                            got = kmod.topk8_select_cuda(x, r, decay, k, keep)
                            want = kmod.topk8_select_plain(x, r, decay, k,
                                                           keep)
                            same(got[0], want[0], kmod.SELECT_LAUNCHES, what)
                            if keep:
                                same(got[1], want[1], kmod.SELECT_LAUNCHES,
                                     what)
                        d_k, r_k = codec.topk8_compress(x, density, r, decay)
                        d_h, r_h = codec.topk8_compress(
                            host, density, None if r is None else res_h,
                            decay)
                        tag = f"{what} density {density} decay {decay}"
                        check(codec.encode(d_k) == host_frame(d_h),
                              f"topk8 frame {tag} (res {r is not None})")
                        check(np.array_equal(r_k.cpu().numpy(),
                                             np.asarray(r_h, np.float32)),
                              f"topk8 residual {tag}")
                        frames += 1
                    check(codec.encode(codec.topk8_pack(x, density))
                          == host_frame(codec.topk8_pack(host, density)),
                          f"stateless topk8 frame {what} density {density}")
                    frames += 1
                n_cases += 1
        for bad in (float("nan"), float("inf")):
            x = wire_input(torch, dev, gen, math.prod(CNN_CUT), "random",
                           dtype)
            x[x.numel() // 3] = bad
            check(not math.isfinite(qmod.q8_views(
                qmod.q8_encode_cuda(x, x.numel()))[0][0].item())
                and kmod.fold_magnitudes_cuda(x)[2].item() == 1
                and kmod.split_select(kmod.topk8_select_cuda(
                    x, None, 1.0, x.numel() // 10)[0].cpu(), x.numel(),
                    x.numel() // 10)[0],
                  f"non-finite {bad} {dtype}: not flagged")
            for encode in (codec.q8_compress,
                           lambda t: codec.topk8_compress(t, DENSITY)):
                try:
                    encode(x)
                except codec.CodecError:
                    continue
                raise RuntimeError(f"chip_smoke check failed: the codec "
                                   f"took a {bad} on the card ({dtype})")

    # the planted fault: K4 keeping the last ties must change the frames
    # of the all-equal probe (bitmap and index forms)
    real = kmod._select_lib
    bad_lib = kmod.bind_select(planted_lib(planted, "topk_select_ties_high"))
    probe = wire_input(torch, dev, gen, math.prod(CNN_CUT), "ties",
                       torch.float32)
    kmod._select_lib = lambda: bad_lib
    try:
        planted_frames = [codec.encode(codec.topk8_pack(probe, d))
                          for d in (DENSITY, 0.01)]
    finally:
        kmod._select_lib = real
    host_frames = [codec.encode(codec.topk8_pack(probe.cpu().numpy(), d))
                   for d in (DENSITY, 0.01)]
    changed = sum(a != b for a, b in zip(planted_frames, host_frames))
    check(changed == 2, f"a planted tie-break K4 changed {changed} of 2 "
                        "all-equal frames")
    return errs, n_cases, frames, changed


class FrameTwin:
    """The card's frames against the host codec's. For the first
    ``steps`` packs of each wrapped direction, copy the card's tensor
    (and EF residual) to the host, encode it there, and count frames
    (and residuals) that differ; and count the host syncs of every pack
    (the card's encode), which must be one a frame."""

    def __init__(self, torch, codec, mode, steps=FRAME_TWIN_STEPS):
        self.torch, self.codec, self.mode, self.steps = torch, codec, mode, steps
        self.frames = self.mismatched = self.packs = 0
        self.syncs = []
        self._seen = {}

    def wrap(self, pack, direction, ef_of=None, role=None):
        """``pack(arr, *key)`` counted and twinned; ``key[0]`` is the EF
        key, and ``key[0][role]`` (``key[0]`` itself for ``role`` None)
        the tensor role that picks the residual's decay."""
        codec, torch = self.codec, self.torch
        self._seen[direction] = 0

        def counted(*args):
            with SyncCount(torch) as sc:
                packed = pack(*args)
            self.packs += 1
            self.syncs.append(sc.n)
            return packed

        def twin_pack(arr, *key):
            if self._seen[direction] >= self.steps:
                return counted(arr, *key)
            self._seen[direction] += 1
            # numpy has no bfloat16 here: the host codec takes a bf16
            # tensor's values widened to float32 (exact) and its frame is
            # labelled bfloat16, as the card's is
            bf16 = arr.dtype == torch.bfloat16
            x_host = arr.detach().cpu().float().numpy()
            prev = None
            if ef_of is not None:
                prev = ef_of().residual(key[0])
                prev = None if prev is None else prev.detach().cpu().numpy()
            packed = counted(arr, *key)
            ok = True
            if self.mode == "int8":
                host = codec.q8_compress(x_host)
            elif ef_of is None:   # stateless (predict)
                host = codec.topk8_pack(x_host, DENSITY)
            else:
                host, res_h = codec.topk8_compress(
                    x_host, DENSITY, residual=prev,
                    decay=codec.ef_decay_for(
                        key[0] if role is None else key[0][role]))
                ok = np.array_equal(
                    ef_of().residual(key[0]).detach().cpu().numpy(), res_h)
            if bf16:
                host["dtype"] = "bfloat16"
            self.frames += 1
            self.mismatched += int(
                not ok or codec.encode(packed) != codec.encode(host))
            return packed
        return twin_pack

    def attach_step(self, transport, server):
        """Wrap both directions of ``split_step``."""
        transport._pack_up = self.wrap(
            transport._pack_up, "up", lambda: transport._ef, 0)
        transport._pack_down = self.wrap(
            transport._pack_down, "down", lambda: server.wire_ef, 1)
        return self

    def attach_http(self, transport, server):
        """Wrap the HTTP client's pack and the server's reply pack."""
        transport._pack = self.wrap(transport._pack, "up",
                                    lambda: transport._ef)
        server._pack_reply = self.wrap(server._pack_reply, "down",
                                       lambda: server.runtime.wire_ef, 1)
        return self

    def attach_predict(self, transport):
        """Wrap the stateless packs of ``predict`` (both directions)."""
        transport._pack_stateless = self.wrap(transport._pack_stateless,
                                              "predict")
        self.steps *= 2   # a token's hop packs twice: up and down
        return self

    def probe(self, torch, dev):
        """An exact-half tensor through the card's and the host's q8."""
        x = wire_input(torch, dev, None, math.prod(CNN_CUT), "halves",
                       torch.float32)
        self.frames += 1
        self.mismatched += int(
            self.codec.encode(self.codec.q8_compress(x))
            != self.codec.encode(self.codec.q8_compress(x.cpu().numpy())))


def two_party_stack(torch, mode, device, init_seed=0):
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.runtime import (
        ServerRuntime, SplitClientTrainer)
    from split_learning_tpu_torch.transport import LocalTransport
    from split_learning_tpu_torch.utils import Config
    cfg = Config(transport="local", batch_size=BATCH, lr=LR)
    server = ServerRuntime(get_plan(), cfg,
                           torch.Generator().manual_seed(init_seed),
                           device=device)
    transport = LocalTransport(server, compress=mode, density=DENSITY)
    client = SplitClientTrainer(get_plan(), cfg,
                                torch.Generator().manual_seed(init_seed),
                                transport, device=device)
    return client, transport, server


def wire_launches(mode, frames):
    """The wire kernels' launches for ``frames`` packs in ``mode``: the
    encode on the card, and for int8 the dequantize of the decode."""
    from split_learning_tpu_torch.ops import quantize as qmod
    from split_learning_tpu_torch.ops import topk as kmod
    if mode == "int8":
        return {qmod.QUANT: frames, qmod.DEQUANT: frames}
    if mode == "topk8":
        return {name: frames for name in kmod.SELECT_LAUNCHES}
    return {}


def two_party_runs(torch, dev, data, planted):
    """Phase 13: the two-party CNN in each mode, with exact launch
    counts, the frame twin, one host sync per frame, the planted fault
    and a CPU twin."""
    from split_learning_tpu_torch.ops import quantize as qmod
    from split_learning_tpu_torch.ops.common import LAUNCHES, NVCC_FLAGS
    from split_learning_tpu_torch.ops.cross_entropy import BWD, FWD
    from split_learning_tpu_torch.ops.sgd import NAME as SGD
    from split_learning_tpu_torch.transport import codec

    base = {FWD: 1, BWD: 1, SGD: 2}
    per_step = {mode: {**base, **wire_launches(mode, 2)}
                for mode in WIRE_MODES}
    modes, twins, totals = {}, {}, {}
    for mode in WIRE_MODES:
        client, transport, server = two_party_stack(torch, mode, "cuda")
        twin = (FrameTwin(torch, codec, mode).attach_step(transport, server)
                if mode != "none" else None)
        LAUNCHES.reset()
        losses, step_ms = [], []
        for i, (x, y) in enumerate(data):
            t = time.perf_counter()
            losses.append(client.train_step(x, y, i))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
        counts = LAUNCHES.snapshot()
        want = {k: v * STEPS for k, v in per_step[mode].items()}
        print(f"[two-party] {mode}: {STEPS} steps, launches {counts}, "
              f"losses {losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)
        check(counts == want, f"two-party {mode} launches {counts}, "
                              f"want {want}")
        check(all(math.isfinite(v) for v in losses), f"{mode}: finite")
        check(statistics.mean(losses[-5:]) < statistics.mean(losses[:5]),
              f"two-party {mode}: loss did not fall: {losses}")
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        if twin is not None:
            check(twin.packs == 2 * STEPS and set(twin.syncs) == {1},
                  f"{mode}: host syncs per card encode {sorted(set(twin.syncs))}"
                  f" over {twin.packs} frames, want 1")
            twin.probe(torch, dev)
            check(twin.frames == 2 * FRAME_TWIN_STEPS + 1
                  and twin.mismatched == 0,
                  f"{mode} frame twin: {twin.mismatched} of {twin.frames} "
                  "frames differ from the host codec's")
            twins[mode] = {"frames": twin.frames,
                           "mismatched": twin.mismatched,
                           "encodes": twin.packs,
                           "host_syncs_per_encode": twin.syncs[0]}
        stats = transport.stats.summary()

        def more_steps(client=client):
            for i, (x, y) in enumerate(data[:PROFILE_STEPS]):
                client.train_step(x, y, STEPS + i)
            torch.cuda.synchronize()
        steady = step_ms[5:]
        modes[mode] = dict(
            step_ms_median=statistics.median(steady),
            step_ms_min=min(steady), step_ms_max=max(steady),
            step_ms_first=step_ms[0], steps_per_s=1e3 / statistics.median(
                steady),
            wire_bytes_up_per_step=stats["bytes_sent"] / STEPS,
            wire_bytes_down_per_step=stats["bytes_received"] / STEPS,
            compression_ratio=stats.get("compression_ratio"),
            loss_first=losses[0], loss_last=losses[-1],
            losses_head=losses[:WIRE_TWIN_STEPS],
            launches=counts, launches_per_step=per_step[mode],
            profile=profile_window(torch, more_steps, PROFILE_STEPS))
        if mode == "none":
            none_losses = losses

    # the planted fault: K3's quantize with roundf must fail the twin
    real_lib = qmod._lib
    bad_lib = qmod.bind(planted_lib(planted, "quantize_roundf"))
    qmod._lib = lambda: bad_lib
    try:
        client, transport, server = two_party_stack(torch, "int8", "cuda")
        bad = FrameTwin(torch, codec, "int8").attach_step(transport, server)
        for i, (x, y) in enumerate(data[:FRAME_TWIN_STEPS]):
            client.train_step(x, y, i)
        bad.probe(torch, dev)
    finally:
        qmod._lib = real_lib
    check(bad.mismatched > 0, f"a planted roundf K3 passed the frame twin "
                              f"({bad.frames} frames)")
    print(f"[two-party] frame twin: {twins}; a planted roundf K3 changes "
          f"{bad.mismatched} of {bad.frames} frames (built with "
          f"{' '.join(NVCC_FLAGS[:2])})", flush=True)

    twin_client = two_party_stack(torch, "none", "cpu")[0]
    twin_losses = [twin_client.train_step(x, y, i)
                   for i, (x, y) in enumerate(data[:WIRE_TWIN_STEPS])]
    twin_diff = max(abs(a - b) for a, b in zip(twin_losses, none_losses))
    check(twin_diff <= 1e-4, f"two-party CPU twin: {twin_losses} vs "
                             f"{none_losses[:WIRE_TWIN_STEPS]}")
    print(f"[two-party] CPU twin of none within {twin_diff:.3g} over "
          f"{WIRE_TWIN_STEPS} steps", flush=True)
    return dict(modes=modes, frame_twin=twins,
                planted_roundf=dict(frames=bad.frames,
                                    mismatched=bad.mismatched),
                cpu_twin_steps=WIRE_TWIN_STEPS,
                cpu_twin_max_abs_diff=twin_diff), totals


def decode_runs(torch, dev):
    """Phase 15: split-party LM decode at full width, ``generate_remote``
    over ``LocalTransport(ServerRuntime)`` on the card in each wire mode,
    with exact launch counts, the local decode's tokens on the
    uncompressed wires and a frame twin on the compressed ones."""
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.ops.common import LAUNCHES
    from split_learning_tpu_torch.ops.flash_attention import NAME as FA
    from split_learning_tpu_torch.runtime import (
        ServerRuntime, generate_remote, greedy_generate)
    from split_learning_tpu_torch.transport import LocalTransport, codec
    from split_learning_tpu_torch.utils import Config

    plan = get_plan(dtype="float32", **LM)
    params = plan.init(torch.Generator().manual_seed(0), torch.zeros(1))
    on_card = tuple({k: v.to(dev) for k, v in st.items()} for st in params)
    client_params = [on_card[i] for i in plan.stages_of("client")]
    prompt = np.random.RandomState(1).randint(
        0, LM["vocab"], (DEC_B, DEC_P)).astype(np.int32)
    server = ServerRuntime(plan, Config(batch_size=DEC_B), params,
                           device="cuda")
    local = greedy_generate(plan, on_card, prompt, DEC_NEW, kv_cache=False,
                            device="cuda").cpu().numpy()
    runs, totals, tokens = {}, {}, {}
    for mode in DEC_MODES:
        transport = LocalTransport(server, compress=mode, density=DENSITY)
        LAUNCHES.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        toks = generate_remote(plan, client_params, transport, prompt,
                               DEC_NEW, device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        counts = LAUNCHES.snapshot()
        want = {FA: N_BLOCKS * DEC_NEW, **wire_launches(mode, 2 * DEC_NEW)}
        label = str(mode)
        print(f"[decode] {label}: {DEC_NEW} tokens in {secs * 1e3:.1f} ms, "
              f"launches {counts}", flush=True)
        check(counts == want, f"decode {label} launches {counts}, want {want}")
        check(toks.shape == (DEC_B, DEC_P + DEC_NEW)
              and np.array_equal(toks[:, :DEC_P], prompt)
              and 0 <= toks.min() and toks.max() < LM["vocab"],
              f"decode {label}: tokens {toks.shape}")
        tokens[label] = toks
        stats = transport.stats.summary()
        rec = dict(seconds=secs, tokens_per_s=DEC_B * DEC_NEW / secs,
                   ms_per_token_step=secs * 1e3 / DEC_NEW, launches=counts,
                   wire_bytes_per_token=(stats["bytes_sent"]
                                         + stats["bytes_received"]) / DEC_NEW,
                   compression_ratio=stats.get("compression_ratio"))
        if mode in (None, "none"):
            agree = float((toks == local).mean())
            check(agree == 1.0, f"decode {label}: tokens agree with the "
                                f"local re-forward decode on {agree}")
            rec["tokens_equal_local_decode"] = True
        else:
            # the frame twin in a run of its own: the host encodes of the
            # twin would swamp the timed run
            twinned = LocalTransport(server, compress=mode, density=DENSITY)
            twin = FrameTwin(torch, codec, mode).attach_predict(twinned)
            twin_toks = generate_remote(plan, client_params, twinned, prompt,
                                        DEC_NEW, device="cuda")
            check(np.array_equal(twin_toks, toks)
                  and twin.frames == 2 * FRAME_TWIN_STEPS
                  and twin.mismatched == 0 and set(twin.syncs) == {1},
                  f"decode {label} frame twin: {twin.mismatched} of "
                  f"{twin.frames} frames differ, host syncs per encode "
                  f"{sorted(set(twin.syncs))}")
            rec.update(frame_twin=dict(frames=twin.frames,
                                       mismatched=twin.mismatched),
                       host_syncs_per_encode=twin.syncs[0],
                       agree_with_local_decode=float((toks == local).mean()))
        runs[label] = rec
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
    # what phase 17 decodes again over HTTP
    ctx = dict(plan=plan, client_params=client_params, prompt=prompt,
               server=server, tokens=tokens)
    return dict(model="transformer_lm", mode="split", dtype="float32",
                d_model=LM["d_model"], num_heads=LM["num_heads"],
                vocab=LM["vocab"], blocks=N_BLOCKS, attn="flash",
                batch=DEC_B, prompt=DEC_P, new_tokens=DEC_NEW,
                cut=list(GEN_CUT), density=DENSITY, modes=runs), totals, ctx


def capture_posts(server):
    """Every POST body ``server`` (a ``SplitHTTPServer``) receives, as
    ``(path, bytes)``, in arrival order."""
    import io
    bodies = []
    handler = server._httpd.RequestHandlerClass
    do_post = handler.do_POST

    def capturing(self):
        raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
        bodies.append((self.path, raw))
        self.rfile = io.BytesIO(raw)
        do_post(self)

    handler.do_POST = capturing
    return bodies


def http_stack(torch, mode, chaos=None):
    """Phase 13's two parties from the same init, over a real socket: a
    ``SplitHTTPServer`` on 127.0.0.1:0 in a thread of this process in
    front of the ``ServerRuntime`` on the card, and the client over
    ``HttpTransport``. With ``chaos`` (server-side faults) the client
    retries, behind a circuit breaker, without backoff sleeps."""
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.runtime import (
        CircuitBreaker, ServerRuntime, SplitClientTrainer)
    from split_learning_tpu_torch.transport import (
        ChaosPolicy, HttpTransport, SplitHTTPServer)
    from split_learning_tpu_torch.utils import Config
    cfg = Config(transport="http", batch_size=BATCH, lr=LR)
    runtime = ServerRuntime(get_plan(), cfg, torch.Generator().manual_seed(0),
                            device="cuda")
    policy = ChaosPolicy(chaos, seed=CHAOS_SEED) if chaos else None
    server = SplitHTTPServer(runtime, host="127.0.0.1", port=0,
                             chaos=policy).start()
    transport = HttpTransport(server.url, timeout=HTTP_TIMEOUT, compress=mode,
                              density=DENSITY)
    kw = {}
    if chaos:
        kw = dict(failure_policy="retry", retry_backoff=0.0,
                  breaker=CircuitBreaker(transport.health, seed=0))
    client = SplitClientTrainer(get_plan(), cfg,
                                torch.Generator().manual_seed(0), transport,
                                device="cuda", **kw)
    return client, transport, server


def http_extra_bytes(codec, mode, step):
    """What an HTTP frame of ``step`` carries beyond the in-process wire's
    frame of the same tensors, (up, down): the step and the client id up,
    with the wire mode (and topk8's density), and the echoed step down.
    They are entries of a msgpack map of at most 15 keys either way, so
    their size is their own encoding less its one-byte map header."""
    up = {"step": step, "client_id": 0}
    if mode != "none":
        up["compress"] = mode
        if mode == "topk8":
            up["density"] = DENSITY
    return (len(codec.encode(up)) - 1,
            len(codec.encode({"step": step})) - 1)


def http_runs(torch, dev, data, two_party):
    """Phase 16: the two-party CNN over HTTP in each mode, with phase 13's
    exact launch counts, one host sync per card encode, phase 13's cut
    bytes and first losses; then the chaos twin in int8 and topk8.
    Returns the record, the launch totals of the clean runs and the
    ``none`` run's live stack for phase 17."""
    from split_learning_tpu_torch.ops.common import LAUNCHES
    from split_learning_tpu_torch.ops.cross_entropy import BWD, FWD
    from split_learning_tpu_torch.ops.sgd import NAME as SGD
    from split_learning_tpu_torch.transport import codec

    base = {FWD: 1, BWD: 1, SGD: 2}
    modes, totals, keep = {}, {}, None
    for mode in WIRE_MODES:
        client, transport, server = http_stack(torch, mode)
        twin = (FrameTwin(torch, codec, mode).attach_http(transport, server)
                if mode != "none" else None)
        LAUNCHES.reset()
        losses, step_ms = [], []
        for i, (x, y) in enumerate(data):
            t = time.perf_counter()
            losses.append(client.train_step(x, y, i))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
        counts = LAUNCHES.snapshot()
        per_step = {**base, **wire_launches(mode, 2)}
        want = {k: v * STEPS for k, v in per_step.items()}
        print(f"[http] {mode}: {STEPS} steps over {server.url}, launches "
              f"{counts}, losses {losses[0]:.4f} -> {losses[-1]:.4f}",
              flush=True)
        check(counts == want, f"http {mode} launches {counts}, want {want}")
        check(all(math.isfinite(v) for v in losses), f"http {mode}: finite")
        check(statistics.mean(losses[-5:]) < statistics.mean(losses[:5]),
              f"http {mode}: loss did not fall: {losses}")
        local = two_party["modes"][mode]
        head = local["losses_head"]
        head_diff = max(abs(a - b) for a, b in zip(losses, head))
        check(head_diff <= 1e-4, f"http {mode}: losses {losses[:len(head)]} "
                                 f"against the local wire's {head}")
        stats = transport.stats.summary()
        extra = [http_extra_bytes(codec, mode, i) for i in range(STEPS)]
        local_up = round(local["wire_bytes_up_per_step"] * STEPS)
        local_down = round(local["wire_bytes_down_per_step"] * STEPS)
        check(stats["bytes_sent"] == local_up + sum(e[0] for e in extra)
              and stats["bytes_received"]
              == local_down + sum(e[1] for e in extra),
              f"http {mode}: frame bytes {stats['bytes_sent']} / "
              f"{stats['bytes_received']} against the local wire's "
              f"{local_up} / {local_down} and the protocol keys {extra[:2]}")
        rec = {}
        if twin is not None:
            check(twin.packs == 2 * STEPS and set(twin.syncs) == {1}
                  and twin.frames == 2 * FRAME_TWIN_STEPS
                  and twin.mismatched == 0,
                  f"http {mode}: {twin.mismatched} of {twin.frames} frames "
                  f"differ from the host codec's; host syncs per card "
                  f"encode {sorted(set(twin.syncs))} over {twin.packs}")
            rec.update(frame_twin=dict(frames=twin.frames,
                                       mismatched=twin.mismatched),
                       encodes=twin.packs,
                       host_syncs_per_encode=twin.syncs[0])

        def more_steps(client=client):
            for i, (x, y) in enumerate(data[:PROFILE_STEPS]):
                client.train_step(x, y, STEPS + i)
            torch.cuda.synchronize()
        steady = step_ms[5:]
        rec.update(
            step_ms_median=statistics.median(steady),
            step_ms_min=min(steady), step_ms_max=max(steady),
            step_ms_first=step_ms[0],
            local_step_ms_median=local["step_ms_median"],
            wire_bytes_up_per_step=stats["bytes_sent"] / STEPS,
            wire_bytes_down_per_step=stats["bytes_received"] / STEPS,
            local_wire_bytes_up_per_step=local["wire_bytes_up_per_step"],
            local_wire_bytes_down_per_step=local[
                "wire_bytes_down_per_step"],
            protocol_bytes_per_step=[sum(e[0] for e in extra) / STEPS,
                                     sum(e[1] for e in extra) / STEPS],
            compression_ratio=stats.get("compression_ratio"),
            losses_head_max_abs_diff=head_diff,
            loss_first=losses[0], loss_last=losses[-1],
            launches=counts, launches_per_step=per_step,
            profile=profile_window(torch, more_steps, PROFILE_STEPS))
        modes[mode] = rec
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        if mode == "none":
            keep = (client, transport, server)
        else:
            transport.close()
            server.stop()

    chaos = {mode: chaos_twin(torch, codec, data, mode)
             for mode in CHAOS_MODES}
    return dict(modes=modes, chaos_twin=chaos), totals, keep


def chaos_twin(torch, codec, data, mode):
    """Phase 16's chaos twin in ``mode``: a clean HTTP run and one with
    the server-side faults of :data:`CHAOS_SPEC`, from the same init.
    cuDNN picks deterministic convolution algorithms for both (its
    default backward sums in an order that changes run to run, which
    moved a topk8 run's losses by 4e-4 through the selection), so the
    two runs differ only by what the faults do."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = {}
        for spec in (None, CHAOS_SPEC):
            client, transport, server = http_stack(torch, mode, chaos=spec)
            bodies = capture_posts(server)
            try:
                losses = [client.train_step(x, y, i)
                          for i, (x, y) in enumerate(data)]
                acked = transport.health()["step"]
            finally:
                transport.close()
                server.stop()
            runs[spec] = (losses, client, server, bodies, acked)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    clean = runs[None][0]
    losses, client, server, bodies, acked = runs[CHAOS_SPEC]
    injected = dict(server.chaos.injected)
    post_apply = injected.get("drop_resp", 0) + injected.get("corrupt", 0)
    hits = server.runtime.replay.body_hits
    first, resent = {}, 0
    for _, body in bodies:
        step = int(codec.decode(body)["step"])
        if step in first:
            resent += 1
            check(body == first[step], f"chaos {mode}: a retried frame of "
                                       f"step {step} differs")
        first.setdefault(step, body)
    diff = max(abs(a - b) for a, b in zip(losses, clean))
    print(f"[http] chaos {mode}: faults {injected}, {resent} frames resent "
          f"byte-equal, replay hits {hits}, dropped "
          f"{client.dropped_batches}, losses within {diff:.3g} of the "
          f"clean run", flush=True)
    check(client.dropped_batches == 0 and None not in losses,
          f"chaos {mode}: dropped {client.dropped_batches}")
    check(acked == runs[None][4] == STEPS - 1,
          f"chaos {mode}: /health step {acked}")
    check(post_apply > 0 and hits == post_apply,
          f"chaos {mode}: {hits} replay hits for {post_apply} post-apply "
          "faults")
    check(resent == sum(injected.values()) and len(first) == STEPS,
          f"chaos {mode}: {resent} resent frames for {injected}")
    check(diff <= CHAOS_LOSS_TOL, f"chaos {mode}: losses {diff} from the "
                                  "clean HTTP run's")
    return dict(spec=CHAOS_SPEC, seed=CHAOS_SEED, faults=injected,
                replay_body_hits=hits, frames_resent=resent,
                breaker=client.breaker.counters, loss_max_abs_diff=diff,
                cudnn_deterministic=True)


def http_serving(torch, launch_run, ds, keep, dec_ctx, decode):
    """Phase 17: ``evaluate_remote`` over phase 16's ``none`` server
    against ``evaluate`` (and over int8 against a CPU twin),
    ``generate_remote`` over HTTP against phase 15's tokens with exact
    launch counts, and the ``serve`` subprocess with ``train
    --transport http`` through the CLI."""
    import contextlib
    import io
    import queue
    import signal
    import subprocess
    import threading

    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.ops import quantize as qmod
    from split_learning_tpu_torch.ops.common import LAUNCHES
    from split_learning_tpu_torch.ops.flash_attention import NAME as FA
    from split_learning_tpu_torch.ops.sgd import NAME as SGD
    from split_learning_tpu_torch.runtime import (
        ServerRuntime, evaluate, evaluate_remote, generate_remote)
    from split_learning_tpu_torch.transport import (
        HttpTransport, LocalTransport, SplitHTTPServer)
    from split_learning_tpu_torch.utils import Config

    # split-party inference of the CNN phase 16 trained
    client, transport, server = keep
    plan = get_plan()
    try:
        want = evaluate(plan, (client.params, server.runtime.params),
                        ds.test, batch_size=BATCH)
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = evaluate_remote(plan, [client.params], transport, ds.test,
                              batch_size=BATCH)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t
        t8 = HttpTransport(server.url, timeout=HTTP_TIMEOUT, compress="int8")
        got8 = evaluate_remote(plan, [client.params], t8, ds.test,
                               batch_size=BATCH)
        t8.close()
        # the same int8 frames without the socket
        local8 = evaluate_remote(
            plan, [client.params],
            LocalTransport(server.runtime, compress="int8"), ds.test,
            batch_size=BATCH)
        cpu = [{k: v.detach().cpu() for k, v in p.items()}
               for p in (client.params, server.runtime.params)]
    finally:
        transport.close()
        server.stop()
    # for the record: a CPU twin quantizes the CPU's cut, whose last bits
    # differ from the card's, so an element can land one int8 step away
    twin_rt = ServerRuntime(plan, Config(batch_size=BATCH), cpu,
                            device="cpu")
    twin8 = evaluate_remote(plan, cpu[:1],
                            LocalTransport(twin_rt, compress="int8"),
                            ds.test, batch_size=BATCH)
    rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    rel8 = abs(got8["loss"] - local8["loss"]) / abs(local8["loss"])
    print(f"[http] evaluate_remote {got['accuracy']:.4f} / {got['loss']:.6f}"
          f" against evaluate {want['accuracy']:.4f} / {want['loss']:.6f};"
          f" int8 {got8['loss']:.6f} against the local int8 wire's "
          f"{local8['loss']:.6f} (CPU twin {twin8['loss']:.6f})", flush=True)
    check(got["accuracy"] == want["accuracy"] and rel <= HTTP_EVAL_RTOL
          and got["examples"] == len(ds.test),
          f"evaluate_remote over HTTP {got} against evaluate {want}")
    check(got8["accuracy"] == local8["accuracy"] and rel8 <= HTTP_EVAL_RTOL,
          f"evaluate_remote over HTTP int8 {got8} against the local int8 "
          f"wire's {local8}")
    evaluation = dict(examples=got["examples"], accuracy=got["accuracy"],
                      loss=got["loss"], evaluate_loss=want["loss"],
                      loss_rel_diff=rel, int8_loss=got8["loss"],
                      int8_local_wire_loss=local8["loss"],
                      int8_loss_rel_diff=rel8,
                      int8_cpu_twin_loss=twin8["loss"],
                      int8_cpu_twin_rel_diff=abs(
                          got8["loss"] - twin8["loss"]) / abs(twin8["loss"]),
                      seconds=eval_s,
                      examples_per_s=got["examples"] / eval_s)

    # split-party decode of phase 15's LM over HTTP
    srv = SplitHTTPServer(dec_ctx["server"], host="127.0.0.1",
                          port=0).start()
    gen, totals = {}, {}
    try:
        for mode in WIRE_MODES:
            t = HttpTransport(srv.url, timeout=HTTP_TIMEOUT, compress=mode,
                              density=DENSITY)
            LAUNCHES.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks = generate_remote(dec_ctx["plan"], dec_ctx["client_params"],
                                   t, dec_ctx["prompt"], DEC_NEW,
                                   device="cuda")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = LAUNCHES.snapshot()
            want = {FA: N_BLOCKS * DEC_NEW,
                    **wire_launches(mode, 2 * DEC_NEW)}
            stats = t.stats.summary()
            t.close()
            same = np.array_equal(toks, dec_ctx["tokens"][mode])
            print(f"[http] generate_remote {mode}: {DEC_NEW} tokens in "
                  f"{secs * 1e3:.1f} ms, launches {counts}, phase 15's "
                  f"tokens: {same}, stalled handshakes retried "
                  f"{t.connect_retries}", flush=True)
            check(counts == want, f"http decode {mode} launches {counts}, "
                                  f"want {want}")
            check(same, f"http decode {mode}: tokens differ from phase 15's")
            gen[mode] = dict(
                seconds=secs, tokens_per_s=DEC_B * DEC_NEW / secs,
                local_tokens_per_s=decode["modes"][mode]["tokens_per_s"],
                ms_per_token_step=secs * 1e3 / DEC_NEW, launches=counts,
                wire_bytes_per_token=(stats["bytes_sent"]
                                      + stats["bytes_received"]) / DEC_NEW,
                connect_retries=t.connect_retries,
                tokens_equal_local_wire=True)
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
    finally:
        srv.stop()

    # the CLI: serve in a subprocess, train --transport http here
    err_path = os.path.join(REPO, "build", "chip_smoke_serve.err")
    os.makedirs(os.path.dirname(err_path), exist_ok=True)
    with open(err_path, "w") as err_f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "split_learning_tpu_torch.launch.run",
             "serve", "--port", "0", "--host", "127.0.0.1", "--device",
             "cuda", "--lr", str(CLI_LR)],
            cwd=REPO, stdout=subprocess.PIPE, stderr=err_f, text=True)
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                     daemon=True).start()
    try:
        try:
            first = lines.get(timeout=CLI_START_TIMEOUT)
        except queue.Empty:
            first = ""
        check(first.startswith("[serve] mode=split role=server listening on "),
              f"serve printed {first!r}; stderr: "
              f"{open(err_path).read()[-2000:]}")
        url = first.split("listening on ")[1].strip()
        out = io.StringIO()
        LAUNCHES.reset()
        with contextlib.redirect_stdout(out):
            rc = launch_run.main([
                "train", "--transport", "http", "--server-url", url,
                "--compress", "int8", "--steps", "5", "--lr", str(CLI_LR),
                "--dataset", "synthetic", "--data-dir",
                os.path.join(REPO, "build", "chip_smoke_data"),
                "--tracking", "stdout", "--wait-server", "60"])
        cli_counts = LAUNCHES.snapshot()
        text = out.getvalue()
        print(text, end="", flush=True)
        check(rc == 0, f"train --transport http returned {rc}")
        first_loss = float(next(
            ln for ln in text.splitlines()
            if ln.startswith("[step 0] loss:")).split(":")[1])
        final = float(text.split("final_loss=")[1].split()[0])
        check(final < first_loss, f"CLI over HTTP: loss {first_loss} -> "
                                  f"{final}")
        # this process is the client: its K2, and its int8 encode and
        # decode, one each a step (K1 runs in the server's process)
        check(cli_counts == {SGD: 5, qmod.QUANT: 5, qmod.DEQUANT: 5},
              f"CLI client launches {cli_counts}")
        proc.send_signal(signal.SIGINT)
        serve_rc = proc.wait(timeout=60)
        check(serve_rc == 0, f"serve exited {serve_rc}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    cli = dict(serve_url=url, serve_rc=serve_rc, train_rc=rc,
               loss_first=first_loss, loss_final=final,
               client_launches=cli_counts)
    return dict(evaluate_remote=evaluation, generate_remote=gen,
                cli=cli), totals


def old_topk8_encode(torch, x, res, decay, k):
    """The codec's topk8 encode before the select kernels (a measured
    reference): the magnitude kernel, ``select_topk``'s PyTorch ops,
    K3 over the survivors and the scatter of the residual."""
    from split_learning_tpu_torch.ops import quantize as qmod
    from split_learning_tpu_torch.ops import topk as kmod
    x_eff, m, _ = kmod.fold_magnitudes_cuda(x, res, decay)
    idx, sel = kmod.select_topk(m, k)
    vals = x_eff[idx]
    stats, q = qmod.q8_views(qmod.q8_encode_cuda(vals, k))
    x_eff[idx] = vals - q.float() * stats[1]
    return kmod.packbits(sel), q, x_eff


def wire_times(torch, dev, gen, bw, fp32):
    """Phase 14: each wire kernel, its plain version, the library call
    and the bound at the CNN cut, the generate cut and the LM cut
    (float32); K4's five launches by name from a profiler window."""
    from split_learning_tpu_torch.ops import quantize as qmod
    from split_learning_tpu_torch.ops import topk as kmod
    from torch.profiler import ProfilerActivity, profile
    out = {name: {} for name in (qmod.QUANT, qmod.DEQUANT, kmod.NAME,
                                 *kmod.SELECT_LAUNCHES)}
    encode = {}
    symbols = dict(zip(("fold_hist_kernel", "hist_mid_kernel",
                        "hist_low_kernel", "count_kernel", "write_kernel"),
                       kmod.SELECT_LAUNCHES))
    for label, shape in (("cnn_cut", CNN_CUT), ("generate_cut", GEN_CUT),
                         ("lm_cut", LM_CUT)):
        n = math.prod(shape)
        x = 3.0 * torch.randn(n, device=dev, generator=gen)
        res = 0.5 * torch.randn(n, device=dev, generator=gen)
        k = _k_of(n, DENSITY)
        stats, q = qmod.q8_views(qmod.q8_encode_cuda(x, n))
        scale = stats[1].item()
        qx = torch.quantize_per_tensor(x, scale, 0, torch.qint8)
        _, pos, payload = kmod.select_layout(n, k)
        # (kernel, plain, library, bytes moved: inputs once, outputs once)
        cases = {
            qmod.QUANT: (lambda: qmod.q8_encode_cuda(x, n),
                         lambda: qmod.q8_encode_plain(x, n),
                         None, 5 * n + 16),
            qmod.DEQUANT: (lambda: qmod.dequantize_cuda(q, scale),
                           lambda: qmod.dequantize_plain(q, scale),
                           lambda: torch.dequantize(qx), 5 * n),
            kmod.NAME: (lambda: kmod.fold_magnitudes_cuda(x, res, EF_DECAY),
                        lambda: kmod.fold_magnitudes_plain(x, res, EF_DECAY),
                        lambda: torch.abs(x), 16 * n + 4),
        }
        for name, (kern, plain, lib, nbytes) in cases.items():
            b_ms, b_by = bound(nbytes, 2 * n, bw, fp32)
            out[name][label] = dict(
                n=n, ms=device_ms(torch, kern), plain_ms=device_ms(
                    torch, plain, reps=20),
                library_ms=None if lib is None else device_ms(torch, lib),
                bytes=nbytes, bound_ms=b_ms, bound_by=b_by)
        # K3's library yardstick is two calls: the amax, then the quantize
        amax_ms = device_ms(torch, lambda: torch.amax(x.abs()))
        qpt_ms = device_ms(torch, lambda: torch.quantize_per_tensor(
            x, scale, 0, torch.qint8))
        out[qmod.QUANT][label].update(
            library_ms=amax_ms + qpt_ms, library_amax_ms=amax_ms,
            library_quantize_ms=qpt_ms)
        # the whole topk8 encode: new (five launches) against old, with
        # and without the residual, torch.topk alone as the yardstick
        new = lambda: kmod.topk8_select_cuda(x, res, EF_DECAY, k)  # noqa
        new_stateless = lambda: kmod.topk8_select_cuda(  # noqa: E731
            x, None, 1.0, k, keep_residual=False)
        m = x.abs()
        b_ms, b_by = bound(12 * n + payload, 2 * n, bw, fp32)
        b0_ms, _ = bound(4 * n + payload, 2 * n, bw, fp32)
        encode[label] = dict(
            n=n, k=k, ms=device_ms(torch, new),
            ms_stateless=device_ms(torch, new_stateless),
            host_ms=host_ms(torch, new, reps=10),
            plain_ms=host_ms(torch, lambda: kmod.topk8_select_plain(
                x, res, EF_DECAY, k), reps=5),
            old_host_ms=host_ms(torch, lambda: old_topk8_encode(
                torch, x, res, EF_DECAY, k), reps=5),
            library_ms=device_ms(torch, lambda: torch.topk(m, k), reps=20),
            library_call="torch.topk(|x|, k) alone",
            bytes=12 * n + payload, bound_ms=b_ms, bound_by=b_by,
            bytes_stateless=4 * n + payload, bound_ms_stateless=b0_ms)
        # each launch's device time, from the profiler, per encode
        # (a window that traced no device activity is taken again, at
        # most twice, as phase 5's K1 windows are)
        reps = 20
        for _ in range(3):
            for _ in range(3):
                new()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    new()
                torch.cuda.synchronize()
            per = {name: 0.0 for name in kmod.SELECT_LAUNCHES}
            traced = False
            for e in prof.events():
                if e.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                traced = True
                for sym, name in symbols.items():
                    if sym in e.name:
                        per[name] += e.time_range.end - e.time_range.start
                        break
            if traced:
                break
        # the bytes each launch must move: its inputs once, its outputs once
        launch_bytes = {kmod.SELECT_LAUNCHES[0]: 12 * n,
                        kmod.SELECT_LAUNCHES[1]: 4 * n,
                        kmod.SELECT_LAUNCHES[2]: 4 * n,
                        kmod.SELECT_LAUNCHES[3]: 4 * n,
                        kmod.SELECT_LAUNCHES[4]: 4 * n + payload + 4 * k}
        for name in kmod.SELECT_LAUNCHES:
            lb_ms, lb_by = bound(launch_bytes[name], n, bw, fp32)
            out[name][label] = dict(
                n=n, k=k, ms=per[name] / 1e3 / reps if per[name] else None,
                bytes=launch_bytes[name], bound_ms=lb_ms, bound_by=lb_by)
        print(f"[wire] times at the {label} ({n} values): "
              + ", ".join(f"{name} {out[name][label]['ms']:.4f} ms "
                          f"(bound {out[name][label]['bound_ms']:.4f})"
                          for name in cases)
              + f"; topk8 encode {encode[label]['ms']:.4f} ms (stateless "
              f"{encode[label]['ms_stateless']:.4f}, bound "
              f"{encode[label]['bound_ms']:.4f}, host {encode[label]['host_ms']:.4f}"
              f", old {encode[label]['old_host_ms']:.4f} host ms, torch.topk "
              f"{encode[label]['library_ms']:.4f})", flush=True)
    return out, encode


def bf16_loss_tol(loss: float) -> float:
    """Two bf16 ulps at the magnitude of ``loss``: 0.0625 in [4, 8). The
    card and the CPU round the bf16 activations and logits at the same
    places but sum their float32 products in other orders, so a logit can
    land one bf16 ulp apart; the cross-entropy of such logits moves by
    about as much as a logit does, and three updates later the parameters
    have moved by less than that rounding."""
    return 2 * 2.0 ** (math.floor(math.log2(abs(loss))) - 7)


def k2_bf16_checks(torch, dev, gen, lm_leaves) -> int:
    """Phase 18, K2 alone: mixed float32/bf16 leaf lists (the bf16 LM's
    54 leaves, whose ``pos`` table is bf16, and SGD_MANY leaves of odd
    sizes alternating the two dtypes, every third a view one element off
    its vector alignment), at momentum 0 and 0.9 over five steps:
    bit-identical to the plain version, each step one launch. Returns the
    number of leaf lists held."""
    from split_learning_tpu_torch.ops.common import LAUNCHES
    from split_learning_tpu_torch.ops.sgd import (
        NAME as SGD, sgd_step_cuda, sgd_step_plain)
    rs = np.random.RandomState(SGD_MANY + 1)
    many = [((int(v),), torch.bfloat16 if i % 2 else torch.float32)
            for i, v in enumerate(rs.randint(1, 3000, SGD_MANY))]
    lists = 0
    for label, spec in (("bf16 LM", lm_leaves), ("mixed", many)):
        def leaves():
            out = []
            for i, (sh, dt) in enumerate(spec):
                if label == "mixed" and i % 3 == 0:
                    out.append(torch.randn(math.prod(sh) + 1, device=dev,
                                           generator=gen).to(dt)[1:].view(sh))
                else:
                    out.append(torch.randn(sh, device=dev,
                                           generator=gen).to(dt))
            return out
        for mu in (0.0, 0.9):
            p_k = leaves()
            p_p = [t.clone() for t in p_k]
            m_k = ([torch.zeros(t.shape, device=dev) for t in p_k] if mu
                   else None)
            m_p = [t.clone() for t in m_k] if mu else None
            for _ in range(5):
                grads = leaves()
                LAUNCHES.reset()
                sgd_step_cuda(p_k, grads, m_k, TRAIN_LR, mu)
                torch.cuda.synchronize()
                check(LAUNCHES.snapshot() == {SGD: 1},
                      f"SGD launches for {label}: {LAUNCHES.snapshot()}")
                sgd_step_plain(p_p, grads, m_p, TRAIN_LR, mu)
            for a, b in zip(p_k + (m_k or []), p_p + (m_p or [])):
                check(torch.equal(a, b), f"SGD {label} mu={mu}: not "
                      f"bit-identical (max abs "
                      f"{(a.float() - b.float()).abs().max().item()})")
            lists += 1
    return lists


def lm_train_counts(steps, sgd: bool) -> dict:
    """The LM's launches over ``steps`` steps: per step one K5 and one of
    each K6 launch per block, one K1 pair, and K2 once under SGD."""
    from split_learning_tpu_torch.ops.cross_entropy import BWD, FWD
    from split_learning_tpu_torch.ops.flash_attention import (
        BWD_NAMES, NAME as FA)
    from split_learning_tpu_torch.ops.sgd import NAME as SGD
    want = {FA: N_BLOCKS * steps, **{n: N_BLOCKS * steps for n in BWD_NAMES},
            FWD: steps, BWD: steps}
    if sgd:
        want[SGD] = steps
    return want


def lm_bf16_runs(torch, tr_data):
    """Phase 18's fused LM in bf16 at phase 10's width, under SGD and
    AdamW with the schedule and clipping of :data:`LM_SCHEDULE`: exact
    launch counts, a falling loss, the leaves' dtypes, a bf16 CPU twin on
    the first rows, step times and a profiler window per optimizer."""
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.ops.common import LAUNCHES
    from split_learning_tpu_torch.runtime import FusedSplitTrainer
    from split_learning_tpu_torch.utils import Config
    plan = get_plan(dtype="bfloat16", **LM)
    init = plan.init(torch.Generator().manual_seed(0), torch.zeros(1))
    rows = [(x[:TWIN_ROWS], y[:TWIN_ROWS]) for x, y in tr_data[:TWIN_STEPS]]
    runs, totals = {}, {}
    for name, okw in LM_OPTIMS.items():
        cfg = Config(transport="fused", model="transformer_lm", attn="flash",
                     batch_size=TRAIN_B, dtype="bfloat16", **LM_SCHEDULE,
                     **okw)
        trainer = FusedSplitTrainer(plan, cfg, init, tr_data[0][0],
                                    device="cuda")
        LAUNCHES.reset()
        losses, ms = [], []
        for x, y in tr_data:
            t = time.perf_counter()
            losses.append(trainer.train_step(x, y))  # float(): syncs
            ms.append((time.perf_counter() - t) * 1e3)
        counts = LAUNCHES.snapshot()
        want = lm_train_counts(TRAIN_STEPS, name == "sgd")
        print(f"[bf16] fused LM {name}: {TRAIN_STEPS} steps, launches "
              f"{counts}, losses {losses[0]:.4f} -> {losses[-1]:.4f}",
              flush=True)
        check(counts == want, f"bf16 {name} launches {counts}, want {want}")
        check(all(math.isfinite(v) for v in losses), f"bf16 {name}: finite")
        check(statistics.mean(losses[-5:]) < statistics.mean(losses[:5]),
              f"bf16 {name}: loss did not fall: {losses}")
        for st in trainer.params:
            for k, v in st.items():
                check(v.dtype == (torch.bfloat16 if k == "pos"
                                  else torch.float32), f"{k} dtype {v.dtype}")
                check(bool(torch.isfinite(v).all()), f"finite {k}")
        twin_cfg = cfg.replace(batch_size=TWIN_ROWS)
        card = FusedSplitTrainer(plan, twin_cfg, init, rows[0][0],
                                 device="cuda")
        cpu = FusedSplitTrainer(plan, twin_cfg, init, rows[0][0],
                                device="cpu")
        card_l = [card.train_step(x, y) for x, y in rows]
        cpu_l = [cpu.train_step(x, y) for x, y in rows]
        gaps = [abs(a - b) for a, b in zip(card_l, cpu_l)]
        tols = [bf16_loss_tol(b) for b in cpu_l]
        check(all(g <= t for g, t in zip(gaps, tols)),
              f"bf16 {name} CPU twin: card {card_l} vs cpu {cpu_l}")
        print(f"[bf16] {name} CPU twin on {TWIN_ROWS} rows x {TWIN_STEPS} "
              f"steps within {max(gaps):.3g} (tolerance {tols})", flush=True)
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        steady = ms[5:]
        runs[name] = dict(
            optimizer=cfg.optimizer, lr=cfg.lr, momentum=cfg.momentum,
            weight_decay=cfg.weight_decay, **LM_SCHEDULE,
            step_ms_median=statistics.median(steady),
            step_ms_min=min(steady), step_ms_max=max(steady),
            step_ms_first=ms[0],
            tokens_per_s=TRAIN_B * TRAIN_T / statistics.median(steady) * 1e3,
            loss_first=losses[0], loss_last=losses[-1], launches=counts,
            twin_card=card_l, twin_cpu=cpu_l, twin_tol=tols,
            profile=profile_steps(torch, trainer, tr_data[:PROFILE_STEPS]))
        del trainer, card, cpu
    return runs, totals


def two_party_lm_stack(torch, mode, device, dtype, init, batch=TRAIN_B):
    """The two-party LM at phase 10's width under AdamW with
    :data:`LM_SCHEDULE`: the client owns the embedding and block 0, the
    server blocks 1-2 and the head; both from ``init``."""
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.runtime import (
        ServerRuntime, SplitClientTrainer)
    from split_learning_tpu_torch.transport import LocalTransport
    from split_learning_tpu_torch.utils import Config
    plan = get_plan(dtype=dtype, **LM)
    cfg = Config(transport="local", model="transformer_lm", attn="flash",
                 batch_size=batch, dtype=dtype, **LM_SCHEDULE,
                 **LM_OPTIMS["adamw"])
    server = ServerRuntime(plan, cfg, init, device=device)
    transport = LocalTransport(server, compress=mode, density=DENSITY)
    client = SplitClientTrainer(plan, cfg, init, transport, device=device)
    return client, transport, server


def two_party_lm_runs(torch, tr_data):
    """Phase 19 over the local wire: the two-party LM in float32 and bf16
    over ``none``, ``int8`` and ``topk8``, 30 AdamW steps each, with exact
    launch counts, one host sync per card encode, the bf16 frame twin at
    steps 1-3, step times, frame bytes and a profiler window per run; then
    a float32 ``none`` CPU twin on the first rows."""
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.ops.common import LAUNCHES
    from split_learning_tpu_torch.transport import codec
    inits = {dt: get_plan(dtype=dt, **LM).init(
        torch.Generator().manual_seed(0), torch.zeros(1))
        for dt in TP_LM_DTYPES}
    # per step: the client's block (1 K5, 1 of each K6), the server's two
    # blocks and its K1 pair; AdamW launches no K2
    per_step = lm_train_counts(1, sgd=False)
    runs, totals, twins = {}, {}, {}
    for dtype in TP_LM_DTYPES:
        for mode in WIRE_MODES:
            client, transport, server = two_party_lm_stack(
                torch, mode, "cuda", dtype, inits[dtype])
            twin = None
            if mode != "none":
                twin = FrameTwin(torch, codec, mode, steps=(
                    FRAME_TWIN_STEPS if dtype == "bfloat16" else 0))
                twin.attach_step(transport, server)
            LAUNCHES.reset()
            losses, ms = [], []
            for i, (x, y) in enumerate(tr_data):
                t = time.perf_counter()
                losses.append(client.train_step(x, y, i))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t) * 1e3)
            counts = LAUNCHES.snapshot()
            want = {k: v * TRAIN_STEPS for k, v in
                    {**per_step, **wire_launches(mode, 2)}.items()}
            label = f"{dtype} {mode}"
            print(f"[two-party LM] {label}: {TRAIN_STEPS} steps, launches "
                  f"{counts}, losses {losses[0]:.4f} -> {losses[-1]:.4f}",
                  flush=True)
            check(counts == want, f"two-party LM {label} launches {counts}, "
                                  f"want {want}")
            check(all(math.isfinite(v) for v in losses), f"{label}: finite")
            check(statistics.mean(losses[-5:]) < statistics.mean(losses[:5]),
                  f"two-party LM {label}: loss did not fall: {losses}")
            if twin is not None:
                check(twin.packs == 2 * TRAIN_STEPS and set(twin.syncs) == {1},
                      f"{label}: host syncs per card encode "
                      f"{sorted(set(twin.syncs))} over {twin.packs} frames")
                if dtype == "bfloat16":
                    check(twin.frames == 2 * FRAME_TWIN_STEPS
                          and twin.mismatched == 0,
                          f"{label} frame twin: {twin.mismatched} of "
                          f"{twin.frames} frames differ from the host "
                          "codec's")
                    twins[mode] = dict(frames=twin.frames,
                                       mismatched=twin.mismatched)
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
            stats = transport.stats.summary()

            def more_steps(client=client):
                for i, (x, y) in enumerate(tr_data[:PROFILE_STEPS]):
                    client.train_step(x, y, TRAIN_STEPS + i)
                torch.cuda.synchronize()
            steady = ms[5:]
            runs[label] = dict(
                dtype=dtype, compress=mode,
                step_ms_median=statistics.median(steady),
                step_ms_min=min(steady), step_ms_max=max(steady),
                step_ms_first=ms[0], tokens_per_s=(
                    TRAIN_B * TRAIN_T / statistics.median(steady) * 1e3),
                wire_bytes_up_per_step=stats["bytes_sent"] / TRAIN_STEPS,
                wire_bytes_down_per_step=(stats["bytes_received"]
                                          / TRAIN_STEPS),
                compression_ratio=stats.get("compression_ratio"),
                loss_first=losses[0], loss_last=losses[-1], launches=counts,
                launches_per_step={**per_step, **wire_launches(mode, 2)},
                host_syncs_per_encode=(None if twin is None
                                       else twin.syncs[0]),
                profile=profile_window(torch, more_steps, PROFILE_STEPS))
            del client, transport, server
    rows = [(x[:TWIN_ROWS], y[:TWIN_ROWS])
            for x, y in tr_data[:WIRE_TWIN_STEPS]]
    pair = {dev: two_party_lm_stack(torch, "none", dev, "float32",
                                    inits["float32"], TWIN_ROWS)[0]
            for dev in ("cuda", "cpu")}
    twin_l = {dev: [c.train_step(x, y, i) for i, (x, y) in enumerate(rows)]
              for dev, c in pair.items()}
    diff = max(abs(a - b) for a, b in zip(twin_l["cuda"], twin_l["cpu"]))
    check(diff <= TWIN_TOL, f"two-party LM CPU twin: {twin_l}")
    print(f"[two-party LM] float32 none CPU twin on {TWIN_ROWS} rows x "
          f"{WIRE_TWIN_STEPS} steps within {diff:.3g}; bf16 frame twin "
          f"{twins}", flush=True)
    return dict(runs=runs, frame_twin_bf16=twins,
                cpu_twin=dict(rows=TWIN_ROWS, steps=WIRE_TWIN_STEPS,
                              card=twin_l["cuda"], cpu=twin_l["cpu"],
                              max_abs_diff=diff)), totals


def lm_cli_http(torch, launch_run) -> dict:
    """Phase 19 over HTTP: ``launch.run serve`` with the bf16 AdamW LM as
    a subprocess on the card, and ``train --transport http`` with the same
    flags against it for 5 int8 steps: both rc 0, a falling loss, and the
    client's launches exact (its block's K5 and K6, its int8 encode and
    decode; the server's K1 runs in the other process, AdamW has no K2)."""
    import contextlib
    import io
    import queue
    import signal
    import subprocess
    import threading

    from split_learning_tpu_torch.ops import quantize as qmod
    from split_learning_tpu_torch.ops.common import LAUNCHES
    from split_learning_tpu_torch.ops.flash_attention import (
        BWD_NAMES, NAME as FA)
    flags = ["--device", "cuda", "--model", "transformer_lm", "--dataset",
             "lm", "--seq-len", str(TRAIN_T), "--d-model",
             str(LM["d_model"]), "--num-heads", str(LM["num_heads"]),
             "--client-depth", str(LM["client_depth"]), "--server-depth",
             str(LM["server_depth"]), "--attn", "flash", "--batch-size",
             str(TRAIN_B), "--dtype", "bfloat16", "--optimizer", "adamw",
             "--lr", str(LM_CLI_LR), "--weight-decay", "0.1",
             "--warmup-steps", "2", "--decay-steps", "10",
             "--grad-clip-norm", "1.0", "--data-dir",
             os.path.join(REPO, "build", "chip_smoke_data")]
    err_path = os.path.join(REPO, "build", "chip_smoke_serve_lm.err")
    os.makedirs(os.path.dirname(err_path), exist_ok=True)
    with open(err_path, "w") as err_f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "split_learning_tpu_torch.launch.run",
             "serve", "--port", "0", "--host", "127.0.0.1", *flags],
            cwd=REPO, stdout=subprocess.PIPE, stderr=err_f, text=True)
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                     daemon=True).start()
    try:
        try:
            first = lines.get(timeout=CLI_START_TIMEOUT)
        except queue.Empty:
            first = ""
        check(first.startswith("[serve] mode=split role=server listening on "),
              f"serve printed {first!r}; stderr: "
              f"{open(err_path).read()[-2000:]}")
        url = first.split("listening on ")[1].strip()
        out = io.StringIO()
        LAUNCHES.reset()
        with contextlib.redirect_stdout(out):
            rc = launch_run.main([
                "train", "--transport", "http", "--server-url", url,
                "--compress", "int8", "--steps", "5", "--tracking",
                "stdout", "--wait-server", "60", *flags])
        counts = LAUNCHES.snapshot()
        text = out.getvalue()
        print(text, end="", flush=True)
        check(rc == 0, f"LM train --transport http returned {rc}")
        first_loss = float(next(
            ln for ln in text.splitlines()
            if ln.startswith("[step 0] loss:")).split(":")[1])
        final = float(text.split("final_loss=")[1].split()[0])
        check(final < first_loss, f"LM CLI over HTTP: loss {first_loss} -> "
                                  f"{final}")
        want = {FA: 5, **{n: 5 for n in BWD_NAMES}, qmod.QUANT: 5,
                qmod.DEQUANT: 5}
        check(counts == want, f"LM CLI client launches {counts}, want {want}")
        proc.send_signal(signal.SIGINT)
        serve_rc = proc.wait(timeout=60)
        check(serve_rc == 0, f"LM serve exited {serve_rc}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    return dict(serve_rc=serve_rc, train_rc=rc, loss_first=first_loss,
                loss_final=final, client_launches=counts,
                flags=" ".join(flags))


def k2_bf16_times(torch, dev, gen, lm_leaves, bw, fp32) -> dict:
    """K2 at the bf16 LM's 54 leaves (its ``pos`` table bf16), momentum
    0.9: one launch, its plain version, ``torch.optim.SGD(fused=True)``,
    and the bound (float32 leaves 20 bytes, bf16 leaves 2 + 2 + 2 bytes
    and an 8-byte trace read and write)."""
    from split_learning_tpu_torch.ops.common import LAUNCHES
    from split_learning_tpu_torch.ops.sgd import (
        NAME as SGD, sgd_step_cuda, sgd_step_plain)
    p = [torch.randn(sh, device=dev, generator=gen).to(dt)
         for sh, dt in lm_leaves]
    g = [(1e-3 * torch.randn(sh, device=dev, generator=gen)).to(dt)
         for sh, dt in lm_leaves]
    m = [torch.zeros(t.shape, device=dev) for t in p]
    n_bf16 = sum(t.numel() for t in p if t.dtype == torch.bfloat16)
    n_all = sum(t.numel() for t in p)
    nbytes = 20 * (n_all - n_bf16) + 14 * n_bf16
    opt_p = [t.clone() for t in p]
    for t, g_ in zip(opt_p, g):
        t.grad = g_
    opt = torch.optim.SGD(opt_p, lr=TRAIN_LR, momentum=TRAIN_MU, fused=True)
    b_ms, b_by = bound(nbytes, 4 * n_all, bw, fp32)
    LAUNCHES.reset()
    sgd_step_cuda(p, g, m, TRAIN_LR, TRAIN_MU)
    launches = LAUNCHES.snapshot()[SGD]
    return dict(
        leaves=len(p), params=n_all, bf16_params=n_bf16, momentum=TRAIN_MU,
        launches_per_step=launches,
        ms=device_ms(torch, lambda: sgd_step_cuda(p, g, m, TRAIN_LR,
                                                  TRAIN_MU)),
        plain_ms=device_ms(torch, lambda: sgd_step_plain(p, g, m, TRAIN_LR,
                                                         TRAIN_MU)),
        library_ms=device_ms(torch, opt.step),
        library_call="torch.optim.SGD(fused=True).step()", bytes=nbytes,
        bound_ms=b_ms, bound_by=b_by)



# --------------------------------------------------------------------- #
# phases 20-23: the U-shaped split, federated training, the multi-client
# runner, and their CLI
# --------------------------------------------------------------------- #
def hop_bytes(transport) -> dict:
    """Record each frame's bytes on the local wire, in call order: hop 1
    up and down, then hop 2 up and down."""
    sizes = []
    wire = transport._wire

    def spy(payload, device):
        tree, n = wire(payload, device)
        sizes.append(n)
        return tree, n

    transport._wire = spy
    return sizes


def party_counts(server, ops=("u_forward", "u_backward")) -> dict:
    """Count the launches made inside the server's ``ops`` (its stages'
    compute; the wire's encodes and decodes run in the transport)."""
    from split_learning_tpu_torch.ops.common import LAUNCHES
    counts: dict = {}
    for op in ops:
        fn = getattr(server, op)

        def spy(*a, _fn=fn, **kw):
            before = LAUNCHES.snapshot()
            out = _fn(*a, **kw)
            for k, v in LAUNCHES.snapshot().items():
                if v != before.get(k, 0):
                    counts[k] = counts.get(k, 0) + v - before.get(k, 0)
            return out

        setattr(server, op, spy)
    return counts


def u_stack(torch, mode, device, plan, cfg, init):
    from split_learning_tpu_torch.runtime import (
        ServerRuntime, USplitClientTrainer)
    from split_learning_tpu_torch.transport import LocalTransport
    server = ServerRuntime(plan, cfg, init, device=device)
    transport = LocalTransport(server, compress=mode, density=DENSITY)
    client = USplitClientTrainer(plan, cfg, init, transport, device=device)
    return client, transport, server


def u_run(torch, client, transport, data, steps, label, want):
    """``steps`` U steps with step times, launch counts held to ``want``
    (per step), the frames' bytes and a profiler window."""
    from split_learning_tpu_torch.ops.common import LAUNCHES
    sizes = hop_bytes(transport)
    LAUNCHES.reset()
    losses, ms = [], []
    for i, (x, y) in enumerate(data[:steps]):
        t = time.perf_counter()
        losses.append(client.train_step(x, y, i))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    counts = LAUNCHES.snapshot()
    total = {k: v * steps for k, v in want.items()}
    print(f"[{label}] {steps} steps, launches {counts}, losses "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)
    check(counts == total, f"{label} launches {counts}, want {total}")
    check(all(math.isfinite(v) for v in losses), f"{label}: finite")
    check(statistics.mean(losses[-5:]) < statistics.mean(losses[:5]),
          f"{label}: loss did not fall: {losses}")
    frames = {"u_forward": {"up": sizes[0], "down": sizes[1]},
              "u_backward": {"up": sizes[2], "down": sizes[3]}} \
        if len(sizes) >= 4 else None

    def more_steps():
        for i, (x, y) in enumerate(data[:PROFILE_STEPS]):
            client.train_step(x, y, steps + i)
        torch.cuda.synchronize()
    steady = ms[5:]
    stats = transport.stats.summary()
    return dict(step_ms_median=statistics.median(steady),
                step_ms_min=min(steady), step_ms_max=max(steady),
                step_ms_first=ms[0], frame_bytes_per_hop=frames,
                wire_bytes_up_per_step=stats["bytes_sent"] / steps,
                wire_bytes_down_per_step=stats["bytes_received"] / steps,
                compression_ratio=stats.get("compression_ratio"),
                loss_first=losses[0], loss_last=losses[-1],
                losses_head=losses[:U_TWIN_STEPS], launches=counts,
                launches_per_step=want,
                profile=profile_window(torch, more_steps, PROFILE_STEPS))


def u_cnn_runs(torch, data):
    """Phase 20: the U-shaped CNN over ``none``, ``int8`` and ``topk8``,
    30 steps each with exact launches per step, frame bytes per hop and
    direction, a profiler window, and a CPU twin in each mode (its hops
    through the host codec; phase 12 holds K3 and K4s at the hops'
    sizes)."""
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.ops.cross_entropy import BWD, FWD
    from split_learning_tpu_torch.ops.sgd import NAME as SGD
    from split_learning_tpu_torch.utils import Config
    plan = get_plan(mode="u_split")
    cfg = Config(mode="u_split", transport="local", batch_size=BATCH, lr=LR)
    with torch.no_grad():
        params = plan.init(torch.Generator().manual_seed(0), torch.zeros(1))
        acts = plan.apply_range(params, torch.as_tensor(data[0][0]), 0, 1)
        feats = plan.apply_range(params, acts, 1, 2)
    check((tuple(acts.shape), tuple(feats.shape)) == (CNN_CUT, U_CNN_HOP2),
          f"U CNN hops {acts.shape}, {feats.shape}: phase 12 checks "
          f"{CNN_CUT} and {U_CNN_HOP2}")
    # client: the head's K1 pair, K2 for A and for C; server: K2 for the
    # trunk; four frames a step
    base = {FWD: 1, BWD: 1, SGD: 3}
    runs, totals = {}, {}
    for mode in WIRE_MODES:
        client, transport, server = u_stack(
            torch, mode, "cuda", plan, cfg, torch.Generator().manual_seed(0))
        srv = party_counts(server)
        want = {**base, **wire_launches(mode, 4)}
        runs[mode] = u_run(torch, client, transport, data, STEPS,
                           f"U CNN {mode}", want)
        check(srv == {SGD: STEPS + PROFILE_STEPS},
              f"U CNN {mode}: server launches {srv}")
        check(not server._u_residual, f"U CNN {mode}: residuals left")
        runs[mode]["server_launches"] = srv
        for k, v in runs[mode]["launches"].items():
            totals[k] = totals.get(k, 0) + v
    diffs = {}
    for mode in WIRE_MODES:
        twin = u_stack(torch, mode, "cpu", plan, cfg,
                       torch.Generator().manual_seed(0))[0]
        twin_l = [twin.train_step(x, y, i)
                  for i, (x, y) in enumerate(data[:U_TWIN_STEPS])]
        diffs[mode] = max(abs(a - b) for a, b in
                          zip(twin_l, runs[mode]["losses_head"]))
        check(diffs[mode] <= U_TWIN_TOL[mode],
              f"U CNN CPU twin {mode}: {twin_l} vs "
              f"{runs[mode]['losses_head']}")
    print(f"[U CNN] median step ms " + ", ".join(
        f"{m} {r['step_ms_median']:.2f}" for m, r in runs.items())
        + f"; CPU twins within {diffs}", flush=True)
    return dict(runs=runs, cpu_twin_steps=U_TWIN_STEPS,
                cpu_twin_max_abs_diff=diffs), totals


def u_lm_runs(torch, tr_data):
    """Phase 21: the U-shaped LM at full width in bf16 under AdamW with
    phase 18's schedule and clipping, over ``int8``, ``topk8`` and
    ``none``, 20 steps each: exact launches per step, the client's and
    the server's K5/K6 apart, the cut's bytes per hop; a bf16 CPU twin on
    the first rows."""
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.ops.cross_entropy import BWD, FWD
    from split_learning_tpu_torch.ops.flash_attention import (
        BWD_NAMES, NAME as FA)
    from split_learning_tpu_torch.utils import Config
    plan = get_plan(dtype="bfloat16", **U_LM)
    cfg = Config(mode="u_split", transport="local", model="transformer_lm",
                 attn="flash", batch_size=TRAIN_B, dtype="bfloat16",
                 **LM_SCHEDULE, **LM_OPTIMS["adamw"])
    init = plan.init(torch.Generator().manual_seed(0), torch.zeros(1))
    cd, sd = U_LM["client_depth"], U_LM["server_depth"]
    server_step = {FA: 2 * sd, **{n: sd for n in BWD_NAMES}}
    client_step = {FA: cd, **{n: cd for n in BWD_NAMES}, FWD: 1, BWD: 1}
    base = {k: client_step.get(k, 0) + server_step.get(k, 0)
            for k in {**client_step, **server_step}}
    runs, totals = {}, {}
    for mode in U_LM_MODES:
        client, transport, server = u_stack(torch, mode, "cuda", plan, cfg,
                                            init)
        srv = party_counts(server)
        want = {**base, **wire_launches(mode, 4)}
        runs[mode] = u_run(torch, client, transport, tr_data, U_LM_STEPS,
                           f"U LM bf16 {mode}", want)
        n = U_LM_STEPS + PROFILE_STEPS
        check(srv == {k: v * n for k, v in server_step.items()},
              f"U LM {mode}: server launches {srv}")
        runs[mode].update(
            server_launches_per_step=server_step,
            client_launches_per_step=client_step,
            tokens_per_s=(TRAIN_B * TRAIN_T / runs[mode]["step_ms_median"]
                          * 1e3))
        for k, v in runs[mode]["launches"].items():
            totals[k] = totals.get(k, 0) + v
        del client, transport, server
    rows = [(x[:TWIN_ROWS], y[:TWIN_ROWS])
            for x, y in tr_data[:TWIN_STEPS]]
    cfg_twin = cfg.replace(batch_size=TWIN_ROWS)
    twin_l = {}
    for dev in ("cuda", "cpu"):
        c = u_stack(torch, "none", dev, plan, cfg_twin, init)[0]
        twin_l[dev] = [c.train_step(x, y, i) for i, (x, y) in enumerate(rows)]
    diffs = [abs(a - b) for a, b in zip(twin_l["cuda"], twin_l["cpu"])]
    check(all(d <= bf16_loss_tol(v) for d, v in zip(diffs, twin_l["cpu"])),
          f"U LM bf16 CPU twin: {twin_l}")
    print(f"[U LM] median step ms " + ", ".join(
        f"{m} {r['step_ms_median']:.2f}" for m, r in runs.items())
        + f"; bf16 CPU twin on {TWIN_ROWS} rows x {TWIN_STEPS} steps within "
        f"{max(diffs):.3g}", flush=True)
    return dict(runs=runs, cpu_twin=dict(
        rows=TWIN_ROWS, steps=TWIN_STEPS, card=twin_l["cuda"],
        cpu=twin_l["cpu"], max_abs_diff=max(diffs))), totals


def federated_http_runs(torch):
    """Phase 22: a federated ``SplitHTTPServer`` thread (``num_clients``
    2) and two ``FederatedClientTrainer``s on ``HttpTransport`` in two
    threads, the CNN at batch 64, 2 epochs of 20 steps on disjoint
    halves: after each epoch both clients' parameters bit-identical and
    within 1e-6 of the mean of their pre-sync parameters (computed on
    the card); the K1 pair and one K2 launch per client step; the
    aggregate round trip and its bytes each way."""
    import threading

    from split_learning_tpu_torch.data import batches, synthetic
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.ops.common import LAUNCHES
    from split_learning_tpu_torch.ops.cross_entropy import BWD, FWD
    from split_learning_tpu_torch.ops.sgd import NAME as SGD
    from split_learning_tpu_torch.runtime import (
        FederatedClientTrainer, ServerRuntime, leaves_of)
    from split_learning_tpu_torch.transport import (
        HttpTransport, SplitHTTPServer)
    from split_learning_tpu_torch.utils import Config
    ds = synthetic("mnist", n_train=BATCH * FED_STEPS * 2, n_test=8, seed=1)
    data = list(batches(ds.train, BATCH, seed=1, drop_remainder=True))
    shards = [data[:FED_STEPS], data[FED_STEPS:]]
    plan = get_plan(mode="federated")
    cfg = Config(mode="federated", transport="http", batch_size=BATCH,
                 lr=LR, num_clients=2, epochs=FED_EPOCHS)
    server = ServerRuntime(plan, cfg, torch.Generator().manual_seed(0),
                           device="cuda")
    srv = SplitHTTPServer(server).start()
    transports = [HttpTransport(srv.url, timeout=HTTP_TIMEOUT)
                  for _ in range(2)]
    clients = [FederatedClientTrainer(plan, cfg,
                                      torch.Generator().manual_seed(0), t,
                                      device="cuda") for t in transports]
    pre, post, rtt = ({i: [] for i in range(2)} for _ in range(3))
    for i, c in enumerate(clients):
        sync = c.sync

        def spy(*a, _i=i, _c=c, _sync=sync, **kw):
            pre[_i].append([t.detach().clone() for t in leaves_of(_c.params)])
            t0 = time.perf_counter()
            _sync(*a, **kw)
            rtt[_i].append((time.perf_counter() - t0) * 1e3)
            post[_i].append([t.detach().clone()
                             for t in leaves_of(_c.params)])

        c.sync = spy
    errors, records = [], {}

    def run(i):
        try:
            records[i] = clients[i].train(lambda: iter(shards[i]),
                                          epochs=FED_EPOCHS)
        except Exception as exc:  # surfaced below
            errors.append((i, repr(exc)))

    LAUNCHES.reset()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(2)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        counts = LAUNCHES.snapshot()
        check(not errors and not any(t.is_alive() for t in threads),
              f"federated clients failed or hung: {errors}")
        stats = [t.stats.summary() for t in transports]
    finally:
        for t in transports:
            t.close()
        srv.stop()
    n = 2 * FED_EPOCHS * FED_STEPS
    want = {FWD: n, BWD: n, SGD: n}
    print(f"[federated] 2 clients x {FED_EPOCHS} epochs x {FED_STEPS} "
          f"steps over HTTP, launches {counts}", flush=True)
    check(counts == want, f"federated launches {counts}, want {want}")
    max_err = 0.0
    for e in range(FED_EPOCHS):
        for a, b, p0, p1 in zip(post[0][e], post[1][e], pre[0][e],
                                pre[1][e]):
            check(torch.equal(a, b), f"epoch {e}: clients differ")
            max_err = max(max_err, (a - (p0 + p1) / 2).abs().max().item())
    check(max_err <= 1e-6, f"FedAvg mean off by {max_err}")
    losses = {i: [r.loss for r in records[i]] for i in range(2)}
    for i in range(2):
        check(all(math.isfinite(v) for v in losses[i]), "federated: finite")
        check(losses[i][-1] < losses[i][0],
              f"federated client {i}: epoch losses {losses[i]}")
    check(server.health()["step"] == FED_EPOCHS * FED_STEPS,
          f"federated server step {server.health()['step']}")
    print(f"[federated] clients bit-identical after each sync, mean within "
          f"{max_err:.3g}; aggregate round trip ms {rtt}; epoch losses "
          f"{losses}", flush=True)
    return dict(model="split_cnn", batch=BATCH, clients=2,
                epochs=FED_EPOCHS, steps_per_epoch=FED_STEPS,
                launches=counts,
                launches_per_client_step={FWD: 1, BWD: 1, SGD: 1},
                mean_max_abs_err=max_err, aggregate_rtt_ms=rtt,
                aggregate_bytes_up=[s["bytes_sent"] / FED_EPOCHS
                                    for s in stats],
                aggregate_bytes_down=[s["bytes_received"] / FED_EPOCHS
                                      for s in stats],
                params=sum(t.numel() for t in leaves_of(clients[0].params)),
                epoch_losses=losses, wall_ms=wall_ms), counts


def multi_client_runs(torch):
    """Phase 23: ``MultiClientSplitRunner`` with 4 clients and one
    ``ServerRuntime`` on the card over ``topk8``, a ``topk8`` bottom sync
    every 2 rounds, 10 rounds, round-robin and then concurrent: exact
    launches per round and per sync, the bottoms equal after each sync,
    the sync byte counters and round ms."""
    from split_learning_tpu_torch.data import batches, synthetic
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.ops import topk as kmod
    from split_learning_tpu_torch.ops.common import LAUNCHES
    from split_learning_tpu_torch.ops.cross_entropy import BWD, FWD
    from split_learning_tpu_torch.ops.sgd import NAME as SGD
    from split_learning_tpu_torch.runtime import (
        MultiClientSplitRunner, ServerRuntime, leaves_of)
    from split_learning_tpu_torch.transport import LocalTransport
    from split_learning_tpu_torch.utils import Config
    n = MC_CLIENTS
    ds = synthetic("mnist", n_train=BATCH * n * MC_ROUNDS, n_test=8, seed=2)
    data = list(batches(ds.train, BATCH, seed=2, drop_remainder=True))
    per_client = [data[i::n] for i in range(n)]
    sizes_a = tuple(p.numel() for p in
                    get_plan().stages[0].module.state_dict().values())
    check(sizes_a == A_LEAVES, f"stage A's leaves {sizes_a}: phase 12 "
                               f"checks {A_LEAVES}")
    leaves_a = len(sizes_a)
    per_round = {FWD: n, BWD: n, SGD: 2 * n,
                 **{k: 2 * n for k in kmod.SELECT_LAUNCHES}}
    per_sync = {k: leaves_a * n for k in kmod.SELECT_LAUNCHES}
    runs, totals = {}, {}
    for concurrent in (False, True):
        cfg = Config(transport="local", batch_size=BATCH, lr=LR,
                     num_clients=n)
        server = ServerRuntime(get_plan(), cfg,
                               torch.Generator().manual_seed(0),
                               device="cuda")
        runner = MultiClientSplitRunner(
            get_plan(), cfg, torch.Generator().manual_seed(0),
            lambda i: LocalTransport(server, compress="topk8",
                                     density=DENSITY),
            sync_bottoms_every=MC_SYNC_EVERY, sync_compress="topk8",
            sync_density=DENSITY, concurrent=concurrent, device="cuda")
        syncs = []
        sync = runner.sync_bottoms

        def spy(_sync=sync, _runner=runner):
            before = LAUNCHES.snapshot()
            raw0, wire0 = _runner.sync_raw_bytes, _runner.sync_wire_bytes
            _sync()
            torch.cuda.synchronize()
            after = LAUNCHES.snapshot()
            ls = [leaves_of(c.state.params) for c in _runner.clients]
            equal = all(torch.equal(a, b) for other in ls[1:]
                        for a, b in zip(ls[0], other))
            syncs.append(dict(
                select_launches={k: after.get(k, 0) - before.get(k, 0)
                                 for k in kmod.SELECT_LAUNCHES},
                raw_bytes=_runner.sync_raw_bytes - raw0,
                wire_bytes=_runner.sync_wire_bytes - wire0, equal=equal))

        runner.sync_bottoms = spy
        LAUNCHES.reset()
        round_ms, losses = [], []
        try:
            for r in range(MC_ROUNDS):
                t = time.perf_counter()
                losses.append(runner.train_round(
                    [per_client[i][r] for i in range(n)]))
                torch.cuda.synchronize()
                round_ms.append((time.perf_counter() - t) * 1e3)
        finally:
            runner.close()
        counts = LAUNCHES.snapshot()
        n_sync = MC_ROUNDS // MC_SYNC_EVERY
        want = {k: MC_ROUNDS * v + (n_sync - 1) * per_sync.get(k, 0)
                for k, v in per_round.items()}
        label = "concurrent" if concurrent else "round-robin"
        print(f"[multi-client] {label}: {MC_ROUNDS} rounds, launches "
              f"{counts}, syncs {[s['select_launches'] for s in syncs]}",
              flush=True)
        check(counts == want, f"multi-client {label} launches {counts}, "
                              f"want {want}")
        check(len(syncs) == n_sync and all(s["equal"] for s in syncs),
              f"multi-client {label}: bottoms differ after a sync")
        check(syncs[0]["select_launches"] == {k: 0 for k in per_sync}
              and all(s["select_launches"] == per_sync for s in syncs[1:]),
              f"multi-client {label}: sync launches {syncs}")
        check(runner.sync_raw_bytes > runner.sync_wire_bytes > 0,
              f"multi-client {label}: sync bytes")
        check(all(math.isfinite(v) for r in losses for v in r),
              f"multi-client {label}: finite losses")
        check(server._last_step == {i: MC_ROUNDS - 1 for i in range(n)},
              f"multi-client {label}: handshakes {server._last_step}")
        runs[label] = dict(
            round_ms_median=statistics.median(round_ms[1:]),
            round_ms_min=min(round_ms[1:]), round_ms_first=round_ms[0],
            launches=counts, launches_per_round=per_round,
            select_launches_per_compressed_sync=per_sync, syncs=syncs,
            sync_raw_bytes=runner.sync_raw_bytes,
            sync_wire_bytes=runner.sync_wire_bytes,
            sync_ratio=runner.sync_raw_bytes / runner.sync_wire_bytes,
            loss_first=statistics.mean(losses[0]),
            loss_last=statistics.mean(losses[-1]))
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
    print(f"[multi-client] round ms round-robin "
          f"{runs['round-robin']['round_ms_median']:.2f}, concurrent "
          f"{runs['concurrent']['round_ms_median']:.2f}; sync raw/wire "
          f"bytes {runs['round-robin']['sync_raw_bytes']}/"
          f"{runs['round-robin']['sync_wire_bytes']}", flush=True)
    return dict(clients=n, rounds=MC_ROUNDS, sync_every=MC_SYNC_EVERY,
                wire="topk8", density=DENSITY, runs=runs), totals


def u_fed_cli(torch, launch_run) -> dict:
    """The CLI of phases 20-23: ``serve --mode u_split`` with the bf16
    AdamW LM as a subprocess and ``train --mode u_split --transport
    http`` with the same flags for 5 int8 steps against it (the client's
    launches exact: its block's K5 and K6, the head's K1 pair, two int8
    encodes and decodes a step); then ``train --mode federated
    --transport local`` on the CNN (the K1 pair and one K2 a step; FedAvg
    launches none). Both rc 0 with a falling loss."""
    import contextlib
    import io
    import queue
    import signal
    import subprocess
    import threading

    from split_learning_tpu_torch.ops import quantize as qmod
    from split_learning_tpu_torch.ops.common import LAUNCHES
    from split_learning_tpu_torch.ops.cross_entropy import BWD, FWD
    from split_learning_tpu_torch.ops.flash_attention import (
        BWD_NAMES, NAME as FA)
    from split_learning_tpu_torch.ops.sgd import NAME as SGD
    data_dir = os.path.join(REPO, "build", "chip_smoke_data")
    flags = ["--mode", "u_split", "--device", "cuda", "--model",
             "transformer_lm", "--dataset", "lm", "--seq-len", str(TRAIN_T),
             "--d-model", str(LM["d_model"]), "--num-heads",
             str(LM["num_heads"]), "--client-depth", str(LM["client_depth"]),
             "--server-depth", str(LM["server_depth"]), "--attn", "flash",
             "--batch-size", str(TRAIN_B), "--dtype", "bfloat16",
             "--optimizer", "adamw", "--lr", str(LM_CLI_LR),
             "--weight-decay", "0.1", "--warmup-steps", "2",
             "--decay-steps", "10", "--grad-clip-norm", "1.0",
             "--data-dir", data_dir]
    err_path = os.path.join(REPO, "build", "chip_smoke_serve_u.err")
    os.makedirs(os.path.dirname(err_path), exist_ok=True)

    def run_cli(args):
        out = io.StringIO()
        LAUNCHES.reset()
        with contextlib.redirect_stdout(out):
            rc = launch_run.main(args)
        counts = LAUNCHES.snapshot()
        text = out.getvalue()
        print(text, end="", flush=True)
        first = float(next(ln for ln in text.splitlines()
                           if ln.startswith("[step 0] loss:")).split(":")[1])
        final = float(text.split("final_loss=")[1].split()[0])
        return rc, counts, first, final

    with open(err_path, "w") as err_f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "split_learning_tpu_torch.launch.run",
             "serve", "--port", "0", "--host", "127.0.0.1", *flags],
            cwd=REPO, stdout=subprocess.PIPE, stderr=err_f, text=True)
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                     daemon=True).start()
    try:
        try:
            first = lines.get(timeout=CLI_START_TIMEOUT)
        except queue.Empty:
            first = ""
        check(first.startswith("[serve] mode=u_split role=server listening "
                               "on "),
              f"serve printed {first!r}; stderr: "
              f"{open(err_path).read()[-2000:]}")
        url = first.split("listening on ")[1].strip()
        rc, counts, l0, l1 = run_cli([
            "train", "--transport", "http", "--server-url", url,
            "--compress", "int8", "--steps", "5", "--tracking", "stdout",
            "--wait-server", "60", *flags])
        check(rc == 0, f"U LM train --transport http returned {rc}")
        check(l1 < l0, f"U LM CLI over HTTP: loss {l0} -> {l1}")
        cd = LM["client_depth"]
        want = {FA: 5 * cd, **{n: 5 * cd for n in BWD_NAMES}, FWD: 5,
                BWD: 5, qmod.QUANT: 10, qmod.DEQUANT: 10}
        check(counts == want, f"U LM CLI client launches {counts}, "
                              f"want {want}")
        proc.send_signal(signal.SIGINT)
        serve_rc = proc.wait(timeout=60)
        check(serve_rc == 0, f"U serve exited {serve_rc}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    u_rec = dict(serve_rc=serve_rc, train_rc=rc, loss_first=l0,
                 loss_final=l1, client_launches=counts)
    rc, counts, l0, l1 = run_cli([
        "train", "--mode", "federated", "--transport", "local", "--steps",
        "8", "--lr", str(CLI_LR), "--dataset", "synthetic", "--tracking",
        "stdout", "--data-dir", data_dir])
    check(rc == 0, f"federated train --transport local returned {rc}")
    check(l1 < l0, f"federated CLI: loss {l0} -> {l1}")
    check(counts == {FWD: 8, BWD: 8, SGD: 8},
          f"federated CLI launches {counts}")
    return dict(u_split_http=u_rec, federated_local=dict(
        train_rc=rc, loss_first=l0, loss_final=l1, launches=counts))


# --------------------------------------------------------------------- #
# phase 24: checkpoints and what loads them

def _ckpt_dir(name):
    path = os.path.join(REPO, "build", "chip_smoke_ckpt", name)
    import shutil
    shutil.rmtree(path, ignore_errors=True)
    return path


def _ckpt_data():
    return os.path.join(REPO, "build", "chip_smoke_ckpt_data")


def _take_losses(data_dir):
    """The jsonl metrics' losses of the run just made, and the log
    cleared for the next one."""
    folder = os.path.join(data_dir, "metrics")
    losses = []
    for name in sorted(os.listdir(folder)):
        path = os.path.join(folder, name)
        with open(path) as f:
            losses += [r["value"] for r in map(json.loads, f)
                       if r.get("key") == "loss"]
        os.remove(path)
    return losses


def _cli(torch, launch_run, argv):
    """``launch.run.main(argv)`` in this process with launch counts reset
    just before and read just after: ``(rc, counts, stdout, seconds)``."""
    import contextlib
    import io
    from split_learning_tpu_torch.ops.common import LAUNCHES
    out = io.StringIO()
    LAUNCHES.reset()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = launch_run.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    return rc, LAUNCHES.snapshot(), out.getvalue(), secs


class _Serve:
    """``launch.run serve`` as a subprocess on the card: its URL, and
    SIGINT with the exit code. stderr goes to ``build/``."""

    def __init__(self, name, *flags):
        import queue
        import subprocess
        import threading
        self.err_path = os.path.join(REPO, "build", f"chip_smoke_{name}.err")
        os.makedirs(os.path.dirname(self.err_path), exist_ok=True)
        with open(self.err_path, "w") as err_f:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "split_learning_tpu_torch.launch.run",
                 "serve", "--device", "cuda", "--host", "127.0.0.1",
                 "--port", "0", *flags],
                cwd=REPO, stdout=subprocess.PIPE, stderr=err_f, text=True)
        lines = queue.Queue()
        threading.Thread(target=lambda: [lines.put(ln)
                                         for ln in self.proc.stdout],
                         daemon=True).start()
        try:
            first = lines.get(timeout=CLI_START_TIMEOUT)
        except queue.Empty:
            first = ""
        if "listening on " not in first:
            self.kill()
            check(False, f"serve {name} printed {first!r}; stderr: "
                         f"{open(self.err_path).read()[-2000:]}")
        self.url = first.split("listening on ")[1].strip()

    def stop(self) -> int:
        import signal
        self.proc.send_signal(signal.SIGINT)
        rc = self.proc.wait(timeout=120)
        check(rc == 0, f"serve exited {rc}: "
                       f"{open(self.err_path).read()[-2000:]}")
        return rc

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)


def _lm_flags(data_dir):
    """Phase 18's bf16 AdamW LM at full width, as the CLI takes it."""
    adamw = LM_OPTIMS["adamw"]
    return ["--device", "cuda", "--model", "transformer_lm", "--dataset",
            "lm", "--seq-len", str(TRAIN_T), "--d-model", str(LM["d_model"]),
            "--num-heads", str(LM["num_heads"]), "--client-depth",
            str(LM["client_depth"]), "--server-depth", str(LM["server_depth"]),
            "--attn", "flash", "--dtype", "bfloat16", "--batch-size",
            str(TRAIN_B), "--optimizer", "adamw", "--lr", str(adamw["lr"]),
            "--weight-decay", str(adamw["weight_decay"]), "--warmup-steps",
            str(LM_SCHEDULE["warmup_steps"]), "--decay-steps",
            str(LM_SCHEDULE["decay_steps"]), "--grad-clip-norm",
            str(LM_SCHEDULE["grad_clip_norm"]), "--data-dir", data_dir]


def _record_checkpointer():
    """Every save's snapshot ms (what the loop was blocked), every
    write's ms and bytes, and every restore's ms, from the
    ``Checkpointer`` of any run in this process."""
    from split_learning_tpu_torch.runtime import checkpoint as ckmod
    rec = {"snapshot_ms": [], "write_ms": [], "bytes": [], "restore_ms": []}
    cls = ckmod.Checkpointer
    save, write, raw = cls.save, cls._write, cls.restore_raw

    def saving(self, *a, **kw):
        save(self, *a, **kw)
        rec["snapshot_ms"].append(self.stats["snapshot_ms"])

    def writing(self, job):
        write(self, job)
        rec["write_ms"].append(self.stats["write_ms"])
        rec["bytes"].append(self.stats["bytes"])

    def restoring(self, *a, **kw):
        out = raw(self, *a, **kw)
        rec["restore_ms"].append(self.stats["restore_ms"])
        return out

    cls.save, cls._write, cls.restore_raw = saving, writing, restoring
    return rec, lambda: setattr(cls, "save", save) or setattr(
        cls, "_write", write) or setattr(cls, "restore_raw", raw)


def fused_resume_run(torch, launch_run):
    """Phase 24, the fused LM: ``train --checkpoint-dir --checkpoint-every
    CKPT_K`` uninterrupted for 2 * CKPT_K steps, against CKPT_K steps, a
    stop, and ``--resume`` for CKPT_K more. Returns the record and the
    uninterrupted run's live trainer and checkpoint for eval/generate."""
    import split_learning_tpu_torch.runtime as rt
    from split_learning_tpu_torch.ops.cross_entropy import BWD, FWD
    from split_learning_tpu_torch.ops.flash_attention import (
        BWD_NAMES, NAME as FA)
    data = _ckpt_data()
    flags = _lm_flags(data) + ["--tracking", "jsonl"]
    live = []
    fused_cls = rt.FusedSplitTrainer

    class Recording(fused_cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            live.append(self)

    rec, restore_cls = _record_checkpointer()
    rt.FusedSplitTrainer = Recording
    try:
        whole_dir, cut_dir = _ckpt_dir("lm_whole"), _ckpt_dir("lm_cut")
        rc, whole_counts, _, whole_s = _cli(torch, launch_run, [
            "train", *flags, "--steps", str(2 * CKPT_K), "--checkpoint-dir",
            whole_dir, "--checkpoint-every", str(CKPT_K)])
        check(rc == 0, f"LM train (uninterrupted) returned {rc}")
        whole = _take_losses(data)
        n_saves = len(rec["snapshot_ms"])
        rc, head_counts, _, _ = _cli(torch, launch_run, [
            "train", *flags, "--steps", str(CKPT_K), "--checkpoint-dir",
            cut_dir, "--checkpoint-every", str(CKPT_K)])
        check(rc == 0, f"LM train (first leg) returned {rc}")
        head = _take_losses(data)
        rc, tail_counts, _, _ = _cli(torch, launch_run, [
            "train", *flags, "--steps", str(CKPT_K), "--checkpoint-dir",
            cut_dir, "--resume"])
        check(rc == 0, f"LM train --resume returned {rc}")
        tail = _take_losses(data)
    finally:
        rt.FusedSplitTrainer = fused_cls
        restore_cls()
    per_step = {FA: N_BLOCKS, **{n: N_BLOCKS for n in BWD_NAMES}, FWD: 1,
                BWD: 1}
    check(whole_counts == {k: 2 * CKPT_K * v for k, v in per_step.items()},
          f"uninterrupted launches {whole_counts}")
    check(tail_counts == {k: CKPT_K * v for k, v in per_step.items()},
          f"resumed launches {tail_counts}, want {per_step} a step")
    check(len(whole) == 2 * CKPT_K and len(head) == len(tail) == CKPT_K,
          f"loss counts {len(whole)}, {len(head)}, {len(tail)}")
    head_err = max(abs(a - b) for a, b in zip(head, whole))
    tail_err = max(abs(a - b) for a, b in zip(tail, whole[CKPT_K:]))
    tol = [bf16_loss_tol(v) for v in whole[CKPT_K:]]
    check(all(abs(a - b) <= t for a, b, t in zip(tail, whole[CKPT_K:], tol)),
          f"resumed losses {tail} against {whole[CKPT_K:]} (2 bf16 ulps)")
    check(whole[-1] < whole[0], f"LM loss {whole[0]} -> {whole[-1]}")
    out = dict(
        steps=2 * CKPT_K, resume_at=CKPT_K, losses=whole,
        resumed_losses=tail, first_leg_max_abs_err=head_err,
        resumed_max_abs_err=tail_err, bit_equal=tail == whole[CKPT_K:],
        launches_per_step=per_step, seconds_uninterrupted=whole_s,
        save_blocking_ms=rec["snapshot_ms"][:n_saves],
        save_blocking_ms_median=statistics.median(
            rec["snapshot_ms"][:n_saves]),
        write_ms=rec["write_ms"], checkpoint_bytes=rec["bytes"][0],
        restore_ms=rec["restore_ms"][-1])
    print(f"[ckpt] fused LM: {2 * CKPT_K} steps against {CKPT_K} + resume "
          f"{CKPT_K}: resumed losses bit-equal {out['bit_equal']} (max abs "
          f"err {tail_err:.3g}; first leg {head_err:.3g}); launches a "
          f"resumed step {per_step}; save blocked the loop "
          f"{out['save_blocking_ms_median']:.3f} ms (median of "
          f"{n_saves}), write {statistics.median(rec['write_ms']):.1f} ms, "
          f"{out['checkpoint_bytes'] / 1e6:.2f} MB a step, restore "
          f"{out['restore_ms']:.1f} ms", flush=True)
    return out, live[0], whole_dir


def eval_generate_runs(torch, launch_run, trainer, ckdir):
    """Phase 24, ``eval`` and ``generate`` on the fused LM's checkpoint
    against ``evaluate`` and ``greedy_generate`` on the live trainer's
    parameters; then ``generate --server-url`` against ``serve --resume``
    of the same checkpoint on ``int8``."""
    from split_learning_tpu_torch.data import load_dataset
    from split_learning_tpu_torch.ops import quantize as qmod
    from split_learning_tpu_torch.ops.common import LAUNCHES
    from split_learning_tpu_torch.ops.flash_attention import NAME as FA
    from split_learning_tpu_torch.runtime import evaluate, greedy_generate
    data = _ckpt_data()
    flags = _lm_flags(data)
    ds = load_dataset("lm", data, seq_len=TRAIN_T)
    # eval: the unrounded result of the command's own code path
    args = launch_run.parse_args(["eval", *flags, "--checkpoint-dir", ckdir])
    LAUNCHES.reset()
    t = time.perf_counter()
    record, res = launch_run.eval_checkpoint(args)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t
    eval_counts = LAUNCHES.snapshot()
    live = evaluate(trainer.plan, trainer.params, ds.test,
                    batch_size=TRAIN_B)
    n_batches = -(-len(ds.test) // TRAIN_B)
    check(eval_counts.get(FA) == N_BLOCKS * n_batches,
          f"eval launches {eval_counts}")
    for key in ("loss", "perplexity"):
        check(abs(res[key] - live[key]) <= CKPT_EVAL_RTOL * abs(live[key]),
              f"eval {key} {res[key]} against evaluate() {live[key]}")
    check(record["checkpoint_step"] == 2 * CKPT_K, f"eval record {record}")
    # generate, KV cache and re-forward, against the live parameters
    prompt = np.asarray(ds.test.x[:1, :CKPT_PROMPT], np.int32)
    gen = {}
    for scheme, extra in (("kv_cache", []), ("reforward", ["--no-kv-cache"])):
        args = launch_run.parse_args([
            "generate", *flags, "--checkpoint-dir", ckdir, "--n-new",
            str(CKPT_GEN_NEW), "--prompt-len", str(CKPT_PROMPT), *extra])
        LAUNCHES.reset()
        t = time.perf_counter()
        rec, toks = launch_run.generate_checkpoint(args)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        counts = LAUNCHES.snapshot()
        want = greedy_generate(trainer.plan, trainer.params, prompt,
                               CKPT_GEN_NEW, kv_cache=not extra,
                               device="cuda").cpu().numpy()
        # the decode alone, warm (the command's time above includes the
        # checkpoint's restore and the prompt's dataset load)
        decode_s = host_ms(torch, lambda: greedy_generate(
            trainer.plan, trainer.params, prompt, CKPT_GEN_NEW,
            kv_cache=not extra, device="cuda")) / 1e3
        # KV: one prefill through the blocks, then single-position steps
        # that attend to the cache without the kernel; re-forward: every
        # token re-runs the blocks
        want_fa = N_BLOCKS * (CKPT_GEN_NEW if extra else 1)
        check(np.array_equal(toks, want), f"generate {scheme}: tokens "
                                          "differ from greedy_generate's")
        check(counts.get(FA) == want_fa, f"generate {scheme} launches "
                                         f"{counts}, want {FA} {want_fa}")
        gen[scheme] = dict(tokens_per_s=CKPT_GEN_NEW / secs, seconds=secs,
                           decode_tokens_per_s=CKPT_GEN_NEW / decode_s,
                           launches=counts, k5_per_token=counts.get(FA, 0)
                           / CKPT_GEN_NEW, tokens_equal_live=True)
    srv = _Serve("serve_ckpt_lm", *flags[2:], "--checkpoint-dir", ckdir,
                 "--resume")
    try:
        remote = {}
        for mode in ("none", "int8"):
            argv = ["generate", *flags, "--checkpoint-dir", ckdir,
                    "--n-new", str(CKPT_REMOTE_NEW), "--prompt-len",
                    str(CKPT_PROMPT), "--server-url", srv.url,
                    "--compress", mode]
            LAUNCHES.reset()
            t = time.perf_counter()
            rec, toks = launch_run.generate_checkpoint(
                launch_run.parse_args(argv))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            counts = LAUNCHES.snapshot()
            remote[mode] = dict(tokens_per_s=CKPT_REMOTE_NEW / secs,
                                launches=counts, tokens=rec["tokens"])
        srv.stop()
    finally:
        srv.kill()
    want_none = greedy_generate(trainer.plan, trainer.params, prompt,
                                CKPT_REMOTE_NEW, kv_cache=False,
                                device="cuda").cpu().numpy()
    check(remote["none"]["tokens"] == want_none[:, CKPT_PROMPT:].tolist(),
          "generate --server-url: tokens differ from the live re-forward's")
    # the client's share of phase 17's per-token wire launches: its
    # encode of the cut and its decode of the reply (the server's two
    # run in its process), and its one block's K5
    n = CKPT_REMOTE_NEW
    want = {FA: LM["client_depth"] * n, qmod.QUANT: n, qmod.DEQUANT: n}
    check(remote["int8"]["launches"] == want,
          f"generate --server-url int8 client launches "
          f"{remote['int8']['launches']}, want {want}")
    check(remote["none"]["launches"] == {FA: LM["client_depth"] * n},
          f"generate --server-url none launches {remote['none']['launches']}")
    print(f"[ckpt] eval: loss {res['loss']:.6f} (evaluate() "
          f"{live['loss']:.6f}), {res['examples'] / eval_s:.1f} examples/s, "
          f"K5 {eval_counts.get(FA)}; generate {CKPT_GEN_NEW} tokens (the "
          f"command; the warm decode alone): KV "
          f"{gen['kv_cache']['tokens_per_s']:.1f}; "
          f"{gen['kv_cache']['decode_tokens_per_s']:.1f} tokens/s (K5 "
          f"{gen['kv_cache']['launches'].get(FA)}), re-forward "
          f"{gen['reforward']['tokens_per_s']:.1f}; "
          f"{gen['reforward']['decode_tokens_per_s']:.1f} tokens/s (K5 "
          f"{gen['reforward']['k5_per_token']:.0f} a token); over HTTP none "
          f"{remote['none']['tokens_per_s']:.1f}, int8 "
          f"{remote['int8']['tokens_per_s']:.1f} tokens/s", flush=True)
    for r in remote.values():
        del r["tokens"]
    return dict(
        eval=dict(record=record, loss=res["loss"], live_loss=live["loss"],
                  perplexity=res["perplexity"],
                  live_perplexity=live["perplexity"],
                  examples_per_s=res["examples"] / eval_s,
                  launches=eval_counts),
        generate=gen, generate_remote=remote)


def _capture_requests():
    """Every POST the port's HttpTransport makes in this process: (path,
    request body, reply body); and the undo."""
    from split_learning_tpu_torch.transport import http as http_mod
    seen = []
    orig = http_mod.HttpTransport._request

    def request(self, method, path, body=None):
        resp, content = orig(self, method, path, body)
        if method == "POST":
            seen.append((path, body, content))
        return resp, content
    http_mod.HttpTransport._request = request
    return seen, lambda: setattr(http_mod.HttpTransport, "_request", orig)


def _post(url, path, body):
    import http.client
    import urllib.parse
    from split_learning_tpu_torch.transport import http as http_mod
    u = urllib.parse.urlparse(url)
    conn = http.client.HTTPConnection(u.hostname, u.port,
                                      timeout=HTTP_TIMEOUT)
    try:
        conn.request("POST", path, body=body, headers={
            http_mod.CRC_HEADER: str(http_mod.codec.checksum(body))})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def two_party_resume_runs(torch, launch_run):
    """Phase 24, the two-party CNN over HTTP in each wire mode: an
    uninterrupted 2 * CKPT_TP_K-step run against a ``SplitHTTPServer`` of
    this process, against ``serve --checkpoint-dir --checkpoint-every 1``
    (a subprocess) with a client that checkpoints, stops after CKPT_TP_K
    steps, ``serve --resume``, the in-flight step sent again (its original
    frame back byte for byte) and ``train --resume``. On topk8 the same
    resume with both ledgers cleared moves the series. A resumed client
    against a fresh server exits 3."""
    import shutil
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.ops.sgd import NAME as SGD
    from split_learning_tpu_torch.runtime import ServerRuntime
    from split_learning_tpu_torch.runtime import client as client_mod
    from split_learning_tpu_torch.transport import SplitHTTPServer
    from split_learning_tpu_torch.utils.config import Config
    data = _ckpt_data()
    common = ["--device", "cuda", "--dataset", "synthetic", "--batch-size",
              str(BATCH), "--lr", str(CLI_LR), "--data-dir", data]

    def client(url, mode, steps, *extra):
        rc, counts, _, _ = _cli(torch, launch_run, [
            "train", "--transport", "http", "--server-url", url,
            "--compress", mode, "--steps", str(steps), "--tracking",
            "jsonl", "--wait-server", "60", *common, *extra])
        return rc, counts, (_take_losses(data) if rc == 0 else None)

    def in_process_server():
        cfg = Config(mode="split", batch_size=BATCH, lr=CLI_LR)
        return SplitHTTPServer(ServerRuntime(
            get_plan(), cfg, torch.Generator().manual_seed(cfg.seed),
            device="cuda"), host="127.0.0.1", port=0).start()

    out = {}
    for mode in WIRE_MODES:
        srv = in_process_server()
        try:
            rc, _, whole = client(srv.url, mode, 2 * CKPT_TP_K)
        finally:
            srv.stop()
        check(rc == 0, f"two-party {mode} uninterrupted returned {rc}")
        sdir, cdir = _ckpt_dir(f"tp_{mode}_s"), _ckpt_dir(f"tp_{mode}_c")
        wire = ["--compress", mode, "--lr", str(CLI_LR)]
        seen, undo = _capture_requests()
        serve = _Serve(f"serve_ckpt_{mode}", *wire, "--checkpoint-dir", sdir,
                       "--checkpoint-every", "1")
        try:
            rc, head_counts, head = client(serve.url, mode, CKPT_TP_K,
                                           "--checkpoint-dir", cdir)
            serve.stop()
        finally:
            serve.kill()
            undo()
        check(rc == 0, f"two-party {mode} first leg returned {rc}")
        path, request, reply = seen[-1]
        if mode == "topk8":
            for name in ("s", "c"):
                src = sdir if name == "s" else cdir
                shutil.copytree(src, src + "_cleared")
        serve = _Serve(f"serve_ckpt_{mode}_resume", *wire, "--checkpoint-dir",
                       sdir, "--resume")
        try:
            status, again = _post(serve.url, path, request)
            rc, tail_counts, tail = client(serve.url, mode, CKPT_TP_K,
                                           "--checkpoint-dir", cdir,
                                           "--resume")
            serve.stop()
        finally:
            serve.kill()
        check(status == 200 and again == reply,
              f"two-party {mode}: the replayed step's frame is not the "
              f"original ({status}, {len(again)} bytes against "
              f"{len(reply)})")
        check(rc == 0, f"two-party {mode} train --resume returned {rc}")
        err = max(abs(a - b) for a, b in zip(head + tail, whole))
        check(err <= CKPT_TP_TOL[mode], f"two-party {mode}: resumed series "
              f"{head + tail} against {whole} (max abs err {err})")
        per_step = {SGD: 1, **wire_launches(mode, 1)}
        check(tail_counts == {k: CKPT_TP_K * v for k, v in per_step.items()},
              f"two-party {mode} resumed client launches {tail_counts}")
        rec = dict(losses=whole, resumed_losses=head + tail,
                   max_abs_err=err, bit_equal=head + tail == whole,
                   client_launches_per_step=per_step,
                   replayed_frame_bytes=len(again),
                   replayed_frame_equal=True)
        if mode == "topk8":
            # both ledgers cleared: the server's sidecar and the client's
            for name in os.listdir(sdir + "_cleared"):
                if name.startswith("extras-"):
                    os.remove(os.path.join(sdir + "_cleared", name))
            restore = client_mod._restore_ledger
            client_mod._restore_ledger = lambda transport, records: None
            serve = _Serve("serve_ckpt_cleared", *wire, "--checkpoint-dir",
                           sdir + "_cleared", "--resume")
            try:
                rc, _, cleared = client(serve.url, mode, CKPT_TP_K,
                                        "--checkpoint-dir",
                                        cdir + "_cleared", "--resume")
                serve.stop()
            finally:
                serve.kill()
                client_mod._restore_ledger = restore
            check(rc == 0, f"topk8 cleared resume returned {rc}")
            moved = max(abs(a - b) for a, b in zip(cleared,
                                                   whole[CKPT_TP_K:]))
            check(moved > max(err, 0.0) and moved > 0,
                  f"topk8: clearing the ledgers moved the series by {moved}, "
                  f"no more than restoring them ({err})")
            rec["cleared_ledger_max_abs_err"] = moved
        out[mode] = rec
        print(f"[ckpt] two-party {mode} over HTTP: {CKPT_TP_K} + resume "
              f"{CKPT_TP_K} steps, max abs err {err:.3g} (bit-equal "
              f"{rec['bit_equal']}), replayed frame byte-equal "
              f"({len(again)} bytes), client launches a step {per_step}"
              + (f"; ledgers cleared: {rec['cleared_ledger_max_abs_err']:.3g}"
                 if mode == "topk8" else ""), flush=True)
    # a resumed client against a fresh server exits 3
    srv = in_process_server()
    try:
        rc, _, _ = client(srv.url, "none", 1, "--checkpoint-dir",
                          os.path.join(REPO, "build", "chip_smoke_ckpt",
                                       "tp_none_c"), "--resume")
    finally:
        srv.stop()
    check(rc == 3, f"resumed client against a fresh server returned {rc}")
    out["fresh_server_rc"] = rc
    return out


def prefetch_runs(torch, launch_run):
    """Phase 24, ``train --transport local --prefetch N`` on the CNN: the
    loss series of ``--prefetch 0`` bit for bit (both under cuDNN's
    deterministic convolutions), each depth's median step ms (host clock
    around ``train_step``; two runs a depth, in turns, as users run it),
    and a profiler window of the prefetched client showing the batch's
    copy to the card on a stream of its own."""
    from torch.profiler import ProfilerActivity, profile
    from split_learning_tpu_torch.data import batches, synthetic
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.runtime import (
        ServerRuntime, SplitClientTrainer)
    from split_learning_tpu_torch.runtime import client as client_mod
    from split_learning_tpu_torch.transport import LocalTransport
    from split_learning_tpu_torch.utils.config import Config
    data = _ckpt_data()
    cls = client_mod.SplitClientTrainer
    step = cls.train_step
    times = []

    def timed(self, *a, **kw):
        t = time.perf_counter()
        loss = step(self, *a, **kw)
        times.append((time.perf_counter() - t) * 1e3)
        return loss

    def run(depth):
        times.clear()
        rc, counts, _, _ = _cli(torch, launch_run, [
            "train", "--device", "cuda", "--transport", "local",
            "--compress", "int8", "--dataset", "synthetic", "--batch-size",
            str(BATCH), "--lr", str(CLI_LR), "--steps",
            str(CKPT_PREFETCH_STEPS), "--prefetch", str(depth),
            "--tracking", "jsonl", "--data-dir", data])
        check(rc == 0, f"train --prefetch {depth} returned {rc}")
        return dict(losses=_take_losses(data),
                    step_ms_median=statistics.median(times[5:]),
                    launches=counts)

    cls.train_step = timed
    deterministic = torch.backends.cudnn.deterministic
    try:
        # the series: cuDNN's deterministic convolutions, so that two
        # runs of one command are bit-equal and any gap is the prefetch's
        torch.backends.cudnn.deterministic = True
        series = {d: run(d) for d in (0, CKPT_PREFETCH_DEPTH)}
        torch.backends.cudnn.deterministic = deterministic
        # the times: as users run it, in turns (0, N, N, 0)
        timing = {0: [], CKPT_PREFETCH_DEPTH: []}
        for d in (0, CKPT_PREFETCH_DEPTH, CKPT_PREFETCH_DEPTH, 0):
            timing[d].append(run(d)["step_ms_median"])
    finally:
        cls.train_step = step
        torch.backends.cudnn.deterministic = deterministic
    runs = {d: dict(series[d], step_ms_median=statistics.mean(timing[d]),
                    step_ms_medians=timing[d]) for d in series}
    same = runs[0]["losses"] == runs[CKPT_PREFETCH_DEPTH]["losses"]
    err = max(abs(a - b) for a, b in zip(runs[0]["losses"],
                                         runs[CKPT_PREFETCH_DEPTH]["losses"]))
    check(same, f"--prefetch {CKPT_PREFETCH_DEPTH} moved the loss series "
                f"(max abs err {err}; deterministic cuDNN)")
    check(runs[0]["launches"] == runs[CKPT_PREFETCH_DEPTH]["launches"],
          "prefetch changed the launches")
    # the profiler window: the client's train(prefetch=) on the API
    cfg = Config(mode="split", batch_size=BATCH, lr=CLI_LR)
    server = ServerRuntime(get_plan(), cfg, torch.Generator().manual_seed(0),
                           device="cuda")
    trainer = SplitClientTrainer(get_plan(), cfg,
                                 torch.Generator().manual_seed(0),
                                 LocalTransport(server), device="cuda")
    ds = synthetic("mnist", n_train=BATCH * 12, n_test=8, seed=1)
    window = list(batches(ds.train, BATCH, seed=1, drop_remainder=True))
    trainer.train(lambda: iter(window[:2]), epochs=1, prefetch=2)
    torch.cuda.synchronize()
    trace = os.path.join(REPO, "build", "chip_smoke_prefetch_trace.json")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.train(lambda: iter(window[2:]), epochs=1,
                      start_step=2, prefetch=CKPT_PREFETCH_DEPTH)
        torch.cuda.synchronize()
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    kernel_streams = {e["args"].get("stream") for e in events
                      if e.get("cat") == "kernel" and "args" in e}
    h2d = [e for e in events if e.get("cat") == "gpu_memcpy"
           and "HtoD" in e.get("name", "")]
    batch_bytes = BATCH * 28 * 28 * 4
    staged = [e for e in h2d if e["args"].get("bytes") == batch_bytes]
    copy_streams = {e["args"].get("stream") for e in staged}
    # the trace may drop some activity records; every batch copy it kept
    # must have run on a stream that ran no kernel
    own = copy_streams - kernel_streams
    check(staged and own == copy_streams,
          f"prefetch window: {len(staged)} batch copies on streams "
          f"{sorted(copy_streams)}, kernels on {sorted(kernel_streams)}")
    out = dict(
        steps=CKPT_PREFETCH_STEPS, depth=CKPT_PREFETCH_DEPTH,
        losses_equal=same, max_abs_err=err,
        step_ms_median={str(d): r["step_ms_median"] for d, r in runs.items()},
        step_ms_medians={str(d): r["step_ms_medians"]
                         for d, r in runs.items()},
        profile=dict(batch_copies=len(staged),
                     batches_in_window=len(window) - 2,
                     copy_streams=sorted(own),
                     kernel_streams=sorted(kernel_streams),
                     copy_us=[e.get("dur") for e in staged][:4],
                     trace=os.path.relpath(trace, REPO)))
    print(f"[ckpt] prefetch: --prefetch 0 and {CKPT_PREFETCH_DEPTH} losses "
          f"equal {same} (deterministic cuDNN); median step ms (mean of two "
          f"runs in turns) "
          f"{runs[0]['step_ms_median']:.3f} against "
          f"{runs[CKPT_PREFETCH_DEPTH]['step_ms_median']:.3f}; the "
          f"window's {len(staged)} batch copies (of {len(window) - 2} "
          f"batches) on stream(s) {sorted(own)}, kernels on "
          f"{sorted(kernel_streams)}", flush=True)
    return out


def card_test_step(filter_: str = CARD_TEST_FILTER):
    """The card tests of a phase's pieces (tests/test_torch_port_cuda.py,
    ``-k filter_``), in a subprocess without the JAX conftest."""
    import subprocess
    t = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda", "-q",
         "-p", "no:cacheprovider", "tests/test_torch_port_cuda.py", "-k",
         filter_], cwd=REPO, capture_output=True, text=True,
        timeout=CARD_TEST_TIMEOUT)
    tail = out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ""
    print(f"[card tests] {tail} ({time.perf_counter() - t:.1f} s)",
          flush=True)
    check(out.returncode == 0 and " passed" in tail and "failed" not in tail
          and "skipped" not in tail,
          f"card tests: rc {out.returncode}: {out.stdout[-3000:]}"
          f"{out.stderr[-2000:]}")
    return tail


def _phase_totals(LAUNCHES):
    """Fold every part's counts into the phase's at each reset (each part
    resets before its own run and reads just after); returns the totals
    and a function restoring the plain reset."""
    totals = {}
    orig_reset = LAUNCHES.reset

    def reset():
        for k, v in LAUNCHES.snapshot().items():
            totals[k] = totals.get(k, 0) + v
        orig_reset()
    LAUNCHES.reset = reset

    def restore():
        reset()
        LAUNCHES.reset = orig_reset
    return totals, restore


def checkpoint_runs(torch, launch_run):
    """Phase 24 (see the module docstring). Returns the record and the
    launch totals of its runs."""
    from split_learning_tpu_torch.ops.common import LAUNCHES
    totals, restore = _phase_totals(LAUNCHES)
    try:
        fused, trainer, ckdir = fused_resume_run(torch, launch_run)
        loads = eval_generate_runs(torch, launch_run, trainer, ckdir)
        del trainer
        two_party = two_party_resume_runs(torch, launch_run)
        prefetch = prefetch_runs(torch, launch_run)
    finally:
        restore()
    cards = card_test_step()
    return dict(fused_lm=fused, **loads, two_party_http=two_party,
                prefetch=prefetch, card_tests=cards), totals


# --------------------------------------------------------------------- #
# phase 25: the server under many clients
# --------------------------------------------------------------------- #
def _many_cfg(**kw):
    from split_learning_tpu_torch.utils import Config
    return Config(mode="split", batch_size=BATCH, lr=LR,
                  num_clients=MANY_CLIENTS, **kw)


def coalesce_runs(torch, data):
    """Phase 25 (a): 4 clients of ``MultiClientSplitRunner(concurrent=
    True)`` against one server on the card, on the local wire (``none``,
    ``int8``) and over HTTP (``int8``), serialized against coalescing
    (``coalesce_max`` 4, window 2 ms or continuous): round ms, mean
    occupancy, flush reasons, exact launches (the server's K1 pair and
    K2 once per group; a client's K2 and the wire's per step); then one
    group through ``_dispatch_group`` on the card and on the CPU."""
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.ops.common import LAUNCHES
    from split_learning_tpu_torch.ops.cross_entropy import BWD, FWD
    from split_learning_tpu_torch.ops.sgd import NAME as SGD
    from split_learning_tpu_torch.runtime import (
        MultiClientSplitRunner, ServerRuntime)
    from split_learning_tpu_torch.runtime.coalesce import CoalesceRequest
    from split_learning_tpu_torch.transport import (
        HttpTransport, LocalTransport, SplitHTTPServer)
    n = MANY_CLIENTS
    per_client = [data[i::n] for i in range(n)]
    cfg = _many_cfg()
    runs = {}
    for wire, mode in MANY_LEGS:
        for name, kw in MANY_CONFIGS:
            server = ServerRuntime(get_plan(), cfg,
                                   torch.Generator().manual_seed(0),
                                   device="cuda", **kw)
            http = None
            if wire == "http":
                http = SplitHTTPServer(server, host="127.0.0.1",
                                       port=0).start()

                def factory(i, _url=http.url, _mode=mode):
                    return HttpTransport(_url, timeout=HTTP_TIMEOUT,
                                         compress=_mode, density=DENSITY)
            else:
                def factory(i, _server=server, _mode=mode):
                    return LocalTransport(_server, compress=_mode,
                                          density=DENSITY)
            runner = MultiClientSplitRunner(
                get_plan(), cfg, torch.Generator().manual_seed(0), factory,
                concurrent=True, device="cuda")
            LAUNCHES.reset()
            round_ms, losses = [], []
            try:
                for r in range(MANY_ROUNDS):
                    t = time.perf_counter()
                    losses.append(runner.train_round(
                        [per_client[i][r] for i in range(n)]))
                    torch.cuda.synchronize()
                    round_ms.append((time.perf_counter() - t) * 1e3)
            finally:
                runner.close()
                if http is not None:
                    http.stop()
                server.close()
            counts = LAUNCHES.snapshot()
            label = f"{wire} {mode} {name}"
            steps = MANY_ROUNDS * n
            c = server.health().get("coalescing", {})
            groups = c.get("groups_flushed", steps)
            want = {FWD: groups, BWD: groups, SGD: steps + groups,
                    **{k: 2 * v for k, v in
                       wire_launches(mode, steps).items()}}
            check(counts == want, f"coalescing {label}: launches {counts}, "
                                  f"want {want}")
            check(all(math.isfinite(v) for r in losses for v in r),
                  f"coalescing {label}: finite losses")
            check(server._last_step == {i: MANY_ROUNDS - 1
                                        for i in range(n)},
                  f"coalescing {label}: handshakes {server._last_step}")
            runs[label] = dict(
                wire=wire, compress=mode, batching=name,
                round_ms_median=statistics.median(round_ms[1:]),
                round_ms_min=min(round_ms[1:]), round_ms_first=round_ms[0],
                groups=groups, steps=steps,
                mean_occupancy=c.get("mean_occupancy", 1.0),
                flush_reasons={k[6:]: v for k, v in c.items()
                               if k.startswith("flush_")},
                compile_count=c.get("compile_count"),
                server_launches_per_group={
                    FWD: counts[FWD] / groups, BWD: counts[BWD] / groups,
                    SGD: (counts[SGD] - steps) / groups},
                server_launches_per_round={
                    FWD: counts[FWD] / MANY_ROUNDS,
                    BWD: counts[BWD] / MANY_ROUNDS,
                    SGD: (counts[SGD] - steps) / MANY_ROUNDS},
                launches=counts,
                loss_first=statistics.mean(losses[0]),
                loss_last=statistics.mean(losses[-1]))
            print(f"[many] {label}: round ms "
                  f"{runs[label]['round_ms_median']:.2f}, occupancy "
                  f"{runs[label]['mean_occupancy']:.2f}, flushes "
                  f"{runs[label]['flush_reasons']}, server launches a group "
                  f"{runs[label]['server_launches_per_group']}", flush=True)
    # one group of four through the dispatch on the card and on the CPU
    g = torch.Generator().manual_seed(5)
    members = [(torch.randn(*CNN_CUT, generator=g),
                torch.randint(0, 10, (BATCH,), generator=g))
               for _ in range(n)]
    out = {}
    for dev in ("cuda", "cpu"):
        server = ServerRuntime(get_plan(), cfg,
                               torch.Generator().manual_seed(0),
                               coalesce_max=n, device=dev)
        reqs = [CoalesceRequest(x.to(server.device), y.to(server.device),
                                0, i) for i, (x, y) in enumerate(members)]
        LAUNCHES.reset()
        server._dispatch_group(reqs, "full")
        replies = [r.result() for r in reqs]
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = LAUNCHES.snapshot()
            check(counts == {FWD: 1, BWD: 1, SGD: 1},
                  f"one group's launches {counts}")
        out[dev] = ([(gr.cpu(), loss) for gr, loss in replies],
                    {k: v.detach().cpu() for k, v in server.params.items()})
        server.close()
    err_g = max((a[0] - b[0]).abs().max().item()
                for a, b in zip(out["cuda"][0], out["cpu"][0]))
    err_l = max(abs(a[1] - b[1]) for a, b in zip(out["cuda"][0],
                                                    out["cpu"][0]))
    err_p = max((out["cuda"][1][k] - out["cpu"][1][k]).abs().max().item()
                for k in out["cpu"][1])
    check(max(err_g, err_l, err_p) <= GROUP_TWIN_TOL,
          f"group CPU twin: gradient {err_g}, loss {err_l}, params {err_p}")
    print(f"[many] one group of {n} on the card: launches {counts}; CPU "
          f"twin within gradient {err_g:.3g}, loss {err_l:.3g}, params "
          f"{err_p:.3g}", flush=True)
    return dict(clients=n, rounds=MANY_ROUNDS, window_ms=MANY_WINDOW_MS,
                runs=runs, group_twin=dict(
                    launches=counts, grad_max_abs_diff=err_g,
                    loss_max_abs_diff=err_l, params_max_abs_diff=err_p))


def decoupled_runs(torch, data, tr_data):
    """Phase 25 (b): the decoupled backward. The split CNN (one client,
    local wire) coupled, at lag 0 and at lag 2: the reply's ms as the
    client sees it (the transport's round trip), step ms, launches per
    step (2BP: the server's K1 pair twice and K2 once), the queue never
    deeper than the lag. The bf16 AdamW LM two-party on ``topk8``,
    coupled and at lag 1: step ms and the server's K5/K6 per step."""
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.ops.common import LAUNCHES
    from split_learning_tpu_torch.ops.cross_entropy import BWD, FWD
    from split_learning_tpu_torch.ops.flash_attention import (
        BWD_NAMES, NAME as FA)
    from split_learning_tpu_torch.ops.sgd import NAME as SGD
    from split_learning_tpu_torch.runtime import (
        ServerRuntime, SplitClientTrainer)
    from split_learning_tpu_torch.transport import LocalTransport
    from split_learning_tpu_torch.utils import Config

    def run(client, transport, server, batches, lag, label):
        LAUNCHES.reset()
        ms, losses = [], []
        for i, (x, y) in enumerate(batches):
            t = time.perf_counter()
            losses.append(client.train_step(x, y, i))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            if lag is not None:
                depth = server.health()["decoupled_bwd"][
                    "deferred_apply_depth"]
                check(depth <= lag, f"{label}: queue depth {depth} > {lag}")
        applied = server.flush_deferred()
        torch.cuda.synchronize()
        counts = LAUNCHES.snapshot()
        check(all(math.isfinite(v) for v in losses), f"{label}: finite")
        reply = sorted(transport.stats._latencies)
        return dict(step_ms_median=statistics.median(ms[3:]),
                    reply_ms_median=statistics.median(reply) * 1e3,
                    reply_ms_min=reply[0] * 1e3, launches=counts,
                    flushed_at_end=applied, loss_first=losses[0],
                    loss_last=losses[-1], losses=losses)

    steps = TWO_BP_STEPS
    cnn = {}
    for lag in (None, *TWO_BP_LAGS):
        kw = {} if lag is None else dict(decouple_bwd=True, apply_lag=lag)
        cfg = Config(transport="local", batch_size=BATCH, lr=LR)
        server = ServerRuntime(get_plan(), cfg,
                               torch.Generator().manual_seed(0),
                               device="cuda", **kw)
        transport = LocalTransport(server, compress="none")
        client = SplitClientTrainer(get_plan(), cfg,
                                    torch.Generator().manual_seed(0),
                                    transport, device="cuda")
        label = "coupled" if lag is None else f"lag {lag}"
        cnn[label] = run(client, transport, server, data[:steps], lag,
                         f"2BP CNN {label}")
        k1 = 1 if lag is None else 2
        want = {FWD: k1 * steps, BWD: k1 * steps, SGD: 2 * steps}
        check(cnn[label]["launches"] == want,
              f"2BP CNN {label}: launches {cnn[label]['launches']}, want "
              f"{want}")
        cnn[label]["launches_per_step"] = {FWD: k1, BWD: k1, SGD: 2}
        cnn[label]["server_launches_per_step"] = {FWD: k1, BWD: k1, SGD: 1}
        server.close()
        print(f"[many] 2BP CNN {label}: reply ms "
              f"{cnn[label]['reply_ms_median']:.3f}, step ms "
              f"{cnn[label]['step_ms_median']:.3f}, launches a step "
              f"{cnn[label]['launches_per_step']}", flush=True)
    # lag 0 runs the coupled step's arithmetic in two backward passes;
    # cuDNN's default algorithms need not repeat bit for bit run to run
    lag0_diff = max(abs(a - b) for a, b in zip(cnn["lag 0"]["losses"],
                                              cnn["coupled"]["losses"]))
    check(lag0_diff <= TWO_BP_LAG0_TOL,
          f"2BP lag 0 left the coupled series by {lag0_diff}")
    # the bf16 AdamW LM, two-party on topk8
    plan = get_plan(dtype="bfloat16", **LM)
    init = plan.init(torch.Generator().manual_seed(0), torch.zeros(1))
    cd, sd = LM["client_depth"], LM["server_depth"]
    lm = {}
    for lag in (None, TWO_BP_LM_LAG):
        kw = {} if lag is None else dict(decouple_bwd=True, apply_lag=lag)
        cfg = Config(transport="local", model="transformer_lm",
                     attn="flash", batch_size=TRAIN_B, dtype="bfloat16",
                     **LM_SCHEDULE, **LM_OPTIMS["adamw"])
        server = ServerRuntime(plan, cfg, init, device="cuda", **kw)
        transport = LocalTransport(server, compress="topk8",
                                   density=DENSITY)
        client = SplitClientTrainer(plan, cfg, init, transport,
                                    device="cuda")
        label = "coupled" if lag is None else f"lag {lag}"
        rec = run(client, transport, server, tr_data[:TWO_BP_LM_STEPS], lag,
                  f"2BP LM {label}")
        k = 1 if lag is None else 2
        srv = {FA: k * sd, **{b: k * sd for b in BWD_NAMES}, FWD: k, BWD: k}
        per = {FA: cd + k * sd, **{b: cd + k * sd for b in BWD_NAMES},
               FWD: k, BWD: k, **wire_launches("topk8", 2)}
        want = {name: v * TWO_BP_LM_STEPS for name, v in per.items()}
        check(rec["launches"] == want,
              f"2BP LM {label}: launches {rec['launches']}, want {want}")
        rec.update(launches_per_step=per, server_launches_per_step=srv,
                   tokens_per_s=TRAIN_B * TRAIN_T / rec["step_ms_median"]
                   * 1e3)
        del rec["losses"]
        lm[label] = rec
        server.close()
        del client, transport, server
        print(f"[many] 2BP LM bf16 topk8 {label}: step ms "
              f"{rec['step_ms_median']:.2f}, reply ms "
              f"{rec['reply_ms_median']:.2f}, server K5/K6 a step "
              f"{srv[FA]}/{srv[BWD_NAMES[0]]}", flush=True)
    for r in cnn.values():
        del r["losses"]
    return dict(cnn=dict(steps=steps, wire="none", runs=cnn,
                         lag0_against_coupled_max_abs_diff=lag0_diff),
                lm=dict(steps=TWO_BP_LM_STEPS, wire="topk8",
                        dtype="bfloat16", optimizer="adamw", runs=lm))


def pipelined_runs(torch, data, tr_data):
    """Phase 25 (c): ``PipelinedSplitClientTrainer`` on the split CNN over
    HTTP on ``int8``: depth 1 against ``SplitClientTrainer`` on fresh
    servers, bit-equal under deterministic cuDNN; then depths 1, 2 and 4
    against ``serve --allow-out-of-order`` (a subprocess): ms a step.
    The bf16 LM on ``topk8`` at depth 2 on the local wire."""
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.ops.common import LAUNCHES
    from split_learning_tpu_torch.ops.cross_entropy import BWD, FWD
    from split_learning_tpu_torch.ops.flash_attention import (
        BWD_NAMES, NAME as FA)
    from split_learning_tpu_torch.runtime import (
        PipelinedSplitClientTrainer, ServerRuntime, SplitClientTrainer)
    from split_learning_tpu_torch.transport import (
        HttpTransport, LocalTransport, SplitHTTPServer)
    from split_learning_tpu_torch.utils import Config
    cfg = Config(transport="http", batch_size=BATCH, lr=LR)
    steps = PIPE_STEPS

    def http_transport(url):
        return HttpTransport(url, timeout=HTTP_TIMEOUT, compress="int8",
                             density=DENSITY)

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        series = {}
        for kind in ("sync", "depth 1"):
            runtime = ServerRuntime(get_plan(), cfg,
                                    torch.Generator().manual_seed(0),
                                    strict_steps=False, device="cuda")
            srv = SplitHTTPServer(runtime, host="127.0.0.1", port=0).start()
            try:
                if kind == "sync":
                    c = SplitClientTrainer(get_plan(), cfg,
                                           torch.Generator().manual_seed(0),
                                           http_transport(srv.url),
                                           device="cuda")
                    series[kind] = [c.train_step(x, y, i) for i, (x, y)
                                    in enumerate(data[:PIPE_TWIN_STEPS])]
                    c.transport.close()
                else:
                    p = PipelinedSplitClientTrainer(
                        get_plan(), cfg, torch.Generator().manual_seed(0),
                        http_transport(srv.url), depth=1, device="cuda")
                    series[kind] = [r.loss for r in p.train(
                        lambda: iter(data[:PIPE_TWIN_STEPS]), epochs=1)]
                    p.close()
            finally:
                srv.stop()
        check(series["sync"] == series["depth 1"],
              f"pipelined depth 1 against SplitClientTrainer: {series}")
        serve = _Serve("pipelined", "--allow-out-of-order", "--compress",
                       "int8", "--batch-size", str(BATCH))
        runs = {}
        try:
            for depth in PIPE_DEPTHS:
                p = PipelinedSplitClientTrainer(
                    get_plan(), cfg, torch.Generator().manual_seed(0),
                    http_transport(serve.url), depth=depth,
                    transport_factory=lambda: http_transport(serve.url),
                    client_id=depth, device="cuda")
                p.train(lambda: iter(data[:PIPE_WARMUP]), epochs=1)
                torch.cuda.synchronize()
                t = time.perf_counter()
                recs = p.train(lambda: iter(data[:steps]), epochs=1,
                               start_step=PIPE_WARMUP)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t) * 1e3
                p.close()
                losses = [r.loss for r in recs]
                check(len(recs) == steps and all(math.isfinite(v)
                                                 for v in losses),
                      f"pipelined depth {depth}: {len(recs)} records")
                runs[str(depth)] = dict(ms_per_step=wall / steps,
                                        loss_first=losses[0],
                                        loss_last=losses[-1],
                                        round_trips=p.stats.round_trips)
                print(f"[many] pipelined CNN over HTTP int8, depth {depth}: "
                      f"{wall / steps:.3f} ms a step", flush=True)
        finally:
            serve.stop()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    # the bf16 LM on topk8 at depth 2, the local wire: the client's
    # forward runs twice a step (its backward recomputes it)
    plan = get_plan(dtype="bfloat16", **LM)
    init = plan.init(torch.Generator().manual_seed(0), torch.zeros(1))
    lm_cfg = Config(transport="local", model="transformer_lm", attn="flash",
                    batch_size=TRAIN_B, dtype="bfloat16", **LM_SCHEDULE,
                    **LM_OPTIMS["adamw"])
    server = ServerRuntime(plan, lm_cfg, init, strict_steps=False,
                           device="cuda")
    p = PipelinedSplitClientTrainer(
        plan, lm_cfg, init, LocalTransport(server, compress="topk8",
                                           density=DENSITY),
        depth=PIPE_LM_DEPTH, device="cuda")
    p.train(lambda: iter(tr_data[:PIPE_WARMUP]), epochs=1)
    LAUNCHES.reset()
    torch.cuda.synchronize()
    t = time.perf_counter()
    recs = p.train(lambda: iter(tr_data[:PIPE_LM_STEPS]), epochs=1,
                   start_step=PIPE_WARMUP)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    counts = LAUNCHES.snapshot()
    p.close()
    server.close()
    cd, sd = LM["client_depth"], LM["server_depth"]
    per = {FA: 2 * cd + sd, **{b: cd + sd for b in BWD_NAMES}, FWD: 1,
           BWD: 1, **wire_launches("topk8", 2)}
    want = {k: v * PIPE_LM_STEPS for k, v in per.items()}
    check(counts == want, f"pipelined LM launches {counts}, want {want}")
    losses = [r.loss for r in recs]
    check(all(math.isfinite(v) for v in losses), "pipelined LM: finite")
    lm = dict(depth=PIPE_LM_DEPTH, steps=PIPE_LM_STEPS, wire="topk8",
              ms_per_step=wall / PIPE_LM_STEPS, launches_per_step=per,
              loss_first=losses[0], loss_last=losses[-1])
    print(f"[many] pipelined bf16 LM topk8 depth {PIPE_LM_DEPTH}: "
          f"{lm['ms_per_step']:.2f} ms a step, launches a step {per}",
          flush=True)
    return dict(cnn=dict(wire="http", compress="int8", steps=steps,
                         depth1_bit_equal_to_sync=True,
                         twin_steps=PIPE_TWIN_STEPS, runs=runs), lm=lm)


def admission_runs(torch):
    """Phase 25 (d): admission over HTTP: 2 tenants, a quota on tenant 0
    only; two retrying clients (one a tenant) on ``int8``: the 429s with
    ``Retry-After`` reach tenant 0's client, every step completes, and
    the server's counters are the clients' counts."""
    from split_learning_tpu_torch.data import batches, synthetic
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.runtime import (
        ServerRuntime, SplitClientTrainer)
    from split_learning_tpu_torch.transport import (
        HttpTransport, SplitHTTPServer)
    from split_learning_tpu_torch.transport.base import Backpressure
    ds = synthetic("mnist", n_train=BATCH * ADMIT_STEPS, n_test=8, seed=3)
    data = list(batches(ds.train, BATCH, seed=3, drop_remainder=True))
    cfg = _many_cfg(transport="http")
    runtime = ServerRuntime(get_plan(), cfg, torch.Generator().manual_seed(0),
                            tenants=2, quota=list(ADMIT_QUOTA),
                            device="cuda")
    srv = SplitHTTPServer(runtime, host="127.0.0.1", port=0).start()
    refused = {0: [], 1: []}
    clients = []
    for i in range(2):
        transport = HttpTransport(srv.url, timeout=HTTP_TIMEOUT,
                                  compress="int8")
        send = transport.split_step

        def spy(*a, _send=send, _i=i, **kw):
            try:
                return _send(*a, **kw)
            except Backpressure as exc:
                refused[_i].append(exc.retry_after_s)
                raise
        transport.split_step = spy
        clients.append(SplitClientTrainer(
            get_plan(), cfg, torch.Generator().manual_seed(i), transport,
            client_id=i, failure_policy="retry", max_retries=ADMIT_RETRIES,
            retry_backoff=0.0, device="cuda"))
    t = time.perf_counter()
    try:
        losses = [[c.train_step(x, y, s) for c in clients]
                  for s, (x, y) in enumerate(data)]
        wall = time.perf_counter() - t
        adm = runtime.health()["admission"]
    finally:
        for c in clients:
            c.transport.close()
        srv.stop()
        runtime.close()
    check(all(math.isfinite(v) for r in losses for v in r),
          "admission: finite losses")
    check(refused[0] and not refused[1] and max(refused[0]) > 0,
          f"admission: 429s seen {refused}")
    check(adm["admission_admitted_t0"] == adm["admission_admitted_t1"]
          == ADMIT_STEPS and adm["admission_rejected_t0"] == len(refused[0])
          and adm["admission_rejected_t1"] == 0
          and adm["admission_queue_depth_t0"] == 0,
          f"admission counters {adm}")
    check(all(c.dropped_batches == 0 for c in clients), "admission: drops")
    print(f"[many] admission over HTTP: tenant 0 refused {len(refused[0])} "
          f"times (Retry-After {min(refused[0]):.3f}-{max(refused[0]):.3f} "
          f"s), every step done in {wall:.2f} s; counters {adm}",
          flush=True)
    return dict(tenants=2, quota=list(ADMIT_QUOTA), steps=ADMIT_STEPS,
                refused_429=len(refused[0]),
                retry_after_s=[min(refused[0]), max(refused[0])],
                wall_s=wall, counters=adm)


def many_clients_runs(torch, tr_data):
    """Phase 25 (see the module docstring). Returns the record and the
    launch totals of its runs."""
    from split_learning_tpu_torch.data import batches, synthetic
    from split_learning_tpu_torch.ops.common import LAUNCHES
    ds = synthetic("mnist", n_train=BATCH * MANY_CLIENTS * MANY_ROUNDS,
                   n_test=8, seed=2)
    data = list(batches(ds.train, BATCH, seed=2, drop_remainder=True))
    t = time.perf_counter()
    totals, restore = _phase_totals(LAUNCHES)
    try:
        rec = dict(coalescing=coalesce_runs(torch, data),
                   decoupled_bwd=decoupled_runs(torch, data, tr_data),
                   pipelined=pipelined_runs(torch, data, tr_data),
                   admission=admission_runs(torch))
    finally:
        restore()
    rec["card_tests"] = card_test_step(MANY_CARD_TEST_FILTER)
    rec["seconds"] = time.perf_counter() - t
    return rec, totals


# --------------------------------------------------------------------- #
# phase 26: the image families (ResNet-18 and the ViT on CIFAR-10)

def vit_flash_checks(torch, dev, gen, bw, flash_peak) -> dict:
    """Phase 26 (a): K5 and K6 non-causal at :data:`VIT_FA_SHAPES`
    against their plain versions, float32 and bf16 (phase 6's and phase
    9's tolerances), with their device ms beside the plain versions',
    ``F.scaled_dot_product_attention``'s (its backward through autograd)
    and the bound (phase 8's roofs; 4 T x T x D products a forward
    counted whole, 10 for the backward)."""
    import torch.nn.functional as F
    from split_learning_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_plain, flash_attention_with_lse_plain,
        flash_bwd_cuda, flash_fwd_cuda)
    out = {}
    for shape in VIT_FA_SHAPES:
        b, t, h, d = shape
        n, rows, pairs = math.prod(shape), b * t * h, b * h * t * t
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            e = torch.tensor([], dtype=dtype).element_size()
            q, k, v, do = (torch.randn(shape, device=dev,
                                       generator=gen).to(dtype)
                           for _ in range(4))
            o, lse = flash_fwd_cuda(q, k, v, False)
            grads = flash_bwd_cuda(q, k, v, o, lse, do, None, False)
            torch.cuda.synchronize()
            o_p, lse_p = flash_attention_with_lse_plain(q, k, v, False)
            e_o = (o.float() - o_p.float()).abs().max().item()
            e_l = (lse - lse_p).abs().max().item()
            tol_o, tol_l = FA_TOL[name]
            check(e_o <= tol_o and e_l <= tol_l,
                  f"K5 at {shape} {name}: O err {e_o}, LSE err {e_l}")
            e_g = 0.0
            for got, want in zip(grads, flash_attention_bwd_plain(
                    q, k, v, o, lse, do, None, False)):
                err = (got.float() - want.float()).abs().max().item()
                scale = max(1.0, want.float().abs().max().item())
                check(got.dtype == want.dtype
                      and err <= FA_BWD_TOL[name] * scale,
                      f"K6 at {shape} {name}: err {err} (scale {scale})")
                e_g = max(e_g, err)
            f_ms, f_by = bound(4 * n * e + 4 * rows, 4 * pairs * d, bw,
                               flash_peak[name])
            b_ms, b_by = bound(8 * n * e + 4 * rows, 10 * pairs * d, bw,
                               flash_peak[name])
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                          for x in (q, k, v))
            lib_out = F.scaled_dot_product_attention(qt, kt, vt)
            do_t = do.transpose(1, 2)
            out[f"{list(shape)} {name}"] = dict(
                shape=list(shape), dtype=name, causal=False,
                fwd=dict(
                    ms=device_ms(torch, lambda: flash_fwd_cuda(q, k, v,
                                                               False)),
                    plain_ms=device_ms(
                        torch, lambda: flash_attention_with_lse_plain(
                            q, k, v, False), reps=20),
                    library_ms=device_ms(
                        torch, lambda: F.scaled_dot_product_attention(
                            qt, kt, vt)),
                    bound_ms=f_ms, bound_by=f_by, max_abs_err=e_o,
                    max_abs_err_lse=e_l),
                bwd=dict(
                    ms=device_ms(torch, lambda: flash_bwd_cuda(
                        q, k, v, o, lse, do, None, False), reps=50),
                    plain_ms=device_ms(
                        torch, lambda: flash_attention_bwd_plain(
                            q, k, v, o, lse, do, None, False), reps=20),
                    library_ms=device_ms(
                        torch, lambda: torch.autograd.grad(
                            lib_out, (qt, kt, vt), do_t, retain_graph=True),
                        reps=50),
                    bound_ms=b_ms, bound_by=b_by, max_abs_err=e_g))
            del q, k, v, do, o, lse, grads, qt, kt, vt, lib_out, do_t
    print("[k5/k6] non-causal at the ViT's shapes, ms kernel / SDPA: "
          + "; ".join(f"{key} fwd {r['fwd']['ms']:.4f} / "
                      f"{r['fwd']['library_ms']:.4f}, bwd "
                      f"{r['bwd']['ms']:.4f} / {r['bwd']['library_ms']:.4f}"
                      for key, r in out.items()), flush=True)
    return out


def _img_data_dir():
    return os.path.join(REPO, "build", "chip_smoke_image_data")


def _loss_times(data_dir):
    """The jsonl metrics' losses of the run just made and the host time
    of each record, and the log cleared for the next one."""
    folder = os.path.join(data_dir, "metrics")
    recs = []
    for name in sorted(os.listdir(folder)):
        path = os.path.join(folder, name)
        with open(path) as f:
            recs += [r for r in map(json.loads, f) if r.get("key") == "loss"]
        os.remove(path)
    return [r["value"] for r in recs], [r["ts"] for r in recs]


def image_cli_leg(torch, launch_run, label, flags, per_step) -> dict:
    """``launch.run.main(["train", ...])`` for IMG_STEPS fused steps at
    IMG_B with launch counts reset before and read after (``per_step``
    each step, exactly); the step ms from the loss records' host times
    (each step ends in the loss's read), median of steps 6-30."""
    data_dir = _img_data_dir()
    rc, counts, _, secs = _cli(torch, launch_run, [
        "train", "--device", "cuda", "--dataset", "cifar10", "--transport",
        "fused", "--batch-size", str(IMG_B), "--steps", str(IMG_STEPS),
        "--tracking", "jsonl", "--data-dir", data_dir, *flags])
    check(rc == 0, f"{label}: launch.run.main returned {rc}")
    want = {k: v * IMG_STEPS for k, v in per_step.items()}
    print(f"[image] {label}: {IMG_STEPS} steps through the CLI, launches "
          f"{counts}", flush=True)
    check(counts == want, f"{label} launches {counts}, want {want}")
    losses, ts = _loss_times(data_dir)
    check(len(losses) == IMG_STEPS and all(map(math.isfinite, losses)),
          f"{label}: losses {losses}")
    check(statistics.mean(losses[-5:]) < statistics.mean(losses[:5]),
          f"{label}: loss did not fall: {losses}")
    steady = [(b - a) * 1e3 for a, b in zip(ts[4:], ts[5:])]
    med = statistics.median(steady)
    return dict(step_ms_median=med, step_ms_min=min(steady),
                step_ms_max=max(steady), images_per_s=IMG_B / med * 1e3,
                cli_seconds=secs, loss_first=losses[0],
                loss_last=losses[-1], launches=counts,
                launches_per_step=per_step)


def image_trainer_window(torch, plan, cfg, data, peak) -> dict:
    """A fused trainer of the leg's plan and config on the card: the
    model FLOPs of one step (``FusedSplitTrainer.step_flops``: K5/K6
    included, JAX's count) beside their bound at ``peak``, and a
    profiler window of 5 steps with the device's time by kernel class.
    Returns the record and the trainer's state after the window
    (``export_states``)."""
    from split_learning_tpu_torch.runtime import FusedSplitTrainer
    trainer = FusedSplitTrainer(plan, cfg, torch.Generator().manual_seed(0),
                                data[0][0], device="cuda")
    for x, y in data[:4]:
        trainer.train_step(x, y)
    flops = trainer.step_flops(*data[3])
    b_ms, b_by = bound(0, flops, 1.0, peak)

    def run():
        for x, y in data[4:4 + PROFILE_STEPS]:
            trainer.train_step(x, y)
    rec = dict(flops_per_step=flops, bound_ms=b_ms, bound_by=b_by,
               bound_peak_flops=peak,
               profile=profile_window(torch, run, PROFILE_STEPS,
                                      classes=IMG_CLASSES))
    return rec, trainer.export_states()


def host_params(params) -> tuple:
    """Host copies of per-stage parameter dicts."""
    return tuple({k: v.detach().cpu().clone() for k, v in st.items()}
                 for st in params)


def update_gap(before, card, cpu) -> float:
    """The relative L2 distance of the card's update (``card`` minus
    ``before``, every leaf of every stage together) from the CPU's."""
    num = den = 0.0
    for st0, st_card, st_cpu in zip(before, card, cpu):
        for k, p0 in st0.items():
            u_cpu = st_cpu[k].detach().cpu().double() - p0.double()
            u_card = st_card[k].detach().cpu().double() - p0.double()
            num += (u_card - u_cpu).square().sum().item()
            den += u_cpu.square().sum().item()
    check(den > 0, "a CPU twin step left the parameters where they were")
    return math.sqrt(num / den)


def twin_check(label, losses, gaps, loss_tol, update_tols, floors=None
               ) -> dict:
    """Hold a twin's per-step losses (``{"cuda": [...], "cpu": [...]}``)
    within ``loss_tol(cpu_loss)`` and its per-step update gaps
    (:func:`update_gap`) within ``update_tols``; the twin's record
    (``floors``: a bf16 twin's CPU bf16-against-float32 gaps)."""
    diffs = [abs(a - b) for a, b in zip(losses["cuda"], losses["cpu"])]
    tols = [loss_tol(b) for b in losses["cpu"]]
    check(all(d <= t for d, t in zip(diffs, tols)),
          f"{label} CPU twin: card losses {losses['cuda']} vs CPU "
          f"{losses['cpu']}, tolerance {tols}")
    check(all(g <= t for g, t in zip(gaps, update_tols)),
          f"{label} CPU twin: the updates differ by {gaps} (relative L2), "
          f"tolerance {update_tols}")
    return dict(steps=IMG_TWIN_STEPS, batch=IMG_TWIN_B,
                card=losses["cuda"], cpu=losses["cpu"],
                max_abs_diff=max(diffs), loss_tol=tols,
                update_rel_l2=gaps, update_tol=update_tols,
                bf16_floor_rel_l2=floors)


def as_float32(torch, tree):
    """``tree`` (nested dicts, lists and tuples) with every floating
    tensor in float32."""
    if torch.is_tensor(tree):
        return tree.float() if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: as_float32(torch, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(as_float32(torch, v) for v in tree)
    return tree


def image_fused_twin(torch, label, plan, cfg, state, data, loss_tol,
                     wide_plan=None) -> dict:
    """IMG_TWIN_STEPS fused steps at IMG_TWIN_B, each on the card and on
    the CPU from one state (cuDNN deterministic): the card's trainer
    starts from ``state`` (the profiled trainer's ``export_states``, 14
    steps in: parameters, optimizer state and count) and runs on, and
    before each step the CPU's adopts the card's whole state. A bf16 leg
    also steps ``wide_plan`` (its plan in float32) on the CPU from that
    state, in float32: the bf16 update's own rounding, which sets the
    update's bound. Held by :func:`twin_check`."""
    from split_learning_tpu_torch.runtime import FusedSplitTrainer
    rows = [(x[:IMG_TWIN_B], y[:IMG_TWIN_B])
            for x, y in data[-IMG_TWIN_STEPS:]]
    cfg = cfg.replace(batch_size=IMG_TWIN_B)
    init = host_params(state["trainer"]["params"])
    card, cpu = (FusedSplitTrainer(plan, cfg, init, rows[0][0], device=where)
                 for where in ("cuda", "cpu"))
    wide = (None if wide_plan is None else FusedSplitTrainer(
        wide_plan, cfg.replace(dtype="float32"), as_float32(torch, init),
        rows[0][0], device="cpu"))
    card.restore_states(state)
    losses, gaps, tols, floors = {"cuda": [], "cpu": []}, [], [], []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for x, y in rows:
            # the tree holds the card's live tensors: adopt it before
            # the card steps
            tree = card.export_states()
            cpu.restore_states(tree)
            if wide is not None:
                wide.restore_states(as_float32(torch, tree))
            before = host_params(card.params)
            losses["cuda"].append(card.train_step(x, y))
            losses["cpu"].append(cpu.train_step(x, y))
            gaps.append(update_gap(before, card.params, cpu.params))
            if wide is None:
                tols.append(IMG_UPDATE_TOL)
                continue
            wide.train_step(x, y)
            floors.append(update_gap(before, cpu.params, wide.params))
            tols.append(IMG_BF16_UPDATE_FACTOR * floors[-1])
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return twin_check(label, losses, gaps, loss_tol, tols, floors or None)


def image_two_party(torch, dev, label, model, kw, cfg, data, mode,
                    server_step, client_step, twin_tol) -> dict:
    """Phase 26's two parties in one process: ``SplitClientTrainer`` over
    ``LocalTransport(ServerRuntime)`` on the card, IMG_TP_STEPS steps in
    ``mode``. Launch counts reset before and read after: the server's
    ``server_step`` a step inside its ``split_step``, the whole run's
    ``server_step + client_step`` plus two frames' wire launches a step;
    one host sync per card encode and the frame twin at steps 1-3; frame
    bytes each way; a CPU twin of IMG_TWIN_STEPS steps at IMG_TWIN_B
    from both parties' state after the run, each step from one state on
    both devices, held by :func:`twin_check` (losses within
    ``twin_tol``)."""
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.ops.common import LAUNCHES
    from split_learning_tpu_torch.runtime import (
        ServerRuntime, SplitClientTrainer)
    from split_learning_tpu_torch.transport import LocalTransport, codec
    plan = get_plan(model=model, **kw)

    def stack(device, init, c):
        server = ServerRuntime(plan, c, init, device=device)
        transport = LocalTransport(server, compress=mode, density=DENSITY)
        return (SplitClientTrainer(plan, c, init, transport, device=device),
                transport, server)

    client, transport, server = stack("cuda",
                                      torch.Generator().manual_seed(0), cfg)
    twin = (FrameTwin(torch, codec, mode).attach_step(transport, server)
            if mode != "none" else None)
    srv = party_counts(server, ("split_step",))
    LAUNCHES.reset()
    losses, ms = [], []
    for i, (x, y) in enumerate(data[:IMG_TP_STEPS]):
        t = time.perf_counter()
        losses.append(client.train_step(x, y, i))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    counts = LAUNCHES.snapshot()
    per_step = dict(client_step)
    for k, v in {**server_step, **wire_launches(mode, 2)}.items():
        per_step[k] = per_step.get(k, 0) + v
    want = {k: v * IMG_TP_STEPS for k, v in per_step.items()}
    want_srv = {k: v * IMG_TP_STEPS for k, v in server_step.items()}
    print(f"[image] {label} {mode}: {IMG_TP_STEPS} steps, launches {counts} "
          f"(server {srv}), losses {losses[0]:.4f} -> {losses[-1]:.4f}",
          flush=True)
    check(counts == want, f"{label} {mode} launches {counts}, want {want}")
    check(srv == want_srv, f"{label} {mode} server launches {srv}, want "
                           f"{want_srv}")
    check(all(map(math.isfinite, losses)), f"{label} {mode}: finite")
    rec = {}
    if twin is not None:
        check(twin.packs == 2 * IMG_TP_STEPS and set(twin.syncs) == {1},
              f"{label} {mode}: host syncs per card encode "
              f"{sorted(set(twin.syncs))} over {twin.packs} frames")
        twin.probe(torch, dev)
        check(twin.frames == 2 * FRAME_TWIN_STEPS + 1
              and twin.mismatched == 0,
              f"{label} {mode} frame twin: {twin.mismatched} of "
              f"{twin.frames} frames differ from the host codec's")
        rec["frame_twin"] = dict(frames=twin.frames,
                                 mismatched=twin.mismatched,
                                 host_syncs_per_encode=twin.syncs[0])
    stats = transport.stats.summary()
    # each twin step from one state: fresh parties on both devices from
    # the parameters the card reached (plain SGD keeps no other state,
    # and a fresh wire's residuals are zero on both)
    check(cfg.optimizer == "sgd" and not cfg.momentum,
          f"{label} {mode}: the twin's parties keep no optimizer state")
    before = host_params((client.params, server.params))
    rows = [(x[:IMG_TWIN_B], y[:IMG_TWIN_B])
            for x, y in data[-IMG_TWIN_STEPS:]]
    small = cfg.replace(batch_size=IMG_TWIN_B)
    losses_twin, gaps = {"cuda": [], "cpu": []}, []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for x, y in rows:
            after = {}
            for where in ("cuda", "cpu"):
                c, _, srv_party = stack(where, before, small)
                losses_twin[where].append(c.train_step(x, y, 0))
                after[where] = (c.params, srv_party.params)
            gaps.append(update_gap(before, after["cuda"], after["cpu"]))
            before = host_params(after["cuda"])
    finally:
        torch.backends.cudnn.deterministic = deterministic
    check(cfg.dtype == "float32", f"{label} {mode}: a float32 twin")
    rec["cpu_twin"] = twin_check(f"{label} {mode}", losses_twin, gaps,
                                 lambda _loss: twin_tol,
                                 [IMG_UPDATE_TOL] * len(gaps))

    def more_steps():
        for i, (x, y) in enumerate(data[:5]):
            client.train_step(x, y, IMG_TP_STEPS + i)
    steady = ms[3:]
    return dict(
        rec, step_ms_median=statistics.median(steady),
        step_ms_min=min(steady), step_ms_max=max(steady),
        images_per_s=len(data[0][1]) / statistics.median(steady) * 1e3,
        wire_bytes_up_per_step=stats["bytes_sent"] / IMG_TP_STEPS,
        wire_bytes_down_per_step=stats["bytes_received"] / IMG_TP_STEPS,
        compression_ratio=stats.get("compression_ratio"),
        loss_first=losses[0], loss_last=losses[-1], launches=counts,
        launches_per_step=per_step, server_launches_per_step=server_step,
        profile=profile_window(torch, more_steps, 5, classes=IMG_CLASSES))


def _f32_twin_tol(_loss):
    return IMG_TWIN_TOL["none"]


def image_runs(torch, launch_run, dev, gen, peaks) -> tuple:
    """Phase 26 (see the module docstring). Returns the record, the
    launch totals of its runs and the K5/K6 records at the ViT's
    shapes."""
    from split_learning_tpu_torch.data import batches, synthetic
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.ops.common import LAUNCHES
    from split_learning_tpu_torch.ops.cross_entropy import BWD, FWD
    from split_learning_tpu_torch.ops.flash_attention import (
        BWD_NAMES, NAME as FA)
    from split_learning_tpu_torch.ops.sgd import NAME as SGD
    from split_learning_tpu_torch.utils import Config
    bw, fp32, bf16_peak, flash_peak = peaks
    t0 = time.perf_counter()
    vit_fa = vit_flash_checks(torch, dev, gen, bw, flash_peak)
    # batches for the trainer windows (4 warm + PROFILE_STEPS) and the
    # two-party legs (IMG_TP_STEPS)
    n_batches = max(4 + PROFILE_STEPS, IMG_TP_STEPS)
    ds = synthetic("cifar10", n_train=IMG_B * n_batches, n_test=8, seed=0)
    data = list(batches(ds.train, IMG_B, seed=0, drop_remainder=True))
    totals, restore = _phase_totals(LAUNCHES)
    rec = {"resnet18_fused": {}}
    try:
        for dtype in ("float32", "bfloat16"):
            leg = image_cli_leg(
                torch, launch_run, f"resnet18 fused {dtype}",
                ["--model", "resnet18", "--dtype", dtype],
                {FWD: 1, BWD: 1, SGD: 1})
            plan = get_plan(model="resnet18", dtype=dtype)
            cfg = Config(transport="fused", model="resnet18", dtype=dtype,
                         batch_size=IMG_B, lr=LR)
            window, state = image_trainer_window(
                torch, plan, cfg, data,
                fp32 if dtype == "float32" else bf16_peak)
            leg.update(window)
            wide = None if dtype == "float32" else get_plan(model="resnet18")
            leg["cpu_twin"] = image_fused_twin(
                torch, f"resnet18 fused {dtype}", plan, cfg, state, data,
                _f32_twin_tol if wide is None else bf16_loss_tol, wide)
            rec["resnet18_fused"][dtype] = leg
        cfg = Config(transport="local", model="resnet18", batch_size=IMG_B,
                     lr=LR)
        rec["resnet18_two_party"] = {
            mode: image_two_party(
                torch, dev, "resnet18 two-party", "resnet18", {}, cfg,
                data, mode, {FWD: 1, BWD: 1, SGD: 1}, {SGD: 1},
                IMG_TWIN_TOL[mode]) for mode in ("none", "int8")}
        n_blocks = VIT_S["client_depth"] + VIT_S["server_depth"]
        vit_s_flags = ["--model", "vit", "--attn", "flash", "--dtype",
                       "bfloat16", *VIT_S_OPT,
                       *(f"--{k.replace('_', '-')}={v}"
                         for k, v in VIT_S.items())]
        leg = image_cli_leg(
            torch, launch_run, "ViT-S bf16 AdamW", vit_s_flags,
            {FA: n_blocks, **{n: n_blocks for n in BWD_NAMES}, FWD: 1,
             BWD: 1})
        plan = get_plan(model="vit", attn="flash", dtype="bfloat16",
                        channels=3, **VIT_S)
        cfg = Config(transport="fused", model="vit", attn="flash",
                     dtype="bfloat16", batch_size=IMG_B, optimizer="adamw",
                     lr=1e-3, weight_decay=0.05, warmup_steps=5,
                     decay_steps=IMG_STEPS, grad_clip_norm=1.0)
        window, state = image_trainer_window(torch, plan, cfg, data,
                                             bf16_peak)
        leg.update(window)
        leg["cpu_twin"] = image_fused_twin(
            torch, "ViT-S bf16", plan, cfg, state, data, bf16_loss_tol,
            get_plan(model="vit", attn="flash", channels=3, **VIT_S))
        rec["vit_s_bf16"] = dict(leg, blocks=n_blocks, tokens=64, **VIT_S)
        cfg = Config(transport="local", model="vit", attn="flash",
                     batch_size=IMG_B, lr=LR)
        rec["vit_two_party"] = {"topk8": image_two_party(
            torch, dev, "ViT two-party", "vit",
            dict(attn="flash", channels=3), cfg, data, "topk8",
            {FA: 2, **{n: 2 for n in BWD_NAMES}, FWD: 1, BWD: 1, SGD: 1},
            {FA: 1, **{n: 1 for n in BWD_NAMES}, SGD: 1},
            IMG_TWIN_TOL["topk8"])}
    finally:
        restore()
    rec["card_tests"] = card_test_step(IMG_CARD_TEST_FILTER)
    rec["seconds"] = time.perf_counter() - t0
    for key, leg in (("resnet18 f32", rec["resnet18_fused"]["float32"]),
                     ("resnet18 bf16", rec["resnet18_fused"]["bfloat16"]),
                     ("ViT-S bf16", rec["vit_s_bf16"])):
        print(f"[image] {key}: {leg['step_ms_median']:.2f} ms a step, "
              f"{leg['images_per_s']:.0f} images/s, bound "
              f"{leg['bound_ms']:.2f} ms, idle "
              f"{leg['profile']['device_idle_share']}", flush=True)
    return rec, totals, vit_fa


# phase 27: the K-stage chain

def chain_per_step(mode=None, s=CHAIN_S, m=CHAIN_M) -> dict:
    """The chain's launches a step, from the code: the last stage's K1
    pair 2M times (its M loss hops, and the deferred apply's recompute
    of them), K2 S times (the hub's update and one deferred apply a
    stage), and on a compressed wire (4S - 6) M packs and decodes (a
    middle wire packs x up, y down, g up and g_in down; the loss wire x
    up and g down; the labels travel dense)."""
    from split_learning_tpu_torch.ops.cross_entropy import BWD, FWD
    from split_learning_tpu_torch.ops.sgd import NAME as SGD
    per = {FWD: 2 * m, BWD: 2 * m, SGD: s}
    per.update(wire_launches(mode, (4 * s - 6) * m))
    return per


def chain_stack(torch, plan, cfg, init, device, mode=None, dc=None,
                schedule="gpipe"):
    """A chain of ``plan`` on ``device`` from ``init``: the hub's
    ``PipelineRunner`` and a ``StageRuntime`` a stage behind
    ``DeviceTransport`` (``mode`` None) or ``LocalTransport`` with
    ``mode`` and the controller ``dc``. Returns (runner, stages,
    wires)."""
    from split_learning_tpu_torch.runtime import PipelineRunner, StageRuntime
    from split_learning_tpu_torch.transport import (
        DeviceTransport, LocalTransport)
    stages = [StageRuntime(plan, i, cfg, init,
                           microbatches=cfg.microbatches, device=device)
              for i in range(1, plan.num_stages)]
    wires = [DeviceTransport(st) if mode is None else LocalTransport(
        st, compress=mode, density=DENSITY, density_controller=dc)
        for st in stages]
    runner = PipelineRunner(plan, cfg, init, None, wires,
                            microbatches=cfg.microbatches,
                            schedule=schedule, device=device,
                            step_timeout_s=CHAIN_STEP_TIMEOUT)
    runner.density_controller = dc
    return runner, stages, wires


def chain_close(chain) -> None:
    runner, stages, _ = chain
    runner.close()
    for st in stages:
        st.close()


def chain_params(chain) -> tuple:
    runner, stages, _ = chain
    return (runner.params, *(st.params for st in stages))


class ChainWireTwin:
    """The hop wires' kernels at the chain's own shapes and densities.
    For the first ``packs`` packs of each wire and EF key, the card's
    pack (K3q, or K4s's five launches with the key's residual) against
    the codec on a CPU copy of the same inputs, which runs the kernels'
    plain versions: frames byte-equal, new residuals bit-equal. For the
    first ``packs`` decodes of each wire and payload, the card's decode
    (K3d for int8) against the CPU's decode of the same frame, bit-equal.
    The plain versions count no launches. Every pack's shape is kept."""

    def __init__(self, torch, codec, mode, packs=CHAIN_WIRE_TWIN_PACKS):
        self.torch, self.codec, self.mode, self.packs = (
            torch, codec, mode, packs)
        self.shapes, self._seen = set(), {}
        self.frames = self.decodes = self.mismatched = 0
        self._lock = threading.Lock()

    def _claim(self, key) -> bool:
        with self._lock:
            n = self._seen.get(key, 0)
            self._seen[key] = n + 1
            return n < self.packs

    def _count(self, what, ok) -> None:
        with self._lock:
            setattr(self, what, getattr(self, what) + 1)
            self.mismatched += int(not ok)

    def _wrap_pack(self, wire, pack, ef_of, role):
        torch, codec = self.torch, self.codec

        def twin(arr, key):
            with self._lock:
                self.shapes.add(tuple(arr.shape))
            if not self._claim((id(wire), key)):
                return pack(arr, key)
            x = arr.detach().cpu()
            if self.mode == "int8":
                packed = pack(arr, key)
                plain, ok = codec.q8_compress(x), True
            else:
                density = wire._density_now()
                prev = ef_of().residual(key)
                prev = None if prev is None else prev.detach().cpu()
                packed = pack(arr, key)
                plain, res = codec.topk8_compress(
                    x, density, prev, codec.ef_decay_for(key[role]))
                ok = torch.equal(ef_of().residual(key).cpu(), res)
            self._count("frames", ok and codec.encode(packed)
                        == codec.encode(plain))
            return packed
        return twin

    def _wrap_decode(self, wire, real):
        torch, codec = self.torch, self.codec
        cpu = torch.device("cpu")

        def twin(payload, device):
            tree, n = real(payload, device)
            if device is None or not self._claim(
                    (id(wire), "decode", tuple(sorted(payload)))):
                return tree, n
            plain = codec.decompress_tree(
                codec.decode(codec.encode(payload)), cpu)
            ok = all(torch.equal(tree[k].cpu(), plain[k]) if isinstance(
                tree[k], torch.Tensor) else tree[k] == plain[k]
                for k in payload)
            self._count("decodes", ok)
            return tree, n
        return twin

    def attach(self, wire):
        """Wrap ``wire``'s two packs (its EF ledgers as it picks them)
        and its decode."""
        wire._pack_up = self._wrap_pack(wire, wire._pack_up,
                                        lambda: wire._ef, 0)
        wire._pack_down = self._wrap_pack(
            wire, wire._pack_down,
            lambda: getattr(wire.server, "wire_ef", None) or wire._down_ef,
            1)
        wire._wire = self._wrap_decode(wire, wire._wire)
        return self

    def summary(self) -> dict:
        return dict(frames=self.frames, decodes=self.decodes,
                    mismatched=self.mismatched,
                    shapes=sorted(map(list, self.shapes)))


def chain_leg(torch, label, plan, cfg, data, mode=None, dc=None,
              steps=CHAIN_STEPS, profile=False):
    """One chain on the card from seed 0: ``steps`` steps with launch
    counts reset before and read after (:func:`chain_per_step` each
    step, exactly), ms a step on the host clock (each step ends in a
    synchronise; median from the third step), finite losses, no host
    copy on a device wire, the wires' bytes a step; on a compressed wire
    a :class:`ChainWireTwin` (its CPU work falls in the first step, which
    the median leaves out) and the packs' shapes equal to CHAIN_CUTS at
    this batch; with ``profile`` the hop workers' busy shares of those
    steps beside the ideal bubble and a profiler window of
    CHAIN_PROFILE_STEPS more. Returns the record and the open chain."""
    from split_learning_tpu_torch.obs import spans
    from split_learning_tpu_torch.ops.common import LAUNCHES
    from split_learning_tpu_torch.transport import codec
    chain = runner, _, wires = chain_stack(
        torch, plan, cfg, torch.Generator().manual_seed(0), "cuda", mode, dc)
    twin = None
    if mode is not None:
        twin = ChainWireTwin(torch, codec, mode)
        for w in wires:
            twin.attach(w)
    LAUNCHES.reset()
    losses, ms = [], []
    for i, (x, y) in enumerate(data[:steps]):
        t = time.perf_counter()
        losses.append(runner.step(x, y, i))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    counts = LAUNCHES.snapshot()
    per_step = chain_per_step(mode)
    want = {k: v * steps for k, v in per_step.items()}
    copies = [w.stats.counters.get(spans.HOP_HOST_COPIES, 0) for w in wires]
    print(f"[chain] {label}: {steps} steps, launches {counts}, losses "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, hop host copies {copies}",
          flush=True)
    check(counts == want, f"{label} launches {counts}, want {want}")
    check(all(map(math.isfinite, losses)), f"{label}: losses {losses}")
    if mode is None:
        check(copies == [0] * len(wires),
              f"{label}: hop payloads fell to the host {copies}")
    else:
        # a middle wire packs under four keys (x, g up; y, g_in down),
        # the loss wire under two
        keys = 4 * (len(wires) - 1) + 2
        cuts = {(cfg.batch_size // cfg.microbatches, *f)
                for f in CHAIN_CUT_FEATURES}
        tw = twin.summary()
        print(f"[chain] {label}: wire twin {tw}", flush=True)
        # and decodes (K3d's on int8) under three payloads (x, y, g) and
        # two (x with the labels; g with the loss)
        payloads = 3 * (len(wires) - 1) + 2
        check(tw["mismatched"] == 0 and tw["frames"] == keys * twin.packs
              and tw["decodes"] == payloads * twin.packs,
              f"{label}: the card's hop frames or decodes differ from the "
              f"plain versions' {tw}")
        check(twin.shapes == cuts,
              f"{label}: packed {sorted(twin.shapes)}, not the cuts "
              f"{sorted(cuts)} that phase 12 checks")
    steady = ms[2:]
    med = statistics.median(steady)
    rec = dict(
        steps=steps, step_ms_median=med, step_ms_min=min(steady),
        step_ms_max=max(steady), images_per_s=CHAIN_B / med * 1e3,
        losses=losses, launches=counts,
        launches_per_step={k: v / steps for k, v in counts.items()},
        launches_per_step_predicted=per_step, hop_host_copies=copies,
        wire_twin=None if twin is None else twin.summary(),
        wire_bytes_per_step=[dict(
            up=w.stats.bytes_sent / steps,
            down=w.stats.bytes_received / steps,
            compression_ratio=w.stats.summary().get("compression_ratio"))
            for w in wires])
    if profile:
        # host time, not the device's: each hop worker's busy share of
        # the wall (unclipped), and JAX's bubble from their sum, clipped
        rec["bubble"] = [dict(stage=r["stage"],
                              busy_share_forward=r["busy_share_forward"],
                              busy_share_backward=r["busy_share_backward"],
                              host_bubble_clipped=r["bubble_fraction"],
                              ideal=r["bubble_theoretical"],
                              reply_p50_ms=r["reply_p50_ms"])
                         for r in runner.stage_report()]

        def more():
            for i, (x, y) in enumerate(
                    data[steps:steps + CHAIN_PROFILE_STEPS]):
                runner.step(x, y, steps + i)
        rec["profile"] = profile_window(torch, more, CHAIN_PROFILE_STEPS,
                                        classes=IMG_CLASSES)
    return rec, chain


def chain_schedules_equal(torch, plan, cfg, data) -> dict:
    """GPipe and 1F1B from one init over CHAIN_EQ_STEPS steps under
    deterministic cuDNN: the loss series bit for bit."""
    series = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for schedule in ("gpipe", "1f1b"):
            chain = chain_stack(torch, plan, cfg,
                                torch.Generator().manual_seed(0), "cuda",
                                schedule=schedule)
            try:
                series[schedule] = [chain[0].step(x, y, i) for i, (x, y)
                                    in enumerate(data[:CHAIN_EQ_STEPS])]
            finally:
                chain_close(chain)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    check(series["1f1b"] == series["gpipe"],
          f"1F1B {series['1f1b']} is not GPipe's {series['gpipe']}")
    return dict(series, bit_equal=True)


def chain_twin(torch, label, plan, cfg, params, data, loss_tol,
               wide_plan=None) -> dict:
    """CHAIN_TWIN_STEPS chain steps at CHAIN_TWIN_B, each on the card and
    on the CPU from one state, the card chain's parameters (plain SGD at
    lag 0 keeps no other state), under deterministic cuDNN. A bf16 leg
    also steps ``wide_plan`` (its plan in float32) on the CPU from that
    state, for the bf16 update's own rounding. Held by
    :func:`twin_check`."""
    rows = [(x[:CHAIN_TWIN_B], y[:CHAIN_TWIN_B])
            for x, y in data[-CHAIN_TWIN_STEPS:]]
    small = cfg.replace(batch_size=CHAIN_TWIN_B)
    before = host_params(params)
    losses, gaps, tols, floors = {"cuda": [], "cpu": []}, [], [], []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for x, y in rows:
            after = {}
            runs = [("cuda", plan, small, before), ("cpu", plan, small,
                                                    before)]
            if wide_plan is not None:
                runs.append(("wide", wide_plan,
                             small.replace(dtype="float32"),
                             as_float32(torch, before)))
            for where, pl, c, init in runs:
                chain = chain_stack(torch, pl, c, init,
                                    "cpu" if where == "wide" else where)
                loss = chain[0].step(x, y, 0)
                chain_close(chain)   # lag 0: every update is applied
                if where != "wide":
                    losses[where].append(loss)
                after[where] = chain_params(chain)
            gaps.append(update_gap(before, after["cuda"], after["cpu"]))
            if wide_plan is None:
                tols.append(IMG_UPDATE_TOL)
            else:
                floors.append(update_gap(before, after["cpu"],
                                         after["wide"]))
                tols.append(IMG_BF16_UPDATE_FACTOR * floors[-1])
            before = host_params(after["cuda"])
    finally:
        torch.backends.cudnn.deterministic = deterministic
    rec = twin_check(label, losses, gaps, loss_tol, tols, floors or None)
    rec.update(steps=CHAIN_TWIN_STEPS, batch=CHAIN_TWIN_B)
    return rec


def chain_dc_twin(torch, plan, cfg, data) -> dict:
    """The adaptive controller on the topk8 chain, on the card and on the
    CPU from one init (CHAIN_DC_STEPS at CHAIN_DC_B, a decision every
    step, deterministic cuDNN): the same decisions and densities. The
    losses are recorded, not held: the two runs round their
    convolutions differently, topk8 then keeps different survivors
    where magnitudes tie to rounding, and a free-running pair drifts.
    :func:`chain_twin` holds the chain's losses step by step, and
    :class:`ChainWireTwin` the wire kernels on this path."""
    from split_learning_tpu_torch.transport import DensityController
    small = cfg.replace(batch_size=CHAIN_DC_B)
    rows = [(x[:CHAIN_DC_B], y[:CHAIN_DC_B])
            for x, y in data[:CHAIN_DC_STEPS]]
    out = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for where in ("cuda", "cpu"):
            dc = DensityController(window=1)
            chain = chain_stack(torch, plan, small,
                                torch.Generator().manual_seed(0), where,
                                "topk8", dc)
            try:
                losses = [chain[0].step(x, y, i)
                          for i, (x, y) in enumerate(rows)]
            finally:
                chain_close(chain)
            out[where] = dict(losses=losses, decisions=[
                [r["action"], r["wire"], r["densities"]]
                for r in dc.snapshot()["trajectory"]])
    finally:
        torch.backends.cudnn.deterministic = deterministic
    check(out["cuda"]["decisions"] == out["cpu"]["decisions"],
          f"the controller's decisions differ: card {out['cuda']}, CPU "
          f"{out['cpu']}")
    gap = max(abs(a - b) for a, b in zip(out["cuda"]["losses"],
                                         out["cpu"]["losses"]))
    return dict(out, steps=CHAIN_DC_STEPS, batch=CHAIN_DC_B,
                loss_gap_max_not_held=gap)


def chain_http_cnn(torch, launch_run) -> dict:
    """``split_cnn_chain3`` over HTTP on ``int8``: two ``serve --role
    stage`` parties in this process (``launch.run.serve_party``, port 0)
    and ``launch.run.main(["train", "--stages", "3", ...])`` against
    them, launch counts reset just before and read just after:
    :func:`chain_per_step` (S 3) each step, exactly; every loss finite,
    the loss falling; the ``[pipeline]`` lines."""
    import contextlib
    import io
    from split_learning_tpu_torch.ops.common import LAUNCHES
    data_dir = os.path.join(REPO, "build", "chip_smoke_chain_data")
    parties = []
    out, err = io.StringIO(), io.StringIO()
    try:
        for i in (1, 2):
            runtime, server, _ = launch_run.serve_party(launch_run.parse_args(
                ["serve", "--role", "stage", "--stage-index", str(i),
                 "--model", "split_cnn_chain3", "--microbatches",
                 str(CHAIN_M), "--device", "cuda", "--host", "127.0.0.1",
                 "--port", "0"]))
            check(runtime is not None, f"serve --role stage {i}: rc {server}")
            parties.append((runtime, server))
        argv = ["train", "--device", "cuda", "--model", "split_cnn_chain3",
                "--stages", "3", "--transport", "http", "--stage-urls",
                ",".join(srv.url for _, srv in parties), "--microbatches",
                str(CHAIN_M), "--compress", "int8", "--dataset", "synthetic",
                "--batch-size", str(CNN_CHAIN_B), "--steps",
                str(CNN_CHAIN_STEPS), "--tracking", "jsonl", "--data-dir",
                data_dir, "--wait-server", str(HTTP_TIMEOUT)]
        LAUNCHES.reset()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = launch_run.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        counts = LAUNCHES.snapshot()
    finally:
        for runtime, server in parties:
            server.stop()
            runtime.close()
    lines = [ln for ln in err.getvalue().splitlines()
             if ln.startswith(("[pipeline]", "[transport]"))]
    print("\n".join(f"[chain] http {ln}" for ln in lines), flush=True)
    check(rc == 0, f"the HTTP chain returned {rc}: {err.getvalue()[-2000:]}")
    per_step = chain_per_step("int8", s=3)
    want = {k: v * CNN_CHAIN_STEPS for k, v in per_step.items()}
    check(counts == want, f"HTTP chain launches {counts}, want {want}")
    losses, ts = _loss_times(data_dir)
    check(len(losses) == CNN_CHAIN_STEPS and all(map(math.isfinite, losses)),
          f"HTTP chain losses {losses}")
    check(statistics.mean(losses[-4:]) < statistics.mean(losses[:4]),
          f"HTTP chain: the loss did not fall: {losses}")
    steady = [(b - a) * 1e3 for a, b in zip(ts[2:], ts[3:])]
    return dict(model="split_cnn_chain3", stages=3, batch=CNN_CHAIN_B,
                microbatches=CHAIN_M, steps=CNN_CHAIN_STEPS, compress="int8",
                launches=counts, launches_per_step={
                    k: v / CNN_CHAIN_STEPS for k, v in counts.items()},
                launches_per_step_predicted=per_step,
                step_ms_median=statistics.median(steady), seconds=secs,
                loss_first=losses[0], loss_last=losses[-1],
                pipeline_lines=lines)


def chain_runs(torch, launch_run, image_rec) -> tuple:
    """Phase 27 (see the module docstring). Returns the record and the
    launch totals of its runs."""
    from split_learning_tpu_torch.data import batches, synthetic
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.ops.common import LAUNCHES
    from split_learning_tpu_torch.runtime import bubble_fraction
    from split_learning_tpu_torch.transport import DensityController
    from split_learning_tpu_torch.utils import Config
    t0 = time.perf_counter()
    ds = synthetic("cifar10", n_train=CHAIN_B * (CHAIN_STEPS
                                                 + CHAIN_PROFILE_STEPS),
                   n_test=8, seed=0)
    data = list(batches(ds.train, CHAIN_B, seed=0, drop_remainder=True))
    kw = dict(model="resnet18_4stage", num_stages=CHAIN_S,
              microbatches=CHAIN_M, batch_size=CHAIN_B, lr=LR)
    rec = {"resnet18_4stage": {}, "wires": {},
           "ideal_bubble": bubble_fraction(CHAIN_M, CHAIN_S)}
    totals, restore = _phase_totals(LAUNCHES)
    try:
        for dtype in ("float32", "bfloat16"):
            plan = get_plan(model="resnet18_4stage", dtype=dtype)
            cfg = Config(transport="device", dtype=dtype, **kw)
            label = f"resnet18_4stage device {dtype}"
            leg, chain = chain_leg(torch, label, plan, cfg, data,
                                   profile=True)
            params = host_params(chain_params(chain))
            chain_close(chain)
            fused = image_rec["resnet18_fused"][dtype]["step_ms_median"]
            leg.update(fused_step_ms_median=fused,
                       over_fused=leg["step_ms_median"] / fused)
            leg["schedules"] = chain_schedules_equal(torch, plan, cfg, data)
            wide = (None if dtype == "float32"
                    else get_plan(model="resnet18_4stage"))
            leg["cpu_twin"] = chain_twin(
                torch, label, plan, cfg, params, data,
                _f32_twin_tol if wide is None else bf16_loss_tol, wide)
            rec["resnet18_4stage"][dtype] = leg
        plan = get_plan(model="resnet18_4stage")
        cfg = Config(transport="local", **kw)
        for mode in ("int8", "topk8"):
            dc = DensityController(window=1) if mode == "topk8" else None
            leg, chain = chain_leg(torch, f"resnet18_4stage local {mode}",
                                   plan, cfg, data, mode, dc,
                                   steps=CHAIN_WIRE_STEPS)
            chain_close(chain)
            if dc is not None:
                leg["densities"] = [r["densities"] for r in
                                    dc.snapshot()["trajectory"]]
            rec["wires"][mode if dc is None else "topk8_auto"] = leg
        rec["wires"]["controller_twin"] = chain_dc_twin(torch, plan, cfg,
                                                        data)
        rec["cnn_chain_http"] = chain_http_cnn(torch, launch_run)
    finally:
        restore()
    rec["card_tests"] = card_test_step(CHAIN_CARD_TEST_FILTER)
    rec["seconds"] = time.perf_counter() - t0
    for dtype, leg in rec["resnet18_4stage"].items():
        shares = [(b["busy_share_forward"], b["busy_share_backward"])
                  for b in leg["bubble"]]
        print(f"[chain] resnet18_4stage {dtype}: {leg['step_ms_median']:.2f}"
              f" ms a step ({leg['over_fused']:.2f}x the fused step's "
              f"{leg['fused_step_ms_median']:.2f}), device idle "
              f"{leg['profile']['device_idle_share']}; hop workers' host "
              f"busy/wall (fwd, bwd) a stage "
              f"{shares} (ideal bubble {rec['ideal_bubble']:.3f})",
              flush=True)
    print(f"[chain] phase 27: {rec['seconds']:.1f} s", flush=True)
    return rec, totals


# --------------------------------------------------------------------- #
# phase 28: observability
# --------------------------------------------------------------------- #
def _mlflow_stub_main() -> int:
    """``chip_smoke.py --mlflow-stub``: phase 28's stdlib MLflow tracking
    server on 127.0.0.1, in a process of its own so that its handler
    threads do not take the trainer's GIL. Serves the REST endpoints the
    port's logger calls, keeps each run's metrics and final status
    (``GET /runs``), prints its port, and runs until terminated."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    runs, exps = {}, {}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            if self.path == "/runs":
                return self._reply(200, runs)
            self._reply(404, {})

        def do_POST(self):
            body = json.loads(self.rfile.read(int(
                self.headers.get("Content-Length", 0))) or b"{}")
            path = self.path.split("/api/2.0/mlflow/", 1)[-1]
            out = {}
            if path == "experiments/get-by-name":
                if body["experiment_name"] not in exps:
                    return self._reply(404, {})
                out = {"experiment": {"experiment_id": exps[
                    body["experiment_name"]]}}
            elif path == "experiments/create":
                exps[body["name"]] = str(len(exps) + 1)
                out = {"experiment_id": exps[body["name"]]}
            elif path == "runs/create":
                rid = f"run{len(runs) + 1}"
                runs[rid] = {"metrics": [], "status": "RUNNING"}
                out = {"run": {"info": {"run_id": rid}}}
            elif path == "runs/log-metric":
                runs[body["run_id"]]["metrics"].append(
                    (body["key"], body["value"], body["step"]))
            elif path == "runs/update":
                runs[body["run_id"]]["status"] = body["status"]
            self._reply(200, out)

        def _reply(self, code, payload):
            data = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    print(srv.server_address[1], flush=True)
    srv.serve_forever()
    return 0


class _MlflowStub:
    """:func:`_mlflow_stub_main` as a subprocess: its URL, its runs
    (``(key, value, step)`` metrics and a status each) and ``close``."""

    def __init__(self):
        import subprocess
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mlflow-stub"],
            stdout=subprocess.PIPE, text=True)
        line = self.proc.stdout.readline()
        if not line.strip().isdigit():
            self.close()
            raise RuntimeError(f"the MLflow stub did not start: {line!r}")
        self.url = f"http://127.0.0.1:{int(line)}"

    @property
    def runs(self) -> dict:
        import urllib.request
        with urllib.request.urlopen(self.url + "/runs",
                                    timeout=HTTP_TIMEOUT) as resp:
            return json.loads(resp.read())

    def close(self):
        self.proc.terminate()
        self.proc.wait(timeout=30)
        self.proc.stdout.close()


class _StepClock:
    """The trainer's own step clock, the same on both sides of (a): the
    ``perf_counter`` reading each time the training loop logs a step's
    loss, taken before the run's logger (``tracking.make_logger``) does
    its own work, whichever logger the flags chose."""

    def __init__(self):
        import split_learning_tpu_torch.tracking as tracking
        self._mod, self._make = tracking, tracking.make_logger
        self.times = []

    def __enter__(self):
        def make(*args, **kw):
            logger = self._make(*args, **kw)
            inner = logger.log_metric

            def log_metric(key, value, step):
                if key == "loss":
                    self.times.append(time.perf_counter())
                return inner(key, value, step)
            logger.log_metric = log_metric
            return logger
        self._mod.make_logger = make
        return self

    def __exit__(self, *exc):
        self._mod.make_logger = self._make


def _trace_kernels(path) -> dict:
    """The device trace's kernel events by phase 28's kernel labels: how
    many events of each, by name fragment."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events
             if e.get("cat") == "kernel" and e.get("ph") == "X"]
    return {label: sum(1 for n in names if any(k in n for k in keys))
            for label, keys in OBS_TRACE_KERNELS.items()}


def _steady_ms(times) -> float:
    return statistics.median((b - a) * 1e3 for a, b in
                             zip(times[3:], times[4:]))


def obs_lm_runs(torch, launch_run, smi) -> tuple:
    """Phase 28 (a): the bf16 AdamW LM through ``launch.run train``, every
    observability flag off and on (OBS_LM_RUNS): losses bit-equal,
    the same launches (exactly phase 18's a step), the MLflow stub's one
    loss a step and a finished run, the device trace naming K1, K5 and
    K6, the flight dump, step_flops and the MFU, the flags' overhead."""
    from split_learning_tpu_torch.data import batches, synthetic_lm
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.ops.common import LAUNCHES
    from split_learning_tpu_torch.runtime import FusedSplitTrainer
    from split_learning_tpu_torch.utils import Config
    from split_learning_tpu_torch.utils.flops import device_peak_flops, mfu
    data_dir = os.path.join(REPO, "build", "chip_smoke_obs_data")
    out_dir = os.path.join(REPO, "build", "chip_smoke_obs")
    os.makedirs(out_dir, exist_ok=True)
    argv = ["train", "--transport", "fused", "--steps", str(OBS_STEPS),
            *_lm_flags(data_dir)]
    stub = _MlflowStub()
    runs = []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for i, label in enumerate(OBS_LM_RUNS):
            files = {k: os.path.join(out_dir, f"lm{i}.{k}")
                     for k in ("trace.json", "flight.json", "profile")}
            flags = (["--tracking", "jsonl"] if label == "off" else [
                "--tracking", "mlflow", "--tracking-uri", stub.url,
                "--trace", files["trace.json"], "--flight",
                files["flight.json"]])
            if label == "on":
                flags += ["--profile-dir", files["profile"]]
            n_runs = len(stub.runs)
            with _StepClock() as clock:
                rc, counts, _, secs = _cli(torch, launch_run, argv + flags)
            check(rc == 0, f"obs LM {label} run {i}: rc {rc}")
            check(len(clock.times) == OBS_STEPS, f"obs LM {label}: "
                  f"{len(clock.times)} loss logs, want {OBS_STEPS}")
            if label == "off":
                losses, _ = _loss_times(data_dir)
            else:
                runs_now = stub.runs
                check(len(runs_now) == n_runs + 1, "one MLflow run a run")
                run = runs_now[f"run{n_runs + 1}"]
                recs = [m for m in run["metrics"] if m[0] == "loss"]
                check([m[2] for m in recs] == list(range(OBS_STEPS))
                      and run["status"] == "FINISHED",
                      f"MLflow stub: loss steps {[m[2] for m in recs]}, "
                      f"status {run['status']}")
                losses = [m[1] for m in recs]
            if label == "on":
                kernels = _trace_kernels(os.path.join(
                    files["profile"], "device_trace.json"))
                check(all(v > 0 for v in kernels.values()),
                      f"device trace kernels {kernels}")
            if label != "off":
                with open(files["flight.json"]) as f:
                    dump = json.load(f)
                check(dump["kind"] == "slt-flight-dump"
                      and dump["reason"] == "exit", "the flight exit dump")
                check(os.path.isfile(files["trace.json"]), "the span trace")
            runs.append(dict(flags=label, losses=losses, launches=counts,
                             step_ms_median=_steady_ms(clock.times),
                             cli_seconds=secs,
                             **({"trace_kernel_events": kernels}
                                if label == "on" else {})))
            print(f"[obs] LM flags {label}: {OBS_STEPS} steps, "
                  f"{runs[-1]['step_ms_median']:.2f} ms a step, launches "
                  f"{counts}", flush=True)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        stub.close()
    want = lm_train_counts(OBS_STEPS, sgd=False)
    totals = {}
    for r in runs:
        check(r["launches"] == want, f"obs LM {r['flags']} launches "
                                     f"{r['launches']}, want {want}")
        for k, v in r["launches"].items():
            totals[k] = totals.get(k, 0) + v
        check(r["losses"] == runs[0]["losses"],
              f"obs LM {r['flags']} losses {r['losses']} != flags off "
              f"{runs[0]['losses']}")
        check(all(map(math.isfinite, r["losses"])), "finite losses")
    # the step's model FLOPs, counted on meta copies: no launch
    plan = get_plan(dtype="bfloat16", **LM)
    cfg = Config(transport="fused", model="transformer_lm", attn="flash",
                 batch_size=TRAIN_B, dtype="bfloat16", **LM_SCHEDULE,
                 **LM_OPTIMS["adamw"])
    ds = synthetic_lm(n_train=TRAIN_B, n_test=TRAIN_B, vocab=LM["vocab"],
                      seq_len=TRAIN_T, seed=0)
    x, y = next(iter(batches(ds.train, TRAIN_B, seed=0)))
    trainer = FusedSplitTrainer(plan, cfg, torch.Generator().manual_seed(0),
                                x, device="cuda")
    LAUNCHES.reset()
    flops = trainer.step_flops(x, y)
    check(LAUNCHES.snapshot() == {}, "step_flops launched a kernel")
    del trainer
    off_ms = statistics.median([r["step_ms_median"] for r in runs
                                if r["flags"] == "off"])
    on_ms = statistics.median([r["step_ms_median"] for r in runs
                               if r["flags"] == "on"])
    noprof_ms = statistics.median([r["step_ms_median"] for r in runs
                                   if r["flags"] == "on_no_profiler"])
    peak = device_peak_flops(0)
    util = mfu(flops / (off_ms / 1e3), peak)
    check(util is not None and 0.0 < util < 1.0, f"MFU {util}")
    print(f"[obs] LM step_flops {flops:.6g} a step; MFU {util:.4f} of "
          f"{peak / 1e12:g} TFLOP/s bf16 at {off_ms:.2f} ms a step ({smi}); "
          f"flags on {on_ms:.2f} ms (+{(on_ms / off_ms - 1) * 100:.1f}%), "
          f"all but the profiler {noprof_ms:.2f} ms", flush=True)
    for r in runs:
        r["losses"] = r["losses"][:3] + ["..."] + r["losses"][-2:]
    return dict(model="transformer_lm", dtype="bfloat16", optimizer="adamw",
                batch=TRAIN_B, seq_len=TRAIN_T, steps=OBS_STEPS,
                step_flops=flops, peak_flops=peak, mfu=util,
                step_ms_flags_off=off_ms, step_ms_flags_on=on_ms,
                step_ms_flags_on_no_profiler=noprof_ms,
                flags_overhead=on_ms / off_ms - 1.0,
                losses_bit_equal=True, launches_per_step={
                    k: v / (OBS_STEPS * len(runs))
                    for k, v in totals.items()},
                runs=runs), totals


def _join_by_trace(client, server, steps) -> int:
    """Every step's client send and server receive of ``/forward_pass``
    carry one trace ID: the (step, trace ID) pairs of the two dumps, one
    a step, equal. Returns the steps joined."""
    def pairs(dump, name, party):
        return sorted((e["step"], e["trace_id"]) for e in dump["events"]
                      if e["name"] == name and e["party"] == party
                      and (e["fields"] or {}).get("path") == "/forward_pass")
    sent = pairs(client, "fl_send", "client")
    got = pairs(server, "fl_recv", "server")
    check([s for s, _ in sent] == list(range(steps))
          and all(t is not None for _, t in sent),
          f"client sends {sent[:4]}... ({len(sent)})")
    check(sent == got, f"trace IDs do not join: client {sent[:3]} server "
                       f"{got[:3]}")
    return len(sent)


def obs_http_runs(torch, launch_run) -> tuple:
    """Phase 28 (b): ``serve --trace --flight --telemetry`` as a subprocess
    and the int8 client with ``--flight --trace`` here: ``/telemetry``
    scraped mid-run until a window holds steps, ``/debug/flight``, the
    server's ``fatal:sigterm`` dump and the client's exit dump joined by
    trace ID, the server's trace with a non-null MFU, and the launches
    of both processes (phase 16's a step)."""
    import re
    import signal
    import urllib.request
    from split_learning_tpu_torch.ops import quantize as qmod
    from split_learning_tpu_torch.ops.common import LAUNCHES
    from split_learning_tpu_torch.ops.cross_entropy import BWD, FWD
    from split_learning_tpu_torch.ops.sgd import NAME as SGD
    out_dir = os.path.join(REPO, "build", "chip_smoke_obs")
    os.makedirs(out_dir, exist_ok=True)
    paths = {k: os.path.join(out_dir, k) for k in (
        "server.trace.json", "server.flight.json", "client.trace.json",
        "client.flight.json")}
    srv = _Serve("obs_serve", "--lr", str(CLI_LR), "--trace",
                 paths["server.trace.json"], "--flight",
                 paths["server.flight.json"], "--telemetry",
                 "--telemetry-interval-s", str(OBS_TEL_INTERVAL_S),
                 "--telemetry-slo-ms", str(OBS_SLO_MS))
    result = {}

    def client():
        LAUNCHES.reset()
        result["rc"] = launch_run.main([
            "train", "--device", "cuda", "--transport", "http",
            "--server-url", srv.url, "--compress", "int8", "--steps",
            str(OBS_HTTP_STEPS), "--lr", str(CLI_LR), "--dataset",
            "synthetic", "--data-dir",
            os.path.join(REPO, "build", "chip_smoke_data"), "--tracking",
            "noop", "--wait-server", "60", "--flight",
            paths["client.flight.json"], "--trace",
            paths["client.trace.json"]])
        result["launches"] = LAUNCHES.snapshot()

    def get(route):
        with urllib.request.urlopen(srv.url + route,
                                    timeout=HTTP_TIMEOUT) as resp:
            return json.loads(resp.read())
    try:
        t = threading.Thread(target=client, daemon=True)
        t0 = time.perf_counter()
        t.start()
        scrapes, window, mid_run = 0, None, False
        while window is None and time.perf_counter() - t0 < 120:
            time.sleep(0.1)
            tel = get("/telemetry")
            scrapes += 1
            # a window past the first step's (its dispatch carries the
            # server's first-call set-up)
            busy = [w for w in tel["windows"]
                    if w["counters"].get("split_steps_total", 0) >= 2
                    and "dispatch" in w["percentiles"]]
            if busy:
                window, mid_run = busy[-1], t.is_alive()
        check(window is not None, "no /telemetry window with steps")
        pct = window["percentiles"]["dispatch"]
        check(pct["p50"] > 0 and pct["p99"] >= pct["p50"],
              f"telemetry percentiles {pct}")
        live = get("/debug/flight")
        check(live["kind"] == "slt-flight-dump" and live["events"],
              "GET /debug/flight")
        t.join(timeout=300)
        check(result.get("rc") == 0, f"obs client rc {result.get('rc')}")
        srv.proc.send_signal(signal.SIGTERM)
        serve_rc = srv.proc.wait(timeout=120)
    finally:
        srv.kill()
    err = open(srv.err_path).read()
    check(serve_rc == -signal.SIGTERM, f"serve exited {serve_rc} on SIGTERM")
    m = re.search(r"kernel launches (\{.*\})", err)
    check(m is not None, f"no server launch line: {err[-1500:]}")
    server_launches = json.loads(m.group(1))
    with open(paths["server.flight.json"]) as f:
        s_dump = json.load(f)
    with open(paths["client.flight.json"]) as f:
        c_dump = json.load(f)
    check(s_dump["reason"] == "fatal:sigterm"
          and c_dump["reason"] == "exit", "the dumps' reasons")
    joined = _join_by_trace(c_dump, s_dump, OBS_HTTP_STEPS)
    with open(paths["server.trace.json"]) as f:
        meta = [e for e in json.load(f) if e["name"] == "mesh_meta"]
    prog = meta[0]["args"]["programs"]["split_step"]
    check(prog["calls"] == OBS_HTTP_STEPS and prog["mfu"] is not None
          and 0 < prog["mfu"] < 1, f"server MFU sidecar {prog}")
    n = OBS_HTTP_STEPS
    check(result["launches"] == {SGD: n, qmod.QUANT: n, qmod.DEQUANT: n},
          f"obs client launches {result['launches']}")
    check(server_launches == {FWD: n, BWD: n, SGD: n, qmod.QUANT: n,
                              qmod.DEQUANT: n},
          f"obs server launches {server_launches}")
    both = dict(result["launches"])
    for k, v in server_launches.items():
        both[k] = both.get(k, 0) + v
    per_step = {k: v / n for k, v in both.items()}
    print(f"[obs] HTTP pair: /telemetry window {window['index']} after "
          f"{scrapes} scrapes (mid-run {mid_run}): "
          f"{window['rates']['split_steps_total']:.1f} steps/s, dispatch "
          f"p50 {pct['p50']:.2f} ms p99 {pct['p99']:.2f} ms; {joined} steps "
          f"joined by trace ID; server split_step MFU {prog['mfu']}; "
          f"launches a step {per_step}", flush=True)
    return dict(steps=n, compress="int8", telemetry_window=window,
                telemetry_scrapes=scrapes, scraped_mid_run=mid_run,
                debug_flight_events=len(live["events"]),
                server_dump_events=len(s_dump["events"]),
                client_dump_events=len(c_dump["events"]),
                steps_joined_by_trace_id=joined, server_programs=meta[0][
                    "args"]["programs"], launches_per_step=per_step,
                client_launches=result["launches"],
                server_launches=server_launches), both


def obs_chain_run(torch, launch_run) -> tuple:
    """Phase 28 (c): ``resnet18_4stage`` on DeviceTransport through the
    CLI with ``--telemetry-port 0 --trace``: the fleet view names a
    bottleneck party, the chain's trace metadata carries each stage's
    MFU (non-null), the launches are phase 27's a step."""
    import contextlib
    import io
    from split_learning_tpu_torch.ops.common import LAUNCHES
    out_dir = os.path.join(REPO, "build", "chip_smoke_obs")
    tr = os.path.join(out_dir, "chain.trace.json")
    err = io.StringIO()
    LAUNCHES.reset()
    with contextlib.redirect_stderr(err):
        rc, counts, out, secs = _cli(torch, launch_run, [
            "train", "--device", "cuda", "--model", "resnet18_4stage",
            "--stages", str(CHAIN_S), "--transport", "device",
            "--microbatches", str(CHAIN_M), "--dataset", "cifar10",
            "--data-dir", _img_data_dir(), "--batch-size", str(CHAIN_B),
            "--steps", str(OBS_CHAIN_STEPS), "--lr", str(LR),
            "--tracking", "noop", "--telemetry-port", "0", "--trace", tr])
    text = err.getvalue()
    print(text[-3000:], end="", flush=True)
    check(rc == 0, f"obs chain rc {rc}")
    check("[telemetry] hub /telemetry on port" in text, "the hub's port")
    fleet = json.loads(text.split("[telemetry] fleet ", 1)[1].splitlines()[0])
    parties = {"hub"} | {f"stage{i}" for i in range(1, CHAIN_S)}
    check(fleet["bottlenecks"] and set(fleet["bottlenecks"]) <= parties
          and fleet["critical_path"], f"fleet view {fleet}")
    with open(tr) as f:
        meta = [e for e in json.load(f) if e["name"] == "stage_meta"]
    stages = meta[0]["args"]["stages"]
    mfus = {s["stage"]: s["mfu"] for s in stages}
    check(sorted(mfus) == list(range(1, CHAIN_S))
          and all(v is not None and 0 < v < 1 for v in mfus.values()),
          f"per-stage MFU {mfus}")
    want = {k: v * OBS_CHAIN_STEPS for k, v in chain_per_step().items()}
    check(counts == want, f"obs chain launches {counts}, want {want}")
    print(f"[obs] chain: bottlenecks {fleet['bottlenecks']}, per-stage MFU "
          f"{mfus}", flush=True)
    return dict(model="resnet18_4stage", steps=OBS_CHAIN_STEPS,
                batch=CHAIN_B, microbatches=CHAIN_M,
                bottlenecks=fleet["bottlenecks"],
                critical_path=fleet["critical_path"], stage_mfu=mfus,
                cli_seconds=secs), counts


def obs_runs(torch, launch_run, smi) -> tuple:
    """Phase 28: (a), (b) and (c) with their launch totals."""
    t0 = time.perf_counter()
    rec, totals = {}, {}
    rec["lm"], counts_a = obs_lm_runs(torch, launch_run, smi)
    rec["http"], counts_b = obs_http_runs(torch, launch_run)
    rec["chain"], counts_c = obs_chain_run(torch, launch_run)
    for c in (counts_a, counts_b, counts_c):
        for k, v in c.items():
            totals[k] = totals.get(k, 0) + v
    rec["seconds"] = time.perf_counter() - t0
    print(f"[obs] phase 28: {rec['seconds']:.1f} s", flush=True)
    return rec, totals


# phase 29: scan-steps, remat, replicas, autoscaling

def _cli_err(torch, launch_run, argv):
    """:func:`_cli` with the run's stderr captured too: ``(rc, counts,
    stdout, stderr, seconds)``."""
    import contextlib
    import io
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc, counts, out, secs = _cli(torch, launch_run, argv)
    return rc, counts, out, err.getvalue(), secs


def _watchdog(dd):
    """The dispatch watchdog on and cleared for one run; the run's
    gauges and violations come from its tracker."""
    dd.force(True)
    dd.install()
    dd.tracker().clear()
    return dd.tracker()


def scan_remat_lm_runs(torch, launch_run) -> tuple:
    """Phase 29 (a) and the LM of (b): the bf16 AdamW LM through the CLI
    stepwise, with ``--scan-steps SCAN_N`` and with ``--remat``, each
    under the dispatch watchdog (a sanctioned host read is counted), and
    the cap of ``--scan-steps`` under ``--checkpoint-every``."""
    from split_learning_tpu_torch.obs import dispatch_debug as dd
    from split_learning_tpu_torch.ops.flash_attention import NAME as FA
    from split_learning_tpu_torch.runtime import checkpoint as ckmod
    data_dir = os.path.join(REPO, "build", "chip_smoke_obs_data")
    argv = ["train", "--transport", "fused", "--steps", str(FLEET_LM_STEPS),
            "--tracking", "jsonl", *_lm_flags(data_dir)]
    n = FLEET_LM_STEPS
    runs = {}
    totals = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for label, extra in (("stepwise", []),
                             ("scan", ["--scan-steps", str(SCAN_N)]),
                             ("remat", ["--remat"])):
            tracker = _watchdog(dd)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with _StepClock() as clock:
                rc, counts, _, secs = _cli(torch, launch_run, argv + extra)
            peak = torch.cuda.max_memory_allocated()
            gauges, violations = tracker.gauges(), list(tracker.violations)
            dd.force(False)
            check(rc == 0, f"fleet LM {label}: rc {rc}")
            losses, _ = _loss_times(data_dir)
            check(len(losses) == n and all(map(math.isfinite, losses)),
                  f"fleet LM {label}: losses {losses}")
            # steps 4..n-1, whole chunks either way: a scanned chunk's
            # losses are logged together after its one read, so its
            # median is a chunk's time over SCAN_N
            every = SCAN_N if label == "scan" else 1
            ts = clock.times[3::every]
            ms = (clock.times[-1] - clock.times[3]) * 1e3 / (n - 4)
            med = statistics.median((b - a) * 1e3 / every
                                    for a, b in zip(ts, ts[1:]))
            runs[label] = dict(losses=losses, launches=counts,
                               step_ms=ms, step_ms_median=med,
                               peak_memory_bytes=peak,
                               cli_seconds=secs, watchdog=gauges,
                               violations=violations)
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
            print(f"[fleet] LM {label}: {n} steps, {ms:.3f} ms a step (median "
                  f"{med:.3f}), peak "
                  f"memory {peak / 2**20:.1f} MiB, launches {counts}, "
                  f"watchdog {gauges}", flush=True)
        # the cap: saves on the --checkpoint-every boundaries
        saves = []
        real_save = ckmod.Checkpointer.save

        def save(self, step, *a, **kw):
            saves.append(step)
            return real_save(self, step, *a, **kw)
        ckmod.Checkpointer.save = save
        try:
            rc, counts, _, err, _ = _cli_err(torch, launch_run, argv + [
                "--scan-steps", str(SCAN_CAP[0]), "--checkpoint-every",
                str(SCAN_CAP[1]), "--checkpoint-dir",
                _ckpt_dir("fleet_scan_cap")])
        finally:
            ckmod.Checkpointer.save = real_save
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        capped = _loss_times(data_dir)[0]
    finally:
        torch.backends.cudnn.deterministic = deterministic
        dd.force(False)
        dd.uninstall()
    warning = (f"[warn] --scan-steps {SCAN_CAP[0]} capped to "
               f"--checkpoint-every {SCAN_CAP[1]} so checkpoint cadence is "
               "preserved")
    cap_line = next((ln for ln in err.splitlines() if "capped" in ln), None)
    print(f"[fleet] {cap_line}; saved steps {saves}", flush=True)
    check(rc == 0 and cap_line == warning, f"the cap: rc {rc}, {cap_line!r}")
    check(saves == list(range(SCAN_CAP[1], n + 1, SCAN_CAP[1])),
          f"the capped run saved at {saves}")
    check(capped == runs["stepwise"]["losses"],
          "the capped scanned run's losses differ from the stepwise run's")
    want = lm_train_counts(n, sgd=False)
    want_remat = dict(want, **{FA: 2 * want[FA]})
    step, scan, remat = runs["stepwise"], runs["scan"], runs["remat"]
    check(step["launches"] == want and scan["launches"] == want,
          f"launches stepwise {step['launches']}, scanned "
          f"{scan['launches']}, want {want}")
    check(remat["launches"] == want_remat,
          f"remat launches {remat['launches']}, want {want_remat}")
    check(scan["losses"] == step["losses"],
          f"scanned losses {scan['losses']} != stepwise {step['losses']}")
    rel = max(abs(a - b) / abs(b) for a, b in
              zip(remat["losses"], step["losses"]))
    check(rel <= REMAT_REL_TOL, f"remat losses {remat['losses']} against "
                                f"{step['losses']}: {rel:.3g} relative")
    for label, r in runs.items():
        check(r["violations"] == [], f"watchdog on LM {label}: "
                                     f"{r['violations']}")
    reads = {k: runs[k]["watchdog"]["expected_d2h_total"] for k in runs}
    check(reads == {"stepwise": n, "scan": n // SCAN_N, "remat": n},
          f"sanctioned host reads {reads}: one a step stepwise, one a "
          f"chunk of {SCAN_N} scanned")
    for r in runs.values():
        r["losses"] = r["losses"][:2] + ["..."] + r["losses"][-2:]
    return dict(
        model="transformer_lm", dtype="bfloat16", optimizer="adamw",
        batch=TRAIN_B, seq_len=TRAIN_T, steps=n, scan_steps=SCAN_N,
        runs=runs, losses_bit_equal_scan=True,
        remat_max_rel_loss_diff=rel, host_reads=reads,
        cap=dict(flags=list(SCAN_CAP), warning=cap_line, saved_steps=saves),
        launches_per_step={label: {k: v / n for k, v in r["launches"].items()}
                           for label, r in runs.items()}), totals


def remat_resnet_runs(torch, launch_run) -> tuple:
    """Phase 29 (b)'s ResNet-18: fused, float32, batch IMG_B, with and
    without ``--remat``: peak memory, step ms, launches and losses."""
    data_dir = _img_data_dir()
    runs, totals = {}, {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for label, extra in (("plain", []), ("remat", ["--remat"])):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            rc, counts, _, secs = _cli(torch, launch_run, [
                "train", "--device", "cuda", "--model", "resnet18",
                "--dataset", "cifar10", "--transport", "fused",
                "--batch-size", str(IMG_B), "--steps", str(REMAT_IMG_STEPS),
                "--tracking", "jsonl", "--data-dir", data_dir, *extra])
            peak = torch.cuda.max_memory_allocated()
            check(rc == 0, f"resnet18 {label}: rc {rc}")
            losses, ts = _loss_times(data_dir)
            check(len(losses) == REMAT_IMG_STEPS
                  and all(map(math.isfinite, losses)),
                  f"resnet18 {label}: losses {losses}")
            ms = statistics.median((b - a) * 1e3
                                   for a, b in zip(ts[3:], ts[4:]))
            runs[label] = dict(losses=losses, launches=counts, step_ms=ms,
                               peak_memory_bytes=peak, cli_seconds=secs)
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
            print(f"[fleet] ResNet-18 {label}: {ms:.3f} ms a step, peak "
                  f"memory {peak / 2**20:.1f} MiB, launches {counts}",
                  flush=True)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    plain, remat = runs["plain"], runs["remat"]
    check(plain["launches"] == remat["launches"],
          f"resnet18 launches {plain['launches']} vs remat "
          f"{remat['launches']}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(remat["losses"],
                                                  plain["losses"]))
    check(rel <= 1e-4, f"resnet18 remat losses {rel:.3g} relative apart")
    check(remat["peak_memory_bytes"] < plain["peak_memory_bytes"],
          "remat did not lower ResNet-18's peak memory")
    for r in runs.values():
        r["losses"] = r["losses"][:2] + ["..."] + r["losses"][-2:]
    return dict(model="resnet18", dtype="float32", batch=IMG_B,
                steps=REMAT_IMG_STEPS, runs=runs,
                max_rel_loss_diff=rel), totals


def replica_http_run(torch, launch_run, handoff: str) -> tuple:
    """Phase 29 (c) in one handoff mode: ``serve --replicas 2
    --replica-sync-every REPL_SYNC`` built by the CLI's ``serve_party``
    in this process (its HTTP server on a thread), REPL_CLIENTS int8
    clients on threads. The first half of the steps, then the replicas
    are bit-equal after the sync; in the second half one replica is
    killed mid-run. Every (client, step) is applied once group-wide, a
    duplicate of a dead replica's client is served the original reply
    byte for byte, and the launches a client step are phase 16's."""
    import threading
    from split_learning_tpu_torch.data import batches, synthetic
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.obs import dispatch_debug as dd
    from split_learning_tpu_torch.obs import flight as obs_flight
    from split_learning_tpu_torch.obs import spans
    from split_learning_tpu_torch.ops.common import LAUNCHES
    from split_learning_tpu_torch.ops.cross_entropy import BWD, FWD
    from split_learning_tpu_torch.ops.sgd import NAME as SGD
    from split_learning_tpu_torch.runtime import (
        ServerRuntime, SplitClientTrainer)
    from split_learning_tpu_torch.transport import HttpTransport, codec
    from split_learning_tpu_torch.utils import Config
    applied = []
    real_serialized = ServerRuntime._serialized

    def serialized(self, activations, labels, step, client_id, *a):
        # only the owner of a step's replay claim gets here: an apply
        applied.append((id(self), client_id, step))
        return real_serialized(self, activations, labels, step, client_id,
                               *a)
    ServerRuntime._serialized = serialized
    tracker = _watchdog(dd)
    rec = obs_flight.enable("chip_smoke")
    seen, undo = _capture_requests()
    runtime = server = None
    try:
        runtime, server, _ = launch_run.serve_party(launch_run.parse_args([
            "serve", "--device", "cuda", "--host", "127.0.0.1", "--port",
            "0", "--lr", str(LR), "--compress", "int8", "--replicas", "2",
            "--replica-sync-every", str(REPL_SYNC), "--handoff", handoff]))
        if handoff == "checkpoint":
            runtime._ckpt_dir = _ckpt_dir(f"fleet_handoff_{handoff}")
        ds = synthetic("mnist", n_train=BATCH * REPL_STEPS, n_test=8, seed=0)
        data = list(batches(ds.train, BATCH, seed=0, drop_remainder=True))
        cfg = Config(transport="http", batch_size=BATCH, lr=LR)
        clients = [SplitClientTrainer(
            get_plan(), cfg, torch.Generator().manual_seed(0),
            HttpTransport(server.url, timeout=HTTP_TIMEOUT,
                          compress="int8"), client_id=c, device="cuda")
            for c in range(REPL_CLIENTS)]
        losses = {c: [] for c in range(REPL_CLIENTS)}
        done = [0]
        done_lock = threading.Lock()

        def drive(steps):
            def one(c):
                for i in steps:
                    x, y = data[(i + c) % len(data)]
                    losses[c].append(clients[c].train_step(x, y, i))
                    with done_lock:
                        done[0] += 1
            threads = [threading.Thread(target=one, args=(c,))
                       for c in range(REPL_CLIENTS)]
            for t in threads:
                t.start()
            return threads

        half = REPL_STEPS // 2
        LAUNCHES.reset()
        for t in drive(range(half)):
            t.join()
        # REPL_CLIENTS * half group steps: the last one synced
        p0, p1 = (r.params for r in runtime.replicas)
        synced = all(torch.equal(p0[k], p1[k]) for k in p0)
        check(synced and runtime.counters()["replica_syncs"]
              == REPL_CLIENTS * half // REPL_SYNC,
              f"replicas not bit-equal after the sync ({handoff})")
        victim = runtime.assignment(0)
        orphans = [c for c in range(REPL_CLIENTS)
                   if runtime.assignment(c) == victim]
        done[0] = 0
        threads = drive(range(half, REPL_STEPS))
        while done[0] < REPL_KILL_AT:
            time.sleep(0.001)
        t_kill = time.perf_counter()
        runtime.kill(victim)
        kill_ms = (time.perf_counter() - t_kill) * 1e3
        for t in threads:
            t.join()
        torch.cuda.synchronize()
        counts = LAUNCHES.snapshot()
        # a duplicate of a dead replica's client, after the handoff: its
        # last step before the kill, re-sent as it was
        dup = None
        on_victim = {(c, st) for rid, c, st in applied
                     if rid == id(runtime.replicas[victim])}
        for path, body, reply in seen:
            req = codec.decode(body)
            if path == "/forward_pass" and (req["client_id"],
                                            req["step"]) in on_victim:
                dup = (path, body, reply, req["client_id"], req["step"])
        check(dup is not None, f"no applied step of the victim's clients "
                               f"{orphans} to re-send")
        n_applied = len(applied)
        status, again = _post(server.url, dup[0], dup[1])
        check(status == 200 and again == dup[2],
              f"the duplicate of client {dup[3]} step {dup[4]} was not "
              f"served the original reply byte for byte ({handoff})")
        check(len(applied) == n_applied, "the duplicate was applied again")
        keys = [(c, s) for _, c, s in applied]
        check(len(keys) == len(set(keys)) == REPL_CLIENTS * REPL_STEPS,
              f"applies {len(keys)} ({len(set(keys))} distinct), want "
              f"{REPL_CLIENTS * REPL_STEPS} once each ({handoff})")
        for c, ls in losses.items():
            check(len(ls) == REPL_STEPS and all(map(math.isfinite, ls)),
                  f"client {c} losses {ls} ({handoff})")
        per_step = {FWD: 1, BWD: 1, SGD: 2, **wire_launches("int8", 2)}
        want = {k: v * REPL_CLIENTS * REPL_STEPS for k, v in per_step.items()}
        check(counts == want, f"replicas {handoff}: launches {counts}, "
                              f"want {want}")
        names = {e["name"] for e in rec.events()}
        need = {spans.FL_ROUTE, spans.FL_REPLICA_DEATH,
                spans.FL_HANDOFF_BEGIN, spans.FL_HANDOFF_COMMIT}
        check(need <= names, f"flight events {sorted(need - names)} missing")
        health = runtime.health()["replicas"]
        ctr = runtime.counters()
        check(ctr["replica_handoffs"] == 1 and ctr["replica_deaths"] == 1
              and health["live"] == [1 - victim],
              f"group after the kill: {health}")
        check(tracker.violations == [],
              f"watchdog on replicas {handoff}: {tracker.violations}")
        out = dict(
            handoff=handoff, clients=REPL_CLIENTS, steps=REPL_STEPS,
            batch=BATCH, compress="int8", sync_every=REPL_SYNC,
            victim=victim, victim_clients=orphans, kill_ms=kill_ms,
            bit_equal_after_sync=synced, duplicate=dict(
                client=dup[3], step=dup[4], byte_equal=True),
            applies=len(keys), launches=counts,
            # measured: the run's counts over its client steps
            launches_per_client_step={
                k: v / (REPL_CLIENTS * REPL_STEPS)
                for k, v in counts.items()},
            launches_per_client_step_predicted=per_step, counters=ctr,
            health_replicas=health, watchdog=tracker.gauges(),
            losses={c: [ls[0], ls[-1]] for c, ls in losses.items()})
        print(f"[fleet] replicas {handoff}: {REPL_CLIENTS} int8 clients x "
              f"{REPL_STEPS} steps over {server.url}, replica {victim} "
              f"killed ({kill_ms:.1f} ms), {ctr['handoff_replay_entries']:.0f}"
              f" replay entries handed off, {ctr['replica_fenced_waits']:.0f}"
              f" fenced waits, {len(keys)} applies, launches {counts}",
              flush=True)
        return out, counts
    finally:
        ServerRuntime._serialized = real_serialized
        undo()
        obs_flight.disable()
        dd.force(False)
        dd.uninstall()
        if server is not None:
            server.stop()
        if runtime is not None:
            runtime.close()


def autoscale_fleet_run(torch) -> tuple:
    """Phase 29 (d): the fleet harness (``runtime/fleet.py``'s runnable
    face) with FLEET_ARGS on the card: at least one scale-up and one
    scale-down, no dropped step, the per-tenant p99s, the watchdog's
    counts (the harness forces it on)."""
    from split_learning_tpu_torch.obs import dispatch_debug as dd
    from split_learning_tpu_torch.ops.common import LAUNCHES
    from split_learning_tpu_torch.runtime import fleet
    LAUNCHES.reset()
    dd.tracker().clear()
    try:
        rc, summary = fleet.run_sim(fleet.parse_args(
            ["--device", "cuda", *FLEET_ARGS]))
    finally:
        dd.uninstall()
    torch.cuda.synchronize()
    counts = LAUNCHES.snapshot()
    block = summary["autoscale"]
    check(rc == 0 and block["scale_ups"] >= 1 and block["scale_downs"] >= 1
          and summary["dropped_steps"] == 0,
          f"fleet: rc {rc}, ups {block['scale_ups']}, downs "
          f"{block['scale_downs']}, dropped {summary['dropped_steps']}")
    # a scale event that raised was counted, not raised, by the pump or
    # the harness's per-step hook: none may have
    check(block["pump_errors"] == 0 and block["step_hook_errors"] == 0,
          f"fleet: failed scale events: pump {block['pump_errors']}, "
          f"step hook {block['step_hook_errors']} "
          f"({block['last_error']})")
    check(summary["dispatch"]["unexpected_d2h_total"] == 0
          and summary["dispatch"]["steady_state_recompiles"] == 0,
          f"watchdog on the fleet: {summary['dispatch']}")
    p99 = {t: row.get("step_p99_ms") for t, row in
           summary["per_tenant"].items()}
    print(f"[fleet] autoscale: {summary['steps_completed']}/"
          f"{summary['steps_expected']} steps, {block['scale_ups']} up / "
          f"{block['scale_downs']} down, peak {block['peak_replicas']} "
          f"replicas, per-tenant step p99 ms {p99}, pooled "
          f"{summary['overall']}", flush=True)
    keep = {k: summary[k] for k in (
        "wall_s", "steps_expected", "steps_completed", "dropped_steps",
        "backpressure_total", "overall", "per_tenant", "utilization",
        "autoscale", "dispatch", "warm_rounds", "compiles_in_run")}
    keep["replication"] = {k: summary["replication"][k] for k in (
        "replica_seconds", "live_replicas", "handoff")}
    keep["flags"] = FLEET_ARGS
    return keep, counts


def watchdog_planted_syncs(torch) -> tuple:
    """Phase 29 (e): the dispatch watchdog on the card. The CNN's fused
    trainer at batch BATCH, 3 steps twice with the watchdog off and once
    on: losses bit-equal and nothing flagged. Then a host sync (``.item()``)
    planted (1) in the trainer's step scope and (2) in a custom
    ``autograd.Function``'s backward between the logits and the loss,
    which PyTorch runs on its autograd device thread unless the scope
    keeps the backward on its own thread: each must count into
    ``unexpected_d2h_total``. The control, recorded and not held: (2)
    again with autograd's multithreading turned back on inside the
    scope."""
    import contextlib
    from split_learning_tpu_torch.data import batches, synthetic
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.obs import dispatch_debug as dd
    from split_learning_tpu_torch.ops.common import LAUNCHES
    from split_learning_tpu_torch.runtime import FusedSplitTrainer
    from split_learning_tpu_torch.utils import Config

    class SyncInBackward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            g.abs().sum().item()  # the planted sync
            return g

    class PlantedPlan:
        def __init__(self, plan):
            self._plan = plan

        def apply(self, params, x):
            return SyncInBackward.apply(self._plan.apply(params, x))

        def __getattr__(self, name):
            return getattr(self._plan, name)

    ds = synthetic("mnist", n_train=BATCH * 3, n_test=8, seed=0)
    data = list(batches(ds.train, BATCH, seed=0, drop_remainder=True))
    cfg = Config(transport="fused", batch_size=BATCH, lr=LR)

    def trainer():
        return FusedSplitTrainer(get_plan(), cfg,
                                 torch.Generator().manual_seed(0), None,
                                 device="cuda")
    LAUNCHES.reset()
    deterministic = torch.backends.cudnn.deterministic
    # cuDNN's weight-gradient algorithms may sum in any order: without
    # this two identical runs part in the last bits
    torch.backends.cudnn.deterministic = True
    try:
        dd.force(False)
        off, off2 = trainer(), trainer()
        losses_off = [off.train_step(x, y) for x, y in data]
        losses_off2 = [off2.train_step(x, y) for x, y in data]
        check(losses_off2 == losses_off,
              f"two watchdog-off runs: {losses_off2} != {losses_off}")
        tracker = _watchdog(dd)
        on = trainer()
        losses_on = [on.train_step(x, y) for x, y in data]
        check(losses_on == losses_off,
              f"watchdog on/off losses {losses_on} != {losses_off}")
        clean = tracker.gauges()
        check(clean["unexpected_d2h_total"] == 0 and not tracker.violations,
              f"watchdog on the clean fused run: {tracker.violations}")
        x, y = data[0]

        def caught(step) -> int:
            before = tracker.unexpected_d2h
            step()
            torch.cuda.synchronize()
            return tracker.unexpected_d2h - before

        real = on._loss_and_grads

        def planted_step(*args):
            loss, grads = real(*args)
            loss.item()  # the planted sync
            return loss, grads
        on._loss_and_grads = planted_step
        in_step = caught(lambda: on.train_step(x, y))
        on._loss_and_grads = real
        plain_plan = on.plan
        on.plan = PlantedPlan(plain_plan)
        in_backward = caught(lambda: on.train_step(x, y))
        real_scope = tracker.scope

        @contextlib.contextmanager
        def scope_device_thread(*a, **kw):
            with real_scope(*a, **kw) as rec:
                with torch.autograd.set_multithreading_enabled(True):
                    yield rec
        tracker.scope = scope_device_thread
        n_flagged = len(tracker.violations)
        try:
            control = caught(lambda: on.train_step(x, y))
            # what else the control's scope saw: K1b left it with the
            # backward, a launch change from the previous step
            control_flags = [v["kind"]
                             for v in tracker.violations[n_flagged:]]
        finally:
            del tracker.scope
            on.plan = plain_plan
        check(in_step >= 1, f"a sync planted in the fused step scope was "
                            f"counted {in_step} times")
        check(in_backward >= 1, f"a sync planted in a custom backward was "
                                f"counted {in_backward} times")
        torch.cuda.synchronize()
        counts = LAUNCHES.snapshot()
    finally:
        torch.backends.cudnn.deterministic = deterministic
        dd.force(False)
        dd.uninstall()
        dd.tracker().clear()
    out = dict(model="split_cnn", batch=BATCH, steps=len(data),
               losses_bit_equal_on_off=True, clean_run=clean,
               caught_in_step_scope=in_step,
               caught_in_custom_backward=in_backward,
               control_backward_on_autograd_device_thread=control,
               control_flags=control_flags)
    print(f"[fleet] watchdog: losses bit-equal on/off, planted syncs "
          f"caught {in_step} in the step scope and {in_backward} in a "
          f"custom backward; control (backward on the autograd device "
          f"thread): {control}, flags {control_flags}", flush=True)
    return out, counts


def fleet_runs(torch, launch_run, smi) -> tuple:
    """Phase 29: (a) to (e) with their launch totals."""
    t0 = time.perf_counter()
    rec, totals = {"card": smi}, {}
    rec["lm"], c_lm = scan_remat_lm_runs(torch, launch_run)
    rec["resnet18_remat"], c_img = remat_resnet_runs(torch, launch_run)
    rec["replicas"] = {}
    parts = [c_lm, c_img]
    for handoff in ("live", "checkpoint"):
        rec["replicas"][handoff], c = replica_http_run(torch, launch_run,
                                                       handoff)
        parts.append(c)
    rec["autoscale"], c_fleet = autoscale_fleet_run(torch)
    parts.append(c_fleet)
    rec["watchdog"], c_dd = watchdog_planted_syncs(torch)
    parts.append(c_dd)
    for c in parts:
        for k, v in c.items():
            totals[k] = totals.get(k, 0) + v
    rec["seconds"] = time.perf_counter() - t0
    print(f"[fleet] phase 29: {rec['seconds']:.1f} s", flush=True)
    return rec, totals


# --------------------------------------------------------------------- #
# phase 30: the device mesh

def mesh_devices(torch, n: int) -> list:
    """The placements of an n-rank mesh this machine offers: n virtual
    ranks on card 0 always, and n distinct cards where it has them."""
    out = [("virtual", [torch.device("cuda", 0)] * n)]
    if torch.cuda.device_count() >= n:
        out.append(("distinct", [torch.device("cuda", i) for i in range(n)]))
    return out


def _live_pairs(t: int, causal: bool, strict: bool) -> int:
    """(query, key) pairs a block computes: its work on this data."""
    if not causal:
        return t * t
    return t * (t - 1) // 2 if strict else t * (t + 1) // 2


def mesh_flash_checks(torch, dev, gen, bw, flash_peak,
                      shapes=MESH_FA_SHAPES) -> dict:
    """Phase 30's kernel rows (and phase 31's, at :data:`TP_FA_SHAPES`):
    K5 and K6 (with an LSE cotangent, as the ring's merge gives them) at
    ``shapes`` (default :data:`MESH_FA_SHAPES`) in bf16 against
    their plain versions (phase 6's and 9's tolerances), with their
    device ms beside the plain versions', SDPA's (a boolean mask for the
    strict block; its backward through autograd) and the bound (the
    live pairs: 4 T x T x D products a forward, 10 a backward)."""
    import torch.nn.functional as F
    from split_learning_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_plain, flash_attention_with_lse_plain,
        flash_bwd_cuda, flash_fwd_cuda)
    out = {}
    name = "bfloat16"
    for label, shape, causal, strict, with_g_lse in shapes:
        b, t, h, d = shape
        n, rows = math.prod(shape), b * t * h
        pairs = b * h * _live_pairs(t, causal, strict)
        q, k, v, do = (torch.randn(shape, device=dev, generator=gen)
                       .to(torch.bfloat16) for _ in range(4))
        g_lse = (torch.randn((b, t, h), device=dev, generator=gen)
                 if with_g_lse else None)
        o, lse = flash_fwd_cuda(q, k, v, causal, strict)
        grads = flash_bwd_cuda(q, k, v, o, lse, do, g_lse, causal, strict)
        torch.cuda.synchronize()
        o_p, lse_p = flash_attention_with_lse_plain(q, k, v, causal, strict)
        e_o = (o.float() - o_p.float()).abs().max().item()
        e_l = (lse - lse_p).abs().max().item()
        tol_o, tol_l = FA_TOL[name]
        check(e_o <= tol_o and e_l <= tol_l,
              f"K5 at {label}: O err {e_o}, LSE err {e_l}")
        e_g = 0.0
        for got, want in zip(grads, flash_attention_bwd_plain(
                q, k, v, o, lse, do, g_lse, causal, strict)):
            err = (got.float() - want.float()).abs().max().item()
            scale = max(1.0, want.float().abs().max().item())
            check(got.dtype == want.dtype and err <= FA_BWD_TOL[name] * scale,
                  f"K6 at {label}: err {err} (scale {scale})")
            e_g = max(e_g, err)
        f_ms, f_by = bound(4 * n * 2 + 4 * rows, 4 * pairs * d, bw,
                           flash_peak[name])
        b_ms, b_by = bound(8 * n * 2 + 8 * rows, 10 * pairs * d, bw,
                           flash_peak[name])
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        sdpa_kw = {}
        if strict:
            ar = torch.arange(t, device=dev)
            sdpa_kw["attn_mask"] = ar[:, None] > ar[None, :]
        elif causal:
            sdpa_kw["is_causal"] = True
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw)
        do_t = do.transpose(1, 2)
        out[label] = dict(
            shape=list(shape), dtype=name, causal=causal, strict=strict,
            g_lse=with_g_lse, live_pairs=pairs,
            fwd=dict(
                ms=device_ms(torch, lambda: flash_fwd_cuda(q, k, v, causal,
                                                           strict)),
                plain_ms=device_ms(
                    torch, lambda: flash_attention_with_lse_plain(
                        q, k, v, causal, strict), reps=20),
                library_ms=device_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, **sdpa_kw)),
                bound_ms=f_ms, bound_by=f_by, max_abs_err=e_o,
                max_abs_err_lse=e_l),
            bwd=dict(
                ms=device_ms(torch, lambda: flash_bwd_cuda(
                    q, k, v, o, lse, do, g_lse, causal, strict), reps=50),
                plain_ms=device_ms(
                    torch, lambda: flash_attention_bwd_plain(
                        q, k, v, o, lse, do, g_lse, causal, strict),
                    reps=20),
                library_ms=device_ms(
                    torch, lambda: torch.autograd.grad(
                        lib_out, (qt, kt, vt), do_t, retain_graph=True),
                    reps=50),
                bound_ms=b_ms, bound_by=b_by, max_abs_err=e_g))
        del q, k, v, do, o, lse, grads, qt, kt, vt, lib_out, do_t, o_p
    print("[k5/k6] at these shapes (bf16), ms kernel / SDPA: "
          + "; ".join(f"{key} fwd {r['fwd']['ms']:.4f} / "
                      f"{r['fwd']['library_ms']:.4f}, bwd "
                      f"{r['bwd']['ms']:.4f} / {r['bwd']['library_ms']:.4f}"
                      for key, r in out.items()), flush=True)
    return out


def _lm_mesh_cfg():
    from split_learning_tpu_torch.utils import Config
    return Config(transport="fused", model="transformer_lm",
                  batch_size=TRAIN_B, dtype="bfloat16", **LM_SCHEDULE,
                  **LM_OPTIMS["adamw"])


def mesh_lm_leg(torch, label, attn, n, devices, tr_data, init,
                ref) -> tuple:
    """One LM run on an n-rank seq mesh: MESH_LM_STEPS steps, each from
    the meshed trainer's state on both it and the unsharded flash
    trainer ``ref`` (one state, two step functions): losses within two
    bf16 ulps, launches a step, step ms both ways. Returns the record,
    the trainer and its mesh."""
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.ops.common import LAUNCHES
    from split_learning_tpu_torch.parallel.mesh import make_mesh
    from split_learning_tpu_torch.runtime import FusedSplitTrainer
    mesh = make_mesh(seq_parallel=n, devices=devices)
    plan = get_plan(dtype="bfloat16", mesh=mesh, **dict(LM, attn=attn))
    cfg = _lm_mesh_cfg().replace(seq_parallel=n)
    trainer = FusedSplitTrainer(plan, cfg, init, tr_data[0][0], mesh=mesh)
    losses, ref_losses, ms, ref_ms, per_step = [], [], [], [], []
    for x, y in tr_data[:MESH_LM_STEPS]:
        ref.restore_states(trainer.export_states())
        torch.cuda.synchronize()
        LAUNCHES.reset()
        t = time.perf_counter()
        losses.append(trainer.train_step(x, y))
        ms.append((time.perf_counter() - t) * 1e3)
        per_step.append(LAUNCHES.snapshot())
        LAUNCHES.reset()
        t = time.perf_counter()
        ref_losses.append(ref.train_step(x, y))
        ref_ms.append((time.perf_counter() - t) * 1e3)
    gaps = [abs(a - b) for a, b in zip(losses, ref_losses)]
    tols = [bf16_loss_tol(b) for b in ref_losses]
    print(f"[mesh] {label}: losses {losses} against unsharded flash "
          f"{ref_losses} (gaps {gaps}, tolerance two bf16 ulps {tols}); "
          f"launches a step {per_step[-1]}; step {statistics.median(ms[1:]):.3f}"
          f" ms against {statistics.median(ref_ms[1:]):.3f}", flush=True)
    check(all(g <= tol for g, tol in zip(gaps, tols)),
          f"{label}: losses {losses} against {ref_losses}")
    check(all(math.isfinite(v) for v in losses), f"{label}: finite losses")
    return dict(attn=attn, seq=n, placement=sorted({str(d) for d in
                                                    devices}),
                losses=losses, ref_losses=ref_losses, loss_gaps=gaps,
                loss_tol=tols, launches_per_step=per_step,
                step_ms_median=statistics.median(ms[1:]),
                ref_step_ms_median=statistics.median(ref_ms[1:]),
                step_ms=ms, ref_step_ms=ref_ms), trainer, mesh


def mesh_lm_runs(torch, tr_data) -> dict:
    """Phase 30 (a) and (b): ring_flash on a seq MESH_SEQ mesh (striped:
    the launches a step of 3 blocks x n ranks x n hops) and Ulysses at
    seq MESH_ULY on K5/K6 (``block_impl="auto"``: the H100 speed rule,
    ``FLASH_SPEED_T``, picks flash at this T), each against the
    unsharded flash trainer; K1 once a seq rank;
    ring_flash's CPU twin; one attention call at the contiguous layout
    (3 x 10 launches a step) and at the striped."""
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.ops.common import LAUNCHES
    from split_learning_tpu_torch.ops.cross_entropy import BWD, FWD
    from split_learning_tpu_torch.ops.flash_attention import (
        BWD_NAMES, FLASH_SPEED_T, NAME as FA)
    from split_learning_tpu_torch.ops.ring_attention import ring_attention
    from split_learning_tpu_torch.parallel.mesh import make_mesh
    from split_learning_tpu_torch.runtime import FusedSplitTrainer
    init = get_plan(dtype="bfloat16", **LM).init(
        torch.Generator().manual_seed(0), torch.zeros(1))
    ref = FusedSplitTrainer(get_plan(dtype="bfloat16", **LM), _lm_mesh_cfg(),
                            init, tr_data[0][0], device="cuda")
    rec = {"ring_flash": {}, "ulysses": {}}

    def want(k5, n):
        # K1 once a seq rank, on its B*T/n rows
        return {FA: k5, **{nm: k5 for nm in BWD_NAMES}, FWD: n, BWD: n}

    for placement, devs in mesh_devices(torch, MESH_SEQ):
        leg, trainer, mesh = mesh_lm_leg(
            torch, f"ring_flash seq {MESH_SEQ} ({placement})", "ring_flash",
            MESH_SEQ, devs, tr_data, init, ref)
        w = want(N_BLOCKS * MESH_SEQ * MESH_SEQ, MESH_SEQ)
        check(all(c == w for c in leg["launches_per_step"]),
              f"ring_flash launches {leg['launches_per_step']}, want {w}")
        rec["ring_flash"][placement] = leg
        if placement == "virtual":
            ring_trainer, ring_mesh = trainer, mesh
    # the CPU twin: TWIN_ROWS rows, each step from the card's state
    rows = [(x[:TWIN_ROWS], y[:TWIN_ROWS]) for x, y in tr_data[:MESH_TWIN_STEPS]]
    cpu_mesh = make_mesh(seq_parallel=MESH_SEQ, device="cpu")
    twin_cfg = _lm_mesh_cfg().replace(batch_size=TWIN_ROWS,
                                      seq_parallel=MESH_SEQ)
    card = FusedSplitTrainer(get_plan(dtype="bfloat16", mesh=ring_mesh,
                                      **dict(LM, attn="ring_flash")),
                             twin_cfg, init, rows[0][0], mesh=ring_mesh)
    cpu = FusedSplitTrainer(get_plan(dtype="bfloat16", mesh=cpu_mesh,
                                     **dict(LM, attn="ring_flash")),
                            twin_cfg, init, rows[0][0], mesh=cpu_mesh)
    card_l, cpu_l = [], []
    for x, y in rows:
        cpu.restore_states(card.export_states())
        card_l.append(card.train_step(x, y))
        cpu_l.append(cpu.train_step(x, y))
    gaps = [abs(a - b) for a, b in zip(card_l, cpu_l)]
    tols = [bf16_loss_tol(b) for b in cpu_l]
    check(all(g <= t for g, t in zip(gaps, tols)),
          f"ring_flash CPU twin: card {card_l} vs cpu {cpu_l}")
    print(f"[mesh] ring_flash CPU twin on {TWIN_ROWS} rows x "
          f"{len(rows)} steps: card {card_l}, cpu {cpu_l} (gaps {gaps}, "
          f"tolerance {tols})", flush=True)
    rec["ring_flash"]["cpu_twin"] = dict(card=card_l, cpu=cpu_l, gaps=gaps,
                                         tol=tols, rows=TWIN_ROWS)
    del card, cpu, ring_trainer
    # one attention call at the LM's shapes: contiguous and striped
    q, k, v = (torch.randn((TRAIN_B, TRAIN_T, LM["num_heads"],
                            LM["d_model"] // LM["num_heads"]),
                           device=ring_mesh.device(),
                           dtype=torch.bfloat16).requires_grad_(True)
               for _ in range(3))
    calls = {}
    for layout in ("contiguous", "striped"):
        def call():
            o = ring_attention(q, k, v, mesh=ring_mesh, causal=True,
                               block_impl="flash", layout=layout)
            torch.autograd.grad(o.float().sum(), (q, k, v))
        call()
        torch.cuda.synchronize()
        LAUNCHES.reset()
        call()
        torch.cuda.synchronize()
        counts = LAUNCHES.snapshot()
        calls[layout] = dict(launches_per_call=counts,
                             host_ms=host_ms(torch, call, reps=5))
    n = MESH_SEQ
    for layout, k5 in (("contiguous", n * (n + 1) // 2),
                       ("striped", n * n)):
        got = calls[layout]["launches_per_call"]
        check(got == {FA: k5, **{nm: k5 for nm in BWD_NAMES}},
              f"{layout} ring call launches {got}, want {k5} of each")
    print(f"[mesh] one causal ring_flash call at seq {n}, [{TRAIN_B}, "
          f"{TRAIN_T}, {LM['num_heads']}, {LM['d_model'] // LM['num_heads']}]"
          f" bf16, forward and backward: {calls}", flush=True)
    rec["ring_flash"]["one_call"] = calls
    del q, k, v
    # (b) Ulysses on K5/K6 at seq MESH_ULY: the speed rule picks flash
    for placement, devs in mesh_devices(torch, MESH_ULY):
        leg, _, _ = mesh_lm_leg(
            torch, f"ulysses seq {MESH_ULY} ({placement})", "ulysses",
            MESH_ULY, devs, tr_data, init, ref)
        w = want(N_BLOCKS * MESH_ULY, MESH_ULY)
        check(all(c == w for c in leg["launches_per_step"]),
              f"ulysses launches {leg['launches_per_step']}, want {w}")
        rec["ulysses"][placement] = dict(leg, flash_speed_t=FLASH_SPEED_T)
    return rec


def mesh_cnn_runs(torch) -> dict:
    """Phase 30 (c): the fused CNN at batch BATCH on a data MESH_DATA
    mesh for MESH_CNN_STEPS steps, each from the meshed trainer's state
    on both it and the unsharded trainer: losses within MESH_CNN_RTOL,
    the replicas bit-equal after every step, K1 and K2 a step."""
    from split_learning_tpu_torch.data import batches, synthetic
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.ops.common import LAUNCHES
    from split_learning_tpu_torch.parallel.mesh import make_mesh
    from split_learning_tpu_torch.runtime import FusedSplitTrainer
    from split_learning_tpu_torch.utils import Config
    ds = synthetic("mnist", n_train=BATCH * MESH_CNN_STEPS, n_test=8, seed=1)
    data = list(batches(ds.train, BATCH, seed=1, drop_remainder=True))
    init = get_plan().init(torch.Generator().manual_seed(0), torch.zeros(1))
    cfg = Config(transport="fused", batch_size=BATCH, lr=LR)
    rec = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for placement, devs in mesh_devices(torch, MESH_DATA):
            mesh = make_mesh(num_clients=MESH_DATA, devices=devs)
            trainer = FusedSplitTrainer(
                get_plan(), cfg.replace(num_clients=MESH_DATA), init,
                data[0][0], mesh=mesh)
            ref = FusedSplitTrainer(get_plan(), cfg, init, data[0][0],
                                    device="cuda")
            losses, ref_losses, per_step, ms = [], [], [], []
            for x, y in data:
                ref.restore_states(trainer.export_states())
                torch.cuda.synchronize()
                LAUNCHES.reset()
                t = time.perf_counter()
                losses.append(trainer.train_step(x, y))
                ms.append((time.perf_counter() - t) * 1e3)
                per_step.append(LAUNCHES.snapshot())
                LAUNCHES.reset()
                ref_losses.append(ref.train_step(x, y))
                first = trainer.states[0].params
                for d in trainer.rows[1:]:
                    for a, b in zip(first, trainer.states[d].params):
                        check(all(torch.equal(a[k], b[k]) for k in a),
                              f"data replica {d} differs from replica 0")
            rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
            print(f"[mesh] CNN data {MESH_DATA} ({placement}): "
                  f"{len(data)} steps, losses {losses[0]:.6f} -> "
                  f"{losses[-1]:.6f}, max relative gap to the unsharded "
                  f"step {rel:.3g}, replicas bit-equal after every step, "
                  f"launches a step {per_step[-1]}, step "
                  f"{statistics.median(ms[1:]):.3f} ms", flush=True)
            check(rel <= MESH_CNN_RTOL, f"CNN data axis: {losses} against "
                                        f"{ref_losses}")
            rec[placement] = dict(
                data=MESH_DATA, steps=len(data), losses=losses,
                ref_losses=ref_losses, max_rel_gap=rel,
                replicas_bit_equal=True, launches_per_step=per_step[-1],
                step_ms_median=statistics.median(ms[1:]),
                placement=sorted({str(d) for d in devs}))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return rec


def mesh_pipeline_runs(torch) -> dict:
    """Phase 30 (d): ``PipelinedTrainer`` with resnet18_4stage at batch
    MESH_PIPE_B, M MESH_PIPE_M, on MESH_STAGES pipe ranks, float32; each
    step from its state on it and on ``FusedSplitTrainer`` at the same
    microbatches: losses within JAX's bar (MESH_PIPE_TOL)."""
    from split_learning_tpu_torch.data import batches, synthetic
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.ops.common import LAUNCHES
    from split_learning_tpu_torch.parallel.mesh import make_mesh
    from split_learning_tpu_torch.parallel.pipeline import PipelinedTrainer
    from split_learning_tpu_torch.runtime import FusedSplitTrainer
    from split_learning_tpu_torch.utils import Config
    ds = synthetic("cifar10", n_train=MESH_PIPE_B * MESH_PIPE_STEPS,
                   n_test=8, seed=2)
    data = list(batches(ds.train, MESH_PIPE_B, seed=2, drop_remainder=True))
    plan = get_plan(model="resnet18_4stage")
    init = plan.init(torch.Generator().manual_seed(0), torch.zeros(1))
    cfg = Config(transport="fused", model="resnet18_4stage",
                 batch_size=MESH_PIPE_B, microbatches=MESH_PIPE_M, lr=LR)
    rec = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for placement, devs in mesh_devices(torch, MESH_STAGES):
            pipe = PipelinedTrainer(plan, cfg.replace(transport="pipeline"),
                                    init, data[0][0],
                                    make_mesh(num_stages=MESH_STAGES,
                                              devices=devs))
            fused = FusedSplitTrainer(plan, cfg, init, data[0][0],
                                      device="cuda")
            losses, ref, ms, ref_ms, per_step = [], [], [], [], []
            for x, y in data:
                fused.restore_states(pipe.export_states())
                torch.cuda.synchronize()
                LAUNCHES.reset()
                t = time.perf_counter()
                losses.append(pipe.train_step(x, y))
                ms.append((time.perf_counter() - t) * 1e3)
                per_step.append(LAUNCHES.snapshot())
                LAUNCHES.reset()
                t = time.perf_counter()
                ref.append(fused.train_step(x, y))
                ref_ms.append((time.perf_counter() - t) * 1e3)
            rtol, atol = MESH_PIPE_TOL
            ok = all(abs(a - b) <= atol + rtol * abs(b)
                     for a, b in zip(losses, ref))
            print(f"[mesh] resnet18_4stage GPipe, {MESH_STAGES} pipe ranks "
                  f"({placement}), batch {MESH_PIPE_B}, M {MESH_PIPE_M}: "
                  f"losses {losses} against the fused trainer's {ref}; "
                  f"launches a step {per_step[-1]}; step "
                  f"{statistics.median(ms[1:]):.3f} ms against "
                  f"{statistics.median(ref_ms[1:]):.3f}", flush=True)
            check(ok, f"pipeline losses {losses} against fused {ref} "
                      f"(rtol {rtol}, atol {atol})")
            rec[placement] = dict(
                losses=losses, fused_losses=ref, tol=list(MESH_PIPE_TOL),
                launches_per_step=per_step[-1],
                step_ms_median=statistics.median(ms[1:]),
                fused_step_ms_median=statistics.median(ref_ms[1:]),
                placement=sorted({str(d) for d in devs}))
            del pipe, fused
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return rec


def mesh_cli_runs(torch, launch_run) -> dict:
    """Phase 30 (e): ``train --attn ring_flash`` with no seq axis warns
    as JAX does and runs K5/K6 once a block; ``--seq-parallel MESH_SEQ``
    with fewer cards than that exits 2 with the mesh message."""
    data_dir = os.path.join(REPO, "build", "chip_smoke_obs_data")
    flags = _lm_flags(data_dir)
    flags[flags.index("--attn") + 1] = "ring_flash"
    argv = ["train", "--transport", "fused", "--steps", str(MESH_CLI_STEPS),
            "--tracking", "noop", *flags]
    rc, counts, _, err, secs = _cli_err(torch, launch_run, argv)
    warning = ("[warn] --attn 'ring_flash' runs as the single-device flash "
               "kernel: no 'seq' mesh axis (pass --seq-parallel > 1 to "
               "shard the sequence)")
    check(rc == 0 and warning in err.splitlines(),
          f"ring_flash without a seq axis: rc {rc}, stderr {err[-600:]}")
    want = lm_train_counts(MESH_CLI_STEPS, sgd=False)
    check(counts == want, f"ring_flash CLI launches {counts}, want {want}")
    rc2, counts2, _, err2, _ = _cli_err(torch, launch_run,
                                        argv + ["--seq-parallel",
                                                str(MESH_SEQ)])
    cards = torch.cuda.device_count()
    if cards < MESH_SEQ:
        msg = (f"[error] mesh needs {MESH_SEQ} devices (1 clients x 1 "
               f"stages x 1 model shards x {MESH_SEQ} seq shards), only "
               f"{cards} available")
        check(rc2 == 2 and msg in err2.splitlines(),
              f"--seq-parallel {MESH_SEQ} on {cards} card(s): rc {rc2}, "
              f"{err2[-600:]}")
    else:
        check(rc2 == 0, f"--seq-parallel {MESH_SEQ}: rc {rc2}")
    print(f"[mesh] CLI: {warning!r}, launches {counts} in "
          f"{MESH_CLI_STEPS} steps; --seq-parallel {MESH_SEQ} on {cards} "
          f"card(s): rc {rc2}", flush=True)
    return dict(warning=warning, launches=counts, steps=MESH_CLI_STEPS,
                cli_seconds=secs, seq_parallel_rc=rc2, cards=cards)


def mesh_runs(torch, launch_run, smi, tr_data) -> tuple:
    """Phase 30: (a) to (e) with their launch totals."""
    from split_learning_tpu_torch.ops.common import LAUNCHES
    t0 = time.perf_counter()
    rec = {"card": smi, "cards": torch.cuda.device_count()}
    LAUNCHES.reset()   # the kernel checks' launches stay out of the totals
    totals, restore = _phase_totals(LAUNCHES)
    try:
        rec["lm"] = mesh_lm_runs(torch, tr_data)
        rec["cnn_data"] = mesh_cnn_runs(torch)
        rec["pipeline"] = mesh_pipeline_runs(torch)
        rec["cli"] = mesh_cli_runs(torch, launch_run)
    finally:
        restore()
    rec["seconds"] = time.perf_counter() - t0
    print(f"[mesh] placements: virtual ranks on cuda:0"
          + (" and distinct cards" if rec["cards"] >= MESH_SEQ else
             f" only ({rec['cards']} card)"), flush=True)
    print(f"[mesh] phase 30: {rec['seconds']:.1f} s", flush=True)
    return rec, totals


# --------------------------------------------------------------------- #
# phase 31: the model axis (tensor parallelism)

def _tp_devices(torch, n: int) -> list:
    """n virtual ranks on card 0 (the machine reports one card)."""
    return [torch.device("cuda", 0)] * n


class _CudaRanks:
    """``SLT_CUDA_RANKS`` set for a command-line run (``parallel/mesh.py``:
    the ranks a process offers over its cards), restored after."""

    def __init__(self, n: int) -> None:
        self.n = n

    def __enter__(self):
        self.prev = os.environ.get("SLT_CUDA_RANKS")
        os.environ["SLT_CUDA_RANKS"] = str(self.n)
        return self

    def __exit__(self, *exc):
        if self.prev is None:
            os.environ.pop("SLT_CUDA_RANKS", None)
        else:
            os.environ["SLT_CUDA_RANKS"] = self.prev
        return False


def _whole_bytes(params) -> int:
    return sum(v.numel() * v.element_size() for st in params
               for v in st.values())


def _tp_want(k5: int, rows: int = 1, sgd: int = 0) -> dict:
    from split_learning_tpu_torch.ops.cross_entropy import BWD, FWD
    from split_learning_tpu_torch.ops.flash_attention import (
        BWD_NAMES, NAME as FA)
    from split_learning_tpu_torch.ops.sgd import NAME as SGD
    want = {FWD: rows, BWD: rows}
    if k5:
        want.update({FA: k5, **{nm: k5 for nm in BWD_NAMES}})
    if sgd:
        want[SGD] = sgd
    return want


def tp_lm_runs(torch, launch_run, tr_data) -> dict:
    """Phase 31 (a): the bf16 AdamW LM at ``model`` TP_MODEL. Through
    ``train --model-parallel`` (the user's entry point) for TP_CLI_STEPS
    steps: K5 and each K6 launch once a rank and block, K1 once, K2 none,
    a step. Then in this process TP_LM_STEPS steps, each from the sharded
    trainer's state on it and on the unsharded trainer (losses within two
    bf16 ulps, step ms both ways), per-rank parameter bytes against the
    whole, and the CPU twin."""
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.ops.common import LAUNCHES
    from split_learning_tpu_torch.parallel.mesh import make_mesh
    from split_learning_tpu_torch.runtime import FusedSplitTrainer
    want = _tp_want(N_BLOCKS * TP_MODEL)
    data_dir = os.path.join(REPO, "build", "chip_smoke_obs_data")
    argv = ["train", "--transport", "fused", "--steps", str(TP_CLI_STEPS),
            "--tracking", "noop", *_lm_flags(data_dir), "--model-parallel",
            str(TP_MODEL)]
    with _CudaRanks(TP_MODEL):
        rc, counts, _, err, secs = _cli_err(torch, launch_run, argv)
    check(rc == 0, f"train --model-parallel {TP_MODEL}: rc {rc}, "
                   f"{err[-1500:]}")
    want_cli = {k: v * TP_CLI_STEPS for k, v in want.items()}
    check(counts == want_cli,
          f"--model-parallel CLI launches {counts}, want {want_cli}")
    print(f"[tp] train --model-parallel {TP_MODEL} (CLI, bf16 AdamW LM): "
          f"rc 0, launches {counts} in {TP_CLI_STEPS} steps, {secs:.1f} s",
          flush=True)
    rec = dict(cli=dict(rc=rc, launches=counts, steps=TP_CLI_STEPS,
                        seconds=secs))
    plan = get_plan(dtype="bfloat16", **LM)
    init = plan.init(torch.Generator().manual_seed(0), torch.zeros(1))
    cfg = _lm_mesh_cfg()
    ref = FusedSplitTrainer(plan, cfg, init, tr_data[0][0], device="cuda")
    mesh = make_mesh(model_parallel=TP_MODEL,
                     devices=_tp_devices(torch, TP_MODEL))
    trainer = FusedSplitTrainer(plan, cfg.replace(model_parallel=TP_MODEL),
                                init, tr_data[0][0], mesh=mesh)
    losses, ref_losses, ms, ref_ms, per_step = [], [], [], [], []
    for x, y in tr_data[:TP_LM_STEPS]:
        ref.restore_states(trainer.export_states())
        torch.cuda.synchronize()
        LAUNCHES.reset()
        t = time.perf_counter()
        losses.append(trainer.train_step(x, y))
        ms.append((time.perf_counter() - t) * 1e3)
        per_step.append(LAUNCHES.snapshot())
        LAUNCHES.reset()
        t = time.perf_counter()
        ref_losses.append(ref.train_step(x, y))
        ref_ms.append((time.perf_counter() - t) * 1e3)
    gaps = [abs(a - b) for a, b in zip(losses, ref_losses)]
    tols = [bf16_loss_tol(b) for b in ref_losses]
    rank_bytes = trainer.state.rank_bytes()[0]
    whole = _whole_bytes(init)
    share = max(rank_bytes) / whole
    print(f"[tp] LM model {TP_MODEL} (virtual ranks): losses {losses} "
          f"against unsharded {ref_losses} (gaps {gaps}, tolerance {tols}); "
          f"launches a step {per_step[-1]}; per-rank param bytes "
          f"{rank_bytes} of {whole} ({share:.4f}); step "
          f"{statistics.median(ms[1:]):.3f} ms against "
          f"{statistics.median(ref_ms[1:]):.3f}", flush=True)
    check(all(g <= tol for g, tol in zip(gaps, tols)),
          f"TP LM: losses {losses} against {ref_losses}")
    check(all(c == want for c in per_step),
          f"TP LM launches {per_step}, want {want}")
    check(share <= TP_LM_BYTES_BAR, f"TP LM per-rank bytes {share}")
    # the CPU twin: TWIN_ROWS rows, each step from the card's state
    rows = [(x[:TWIN_ROWS], y[:TWIN_ROWS])
            for x, y in tr_data[:TP_TWIN_STEPS]]
    twin_cfg = cfg.replace(batch_size=TWIN_ROWS, model_parallel=TP_MODEL)
    card = FusedSplitTrainer(plan, twin_cfg, init, rows[0][0], mesh=mesh)
    cpu = FusedSplitTrainer(plan, twin_cfg, init, rows[0][0],
                            mesh=make_mesh(model_parallel=TP_MODEL,
                                           device="cpu"))
    card_l, cpu_l = [], []
    for x, y in rows:
        cpu.restore_states(card.export_states())
        card_l.append(card.train_step(x, y))
        cpu_l.append(cpu.train_step(x, y))
    twin_gaps = [abs(a - b) for a, b in zip(card_l, cpu_l)]
    twin_tols = [bf16_loss_tol(b) for b in cpu_l]
    check(all(g <= t for g, t in zip(twin_gaps, twin_tols)),
          f"TP LM CPU twin: card {card_l} vs cpu {cpu_l}")
    print(f"[tp] LM CPU twin on {TWIN_ROWS} rows x {len(rows)} steps: card "
          f"{card_l}, cpu {cpu_l} (gaps {twin_gaps})", flush=True)
    rec.update(
        model=TP_MODEL, placement=sorted({str(d) for d in
                                          mesh.devices.flat}),
        losses=losses, ref_losses=ref_losses, loss_gaps=gaps,
        loss_tol=tols, launches_per_step=per_step[-1], step_ms=ms,
        ref_step_ms=ref_ms, step_ms_median=statistics.median(ms[1:]),
        ref_step_ms_median=statistics.median(ref_ms[1:]),
        rank_param_bytes=rank_bytes, whole_param_bytes=whole,
        rank_share=share,
        cpu_twin=dict(card=card_l, cpu=cpu_l, gaps=twin_gaps,
                      tol=twin_tols, rows=TWIN_ROWS))
    return rec


def _tp_pair(torch, trainer, ref, data):
    """Each step from ``trainer``'s state on it and on ``ref``: the
    losses, the launches of each sharded step, and both step ms."""
    from split_learning_tpu_torch.ops.common import LAUNCHES
    losses, ref_losses, per_step, ms, ref_ms = [], [], [], [], []
    for x, y in data:
        ref.restore_states(trainer.export_states())
        torch.cuda.synchronize()
        LAUNCHES.reset()
        t = time.perf_counter()
        losses.append(trainer.train_step(x, y))
        ms.append((time.perf_counter() - t) * 1e3)
        per_step.append(LAUNCHES.snapshot())
        LAUNCHES.reset()
        t = time.perf_counter()
        ref_losses.append(ref.train_step(x, y))
        ref_ms.append((time.perf_counter() - t) * 1e3)
    return losses, ref_losses, per_step, ms, ref_ms


def tp_image_runs(torch) -> dict:
    """Phase 31 (b): the fused CNN at batch BATCH on each (data, model)
    of TP_CNN_SHAPES (model 4 puts the 9216x10 fc row parallel), each
    step from one state against the unsharded trainer (JAX's bar), K1
    once a data row and K2 once a rank; ResNet-18 at batch IMG_B at
    model 2: per-rank parameter bytes and its steps against the
    unsharded ones."""
    from split_learning_tpu_torch.data import batches, synthetic
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.parallel.mesh import make_mesh
    from split_learning_tpu_torch.runtime import FusedSplitTrainer
    from split_learning_tpu_torch.utils import Config
    ds = synthetic("mnist", n_train=BATCH * TP_CNN_STEPS, n_test=8, seed=1)
    data = list(batches(ds.train, BATCH, seed=1, drop_remainder=True))
    init = get_plan().init(torch.Generator().manual_seed(0), torch.zeros(1))
    cfg = Config(transport="fused", batch_size=BATCH, lr=LR)
    rtol, atol = TP_FUSED_TOL
    rec = {"cnn": {}}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ref = FusedSplitTrainer(get_plan(), cfg, init, data[0][0],
                                device="cuda")
        for d, m in TP_CNN_SHAPES:
            mesh = make_mesh(num_clients=d, model_parallel=m,
                             devices=_tp_devices(torch, d * m))
            trainer = FusedSplitTrainer(
                get_plan(), cfg.replace(num_clients=d, model_parallel=m),
                init, data[0][0], mesh=mesh)
            losses, ref_losses, per_step, ms, ref_ms = _tp_pair(
                torch, trainer, ref, data)
            want = _tp_want(0, rows=d, sgd=d * m)
            label = f"data{d}_model{m}"
            print(f"[tp] CNN {label}: losses {losses[0]:.6f} -> "
                  f"{losses[-1]:.6f}, max gap to the unsharded step "
                  f"{max(abs(a - b) for a, b in zip(losses, ref_losses)):.3g}"
                  f", launches a step {per_step[-1]}, step "
                  f"{statistics.median(ms[1:]):.3f} ms against "
                  f"{statistics.median(ref_ms[1:]):.3f}", flush=True)
            check(np.allclose(losses, ref_losses, rtol=rtol, atol=atol),
                  f"CNN {label}: {losses} against {ref_losses}")
            check(all(c == want for c in per_step),
                  f"CNN {label} launches {per_step}, want {want}")
            rec["cnn"][label] = dict(
                data=d, model=m, losses=losses, ref_losses=ref_losses,
                launches_per_step=per_step[-1],
                step_ms_median=statistics.median(ms[1:]),
                ref_step_ms_median=statistics.median(ref_ms[1:]),
                rank_param_bytes=trainer.state.rank_bytes()[0],
                fc_split_dim=trainer.state.dims[1]["fc.weight"])
        check(rec["cnn"]["data1_model4"]["fc_split_dim"] == 1,
              "model 4: the fc is not row parallel")
        # ResNet-18 at batch IMG_B, model 2
        img = synthetic("cifar10", n_train=IMG_B * 3, n_test=8, seed=0)
        img_data = list(batches(img.train, IMG_B, seed=0,
                                drop_remainder=True))
        plan = get_plan(model="resnet18")
        rinit = plan.init(torch.Generator().manual_seed(0), torch.zeros(1))
        rcfg = Config(transport="fused", model="resnet18",
                      batch_size=IMG_B, lr=LR)
        rref = FusedSplitTrainer(plan, rcfg, rinit, img_data[0][0],
                                 device="cuda")
        mesh = make_mesh(model_parallel=TP_MODEL,
                         devices=_tp_devices(torch, TP_MODEL))
        rtr = FusedSplitTrainer(plan, rcfg.replace(model_parallel=TP_MODEL),
                                rinit, img_data[0][0], mesh=mesh)
        losses, ref_losses, per_step, ms, ref_ms = _tp_pair(
            torch, rtr, rref, img_data)
        rank_bytes = rtr.state.rank_bytes()[0]
        share = max(rank_bytes) / _whole_bytes(rinit)
        print(f"[tp] ResNet-18 model {TP_MODEL}, batch {IMG_B}: losses "
              f"{losses} against {ref_losses}, per-rank param bytes "
              f"{share:.4f} of the whole, launches a step {per_step[-1]}, "
              f"step {statistics.median(ms[1:]):.3f} ms against "
              f"{statistics.median(ref_ms[1:]):.3f}", flush=True)
        check(np.allclose(losses, ref_losses, rtol=rtol, atol=atol),
              f"ResNet-18 model {TP_MODEL}: {losses} against {ref_losses}")
        check(share <= TP_IMG_BYTES_BAR, f"ResNet-18 per-rank bytes {share}")
        check(all(c == _tp_want(0, sgd=TP_MODEL) for c in per_step),
              f"ResNet-18 TP launches {per_step}")
        rec["resnet18"] = dict(
            model=TP_MODEL, batch=IMG_B, losses=losses,
            ref_losses=ref_losses, launches_per_step=per_step[-1],
            rank_param_bytes=rank_bytes, rank_share=share,
            step_ms_median=statistics.median(ms[1:]),
            ref_step_ms_median=statistics.median(ref_ms[1:]))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return rec


def _done_line(out: str) -> dict:
    """The CLI's ``[done]`` line: its final loss and steps/s."""
    line = next(ln for ln in out.splitlines() if ln.startswith("[done]"))
    loss = float(line.split("final_loss=")[1].split()[0])
    rate = float(line.split("(")[-1].split()[0])
    return dict(final_loss=loss, steps_per_s=rate, line=line)


def tp_server_runs(torch, launch_run) -> dict:
    """Phase 31 (c): the sharded server. ``serve --mesh-data 2
    --mesh-model 2`` over HTTP against a CNN client at batch BATCH on the
    ``none`` wire, TP_SERVER_STEPS steps against ``serve`` unsharded from
    the same seeds (JAX's bar; the step ms of both), /health's mesh and
    /metrics' gather bytes; ``train --transport local --mesh-data 2
    --mesh-model 2`` against the flags' absence (the final loss and the
    rate, paired); a coalesced group of TP_PAD_B rows padded to the data
    TP_PAD_DATA multiple."""
    import urllib.request
    from split_learning_tpu_torch.data import batches, synthetic
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.parallel.mesh import make_mesh
    from split_learning_tpu_torch.runtime import (
        ServerRuntime, SplitClientTrainer)
    from split_learning_tpu_torch.transport import (
        HttpTransport, LocalTransport, codec)
    from split_learning_tpu_torch.utils import Config
    rtol, atol = TP_SERVER_TOL
    ds = synthetic("mnist", n_train=BATCH * TP_SERVER_STEPS, n_test=8,
                   seed=2)
    data = list(batches(ds.train, BATCH, seed=2, drop_remainder=True))
    cfg = Config(transport="http", batch_size=BATCH, lr=LR)

    def client(transport):
        return SplitClientTrainer(get_plan(), cfg,
                                  torch.Generator().manual_seed(0),
                                  transport, device="cuda")

    def series(c):
        out, ms = [], []
        for i, (x, y) in enumerate(data):
            t = time.perf_counter()
            out.append(c.train_step(x, y, i))
            ms.append((time.perf_counter() - t) * 1e3)
        return out, ms

    rec = {}
    http = {}
    for label, flags in (("flat", ()), ("mesh", ("--mesh-data", "2",
                                                  "--mesh-model", "2"))):
        with _CudaRanks(4):
            srv = _Serve(f"tp_server_{label}", *flags, "--lr", str(LR))
        try:
            transport = HttpTransport(srv.url, timeout=HTTP_TIMEOUT,
                                      compress="none")
            losses, ms = series(client(transport))
            with urllib.request.urlopen(srv.url + "/health",
                                        timeout=HTTP_TIMEOUT) as r:
                health = codec.decode(r.read())
            with urllib.request.urlopen(srv.url + "/metrics",
                                        timeout=HTTP_TIMEOUT) as r:
                metrics = r.read().decode()
            transport.close()
        finally:
            srv.stop()
        gather = [float(ln.split()[-1]) for ln in metrics.splitlines()
                  if ln.startswith("slt_gather_bytes")]
        http[label] = dict(losses=losses, step_ms=ms,
                           step_ms_median=statistics.median(ms[1:]),
                           mesh=health.get("mesh"),
                           gather_bytes=gather[0] if gather else 0.0)
    got, flat = http["mesh"], http["flat"]
    print(f"[tp] serve --mesh-data 2 --mesh-model 2 over HTTP (none): "
          f"losses {got['losses']} against the unsharded server "
          f"{flat['losses']}; health mesh {got['mesh']}; gather bytes "
          f"{got['gather_bytes']} (unsharded {flat['gather_bytes']}); step "
          f"{got['step_ms_median']:.3f} ms against "
          f"{flat['step_ms_median']:.3f}", flush=True)
    check(np.allclose(got["losses"], flat["losses"], rtol=rtol, atol=atol),
          f"sharded HTTP server: {got['losses']} against {flat['losses']}")
    check(got["mesh"] == {"devices": 4, "data": 2, "pipe": 1, "model": 2}
          and flat["mesh"] is None, f"health meshes {http}")
    check(got["gather_bytes"] > 0 and flat["gather_bytes"] == 0,
          f"gather bytes {http}")
    rec["http"] = http
    # the in-process server of the local wire, through the CLI, paired
    data_dir = os.path.join(REPO, "build", "chip_smoke_data")
    argv = ["train", "--device", "cuda", "--transport", "local", "--steps",
            str(TP_SERVER_STEPS * 2), "--dataset", "synthetic",
            "--data-dir", data_dir, "--tracking", "noop", "--lr", str(LR)]
    runs = {}
    for label, extra in (("flat", []),
                         ("mesh", ["--mesh-data", "2", "--mesh-model", "2"]),
                         ("mesh_again", ["--mesh-data", "2",
                                         "--mesh-model", "2"]),
                         ("flat_again", [])):
        with _CudaRanks(4):
            rc, counts, out, err, secs = _cli_err(torch, launch_run,
                                                  argv + extra)
        check(rc == 0, f"train --transport local {extra}: rc {rc}, "
                       f"{err[-1500:]}")
        runs[label] = dict(_done_line(out), launches=counts, seconds=secs)
    steps = TP_SERVER_STEPS * 2
    want_mesh = _tp_want(0, sgd=1 + 2 * 2)
    check(runs["mesh"]["launches"] == {k: v * steps for k, v in
                                       want_mesh.items()},
          f"local mesh launches {runs['mesh']['launches']}")
    a, b = runs["mesh"]["final_loss"], runs["flat"]["final_loss"]
    check(abs(a - b) <= atol + rtol * abs(b),
          f"local mesh final loss {a} against {b}")
    print(f"[tp] train --transport local --mesh-data 2 --mesh-model 2: "
          f"final loss {a} against {b}; steps/s flat "
          f"{runs['flat']['steps_per_s']}, {runs['flat_again']['steps_per_s']}"
          f", mesh {runs['mesh']['steps_per_s']}, "
          f"{runs['mesh_again']['steps_per_s']}; launches "
          f"{runs['mesh']['launches']} in {steps} steps", flush=True)
    rec["local_cli"] = runs
    # a coalesced group pads to the data axis
    pad_srv = ServerRuntime(
        get_plan(), cfg, torch.Generator().manual_seed(0),
        coalesce_max=4, coalesce_window_ms=5.0,
        mesh=make_mesh(num_clients=TP_PAD_DATA,
                       devices=_tp_devices(torch, TP_PAD_DATA)))
    ref_srv = ServerRuntime(get_plan(), cfg,
                            torch.Generator().manual_seed(0), device="cuda")
    small = [(x[:TP_PAD_B], y[:TP_PAD_B]) for x, y in data]
    try:
        pc = client(LocalTransport(pad_srv))
        rc_ = client(LocalTransport(ref_srv))
        padded = [pc.train_step(x, y, i) for i, (x, y) in enumerate(small)]
        plain = [rc_.train_step(x, y, i) for i, (x, y) in enumerate(small)]
        sigs = sorted(pad_srv._coalesce_shapes)
    finally:
        pad_srv.close()
        ref_srv.close()
    print(f"[tp] coalesced groups of {TP_PAD_B} rows on data {TP_PAD_DATA}:"
          f" signatures {sigs}, losses {padded} against {plain}", flush=True)
    check(sigs and all(sh[0] % TP_PAD_DATA == 0 for sh, _, _ in sigs),
          f"group signatures {sigs}")
    check(np.allclose(padded, plain, rtol=rtol, atol=atol),
          f"padded groups: {padded} against {plain}")
    rec["coalesced_pad"] = dict(data=TP_PAD_DATA, rows=TP_PAD_B,
                                signatures=[list(sh) for sh, _, _ in sigs],
                                losses=padded, ref_losses=plain)
    return rec


def tp_chain_runs(torch) -> dict:
    """Phase 31 (d): ``split_cnn_chain3`` on the device wire at batch
    BATCH, M 2, its middle stage at data 2 x model 2: the flat chain's
    series (the sharded server's bar), no host copy on a hop, the step
    ms of both."""
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.obs import spans
    from split_learning_tpu_torch.parallel.mesh import make_mesh
    from split_learning_tpu_torch.runtime import (
        PipelineRunner, StageRuntime)
    from split_learning_tpu_torch.transport import DeviceTransport
    from split_learning_tpu_torch.utils import Config
    rtol, atol = TP_SERVER_TOL
    plan = get_plan(model="split_cnn_chain3")
    cfg = Config(transport="device", model="split_cnn_chain3",
                 batch_size=BATCH, num_stages=3, microbatches=2, lr=LR)
    init = plan.init(torch.Generator().manual_seed(0), torch.zeros(1))
    rs = np.random.RandomState(3)
    data = [(rs.randn(BATCH, 28, 28, 1).astype(np.float32),
             rs.randint(0, 10, BATCH).astype(np.int64))
            for _ in range(TP_CHAIN_STEPS)]
    rec = {}
    for label, mesh in (("flat", None), ("middle_data2_model2", make_mesh(
            num_clients=2, model_parallel=2,
            devices=_tp_devices(torch, 4)))):
        stages = [StageRuntime(plan, i, cfg, init, microbatches=2,
                               mesh=mesh if i == 1 else None,
                               device="cuda") for i in (1, 2)]
        wires = [DeviceTransport(st) for st in stages]
        runner = PipelineRunner(plan, cfg, init, None, wires,
                                microbatches=2, device="cuda",
                                step_timeout_s=CHAIN_STEP_TIMEOUT)
        try:
            losses, ms = [], []
            for s_, (x, y) in enumerate(data):
                torch.cuda.synchronize()
                t = time.perf_counter()
                losses.append(runner.step(x, y, step=s_))
                ms.append((time.perf_counter() - t) * 1e3)
            report = runner.stage_report()
        finally:
            runner.close()
            for st in stages:
                st.close()
        copies = [w.stats.counters.get(spans.HOP_HOST_COPIES, 0)
                  for w in wires]
        rec[label] = dict(losses=losses, step_ms=ms,
                          step_ms_median=statistics.median(ms[1:]),
                          hop_host_copies=copies,
                          mesh=[r["mesh"] for r in report])
    got, ref = rec["middle_data2_model2"], rec["flat"]
    print(f"[tp] split_cnn_chain3 device wire, middle stage data 2 x model "
          f"2: losses {got['losses']} against flat {ref['losses']}, "
          f"hop_host_copies {got['hop_host_copies']}, meshes {got['mesh']},"
          f" step {got['step_ms_median']:.3f} ms against "
          f"{ref['step_ms_median']:.3f}", flush=True)
    check(np.allclose(got["losses"], ref["losses"], rtol=rtol, atol=atol),
          f"sharded chain: {got['losses']} against {ref['losses']}")
    check(got["hop_host_copies"] == [0, 0],
          f"host copies on the device wire {got['hop_host_copies']}")
    check(got["mesh"][0].get("model") == 2, f"stage meshes {got['mesh']}")
    return rec


def model_axis_runs(torch, launch_run, smi, tr_data) -> tuple:
    """Phase 31: (a) to (d) with their launch totals."""
    from split_learning_tpu_torch.ops.common import LAUNCHES
    t0 = time.perf_counter()
    rec = {"card": smi, "cards": torch.cuda.device_count(),
           "placement": "virtual ranks on cuda:0"}
    LAUNCHES.reset()   # the kernel checks' launches stay out of the totals
    totals, restore = _phase_totals(LAUNCHES)
    try:
        rec["lm"] = tp_lm_runs(torch, launch_run, tr_data)
        rec["image"] = tp_image_runs(torch)
        rec["server"] = tp_server_runs(torch, launch_run)
        rec["chain"] = tp_chain_runs(torch)
    finally:
        restore()
    rec["seconds"] = time.perf_counter() - t0
    print(f"[tp] phase 31: {rec['seconds']:.1f} s, every mesh on virtual "
          f"ranks of card 0 ({rec['cards']} card)", flush=True)
    return rec, totals


# --------------------------------------------------------------------- #
# phase 32: the native host codec and the concurrency checker

def _native_line(on: bool) -> None:
    """Send the host codec to the native library (``on``) or to its
    numpy line (``SLT_NO_NATIVE=1``)."""
    if on:
        os.environ.pop("SLT_NO_NATIVE", None)
    else:
        os.environ["SLT_NO_NATIVE"] = "1"


def _codec_frames(codec, kind, xs, device=None):
    """Frame bytes, decoded bytes and the final residual of ``xs`` (numpy
    arrays or tensors, one a step) in ``kind``: int8, topk8 (one step, no
    EF) or topk8_ef (the EF ledger over every step). ``device`` decodes
    there (None: on the host)."""
    frames, decoded = [], []
    ef = codec.TopK8EF() if kind == "topk8_ef" else None
    for x in xs:
        if kind == "int8":
            d = codec.q8_compress(x)
        elif kind == "topk8":
            d = codec.topk8_compress(x, DENSITY)[0]
        else:
            d = ef.compress("g", x, DENSITY)
        frames.append(codec.encode(d))
        out = codec.decompress_tree(codec.decode(frames[-1]), device)
        if device is not None:
            out = out.cpu().numpy()
        decoded.append(np.ascontiguousarray(out).tobytes())
    res = None
    if ef is not None:
        r = ef.residual("g")
        res = (r.detach().cpu().numpy() if hasattr(r, "detach")
               else np.asarray(r)).tobytes()
    return frames, decoded, res


def native_codec_runs(torch, dev):
    """Phase 32 (a): the native build, three-way byte-equal frames at
    both cuts, host ms per MB native against numpy."""
    from split_learning_tpu_torch import native
    from split_learning_tpu_torch.native import codec as ncodec
    from split_learning_tpu_torch.ops import quantize as qmod
    from split_learning_tpu_torch.ops import topk as kmod
    from split_learning_tpu_torch.ops.common import LAUNCHES
    from split_learning_tpu_torch.transport import codec
    _native_line(True)
    t = time.perf_counter()
    check(native.available(), f"native codec: {native.build_error()}")
    first_call_s = time.perf_counter() - t
    # one build from nothing with this machine's g++, timed (the codec's
    # own library may have come from an earlier phase's cache)
    fresh = os.path.join(REPO, "build", "chip_smoke_native", str(os.getpid()))
    prev = os.environ.get("SLT_NATIVE_CACHE")
    os.environ["SLT_NATIVE_CACHE"] = fresh
    try:
        t = time.perf_counter()
        built = ncodec._build()
        build_s = time.perf_counter() - t
    finally:
        if prev is None:
            os.environ.pop("SLT_NATIVE_CACHE")
        else:
            os.environ["SLT_NATIVE_CACHE"] = prev
    check(os.path.exists(built), f"native build: no {built}")
    rec = dict(build_s=build_s, first_call_s=first_call_s,
               library=os.path.relpath(ncodec.library_path(), REPO),
               cpu_count=os.cpu_count(), reps=NATIVE_REPS, frames={},
               host={})
    kinds = ("int8", "topk8", "topk8_ef")
    for ci, (cut, shape) in enumerate(NATIVE_CUTS):
        steps = [(np.random.RandomState(320 + 10 * ci + s).randn(*shape)
                  * 3.0).astype(np.float32) for s in range(NATIVE_EF_STEPS)]
        for kind in kinds:
            xs = steps if kind == "topk8_ef" else steps[:1]
            _native_line(True)
            nat = _codec_frames(codec, kind, xs)
            _native_line(False)
            ref = _codec_frames(codec, kind, xs)
            _native_line(True)
            LAUNCHES.reset()
            card = _codec_frames(codec, kind,
                                 [torch.from_numpy(x).to(dev) for x in xs],
                                 dev)
            torch.cuda.synchronize()
            counts = LAUNCHES.snapshot()
            # the encode on the card (K3, or K4s's five launches), and
            # for int8 the dequantize of the card's decode
            want = ({qmod.QUANT: len(xs), qmod.DEQUANT: len(xs)}
                    if kind == "int8" else
                    {n: len(xs) for n in kmod.SELECT_LAUNCHES})
            check(counts == want, f"native {cut} {kind}: card launches "
                                  f"{counts}, want {want}")
            for what, i in (("frames", 0), ("decoded", 1), ("residual", 2)):
                check(nat[i] == ref[i] == card[i],
                      f"native {cut} {kind}: {what} differ between the "
                      f"native codec, the numpy line and the card")
            rec["frames"][f"{cut} {kind}"] = dict(
                shape=list(shape), steps=len(xs), byte_equal=True,
                frame_bytes=[len(f) for f in nat[0]], card_launches=counts)
        x = steps[0]
        mb = x.nbytes / 1e6
        for kind in ("int8", "topk8"):
            enc = ((lambda: codec.q8_compress(x)) if kind == "int8"
                   else (lambda: codec.topk8_compress(x, DENSITY)))
            times = {"native": ([], []), "numpy": ([], [])}
            # native, numpy, numpy, native: half the reps each time, so
            # neither line always runs first
            for line in ("native", "numpy", "numpy", "native"):
                _native_line(line == "native")
                d = enc() if kind == "int8" else enc()[0]
                times[line][0].extend(_host_reps(enc, NATIVE_REPS // 2))
                times[line][1].extend(_host_reps(
                    lambda: codec.decompress_tree(d), NATIVE_REPS // 2))
            row = {}
            for line, (e, dd) in times.items():
                e_ms, d_ms = statistics.median(e), statistics.median(dd)
                row[line] = dict(encode_ms=e_ms, decode_ms=d_ms,
                                 encode_ms_per_mb=e_ms / mb,
                                 decode_ms_per_mb=d_ms / mb)
            row["mb"] = mb
            rec["host"][f"{cut} {kind}"] = row
    _native_line(True)
    return rec


def _host_reps(fn, reps):
    out = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t) * 1e3)
    return out


def analysis_runs():
    """Phase 32 (b), five subprocesses at once, each within
    ANALYSIS_TIMEOUT_S: the lint over the port and chip_smoke.py, every
    slt-check scenario in one sweep cut to ANALYSIS_CHECK_BUDGET
    schedules each, and each slt-crash scenario at its own budget. rc 0
    each, no finding, the schedules each scenario explored against its
    own budget, seconds. (The interpreter's start dominates a short
    sweep, so fewer processes finish sooner.)"""
    import re
    import subprocess
    from split_learning_tpu_torch.analysis.scenarios import (
        CRASH_SCENARIOS, SCENARIOS)
    out_dir = os.path.join(REPO, "build", "chip_smoke_analysis")
    os.makedirs(out_dir, exist_ok=True)
    mod = [sys.executable, "-m", "split_learning_tpu_torch.analysis"]
    jobs = [(n, mod + ["--check", "--crash", "--scenario", n])
            for n in CRASH_SCENARIOS]
    jobs += [("lint", mod + ["split_learning_tpu_torch/", "chip_smoke.py"]),
             ("check", mod + ["--check", "--budget",
                              str(ANALYSIS_CHECK_BUDGET)])]
    # the sweeps run tiny CPU tensors: one intra-op thread a process
    env = {k: v for k, v in os.environ.items()
           if k not in ("SLT_LOCK_DEBUG", "SLT_NO_NATIVE")}
    env["OMP_NUM_THREADS"] = "1"
    t0 = time.perf_counter()
    running = {}
    for name, cmd in jobs:
        fh = open(os.path.join(out_dir, f"{name}.txt"), "w")
        running[name] = (subprocess.Popen(
            cmd, cwd=REPO, env=env, stdout=fh, stderr=subprocess.STDOUT,
            text=True), fh)
    seconds, texts = {}, {}
    while running:
        for name, (proc, fh) in list(running.items()):
            if proc.poll() is None:
                if time.perf_counter() - t0 <= ANALYSIS_TIMEOUT_S:
                    continue
                proc.kill()
                proc.wait()
            fh.close()
            del running[name]
            seconds[name] = time.perf_counter() - t0
            with open(fh.name) as f:
                texts[name] = f.read()
            check(proc.returncode == 0 and "0 unwaived finding(s)"
                  in texts[name], f"analysis {name}: rc "
                  f"{proc.returncode}: {texts[name][-1500:]}")
        time.sleep(0.05)
    runs = {}
    for name in list(SCENARIOS) + list(CRASH_SCENARIOS):
        text = texts["check" if name in SCENARIOS else name]
        m = re.search(rf"{re.escape(name)}: (\d+) schedules", text)
        check(m is not None and int(m.group(1)) > 0,
              f"analysis {name}: no schedules explored: {text[-1500:]}")
        runs[name] = dict(schedules=int(m.group(1)))
        if name in SCENARIOS:
            runs[name].update(budget=ANALYSIS_CHECK_BUDGET,
                              own_budget=SCENARIOS[name].budget)
    rec = dict(python=sys.version.split()[0], seconds=seconds,
               check_budget=ANALYSIS_CHECK_BUDGET,
               # the sweeps the cut stopped short of their own budget
               cut=sorted(n for n in SCENARIOS
                          if runs[n]["schedules"] >= ANALYSIS_CHECK_BUDGET
                          and ANALYSIS_CHECK_BUDGET < SCENARIOS[n].budget),
               runs=runs, wall_s=time.perf_counter() - t0,
               schedules_check=sum(runs[n]["schedules"] for n in SCENARIOS),
               schedules_crash=sum(runs[n]["schedules"]
                                   for n in CRASH_SCENARIOS),
               scenarios=len(SCENARIOS), crash_scenarios=len(CRASH_SCENARIOS))
    return rec


def watchdog_round(device="cuda", rounds=WATCHDOG_ROUNDS):
    """Phase 32 (c), one process: phase 25's coalesced MANY_CLIENTS-client
    CNN (local wire, ``none``, coalesce_max MANY_CLIENTS, an SLO so the
    admission layer is built) for ``rounds`` rounds, the clients enqueued
    in client order each round (each starts once the previous one's
    request has arrived), so every group is the same. Returns the loss
    series (float.hex), the names of the instrumented locks built, the
    watchdog's violations and the launches. Deterministic cuDNN."""
    import torch
    from split_learning_tpu_torch.data import batches, synthetic
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.obs import locks
    from split_learning_tpu_torch.ops.common import LAUNCHES
    from split_learning_tpu_torch.runtime import (
        ServerRuntime, SplitClientTrainer)
    from split_learning_tpu_torch.transport import LocalTransport
    n = MANY_CLIENTS
    ds = synthetic("mnist", n_train=BATCH * n * rounds, n_test=8, seed=2)
    data = list(batches(ds.train, BATCH, seed=2, drop_remainder=True))
    names = []
    orig_init = locks.InstrumentedLock.__init__

    def init(self, name, **kw):
        names.append(name)
        orig_init(self, name, **kw)

    locks.InstrumentedLock.__init__ = init
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        cfg = _many_cfg()
        server = ServerRuntime(get_plan(), cfg,
                               torch.Generator().manual_seed(0),
                               coalesce_max=n,
                               coalesce_window_ms=WATCHDOG_WINDOW_MS,
                               slo_ms=WATCHDOG_SLO_MS, device=device)
        clients = [SplitClientTrainer(
            get_plan(), cfg, torch.Generator().manual_seed(1 + i),
            LocalTransport(server), client_id=i, device=device)
            for i in range(n)]
        LAUNCHES.reset()
        losses, errors = [], []
        try:
            for r in range(rounds):
                out = [None] * n

                def run(i, r=r, out=out):
                    try:
                        out[i] = clients[i].train_step(*data[r * n + i],
                                                       step=r)
                    except Exception as exc:   # reported below
                        errors.append(exc)

                threads = []
                for i in range(n):
                    th = threading.Thread(target=run, args=(i,))
                    th.start()
                    threads.append(th)
                    deadline = time.monotonic() + 60.0
                    # the coalescer's arrival count: this client's
                    # request is queued before the next one starts
                    while (i < n - 1 and not errors
                           and server._coalescer._arrivals < r * n + i + 1):
                        check(time.monotonic() < deadline,
                              f"watchdog round {r}: client {i} never "
                              f"enqueued")
                        time.sleep(0.001)
                for th in threads:
                    th.join(timeout=120.0)
                check(not errors, f"watchdog round {r}: {errors}")
                losses.append([float(v).hex() for v in out])
            if device != "cpu":
                torch.cuda.synchronize()
            counts = LAUNCHES.snapshot()
        finally:
            server.close()
        health = server.health()["coalescing"]
    finally:
        locks.InstrumentedLock.__init__ = orig_init
        torch.backends.cudnn.deterministic = deterministic
    return dict(losses=losses, locks=sorted(set(names)),
                violations=[v["message"]
                            for v in locks.default_graph().violations],
                launches=counts, rounds=rounds,
                groups=int(health.get("groups_flushed", 0)),
                mean_occupancy=health.get("mean_occupancy", 0.0))


def watchdog_runs(torch, per_round):
    """Phase 32 (c): :func:`watchdog_round` in two subprocesses on the
    card, ``SLT_LOCK_DEBUG=1`` and unset, at once: the loss series
    bit-equal, no violation, the named locks instrumented (and none with
    the watchdog off), K1 and K2 each round as phase 25's coalesced
    round (``per_round``)."""
    import subprocess
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke as cs; "
            "print('WATCHDOG ' + json.dumps(cs.watchdog_round('cuda')))")
    t0 = time.perf_counter()
    procs = {}
    for debug in (True, False):
        env = {k: v for k, v in os.environ.items() if k != "SLT_LOCK_DEBUG"}
        if debug:
            env["SLT_LOCK_DEBUG"] = "1"
        procs[debug] = subprocess.Popen(
            [sys.executable, "-c", code, REPO], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    runs = {}
    for debug, proc in procs.items():
        out, err = proc.communicate(timeout=600)
        check(proc.returncode == 0,
              f"watchdog run (debug {debug}): rc {proc.returncode}: "
              f"{err[-2000:]}")
        line = [ln for ln in out.splitlines() if ln.startswith("WATCHDOG ")]
        check(len(line) == 1, f"watchdog run (debug {debug}): {out[-800:]}")
        runs[debug] = json.loads(line[0][len("WATCHDOG "):])
    on, off = runs[True], runs[False]
    check(on["losses"] == off["losses"],
          f"watchdog: loss series differ on and off: {on['losses']} vs "
          f"{off['losses']}")
    check(on["violations"] == [] and off["violations"] == [],
          f"watchdog: violations {on['violations']} {off['violations']}")
    check(set(WATCHDOG_LOCKS) <= set(on["locks"]),
          f"watchdog: instrumented locks {on['locks']}")
    check(off["locks"] == [], f"watchdog off built {off['locks']}")
    want = {k: v * WATCHDOG_ROUNDS for k, v in per_round.items()}
    for label, run in (("on", on), ("off", off)):
        check(run["launches"] == want,
              f"watchdog {label}: launches {run['launches']}, want {want} "
              f"(phase 25's coalesced round x {WATCHDOG_ROUNDS})")
        check(run["groups"] == WATCHDOG_ROUNDS,
              f"watchdog {label}: {run['groups']} groups")
    return dict(seconds=time.perf_counter() - t0, rounds=WATCHDOG_ROUNDS,
                clients=MANY_CLIENTS, losses_bit_equal=True,
                losses=[[float.fromhex(v) for v in r] for r in on["losses"]],
                instrumented_locks=on["locks"], violations=0,
                launches=on["launches"], launches_per_round=per_round)


def analysis_native_runs(torch, dev, smi, many_rec):
    """Phase 32: (b), (c), then (a) on a quiet host (its timings); each
    prints its own line with the card."""
    from split_learning_tpu_torch.ops.cross_entropy import BWD, FWD
    from split_learning_tpu_torch.ops.sgd import NAME as SGD
    t0 = time.perf_counter()
    rec = {"card": smi}
    group = many_rec["coalescing"]["runs"]["local none window"][
        "server_launches_per_group"]
    per_round = {k: group.get(k, 0) for k in (FWD, BWD, SGD)}
    per_round[SGD] += MANY_CLIENTS   # each client's own step
    rec["checker"] = c = analysis_runs()
    print(f"[analysis] {smi} | lint rc 0; slt-check {c['scenarios']} "
          f"scenarios, {c['schedules_check']} schedules (at most "
          f"{c['check_budget']} each; {len(c['cut'])} cut from their own "
          f"budget); slt-crash "
          f"{c['crash_scenarios']} scenarios, {c['schedules_crash']} "
          f"schedules; 0 violations; {c['wall_s']:.1f} s in 5 "
          f"processes, Python {c['python']}", flush=True)
    rec["watchdog"] = w = watchdog_runs(torch, per_round)
    print(f"[watchdog] {smi} | {w['clients']} clients x {w['rounds']} "
          f"coalesced rounds, SLT_LOCK_DEBUG=1 and off: loss series "
          f"bit-equal, 0 violations, instrumented "
          f"{', '.join(w['instrumented_locks'])}; launches a round "
          f"{w['launches_per_round']}; {w['seconds']:.1f} s", flush=True)
    rec["native"] = native_codec_runs(torch, dev)
    nat = rec["native"]
    host = "; ".join(
        f"{k}: enc {r['native']['encode_ms_per_mb']:.3f} vs "
        f"{r['numpy']['encode_ms_per_mb']:.3f}, dec "
        f"{r['native']['decode_ms_per_mb']:.3f} vs "
        f"{r['numpy']['decode_ms_per_mb']:.3f}"
        for k, r in nat["host"].items())
    print(f"[native] {smi} | g++ build {nat['build_s']:.2f} s (first call "
          f"{nat['first_call_s']:.2f} s); frames byte-equal native / numpy "
          f"/ card on {len(nat['frames'])} cases; host ms per MB native vs "
          f"numpy (median of {nat['reps']}, {nat['cpu_count']} CPUs): "
          f"{host}", flush=True)
    rec["seconds"] = time.perf_counter() - t0
    print(f"[analysis] phase 32: {rec['seconds']:.1f} s", flush=True)
    return rec


# --------------------------------------------------------------------- #
# phase 33: the seq axis as JAX lays it out, with the model axis

def ce_row_checks(torch, dev, gen, bw, fp32, n: int, c: int) -> dict:
    """Phase 33 (a), K1 at one seq rank's ``[n, c]`` bf16 rows: forward
    and backward against the plain versions (the loss within
    CE_LOSS_RTOL, the gradient within one bf16 ulp), device ms beside
    the plain versions' and ``F.cross_entropy``'s (its backward through
    autograd), and the bound (logits read once, the gradient written
    once)."""
    import torch.nn.functional as F
    from split_learning_tpu_torch.ops.cross_entropy import (
        ce_backward_cuda, ce_backward_plain, ce_forward_cuda,
        ce_forward_plain)
    g_one = torch.ones((), device=dev)
    x, y = ce_inputs(torch, dev, gen, n, c, torch.bfloat16)
    loss, lse = ce_forward_cuda(x, y)
    grad = ce_backward_cuda(x, y, lse, g_one)
    loss_p, lse_p = ce_forward_plain(x, y)
    grad_p = ce_backward_plain(x, y, lse_p, g_one)
    d = abs(loss.item() - loss_p.item())
    ulps = bf16_ulps(torch, grad, grad_p)
    check(d <= CE_LOSS_RTOL * abs(loss_p.item()) and ulps <= 1,
          f"K1 at [{n}, {c}] bf16: loss {loss.item()} vs {loss_p.item()}, "
          f"grad {ulps} ulps")
    xr = x.clone().requires_grad_(True)
    lib_loss = F.cross_entropy(xr, y)
    logits_b = n * c * x.element_size()
    f_ms, f_by = bound(logits_b + n * 8 + n * 4 + 4, 4 * n * c, bw, fp32)
    b_ms, b_by = bound(2 * logits_b + n * 8 + n * 4 + 4, 4 * n * c, bw,
                       fp32)
    rec = dict(shape=[n, c], dtype="bfloat16", fwd=dict(
        ms=device_ms(torch, lambda: ce_forward_cuda(x, y)),
        plain_ms=device_ms(torch, lambda: ce_forward_plain(x, y), reps=20),
        library_ms=device_ms(torch, lambda: F.cross_entropy(x, y)),
        bound_ms=f_ms, bound_by=f_by, max_abs_err=d), bwd=dict(
        ms=device_ms(torch, lambda: ce_backward_cuda(x, y, lse, g_one)),
        plain_ms=device_ms(torch, lambda: ce_backward_plain(
            x, y, lse, g_one), reps=20),
        library_ms=device_ms(torch, lambda: torch.autograd.grad(
            lib_loss, xr, retain_graph=True)),
        bound_ms=b_ms, bound_by=b_by,
        max_abs_err=(grad.float() - grad_p.float()).abs().max().item(),
        grad_ulps=ulps))
    print(f"[seq] K1 at one seq rank's rows [{n}, {c}] bf16: fwd "
          f"{rec['fwd']['ms']:.5f} ms (bound {f_ms:.5f}, F.cross_entropy "
          f"{rec['fwd']['library_ms']:.5f}), bwd {rec['bwd']['ms']:.5f} "
          f"(bound {b_ms:.5f}, autograd {rec['bwd']['library_ms']:.5f})",
          flush=True)
    return rec


def sm_want(torch, attn: str, sgd: bool = False) -> dict:
    """The launches a step of the LM at ``model`` SM_MODEL x ``seq``
    SM_SEQ, as the code implies them. ``ring_flash`` (causal, so
    striped): K5 and each K6 launch once a block, model rank, seq rank
    and hop. ``ulysses``: a model rank's one head does not divide over
    the seq ranks, so the heads are gathered and Ulysses runs on both
    over the seq ranks: K5 and K6 once a block and seq rank where
    ``select_attention`` picks flash at one rank's shape (T 1024, one
    head, bf16), else none. K1f and K1b once a seq rank; K2 under SGD
    once a model rank (the state lives on seq rank 0; the other seq
    ranks' copies come from a broadcast each step)."""
    from split_learning_tpu_torch.ops.flash_attention import (
        select_attention)
    if attn == "ring_flash":
        k5 = N_BLOCKS * SM_MODEL * SM_SEQ * SM_SEQ
    else:
        pick = select_attention(TRAIN_B, TRAIN_T,
                                LM["num_heads"] // SM_SEQ, 2,
                                device=torch.device("cuda", 0))
        k5 = N_BLOCKS * SM_SEQ if pick == "flash" else 0
    return _tp_want(k5, rows=SM_SEQ, sgd=SM_MODEL if sgd else 0)


def _sm_hooks(plan):
    """Forward hooks on every Dense and LayerNorm (the token extents
    their inputs hold) and on the first stage (its output's blocks)."""
    from split_learning_tpu_torch.models.transformer import Dense, LayerNorm
    seen, cuts, handles = {}, [], []
    for st in plan.stages:
        for name, mod in st.module.named_modules():
            if isinstance(mod, (Dense, LayerNorm)):
                handles.append(mod.register_forward_hook(
                    lambda m, a, o, key=f"{st.name}.{name}":
                    seen.setdefault(key, []).append(int(a[0].shape[1]))))
    handles.append(plan.stages[0].module.register_forward_hook(
        lambda m, a, o: cuts.append(
            [tuple(b.shape) for b in getattr(o, "blocks", [o])])))
    return seen, cuts, handles


def seq_model_lm_runs(torch, launch_run, tr_data) -> dict:
    """Phase 33 (b), see the module docstring."""
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.ops.common import LAUNCHES
    from split_learning_tpu_torch.parallel.mesh import make_mesh
    from split_learning_tpu_torch.runtime import FusedSplitTrainer
    from split_learning_tpu_torch.utils import Config
    n = SM_MODEL * SM_SEQ
    t_rank = TRAIN_T // SM_SEQ
    plan0 = get_plan(dtype="bfloat16", **LM)
    init = plan0.init(torch.Generator().manual_seed(0), torch.zeros(1))
    cfg = _lm_mesh_cfg()
    ref = FusedSplitTrainer(plan0, cfg, init, tr_data[0][0], device="cuda")
    mesh = make_mesh(model_parallel=SM_MODEL, seq_parallel=SM_SEQ,
                     devices=_tp_devices(torch, n))
    mcfg = cfg.replace(model_parallel=SM_MODEL, seq_parallel=SM_SEQ)
    data_dir = os.path.join(REPO, "build", "chip_smoke_obs_data")
    rec = {}
    for attn in ("ring_flash", "ulysses"):
        want = sm_want(torch, attn)
        flags = _lm_flags(data_dir)
        flags[flags.index("--attn") + 1] = attn
        argv = ["train", "--transport", "fused", "--steps",
                str(SM_CLI_STEPS), "--tracking", "noop", *flags,
                "--model-parallel", str(SM_MODEL), "--seq-parallel",
                str(SM_SEQ)]
        with _CudaRanks(n):
            rc, counts, _, err, secs = _cli_err(torch, launch_run, argv)
        check(rc == 0, f"train --model-parallel {SM_MODEL} --seq-parallel "
                       f"{SM_SEQ} --attn {attn}: rc {rc}, {err[-1500:]}")
        want_cli = {k: v * SM_CLI_STEPS for k, v in want.items()}
        check(counts == want_cli,
              f"{attn} model x seq CLI launches {counts}, want {want_cli}")
        plan = get_plan(dtype="bfloat16", mesh=mesh, **dict(LM, attn=attn))
        trainer = FusedSplitTrainer(plan, mcfg, init, tr_data[0][0],
                                    mesh=mesh)
        seen, cuts, handles = _sm_hooks(plan)
        losses, ref_losses, ms, ref_ms, per_step = [], [], [], [], []
        for i, (x, y) in enumerate(tr_data[:SM_LM_STEPS]):
            ref.restore_states(trainer.export_states())
            torch.cuda.synchronize()
            LAUNCHES.reset()
            t = time.perf_counter()
            losses.append(trainer.train_step(x, y))
            ms.append((time.perf_counter() - t) * 1e3)
            per_step.append(LAUNCHES.snapshot())
            if i == 0:
                for h in handles:
                    h.remove()
            LAUNCHES.reset()
            t = time.perf_counter()
            ref_losses.append(ref.train_step(x, y))
            ref_ms.append((time.perf_counter() - t) * 1e3)
        gaps = [abs(a - b) for a, b in zip(losses, ref_losses)]
        extents = sorted({e for v in seen.values() for e in v})
        print(f"[seq] {attn} model {SM_MODEL} x seq {SM_SEQ}: CLI rc 0, "
              f"launches {counts} in {SM_CLI_STEPS} steps ({secs:.1f} s); "
              f"losses {losses} against unsharded {ref_losses} (gaps "
              f"{gaps}); launches a step {per_step[-1]} (want {want}); "
              f"step {statistics.median(ms[1:]):.3f} ms against "
              f"{statistics.median(ref_ms[1:]):.3f}; {len(seen)} Dense and "
              f"LayerNorm modules saw token extents {extents}, the cut "
              f"{cuts}", flush=True)
        check(all(g <= SM_LOSS_TOL for g in gaps),
              f"{attn} model x seq: losses {losses} against {ref_losses}")
        check(all(c == want for c in per_step),
              f"{attn} model x seq launches {per_step}, want {want}")
        check(extents == [t_rank] and len(seen) == 8 * N_BLOCKS + 2,
              f"{attn}: Dense/LayerNorm token extents {seen}")
        check(cuts == [[(TRAIN_B, t_rank, LM["d_model"])] * SM_SEQ],
              f"{attn}: the cut tensor's blocks {cuts}")
        rec[attn] = dict(
            cli=dict(rc=rc, launches=counts, steps=SM_CLI_STEPS,
                     seconds=secs),
            losses=losses, ref_losses=ref_losses, loss_gaps=gaps,
            loss_tol=SM_LOSS_TOL, launches_per_step=per_step[-1],
            want_per_step=want, step_ms=ms, ref_step_ms=ref_ms,
            step_ms_median=statistics.median(ms[1:]),
            ref_step_ms_median=statistics.median(ref_ms[1:]),
            token_extents=extents, modules_hooked=len(seen), cut=cuts[0])
        del trainer
    # K2: the same mesh under SGD
    sgd_cfg = Config(transport="fused", model="transformer_lm",
                     batch_size=TRAIN_B, dtype="bfloat16",
                     model_parallel=SM_MODEL, seq_parallel=SM_SEQ,
                     **LM_OPTIMS["sgd"])
    plan = get_plan(dtype="bfloat16", mesh=mesh,
                    **dict(LM, attn="ring_flash"))
    trainer = FusedSplitTrainer(plan, sgd_cfg, init, tr_data[0][0],
                                mesh=mesh)
    want = sm_want(torch, "ring_flash", sgd=True)
    sgd_l, sgd_counts = [], []
    for x, y in tr_data[:SM_SGD_STEPS]:
        LAUNCHES.reset()
        sgd_l.append(trainer.train_step(x, y))
        sgd_counts.append(LAUNCHES.snapshot())
    check(all(c == want for c in sgd_counts) and all(
        math.isfinite(v) for v in sgd_l),
        f"SGD model x seq: launches {sgd_counts}, want {want}; {sgd_l}")
    print(f"[seq] ring_flash under SGD: losses {sgd_l}, launches a step "
          f"{sgd_counts[-1]}", flush=True)
    rec["sgd"] = dict(losses=sgd_l, launches_per_step=sgd_counts[-1],
                      steps=SM_SGD_STEPS)
    del trainer
    # the CPU twin: TWIN_ROWS rows, each step from the card's state
    rows = [(x[:TWIN_ROWS], y[:TWIN_ROWS])
            for x, y in tr_data[:SM_TWIN_STEPS]]
    twin_cfg = mcfg.replace(batch_size=TWIN_ROWS)
    cpu_mesh = make_mesh(model_parallel=SM_MODEL, seq_parallel=SM_SEQ,
                         device="cpu")
    card = FusedSplitTrainer(plan, twin_cfg, init, rows[0][0], mesh=mesh)
    cpu = FusedSplitTrainer(
        get_plan(dtype="bfloat16", mesh=cpu_mesh,
                 **dict(LM, attn="ring_flash")),
        twin_cfg, init, rows[0][0], mesh=cpu_mesh)
    card_l, cpu_l = [], []
    for x, y in rows:
        cpu.restore_states(card.export_states())
        card_l.append(card.train_step(x, y))
        cpu_l.append(cpu.train_step(x, y))
    twin_gaps = [abs(a - b) for a, b in zip(card_l, cpu_l)]
    twin_tols = [bf16_loss_tol(b) for b in cpu_l]
    check(all(g <= t for g, t in zip(twin_gaps, twin_tols)),
          f"model x seq CPU twin: card {card_l} vs cpu {cpu_l}")
    print(f"[seq] CPU twin on {TWIN_ROWS} rows x {len(rows)} steps: card "
          f"{card_l}, cpu {cpu_l} (gaps {twin_gaps})", flush=True)
    rec["cpu_twin"] = dict(card=card_l, cpu=cpu_l, gaps=twin_gaps,
                           tol=twin_tols, rows=TWIN_ROWS)
    return rec


def crossover_runs(torch, dev, gen) -> dict:
    """Phase 33 (c): dense ``full_attention`` against K5+K6, forward and
    backward, causal, at SM_CROSS_T with B*T SM_CROSS_TOKENS, bf16 and
    float32 (device ms, the median of SM_CROSS_REPS calls); the smallest
    T from which flash wins at every larger T measured, beside
    ``FLASH_SPEED_T``; ``select_attention``'s picks; then ``attn="auto"``
    on the LM (forward and backward at batch SM_AUTO_B) at the constant's
    T and the measured T below it: K5 and each K6 launch once a block at
    the one, none at the other."""
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.ops import flash_attention as fa
    from split_learning_tpu_torch.ops.common import LAUNCHES
    from split_learning_tpu_torch.ops.ring_attention import full_attention
    heads, d = LM["num_heads"], LM["d_model"] // LM["num_heads"]
    rec = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        itemsize = torch.tensor([], dtype=dtype).element_size()
        rows = {}
        for t in SM_CROSS_T:
            b = SM_CROSS_TOKENS // t
            shape = (b, t, heads, d)
            q, k, v = (torch.randn(shape, device=dev, generator=gen)
                       .to(dtype).requires_grad_(True) for _ in range(3))
            do = torch.randn(shape, device=dev, generator=gen).to(dtype)

            def run(attend):
                o = attend(q, k, v, causal=True)
                torch.autograd.grad(o, (q, k, v), do)

            rows[t] = dict(batch=b, dense_ms=device_ms(
                torch, lambda: run(full_attention), SM_CROSS_REPS),
                flash_ms=device_ms(torch, lambda: run(fa.flash_attention),
                                   SM_CROSS_REPS))
            del q, k, v, do
            torch.cuda.empty_cache()
        wins = {t for t in SM_CROSS_T
                if rows[t]["flash_ms"] < rows[t]["dense_ms"]}
        measured = next((t for t in SM_CROSS_T
                         if all(u in wins for u in SM_CROSS_T if u >= t)),
                        None)
        const = fa.FLASH_SPEED_T[itemsize]
        picks = {t: fa.select_attention(SM_CROSS_TOKENS // t, t, heads,
                                        itemsize, device=dev)
                 for t in SM_CROSS_T}
        print(f"[seq] crossover {name}: ms dense / flash (fwd+bwd) "
              + ", ".join(f"T {t}: {r['dense_ms']:.4f} / "
                          f"{r['flash_ms']:.4f}" for t, r in rows.items())
              + f"; flash wins from T {measured}, FLASH_SPEED_T {const}; "
              f"auto picks {picks}", flush=True)
        rec[name] = dict(times=rows, measured_crossover=measured,
                         constant=const, agrees=measured == const,
                         picks=picks)
    # attn="auto" on the LM on both sides of the constant
    for name, itemsize in (("bfloat16", 2), ("float32", 4)):
        cross = fa.FLASH_SPEED_T[itemsize]
        ts = [max([t for t in SM_CROSS_T if t < cross], default=cross // 2),
              cross]
        plan = get_plan(dtype=name, **dict(LM, attn="auto",
                                           max_len=max(SM_CROSS_T)))
        params = tuple({k: v.to(dev).requires_grad_(True)
                        for k, v in st.items()}
                       for st in plan.init(torch.Generator().manual_seed(0),
                                           torch.zeros(1)))
        leaves = [v for st in params for v in st.values()]
        launches = {}
        for t in ts:
            x = torch.randint(0, LM["vocab"], (SM_AUTO_B, t), device=dev)
            LAUNCHES.reset()
            out = plan.apply(params, x)
            torch.autograd.grad(out.float().sum(), leaves)
            torch.cuda.synchronize()
            counts = LAUNCHES.snapshot()
            k = N_BLOCKS if t >= cross else 0
            want = ({fa.NAME: k, **{nm: k for nm in fa.BWD_NAMES}}
                    if k else {})
            check(counts == want,
                  f"attn='auto' {name} at T {t}: launches {counts}, "
                  f"want {want} (FLASH_SPEED_T {cross})")
            launches[t] = counts
        print(f"[seq] attn='auto' {name} (FLASH_SPEED_T {cross}): launches "
              f"a forward and backward {launches}", flush=True)
        rec[name]["auto_launches"] = launches
    return rec


def seq_model_runs(torch, launch_run, dev, gen, bw, fp32, flash_peak,
                   tr_data) -> tuple:
    """Phase 33: (a) the kernel checks, (b) with its launch totals, (c).
    Returns the record, (b)'s totals, and (a)'s K5/K6 and K1 rows."""
    from split_learning_tpu_torch.ops.common import LAUNCHES
    t0 = time.perf_counter()
    fa_rec = mesh_flash_checks(torch, dev, gen, bw, flash_peak,
                               SM_FA_SHAPES)
    ce_rec = ce_row_checks(torch, dev, gen, bw, fp32, *SM_CE)
    rec = {"model": SM_MODEL, "seq": SM_SEQ, "placement": "virtual ranks "
           "on cuda:0", "batch": TRAIN_B, "seq_len": TRAIN_T}
    LAUNCHES.reset()   # the kernel checks' launches stay out of the totals
    totals, restore = _phase_totals(LAUNCHES)
    try:
        rec["lm"] = seq_model_lm_runs(torch, launch_run, tr_data)
    finally:
        restore()
    rec["crossover"] = crossover_runs(torch, dev, gen)
    LAUNCHES.reset()
    rec["seconds"] = time.perf_counter() - t0
    print(f"[seq] phase 33: {rec['seconds']:.1f} s", flush=True)
    return rec, totals, fa_rec, ce_rec


def phase33_main() -> int:
    """``chip_smoke.py --phase 33``: phase 33 alone on the card, with
    phase 10's training batches. Writes ``chiprun_out/p33.json``."""
    sys.path.insert(0, REPO)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs "
              "a CUDA card", file=sys.stderr)
        return 1
    from split_learning_tpu_torch.data import batches, synthetic_lm
    from split_learning_tpu_torch.launch import run as launch_run
    from split_learning_tpu_torch.ops.common import load_kernels
    from split_learning_tpu_torch.utils import (
        gpu_name_and_power_limit, resolve_device)
    t0 = time.perf_counter()
    dev = resolve_device("cuda")
    smi = gpu_name_and_power_limit().splitlines()[0]
    print(smi, sys.version.split()[0], torch.__version__, flush=True)
    bw, fp32, bf16_peak, tf32_peak, _ = card_peaks(
        torch.cuda.get_device_name(0))
    load_kernels()
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    lm = synthetic_lm(n_train=TRAIN_B * SM_LM_STEPS, n_test=TRAIN_B,
                      vocab=LM["vocab"], seq_len=TRAIN_T, seed=0)
    tr_data = list(batches(lm.train, TRAIN_B, seed=0, drop_remainder=True))
    gen = torch.Generator(device=dev).manual_seed(0)
    rec, totals, fa_rec, ce_rec = seq_model_runs(
        torch, launch_run, dev, gen, bw, fp32,
        {"bfloat16": bf16_peak, "float32": tf32_peak / 3}, tr_data)
    out = dict(card=smi, launches=totals, kernels=fa_rec, k1=ce_rec, **rec)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "p33.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)
    print(json.dumps({"seq_model": out}, default=str))
    print(f"[seq] phase 33 alone: {time.perf_counter() - t0:.1f} s")
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs "
              "a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import torch.nn.functional as F

    from split_learning_tpu_torch.data import batches, synthetic, synthetic_lm
    from split_learning_tpu_torch.launch import run as launch_run
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.ops.common import (
        LAUNCHES, NEG_BIG, load_kernels)
    from split_learning_tpu_torch.ops.cross_entropy import BWD, FWD
    from split_learning_tpu_torch.ops.sgd import (
        NAME as SGD, sgd_step_cuda, sgd_step_plain)
    import split_learning_tpu_torch.ops.flash_attention as fa_mod
    from split_learning_tpu_torch.ops.flash_attention import (
        BWD_DELTA, BWD_DKV, BWD_DQ, BWD_NAMES, NAME as FA,
        flash_attention_bwd_plain, flash_attention_with_lse,
        flash_attention_with_lse_plain, flash_bwd_cuda, flash_bwd_delta_cuda,
        flash_bwd_delta_plain, flash_bwd_dkv_cuda, flash_bwd_dkv_plain,
        flash_bwd_dq_cuda, flash_bwd_dq_plain, flash_fwd_cuda)
    from split_learning_tpu_torch.runtime import (
        FusedSplitTrainer, evaluate, greedy_generate, sample_generate)
    from split_learning_tpu_torch.utils import (
        Config, gpu_name_and_power_limit, resolve_device)

    # ---- 1. device and build ---------------------------------------- #
    t_script = time.perf_counter()

    def clock(n: int) -> None:
        """Print when phase ``n`` starts, in seconds since the imports
        (where the time limit goes)."""
        print(f"[clock] phase {n} at {time.perf_counter() - t_script:.1f} s",
              flush=True)

    dev = resolve_device("cuda")
    smi = gpu_name_and_power_limit().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    bw, fp32, bf16_peak, tf32_peak, peak_key = card_peaks(kind)
    # the flash kernels' roof by input dtype: bf16 operands, or float32
    # inputs as three TF32 products each (the 3xTF32 split)
    flash_peak = {"bfloat16": bf16_peak, "float32": tf32_peak / 3}
    print(f"[device] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | peaks of {peak_key}: "
          f"{bw / 1e12} TB/s, {fp32 / 1e12} TFLOP/s f32, "
          f"{bf16_peak / 1e12} TFLOP/s bf16, {tf32_peak / 1e12} TFLOP/s "
          f"TF32 ({tf32_peak / 3e12} as 3xTF32)", flush=True)
    t0 = time.perf_counter()
    planted_builds = start_planted_builds()   # phases 12 and 13's faults
    load_kernels()
    print(f"[build] kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)

    # ---- 2. cross-entropy kernels vs plain -------------------------- #
    clock(2)
    ce_err = ce_checks(torch, dev, gen)
    print(f"[k1] cross-entropy matches its plain version on "
          f"{ce_err['cases']} cases (N x C grid and {list(CE_LM)}, f32 and "
          f"bf16; two runs bit-identical; NaN rows), max abs err f32 loss "
          f"{ce_err['float32']['loss']:.3g}, grad "
          f"{ce_err['float32']['grad']:.3g} ({list(CE_LM)}: "
          f"{ce_err['float32']['grad_lm']:.3g}); bf16 loss "
          f"{ce_err['bfloat16']['loss']:.3g}, grad "
          f"{ce_err['bfloat16']['grad_ulps']} ulp", flush=True)

    # ---- 3. SGD kernel vs plain ------------------------------------- #
    clock(3)
    lm_shapes = [tuple(t.shape) for st in get_plan(dtype="float32", **LM).init(
        torch.Generator().manual_seed(0), torch.zeros(1)) for t in st.values()]
    check(len(lm_shapes) == LM_LEAVES, f"LM leaves: {len(lm_shapes)}")
    sgd_checks(torch, dev, gen, lm_shapes)
    print(f"[k2] SGD bit-identical to its plain version (mu 0 and 0.9, "
          f"5 steps; the CNN's 6 leaves, the LM's {LM_LEAVES} and {SGD_MANY} "
          f"mixed leaves, each step one launch)", flush=True)

    # ---- 4. the main path ------------------------------------------- #
    clock(4)
    ds = synthetic("mnist", n_train=BATCH * STEPS, n_test=512, seed=0)
    data = list(batches(ds.train, BATCH, seed=0, drop_remainder=True))
    check(len(data) == STEPS, "batch count")
    plan = get_plan(model="split_cnn", mode="split")
    cfg = Config(transport="fused", batch_size=BATCH, lr=LR)
    trainer = FusedSplitTrainer(plan, cfg, torch.Generator().manual_seed(0),
                                data[0][0], device="cuda")
    init_cpu = tuple({k: v.detach().cpu().clone() for k, v in st.items()}
                     for st in trainer.params)

    LAUNCHES.reset()
    losses, step_ms = [], []
    for x, y in data:
        t = time.perf_counter()
        losses.append(trainer.train_step(x, y))  # float(): syncs the step
        step_ms.append((time.perf_counter() - t) * 1e3)
    counts = LAUNCHES.snapshot()
    print(f"[main] {STEPS} steps, launches {counts}, losses "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)
    for name in (FWD, BWD, SGD):
        check(counts.get(name) == STEPS,
              f"{name} launched {counts.get(name)} times in {STEPS} steps")
    check(all(math.isfinite(v) for v in losses), "finite losses")
    check(statistics.mean(losses[-5:]) < statistics.mean(losses[:5]),
          f"loss did not fall: {losses}")
    for st in trainer.params:
        for k, v in st.items():
            check(bool(torch.isfinite(v).all()), f"finite param {k}")

    twin = FusedSplitTrainer(plan, cfg, init_cpu, data[0][0], device="cpu")
    twin_losses = [twin.train_step(x, y) for x, y in data[:3]]
    diffs = [abs(a - b) for a, b in zip(twin_losses, losses[:3])]
    check(max(diffs) <= 1e-4, f"CPU twin: {twin_losses} vs {losses[:3]}")
    res = evaluate(plan, trainer.params, ds.test, batch_size=512)
    check(0.0 <= res["accuracy"] <= 1.0 and math.isfinite(res["loss"]),
          f"evaluate: {res}")
    print(f"[main] CPU twin agrees (max diff {max(diffs):.3g}); test "
          f"accuracy {res['accuracy']:.4f}", flush=True)

    LAUNCHES.reset()
    rc = launch_run.main(["train", "--steps", "5", "--dataset", "synthetic",
                          "--data-dir",
                          os.path.join(REPO, "build", "chip_smoke_data")])
    cli_counts = LAUNCHES.snapshot()
    check(rc == 0, f"launch.run.main returned {rc}")
    check(all(cli_counts.get(n) == 5 for n in (FWD, BWD, SGD)),
          f"CLI launches {cli_counts}")

    # ---- 5. times ---------------------------------------------------- #
    clock(5)
    k1 = ce_times(torch, dev, gen, bw, fp32)
    ce_common = dict(route="cuda",
                     source="split_learning_tpu_torch/csrc/cross_entropy.cu",
                     jax_counterpart="split_learning_tpu/ops/cross_entropy.py"
                                     ":fused_cross_entropy",
                     shape=[BATCH, 10], dtype="float32")
    records = []
    for name, part, replaces, lib_call, err in (
            ("fused_cross_entropy_fwd", "fwd", "cross_entropy.py:58",
             "torch.nn.functional.cross_entropy (forward)",
             ce_err["float32"]["loss"]),
            ("fused_cross_entropy_bwd", "bwd", "cross_entropy.py:82",
             "torch.autograd.grad of F.cross_entropy (backward)",
             max(ce_err["float32"]["grad"], ce_err["float32"]["grad_lm"]))):
        records.append(dict(
            name=name, replaces=f"split_learning_tpu/ops/{replaces}",
            launches=counts[FWD if part == "fwd" else BWD],
            launches_per_step=1, max_abs_err=err, library_call=lib_call,
            **k1["cnn", "float32"][part], **ce_common,
            bfloat16=k1["cnn", "bfloat16"][part],
            lm_shape=dict(shape=list(CE_LM),
                          float32=k1["lm", "float32"][part],
                          bfloat16=k1["lm", "bfloat16"][part])))
    records[1]["max_bf16_ulps"] = ce_err["bfloat16"]["grad_ulps"]

    n_par = sum(math.prod(s) for s in CNN_LEAF_SHAPES)
    sgd_times = {}
    for mu in (0.0, 0.9):
        ps = [torch.randn(s, device=dev, generator=gen)
              for s in CNN_LEAF_SHAPES]
        gs = [torch.randn(s, device=dev, generator=gen) * 1e-3
              for s in CNN_LEAF_SHAPES]
        ms_ = [torch.zeros_like(t) for t in ps] if mu else None
        kernel = device_ms(torch, lambda: sgd_step_cuda(ps, gs, ms_, LR, mu))
        plain = device_ms(torch, lambda: sgd_step_plain(ps, gs, ms_, LR, mu))
        lib = {}
        for flag in ("foreach", "fused"):
            lp = [t.clone() for t in ps]
            for t, g in zip(lp, gs):
                t.grad = g
            opt = torch.optim.SGD(lp, lr=LR, momentum=mu, **{flag: True})
            lib[flag] = device_ms(torch, opt.step)
        nbytes = n_par * (20 if mu else 12)
        b_ms, b_by = bound(nbytes, n_par * (4 if mu else 2), bw, fp32)
        sgd_times[mu] = dict(ms=kernel, plain_ms=plain,
                             library_ms=lib["fused"],
                             library_foreach_ms=lib["foreach"],
                             bytes=nbytes, bound_ms=b_ms, bound_by=b_by)
    records.append(dict(
        name="fused_sgd_step", route="cuda",
        source="split_learning_tpu_torch/csrc/sgd.cu",
        replaces="split_learning_tpu/ops/sgd.py:56",
        jax_counterpart="split_learning_tpu/ops/sgd.py:fused_sgd_step",
        launches=counts[SGD], launches_per_step=1, max_abs_err=0.0,
        params=n_par, momentum=0.0,
        library_call="torch.optim.SGD(fused=True).step()",
        **sgd_times[0.0],
        with_momentum_0_9=sgd_times[0.9]))

    steady = step_ms[5:]
    step = dict(main_path=dict(
        model="split_cnn", mode="split", batch=BATCH, steps=STEPS,
        device=kind, step_ms_median=statistics.median(steady),
        steps_per_s=1e3 / statistics.median(steady),
        step_ms_first=step_ms[0], loss_first=losses[0],
        loss_last=losses[-1],
        profile=profile_steps(torch, trainer, data[:20])))

    # ---- 6. flash attention kernel vs plain ------------------------- #
    clock(6)
    fa_err = {"float32": [0.0, 0.0], "bfloat16": [0.0, 0.0]}
    fa_err_train = {"float32": [0.0, 0.0], "bfloat16": [0.0, 0.0]}
    n_cases = 0

    def fa_check(q, k, v, causal, strict, what, errs=fa_err):
        o_k, lse_k = flash_fwd_cuda(q, k, v, causal, strict)
        torch.cuda.synchronize()
        o_p, lse_p = flash_attention_with_lse_plain(q, k, v, causal, strict)
        name = str(q.dtype).replace("torch.", "")
        e_o = (o_k.float() - o_p.float()).abs().max().item()
        e_l = (lse_k - lse_p).abs().max().item()
        tol_o, tol_l = FA_TOL[name]
        check(e_o <= tol_o and e_l <= tol_l,
              f"flash {what} {name}: O err {e_o}, LSE err {e_l}")
        if strict:
            check(bool((o_k[:, 0] == 0).all()) and
                  bool((lse_k[:, 0] == NEG_BIG).all()),
                  f"flash {what} {name}: strict row 0 not (0, NEG_BIG)")
        errs[name][0] = max(errs[name][0], e_o)
        errs[name][1] = max(errs[name][1], e_l)

    for dtype in (torch.float32, torch.bfloat16):
        for t in FA_T:
            for d in FA_D:
                for b, h in FA_BH:
                    q, k, v = (torch.randn(b, t, h, d, device=dev,
                                           generator=gen).to(dtype)
                               for _ in range(3))
                    for causal, strict in FA_MASKS:
                        fa_check(q, k, v, causal, strict,
                                 f"B{b} T{t} H{h} D{d} causal={causal} "
                                 f"strict={strict}")
                        n_cases += 1
        # q, k, v as strided views of one packed [B, T, 3, H, D] tensor
        for d in FA_STRIDED_D:
            packed = torch.randn(2, 100, 3, 3, d, device=dev,
                                 generator=gen).to(dtype)
            fa_check(*packed.unbind(2), True, False, f"strided views D{d}")
            n_cases += 1
        # the LM training path's shape
        q, k, v = (torch.randn(TRAIN_SHAPE, device=dev, generator=gen).to(
            dtype) for _ in range(3))
        fa_check(q, k, v, True, False, f"training shape {TRAIN_SHAPE}",
                 fa_err_train)
        n_cases += 1
    print(f"[k5] flash attention matches its plain version on {n_cases} "
          f"cases (max abs err O/LSE: f32 {fa_err['float32'][0]:.3g}/"
          f"{fa_err['float32'][1]:.3g}, bf16 {fa_err['bfloat16'][0]:.3g}/"
          f"{fa_err['bfloat16'][1]:.3g}; at the training shape "
          f"{fa_err_train})", flush=True)

    # ---- 7. the serving path at full width -------------------------- #
    clock(7)
    plan_lm = get_plan(dtype="bfloat16", **LM)
    on_card = torch.zeros(1, device=dev)
    params_lm = plan_lm.init(torch.Generator().manual_seed(0), on_card)
    prompt = np.random.RandomState(0).randint(
        0, LM["vocab"], (SERVE_B, SERVE_P)).astype(np.int32)
    serve_counts = {}

    def counted(label, fn):
        LAUNCHES.reset()
        out = fn()
        torch.cuda.synchronize()
        serve_counts[label] = LAUNCHES.snapshot().get(FA, 0)
        return out

    toks = counted("kv_generate", lambda: greedy_generate(
        plan_lm, params_lm, prompt, SERVE_NEW, device="cuda"))
    check(tuple(toks.shape) == (SERVE_B, SERVE_P + SERVE_NEW),
          f"KV generate shape {tuple(toks.shape)}")
    check(bool((toks[:, :SERVE_P].cpu() == torch.from_numpy(prompt)).all()),
          "KV generate kept the prompt")
    check(0 <= toks.min().item() and toks.max().item() < LM["vocab"],
          "KV generate tokens in the vocabulary")
    check(serve_counts["kv_generate"] == N_BLOCKS,
          f"KV generate launched flash {serve_counts['kv_generate']} times")
    refwd = counted("reforward_generate", lambda: greedy_generate(
        plan_lm, params_lm, prompt, REFWD_NEW, kv_cache=False,
        device="cuda"))
    check(serve_counts["reforward_generate"] == N_BLOCKS * REFWD_NEW,
          f"re-forward generate launched flash "
          f"{serve_counts['reforward_generate']} times")
    agree = (refwd[:, SERVE_P:] == toks[:, SERVE_P:SERVE_P + REFWD_NEW]
             ).float().mean().item()

    def sample(seed):
        return sample_generate(
            plan_lm, params_lm, prompt, TWIN_NEW,
            torch.Generator(device=dev).manual_seed(seed), 0.8, top_k=40,
            top_p=0.9, device="cuda")

    s1 = counted("sample_generate", lambda: sample(1))
    s2 = sample(1)
    check(torch.equal(s1, s2), "sampling: one seed, two token streams")
    check(0 <= s1.min().item() and s1.max().item() < LM["vocab"],
          "sampled tokens in the vocabulary")
    check(serve_counts["sample_generate"] == N_BLOCKS,
          f"sample generate launched flash "
          f"{serve_counts['sample_generate']} times")
    lm_ds = synthetic_lm(n_train=8, n_test=4 * SERVE_B, vocab=LM["vocab"],
                         seq_len=SERVE_P, seed=0)
    res_lm = counted("evaluate", lambda: evaluate(
        plan_lm, params_lm, lm_ds.test, batch_size=SERVE_B))
    check(res_lm["perplexity"] is not None
          and math.isfinite(res_lm["perplexity"]), f"evaluate: {res_lm}")
    check(serve_counts["evaluate"] == N_BLOCKS * 4,
          f"evaluate launched flash {serve_counts['evaluate']} times in 4 "
          "batches")
    print(f"[serve] launches {serve_counts}; re-forward agrees with KV on "
          f"{agree:.3f} of its tokens; eval perplexity "
          f"{res_lm['perplexity']:.2f}", flush=True)

    # CPU twin at float32 from the same parameters
    plan32 = get_plan(dtype="float32", **LM)
    params_cpu = plan32.init(torch.Generator().manual_seed(0), torch.zeros(1))
    params_dev = tuple({k: v.to(dev) for k, v in st.items()}
                       for st in params_cpu)
    prompt2 = prompt[:TWIN_B]

    def prefill_logits(params, device):
        x = torch.from_numpy(prompt2).to(device)
        with torch.no_grad():
            for st, pr in zip(plan32.stages, params):
                x, _ = st.apply(pr, x, cache_len=SERVE_P)
        return x

    with torch.no_grad():
        want = plan32.apply(params_cpu, torch.from_numpy(prompt2))
    twin_prefill = (prefill_logits(params_dev, dev).cpu() - want).abs().max()
    check(twin_prefill.item() <= 1e-4,
          f"CPU twin: prefill logits differ by {twin_prefill.item()}")
    toks32 = greedy_generate(plan32, params_dev, prompt2, TWIN_NEW,
                             device="cuda").cpu()
    with torch.no_grad():
        cpu_logits = plan32.apply(params_cpu, toks32[:, :-1])
    rows = cpu_logits[:, SERVE_P - 1:]
    chosen = rows.gather(-1, toks32[:, SERVE_P:, None].long())[..., 0]
    gap = (rows.max(dim=-1).values - chosen).max().item()
    check(gap <= 1e-4, f"CPU twin: a card token is {gap} below the CPU "
                       "row's max logit")
    print(f"[serve] CPU twin: prefill logits within {twin_prefill.item():.3g}"
          f"; {TWIN_B}x{TWIN_NEW} greedy tokens within {gap:.3g} of the CPU "
          "row max", flush=True)

    # ---- 8. times ---------------------------------------------------- #
    clock(8)
    prefill_shape = (SERVE_B, SERVE_P, LM["num_heads"],
                     LM["d_model"] // LM["num_heads"])
    fa_rec = {"prefill": {}, "train": {}}
    for label, shape in (("prefill", prefill_shape), ("train", TRAIN_SHAPE)):
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).replace("torch.", "")
            q, k, v = (torch.randn(shape, device=dev, generator=gen).to(dtype)
                       for _ in range(3))
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            n = math.prod(shape)
            nbytes = 4 * n * q.element_size() + n // shape[3] * 4
            flops = 2 * shape[0] * shape[2] * shape[1] ** 2 * shape[3]
            b_ms, b_by = bound(nbytes, flops, bw, flash_peak[name])
            fa_rec[label][name] = dict(
                shape=list(shape), dtype=name, causal=True,
                ms=device_ms(torch, lambda: flash_fwd_cuda(q, k, v, True)),
                plain_ms=device_ms(
                    torch, lambda: flash_attention_with_lse_plain(
                        q, k, v, True), reps=10),
                library_ms=device_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True)),
                bytes=nbytes, flops=flops, bound_ms=b_ms, bound_by=b_by,
                bound_peak_flops=flash_peak[name])
            del q, k, v, qt, kt, vt
    for name, rec in fa_rec["prefill"].items():
        rec.update(max_abs_err=fa_err[name][0],
                   max_abs_err_lse=fa_err[name][1],
                   train_shape_max_abs_err=fa_err_train[name])
    print("[k5] ms kernel / bound / library: " + "; ".join(
        f"{label} {name} {r['ms']:.4f} / {r['bound_ms']:.4f} / "
        f"{r['library_ms']:.4f}" for label, recs in fa_rec.items()
        for name, r in recs.items()), flush=True)
    records.append(dict(
        name="flash_attention_fwd", route="cuda",
        source="split_learning_tpu_torch/csrc/flash_attention.cu",
        replaces="split_learning_tpu/ops/flash_attention.py:391",
        jax_counterpart="split_learning_tpu/ops/flash_attention.py"
                        ":flash_attention",
        launches=serve_counts["kv_generate"], launches_per_generate=N_BLOCKS,
        launches_reforward=serve_counts["reforward_generate"],
        launches_evaluate=serve_counts["evaluate"],
        library_call="torch.nn.functional.scaled_dot_product_attention("
                     "is_causal=True)",
        **fa_rec["prefill"]["bfloat16"],
        float32=fa_rec["prefill"]["float32"], train_shape=fa_rec["train"]))

    def prefill():
        x = torch.from_numpy(prompt).to(dev)
        with torch.no_grad():
            for st, pr in zip(plan_lm.stages, params_lm):
                x, _ = st.apply(pr, x, cache_len=SERVE_P + SERVE_NEW)
        return x

    prefill_ms = host_ms(torch, prefill, reps=5)
    kv_ms = host_ms(torch, lambda: greedy_generate(
        plan_lm, params_lm, prompt, SERVE_NEW, device="cuda"))
    refwd_ms = host_ms(torch, lambda: greedy_generate(
        plan_lm, params_lm, prompt, REFWD_NEW, kv_cache=False,
        device="cuda"))
    decode_ms = kv_ms - prefill_ms
    serving = dict(serving_path=dict(
        model="transformer_lm", mode="split", dtype="bfloat16",
        d_model=LM["d_model"], num_heads=LM["num_heads"],
        vocab=LM["vocab"], blocks=N_BLOCKS, attn="flash", batch=SERVE_B,
        prompt=SERVE_P, new_tokens=SERVE_NEW, device=kind,
        prefill_ms=prefill_ms, kv_generate_ms=kv_ms,
        kv_decode_ms_per_token=decode_ms / (SERVE_NEW - 1),
        kv_decode_tokens_per_s=SERVE_B * (SERVE_NEW - 1) / decode_ms * 1e3,
        kv_generate_tokens_per_s=SERVE_B * SERVE_NEW / kv_ms * 1e3,
        reforward_new_tokens=REFWD_NEW, reforward_generate_ms=refwd_ms,
        reforward_tokens_per_s=SERVE_B * REFWD_NEW / refwd_ms * 1e3,
        flash_launches=serve_counts, eval_perplexity=res_lm["perplexity"],
        twin_prefill_max_abs=twin_prefill.item(), twin_token_gap=gap,
        profile_kv_generate=profile_window(torch, lambda: greedy_generate(
            plan_lm, params_lm, prompt, SERVE_NEW, device="cuda"), 1,
            per="generate")))

    # ---- 9. flash backward kernels vs plain ------------------------- #
    clock(9)
    bwd_err, bwd_err_train = ({dt: {n: 0.0 for n in BWD_NAMES}
                               for dt in ("float32", "bfloat16")}
                              for _ in range(2))
    n_bwd = 0

    def bwd_check(q, k, v, do, g_lse, causal, strict, what, errs=bwd_err):
        """Each K6 launch against its plain part, on the same inputs."""
        name = str(q.dtype).replace("torch.", "")
        tol = FA_BWD_TOL[name]
        o, lse = flash_fwd_cuda(q, k, v, causal, strict)
        delta = flash_bwd_delta_cuda(o, do, g_lse)
        dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, strict)
        dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, strict)
        torch.cuda.synchronize()
        parts = {
            BWD_DELTA: ((delta,), (flash_bwd_delta_plain(o, do, g_lse),)),
            BWD_DKV: ((dk, dv), flash_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                    causal, strict)),
            BWD_DQ: ((dq,), (flash_bwd_dq_plain(q, k, v, do, lse, delta,
                                                causal, strict),))}
        for launch, (got, want) in parts.items():
            for a, b in zip(got, want):
                err = (a.float() - b.float()).abs().max().item()
                scale = max(1.0, b.float().abs().max().item())
                check(a.dtype == b.dtype and err <= tol * scale,
                      f"{launch} {what} {name}: err {err} (scale {scale})")
                errs[name][launch] = max(errs[name][launch], err)
        # the composite launcher is the kernels above, in order
        whole = flash_bwd_cuda(q, k, v, o, lse, do, g_lse, causal, strict)
        check(all(torch.equal(a, b) for a, b in zip(whole, (dq, dk, dv))),
              f"flash_bwd_cuda {what} {name}: differs from its launches")
        if strict:
            check(bool((dq[:, 0] == 0).all()),
                  f"K6 {what} {name}: strict row 0 has dq != 0")

    for dtype in (torch.float32, torch.bfloat16):
        for t in FA_T:
            for d in FA_D:
                for b, h in FA_BH:
                    q, k, v, do = (torch.randn(b, t, h, d, device=dev,
                                               generator=gen).to(dtype)
                                   for _ in range(4))
                    g_lse = torch.randn(b, t, h, device=dev, generator=gen)
                    for causal, strict in FA_MASKS:
                        for gl in (None, g_lse):
                            bwd_check(q, k, v, do, gl, causal, strict,
                                      f"B{b} T{t} H{h} D{d} causal={causal} "
                                      f"strict={strict} g_lse={gl is not None}")
                            n_bwd += 1
        # q, k, v and dO as strided views of one packed tensor
        for d in FA_STRIDED_D:
            packed = torch.randn(2, 100, 4, 3, d, device=dev,
                                 generator=gen).to(dtype)
            bwd_check(*packed.unbind(2), None, True, False,
                      f"strided views D{d}")
            n_bwd += 1
        # the LM training path's shape: causal, no LSE cotangent
        q, k, v, do = (torch.randn(TRAIN_SHAPE, device=dev,
                                   generator=gen).to(dtype)
                       for _ in range(4))
        bwd_check(q, k, v, do, None, True, False,
                  f"training shape {TRAIN_SHAPE}", bwd_err_train)
        n_bwd += 1
        del q, k, v, do

    # autograd through the kernels against autograd of dense attention
    aq, ak, av, aw = (torch.randn(2, 300, 2, 128, device=dev, generator=gen)
                      for _ in range(4))
    aw_lse = torch.randn(2, 300, 2, device=dev, generator=gen)

    def dense_with_lse(q, k, v):
        s_ = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[3] ** -0.5
        keep = torch.ones(s_.shape[-1], s_.shape[-1], dtype=torch.bool,
                          device=dev).tril()
        s_ = s_.masked_fill(~keep, NEG_BIG)
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s_, dim=-1), v)
        return o, torch.logsumexp(s_, dim=-1).permute(0, 2, 1)

    def attn_grads(fn):
        leaves = [x.clone().requires_grad_(True) for x in (aq, ak, av)]
        o, lse = fn(*leaves)
        return torch.autograd.grad((o * aw).sum() + (lse * aw_lse).sum(),
                                   leaves)

    LAUNCHES.reset()
    g_flash = attn_grads(lambda *a: flash_attention_with_lse(*a, causal=True))
    torch.cuda.synchronize()
    check(LAUNCHES.snapshot() == {FA: 1, **{n: 1 for n in BWD_NAMES}},
          f"autograd launches {LAUNCHES.snapshot()}")
    g_dense = attn_grads(dense_with_lse)
    autograd_err = max((a - b).abs().max().item() / max(
        1.0, b.abs().max().item()) for a, b in zip(g_flash, g_dense))
    check(autograd_err <= FA_BWD_TOL["float32"],
          f"autograd through flash vs dense: rel err {autograd_err}")
    g_again = attn_grads(lambda *a: flash_attention_with_lse(*a,
                                                             causal=True))
    check(all(torch.equal(a, b) for a, b in zip(g_flash, g_again)),
          "two runs of the flash backward differ")
    print(f"[k6] flash backward matches its plain version on {n_bwd} cases "
          f"(max abs err f32 {bwd_err['float32']}, bf16 "
          f"{bwd_err['bfloat16']}; at the training shape {bwd_err_train}); "
          f"autograd vs dense rel err "
          f"{autograd_err:.3g}; two runs bit-identical", flush=True)

    # ---- 10. the training path at full width ------------------------ #
    clock(10)
    plan_tr = get_plan(dtype="float32", **LM)
    lm_train = synthetic_lm(n_train=TRAIN_B * TRAIN_STEPS, n_test=TRAIN_B,
                            vocab=LM["vocab"], seq_len=TRAIN_T, seed=0)
    tr_data = list(batches(lm_train.train, TRAIN_B, seed=0,
                           drop_remainder=True))
    check(len(tr_data) == TRAIN_STEPS, "LM batch count")
    cfg_tr = Config(transport="fused", model="transformer_lm", attn="flash",
                    batch_size=TRAIN_B, lr=TRAIN_LR, momentum=TRAIN_MU)
    trainer_lm = FusedSplitTrainer(plan_tr, cfg_tr,
                                   torch.Generator().manual_seed(0),
                                   tr_data[0][0], device="cuda")
    tr_init = tuple({k: v.detach().cpu().clone() for k, v in st.items()}
                    for st in trainer_lm.params)
    check(sum(len(st) for st in tr_init) == LM_LEAVES, "LM leaf count")

    LAUNCHES.reset()
    tr_losses, tr_ms = [], []
    for x, y in tr_data:
        t = time.perf_counter()
        tr_losses.append(trainer_lm.train_step(x, y))  # float(): syncs
        tr_ms.append((time.perf_counter() - t) * 1e3)
    tr_counts = LAUNCHES.snapshot()
    want_counts = {FA: N_BLOCKS * TRAIN_STEPS,
                   **{n: N_BLOCKS * TRAIN_STEPS for n in BWD_NAMES},
                   FWD: TRAIN_STEPS, BWD: TRAIN_STEPS,
                   SGD: TRAIN_STEPS}
    print(f"[train] {TRAIN_STEPS} steps, launches {tr_counts}, losses "
          f"{tr_losses[0]:.4f} -> {tr_losses[-1]:.4f}", flush=True)
    check(tr_counts == want_counts,
          f"training launches {tr_counts}, want {want_counts}")
    check(all(math.isfinite(v) for v in tr_losses), "finite LM losses")
    check(statistics.mean(tr_losses[-5:]) < statistics.mean(tr_losses[:5]),
          f"LM loss did not fall: {tr_losses}")
    for st in trainer_lm.params:
        for k, v in st.items():
            check(bool(torch.isfinite(v).all()), f"finite LM param {k}")

    cfg_twin = cfg_tr.replace(batch_size=TWIN_ROWS)
    rows = [(x[:TWIN_ROWS], y[:TWIN_ROWS]) for x, y in tr_data[:TWIN_STEPS]]
    twin_card = FusedSplitTrainer(plan_tr, cfg_twin, tr_init, rows[0][0],
                                  device="cuda")
    twin_cpu = FusedSplitTrainer(plan_tr, cfg_twin, tr_init, rows[0][0],
                                 device="cpu")
    card_rows = [twin_card.train_step(x, y) for x, y in rows]
    cpu_rows = [twin_cpu.train_step(x, y) for x, y in rows]
    twin_lm_diff = max(abs(a - b) for a, b in zip(card_rows, cpu_rows))
    check(twin_lm_diff <= TWIN_TOL,
          f"LM CPU twin: {cpu_rows} vs card {card_rows}")

    def update_err(params, ref):
        """Worst leaf's max abs difference of the summed update (final
        minus initial parameters) from ``ref``'s, over the larger of
        ``ref``'s largest update entry in that leaf and TWIN_UPDATE_FLOOR
        of the largest in any leaf: ``(error, leaf)``."""
        diffs, tops = {}, {}
        for i, (st, st_ref, st0) in enumerate(zip(params, ref, tr_init)):
            for key, p0 in st0.items():
                u_ref = st_ref[key].detach().cpu() - p0
                tops[i, key] = u_ref.abs().max().item()
                diffs[i, key] = (st[key].detach().cpu() - p0
                                 - u_ref).abs().max().item()
        floor = TWIN_UPDATE_FLOOR * max(tops.values())
        rel = {leaf: diffs[leaf] / max(tops[leaf], floor) for leaf in tops}
        leaf = max(rel, key=rel.get)
        return rel[leaf], f"stage {leaf[0]} {leaf[1]}"

    twin_update, twin_leaf = update_err(twin_card.params, twin_cpu.params)
    check(twin_update <= TWIN_UPDATE_TOL,
          f"LM CPU twin: parameter updates differ by {twin_update} in "
          f"{twin_leaf}")
    # the check must see a broken backward: the CPU twin again, with the
    # plain backward's dQ planted as zero
    planted = fa_mod.flash_attention_bwd_plain

    def zero_dq(*args):
        dq, dk, dv = planted(*args)
        return torch.zeros_like(dq), dk, dv

    fa_mod.flash_attention_bwd_plain = zero_dq
    try:
        twin_bad = FusedSplitTrainer(plan_tr, cfg_twin, tr_init, rows[0][0],
                                     device="cpu")
        bad_rows = [twin_bad.train_step(x, y) for x, y in rows]
    finally:
        fa_mod.flash_attention_bwd_plain = planted
    bad_update, bad_leaf = update_err(twin_bad.params, twin_cpu.params)
    bad_loss = max(abs(a - b) for a, b in zip(bad_rows, cpu_rows))
    check(bad_update > TWIN_UPDATE_TOL,
          f"a zero dQ moved the updates by only {bad_update}")
    print(f"[train] CPU twin on {TWIN_ROWS} rows x {TWIN_STEPS} steps agrees "
          f"(losses within {twin_lm_diff:.3g}; updates within "
          f"{twin_update:.3g}, worst in {twin_leaf}, tolerance "
          f"{TWIN_UPDATE_TOL}); a planted zero dQ moves the updates by "
          f"{bad_update:.3g} (in {bad_leaf}) and the losses by "
          f"{bad_loss:.3g}", flush=True)

    cli_runs = {}
    for model, dataset, size in (
            ("transformer_lm", "lm", ["--seq-len", "128", "--d-model", "64",
                                      "--batch-size", "8"]),
            ("transformer", "tokens", ["--seq-len", "256", "--d-model",
                                       str(LM["d_model"]), "--batch-size",
                                       str(TRAIN_B)])):
        LAUNCHES.reset()
        rc = launch_run.main([
            "train", "--model", model, "--dataset", dataset, "--attn",
            "flash", "--num-heads", "2", "--steps", "5", "--lr", "0.1",
            "--tracking", "noop", "--data-dir",
            os.path.join(REPO, "build", "chip_smoke_data"), *size])
        cli_runs[model] = LAUNCHES.snapshot()
        check(rc == 0, f"launch.run.main {model} returned {rc}")
        check(cli_runs[model] == {FA: 15, **{n: 15 for n in BWD_NAMES},
                                  FWD: 5, BWD: 5, SGD: 5},
              f"CLI {model} launches {cli_runs[model]}")
    print(f"[train] CLI trained transformer_lm and transformer 5 steps each "
          f"(launches {cli_runs})", flush=True)

    # ---- 11. times ---------------------------------------------------- #
    clock(11)
    shape = TRAIN_SHAPE
    head_dim = shape[3]
    n_rows, n_el = math.prod(shape[:3]), math.prod(shape)
    bh = shape[0] * shape[2]
    pairs = TRAIN_T * (TRAIN_T + 1) // 2 * bh   # live causal (row, col)
    # products of T x T x D per kernel: dK/dV 4 (S, dP, dV, dK), dQ 3
    # (S, dP, dQ); the least work for the whole backward is 5
    work = {BWD_DELTA: 2 * n_el, BWD_DKV: 8 * pairs * head_dim,
            BWD_DQ: 6 * pairs * head_dim, "whole": 10 * pairs * head_dim}
    k6_rec = {n: {} for n in BWD_NAMES}
    k6_whole = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        # the delta launch is a float32 row sum on the CUDA cores; the
        # products run on the tensor cores
        peak = {n: flash_peak[name] for n in (BWD_DKV, BWD_DQ, "whole")}
        peak[BWD_DELTA] = fp32
        e = torch.tensor([], dtype=dtype).element_size()
        q, k, v, do = (torch.randn(shape, device=dev, generator=gen).to(dtype)
                       for _ in range(4))
        o, lse = flash_fwd_cuda(q, k, v, True)
        delta = flash_bwd_delta_cuda(o, do)
        nbytes = {BWD_DELTA: 2 * n_el * e + 4 * n_rows,
                  BWD_DKV: 6 * n_el * e + 8 * n_rows,
                  BWD_DQ: 5 * n_el * e + 8 * n_rows,
                  "whole": 8 * n_el * e + 4 * n_rows}
        launch = {BWD_DELTA: lambda: flash_bwd_delta_cuda(o, do),
                  BWD_DKV: lambda: flash_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                                      True),
                  BWD_DQ: lambda: flash_bwd_dq_cuda(q, k, v, do, lse, delta,
                                                    True)}
        plain = {BWD_DELTA: lambda: flash_bwd_delta_plain(o, do),
                 BWD_DKV: lambda: flash_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                      True),
                 BWD_DQ: lambda: flash_bwd_dq_plain(q, k, v, do, lse, delta,
                                                    True)}
        for n in BWD_NAMES:
            b_ms, b_by = bound(nbytes[n], work[n], bw, peak[n])
            k6_rec[n][name] = dict(
                ms=device_ms(torch, launch[n], reps=20),
                plain_ms=device_ms(torch, plain[n], reps=10),
                bytes=nbytes[n], flops=work[n], bound_ms=b_ms, bound_by=b_by,
                bound_peak_flops=peak[n],
                max_abs_err=bwd_err_train[name][n],
                max_abs_err_grid=bwd_err[name][n])
        # delta with no LSE cotangent, as on the training path, is one
        # library call (its output in the input dtype)
        k6_rec[BWD_DELTA][name]["library_ms"] = device_ms(
            torch, lambda: torch.linalg.vecdot(o, do, dim=-1), reps=20)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        do_t = do.transpose(1, 2)
        b_ms, b_by = bound(nbytes["whole"], work["whole"], bw, peak["whole"])
        k6_whole[name] = dict(
            shape=list(shape), dtype=name, causal=True,
            ms=device_ms(torch, lambda: flash_bwd_cuda(q, k, v, o, lse, do,
                                                       None, True), reps=20),
            plain_ms=device_ms(torch, lambda: flash_attention_bwd_plain(
                q, k, v, o, lse, do, None, True), reps=10),
            library_ms=device_ms(torch, lambda: torch.autograd.grad(
                lib_out, (qt, kt, vt), do_t, retain_graph=True), reps=20),
            library_call="torch.autograd.grad of "
                         "F.scaled_dot_product_attention(is_causal=True)",
            bytes=nbytes["whole"], flops=work["whole"], bound_ms=b_ms,
            bound_by=b_by, bound_peak_flops=peak["whole"])
        # no library call computes dK, dV or dQ alone: the SDPA backward,
        # which computes all three, stands on the dK/dV record
        k6_rec[BWD_DKV][name]["library_ms"] = k6_whole[name]["library_ms"]
        k6_rec[BWD_DQ][name]["library_ms"] = None
        del q, k, v, do, o, lse, delta, qt, kt, vt, lib_out, do_t
    replaces = {BWD_DELTA: "split_learning_tpu/ops/flash_attention.py:693",
                BWD_DKV: "split_learning_tpu/ops/flash_attention.py:542",
                BWD_DQ: "split_learning_tpu/ops/flash_attention.py:503"}
    library_call = {
        BWD_DELTA: "torch.linalg.vecdot(o, do, dim=-1)",
        BWD_DKV: "torch.autograd.grad of F.scaled_dot_product_attention("
                 "is_causal=True): the whole backward, all three launches",
        BWD_DQ: None}
    for n in BWD_NAMES:
        records.append(dict(
            name=n, route="cuda",
            source="split_learning_tpu_torch/csrc/flash_attention_bwd.cu",
            replaces=replaces[n],
            also_replaces="split_learning_tpu/ops/flash_attention.py:443",
            jax_counterpart="split_learning_tpu/ops/flash_attention.py"
                            ":_make_flash.vjp_bwd",
            launches=tr_counts[n], launches_per_step=N_BLOCKS,
            library_call=library_call[n],
            shape=list(shape), dtype="float32", causal=True,
            **k6_rec[n]["float32"], bfloat16=k6_rec[n]["bfloat16"]))
    records[-1]["library_note"] = (
        "no one PyTorch call computes dQ alone; the SDPA backward, which "
        "computes dQ, dK and dV, is the dK/dV record's library_ms")
    launch_of = {"fused_cross_entropy_fwd": FWD,
                 "fused_cross_entropy_bwd": BWD, "fused_sgd_step": SGD}
    for rec in records:
        rec["launches_train_lm"] = tr_counts[launch_of.get(rec["name"],
                                                           rec["name"])]

    steady_tr = tr_ms[5:]
    train_lm = dict(train_lm=dict(
        model="transformer_lm", mode="split", dtype="float32",
        d_model=LM["d_model"], num_heads=LM["num_heads"], vocab=LM["vocab"],
        blocks=N_BLOCKS, attn="flash", batch=TRAIN_B, seq_len=TRAIN_T,
        steps=TRAIN_STEPS, lr=TRAIN_LR, momentum=TRAIN_MU, device=kind,
        step_ms_median=statistics.median(steady_tr),
        step_ms_min=min(steady_tr), step_ms_max=max(steady_tr),
        tokens_per_s=TRAIN_B * TRAIN_T / statistics.median(steady_tr) * 1e3,
        step_ms_first=tr_ms[0], loss_first=tr_losses[0],
        loss_last=tr_losses[-1], launches=tr_counts,
        twin_rows=TWIN_ROWS, twin_steps=TWIN_STEPS,
        twin_max_abs_diff=twin_lm_diff, twin_update_rel_err=twin_update,
        twin_update_worst_leaf=twin_leaf,
        planted_zero_dq_update_rel_err=bad_update,
        planted_zero_dq_loss_diff=bad_loss, cli_launches=cli_runs,
        k6=k6_whole, k6_autograd_rel_err=autograd_err,
        profile=profile_steps(torch, trainer_lm, tr_data[:10])))

    # ---- 12. wire kernels vs plain ----------------------------------- #
    clock(12)
    from split_learning_tpu_torch.ops import quantize as qmod
    from split_learning_tpu_torch.ops import topk as kmod
    wire_err, wire_cases, wire_frames, ties_changed = wire_kernel_checks(
        torch, dev, gen, planted_builds)
    print(f"[k3/k4] wire kernels bit-equal to their plain versions on "
          f"{wire_cases} cases, {wire_frames} card frames byte-equal to the "
          f"host codec's; NaN and inf refused; a planted tie-break K4 "
          f"changes {ties_changed} of 2 all-equal frames", flush=True)

    # ---- 13. the two-party path at full width ---------------------- #
    clock(13)
    two_party, tp_counts = two_party_runs(torch, dev, data, planted_builds)

    # ---- 14. times ---------------------------------------------------- #
    clock(14)
    wire_rec, encode_times = wire_times(torch, dev, gen, bw, fp32)
    # K2 at the LM's 54 leaves (one launch a step)
    p_lm = [torch.randn(s_, device=dev, generator=gen) for s_ in lm_shapes]
    g_lm = [1e-3 * torch.randn(s_, device=dev, generator=gen)
            for s_ in lm_shapes]
    m_lm = [torch.zeros_like(t) for t in p_lm]
    n_lm = sum(t.numel() for t in p_lm)
    opt_p = [t.clone() for t in p_lm]
    for t, g_ in zip(opt_p, g_lm):
        t.grad = g_
    opt = torch.optim.SGD(opt_p, lr=TRAIN_LR, momentum=TRAIN_MU, fused=True)
    b_ms, b_by = bound(20 * n_lm, 4 * n_lm, bw, fp32)
    LAUNCHES.reset()
    sgd_step_cuda(p_lm, g_lm, m_lm, TRAIN_LR, TRAIN_MU)
    records[2]["lm_leaves"] = dict(
        leaves=LM_LEAVES, params=n_lm, momentum=TRAIN_MU,
        launches_per_step=LAUNCHES.snapshot()[SGD],
        ms=device_ms(torch, lambda: sgd_step_cuda(p_lm, g_lm, m_lm, TRAIN_LR,
                                                  TRAIN_MU)),
        plain_ms=device_ms(torch, lambda: sgd_step_plain(
            p_lm, g_lm, m_lm, TRAIN_LR, TRAIN_MU)),
        library_ms=device_ms(torch, opt.step), bytes=20 * n_lm,
        bound_ms=b_ms, bound_by=b_by)
    del p_lm, g_lm, m_lm, opt_p, opt

    # ---- 15. split-party LM decode at full width ------------------- #
    clock(15)
    decode, dec_counts, dec_ctx = decode_runs(torch, dev)

    # ---- 16. the two-party path over HTTP --------------------------- #
    clock(16)
    http_rec, http_counts, http_keep = http_runs(torch, dev, data, two_party)

    # ---- 17. split-party inference and the CLI over HTTP ------------ #
    clock(17)
    http_serving_rec, http_dec_counts = http_serving(
        torch, launch_run, ds, http_keep, dec_ctx, decode)

    # ---- 18. K2 on bf16 leaves; the fused LM in bf16 ----------------- #
    clock(18)
    lm_bf16_leaves = [(tuple(t.shape), t.dtype) for st in get_plan(
        dtype="bfloat16", **LM).init(torch.Generator().manual_seed(0),
                                     torch.zeros(1)) for t in st.values()]
    check(len(lm_bf16_leaves) == LM_LEAVES
          and sum(dt == torch.bfloat16 for _, dt in lm_bf16_leaves) == 1,
          "the bf16 LM: 54 leaves, its pos table bf16")
    k2_lists = k2_bf16_checks(torch, dev, gen, lm_bf16_leaves)
    print(f"[k2] bf16: bit-identical to its plain version on {k2_lists} "
          f"mixed float32/bf16 leaf lists (the bf16 LM's {LM_LEAVES}, "
          f"{SGD_MANY} of odd sizes, unaligned views; mu 0 and 0.9, 5 steps), "
          "each step one launch", flush=True)
    records[2]["bf16_lm_leaves"] = k2_bf16_times(torch, dev, gen,
                                                 lm_bf16_leaves, bw, fp32)
    bf16_runs, bf16_counts = lm_bf16_runs(torch, tr_data)

    # ---- 19. the two-party LM: local wire, then the CLI over HTTP ---- #
    clock(19)
    tp_lm, tp_lm_counts = two_party_lm_runs(torch, tr_data)
    tp_lm["cli_http"] = lm_cli_http(torch, launch_run)

    # ---- 20. the U-shaped CNN ---------------------------------------- #
    clock(20)
    u_cnn, u_cnn_counts = u_cnn_runs(torch, data)

    # ---- 21. the U-shaped LM at full width, bf16 --------------------- #
    clock(21)
    u_lm, u_lm_counts = u_lm_runs(torch, tr_data)

    # ---- 22. federated training over HTTP ---------------------------- #
    clock(22)
    fed, fed_counts = federated_http_runs(torch)

    # ---- 23. the multi-client runner, then the CLI of 20-23 --------- #
    clock(23)
    mc, mc_counts = multi_client_runs(torch)
    cli_u_fed = u_fed_cli(torch, launch_run)

    # ---- 24. checkpoints and what loads them ------------------------- #
    clock(24)
    ckpt_rec, ckpt_counts = checkpoint_runs(torch, launch_run)

    # ---- 25. the server under many clients --------------------------- #
    clock(25)
    many_rec, many_counts = many_clients_runs(torch, tr_data)

    # ---- 26. the image families: ResNet-18 and the ViT --------------- #
    clock(26)
    image_rec, image_counts, vit_fa = image_runs(
        torch, launch_run, dev, gen, (bw, fp32, bf16_peak, flash_peak))

    # ---- 27. the K-stage chain --------------------------------------- #
    clock(27)
    chain_rec, chain_counts = chain_runs(torch, launch_run, image_rec)

    # ---- 28. observability ------------------------------------------ #
    clock(28)
    obs_rec, obs_counts = obs_runs(torch, launch_run, smi)

    # ---- 29. scan-steps, remat, replicas, autoscaling ---------------- #
    clock(29)
    fleet_rec, fleet_counts = fleet_runs(torch, launch_run, smi)

    # ---- 30. the device mesh ----------------------------------------- #
    clock(30)
    mesh_fa = mesh_flash_checks(torch, dev, gen, bw, flash_peak)
    mesh_rec, mesh_counts = mesh_runs(torch, launch_run, smi, tr_data)
    for name in (FA, *BWD_NAMES, FWD, BWD, SGD):
        check(mesh_counts.get(name, 0) > 0,
              f"phase 30's runs launched {name} no time: {mesh_counts}")

    # ---- 31. the model axis ------------------------------------------ #
    clock(31)
    tp_fa = mesh_flash_checks(torch, dev, gen, bw, flash_peak, TP_FA_SHAPES)
    tp_rec, tp_counts = model_axis_runs(torch, launch_run, smi, tr_data)
    for name in (FA, *BWD_NAMES, FWD, BWD, SGD):
        check(tp_counts.get(name, 0) > 0,
              f"phase 31's runs launched {name} no time: {tp_counts}")

    # ---- 32. the native host codec and the concurrency checker ------- #
    clock(32)
    an_rec = analysis_native_runs(torch, dev, smi, many_rec)

    # ---- 33. the seq axis with the model axis; attn="auto" ----------- #
    clock(33)
    sm_rec, sm_counts, sm_fa, sm_ce = seq_model_runs(
        torch, launch_run, dev, gen, bw, fp32, flash_peak, tr_data)
    for name in (FA, *BWD_NAMES, FWD, BWD, SGD):
        check(sm_counts.get(name, 0) > 0,
              f"phase 33's runs launched {name} no time: {sm_counts}")

    for rec in records:
        key = launch_of.get(rec["name"], rec["name"])
        rec["launches_train_lm_bf16"] = bf16_counts.get(key, 0)
        rec["launches_two_party_lm"] = tp_lm_counts.get(key, 0)
        rec["launches_two_party"] = tp_counts.get(key, 0)
        rec["launches_decode"] = dec_counts.get(key, 0)
        rec["launches_http"] = http_counts.get(key, 0)
        rec["launches_http_decode"] = http_dec_counts.get(key, 0)
    select_src = "topk_select.cu"
    wire_meta = {
        qmod.QUANT: ("quantize.cu", "split_learning_tpu/ops/quantize.py:44",
                     "torch.amax(x.abs()) + torch.quantize_per_tensor(x, "
                     "scale, 0, torch.qint8): two calls"),
        qmod.DEQUANT: ("quantize.cu",
                       "split_learning_tpu/ops/quantize.py:65",
                       "torch.dequantize(qint8 tensor)"),
        kmod.NAME: ("topk.cu", "split_learning_tpu/ops/topk.py:35",
                    "torch.abs(x)"),
        **{name: (select_src, "split_learning_tpu/ops/topk.py:35", None)
           for name in kmod.SELECT_LAUNCHES}}
    for name, (src, replaces, lib_call) in wire_meta.items():
        cuts = wire_rec[name]
        rec = dict(
            name=name, route="cuda",
            source=f"split_learning_tpu_torch/csrc/{src}",
            replaces=replaces, launches=tp_counts.get(name, 0),
            launches_decode=dec_counts.get(name, 0),
            launches_http=http_counts.get(name, 0),
            launches_http_decode=http_dec_counts.get(name, 0),
            launches_two_party_lm=tp_lm_counts.get(name, 0),
            launches_train_lm_bf16=bf16_counts.get(name, 0),
            launches_per_step={mode: r["launches_per_step"].get(name, 0)
                               for mode, r in two_party["modes"].items()},
            max_abs_err=wire_err[name], library_call=lib_call,
            shape=list(CNN_CUT), dtype="float32", **cuts["cnn_cut"],
            generate_cut=cuts["generate_cut"], lm_cut=cuts["lm_cut"])
        if src == select_src:
            # one launch of five: no plain version or library call of its
            # own; the whole encode's stand beside it
            rec.update(plain_ms=encode_times["cnn_cut"]["plain_ms"],
                       library_ms=None, plain_of="the whole encode")
            if name == kmod.SELECT_LAUNCHES[0]:
                rec["encode"] = encode_times
        if name == kmod.NAME:
            rec["path"] = "magnitudes() only; the codec runs the select launches"
        if name == qmod.QUANT:
            rec["also_replaces"] = ("split_learning_tpu/ops/quantize.py:56, "
                                    ":60 (the gridded amax and quantize)")
        records.append(rec)
    mc_rr = mc["runs"]["round-robin"]
    for rec in records:
        key = launch_of.get(rec["name"], rec["name"])
        rec["launches_u_split_cnn"] = u_cnn_counts.get(key, 0)
        rec["launches_u_split_lm_bf16"] = u_lm_counts.get(key, 0)
        rec["launches_federated"] = fed_counts.get(key, 0)
        rec["launches_multi_client"] = mc_counts.get(key, 0)
        rec["launches_checkpoint"] = ckpt_counts.get(key, 0)
        rec["launches_many_clients"] = many_counts.get(key, 0)
        rec["launches_per_step_new_paths"] = dict(
            u_split_cnn={m: r["launches_per_step"].get(key, 0)
                         for m, r in u_cnn["runs"].items()},
            u_split_lm_bf16={m: r["launches_per_step"].get(key, 0)
                             for m, r in u_lm["runs"].items()},
            federated_per_client_step=fed["launches_per_client_step"].get(
                key, 0),
            multi_client_per_round=mc_rr["launches_per_round"].get(key, 0),
            multi_client_per_compressed_sync=mc_rr[
                "select_launches_per_compressed_sync"].get(key, 0))
    many_group = many_rec["coalescing"]["runs"][
        "local none window"]["server_launches_per_group"]
    many_2bp = many_rec["decoupled_bwd"]
    for rec in records:
        key = launch_of.get(rec["name"], rec["name"])
        rec["launches_per_step_many_clients"] = dict(
            server_per_coalesced_group=many_group.get(key, 0),
            two_bp_cnn_per_step={
                lag: r["launches_per_step"].get(key, 0)
                for lag, r in many_2bp["cnn"]["runs"].items()},
            two_bp_lm_bf16_per_step={
                lag: r["launches_per_step"].get(key, 0)
                for lag, r in many_2bp["lm"]["runs"].items()},
            pipelined_lm_bf16_per_step=many_rec["pipelined"]["lm"][
                "launches_per_step"].get(key, 0))
    per_leg = {"resnet18_fused_" + dt: leg for dt, leg in
               image_rec["resnet18_fused"].items()}
    per_leg.update({"resnet18_two_party_" + m: leg for m, leg in
                    image_rec["resnet18_two_party"].items()})
    per_leg["vit_s_bf16"] = image_rec["vit_s_bf16"]
    per_leg["vit_two_party_topk8"] = image_rec["vit_two_party"]["topk8"]
    for rec in records:
        key = launch_of.get(rec["name"], rec["name"])
        rec["launches_image"] = image_counts.get(key, 0)
        rec["launches_per_step_image"] = {
            leg_name: leg["launches_per_step"].get(key, 0)
            for leg_name, leg in per_leg.items()}
        if rec["name"] == FA:
            rec["vit_shapes"] = {k: dict(r["fwd"], shape=r["shape"],
                                         dtype=r["dtype"], causal=False)
                                 for k, r in vit_fa.items()}
        if rec["name"] == BWD_DKV:
            rec["vit_shapes_whole_backward"] = {
                k: dict(r["bwd"], shape=r["shape"], dtype=r["dtype"],
                        causal=False) for k, r in vit_fa.items()}
    chain_legs = {f"resnet18_4stage_device_{dt}": leg for dt, leg in
                  chain_rec["resnet18_4stage"].items()}
    chain_legs.update({f"resnet18_4stage_local_{m}": leg for m, leg in
                       chain_rec["wires"].items() if "launches_per_step"
                       in leg})
    chain_legs["split_cnn_chain3_http_int8"] = chain_rec["cnn_chain_http"]
    for rec in records:
        key = launch_of.get(rec["name"], rec["name"])
        rec["launches_chain"] = chain_counts.get(key, 0)
        # measured: the leg's counts over its steps
        rec["launches_per_step_chain"] = {
            leg_name: leg["launches"].get(key, 0) / leg["steps"]
            for leg_name, leg in chain_legs.items()}
        # phase 28: the launches of its three parts (a's six runs, both
        # processes of b), and a step's of each
        rec["launches_obs"] = obs_counts.get(key, 0)
        rec["launches_per_step_obs"] = {
            part: obs_rec[part]["launches_per_step"].get(key, 0)
            for part in ("lm", "http")}
        # phase 29: every run of its five parts, and a step's of (a), (b)
        # and (c), measured (the fleet's coalesced groups have no fixed
        # count a client step)
        rec["launches_fleet"] = fleet_counts.get(key, 0)
        per_step = {f"lm_{label}": n.get(key, 0) for label, n in
                    fleet_rec["lm"]["launches_per_step"].items()}
        per_step.update({
            f"resnet18_{label}": r["launches"].get(key, 0) / REMAT_IMG_STEPS
            for label, r in fleet_rec["resnet18_remat"]["runs"].items()})
        per_step.update({
            f"replicas_{mode}_per_client_step": r[
                "launches_per_client_step"].get(key, 0)
            for mode, r in fleet_rec["replicas"].items()})
        rec["launches_per_step_fleet"] = per_step
        # phase 30: every run of its five parts, and a step's of each leg
        rec["launches_mesh"] = mesh_counts.get(key, 0)
        lm = mesh_rec["lm"]
        rec["launches_per_step_mesh"] = dict(
            ring_flash_seq4=lm["ring_flash"]["virtual"][
                "launches_per_step"][-1].get(key, 0),
            ulysses_seq2=lm["ulysses"]["virtual"][
                "launches_per_step"][-1].get(key, 0),
            cnn_data4=mesh_rec["cnn_data"]["virtual"][
                "launches_per_step"].get(key, 0),
            pipeline_resnet18_4stage=mesh_rec["pipeline"]["virtual"][
                "launches_per_step"].get(key, 0))
        if rec["name"] == FA:
            rec["mesh_shapes"] = {k: dict(r["fwd"], shape=r["shape"],
                                          causal=r["causal"],
                                          strict=r["strict"])
                                  for k, r in mesh_fa.items()}
        if rec["name"] == BWD_DKV:
            rec["mesh_shapes_whole_backward"] = {
                k: dict(r["bwd"], shape=r["shape"], causal=r["causal"],
                        strict=r["strict"], g_lse=r["g_lse"])
                for k, r in mesh_fa.items()}
        # phase 31: every run of its four parts, and a step's of each leg
        rec["launches_model_axis"] = tp_counts.get(key, 0)
        per_step = {"lm_model2": tp_rec["lm"]["launches_per_step"].get(key, 0),
                    "resnet18_model2": tp_rec["image"]["resnet18"][
                        "launches_per_step"].get(key, 0)}
        per_step.update({f"cnn_{label}": r["launches_per_step"].get(key, 0)
                         for label, r in tp_rec["image"]["cnn"].items()})
        rec["launches_per_step_model_axis"] = per_step
        if rec["name"] == FA:
            rec["tp_shapes"] = {k: dict(r["fwd"], shape=r["shape"],
                                        causal=r["causal"])
                                for k, r in tp_fa.items()}
        if rec["name"] == BWD_DKV:
            rec["tp_shapes_whole_backward"] = {
                k: dict(r["bwd"], shape=r["shape"], causal=r["causal"])
                for k, r in tp_fa.items()}
        # phase 33: (b)'s runs, and a step's of each leg
        rec["launches_seq_model"] = sm_counts.get(key, 0)
        sm_lm = sm_rec["lm"]
        rec["launches_per_step_seq_model"] = {
            f"{leg}_model{SM_MODEL}_seq{SM_SEQ}": sm_lm[leg][
                "launches_per_step"].get(key, 0)
            for leg in ("ring_flash", "ulysses", "sgd")}
        if rec["name"] == FA:
            rec["seq_model_shapes"] = {
                k: dict(r["fwd"], shape=r["shape"], causal=r["causal"],
                        strict=r["strict"]) for k, r in sm_fa.items()}
        if rec["name"] == BWD_DKV:
            rec["seq_model_shapes_whole_backward"] = {
                k: dict(r["bwd"], shape=r["shape"], causal=r["causal"],
                        strict=r["strict"], g_lse=r["g_lse"])
                for k, r in sm_fa.items()}
        if key in (FWD, BWD):
            rec["seq_model_shape"] = dict(
                sm_ce["fwd" if key == FWD else "bwd"], shape=sm_ce["shape"],
                dtype=sm_ce["dtype"])
    two_party_line = dict(two_party=dict(
        model="split_cnn", mode="split", transport="local", batch=BATCH,
        steps=STEPS, density=DENSITY, device=kind, kernel_cases=wire_cases,
        kernel_frames=wire_frames, planted_ties_high_changed=ties_changed,
        **two_party))
    decode_line = dict(split_decode=dict(device=kind, **decode))
    http_line = dict(http=dict(
        model="split_cnn", mode="split", transport="http", batch=BATCH,
        steps=STEPS, density=DENSITY, device=kind, card=smi,
        server="SplitHTTPServer on 127.0.0.1:0, a thread of this process",
        **http_rec, **http_serving_rec))

    lm_line = dict(train_lm_bf16=dict(
        model="transformer_lm", mode="split", dtype="bfloat16",
        d_model=LM["d_model"], num_heads=LM["num_heads"], vocab=LM["vocab"],
        blocks=N_BLOCKS, attn="flash", batch=TRAIN_B, seq_len=TRAIN_T,
        steps=TRAIN_STEPS, device=kind, card=smi,
        float32_sgd_step_ms_median=train_lm["train_lm"]["step_ms_median"],
        runs=bf16_runs), two_party_lm=dict(
        model="transformer_lm", mode="split", transport="local",
        batch=TRAIN_B, seq_len=TRAIN_T, cut=list(LM_CUT), steps=TRAIN_STEPS,
        density=DENSITY, optimizer="adamw", device=kind, card=smi, **tp_lm))

    print(f"[clock] all phases at {time.perf_counter() - t_script:.1f} s",
          flush=True)
    print(json.dumps({"kernels": records}))
    print(json.dumps(step))
    print(json.dumps(serving))
    print(json.dumps(train_lm))
    print(json.dumps(two_party_line))
    print(json.dumps(decode_line))
    print(json.dumps(http_line))
    print(json.dumps(lm_line))
    print(json.dumps(dict(
        u_split=dict(model="split_cnn", batch=BATCH, steps=STEPS,
                     density=DENSITY, device=kind, card=smi, **u_cnn),
        u_split_lm=dict(model="transformer_lm", dtype="bfloat16",
                        optimizer="adamw", batch=TRAIN_B, seq_len=TRAIN_T,
                        cut=list(LM_CUT), steps=U_LM_STEPS, device=kind,
                        card=smi, **u_lm),
        federated=dict(transport="http", device=kind, card=smi, **fed),
        multi_client=dict(device=kind, card=smi, **mc),
        cli=cli_u_fed)))
    print(json.dumps({"checkpoint": dict(device=kind, card=smi,
                                         **ckpt_rec)}))
    print(json.dumps({"many_clients": dict(device=kind, card=smi,
                                           **many_rec)}))
    print(json.dumps({"image": dict(device=kind, card=smi, batch=IMG_B,
                                    steps=IMG_STEPS, **image_rec)}))
    print(json.dumps({"chain": dict(
        device=kind, card=smi, model="resnet18_4stage", batch=CHAIN_B,
        microbatches=CHAIN_M, stages=CHAIN_S, lr=LR, **chain_rec)}))
    print(json.dumps({"obs": dict(device=kind, card=smi, **obs_rec)}))
    print(json.dumps({"fleet": dict(device=kind, **fleet_rec)}))
    print(json.dumps({"mesh": dict(device=kind, model="transformer_lm",
                                   batch=TRAIN_B, seq_len=TRAIN_T,
                                   kernels=mesh_fa, **mesh_rec)}))
    print(json.dumps({"model_axis": dict(device=kind, kernels=tp_fa,
                                         **tp_rec)}))
    print(json.dumps({"analysis_native": dict(device=kind, **an_rec)}))
    print(json.dumps({"seq_model": dict(device=kind, card=smi,
                                        kernels=sm_fa, k1=sm_ce,
                                        **sm_rec)}, default=str))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def phase32_main() -> int:
    """``chip_smoke.py --phase 32``: phase 32 alone on the card, its watchdog
    round held to phase 25's group launches (K1f 1, K1b 1, K2 1 a
    coalesced group in every run of phase 25 on the card). Writes
    ``chiprun_out/p32.json``."""
    sys.path.insert(0, REPO)
    import torch
    from split_learning_tpu_torch.ops.common import load_kernels
    from split_learning_tpu_torch.ops.cross_entropy import BWD, FWD
    from split_learning_tpu_torch.ops.sgd import NAME as SGD
    from split_learning_tpu_torch.utils import (
        gpu_name_and_power_limit, resolve_device)
    t0 = time.perf_counter()
    dev = resolve_device("cuda")
    smi = gpu_name_and_power_limit().splitlines()[0]
    print(smi, sys.version.split()[0], torch.__version__, flush=True)
    load_kernels()
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    many = {"coalescing": {"runs": {"local none window": {
        "server_launches_per_group": {FWD: 1, BWD: 1, SGD: 1}}}}}
    rec = analysis_native_runs(torch, dev, smi, many)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "p32.json"), "w") as f:
        json.dump(rec, f, indent=1)
    print(f"[analysis] phase 32 alone: {time.perf_counter() - t0:.1f} s")
    return 0


def native_ops_main() -> int:
    """``chip_smoke.py --native-ops``: what phase 32 (a)'s host ms per MB
    are made of. At both of its cuts, the median ms of 20 calls (10 for
    the selects) of the native codec's quantize, dequantize, topk8 select
    (density 0.1) and scatter at 1, 2, 4 and 8 threads, beside numpy's
    quantize, absmax, dequantize and select; one JSON object."""
    sys.path.insert(0, REPO)
    from split_learning_tpu_torch import native
    from split_learning_tpu_torch.transport import codec
    _native_line(True)
    check(native.available(), f"native codec: {native.build_error()}")

    def med(fn, reps=NATIVE_REPS):
        return statistics.median(_host_reps(fn, reps))

    res = {"cpu_count": os.cpu_count()}
    for cut, shape in NATIVE_CUTS:
        x = (np.random.RandomState(0).randn(*shape) * 3.0).astype(np.float32)
        flat = x.reshape(-1)
        n, k = flat.size, math.ceil(DENSITY * flat.size)
        q, s = native.q8_quantize(x)
        idx, _ = native.topk8_select(flat, k)
        r = {}
        for t in (1, 2, 4, 8):
            r[f"q8_quantize_t{t}"] = med(
                lambda: native.q8_quantize(x, n_threads=t))
            r[f"q8_dequantize_t{t}"] = med(
                lambda: native.q8_dequantize(q, s, n_threads=t))
            r[f"topk8_select_t{t}"] = med(
                lambda: native.topk8_select(flat, k, n_threads=t), 10)
            r[f"topk8_scatter_t{t}"] = med(
                lambda: native.topk8_scatter(idx, q.reshape(-1)[idx], s, n,
                                             n_threads=t))
        r["np_q8_quantize"] = med(
            lambda: np.clip(np.round(x / s), -127, 127).astype(np.int8))
        r["np_absmax"] = med(lambda: float(np.max(np.abs(x))))
        r["np_q8_dequantize"] = med(lambda: q.astype(np.float32) * s)
        r["np_topk8_select"] = med(
            lambda: codec._topk8_select_numpy(flat, k), 10)
        res[cut] = r
    print(json.dumps(res, indent=1))
    return 0


def host_line_main(root: str) -> int:
    """``chip_smoke.py --host-line [ROOT]``: the codec's numpy line end to
    end. A party that hands numpy arrays to ``LocalTransport`` (int8 and
    topk8 at DENSITY) takes split steps at the CNN cut against a
    ``ServerRuntime`` on the CPU: both wire directions encode and decode
    numpy, on the native codec or, with ``SLT_NO_NATIVE=1``, on numpy.
    The median ms of HOST_LINE_STEPS steps after HOST_LINE_WARM, each
    line in turn, twice; ``ROOT`` runs the package of another checkout
    (a commit before the native codec has only the numpy line). One
    JSON object."""
    sys.path.insert(0, os.path.abspath(root or REPO))
    import torch
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.runtime import ServerRuntime
    from split_learning_tpu_torch.transport import LocalTransport
    import split_learning_tpu_torch as pkg
    try:
        from split_learning_tpu_torch import native
    except ImportError:
        native = None
    rng = np.random.RandomState(0)
    acts = (rng.randn(*CNN_CUT) * 3.0).astype(np.float32)
    labels = rng.randint(0, 10, size=CNN_CUT[0]).astype(np.int32)
    lines = ("native", "numpy") if native is not None else ("numpy",)
    res = {"package": os.path.dirname(pkg.__file__),
           "cpu_count": os.cpu_count(), "steps": HOST_LINE_STEPS}
    for kind in ("int8", "topk8"):
        row = {}
        for line in lines * 2:
            _native_line(line == "native")
            server = ServerRuntime(get_plan(), _many_cfg(),
                                   torch.Generator().manual_seed(0),
                                   device="cpu")
            wire = LocalTransport(server, compress=kind, density=DENSITY)
            ms = []
            for step in range(HOST_LINE_WARM + HOST_LINE_STEPS):
                t = time.perf_counter()
                g, _ = wire.split_step(acts, labels, step)
                ms.append((time.perf_counter() - t) * 1e3)
            check(isinstance(g, np.ndarray) and g.shape == acts.shape,
                  f"host line {kind}: reply {type(g)}")
            server.close()
            row.setdefault(line, []).append(
                statistics.median(ms[HOST_LINE_WARM:]))
        res[kind] = row
    _native_line(True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--mlflow-stub"]:
        sys.exit(_mlflow_stub_main())
    if sys.argv[1:] == ["--phase", "32"]:
        sys.exit(phase32_main())
    if sys.argv[1:] == ["--phase", "33"]:
        sys.exit(phase33_main())
    if sys.argv[1:] == ["--native-ops"]:
        sys.exit(native_ops_main())
    if sys.argv[1:2] == ["--host-line"] and len(sys.argv) <= 3:
        sys.exit(host_line_main(sys.argv[2] if len(sys.argv) == 3 else ""))
    sys.exit(main())
