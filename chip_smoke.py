"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py                         # every phase (the contract)
    python3 chip_smoke.py --only llm-kernels      # build K11/K12, their rows
    python3 chip_smoke.py --only llm-paths [PHASE ...]  # the LLM phases
    python3 chip_smoke.py --only kmeans-kernels   # build K3/K4/K5, their rows
    python3 chip_smoke.py --only bottom-kernels   # build K1/K2/K9/K10, rows
    python3 chip_smoke.py --only psi-kernels      # build K6/K7/K8, rows
    python3 chip_smoke.py --only table2           # the VFL kernels, BA/MU/RI/BP
    python3 chip_smoke.py --only llm-train        # build K11/K12, training
    python3 chip_smoke.py --only long-context     # build K11/K12, long_500k
    python3 chip_smoke.py --only sharded          # the VFL kernels, mesh=
    python3 chip_smoke.py --only llm-sharded      # build K11, LLM on a mesh
    python3 chip_smoke.py --only analysis         # the gate's census, smem

Phases, each printing JSON lines:

1. device   — the card's name and power limit (nvidia-smi) and torch's name.
2. build    — compiles every CUDA kernel of the slice from
              ``src/repro_torch/kernels/csrc`` (one nvcc per source, all
              at once) into ``build/repro_torch_ext/``, with ptxas's
              registers and spills for each kernel instance (K3/K4's
              fused kernel and K5: one line an instance, none may spill),
              counts the tensor-core instructions (``cuobjdump -sass``:
              HMMA, HGMMA) of each K11 instance and of each of its
              backward's (every bf16 one must have them; a bf16 backward
              instance up to Dh 128 must not spill), and HMMA/HGMMA/FFMA
              of K12's two kernels, whose
              products are f32 FMAs in the plain version's order (a
              record, not checked).
3. kernels  — each kernel against its plain PyTorch version on the card,
              at the shapes the main paths give it (K6 on 2×2^17 ids, K7
              at P=2^17 with ~70% overlap, K3/K5 at M=3, N=49,000, d=11,
              K=14, K1 at an eval block M=3, B=512, d=11, o=8 and at lr's
              o=1, K2 at a train step of 700 seeded rows with duplicates
              out of a (3, 49,000, 11) slab); median time over 20 launches with
              CUDA events beside the plain version, the library yardstick
              and the bound.  Integer outputs must match bit for bit; an
              assignment may differ only on a near tie (best/second-best
              d² margin <= 1e-4·(1+d²)); counts are exact; sums within
              rtol=1e-5 of Σ|p| of the float64 sums of the kernel's own
              assignment; sqd within 1e-5 + 1e-5·(‖p‖²+‖c‖²) of the plain
              version, the size of the terms the f32 formula cancels.
              K1/K2 outputs within 1e-6 + 1e-5·(Σ_k|x_k w_k| + |b|) of the
              plain version, and K2 bitwise equal to K1 on the gathered
              rows.  The same checks at the YP job's shapes: K3/K5 at
              M=3, N=249,900, d=30, K=12 (``timed_at``); K1 at an eval
              block of 512 rows and K2 over a coreset-sized slab of 300
              rows and at a 3,570-row step out of (3, 249,900, 30), o=1
              without ReLU.  K3's assign and sqd bitwise K5's on the same
              centroids, and two K3 calls bitwise; its profiled launches
              a call must be one ``kmeans_update_kernel``.  K4 at a YP
              minibatch step (1,024 seeded indices with duplicates into
              a (1, 357,000, 30) client, K=12): bitwise equal to K3 on
              the pre-gathered rows and to a second call, one launch a
              call, within K3's tolerances of its plain version; again
              over (3, 49,000, 11) with 1,000 indices a client, and with
              indices outside [0, N) (assign -1, sqd NaN, no count, the
              other rows' bits kept; ``check_only``).  K5 also at a YP
              minibatch build's end (one client's 357,000 rows, d=30,
              K=12; ``timed_at``), each K5 row one device kernel a call
              (``one_launch``).  K3 and K4 at edge shapes
              (``EDGE_SHAPES``) against the plain version, K5 and each
              other, and K5 against its plain version there.  K8 (the
              merge kernel past
              the reference's single-pass bound) at P=2^19, at 2^20 and
              as nine pairs at 2^19 (the delta probe's batch), ~70%
              overlap, bitwise; ``torch.sort`` of the 2P keys beside it.
              K7/K8 also at the tile and co-rank edges (``check_only``,
              bitwise): P=8 with 5/8/3, 0/4/0 and 8/8/8 keys a side and
              common, one side all pads, disjoint sides either way
              round, identical sides, strictly alternating keys, 3 pairs
              with different fills, an odd P (the scalar stores) and
              P=2^21; every merge row one device kernel a call.
              K9 (the int8 bottom pass) and K10 (over gathered rows) in
              the wire form the quantized wire runs (quantizers in the
              operand loads, the wire rounding in the epilogue, one
              launch a call): bitwise the plain composition
              quantize_rows → int8 pass → fake_quantize, one device
              kernel a call (the profiler); K9 at the int8 eval block
              (3, 512, 11) → 8 with ReLU, at lr's o=1 without, at a
              serving dispatch of 64 rows, at B=509 and at o=3, K10 at
              a 700-row train step with duplicates out of (3, 49,000,
              11), with and without its pre-rounding output; each timed
              beside the parent's eager path (the same result) and
              ``torch.baddbmm`` on the dequantized operands.  The
              operands form (the first design, ``timed_at``) at the eval
              block, o=1 and the train step: bitwise their plain
              versions, K10 bitwise K9 on the gathered rows.  K1 and K2
              in the fp8 wire form the fp8 wire runs (the f32 pass,
              then the wire rounding in the epilogue, one launch a
              call), at K9/K10's shapes: the output before the rounding
              bitwise the f32 form's, the wire value bitwise the eager
              ``fake_quantize(·, "fp8")`` of it, the pass within K1's
              tolerance of cuBLAS, one device kernel a call; each timed
              beside the parent's path (the f32 form, then the eager
              rounding).  The quantizers on the card bitwise the same
              quantizers on the CPU, int8 and fp8; the fp8 wire
              rounding through the wire K1 bitwise the eager one over
              every finite f32 of magnitude <= 448 and 10^6 seeded
              values at each exponent (``fp8_encode_sweep``).  K11
              (flash attention) at the
              tinyllama prefill (B=2, Sq=Sk=2,048, H=32, KV=4, Dh=64,
              causal, bf16) within one bf16 ulp of its plain version (f32
              full attention rounded once), SDPA with ``enable_gqa``
              beside it; in f32 (within 1e-5) and bf16 under a window +
              prefix, a softcap with Dh=128, no causal mask with Dh=48
              and Sq<Sk (``check_only``); bf16 at the shapes of the other
              configs that reach K11 (B=2, S=2,048): stablelm-12b and
              qwen2-72b timed beside SDPA (``timed_at``, outside the
              ``kernels`` line), gemma2-9b (Dh=256, window, softcap)
              checked, and G=128 and Dh=36; bf16 at the shapes of the
              other LLM paths, timed beside SDPA with the same mask, each
              a row of the ``kernels`` line with its path's launches
              (``path``): hymba-1.5b (S=2,176, G=5, window 1,024,
              prefix 128), internvl2-1b (S=2,304, G=7), olmoe-1b-7b
              (G=1, Dh=128), whisper-large-v3's encoder (1,500 frames,
              no causal mask) and cross-attention (Sq=1 against them;
              both also checked in f32).  K12 (the SSD scan) at the
              mamba2-1.3b prefill (B=2, S=2,048, H=64, P=64, N=128,
              L=128) and at hymba-1.5b's (S=2,176, 17 chunks, H=50,
              N=16; ``path``), each with the device time of
              its two launches, the bound of the function on 3xTF32
              tensor cores, PR 16's bound and that of the f32 FMAs the
              kernel does, and the bytes the design moves; at
              S=1,000, L=37 and the CPU tests' ragged (P, N, L) = (8, 8,
              16) and (16, 16, 32) checked; y and state within
              1e-5·(1+max|plain|).  K11's backward
              (``flash_attention_bwd.cu``: dq, dk, dv; no TPU entry
              point, the reference differentiates its full attention
              with XLA) against ``ref.flash_attention_bwd`` on the
              kernel forward's output, the backward fed the forward's
              LSE, f32 and bf16 (bf16 rows with ``passes_run``, the
              tensor-core passes the design runs, beside the bound's
              11): at the tinyllama
              train shape (the ``kernels`` line's row), hymba's,
              internvl2's, olmoe's, gemma2's (softcap, Dh=256),
              whisper's encoder and its teacher-forced cross-attention
              (Sq=448 against 1,500 frames), timed in bf16 with the
              backward of SDPA (``enable_gqa``) as the library, and
              ragged edges checked; f32 within 1e-4·max|plain|, bf16
              within 2^-7·|plain| + 1e-4·max|plain| (the f32 sums in
              other orders, then one rounding); a second launch bitwise
              the first (no atomics).  Then ``grad``: K11's op
              differentiates on the card (its autograd gradients
              against the plain version's, each operand in turn), K12's
              CUDA wrapper must refuse, under grad mode, each operand
              that requires grad (it has no backward), and both run
              under ``no_grad``.  Every library yardstick is timed
              with CUDA events (``library_ms``) and by the profiler
              (``library_device_ms``), to compare with ``device_ms``.
4. pipeline — ``run_pipeline(model="knn")`` at the paper's full HI size
              (70,000 train / 30,000 test rows, 3 clients, k=14,
              25 iterations, OPRF on the device) for ``treecss`` and
              ``starall``, once with the kernels (launch counts set to 0
              just before and read just after each run) and once with
              ``impl="ref"``; intersections and MPSIStats counters must be
              identical and accuracy within 0.002.  Coreset indices must be
              identical, or else the two coreset fits, run side by side
              from the same k-means++ centroids, must first part at a step
              where every differing assignment is a near tie (the f32
              distances of the kernel and of cuBLAS sum in other orders);
              two kernel fits must give the same bits.
5. train    — ``run_pipeline`` for the SplitNN jobs at full HI with the
              paper's Table-2 settings (batches of max(8, 70,000 // 100) =
              700 rows, lr 0.05 for lr and 0.01 for mlp, k=14, OPRF on the
              device): treecss × {mlp, lr} and starall × mlp (49,000 rows,
              70 steps an epoch), each to the 200-epoch cap or convergence,
              each traced, with the kernels and with every plain version.
              MPSI and n_train must be identical, steps and comm_bytes too
              unless the convergence window stopped at another epoch
              (reported), the loss at the last common epoch within rtol
              1e-3 (within 1e-3 of the first epoch's loss where the two
              coreset fits parted at a near tie), accuracy within 0.005
              and in (0.5, 1]; K2 launches = train steps, K1 launches =
              eval batches, no launch in the plain runs.
6. serve    — ``VFLScoringEngine(slots=64)`` over the 30,000 HI test rows
              as seeded requests of 1-256 rows with the treecss-mlp params:
              outputs within tolerance of ``score_partition``, ServeStats
              equal between the kernel and plain engines, K1 launches =
              dispatches.
7. profile  — spans, device busy share and top device ops of one traced
              full-HI treecss run, k-NN, mlp and mlp under the int8 wire
              (with a cProfile of the int8 run's host time) and the fp8
              wire.
8. yp       — Table-2 YP × linreg ``treecss`` at full size (357,000 train /
              153,000 test rows, 3 clients × 30 columns, k=12, batches of
              3,570 rows, the 200-epoch cap or convergence, OPRF on the
              device), kernels and plain versions: identical intersection
              and MPSIStats, 249,900 ids aligned, one K8 launch per Tree-MPSI
              round (every pair pads to P=2^19) and none in the plain run,
              coreset indices identical or parted at a near tie, MSE within
              rtol 1e-2 (5e-2 where the coresets parted); stage walls and a
              profiled kernel run.
9. minibatch— ``benchmarks/beyond_minibatch.py``'s YP job at full size:
              ``cluster_coreset`` with Lloyd and with the minibatch fit on
              the 357,000 train rows (linreg trained on each coreset and
              evaluated) and at 510,000 rows, kernels and plain versions:
              K4 launched 25 × 3 times per minibatch build, two kernel
              minibatch fits bitwise equal; build walls, coreset sizes, MSE.
10. delta   — ``benchmarks/fig7_delta_psi.py``'s device sweep at full size
              (m=4 parties of 300,000 ids, Δ/N in {0.001, 0.01, 0.1}, one
              untimed and 6 timed deltas each): the aligned set equals the
              plain intersection after every delta and a full Tree-MPSI
              re-run at the end; K8 launched; median delta wall and bytes
              against the full re-run.
11. quant   — the SplitNN jobs of phase 5 under the quantized wire
              (``benchmarks/quant_vfl.py``'s sweep at full HI): treecss ×
              {mlp, lr} × {int8, fp8} and starall × mlp × int8, kernels
              and plain versions, compared as phase 5 compares them
              (starall's losses bitwise: no coreset, the same rows); the
              int8 accuracy at most 0.01 below phase 5's f32 run of the
              same job, the gathered payload <= 0.3× f32's; K10 launches
              = train steps and K9 = eval blocks under int8 (the wire
              form; the operands form never), K2/K1's fp8 wire form
              under fp8 (their f32 form never).  Then
              ``VFLScoringEngine(slots=64, quant=...)`` serves the test
              rows with the int8- and the fp8-trained treecss-mlp
              params: ServeStats equal, each engine within one wire step
              of ``score_partition(quant=...)`` (a wire block groups
              other rows in the two), the kernel and plain engines
              bitwise under int8 and within one wire step of each other
              under fp8 (cuBLAS rounds the f32 pass apart), K9 (the fp8
              wire K1) launches = dispatches.
12. table2  — the paper's Table-2 jobs on the other four datasets at
              full size (``data.table2.JOBS``): BA (10,000 × 11) lr and
              mlp at k=12, MU (8,000 × 22) lr and mlp at k=10, RI (18,000
              × 11, two modes a class, margin 3.5) lr, mlp and k-NN at
              k=8, BP (13,000 × 11, 4 classes) mlp at k=12; 70/30, 3
              clients (4/4/3 columns, MU 8/7/7), OPRF on the device,
              Table-2's lr, batches of max(8, n_train_rows // 100), the
              200-epoch cap or convergence.  Each job runs ``treecss``
              with the kernels and with every plain version, compared as
              phase 5 compares them (accuracy within 0.005, RI × k-NN
              within 0.002, above 1 / n_classes; coresets that differ
              need fits that part, and only at near ties: a Lloyd step's
              or the final pass's assignments, or the final distances
              within their f32 bound, ``fit_divergence``); MPSIStats
              equal; K6, K7, K3 and K5 launched, K8 not (P <= 2^18), K2
              once a step and K1 once an eval block (neither for k-NN);
              one dispatch and one host sync an epoch; a line a job with
              its stage walls, epochs, steps and launches.
13. llm_dense — LLM serving at full width: tinyllama-1.1b (22 layers,
              d 2,048, GQA 32/4, bf16) with seeded ``torch.Generator``
              params on the card, 2 prompts of 2,048 seeded tokens,
              ``serve.engine.greedy_decode`` of 32 new tokens: K11
              launched 22 times a prefill; then the engine's prefill and
              serve steps, kernels (3 timed runs, bitwise equal) and plain
              versions: prefill ms, decode ms a token, peak memory.  The
              end-to-end gate is the same model in f32: the plain
              versions decode 32 tokens freely and the kernels decode fed
              those tokens; logits at the prefill's last position and at
              every step within 1e-3·(1+max|logits|) (argmax tokens
              counted where the plain top-2 margin is above twice that).  The
              bf16 runs must be finite, bitwise equal across the three
              kernel runs and equal to ``greedy_decode``; their
              kernel-vs-plain and bf16-vs-f32 gaps are recorded.
14. llm_ssm — the same for mamba2-1.3b (48 Mamba2 layers, d_inner
              4,096, 64 SSD heads, N=128, vocab padded to 50,432): K12
              launched 48 times a prefill; K12 on every layer's inputs
              of the f32 model within twice the plain f32 version's
              distance to a float64 scan, and within 1e-5·(1+max) of its
              plain version; past the prefill a decode step's f32 logits
              beyond the bound pass only within a tenth of the plain
              run's distance to the model with float64 scans.
15. llm_hybrid — the same for hymba-1.5b (32 layers of attention and
              Mamba2 side by side, 128 meta tokens pinned in windows of
              1,024, global layers 0, 15, 31): K11 and K12 launched 32
              times each a prefill (S=2,176); K12 on every Mamba2
              mixer's inputs as for mamba2; past the bound, the f32
              kernel run within twice the plain run's distance to the
              model with float64 prefill attention and scans.
16. llm_moe — olmoe-1b-7b (16 layers, 64 experts, top-8): K11
              launched 16 times a prefill.  Every routing call of the
              two f32 runs is recorded: the logit bound holds at the
              positions before the chain's first route flip, each route
              that flips there must sit at a plain-run margin <= 1e-5
              (a token's k-th minus (k+1)-th probability, an expert's
              C-th minus (C+1)-th gate), and so must every flip of each
              layer fed the plain run's input with K11 as the only
              difference; flips are counted.
17. llm_vlm — internvl2-1b (24 layers, G=7) with 256 seeded patch
              embeddings before each prompt: K11 launched 24 times a
              prefill (S=2,304).
18. llm_audio — whisper-large-v3 (32 encoder and 32 decoder layers)
              on seeded frames (2, 1,500, 1,280) and 2 prompts of 4
              tokens: K11 launched 32 times an encode and 32 times a
              decode step (the cross-attention), 1,184 a
              ``greedy_decode``; the prefill is the encoder and the
              prompt through the decoder's cache.
              Between models the params are freed and the cache
              emptied; each LLM line carries its phase's seconds.
19. llm_train — LLM training (``train.steps``): tinyllama-1.1b at full
              width and depth, B=2, S=2,048, Eq.(2) weights 1 + rank/B,
              remat, Adam.  The f32 model's loss and every param leaf's
              gradient with the kernels (K11 forward and backward)
              against the plain versions from the same params and batch:
              |Δloss| <= 1e-5·|loss|, ‖Δg‖ <= 1e-3·‖g‖ + 1e-6·max‖g‖
              (the floor for leaves whose gradient is zero in exact
              arithmetic: a key bias).  In the config's bf16, 6 steps on
              one batch, twice: the losses bitwise equal, the 6th below
              the 1st, K11 launched 44 times a step forward (22 + 22
              remat) and 22 backward, K12 0; step ms, tokens/s, peak
              memory, the busy share, top ops and K11-backward's share
              of a profiled step.  Each of the ten reduced configs (f32,
              B=2, S=64): one kernel-vs-plain gradient under the same
              gate, K11 launched twice a forward and once a backward per
              attention layer, K12 never.  A checkpoint of reduced
              tinyllama's params and Adam state after 3 steps, loaded
              into fresh tensors on the card: step 4 bitwise the
              uninterrupted run's.
20. long_context — the long_500k serving shape (one request, a context
              of 524,288) of mamba2-1.3b, hymba-1.5b and gemma2-9b at
              full width and depth in bf16, with ``force_window`` as
              ``launch.specs.build_decode`` sets it (every attention
              layer on a ring cache of its window): a seeded prompt of
              32,768 tokens through the engine's prefill (K12 a Mamba2
              layer, K11 an attention layer, counted), timed over 3 more
              runs, bitwise equal; 32 greedy serve steps from it and 32
              from a copy of its caches at positions 524,256 … 524,287
              (ms a token, finite logits); peak GB; the decode state's
              bytes beside what full-context caches would take, no cache
              of the context's size.  Gates: the first, middle and last
              layer's K11 and K12 launches of the counted bf16 prefill,
              kept with their inputs and held against the plain versions
              on them (K11's bf16 tensor-core instance on three slices of
              1,024 query rows within one bf16 ulp, 2^-7·|plain| + 1e-6;
              K12 within 1e-5·(1 + max|plain|)), each also timed alone
              beside its bound (K11 also beside SDPA's time);
              the f32 model at 8,192 tokens (every ring wraps), kernels
              against plain versions: the prefill's last logits, 8 steps
              after it and 8 far out, fed the plain run's tokens, within
              1e-3·(1 + max|logits|); every ring cache's ``pos`` as
              ``cache_slot`` maps it; CUDA's cos/sin of the rotary angles
              there within 1e-6 of float64's.
21. sharded — the HI treecss × mlp pipeline with ``mesh=``
              (``repro_torch.sharding``), the kernels built once here
              before any rank starts: 2 ranks on ``("data",)`` and 4 on
              (data 2, model 2), f32 and int8, spawned by
              ``launch.mesh.run_ranks``, all on the one card over gloo
              (the collectives staged through host memory), and 2 ranks
              over NCCL, one a card, where the host has 2 cards; each
              world prints its backend, size and mesh.  Against the
              unsharded run on the card: intersections, coreset indices
              and weights bitwise; the stats' shards equal to the mesh;
              counters exact (steps, comm_bytes, payload bytes, one host
              sync an epoch on every rank); f32 losses within rtol 1e-4,
              atol 1e-6, accuracy within 0.02; int8 losses within twice
              the wire's own distance (int8 to f32, unsharded) plus 1e-4,
              its accuracy at most 0.01 below f32's; every rank's outputs
              bitwise rank 0's; on every rank K6/K7/K3/K5 launched as
              often as unsharded, K2 (K10) once a step and K1 (K9) once
              an eval block, and the profiler seeing K2's (K10's) kernel
              in one epoch; each stage's wall a rank and its collectives
              (calls, staged, bytes).
22. llm_sharded — LLM training on a (data 2, model 2) mesh, profile
              "2d", 4 gloo ranks on the one card (every collective staged
              through host memory: no NCCL figure), K11 built here before
              the ranks start; again over NCCL, one rank a card, where the
              host has 2 or more.  tinyllama-1.1b at full width, 4
              layers (B 2 × S 2,048): the f32 loss within
              ``TRAIN_LOSS_RTOL`` and
              every gradient leaf, gathered whole, within ``grad_gate``'s
              bounds of the unsharded ones on the card (the worst leaf
              named); the config's bf16 (f32 masters, bf16 compute): the
              first gradient, gathered whole, each leaf at most 3× as far
              from the f32 one as the unsharded bf16 leaf is (plus
              ``TRAIN_GRAD_FLOOR``·max‖g‖), then 3 steps twice: losses
              bitwise across the runs and falling, the first within 0.1%
              of the unsharded first loss; K11 launched 8 times and its
              backward 4 times a step on every rank, both seen by the
              profiler there; each rank's params and Adam moments at most 30% of
              the unsharded bytes; step ms, peak GB and collectives a step
              for each rank.  olmoe-1b-7b at full width, 2 layers (the
              card cannot hold 16 layers' f32 training state), B 2 × S
              1,024, f32: with the capacity factor raised until no token
              drops, the loss and gradients against the unsharded ones
              at S (scheme A: two ``all_to_all``s a layer) and at S - 1
              (scheme B: ``model`` does not divide it); at the config's
              capacity factor, finite, the aux loss recorded; a
              ``forward_lm`` at S = 1 (scheme B) within 1e-4·(1 +
              max|logits|) of the unsharded one.  hymba-1.5b at full
              width, 4 layers (global layer 0, three windowed), B 2 × S
              2,048: attention context-parallel (25 q heads; each model
              rank its 1,088 q rows, keys to the block's end), the Mamba
              mixer and the MLP tensor-parallel; the f32 loss and every
              gradient leaf against the unsharded ones as tinyllama's;
              bf16 3 steps twice, bitwise; K11 8 + 4 launches a step a
              rank, each at (Sq, Sk) = (1,088, 1,088) on model rank 0 and
              (1,088, 2,176) on rank 1; two forward and two backward
              launches kept and held against the plain versions on each
              rank (one bf16 ulp; the backward as ``flash_bwd_row``
              holds it) and timed there, one rank at a time; collectives,
              ms and peak GB a step.  mamba2-1.3b, internvl2-1b (B 2 × S
              2,048) and whisper-large-v3 (448 decoder tokens over its
              1,500 frames), full width, 2 layers (whisper 2 + 2), f32:
              one loss and gradient each against the unsharded run.
23. analysis — the engine-contract gate's layers on the card
              (``repro_torch.analysis``): the census of every
              single-device program of ``analysis.check`` with the
              kernels on — kernel launches a call (and a step) as
              ``ANALYSIS_LAUNCHES`` has them and equal to the reference's
              ``pallas_calls`` in ``experiments/bench/static_contract.json``
              (one K6 launch over both sides stands for its two PRF calls),
              zero host syncs inside a train step (counted, and read by
              ``torch.cuda.set_sync_debug_mode``) and exactly the epoch's
              one outside them, zero f64, the contract's counters; every
              ``ok`` row of ``analysis.blocks.smem_report`` launched at its
              shape and held against its plain version; K11's forward and
              K7/K8's static shared memory equal to ptxas's; K1 at
              d = o = 128 refused before launch.

The line before the last three is ``{"phase_s": {...}}``, each phase's
wall in seconds (the build's included); the line before the last two is
the ``{"kernels": [...]}`` summary; the line before the last is
nvidia-smi's name and power limit; the last line is ``{"ok": true,
"device": {...}}``.  Any failure raises and exits
non-zero without that line.  The script never imports jax or ``repro``.
Full results also go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 peak bandwidth
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
BF16_FLOPS = 989e12            # H100 SXM bf16 tensor cores, dense
TF32_FLOPS = 495e12            # H100 SXM tf32 tensor cores, dense
INT8_OPS = 1979e12             # H100 SXM int8 tensor cores, dense
SEED = 0
DELTA_N = 300_000              # ids a party in the delta-PSI sweep (fig7)
YP_TRAIN = 357_000             # YP's Table-2 train rows (70% of 510,000)
YP_ALIGNED = 249_900           # of them common to the 3 clients (70%)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def profile_device(fn, reps: int = 20, warm: bool = True):
    """torch.profiler over ``reps`` calls of ``fn`` (after one unprofiled
    call unless ``warm`` is False): ({kernel name: device ms per call},
    total device ms per call or None where the profiler sees no device
    time, wall ms per call of the profiled window)."""
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    per_name = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0)
        if ev.device_type == torch.autograd.DeviceType.CUDA and t > 0:
            per_name[ev.key] = t / 1e3 / reps
    return (per_name, sum(per_name.values()) if per_name else None,
            wall_ms)


def kernel_device_ms(fn, marks):
    """Device time per call of the launches whose names contain one of
    ``marks`` (the CUDA kernels of the wrapper, without the small torch
    ops around them); None where the profiler sees no device time."""
    per_name, _, _ = profile_device(fn)
    hits = [t for k, t in per_name.items() if any(m in k for m in marks)]
    return sum(hits) if hits else None


def device_events(fn, reps: int, tries: int = 6) -> list:
    """The profiler's device events (``key_averages``) over ``reps``
    calls of ``fn``, after one unprofiled call.  The profiler now and
    then records no device event in a whole session, so a session that
    holds none is run again, up to ``tries`` sessions; [] if every one
    was empty."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [ev for ev in prof.key_averages()
                  if ev.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            return events
    return []


def launch_device_ms(fn, marks, reps: int = 20) -> float:
    """Mean device time of one launch whose name contains one of
    ``marks``, over the launches the profiler recorded in ``reps`` calls
    (unlike ``kernel_device_ms``, a dropped event does not lower it)."""
    total, count = 0.0, 0
    for ev in device_events(fn, reps):
        if any(m in ev.key for m in marks):
            t = getattr(ev, "device_time_total", None)
            total += getattr(ev, "cuda_time_total", 0) if t is None else t
            count += ev.count
    if count == 0:
        raise RuntimeError(f"the profiler recorded no launch of {marks}")
    return total / 1e3 / count


def device_launches(fn, reps: int = 5):
    """The device kernels one call of ``fn`` launches: {name: launches
    a call}, from the profiler's event counts over ``reps`` calls (after
    one unprofiled call)."""
    return {ev.key: ev.count / reps for ev in device_events(fn, reps)}


@functools.lru_cache(maxsize=None)
def capture_stream() -> torch.cuda.Stream:
    """The side stream ``graph_nodes`` captures on (a capture cannot run
    on the default stream)."""
    return torch.cuda.Stream()


def graph_nodes(call) -> list:
    """The device work of one call of ``call``, read from a CUDA graph
    captured around it (``cudaGraphDebugDotPrint``): one label a node,
    its type and, for a kernel, its name.  Unlike the profiler's device
    records, the graph holds every node the call enqueues.  The call
    runs once on the capture stream first, so what a wrapper makes once
    a stream (K3/K4's zeroed ticket counters) is not made in the graph."""
    path = os.path.join(ROOT, "build", "one_launch.dot")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    stream = capture_stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)   # kept for the dump
    graph.enable_debug_mode()
    with torch.cuda.graph(graph, stream=stream):
        call()
    graph.debug_dump(path)
    del graph
    if not os.path.exists(path):
        raise RuntimeError("the CUDA graph of one call was not dumped")
    with open(path) as f:
        text = f.read()
    os.remove(path)
    # node lines open with the node's name and its attributes; edge
    # lines with a name and an arrow
    heads = list(re.finditer(r'^\s*"graph_\d+_node_\d+"\s*\[', text,
                             re.MULTILINE))
    return [text[h.end():nxt.start() if nxt else len(text)]
            for h, nxt in zip(heads, heads[1:] + [None])]


def one_launch(name, call, marks, reps: int = 20, tries: int = 5):
    """The device kernels a call of ``call`` launches ({name: launches a
    call}), which must be one kernel named by ``marks``.  Two counts:

    * a CUDA graph captured around one call (``graph_nodes``) must hold
      exactly one node, a kernel whose name holds a mark (no other
      kernel, copy or memset);
    * ``reps`` calls profiled in one session must make exactly ``reps``
      launch calls to the runtime (``cudaLaunchKernel`` and its kin,
      recorded on the host), and every device kernel the session records
      must be that one.

    The profiler drops device records (19 of 20 in some sessions, all of
    them in a few sessions in a row) while it keeps every launch call of
    the same sessions, so its launches are counted on the host and its
    device records only checked for names.  A session that counts fewer
    launches is profiled again, up to ``tries``; more, or a device
    kernel of another name, fails at once."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    nodes = graph_nodes(call)
    if (len(nodes) != 1 or "KERNEL" not in nodes[0]
            or not any(m in nodes[0] for m in marks)):
        raise AssertionError(f"{name}: a CUDA graph of one call holds "
                             f"{len(nodes)} nodes, not one {marks[0]}: "
                             f"{[n[:400] for n in nodes[:3]]}")
    counts, seen = [], None
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        events = prof.key_averages()
        kernels = [ev.key for ev in events
                   if ev.device_type == torch.autograd.DeviceType.CUDA]
        counts.append(sum(
            ev.count for ev in events
            if ev.device_type == torch.autograd.DeviceType.CPU
            and ev.key.startswith("cu") and "Launch" in ev.key))
        if (counts[-1] > reps or len(kernels) > 1
                or any(not any(m in k for m in marks) for k in kernels)):
            raise AssertionError(f"{name}: {reps} calls made {counts[-1]} "
                                 f"launches of {kernels}, not one "
                                 f"{marks[0]} each")
        if counts[-1] == reps:
            if kernels:
                return {kernels[0]: 1.0}
            seen = marks[0]
    if seen is not None:
        return {seen: 1.0}
    raise AssertionError(f"{name}: the profiler counted {counts} launches "
                         f"of {marks[0]} in sessions of {reps} calls, never "
                         f"{reps}")


def host_profile(fn, top: int = 12):
    """cProfile of one call of ``fn`` (ended by a synchronize): the
    port's functions by cumulative host ms, and every function by its own
    host ms.  cProfile adds a cost to each Python call, so read the
    shares, not the sums."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    cum, own = [], []
    for (path, line, name), (_, _, tt, ct, _) in pstats.Stats(
            prof).stats.items():
        where = (f"{os.path.relpath(path, ROOT)}:{line}({name})"
                 if path.startswith(ROOT) else f"{name}")
        if "repro_torch" in path:
            cum.append((where, ct * 1e3))
        own.append((where, tt * 1e3))
    return {"cum_ms": sorted(cum, key=lambda r: -r[1])[:top],
            "own_ms": sorted(own, key=lambda r: -r[1])[:top]}


def library_times(fn):
    """A library yardstick's event ms (``cuda_ms``) and device ms (the
    profiler's total for one call), so that kernels compare with it
    device time to device time."""
    return dict(library_ms=cuda_ms(fn),
                library_device_ms=profile_device(fn)[1])


def bound(nbytes: float, ops, rate: float = F32_FLOPS):
    """(ms, what binds): the larger of ``nbytes`` at the HBM rate and
    ``ops`` at ``rate``; ``ops`` may be a list of (ops, rate) pairs, work
    of different kinds whose times add."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    work = ops if isinstance(ops, list) else [(ops, rate)]
    t_ops = sum(o / r for o, r in work) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sass_census(name: str, marks=("HMMA", "HGMMA")):
    """Per kernel function of kernel library ``name`` as built, the count
    of each SASS mnemonic in ``marks`` (``cuobjdump -sass``): tensor-core
    instructions in the code, not launches."""
    from repro_torch.kernels import build
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(build._target(name))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if line.strip().startswith("Function :"):
            fn = line.split(":", 1)[1].strip()
            counts[fn] = dict.fromkeys(marks, 0)
        elif fn is not None:
            for mark in marks:
                counts[fn][mark] += len(re.findall(rf"\b{mark}\b", line))
    return counts


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------ kernel phase

def near_tie_rows(points, cents, assign_a, assign_b):
    """Rows whose assignments differ, and whether each is a near tie
    (best/second-best d² margin <= 1e-4·(1+d²), in float64)."""
    p = points.double()
    c = cents.double()
    d = ((p[:, :, None, :] - c[:, None, :, :]) ** 2).sum(-1)
    if d.shape[-1] < 2:     # one centroid: no row has a second choice
        d = torch.cat([d, torch.full_like(d, torch.inf)], -1)
    two = torch.topk(d, 2, dim=-1, largest=False).values
    margin = two[..., 1] - two[..., 0]
    tie = margin <= 1e-4 * (1 + two[..., 0])
    diff = assign_a != assign_b
    return int(diff.sum()), int((diff & ~tie).sum()), float(
        margin[diff].min()) if bool(diff.any()) else None


def check_close(name, got, want, scale, rtol=1e-5, atol=1e-5) -> float:
    """|got - want| <= atol + rtol * scale, where ``scale`` is the size of
    the terms the f32 arithmetic combined (‖p‖² + ‖c‖² for a distance
    that cancels them; Σ|p| for a cluster sum), which bounds the
    rounding error of either summation order."""
    err = (got.double() - want.double()).abs()
    lim = atol + rtol * scale.double()
    if bool((err > lim).any()):
        raise AssertionError(f"{name}: max abs err {float(err.max())} "
                             f"exceeds atol={atol} rtol={rtol}")
    return float(err.max()) if err.numel() else 0.0


def sqd_scale(points, cents, assign):
    """‖p‖² + ‖c_assign‖² per row: the size of the terms d² cancels."""
    c2 = (cents * cents).sum(-1)
    return (points * points).sum(-1) + torch.gather(c2, 1, assign.long())


def same_bits(got, want) -> bool:
    """Every tensor of ``got`` equal to ``want``'s bit for bit (NaNs
    included)."""
    torch.cuda.synchronize()
    return all(g.shape == w.shape and g.dtype == w.dtype and torch.equal(
        g.view(torch.int32) if g.dtype == torch.float32 else g,
        w.view(torch.int32) if w.dtype == torch.float32 else w)
        for g, w in zip(got, want))


def differ(name, what, got, want) -> None:
    """Raise unless f32 tensors ``got`` and ``want`` are equal bit for
    bit, with the count of elements that differ."""
    if not same_bits([got], [want]):
        bad = got.view(torch.int32) != want.view(torch.int32)
        raise AssertionError(f"{name}: {what} differ at {int(bad.sum())} "
                             f"of {bad.numel()} elements")


#: the name K3 and K4 launch under (``csrc/kmeans_update.cu``)
KMEANS_UPDATE_MARKS = ["kmeans_update_kernel"]


def update_timing(name, call):
    """K3's or K4's times: events, the profiler's device time of its
    launches, and the launches one call makes, which must be one launch
    of the fused kernel (the reduce across CTAs runs inside it)."""
    launched = one_launch(name, call, KMEANS_UPDATE_MARKS)
    return dict(ms=cuda_ms(call),
                device_ms=kernel_device_ms(call, KMEANS_UPDATE_MARKS),
                device_launches=launched)


def check_update(name, pts, cents, got, want):
    """A fused Lloyd step (K3, or K4 with ``pts`` the gathered rows)
    against its plain version: assignments equal off near ties, counts
    exact, sums of the kernel's own assignment within 1e-5·Σ|p| of the
    float64 sums, sqd within 1e-5 + 1e-5·(‖p‖²+‖c‖²).  Returns (max abs
    err, differing assignments, their least margin)."""
    (ga, gs, gsum, gcnt), (wa, ws, wsum, wcnt) = got, want
    torch.cuda.synchronize()
    m, n, d = pts.shape
    k = cents.shape[1]
    n_diff, n_bad, min_margin = near_tie_rows(pts, cents, ga, wa)
    if n_bad:
        raise AssertionError(f"{name}: {n_bad} assignments differ beyond "
                             "a near tie")
    same = ga == wa
    err = check_close(f"{name} sqd", gs[same], ws[same],
                      sqd_scale(pts, cents, wa)[same])
    # counts and sums of the rows the kernel assigned, exactly (float64)
    seg = (torch.arange(m, device=pts.device)[:, None] * k
           + ga.long()).reshape(-1)
    rows_f64 = pts.double().reshape(m * n, d)
    exact = torch.zeros((m * k, d), dtype=torch.float64, device=pts.device
                        ).index_add_(0, seg, rows_f64).view(m, k, d)
    abs_sums = torch.zeros((m * k, d), dtype=torch.float64,
                           device=pts.device
                           ).index_add_(0, seg, rows_f64.abs()).view(m, k, d)
    if not torch.equal(gcnt.double(), torch.bincount(
            seg, minlength=m * k).view(m, k).double()):
        raise AssertionError(f"{name}: counts are not exact")
    check_close(f"{name} sums (vs float64)", gsum, exact, abs_sums)
    if n_diff == 0:     # a near-tie row moves one point between clusters
        if not torch.equal(gcnt, wcnt):
            raise AssertionError(f"{name}: counts differ")
        err = max(err, float((gsum - wsum).abs().max()))
    return err, n_diff, min_margin


def merge_operands(rng, p, n_side, n_common, dev, pairs=1):
    """(pairs, P) receiver/sender keys of ``n_side`` keys a side,
    ``n_common`` of them common in each pair, padded with the sentinels."""
    from repro_torch.kernels.sorted_intersect.ops import PAD_A64, PAD_B64
    a = np.full((pairs, p), PAD_A64, np.int64)
    b = np.full((pairs, p), PAD_B64, np.int64)
    for i in range(pairs):
        tags = np.unique(rng.integers(0, 2 ** 62, 3 * n_side,
                                      dtype=np.int64))
        tags = rng.permutation(tags)
        common = tags[:n_common]
        ta = np.sort(np.concatenate([common, tags[n_common:n_side]]))
        tb = np.sort(np.concatenate([common,
                                     tags[n_side:2 * n_side - n_common]]))
        a[i, :len(ta)] = (ta << 1) | 1
        b[i, :len(tb)] = tb << 1
    return torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)


def layout_operands(rng, p, fills, dev):
    """(len(fills), P) keys, a pair for each (n_a, n_b, n_common, layout):
    random tags with ``n_common`` shared, or from one ascending pool
    every A tag below every B tag (``a_below_b``), the reverse, the same
    tags on both sides (``identical``) or A and B strictly alternating
    (the CPU tests' ``_key_rows``)."""
    from repro_torch.kernels.sorted_intersect.ops import PAD_A64, PAD_B64
    a = np.full((len(fills), p), PAD_A64, np.int64)
    b = np.full((len(fills), p), PAD_B64, np.int64)
    for i, (n_a, n_b, n_common, layout) in enumerate(fills):
        pool = np.unique(rng.integers(0, 2 ** 62, 3 * (n_a + n_b) + 8,
                                      dtype=np.int64))
        if layout == "random":
            pool = rng.permutation(pool)
            ta = np.concatenate([pool[:n_common], pool[n_common:n_a]])
            tb = np.concatenate([pool[:n_common],
                                 pool[n_a:n_a + n_b - n_common]])
        elif layout == "a_below_b":
            ta, tb = pool[:n_a], pool[n_a:n_a + n_b]
        elif layout == "b_below_a":
            tb, ta = pool[:n_b], pool[n_b:n_b + n_a]
        elif layout == "identical":
            ta = tb = pool[:n_a]
        else:                                   # alternating
            ta, tb = pool[0:2 * n_a:2], pool[1:2 * n_b + 1:2]
        a[i, :len(ta)] = (np.sort(ta) << 1) | 1
        b[i, :len(tb)] = np.sort(tb) << 1
    return torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)


#: the name the merge launches under (``csrc/sorted_intersect.cu``)
MERGE_MARKS = ["merge_path_kernel"]


def merge_row(name, replaces, a, b, n_common, timed=True, **extra):
    """The merge kernel on (pairs, P) operands against its plain version,
    bitwise, ``n_common`` common keys over all pairs, one device kernel a
    call; timed (events, the profiler's device time a launch, the plain
    version) with the bound and the ``torch.sort`` yardstick."""
    from repro_torch.kernels.sorted_intersect import ref as si_ref
    from repro_torch.kernels.sorted_intersect.kernel import \
        sorted_intersect_cuda
    pairs, p = a.shape
    got, want = sorted_intersect_cuda(a, b), si_ref.sorted_intersect(a, b)
    torch.cuda.synchronize()
    for part, g, w in zip(("sel", "rank", "merged"), got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"{name} {extra}: {part} of the kernel and "
                                 f"the plain version differ on "
                                 f"{int((g != w).sum())} slots")
    if int(got[0].sum()) != n_common:
        raise AssertionError(f"{name} {extra}: wrong intersection size")
    call = lambda: sorted_intersect_cuda(a, b)
    launched = one_launch(f"{name} {extra}", call, MERGE_MARKS)
    row = dict(name=name, route="cuda",
               source="src/repro_torch/kernels/csrc/sorted_intersect.cu",
               replaces=replaces, max_abs_err=0.0, device_launches=launched,
               shape=[pairs, p], **extra)
    if not timed:
        return row
    ab = torch.cat([a, b], 1)
    depth = p.bit_length()           # log2(2P) merge levels
    b_ms, b_by = bound(pairs * (2 * p * 8 + 2 * p * 16),
                       pairs * 2 * p * 4 * depth)
    return row | dict(
        ms=cuda_ms(call), device_ms=launch_device_ms(call, MERGE_MARKS),
        plain_ms=cuda_ms(lambda: si_ref.sorted_intersect(a, b)),
        bound_ms=b_ms, bound_by=b_by,
        **library_times(lambda: torch.sort(ab, dim=1)),
        library="torch.sort of the 2P keys")


#: (what, P, [(n_a, n_b, n_common, layout) a pair]): the merge kernel's
#: tile and co-rank edges, bitwise (the CPU tests' MERGE_PATH_CASES)
MERGE_EDGES = (
    ("P=8, 5/8/3", 8, [(5, 8, 3, "random")]),
    ("P=8, 0/4/0", 8, [(0, 4, 0, "random")]),
    ("P=8, 8/8/8", 8, [(8, 8, 8, "identical")]),
    ("A all pads", 1 << 17, [(0, 70_000, 0, "random")]),
    ("B all pads", 1 << 17, [(70_000, 0, 0, "random")]),
    ("A below B", 1 << 17, [(1 << 17, 1 << 17, 0, "a_below_b")]),
    ("B below A", 1 << 17, [(100_000, 1 << 17, 0, "b_below_a")]),
    ("identical", 1 << 17, [(1 << 17, 1 << 17, 1 << 17, "identical")]),
    ("alternating", 1 << 17, [(1 << 17, 1 << 17, 0, "alternating")]),
    ("3 pairs", 1 << 17, [(70_000, 70_000, 49_000, "random"),
                          (1 << 17, 120_000, 100_000, "random"),
                          (5, 1, 1, "random")]),
    ("odd P, 2 pairs", 100_003, [(100_003, 90_000, 63_000, "random"),
                                 (3, 100_003, 2, "random")]),
    ("P=2^21", 1 << 21, [(1_400_000, 1_400_000, 980_000, "random")]),
)


def merge_edge_rows(dev):
    """K7/K8 at ``MERGE_EDGES`` (``check_only``): bitwise, one kernel a
    call; data from its own seed, so the other rows' data stay as they
    were."""
    from repro_torch.kernels.sorted_intersect.kernel import SINGLE_PASS_MAX_P
    rng = np.random.default_rng(SEED + 5)
    rows = []
    for what, p, fills in MERGE_EDGES:
        a, b = layout_operands(rng, p, fills, dev)
        k8 = p > SINGLE_PASS_MAX_P
        rows.append(merge_row(
            "sorted_intersect_tiled" if k8 else "sorted_intersect",
            f"src/repro/kernels/sorted_intersect/kernel.py:"
            f"{155 if k8 else 73}", a, b, sum(f[2] for f in fills),
            timed=False, check_only=what))
        del a, b
    return rows


def psi_kernel_rows(dev, rng):
    """K6 (the PRF), K7 and K8 (the merge) at the shapes of their paths,
    then the merge's edge rows."""
    from repro_torch.kernels.psi_prf import ref as prf_ref
    from repro_torch.kernels.psi_prf.kernel import prf_tags_cuda
    from repro_torch.kernels.sorted_intersect.ops import next_pow2

    rows = []
    # K6 psi_prf: both sides of one pair, P = 2^17 ids each
    p = next_pow2(70_000)
    ids = torch.from_numpy(rng.integers(0, 2 ** 62, (2, p),
                                        dtype=np.int64)).to(dev)
    seeds = torch.from_numpy(rng.integers(0, 2 ** 32, (2, 2),
                                          dtype=np.int64)).to(dev)
    got, want = prf_tags_cuda(ids, seeds), prf_ref.prf_tags(ids, seeds)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("psi_prf: kernel and plain version differ "
                             f"on {int((got != want).sum())} tags")
    b_ms, b_by = bound(ids.numel() * 16, ids.numel() * 52)
    rows.append(dict(
        name="psi_prf", route="cuda",
        source="src/repro_torch/kernels/csrc/psi_prf.cu",
        replaces="src/repro/kernels/psi_prf/kernel.py:35",
        max_abs_err=0.0,
        ms=cuda_ms(lambda: prf_tags_cuda(ids, seeds)),
        device_ms=kernel_device_ms(lambda: prf_tags_cuda(ids, seeds),
                                   ["prf_kernel"]),
        plain_ms=cuda_ms(lambda: prf_ref.prf_tags(ids, seeds)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=[2, p]))

    # K7 sorted_intersect: one pair at P = 2^17, 70,000 keys a side,
    # ~70% of them common (the HI rounds)
    a, b = merge_operands(rng, p, 70_000, 49_000, dev)
    rows.append(merge_row("sorted_intersect",
                          "src/repro/kernels/sorted_intersect/kernel.py:73",
                          a, b, 49_000))
    # K8 sorted_intersect_tiled: the same kernel past the reference's
    # single-pass bound, at the YP rounds' P = 2^19 (357,000 keys a side,
    # 249,900 common), at P = 2^20 (~70% overlap), and as the delta probe
    # batches it, nine (party, run) pairs at 2^19 (72 MB of keys, past
    # the 50 MB L2)
    for n_side, n_common, pairs, extra in (
            (357_000, 249_900, 1, {}),
            (700_000, 490_000, 1, {"check_only": "P=2^20"}),
            (300_000, 210_000, 9, {"check_only": "9 pairs at P=2^19"})):
        p8 = next_pow2(n_side)
        a, b = merge_operands(rng, p8, n_side, n_common, dev, pairs)
        rows.append(merge_row(
            "sorted_intersect_tiled",
            "src/repro/kernels/sorted_intersect/kernel.py:155", a, b,
            n_common * pairs, **extra))
        del a, b
    return rows + merge_edge_rows(dev)


def kernel_phase(dev):
    rng = np.random.default_rng(SEED)
    rows = psi_kernel_rows(dev, rng)
    kmeans_rows, slab, yslab = kmeans_kernel_rows(dev, rng)
    rows += kmeans_rows
    rows += bottom_kernel_rows(dev, slab, yslab, rng)
    rows += int8_kernel_rows(dev, slab, rng)
    rows += fp8_wire_rows(dev, slab, np.random.default_rng(SEED + 3))
    quantizer_check(dev, slab, rng)
    rows += llm_kernel_rows(dev, rng)
    for r in rows:
        emit({"phase": "kernel", **r})
    return rows


def kmeans_kernel_rows(dev, rng):
    """K3 / K5 at the coreset fit's shapes: the HI clients' slices
    (11/11/10 columns zero-padded to 11) of 49,000 rows, 14 centroids
    from the rows, and the YP job's (``timed_at``): 3 clients × 30
    columns, as many rows as it aligns (249,900), 12 centroids; then K4
    at a YP minibatch step and K5 at a minibatch build's end (one
    client's 357,000 rows, 12 centroids, ``timed_at``).  Returns the
    rows and the HI and YP slabs."""
    tr, _ = partitions()
    slab = client_slab(tr, 49_000, dev)
    rows = lloyd_kernel_rows(slab, 14, rng)
    ytr, _ = partitions("YP")
    yslab = client_slab(ytr, YP_ALIGNED, dev)
    rows += lloyd_kernel_rows(yslab, 12, rng, timed_at="YP")
    ypts = torch.from_numpy(ytr.client_features[0]).to(dev)[None]
    rows.append(gather_update_row(rng, ypts, 12, 1024))
    # K5 at a minibatch build's end: one client's 357,000 rows, K = 12
    rows.append(assign_row(ypts, ypts[:, torch.from_numpy(rng.choice(
        ypts.shape[1], 12, replace=False)).to(dev)].contiguous(),
        timed_at="YP minibatch end"))
    rows.append(gather_update_row(rng, slab, 14, 1000,
                                  check_only="HI, 3 clients"))
    rows.append(edge_update_checks(dev, rng))
    return rows, slab, yslab


#: (M, rows, K, d) where K3/K4's and K5's geometry and loops have edges: a
#: single row, ragged tiles, fewer rows than a CTA's threads, K = 1, d = 1,
#: widths past the compiled ones and past the CTA's 128 threads, more
#: (cluster, warp) offsets than a warp holds, partial rows too wide for
#: more than one in the reduce's stage (64-row tiles; K3 32-row and K5
#: 64-row tiles at d = 500)
EDGE_SHAPES = [(1, 1, 3, 5), (2, 127, 7, 2), (1, 129, 1, 1),
               (1, 1000, 12, 30), (3, 4097, 40, 64), (2, 3000, 9, 130),
               (1, 300, 16, 300), (1, 200, 16, 500)]


def edge_update_checks(dev, rng):
    """K3 at ``EDGE_SHAPES`` against its plain version (``check_update``)
    and K5 (assign and sqd bitwise), K5 against its plain version
    (``check_assign``), K4 over a draw of as many rows with duplicates
    bitwise K3 on the gathered rows.  Seeded normal points."""
    from repro_torch.kernels.kmeans_assign.kernel import kmeans_assign_cuda
    from repro_torch.kernels.kmeans_update import ref as ku_ref
    from repro_torch.kernels.kmeans_update.kernel import (
        kmeans_update_cuda, kmeans_update_gather_cuda)
    worst = worst5 = 0.0
    for m, n, k, d in EDGE_SHAPES:
        pts = torch.from_numpy(rng.normal(0, 1, (m, n, d)).astype(
            np.float32)).to(dev)
        cents = torch.from_numpy(rng.normal(0, 1, (m, k, d)).astype(
            np.float32)).to(dev)
        got = kmeans_update_cuda(pts, cents)
        err = check_update(f"kmeans_update {m, n, k, d}", pts, cents, got,
                           ku_ref.kmeans_update(pts, cents))[0]
        worst = max(worst, err)
        k5 = kmeans_assign_cuda(pts, cents)
        if not same_bits(got[:2], k5):
            raise AssertionError(f"kmeans_update {m, n, k, d}: assign/sqd "
                                 "differ from kmeans_assign's")
        worst5 = max(worst5, check_assign(f"kmeans_assign {m, n, k, d}",
                                          pts, cents, k5)[0])
        idx = torch.from_numpy(rng.integers(0, n, (m, n)).astype(
            np.int32)).to(dev)
        rows = torch.gather(pts, 1, idx.long()[..., None].expand(-1, -1, d))
        if not same_bits(kmeans_update_gather_cuda(pts, cents, idx),
                         kmeans_update_cuda(rows, cents)):
            raise AssertionError(f"kmeans_update_gather {m, n, k, d}: K4 "
                                 "differs from K3 on the gathered rows")
    return dict(name="kmeans_update", check_only="edge shapes",
                shapes=EDGE_SHAPES, max_abs_err=worst,
                kmeans_assign_max_abs_err=worst5)


def client_slab(part, n, dev):
    """The first ``n`` rows of every client of ``part`` as one (M, n,
    d_max) zero-padded stack on the card."""
    from repro_torch.kernels.padding import stack_padded
    return stack_padded([torch.from_numpy(f[:n]).to(dev)
                         for f in part.client_features], n,
                        max(f.shape[1] for f in part.client_features))


def lloyd_kernel_rows(pts, k, rng, **extra):
    """K3 (one fused Lloyd step) and K5 (the final assignment) on (M, N,
    d) points and k centroids drawn from the rows, each against its plain
    version."""
    from repro_torch.kernels.kmeans_assign.kernel import kmeans_assign_cuda
    from repro_torch.kernels.kmeans_update import ref as ku_ref
    from repro_torch.kernels.kmeans_update.kernel import kmeans_update_cuda

    m, n, d = pts.shape
    cents = pts[:, torch.from_numpy(rng.choice(n, k, replace=False)).to(
        pts.device)].contiguous()

    got = kmeans_update_cuda(pts, cents)
    err, n_diff, min_margin = check_update(
        "kmeans_update", pts, cents, got, ku_ref.kmeans_update(pts, cents))
    # the assignment and distances are K5's, bit for bit (one thread runs
    # a row's whole FMA chain in both); a second call repeats every bit
    if not same_bits(got[:2], kmeans_assign_cuda(pts, cents)):
        raise AssertionError("kmeans_update: assign/sqd differ from "
                             "kmeans_assign's on the same centroids")
    if not same_bits(kmeans_update_cuda(pts, cents), got):
        raise AssertionError("kmeans_update: two calls differ")
    io_bytes, ops_assign = assign_work(m, n, k, d)
    # K3 also writes the K centroids' sums and counts, and sums the rows
    b_ms, b_by = bound(io_bytes + m * k * (d + 1) * 4,
                       ops_assign + m * n * d)
    rows = [dict(
        name="kmeans_update", route="cuda",
        source="src/repro_torch/kernels/csrc/kmeans_update.cu",
        replaces="src/repro/kernels/kmeans_update/kernel.py:94",
        max_abs_err=err, assign_mismatch=n_diff,
        min_mismatch_margin=min_margin,
        k3_assign_sqd_equal_k5_bitwise=True, two_calls_bitwise=True,
        **update_timing("kmeans_update",
                        lambda: kmeans_update_cuda(pts, cents)),
        plain_ms=cuda_ms(lambda: ku_ref.kmeans_update(pts, cents)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=[m, n, d, k], **extra)]

    rows.append(assign_row(pts, cents, **extra))
    return rows


def assign_work(m, n, k, d):
    """(bytes, f32 ops) of an assignment of M·N rows of width d to K
    centroids: the rows and centroids read once, 8 B a row written; ‖p‖²,
    and a cross term, its combination and a compare a centroid."""
    return (m * n * d * 4 + m * k * d * 4 + m * n * 8,
            m * n * (2 * d + k * (2 * d + 3) + k))


#: the name K5 launches under (``csrc/kmeans_assign.cu``)
KMEANS_ASSIGN_MARKS = ["assign_kernel"]


def check_assign(name, pts, cents, got):
    """K5's (assign, sqd) against its plain version: assignments equal
    off near ties, sqd within 1e-5 + 1e-5·(‖p‖²+‖c‖²) where they agree.
    Returns (max abs err, differing assignments, their least margin)."""
    from repro_torch.kernels.kmeans_assign import ref as ka_ref
    ga, gs = got
    wa, ws = ka_ref.kmeans_assign(pts, cents)
    torch.cuda.synchronize()
    n_diff, n_bad, min_margin = near_tie_rows(pts, cents, ga, wa)
    if n_bad:
        raise AssertionError(f"{name}: {n_bad} assignments differ beyond "
                             "a near tie")
    same = ga == wa
    err = check_close(f"{name} sqd", gs[same], ws[same],
                      sqd_scale(pts, cents, wa)[same])
    return err, n_diff, min_margin


def assign_row(pts, cents, **extra):
    """K5 (the final assignment) on (M, N, d) points and (M, K, d)
    centroids against its plain version (``check_assign``), one device
    kernel a call (``one_launch``), with its bound and the ``cdist`` +
    ``argmin`` yardstick."""
    from repro_torch.kernels.kmeans_assign import ref as ka_ref
    from repro_torch.kernels.kmeans_assign.kernel import kmeans_assign_cuda

    m, n, d = pts.shape
    k = cents.shape[1]
    call = lambda: kmeans_assign_cuda(pts, cents)
    err, n_diff, min_margin = check_assign("kmeans_assign", pts, cents,
                                           call())
    b_ms, b_by = bound(*assign_work(m, n, k, d))
    return dict(
        name="kmeans_assign", route="cuda",
        source="src/repro_torch/kernels/csrc/kmeans_assign.cu",
        replaces="src/repro/kernels/kmeans_assign/kernel.py:39",
        max_abs_err=err, assign_mismatch=n_diff,
        min_mismatch_margin=min_margin,
        device_launches=one_launch(f"kmeans_assign {m, n, d, k}", call,
                                   KMEANS_ASSIGN_MARKS),
        ms=cuda_ms(call), device_ms=kernel_device_ms(call,
                                                     KMEANS_ASSIGN_MARKS),
        plain_ms=cuda_ms(lambda: ka_ref.kmeans_assign(pts, cents)),
        bound_ms=b_ms, bound_by=b_by,
        **library_times(lambda: torch.cdist(pts, cents).argmin(-1)),
        shape=[m, n, d, k], **extra)


def gather_update_row(rng, pts, k, bsz, **extra):
    """K4 at one minibatch step: ``bsz`` seeded indices a client, with
    duplicates, into ``pts`` (M, N, d), K = ``k`` centroids from the
    rows.  Bitwise equal to K3 on the pre-gathered rows, and a second
    call to the first; against its plain version as K3.  With
    ``check_only``, also indices outside [0, N): their rows get assign
    -1 and sqd NaN and count for no cluster, and every other row keeps
    its bits."""
    from repro_torch.kernels.kmeans_update import ref as ku_ref
    from repro_torch.kernels.kmeans_update.kernel import (
        kmeans_update_cuda, kmeans_update_gather_cuda)

    m, n, d = pts.shape
    dev = pts.device
    cents = pts[:, torch.from_numpy(rng.choice(n, k, replace=False)).to(
        dev)].contiguous()
    idx = torch.from_numpy(rng.integers(0, n, (m, bsz)).astype(
        np.int32)).to(dev)
    idx[:, 1::50] = idx[:, :1]               # duplicates, as a draw has
    call = lambda: kmeans_update_gather_cuda(pts, cents, idx)
    got = call()
    rows = torch.gather(pts, 1, idx.long()[..., None].expand(-1, -1, d))
    k3 = kmeans_update_cuda(rows, cents)
    if not same_bits(got, k3):
        raise AssertionError("kmeans_update_gather: K4 differs from K3 on "
                             "the gathered rows")
    if not same_bits(call(), got):
        raise AssertionError("kmeans_update_gather: two calls differ")
    err, n_diff, min_margin = check_update(
        "kmeans_update_gather", rows, cents, got,
        ku_ref.kmeans_update_gather(pts, cents, idx))
    if "check_only" in extra:
        out_of_range(pts, cents, idx, rows, got)
    unique = sum(int(torch.unique(i).numel()) for i in idx)
    b_ms, b_by = bound(
        4 * (unique * d + m * bsz + m * k * d + 2 * m * bsz
             + m * k * (d + 1)),
        m * bsz * (2 * d + k * (2 * d + 3) + k) + m * bsz * d)
    return dict(
        name="kmeans_update_gather", route="cuda",
        source="src/repro_torch/kernels/csrc/kmeans_update.cu",
        replaces="src/repro/kernels/kmeans_update/kernel.py:164",
        max_abs_err=err, assign_mismatch=n_diff,
        min_mismatch_margin=min_margin, k4_equals_k3_bitwise=True,
        two_calls_bitwise=True, **update_timing("kmeans_update_gather", call),
        plain_ms=cuda_ms(lambda: ku_ref.kmeans_update_gather(pts, cents,
                                                             idx)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=[m, n, d, k, bsz], **extra)


def out_of_range(pts, cents, idx, rows, good):
    """K4 with every 97th index of each client set to -1 or N: those
    rows get assign -1 and sqd NaN, the others the bits of ``good`` (the
    call on in-range indices), and counts and sums cover exactly the
    in-range rows (counts exact, sums as ``check_update``)."""
    from repro_torch.kernels.kmeans_update.kernel import \
        kmeans_update_gather_cuda
    m, n, d = pts.shape
    k = cents.shape[1]
    bad_idx = idx.clone()
    bad_idx[:, ::194] = -1
    bad_idx[:, 97::194] = n
    bad = bad_idx != idx
    ga, gs, gsum, gcnt = kmeans_update_gather_cuda(pts, cents, bad_idx)
    torch.cuda.synchronize()
    if not (bool((ga[bad] == -1).all()) and bool(gs[bad].isnan().all())):
        raise AssertionError("kmeans_update_gather: an index outside "
                             "[0, N) did not give assign -1 and sqd NaN")
    if not same_bits((ga[~bad], gs[~bad]), (good[0][~bad], good[1][~bad])):
        raise AssertionError("kmeans_update_gather: an index outside [0, "
                             "N) moved the bits of another row")
    keep = (~bad).double()[..., None]
    seg = (torch.arange(m, device=pts.device)[:, None] * k
           + ga.long().clamp_min(0)).reshape(-1)
    vals = (rows.double() * keep).reshape(-1, d)
    exact = torch.zeros((m * k, d), dtype=torch.float64, device=pts.device
                        ).index_add_(0, seg, vals).view(m, k, d)
    abs_sums = torch.zeros((m * k, d), dtype=torch.float64,
                           device=pts.device
                           ).index_add_(0, seg, vals.abs()).view(m, k, d)
    want_cnt = torch.zeros(m * k, dtype=torch.float64, device=pts.device
                           ).index_add_(0, seg, keep.reshape(-1)).view(m, k)
    if not torch.equal(gcnt.double(), want_cnt):
        raise AssertionError("kmeans_update_gather: counts with indices "
                             "outside [0, N) are not exact")
    check_close("kmeans_update_gather sums, indices outside [0, N)", gsum,
                exact, abs_sums)


def bottom_kernel_rows(dev, slab, yslab, rng):
    """K1 at the HI eval block (and at lr's o=1 without ReLU), K2 at a
    full-HI train step; K1 and K2 at the YP linreg job's shapes, o=1
    without ReLU: an eval block of 512 rows, one epoch over a
    coreset-sized slab (300 rows, the batch is the whole coreset), and a
    3,570-row step gathered from a (3, 249,900, 30) slab, as a job that
    trains on all the aligned rows steps.  Each against its plain
    version; K2 bitwise against K1 on the gathered rows."""
    from repro_torch.kernels.splitnn_bottom import ref as sb_ref
    from repro_torch.kernels.splitnn_bottom.kernel import (
        splitnn_bottom_cuda, splitnn_bottom_gather_cuda)

    g = lambda *shape, scale=1.0: (torch.from_numpy(rng.normal(
        size=shape).astype(np.float32)) * scale).to(dev)

    def scale_of(x, w, b):          # Σ_k |x_k w_k| + |b|, per output
        return torch.bmm(x.abs(), w.abs()) + b.abs()[:, None, :]

    def row(name, x, w, b, relu, idx=None, **extra):
        m, _, d = x.shape
        o = w.shape[2]
        xg = x if idx is None else x.index_select(1, idx).contiguous()
        if idx is None:
            call = lambda: splitnn_bottom_cuda(x, w, b, relu)
        else:
            call = lambda: splitnn_bottom_gather_cuda(idx, x, w, b, relu)
        got, want = call(), sb_ref.splitnn_bottom(xg, w, b, relu)
        torch.cuda.synchronize()
        err = check_close(name, got, want, scale_of(xg, w, b), rtol=1e-5,
                          atol=1e-6)
        if idx is not None:
            k1 = splitnn_bottom_cuda(xg, w, b, relu)
            torch.cuda.synchronize()
            if not torch.equal(got, k1):
                raise AssertionError("splitnn_bottom_gather: K2 differs "
                                     "from K1 on the gathered rows")
            extra["k2_equals_k1_bitwise"] = True
        bsz = xg.shape[1]
        rows_read = bsz if idx is None else int(torch.unique(idx).numel())
        nbytes = 4 * (m * rows_read * d + m * d * o + m * o + m * bsz * o
                      + (0 if idx is None else bsz))
        b_ms, b_by = bound(nbytes, m * bsz * o * (2 * d + 2))
        bb = b[:, None, :]
        return dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/splitnn_bottom.cu",
            max_abs_err=err, ms=cuda_ms(call),
            device_ms=launch_device_ms(call, ["bottom_kernel"]),
            plain_ms=cuda_ms(lambda: sb_ref.splitnn_bottom(x, w, b, relu,
                                                           idx)),
            bound_ms=b_ms, bound_by=b_by,
            **library_times(lambda: torch.baddbmm(bb, xg, w)),
            library="torch.baddbmm on the same (gathered) operands, "
                    "without the ReLU",
            shape=[m, bsz, d, o], relu=relu, **extra)

    def step_idx(n, bsz):
        idx = torch.from_numpy(rng.integers(0, n, bsz).astype(np.int32)
                               ).to(dev)
        idx[1::50] = idx[0]                  # duplicates, as a schedule
        return idx

    k1 = "src/repro/kernels/splitnn_bottom/kernel.py:40"
    k2 = "src/repro/kernels/splitnn_bottom/kernel.py:141"
    m, n, d = slab.shape
    eval_x = slab[:, :512].contiguous()
    w8, b8 = g(m, d, 8, scale=d ** -0.5), g(m, 8, scale=0.1)
    w1, b1 = g(m, d, 1, scale=0.1 * d ** -0.5), g(m, 1, scale=0.1)
    my, ny, dy = yslab.shape
    wy, by = g(my, dy, 1, scale=0.1 * dy ** -0.5), g(my, 1, scale=0.1)
    return [
        row("splitnn_bottom", eval_x, w8, b8, True, replaces=k1),
        row("splitnn_bottom", eval_x, w1, b1, False, check_only="lr",
            replaces=k1),
        row("splitnn_bottom_gather", slab, w8, b8, True,
            idx=step_idx(n, 700), replaces=k2),
        row("splitnn_bottom", yslab[:, :512].contiguous(), wy, by, False,
            check_only="YP eval block", replaces=k1),
        row("splitnn_bottom_gather", yslab[:, :300].contiguous(), wy, by,
            False, idx=torch.from_numpy(rng.permutation(300).astype(
                np.int32)).to(dev),
            check_only="YP coreset epoch", replaces=k2),
        row("splitnn_bottom_gather", yslab, wy, by, False,
            idx=step_idx(ny, max(8, YP_TRAIN // 100)),
            check_only="YP step over the aligned rows", replaces=k2),
    ]


def int8_kernel_rows(dev, slab, rng):
    """K9 and K10 in both forms.  The operands form (the first design,
    the TPU kernels' function; ``timed_at`` rows, outside the ``kernels``
    line):
    K9 at the int8 eval block (3, 512, 11) → 8 with ReLU and at lr's
    o = 1 without it, K10 at a 700-row train step with duplicates out of
    the (3, 49,000, 11) slab; the operands quantized as the eager path did
    (rows of x, columns of w, pow2 scales); each bitwise its plain
    version, K10 bitwise K9 on the gathered rows.  Then the wire form the
    quantized wire runs (``wire_kernel_rows``).  The library yardstick
    is ``torch.baddbmm`` on the dequantized f32 operands (the same product
    in f32); ``torch._int_mm`` takes 2-D operands with K and N multiples
    of 8, which d = 11 is not."""
    from repro_torch.kernels.splitnn_bottom import ref as sb_ref
    from repro_torch.kernels.splitnn_bottom.kernel import (
        splitnn_bottom_int8_cuda, splitnn_bottom_int8_gather_cuda)
    from repro_torch.kernels.splitnn_bottom.ops import int8_rows
    from repro_torch.quant import pow2, quantize_columns

    g = lambda *shape, scale=1.0: (torch.from_numpy(rng.normal(
        size=shape).astype(np.float32)) * scale).to(dev)

    def row(name, xq, sx, wq, sw, b, relu, idx=None, **extra):
        m, _, d = xq.shape
        o = wq.shape[2]
        xg = xq if idx is None else xq.index_select(1, idx).contiguous()
        if idx is None:
            call = lambda: splitnn_bottom_int8_cuda(xq, sx, wq, sw, b, relu)
        else:
            call = lambda: splitnn_bottom_int8_gather_cuda(idx, xq, sx, wq,
                                                           sw, b, relu)
        plain = lambda: sb_ref.splitnn_bottom_int8(xq, sx, wq, sw, b, relu,
                                                   idx)
        got, want = call(), plain()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel and plain version differ "
                                 f"by {float((got - want).abs().max())}")
        if idx is not None:
            k9 = splitnn_bottom_int8_cuda(xg, sx, wq, sw, b, relu)
            torch.cuda.synchronize()
            if not torch.equal(got, k9):
                raise AssertionError("splitnn_bottom_int8_gather: K10 "
                                     "differs from K9 on the gathered rows")
            extra["k10_equals_k9_bitwise"] = True
        bsz = xg.shape[1]
        rows_read = bsz if idx is None else int(torch.unique(idx).numel())
        nbytes = (m * rows_read * d + m * d * o
                  + 4 * (m * bsz + 2 * m * o + m * bsz * o
                         + (0 if idx is None else bsz)))
        # int8 products at the int8 tensor-core peak, the f32 epilogue
        # (scale product, scale, bias) at the f32 peak
        b_ms, b_by = bound(nbytes, [(2 * m * bsz * d * o, INT8_OPS),
                                    (3 * m * bsz * o, F32_FLOPS)])
        xf = xg.float() * sx[:, :, None]
        wf = wq.float() * sw[:, None, :]
        bb = b[:, None, :]
        return dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/splitnn_bottom.cu",
            max_abs_err=0.0, ms=cuda_ms(call),
            device_ms=kernel_device_ms(call, ["bottom_int8_kernel"]),
            plain_ms=cuda_ms(plain), bound_ms=b_ms, bound_by=b_by,
            nbytes=nbytes,
            **library_times(lambda: torch.baddbmm(bb, xf, wf)),
            library="torch.baddbmm on the dequantized f32 operands (the "
                    "same product in f32), without the ReLU; "
                    "torch._int_mm does not take K = 11",
            shape=[m, bsz, d, o], relu=relu,
            timed_at="the operands form (the first design, the TPU "
                     "kernel's function)", **extra)

    m, n, d = slab.shape
    xq, sx = int8_rows(slab)
    eval_q, eval_s = xq[:, :512].contiguous(), sx[:, :512].contiguous()
    rows = []
    for o, relu in ((8, True), (1, False)):
        w, b = g(m, d, o, scale=d ** -0.5), g(m, o, scale=0.1)
        wq, ew = quantize_columns(w, "int8")
        sw = pow2(ew)
        rows.append(row("splitnn_bottom_int8_operands", eval_q, eval_s, wq,
                        sw, b, relu, replaces="src/repro/kernels/"
                        "splitnn_bottom/kernel.py:83"))
        if o == 8:
            idx = torch.from_numpy(rng.integers(0, n, 700).astype(
                np.int32)).to(dev)
            idx[1::50] = idx[0]              # duplicates, as a schedule
            rows.append(row(
                "splitnn_bottom_int8_gather_operands", xq,
                sx.index_select(1, idx).contiguous(), wq, sw, b, relu,
                idx=idx, replaces="src/repro/kernels/splitnn_bottom/"
                "kernel.py:208"))
    return rows + wire_kernel_rows(dev, slab, rng)


def wire_kernel_rows(dev, slab, rng):
    """K9 and K10 in the wire form, the quantized wire's one launch a
    call, each against the plain composition ``quantize_rows`` → int8
    pass → ``fake_quantize`` (``ref.splitnn_bottom_int8_wire``) on the
    card, bitwise: the wire value and, where the kernel writes it, the
    output before the rounding.  K9 at the int8 eval block (3, 512, 11)
    → 8 with ReLU (the ``kernels`` line's K9), at lr's o = 1 without, at
    a serving dispatch (3, 64, 11) → 8, at B = 509 and at o = 3; K10 at a
    700-row train step with duplicates out of the (3, 49,000, 11) slab,
    writing the pre-rounding output as training does (the ``kernels``
    line's K10), and without it.  Each call must be one device kernel
    (the profiler).  Times: events and device, beside the parent's path
    (the quantizers, the operands form and ``fake_quantize`` as eager
    ops, bitwise the same result: ``parent_path_ms``,
    ``parent_path_device_ms``, ``parent_path_launches``), the plain
    composition and ``torch.baddbmm`` on the dequantized operands.
    ``device_ms`` is the mean of the launches the profiler recorded: it
    drops an event of these 2-4 µs kernels now and then."""
    from repro_torch import quant as Q
    from repro_torch.kernels.splitnn_bottom import ref as sb_ref
    from repro_torch.kernels.splitnn_bottom.kernel import (
        splitnn_bottom_int8_cuda, splitnn_bottom_int8_gather_cuda,
        splitnn_bottom_int8_wire_cuda, splitnn_bottom_int8_wire_gather_cuda)
    from repro_torch.kernels.splitnn_bottom.ops import int8_rows

    marks = ["bottom_int8_kernel"]
    xq_slab, sx_slab = int8_rows(slab)
    g = lambda *shape, scale=1.0: (torch.from_numpy(rng.normal(
        size=shape).astype(np.float32)) * scale).to(dev)

    def row(name, x, w, b, relu, idx=None, keep_pre=False, **extra):
        m, _, d = x.shape
        o = w.shape[2]
        wq, ew = Q.quantize_columns(w, "int8")
        sw = Q.pow2(ew)
        if idx is None:
            call = lambda: splitnn_bottom_int8_wire_cuda(x, w, b, relu,
                                                         keep_pre)
            plain = lambda: sb_ref.splitnn_bottom_int8_wire(
                *int8_rows(x), w, b, relu)

            def parent():
                xq, sx = int8_rows(x)
                wq, ew = Q.quantize_columns(w, "int8")
                return Q.fake_quantize(splitnn_bottom_int8_cuda(
                    xq, sx, wq, Q.pow2(ew), b, relu), "int8")
            xq, sx = int8_rows(x)
            rows_read, bsz = x.shape[1], x.shape[1]
            x_bytes = 4 * m * bsz * d
            x_ops = 2 * m * bsz * d      # the row quantizer's |max|, scale
        else:
            call = lambda: splitnn_bottom_int8_wire_gather_cuda(
                idx, xq_slab, sx_slab, w, b, relu, keep_pre)
            plain = lambda: sb_ref.splitnn_bottom_int8_wire(
                xq_slab, sx_slab, w, b, relu, idx)

            def parent():
                wq, ew = Q.quantize_columns(w, "int8")
                return Q.fake_quantize(splitnn_bottom_int8_gather_cuda(
                    idx, xq_slab, sx_slab.index_select(1, idx), wq,
                    Q.pow2(ew), b, relu), "int8")
            xq = xq_slab.index_select(1, idx)
            sx = sx_slab.index_select(1, idx)
            rows_read, bsz = int(torch.unique(idx).numel()), idx.shape[0]
            x_bytes = (d + 4) * m * rows_read + 4 * bsz
            x_ops = 0
        (got, pre), (want, want_pre) = call(), plain()
        torch.cuda.synchronize()
        differ(name, "the wire values of the kernel and the plain "
               "composition", got, want)
        if keep_pre:
            differ(name, "the pre-rounding outputs", pre, want_pre)
        elif pre is not None:
            raise AssertionError(f"{name}: wrote pre without keep_pre")
        differ(name, "the parent's path and the plain composition",
               parent(), want)
        launched = one_launch(name, call, marks)
        parent_launched = device_launches(parent, reps=20)
        # bytes: x (f32 rows; K10 the gathered int8 rows and scales, the
        # indices), w and b read, the wire value (and pre) written; the
        # int8 products at the int8 peak, the f32 work at the f32 peak:
        # the quantizers' |max| and scaling (2 an element of x for K9, and
        # of w), the epilogue (3 an output) and the wire (|max|, encode,
        # decode: 3 an output)
        nbytes = x_bytes + 4 * (m * d * o + m * o
                                + m * bsz * o * (2 if keep_pre else 1))
        b_ms, b_by = bound(nbytes, [
            (2 * m * bsz * d * o, INT8_OPS),
            (x_ops + 2 * m * d * o + 6 * m * bsz * o, F32_FLOPS)])
        xf = xq.float() * sx[:, :, None]
        wf = wq.float() * sw[:, None, :]
        bb = b[:, None, :]
        return dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/splitnn_bottom.cu",
            max_abs_err=0.0, ms=cuda_ms(call),
            device_ms=launch_device_ms(call, marks),
            device_launches=launched,
            parent_path_ms=cuda_ms(parent),
            parent_path_device_ms=profile_device(parent)[1],
            parent_path_launches=sum(parent_launched.values()),
            plain_ms=cuda_ms(plain), bound_ms=b_ms, bound_by=b_by,
            nbytes=nbytes,
            **library_times(lambda: torch.baddbmm(bb, xf, wf)),
            library="torch.baddbmm on the dequantized f32 operands (the "
                    "product alone, in f32), without the ReLU",
            shape=[m, bsz, d, o], relu=relu, keep_pre=keep_pre, **extra)

    m, n, d = slab.shape
    eval_x = slab[:, :512].contiguous()
    w8, b8 = g(m, d, 8, scale=d ** -0.5), g(m, 8, scale=0.1)
    w1, b1 = g(m, d, 1, scale=0.1 * d ** -0.5), g(m, 1, scale=0.1)
    w3, b3 = g(m, d, 3, scale=d ** -0.5), g(m, 3, scale=0.1)
    idx = torch.from_numpy(rng.integers(0, n, 700).astype(np.int32)).to(dev)
    idx[1::50] = idx[0]                      # duplicates, as a schedule
    k9 = "src/repro/kernels/splitnn_bottom/kernel.py:83"
    k10 = "src/repro/kernels/splitnn_bottom/kernel.py:208"
    return [
        row("splitnn_bottom_int8", eval_x, w8, b8, True, replaces=k9),
        row("splitnn_bottom_int8", eval_x, w1, b1, False, replaces=k9,
            check_only="lr, o=1"),
        row("splitnn_bottom_int8", slab[:, :64].contiguous(), w8, b8, True,
            replaces=k9, check_only="a serving dispatch, B=64"),
        row("splitnn_bottom_int8", slab[:, :509].contiguous(), w8, b8, True,
            replaces=k9, check_only="B=509, a ragged wire block"),
        row("splitnn_bottom_int8", eval_x, w3, b3, True, replaces=k9,
            check_only="o=3, 80 rows a CTA"),
        row("splitnn_bottom_int8_gather", slab, w8, b8, True, idx=idx,
            keep_pre=True, replaces=k10),
        row("splitnn_bottom_int8_gather", slab, w8, b8, True, idx=idx,
            replaces=k10, check_only="no pre-rounding output (no_grad)"),
    ]


def fp8_wire_rows(dev, slab, rng):
    """K1 and K2 in the fp8 wire form, the fp8 wire's one launch a call:
    K1 at the eval block (3, 512, 11) → 8 with ReLU (the ``kernels``
    line's ``splitnn_bottom_fp8``), at lr's o = 1 without, at a serving
    dispatch (3, 64, 11) → 8, at B = 509 and at o = 3; K2 at a 700-row
    train step with duplicates out of the (3, 49,000, 11) slab, writing
    ``pre`` as training does (the ``kernels`` line's
    ``splitnn_bottom_fp8_gather``), and without it.  Each row is checked
    four ways: ``pre`` bitwise the f32 form's output on the same operands
    (a second call writes it where the row does not); the wire value
    bitwise ``quant.fake_quantize(pre, "fp8")``, eager on the card;
    ``pre`` within K1's tolerance of ``ref.splitnn_bottom`` (cuBLAS), and
    the wire value within that plus one fp8 step of its block (32·2^e)
    of the plain composition ``ref.splitnn_bottom_fp8_wire``
    (``max_abs_err``); one device kernel a call.  Times: events and
    device, beside the parent's path (the f32 form, then
    ``fake_quantize`` as eager ops: ``parent_path_*``), the plain
    composition and ``torch.baddbmm``."""
    from repro_torch import quant as Q
    from repro_torch.kernels.splitnn_bottom import ref as sb_ref
    from repro_torch.kernels.splitnn_bottom.kernel import (
        splitnn_bottom_cuda, splitnn_bottom_fp8_cuda,
        splitnn_bottom_fp8_gather_cuda, splitnn_bottom_gather_cuda)

    marks = ["bottom_kernel"]
    g = lambda *shape, scale=1.0: (torch.from_numpy(rng.normal(
        size=shape).astype(np.float32)) * scale).to(dev)

    def row(name, x, w, b, relu, idx=None, keep_pre=False, **extra):
        m, _, d = x.shape
        o = w.shape[2]
        if idx is None:
            call = lambda keep=keep_pre: splitnn_bottom_fp8_cuda(x, w, b,
                                                                 relu, keep)
            f32 = lambda: splitnn_bottom_cuda(x, w, b, relu)
            xg, rows_read, bsz = x, x.shape[1], x.shape[1]
        else:
            call = lambda keep=keep_pre: splitnn_bottom_fp8_gather_cuda(
                idx, x, w, b, relu, keep)
            f32 = lambda: splitnn_bottom_gather_cuda(idx, x, w, b, relu)
            xg = x.index_select(1, idx).contiguous()
            rows_read, bsz = int(torch.unique(idx).numel()), idx.shape[0]
        parent = lambda: Q.fake_quantize(f32(), "fp8")
        plain = lambda: sb_ref.splitnn_bottom_fp8_wire(x, w, b, relu, idx)
        (got, pre), (_, pre_k), k12 = call(), call(True), f32()
        (want, want_pre) = plain()
        torch.cuda.synchronize()
        if keep_pre:
            differ(name, "the pre-rounding outputs of two calls", pre, pre_k)
        elif pre is not None:
            raise AssertionError(f"{name}: wrote pre without keep_pre")
        differ(name, "pre and the f32 form's output", pre_k, k12)
        differ(name, "the wire value and fake_quantize(pre) on the card",
               got, Q.fake_quantize(pre_k, "fp8"))
        differ(name, "the parent's path and the wire value", parent(), got)
        scale = torch.bmm(xg.abs(), w.abs()) + b.abs()[:, None, :]
        pre_err = check_close(f"{name} pre vs cuBLAS", pre_k, want_pre,
                              scale, rtol=1e-5, atol=1e-6)
        e = torch.maximum(Q.quantize_row_blocks(pre_k, "fp8")[1],
                          Q.quantize_row_blocks(want_pre, "fp8")[1])
        step = (Q.pow2(e).double() * 32.0).repeat_interleave(
            Q.QUANT_BLOCK_ROWS, 1)[:, :bsz, None]
        err = check_close(f"{name} wire vs the plain composition", got,
                          want, scale, rtol=1e-5, atol=1e-6 + step)
        launched = one_launch(name, call, marks)
        parent_launched = device_launches(parent, reps=20)
        # bytes: x (K2: the rows it gathers and the indices), w and b
        # read, the wire value (and pre) written; the f32 products and
        # the epilogue (bias, ReLU; the wire's |max|, encode, decode) at
        # the f32 peak
        nbytes = 4 * (m * rows_read * d + (0 if idx is None else bsz)
                      + m * d * o + m * o
                      + m * bsz * o * (2 if keep_pre else 1))
        b_ms, b_by = bound(nbytes, 2 * m * bsz * d * o + 5 * m * bsz * o)
        bb = b[:, None, :]
        return dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/splitnn_bottom.cu",
            max_abs_err=err, pre_max_abs_err=pre_err,
            pre_equals_f32_form_bitwise=True,
            wire_equals_fake_quantize_bitwise=True,
            ms=cuda_ms(call), device_ms=launch_device_ms(call, marks),
            device_launches=launched,
            parent_path_ms=cuda_ms(parent),
            parent_path_device_ms=profile_device(parent)[1],
            parent_path_launches=sum(parent_launched.values()),
            plain_ms=cuda_ms(plain), bound_ms=b_ms, bound_by=b_by,
            nbytes=nbytes,
            **library_times(lambda: torch.baddbmm(bb, xg, w)),
            library="torch.baddbmm on the same (gathered) operands, "
                    "without the ReLU and the rounding",
            shape=[m, bsz, d, o], relu=relu, keep_pre=keep_pre, **extra)

    m, n, d = slab.shape
    eval_x = slab[:, :512].contiguous()
    w8, b8 = g(m, d, 8, scale=d ** -0.5), g(m, 8, scale=0.1)
    w1, b1 = g(m, d, 1, scale=0.1 * d ** -0.5), g(m, 1, scale=0.1)
    w3, b3 = g(m, d, 3, scale=d ** -0.5), g(m, 3, scale=0.1)
    idx = torch.from_numpy(rng.integers(0, n, 700).astype(np.int32)).to(dev)
    idx[1::50] = idx[0]                      # duplicates, as a schedule
    k1 = "src/repro/kernels/splitnn_bottom/kernel.py:40"
    k2 = "src/repro/kernels/splitnn_bottom/kernel.py:141"
    return [
        row("splitnn_bottom_fp8", eval_x, w8, b8, True, replaces=k1),
        row("splitnn_bottom_fp8", eval_x, w1, b1, False, replaces=k1,
            check_only="lr, o=1"),
        row("splitnn_bottom_fp8", slab[:, :64].contiguous(), w8, b8, True,
            replaces=k1, check_only="a serving dispatch, B=64"),
        row("splitnn_bottom_fp8", slab[:, :509].contiguous(), w8, b8, True,
            replaces=k1, check_only="B=509, a ragged wire block"),
        row("splitnn_bottom_fp8", eval_x, w3, b3, True, replaces=k1,
            check_only="o=3, 80 rows a CTA"),
        row("splitnn_bottom_fp8_gather", slab, w8, b8, True, idx=idx,
            keep_pre=True, replaces=k2),
        row("splitnn_bottom_fp8_gather", slab, w8, b8, True, idx=idx,
            replaces=k2, check_only="no pre-rounding output (no_grad)"),
    ]


#: values a chunk of the fp8 encode sweep
FP8_SWEEP_CHUNK = 1 << 26


def fp8_encode_sweep(dev):
    """The fp8 wire rounding through the wire K1, bitwise against the
    eager ``quant.fake_quantize(·, "fp8")`` on the card.  With d = 1,
    w = 1, b = 0 and no ReLU the pass's output is x itself, -0 aside
    (``fmaf(-0, 1, 0)`` is +0; checked), so the sweep drives the
    epilogue's exponent, encode and decode.  First every finite f32 with
    |x| <= 448 (both signs, -0 aside: the pass never gives it), 7 a wire
    block behind a first row pinned at 448
    (exponent 0), in chunks; then 10^6 seeded values at each exponent a
    finite f32 |max| reaches under fp8 (e in [-126, 120]: 448 · 2^121 is
    past FLT_MAX), the first row pinned at min(448 · 2^e, FLT_MAX), the
    others of magnitude 2^u · 2^e with u uniform over [-24, log2 448]
    (e4m3's normal and subnormal values and those that round to 0), half
    of them cut to 5 significant bits (e4m3's grid and its halfway
    points), clamped to the pin.  The first mismatch goes to
    ``chiprun_out/fp8_sweep_mismatch.json``."""
    import math

    from repro_torch import quant as Q
    from repro_torch.kernels.splitnn_bottom.kernel import (
        splitnn_bottom_fp8_cuda)

    w1 = torch.ones((1, 1, 1), device=dev)
    b0 = torch.zeros((1, 1), device=dev)
    f32_max = float(torch.finfo(torch.float32).max)

    def through(vals, pin):
        """vals (n,) f32, 7 a block behind ``pin`` (nb,): the number of
        values checked."""
        nb = -(-vals.numel() // 7)
        rest = torch.zeros(nb * 7, device=dev)
        rest[:vals.numel()] = vals
        x = torch.cat([torch.as_tensor(pin, device=dev).expand(nb)[:, None],
                       rest.view(nb, 7)], 1).view(1, nb * 8, 1)
        wire, pre = splitnn_bottom_fp8_cuda(x, w1, b0, False, True)
        want = Q.fake_quantize(pre, "fp8")
        x = x + 0.0        # the pass's output: x, but +0 for -0
        torch.cuda.synchronize()
        ok = [same_bits([pre], [x]), same_bits([wire], [want])]
        if not all(ok):
            bad = ((pre.view(torch.int32) != x.view(torch.int32))
                   | (wire.view(torch.int32) != want.view(torch.int32)))
            i = int(bad.view(-1).nonzero()[0])
            blk = slice(i // 8 * 8, i // 8 * 8 + 8)
            hexs = lambda t: [f"{v:#010x}" for v in
                              t.view(-1)[blk].view(torch.int32).tolist()]
            info = {"block_x": hexs(x), "block_pre": hexs(pre),
                    "block_wire": hexs(wire), "block_fake_quantize":
                    hexs(want), "element": i % 8}
            os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
            with open(os.path.join(ROOT, "chiprun_out",
                                   "fp8_sweep_mismatch.json"), "w") as f:
                json.dump(info, f, indent=1)
            raise AssertionError(f"fp8 encode sweep: the wire K1 and "
                                 f"fake_quantize differ: {info}")
        return vals.numel()

    t0 = time.perf_counter()
    top = 0x43E00000                          # the bits of 448.0
    exhaustive = 0
    for lo in range(0, top + 1, FP8_SWEEP_CHUNK):
        vals = torch.arange(lo, min(lo + FP8_SWEEP_CHUNK, top + 1),
                            dtype=torch.int32, device=dev).view(
                                torch.float32)
        exhaustive += through(vals, 448.0)
        exhaustive += through(-vals[1:] if lo == 0 else -vals, 448.0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 20)
    per, seeded = 10 ** 6, 0
    for e0 in range(-126, 121, 16):
        es = torch.arange(e0, min(e0 + 16, 121), device=dev,
                          dtype=torch.float64)[:, None]
        pin = torch.clamp(448.0 * torch.exp2(es), max=f32_max)
        u = torch.rand((es.shape[0], per), generator=gen, device=dev,
                       dtype=torch.float64) * (math.log2(448.0) + 24) - 24
        mant, ex = torch.frexp(torch.exp2(u))
        coarse = torch.rand(u.shape, generator=gen, device=dev) < 0.5
        mant = torch.where(coarse, torch.round(mant * 32) / 32, mant)
        sign = torch.where(torch.rand(u.shape, generator=gen, device=dev)
                           < 0.5, -1.0, 1.0).double()
        v = sign * torch.ldexp(mant, ex) * torch.exp2(es)
        v = torch.minimum(torch.maximum(v, -pin), pin).float()
        for j in range(es.shape[0]):
            seeded += through(v[j], pin[j].float())
    return {"fp8_sweep_exhaustive": exhaustive, "fp8_sweep_seeded": seeded,
            "fp8_sweep_exponents": [-126, 120],
            "fp8_sweep_s": time.perf_counter() - t0}


def quantizer_check(dev, slab, rng):
    """The quantizers on the card against the same quantizers on the
    CPU, bitwise, for int8 and fp8: rows and columns, row blocks and
    their dequantization, the fake-quantize pass and ``int8_rows``, on
    the HI rows, on weights, and on seeded magnitudes over 2^-120 ...
    2^100 (scales are built from exponent bits, not ``exp2``).  A
    mismatch raises with the first differing elements, and the input
    that showed it goes to ``chiprun_out/quantizer_mismatch.pt``.  Then
    the fp8 wire rounding through the wire K1 (``fp8_encode_sweep``)."""
    from repro_torch import quant as Q
    from repro_torch.kernels.splitnn_bottom.ops import int8_rows

    wide = torch.from_numpy((np.exp2(rng.uniform(-120, 100, 3 * 4096 * 8))
                             * np.sign(rng.normal(size=3 * 4096 * 8))
                             ).astype(np.float32)).reshape(3, 4096, 8)
    wide[:, :64] *= 1e-30                  # blocks of tiny values too
    cases = {"hi_rows": slab[:, :4096].cpu(), "wide": wide,
             "weights": torch.from_numpy(rng.normal(size=(3, 11, 8)).astype(
                 np.float32)) * 0.3}

    def bits(t):
        return t.view(torch.int8) if t.dtype == Q.FP8_DTYPE else t

    def check(what, x, card, cpu):
        for a, b in zip(card, cpu):
            a, b = bits(a.cpu()), bits(b)
            if torch.equal(a, b):
                continue
            diff = (a != b).nonzero()[:4].tolist()
            os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
            torch.save({"what": what, "x": x}, os.path.join(
                ROOT, "chiprun_out", "quantizer_mismatch.pt"))
            raise AssertionError(
                f"{what}: card and CPU differ at {int((a != b).sum())} "
                f"elements, first {diff}: card "
                f"{[a[tuple(i)].item() for i in diff]}, CPU "
                f"{[b[tuple(i)].item() for i in diff]}")

    checked = 0
    for quant in ("int8", "fp8"):
        for name, x in cases.items():
            xd = x.to(dev)
            for fn in (Q.quantize_rows, Q.quantize_columns,
                       Q.quantize_row_blocks):
                check(f"{fn.__name__}({name}, {quant})", x, fn(xd, quant),
                      fn(x, quant))
                checked += 2
            qc, ec = Q.quantize_row_blocks(x, quant)
            check(f"dequantize_row_blocks({name}, {quant})", x,
                  [Q.dequantize_row_blocks(qc.to(dev), ec.to(dev)),
                   Q.fake_quantize(xd, quant)],
                  [Q.dequantize_row_blocks(qc, ec), Q.fake_quantize(x, quant)])
            checked += 2
    for name in ("hi_rows", "wide"):
        x = cases[name]
        check(f"int8_rows({name})", x, int8_rows(x.to(dev)), int8_rows(x))
        checked += 2
    out = {"phase": "quantizer_check", "tensors_bitwise": checked,
           "cases": {k: list(v.shape) for k, v in cases.items()},
           **fp8_encode_sweep(dev)}
    emit(out)
    return out


# --------------------------------------------------- LLM kernels (K11, K12)

BF16_ULP = 2.0 ** -7           # bf16 spacing relative to a value, at most


def visible_pairs(sq, sk, causal=True, window=0, prefix=0) -> int:
    """(query, key) pairs the mask leaves visible, suffix-aligned: the
    pairs whose products the function needs."""
    row = np.arange(sq, dtype=np.int64)[:, None] + (sk - sq)
    col = np.arange(sk, dtype=np.int64)[None, :]
    ok = np.ones((sq, sk), bool) if not causal else col <= row
    if window > 0:
        ok &= ((row - col) < window) | (col < prefix)
    return int(ok.sum())


def flash_row(dev, rng, b, sq, sk, h, kv, dh, dtype, check_only=None,
              timed_at=None, path=None, **kw):
    """K11 on seeded unit-normal q/k/v against its plain version (f32
    full attention, rounded once to q's dtype): within 1e-5 abs in f32;
    in bf16 both round one f32 result, so within one bf16 ulp
    (2^-7·|plain| + 1e-6).  Every row also asks for the LSE: the output
    must then be bitwise the same, and the LSE within 1e-4·(1 +
    max|plain|) of the plain ``return_lse``.  Timed rows (the main path's, ``path`` = (the
    LLM phase, its launch count) a shape another LLM path runs, and
    ``timed_at`` a config's shape outside the ``kernels`` line) take SDPA
    with ``enable_gqa`` and the same mask as the library yardstick
    (``is_causal``; a boolean mask under a window or prefix; none
    without the causal mask)."""
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_cuda

    g = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(dev, dtype)
    q, k, v = g(b, sq, h, dh), g(b, sk, kv, dh), g(b, sk, kv, dh)
    call = lambda: flash_attention_cuda(q, k, v, **kw)
    plain = lambda: fa_ref.flash_attention(q, k, v, **kw)
    got, want = call(), plain()
    # the LSE the backward reads: asking for it leaves the output's bits
    with_lse, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    want_lse = fa_ref.flash_attention(q, k, v, return_lse=True, **kw)[1]
    torch.cuda.synchronize()
    if got.dtype != q.dtype or not bool(torch.isfinite(got).all()):
        raise AssertionError("flash_attention: wrong dtype or non-finite")
    if not torch.equal(got, with_lse):
        raise AssertionError(f"flash_attention {[b, sq, sk, h, kv, dh]} "
                             f"{kw}: the output changes with return_lse")
    lse_err = check_close(f"flash_attention lse ({str(dtype)}, "
                          f"{[b, sq, sk, h, kv, dh]}, {kw})", lse, want_lse,
                          torch.zeros_like(want_lse), rtol=0.0,
                          atol=1e-4 * (1 + float(want_lse.abs().max())))
    del with_lse, lse, want_lse
    if dtype == torch.float32:
        err = check_close("flash_attention", got, want,
                          torch.zeros_like(want), rtol=0.0, atol=1e-5)
    else:
        err = check_close(f"flash_attention (bf16, {[b, sq, sk, h, kv, dh]}"
                          f", {kw})", got, want, want.float().abs(),
                          rtol=BF16_ULP, atol=1e-6)
    row = dict(name="flash_attention", route="cuda",
               source="src/repro_torch/kernels/csrc/flash_attention.cu",
               replaces="src/repro/kernels/flash_attention/kernel.py:99",
               max_abs_err=err, lse_max_abs_err=lse_err,
               out_bitwise_with_lse=True, shape=[b, sq, sk, h, kv, dh],
               dtype=str(dtype).split(".")[-1], **kw)
    del want
    if check_only:
        return row | {"check_only": check_only}
    if timed_at:
        row["timed_at"] = timed_at
    if path:
        row["path"] = path
    masks = {key: kw[key] for key in kw if key != "logit_cap"}
    visible = visible_pairs(sq, sk, **masks)
    # Tensor-core bound of the bf16 row: QKᵀ of bf16 operands is exact in
    # f32, so one bf16 pass at the dense rate; P·V takes f32
    # probabilities, which three bf16 pieces carry whole (8 + 8 + 8
    # significand bits), so three passes.  The exps are not counted.
    assert q.dtype == torch.bfloat16, "the bound assumes bf16 q/k/v"
    products = 2 * b * h * dh * visible              # flops of each GEMM
    b_ms, b_by = bound(q.element_size() * (2 * q.numel() + 2 * k.numel()),
                       (1 + 3) * products, BF16_FLOPS)
    assert not kw.get("logit_cap"), "SDPA cannot softcap"
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if masks.get("window") or masks.get("prefix") or (
            masks.get("causal", True) and sq != sk):
        # SDPA's is_causal aligns the top left: Sq < Sk takes the mask
        row_pos = torch.arange(sq, device=dev)[:, None] + (sk - sq)
        col = torch.arange(sk, device=dev)[None, :]
        mask = col <= row_pos if masks.get("causal", True) else col >= 0
        if masks.get("window"):
            mask &= ((row_pos - col) < masks["window"]) | (
                col < masks.get("prefix", 0))
        lib_kw, what = dict(attn_mask=mask), "a boolean attn_mask"
    elif masks.get("causal", True):
        lib_kw, what = dict(is_causal=True), "is_causal"
    else:
        lib_kw, what = {}, "no mask"
    return row | dict(
        ms=cuda_ms(call),
        device_ms=kernel_device_ms(call, ["flash_attention_kernel"]),
        plain_ms=cuda_ms(plain, reps=5), bound_ms=b_ms, bound_by=b_by,
        visible_pairs=visible,
        **library_times(lambda: sdpa(qt, kt, vt, enable_gqa=True,
                                     **lib_kw)),
        library=f"torch scaled_dot_product_attention({what}, enable_gqa)")


def flash_rows(dev, rng):
    """K11 at the tinyllama prefill (B = 2, Sq = Sk = 2,048, H = 32,
    KV = 4, Dh = 64, causal, bf16: the ``kernels`` line's row), in f32
    there, and in f32 and bf16 under a window and prefix, a softcap with
    Dh = 128, without the causal mask with Dh = 48 and with Sq < Sk
    (``check_only``); bf16 at the other registered configs' shapes that
    reach K11 (B = 2): stablelm-12b (G = 4, Dh = 160) and qwen2-72b (G =
    8, Dh = 128) at S = 2,048 timed, gemma2-9b (G = 2, Dh = 256, window
    4,096, softcap 50: SDPA cannot softcap) checked; the shapes of the
    other LLM paths timed (``path``): hymba-1.5b's prefill (S = 128 meta
    tokens + 2,048, G = 5, window 1,024, prefix 128), internvl2-1b's (S
    = 256 patches + 2,048, G = 7), olmoe-1b-7b's (S = 2,048, G = 1, Dh =
    128), whisper-large-v3's encoder (1,500 frames, no causal mask) and
    its cross-attention (Sq = 1 against the 1,500 frames), the last two
    checked in f32 too; and bf16 at G = 128 (the heads split over CTAs)
    and at Dh = 36 (rows not 16-byte aligned: the kernel's element-wise
    loads); hymba-1.5b's context-parallel shapes (``hymba_cp_rows``)."""
    f32, bf16 = torch.float32, torch.bfloat16
    rows = [flash_row(dev, rng, 2, 2048, 2048, 32, 4, 64, bf16, causal=True)]
    for dtype in (f32, bf16):
        tag = str(dtype).split(".")[-1]
        if dtype == f32:
            rows.append(flash_row(dev, rng, 2, 2048, 2048, 32, 4, 64, f32,
                                  causal=True, check_only="f32"))
        rows += [
            flash_row(dev, rng, 1, 1024, 1024, 8, 2, 64, dtype, causal=True,
                      window=256, prefix=32,
                      check_only=f"window+prefix, {tag}"),
            flash_row(dev, rng, 1, 512, 512, 16, 8, 128, dtype, causal=True,
                      window=128, logit_cap=50.0,
                      check_only=f"softcap, Dh=128, {tag}"),
            flash_row(dev, rng, 2, 384, 384, 4, 4, 48, dtype, causal=False,
                      check_only=f"non-causal, Dh=48, {tag}"),
            flash_row(dev, rng, 2, 100, 700, 6, 3, 32, dtype, causal=True,
                      window=200, prefix=16, check_only=f"Sq<Sk, {tag}")]
    rows += [
        flash_row(dev, rng, 2, 2048, 2048, 32, 8, 160, bf16, causal=True,
                  timed_at="stablelm-12b"),
        flash_row(dev, rng, 2, 2048, 2048, 64, 8, 128, bf16, causal=True,
                  timed_at="qwen2-72b"),
        flash_row(dev, rng, 2, 2048, 2048, 16, 8, 256, bf16, causal=True,
                  window=4096, logit_cap=50.0, check_only="gemma2-9b"),
        flash_row(dev, rng, 2, 2176, 2176, 25, 5, 64, bf16, causal=True,
                  window=1024, prefix=128,
                  path=("llm_hybrid", "flash_attention")),
        flash_row(dev, rng, 2, 2304, 2304, 14, 2, 64, bf16, causal=True,
                  path=("llm_vlm", "flash_attention")),
        flash_row(dev, rng, 2, 2048, 2048, 16, 16, 128, bf16, causal=True,
                  path=("llm_moe", "flash_attention")),
        flash_row(dev, rng, 2, 1500, 1500, 20, 20, 64, bf16, causal=False,
                  path=("llm_audio", "launches_encode")),
        flash_row(dev, rng, 2, 1, 1500, 20, 20, 64, bf16, causal=False,
                  path=("llm_audio", "launches_steps")),
        flash_row(dev, rng, 2, 1, 1500, 20, 20, 64, f32, causal=False,
                  check_only="whisper cross-attention, f32"),
        flash_row(dev, rng, 2, 1500, 1500, 20, 20, 64, f32, causal=False,
                  check_only="whisper encoder, f32"),
        flash_row(dev, rng, 1, 64, 64, 128, 1, 64, bf16, causal=True,
                  check_only="G=128"),
        flash_row(dev, rng, 2, 300, 300, 4, 2, 36, bf16, causal=True,
                  window=100, check_only="Dh=36")]
    rows += hymba_cp_rows(dev, rng, flash_row)
    return rows


def hymba_cp_rows(dev, rng, row_fn):
    """``row_fn`` (``flash_row`` or ``flash_bwd_row``) at hymba-1.5b's
    context-parallel shapes on (2, 2) (``llm_sharded``'s hymba run): a
    data rank's one batch row of 128 meta tokens + 2,048, each model rank
    its block of 1,088 q rows against the keys up to the block's end
    (rank 0: 1,088, rank 1: 2,176), G = 5, Dh = 64, prefix 128: timed
    under the window of 1,024 (3 of the run's 4 layers), checked in the
    global layer's full attention; the forward launches twice a layer a
    step (remat), the backward once."""
    rows = []
    for rank, sk in enumerate(HYMBA_CP_SK):
        tag = f"hymba-1.5b context-parallel, model rank {rank}"
        extra = ({"launches_a_step": HYMBA_SHARDED_LAYERS - 1}
                 if row_fn is flash_bwd_row else {})
        rows.append(row_fn(dev, rng, 1, HYMBA_CP_SQ, sk, 25, 5, 64,
                           torch.bfloat16, causal=True, window=1024,
                           prefix=128, timed_at=tag, **extra))
        rows.append(row_fn(dev, rng, 1, HYMBA_CP_SQ, sk, 25, 5, 64,
                           torch.bfloat16, causal=True, prefix=128,
                           check_only=f"{tag}, global layer"))
    return rows


def grad_check(dev, rng):
    """K11's op differentiates on the card: for each of q, k, v in turn
    requiring grad (f32, a window, prefix and softcap), the gradient
    through ``ops.flash_attention(impl="kernel")`` (K11 forward, then its
    backward kernel: one launch of each) against autograd of the plain
    version on the card, within 1e-5·(1 + max|grad|).  K12 has no
    backward: under grad mode its CUDA wrapper must refuse an operand
    that requires grad (RuntimeError, "no backward"), and under
    ``torch.no_grad()`` the same call runs and matches its plain version
    (within 1e-5·(1+max|y|)); so does K11's op.  A refusal that is not
    seen fails the run."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda

    g = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(dev)
    kw = dict(causal=True, window=40, prefix=8, logit_cap=30.0)
    qkv, do = (g(1, 96, 4, 32), g(1, 96, 2, 32), g(1, 96, 2, 32)), \
        g(1, 96, 4, 32)
    errs = []
    for i in range(3):
        grads = []
        for impl in ("kernel", "ref"):
            leaves = [t.clone().requires_grad_(j == i)
                      for j, t in enumerate(qkv)]
            build.reset_launches()
            out = fa_ops.flash_attention(*leaves, impl=impl, **kw)
            grads.append(torch.autograd.grad(out, leaves[i], do)[0])
            if impl == "kernel" and (
                    build.LAUNCHES["flash_attention"] != 1
                    or build.LAUNCHES["flash_attention_bwd"] != 1):
                raise AssertionError(f"flash_attention: grad of operand {i}"
                                     f" launched {dict(build.LAUNCHES)}")
        torch.cuda.synchronize()
        err = float((grads[0] - grads[1]).abs().max())
        if err > 1e-5 * (1 + float(grads[1].abs().max())):
            raise AssertionError(f"flash_attention: autograd of operand {i}"
                                 f" {err} from the plain version's")
        errs.append(err)
    with torch.no_grad():
        err = float((fa_ops.flash_attention(*qkv, impl="kernel", **kw)
                     - fa_ops.flash_attention(*qkv, impl="ref", **kw)
                     ).abs().max())
    if err > 1e-5:
        raise AssertionError(f"flash_attention under no_grad: {err}")
    out = {"flash_attention": dict(grad_max_abs_err=errs,
                                   no_grad_max_abs_err=err)}
    args = (g(1, 64, 2, 16), g(1, 64, 2).abs() * 0.1, -g(2).abs(),
            g(1, 64, 16), g(1, 64, 16))
    for i in range(len(args)):
        leaves = [t.clone().requires_grad_(j == i)
                  for j, t in enumerate(args)]
        try:
            ssd_scan_cuda(*leaves, chunk=32)
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
            msg = str(e)
        else:
            raise AssertionError(f"ssd_scan: the CUDA wrapper ran under "
                                 f"grad with operand {i} requiring grad")
        with torch.no_grad():
            got = ssd_scan_cuda(*leaves, chunk=32)[0]
            want = ssd_ref.ssd_scan(*leaves, 32)[0]
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if err > 1e-5 * (1 + float(want.abs().max())):
            raise AssertionError(f"ssd_scan under no_grad: {err} from the "
                                 "plain version")
    out["ssd_scan"] = dict(raised=msg, operands_refused=len(args),
                           no_grad_max_abs_err=err)
    emit({"phase": "grad", **out})
    return out


def flash_bwd_row(dev, rng, b, sq, sk, h, kv, dh, dtype, check_only=None,
                  timed_at=None, launches_a_step=None, **kw):
    """K11's backward on seeded unit-normal q/k/v/do and the K11
    forward's output o and LSE, against its plain version
    (``ref.flash_attention_bwd``, f32 math, one rounding to the dtype):
    f32 within 1e-4·max|plain| (sums over up to G·Sq rows in other
    orders), bf16 within 2^-7·|plain| + 1e-4·max|plain|; a second launch
    bitwise the first.  Timed rows (bf16; ``timed_at`` names the config,
    ``launches_a_step`` its train step's launches at this shape, one an
    attention layer of that kind) carry the
    event and device time of the two launches, the plain version's time,
    the bound and the backward of SDPA (``enable_gqa``, the same mask;
    none under a softcap) as the library: event time of
    ``torch.autograd.grad`` through a saved forward, and its device
    time."""
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.flash_attention.kernel import (
        bwd_tiles, flash_attention_bwd_cuda, flash_attention_cuda)

    g = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(dev, dtype)
    q, k, v = g(b, sq, h, dh), g(b, sk, kv, dh), g(b, sk, kv, dh)
    do = g(b, sq, h, dh)
    o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    call = lambda: flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
    plain = lambda: fa_ref.flash_attention_bwd(q, k, v, o, do, **kw)
    got, again, want = call(), call(), plain()
    torch.cuda.synchronize()
    tag = f"flash_attention_bwd ({str(dtype)}, {[b, sq, sk, h, kv, dh]}, {kw})"
    errs = []
    for name, x, y, w in zip(("dq", "dk", "dv"), got, again, want):
        if x.dtype != dtype or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{tag}: {name} wrong dtype or non-finite")
        if not torch.equal(x, y):
            raise AssertionError(f"{tag}: {name} differs between two "
                                 "launches")
        top = float(w.float().abs().max())
        if dtype == torch.float32:
            errs.append(check_close(f"{tag} {name}", x, w,
                                    torch.zeros_like(w), rtol=0.0,
                                    atol=1e-4 * top))
        else:
            errs.append(check_close(f"{tag} {name}", x, w, w.float().abs(),
                                    rtol=BF16_ULP, atol=1e-4 * top))
    row = dict(name="flash_attention_bwd", route="cuda",
               source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
               replaces="none: XLA differentiates src/repro/models/"
               "attention.py:81 (full_attention)",
               max_abs_err=max(errs), max_abs_err_dq_dk_dv=errs,
               shape=[b, sq, sk, h, kv, dh],
               dtype=str(dtype).split(".")[-1], bitwise_rerun=True, **kw)
    if dtype == torch.bfloat16:
        # the bf16 tensor-core passes the design runs (S and dP in both
        # kernels), beside the bound's 11
        row["passes_run"] = bwd_tiles(dh).passes
    del want, got, again
    if check_only:
        return row | {"check_only": check_only}
    if timed_at:
        row |= dict(timed_at=timed_at, launches_a_step=launches_a_step)
    masks = {key: kw[key] for key in kw if key != "logit_cap"}
    visible = visible_pairs(sq, sk, **masks)
    # The products the function needs, each 2·B·H·Dh·(visible pairs)
    # flops: S = QKᵀ again and dP = dO·Vᵀ, of bf16 operands (exact in
    # f32: one bf16 pass each), and dV = Pᵀ·dO, dK = dSᵀ·Q, dQ = dS·K,
    # whose f32 p and ds three bf16 pieces carry whole (three passes
    # each), as the forward's bound counts P·V: 11 passes on the
    # tensor cores.  The exps are not counted.
    assert dtype == torch.bfloat16, "the bound assumes bf16 operands"
    products = 2 * b * h * dh * visible
    b_ms, b_by = bound(q.element_size() * (3 * 2 * q.numel()
                                           + 2 * 2 * k.numel()),
                       (1 + 1 + 3 * 3) * products, BF16_FLOPS)
    lib = {}
    if not kw.get("logit_cap"):
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        if masks.get("window") or masks.get("prefix") or (
                masks.get("causal", True) and sq != sk):
            row_pos = torch.arange(sq, device=dev)[:, None] + (sk - sq)
            col = torch.arange(sk, device=dev)[None, :]
            mask = (col <= row_pos if masks.get("causal", True)
                    else col >= 0)
            if masks.get("window"):
                mask &= ((row_pos - col) < masks["window"]) | (
                    col < masks.get("prefix", 0))
            lib_kw, what = dict(attn_mask=mask), "a boolean attn_mask"
        elif masks.get("causal", True):
            lib_kw, what = dict(is_causal=True), "is_causal"
        else:
            lib_kw, what = {}, "no mask"
        sdpa_out = sdpa(qt, kt, vt, enable_gqa=True, **lib_kw)
        dot = do.transpose(1, 2)
        lib_call = lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dot,
                                               retain_graph=True)
        lib = dict(**library_times(lib_call),
                   library=f"backward of torch scaled_dot_product_attention"
                   f"({what}, enable_gqa)")
    else:
        lib = dict(library_ms=None, library="none: SDPA cannot softcap")
    return row | dict(
        ms=cuda_ms(call),
        device_ms=kernel_device_ms(call, ["flash_attention_bwd_"]),
        plain_ms=cuda_ms(plain, reps=3), bound_ms=b_ms, bound_by=b_by,
        visible_pairs=visible, **lib)


def flash_bwd_rows(dev, rng):
    """K11's backward at the tinyllama-1.1b train step (B = 2, S = 2,048,
    H = 32, KV = 4, Dh = 64, causal, bf16: the ``kernels`` line's row),
    checked in f32 there; in bf16 timed and in f32 checked at hymba-1.5b
    (S = 2,176, G = 5, window 1,024, prefix 128), internvl2-1b (S =
    2,304, G = 7), olmoe-1b-7b (G = 1, Dh = 128), gemma2-9b (G = 2, Dh =
    256, window 4,096, softcap 50), whisper-large-v3's encoder (1,500
    frames, no causal mask) and its teacher-forced cross-attention (Sq =
    448 against 1,500 frames, no causal mask); and ragged edges in both
    dtypes: Sq < Sk with a window and prefix, Dh = 36, G = 128, Dh = 160
    with G = 7 (``check_only``); hymba-1.5b's context-parallel shapes
    (``hymba_cp_rows``)."""
    from repro_torch.configs import get_config

    f32, bf16 = torch.float32, torch.bfloat16
    rows = [flash_bwd_row(dev, rng, 2, 2048, 2048, 32, 4, 64, bf16,
                          causal=True),
            flash_bwd_row(dev, rng, 2, 2048, 2048, 32, 4, 64, f32,
                          causal=True, check_only="tinyllama, f32")]
    whisper = get_config("whisper-large-v3")
    for arch, n, shape, kw in (
            ("hymba-1.5b", None, (2, 2176, 2176, 25, 5, 64),
             dict(causal=True, window=1024, prefix=128)),
            ("internvl2-1b", None, (2, 2304, 2304, 14, 2, 64),
             dict(causal=True)),
            ("olmoe-1b-7b", None, (2, 2048, 2048, 16, 16, 128),
             dict(causal=True)),
            # gemma2's local layers (its global ones see 2,048 keys too)
            ("gemma2-9b", None, (2, 2048, 2048, 16, 8, 256),
             dict(causal=True, window=4096, logit_cap=50.0)),
            ("whisper-large-v3 encoder", whisper.enc_layers,
             (2, 1500, 1500, 20, 20, 64), dict(causal=False)),
            ("whisper-large-v3 cross-attention", whisper.n_layers,
             (2, 448, 1500, 20, 20, 64), dict(causal=False))):
        n = get_config(arch).n_layers if n is None else n
        rows.append(flash_bwd_row(dev, rng, *shape, bf16, timed_at=arch,
                                  launches_a_step=n, **kw))
        rows.append(flash_bwd_row(dev, rng, *shape, f32,
                                  check_only=f"{arch}, f32", **kw))
    for dtype in (f32, bf16):
        tag = str(dtype).split(".")[-1]
        rows += [
            flash_bwd_row(dev, rng, 2, 100, 700, 6, 3, 32, dtype,
                          causal=True, window=200, prefix=16,
                          check_only=f"Sq<Sk, {tag}"),
            flash_bwd_row(dev, rng, 2, 300, 300, 4, 2, 36, dtype,
                          causal=True, window=100,
                          check_only=f"Dh=36, {tag}"),
            flash_bwd_row(dev, rng, 1, 64, 64, 128, 1, 64, dtype,
                          causal=True, check_only=f"G=128, {tag}"),
            flash_bwd_row(dev, rng, 1, 257, 257, 7, 1, 160, dtype,
                          causal=True, logit_cap=20.0,
                          check_only=f"Dh=160, G=7, softcap, {tag}")]
    rows += hymba_cp_rows(dev, rng, flash_bwd_row)
    return rows


def ssd_work(b, s, h, p, n, chunk):
    """K12's work on (B, S, H, P) x, N states, chunks of ``chunk``: (the
    function's bytes: x and y, dt, A, B and C, the final state, f32; the
    flops of its products; its elementwise f32 ops a (b, h); the older
    count of the products, the K12 rows' ``old`` bound).  The products:
    per (b, h, chunk) the decayed lower triangle times dt·x, the state
    feed and the state update; C Bᵀ (no head axis) once per (b, chunk)."""
    head = cbt = elem = old = 0
    for c0 in range(0, s, chunk):
        ln = min(chunk, s - c0)
        tri = ln * (ln + 1) // 2
        head += 2 * tri * p + 2 * (2 * ln * n * p)
        cbt += 2 * tri * n
        elem += ln * p + 2 * p * n
        # the older count: C Bᵀ per head too, in nine bf16 passes
        old += 2 * tri * n + 2 * tri * p + 2 * ln * n * p + 2 * ln * p * n
    nbytes = 4 * (2 * b * s * h * p + b * s * h + h + 2 * b * s * n
                  + b * h * p * n)
    return nbytes, b * h * head + b * cbt, elem, old


def ssd_row(dev, rng, b, s, h, p, n, chunk, check_only=None,
            timed_at=None, path=None):
    """K12 on tests/test_kernels.py's input distribution (x, B, C unit
    normal, dt = |N(0.1, 0.05)|, A = -|N(1, 0.3)|) against its plain
    version ``ssd_chunked``: y and the final state within 1e-5·(1 +
    max|plain|) (f32 sums in other orders).  No single PyTorch call
    computes the scan: no library yardstick.  Timed rows give the device
    time of every launch of one call (the kernels named ``ssd_scan_*``)
    and of each, the function's bound (its products on tf32 tensor cores
    in three passes), PR 16's count of it, the time of the f32 FMAs the
    kernel does at the CUDA cores' rate, and the bytes the design moves."""
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda

    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    x = f(rng.normal(size=(b, s, h, p)))
    dt = f(np.abs(rng.normal(0.1, 0.05, size=(b, s, h))))
    A = f(-np.abs(rng.normal(1, 0.3, size=(h,))))
    Bm, Cm = f(rng.normal(size=(b, s, n))), f(rng.normal(size=(b, s, n)))
    call = lambda: ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=chunk)
    plain = lambda: ssd_ref.ssd_scan(x, dt, A, Bm, Cm, chunk)
    (y, fs), (wy, wfs) = call(), plain()
    torch.cuda.synchronize()
    err = max(check_close("ssd_scan y", y, wy, torch.full_like(
                  wy, float(wy.abs().max())), rtol=1e-5, atol=1e-5),
              check_close("ssd_scan state", fs, wfs, torch.full_like(
                  wfs, float(wfs.abs().max())), rtol=1e-5, atol=1e-5))
    row = dict(name="ssd_scan", route="cuda",
               source="src/repro_torch/kernels/csrc/ssd_scan.cu",
               replaces="src/repro/kernels/ssd_scan/kernel.py:79",
               max_abs_err=err, max_abs_y=float(wy.abs().max()),
               shape=[b, s, h, p, n, chunk])
    if check_only:
        return row | {"check_only": check_only}
    if timed_at:
        row["timed_at"] = timed_at
    if path:
        row["path"] = path
    # The products the function needs: per (b, h, chunk) the decayed
    # lower triangle times dt·x, the state feed and the state update; C Bᵀ
    # (no head axis) once per (b, chunk).  bound_ms charges them on tf32
    # tensor cores in three passes (3xTF32, enough for f32 operands); the
    # kernel does them as f32 FMAs in the plain version's order, whose
    # time at the CUDA cores' 67 TFLOP/s is f32_fma_ms.  dt·x and the
    # state decay are elementwise f32.  The exps are not counted.
    nbytes, flops, elem, old = ssd_work(b, s, h, p, n, chunk)
    b_ms, b_by = bound(nbytes, [(3 * flops, TF32_FLOPS),
                                (b * h * elem, F32_FLOPS)])
    fma_ms, _ = bound(nbytes, [(flops, F32_FLOPS), (b * h * elem, F32_FLOPS)])
    old_ms, _ = bound(nbytes, [(9 * b * h * old, BF16_FLOPS),
                               (b * h * elem, F32_FLOPS)])
    # What the design moves through device memory besides the function's
    # bytes (L2 reads counted as device memory): x staged twice; B staged
    # by every head; (C Bᵀ)ᵀ and Cᵀ (lp × lp and N × lp a chunk) written
    # once and staged by every head; each head's dt and cum written and
    # read once; the state after each chunk but the last written once and
    # read once by the next chunk.
    nc, lp = -(-s // chunk), -(-chunk // 16) * 16
    moved = (nbytes + 4 * x.numel() + 4 * (h - 1) * Bm.numel()
             + 4 * b * nc * (h + 1) * (lp + n) * lp
             + 2 * 2 * 4 * b * nc * lp * h
             + 2 * 4 * b * (nc - 1) * h * p * n)
    per_name = profile_device(call)[0]
    phases = {re.search(r"ssd_scan_\w+?_kernel", k).group(0): t
              for k, t in per_name.items() if "ssd_scan_" in k}
    if not phases:
        raise AssertionError(f"ssd_scan: the profiler saw none of its "
                             f"kernels: {sorted(per_name)}")
    return row | dict(
        ms=cuda_ms(call), device_ms=sum(phases.values()), phase_ms=phases,
        plain_ms=cuda_ms(plain, reps=5), bound_ms=b_ms, bound_by=b_by,
        bound_ms_pr16=old_ms, f32_fma_ms=fma_ms, flops=flops,
        bytes_moved=moved,
        bytes_moved_ms=moved / HBM_BYTES_PER_S * 1e3, library_ms=None,
        ctas=b * nc * h)


def llm_kernel_rows(dev, rng):
    """K11's rows (``flash_rows``), its backward's (``flash_bwd_rows``),
    then K12 at the mamba2-1.3b prefill
    (B = 2, S = 2,048, H = 64, P = 64, N = 128, L = 128), at hymba-1.5b's
    (S = 2,176: 17 chunks, H = 50, N = 16; timed, ``path``), at S = 1,000 (a
    padded last chunk), at a 37-token prompt (L = 37) and at the CPU
    tests' ragged P/N shapes (``check_only``), then K11's gradients and
    K12's refusal under grad (``grad_check``)."""
    rows = flash_rows(dev, rng) + flash_bwd_rows(
        dev, np.random.default_rng(SEED + 7)) + [
        ssd_row(dev, rng, 2, 2048, 64, 64, 128, 128),
        ssd_row(dev, rng, 2, 2176, 50, 64, 16, 128,
                path=("llm_hybrid", "ssd_scan")),
        ssd_row(dev, rng, 2, 1000, 64, 64, 128, 128, check_only="S=1000"),
        ssd_row(dev, rng, 2, 37, 64, 64, 128, 37, check_only="L=37"),
        ssd_row(dev, rng, 1, 64, 1, 8, 8, 16, check_only="P=8, N=8, L=16"),
        ssd_row(dev, rng, 2, 100, 3, 16, 16, 32,
                check_only="P=16, N=16, L=32"),
    ]
    grad_check(dev, rng)
    return rows

# ---------------------------------------------------------- pipeline phase

@functools.lru_cache(maxsize=None)
def dataset(name: str):
    """A paper dataset at its full spec (HI 100,000 × 32, YP 510,000 ×
    90), made from ``SEED`` once a run."""
    from repro_torch.data.synthetic import DATASETS, make_dataset
    return make_dataset(DATASETS[name], seed=SEED)


@functools.lru_cache(maxsize=None)
def partitions(name: str = "HI"):
    """A paper dataset's job at its full size, as
    ``data.table2.dataset_partitions`` builds it: 70/30 split, 3
    clients."""
    from repro_torch.data.table2 import dataset_partitions
    return dataset_partitions(name, seed=SEED, quick=False)


def fit_divergence(tr, dev, k: int = 14, tag: str = "HI"):
    """Where the kernel and plain-version coreset fits of the aligned
    clients of ``tr`` part: both start from the same k-means++ centroids and run Lloyd
    steps side by side; at the first step whose assignments differ,
    every differing row must be a near tie of the kernel's centroids.
    Where the steps agree, the final assignment pass (K5 against its
    plain version, each on its own side's centroids, which differ in
    the sums' last bits) must part only at near ties, and its distances
    agree within ``check_close``'s f32 bound: two rows whose order a
    coreset's weights or selection reads then swap only where their
    distances lie within that bound of each other.
    Also: two kernel fits give the same bits (no atomics)."""
    from repro_torch import rng
    from repro_torch.config import AlignOptions
    from repro_torch.core.kmeans import (kmeans_fit, kmeans_pp_init,
                                         lloyd_step, pad_masks)
    from repro_torch.core.treecss import _align
    from repro_torch.kernels.kmeans_assign.ops import kmeans_assign
    from repro_torch.kernels.padding import stack_padded

    aligned, *_ = _align(tr, "tree", seed=SEED, align=AlignOptions(
        protocol="oprf", psi_backend="device", device=dev))
    feats = aligned.client_features
    ns = [f.shape[0] for f in feats]
    pts = stack_padded([torch.from_numpy(f).to(dev) for f in feats],
                       max(ns), max(f.shape[1] for f in feats))
    keys = np.stack([rng.PRNGKey(SEED + 17 * i) for i in range(len(feats))])
    fits = [kmeans_fit(keys, pts, k, impl="kernel", n_valid=ns)
            for _ in range(2)]
    if not all(torch.equal(a, b) for a, b in zip(*fits)):
        raise AssertionError("two kernel fits differ")
    valid, n_pad = pad_masks(max(ns), ns, dev)
    ck = cr = kmeans_pp_init(keys, pts, k, ns)
    final = dict(final_assign_rows=None, final_sqd_bitwise=None,
                 final_sqd_max_abs_err=None)
    for it in range(25):
        nk, ak = lloyd_step(pts, ck, valid, n_pad, "kernel")
        nr, ar = lloyd_step(pts, cr, valid, n_pad, "ref")
        if not torch.equal(ak, ar):
            n_diff, n_bad, margin = near_tie_rows(pts, ck, ak, ar)
            out = dict(first_divergence_step=it, rows=n_diff,
                       beyond_near_tie=n_bad, min_margin=margin)
            break
        ck, cr = nk, nr
    else:
        ak, sk = kmeans_assign(pts, ck, impl="kernel")
        ar, sr = kmeans_assign(pts, cr, impl="ref")
        ar = torch.where(valid, ar, ak)          # padded rows are no one's
        n_diff, n_bad, margin = near_tie_rows(pts, ck, ak, ar)
        out = dict(first_divergence_step=None, rows=n_diff,
                   beyond_near_tie=n_bad, min_margin=margin)
        final = dict(final_assign_rows=n_diff,
                     final_sqd_bitwise=torch.equal(sk[valid], sr[valid]),
                     final_sqd_max_abs_err=check_close(
                         f"{tag} final sqd", sk[valid], sr[valid],
                         sqd_scale(pts, ck, ak)[valid]))
    out = {"phase": "fit_divergence", "dataset": tag, **out, **final}
    emit(out)
    if out["beyond_near_tie"]:
        raise AssertionError("kernel and plain fits part beyond a near tie")
    return out


def fits_part(divergence) -> bool:
    """Whether ``fit_divergence`` found the two fits apart anywhere: a
    Lloyd step's or the final pass's assignments, or the final
    distances' last bits."""
    return (divergence["first_divergence_step"] is not None
            or bool(divergence["rows"])
            or divergence["final_sqd_bitwise"] is False)


# the kernels of alignment (K6, K7) and of the coreset fit (K3, K5)
VFL_PATH = ("psi_prf", "sorted_intersect", "kmeans_update", "kmeans_assign")


def pipeline_phase(dev):
    from repro_torch.config import AlignOptions, EngineOptions
    from repro_torch.core.splitnn import SplitNNConfig
    from repro_torch.core.treecss import run_pipeline
    from repro_torch.kernels.build import LAUNCHES, reset_launches

    tr, te = partitions()
    drive = lambda variant, impl: run_pipeline(
        tr, te, SplitNNConfig(model="knn", n_classes=2), variant=variant,
        clusters_per_client=14, kmeans_impl=impl, seed=SEED, knn_k=5,
        options=EngineOptions(device=dev),
        align=AlignOptions(protocol="oprf", psi_backend="device", impl=impl))
    # one untimed drive first: lazy CUDA module loading and cuBLAS set-up
    # would otherwise land in the first timed run's stage walls
    drive("treecss", "kernel")
    runs = {}
    for variant in ("treecss", "starall"):
        for impl in ("kernel", "ref"):
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep = drive(variant, impl)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(LAUNCHES)
            row = dict(phase="pipeline", variant=variant, impl=impl,
                       n_align=int(rep.mpsi.intersection.shape[0]),
                       n_train=rep.n_train, metric=rep.metric,
                       rounds=rep.mpsi.rounds,
                       comm_bytes=rep.mpsi.total_bytes,
                       dispatches=rep.mpsi.device_dispatches,
                       align_wall_s=rep.align_wall_seconds,
                       coreset_wall_s=rep.coreset_wall_seconds,
                       knn_wall_s=rep.train_wall_seconds,
                       total_wall_s=wall, launches=launches)
            emit(row)
            runs[variant, impl] = (rep, row)

    # the fits may part at a near tie of two f32 summation orders;
    # anything else is a fault (fit_divergence raises)
    divergence = fit_divergence(tr, dev)
    for variant in ("treecss", "starall"):
        (rk, row_k), (rr, row_r) = runs[variant, "kernel"], runs[variant,
                                                                 "ref"]
        if not np.array_equal(rk.mpsi.intersection, rr.mpsi.intersection):
            raise AssertionError(f"{variant}: intersections differ")
        for f in ("rounds", "total_bytes", "total_messages", "schedule",
                  "device_dispatches"):
            if getattr(rk.mpsi, f) != getattr(rr.mpsi, f):
                raise AssertionError(f"{variant}: MPSIStats.{f} differs")
        if (rk.coreset is not None and not np.array_equal(
                rk.coreset.indices, rr.coreset.indices)
                and divergence["first_divergence_step"] is None):
            raise AssertionError(f"{variant}: coreset indices differ")
        if abs(rk.metric - rr.metric) > 0.002:
            raise AssertionError(f"{variant}: accuracy {rk.metric} vs "
                                 f"{rr.metric}")
        if any(row_r["launches"].values()):
            raise AssertionError(f"{variant}: impl='ref' launched kernels")
        if not 0.5 < rk.metric <= 1.0 or rk.n_train <= 0:
            raise AssertionError(f"{variant}: implausible result")
    on_path = {"treecss": VFL_PATH, "starall": VFL_PATH[:2]}
    for variant, names in on_path.items():
        launches = runs[variant, "kernel"][1]["launches"]
        missing = [k for k in names if launches[k] == 0]
        if missing:
            raise AssertionError(f"{variant}: kernels {missing} were not "
                                 "launched on the main path")
    rows = [r for _, r in runs.values()] + [divergence]
    return runs["treecss", "kernel"][1]["launches"], rows


# (variant, model, lr, max_epochs): the paper's 200-epoch cap for all
# three; starall × mlp (70 steps an epoch) stops at convergence well
# inside the script's time (PERF.md §4)
TRAIN_JOBS = (("treecss", "mlp", 0.01, 200), ("treecss", "lr", 0.05, 200),
              ("starall", "mlp", 0.01, 200))


def train_cfg(model, lr, n_rows, max_epochs, n_classes=2):
    """The paper's Table-2 SplitNN settings
    (``benchmarks/table2_framework.py``)."""
    from repro_torch.data.table2 import table2_config
    return table2_config(model, n_classes, lr, n_rows, max_epochs, SEED)


def drive_split(tr, te, dev, variant, cfg, impl, trace=None, quant=None,
                k=14):
    from repro_torch.config import AlignOptions, EngineOptions
    from repro_torch.core.treecss import run_pipeline
    return run_pipeline(
        tr, te, cfg, variant=variant, clusters_per_client=k,
        kmeans_impl=impl, seed=SEED,
        options=EngineOptions(device=dev, bottom_impl=impl, trace=trace,
                              quant=quant),
        align=AlignOptions(protocol="oprf", psi_backend="device", impl=impl))


def split_job(tr, te, dev, variant, model, lr, cfg, impl, quant=None, k=14,
              phase=None):
    """One traced ``run_pipeline`` (a SplitNN job, or k-NN's vote) with
    the launch counts set to 0 just before it and read just after:
    (report, JSON row)."""
    from repro_torch.kernels.build import LAUNCHES, reset_launches

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = drive_split(tr, te, dev, variant, cfg, impl, trace=True,
                      quant=quant, k=k)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = rep.train.steps
    row = dict(phase=phase or ("train" if quant is None else "quant"),
               variant=variant, model=model, impl=impl, quant=quant, k=k,
               max_epochs=cfg.max_epochs, batch_size=cfg.batch_size, lr=lr,
               n_align=int(rep.mpsi.intersection.shape[0]),
               n_train=rep.n_train, metric=rep.metric,
               epochs=rep.train.epochs, steps=steps,
               final_loss=rep.train.losses[-1] if steps else None,
               comm_bytes=rep.train.comm_bytes,
               gather_payload_bytes=rep.train.engine_stats
               .gather_payload_bytes if steps else None,
               align_wall_s=rep.align_wall_seconds,
               coreset_wall_s=rep.coreset_wall_seconds,
               train_wall_s=rep.train_wall_seconds,
               train_engine_s=rep.train.train_seconds,
               ms_per_step=(rep.train.train_seconds * 1e3 / steps
                            if steps else None),
               eval_wall_s=rep.tracer.total_seconds("pipeline.serve"),
               total_wall_s=wall, launches=dict(LAUNCHES))
    emit(row)
    return rep, row


def compare_jobs(tag, kernel_run, ref_run, n_classes=2, acc_tol=0.005):
    """A job's kernel run against its plain-version run: the same
    alignment, MPSIStats counters and n_train, steps and comm_bytes
    unless the convergence window stopped at another epoch (reported),
    the loss at the last common epoch within rtol 1e-3 (within 1e-3 of
    the first epoch's loss where the two coreset fits parted at a near
    tie, fit_divergence), accuracy within ``acc_tol`` and in
    (1 / n_classes, 1], no launch in the plain run."""
    (rk, row_k), (rr, row_r) = kernel_run, ref_run
    if not np.array_equal(rk.mpsi.intersection, rr.mpsi.intersection):
        raise AssertionError(f"{tag}: intersections differ")
    for f in ("rounds", "total_bytes", "total_messages", "schedule",
              "device_dispatches"):
        if getattr(rk.mpsi, f) != getattr(rr.mpsi, f):
            raise AssertionError(f"{tag}: MPSIStats.{f} differs")
    if rk.n_train != rr.n_train:
        raise AssertionError(f"{tag}: n_train {rk.n_train} vs {rr.n_train}")
    common = min(rk.train.epochs, rr.train.epochs)
    if rk.train.epochs == rr.train.epochs:
        if (rk.train.steps, rk.train.comm_bytes) != (
                rr.train.steps, rr.train.comm_bytes):
            raise AssertionError(f"{tag}: steps or comm_bytes differ")
    else:
        emit({"phase": "train_note", "job": tag,
              "epochs_kernel": rk.train.epochs,
              "epochs_ref": rr.train.epochs,
              "note": "the convergence window stopped at another epoch"})
    same_data = rk.coreset is None or (
        np.array_equal(rk.coreset.indices, rr.coreset.indices)
        and np.array_equal(rk.coreset.weights, rr.coreset.weights))
    row_k["same_train_data"] = same_data
    if common:
        lk, lr_ = rk.train.losses[common - 1], rr.train.losses[common - 1]
        lim = 1e-3 * (abs(lr_) if same_data else rr.train.losses[0])
        if abs(lk - lr_) > lim:
            raise AssertionError(f"{tag}: loss {lk} vs {lr_} at epoch "
                                 f"{common} (same train data: {same_data})")
    if abs(rk.metric - rr.metric) > acc_tol:
        raise AssertionError(f"{tag}: accuracy {rk.metric} vs {rr.metric}")
    if not 1 / n_classes < rk.metric <= 1.0:
        raise AssertionError(f"{tag}: implausible accuracy {rk.metric}")
    if any(row_r["launches"].values()):
        raise AssertionError(f"{tag}: the plain run launched kernels")


def check_launches(tag, launches, want):
    """Each named kernel launched exactly as often as ``want`` says."""
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{tag}: {name} launched {launches[name]} "
                                 f"times, expected {n}")


def train_phase(dev):
    """The SplitNN jobs at full HI, kernels against plain versions."""
    tr, te = partitions()
    n_eval_batches = -(-te.n_samples // 512)
    # untimed, both models: first use of autograd, of each model's
    # GEMM shapes and of pinned host memory would otherwise land in the
    # first timed run of that model
    for model in ("mlp", "lr"):
        drive_split(tr, te, dev, "treecss",
                    train_cfg(model, 0.01, tr.n_samples, 2), None)
    runs, rows = {}, []
    for variant, model, lr, epochs in TRAIN_JOBS:
        cfg = train_cfg(model, lr, tr.n_samples, epochs)
        for impl in ("kernel", "ref"):
            runs[variant, model, impl] = split_job(tr, te, dev, variant,
                                                   model, lr, cfg, impl)
            rows.append(runs[variant, model, impl][1])
    for variant, model, _, _ in TRAIN_JOBS:
        tag = f"{variant}/{model}"
        rk, row_k = runs[variant, model, "kernel"]
        compare_jobs(tag, runs[variant, model, "kernel"],
                     runs[variant, model, "ref"])
        check_launches(tag, row_k["launches"], {
            "splitnn_bottom_gather": rk.train.steps,
            "splitnn_bottom": n_eval_batches})
    return runs, rows


TABLE2_DATASETS = ("BA", "MU", "RI", "BP")
TABLE2_EPOCHS = 200            # the paper's cap; convergence stops most
TABLE2_KNN_ACC = 0.002         # RI × k-NN: kernel vs plain accuracy


def table2_phase(dev):
    """The paper's Table-2 jobs on BA, MU, RI and BP at full size
    (``data.table2.JOBS``): treecss with the kernels and with every
    plain version, compared as ``compare_jobs`` compares them; where the
    two coresets differ, ``fit_divergence`` must find the fits apart,
    and only at near ties (``fits_part``).  The
    kernel run launches K6, K7, K3 and K5, no K8 (P <= 2^18), K2 once a
    step and K1 once an eval block (none for k-NN), one dispatch and one
    host sync an epoch."""
    from repro_torch.data.table2 import JOBS

    # untimed: the first use of each dataset's GEMM shapes and of
    # autograd would otherwise land in the first job's stage walls
    tr, te = partitions("BA")
    drive_split(tr, te, dev, "treecss", train_cfg("mlp", 0.01, tr.n_samples,
                                                  2), None, k=12)
    rows, divergences = [], {}
    for ds, model, n_classes, lr, k in JOBS:
        if ds not in TABLE2_DATASETS:
            continue
        tag = f"table2 {ds}/{model}"
        tr, te = partitions(ds)
        cfg = train_cfg(model, lr, tr.n_samples, TABLE2_EPOCHS, n_classes)
        runs = {impl: split_job(tr, te, dev, "treecss", model, lr, cfg, impl,
                                k=k, phase="table2")
                for impl in ("kernel", "ref")}
        (rk, row_k), (rr, row_r) = runs["kernel"], runs["ref"]
        divergence = None
        if not (np.array_equal(rk.coreset.indices, rr.coreset.indices)
                and np.array_equal(rk.coreset.weights, rr.coreset.weights)):
            if (ds, k) not in divergences:
                divergences[ds, k] = fit_divergence(tr, dev, k=k, tag=ds)
            divergence = divergences[ds, k]
            if not fits_part(divergence):
                raise AssertionError(f"{tag}: coresets differ, the fits "
                                     "do not")
        compare_jobs(tag, runs["kernel"], runs["ref"], n_classes=n_classes,
                     acc_tol=TABLE2_KNN_ACC if model == "knn" else 0.005)
        bottom = {"splitnn_bottom_gather": 0, "splitnn_bottom": 0}
        if model != "knn":
            bottom = {"splitnn_bottom_gather": rk.train.steps,
                      "splitnn_bottom": -(-te.n_samples // 512)}
            for run in (rk, rr):
                st = run.train.engine_stats
                if not st.dispatches == st.host_syncs == run.train.epochs:
                    raise AssertionError(
                        f"{tag}: {st.dispatches} dispatches and "
                        f"{st.host_syncs} host syncs in "
                        f"{run.train.epochs} epochs")
        check_launches(tag, row_k["launches"],
                       bottom | {"sorted_intersect_tiled": 0})
        missing = [n for n in VFL_PATH if not row_k["launches"][n]]
        if missing:
            raise AssertionError(f"{tag}: kernels {missing} were not "
                                 "launched on the path")
        row = dict(phase="table2_job", job=f"{ds}/{model}", k=k,
                   n_classes=n_classes, n_train_rows=tr.n_samples,
                   n_test_rows=te.n_samples,
                   columns=[f.shape[1] for f in tr.client_features],
                   n_align=row_k["n_align"], n_train=rk.n_train,
                   batch_size=cfg.batch_size, epochs=rk.train.epochs,
                   epochs_ref=rr.train.epochs, steps=rk.train.steps,
                   metric=rk.metric, metric_ref=rr.metric,
                   same_train_data=row_k["same_train_data"],
                   fit_divergence=divergence,
                   **{key: row_k[key] for key in (
                       "align_wall_s", "coreset_wall_s", "train_wall_s",
                       "eval_wall_s", "total_wall_s")},
                   total_wall_s_ref=row_r["total_wall_s"],
                   launches={n: c for n, c in row_k["launches"].items()
                             if c})
        emit(row)
        rows += [row_k, row_r, row]
    return rows


def serve_scale(params, feats):
    """The K1 tolerance's scale for mlp outputs: each output's term
    magnitudes carried through the top layers, (|a|·|w1| + |b1|)·|w2| +
    |b2| with |a| = |x|·|w| + |b|."""
    p = {k: v.detach().double().abs().cpu() for k, v in params["top"].items()}
    acts = [torch.from_numpy(np.abs(f)).double() @ bp["w"].double().abs().cpu()
            + bp["b"].double().abs().cpu()
            for f, bp in zip(feats, params["bottoms"])]
    return (torch.cat(acts, 1) @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def wire_step(params, te, quant, dev):
    """One wire step of the mlp's activations, carried through its top
    layers: per client, the step of the coarsest exponent any wire block
    can get (that of the client's largest bottom activation over ``te``,
    or of ``relu(b)``, a zero row's); for fp8 the step at the top of its
    mantissa range (32·2^e).  Two roundings of one value on grids no
    coarser than that differ by at most one step, and ``|Δout| <= (Σ
    step·|w1|)·|w2|``."""
    from repro_torch.kernels.splitnn_bottom.ops import splitnn_bottom
    from repro_torch.quant import pow2, pow2_exponent
    from repro_torch.train.vfl import pack_slab, pack_slab_params

    fd = [f.shape[1] for f in te.client_features]
    packed = pack_slab_params(params, max(fd))
    slab = torch.from_numpy(pack_slab(te.client_features)).to(dev)
    with torch.no_grad():
        acts = splitnn_bottom(slab, packed["bw"], packed["bb"], True, "ref",
                              None, quant)
    amax = torch.maximum(acts.abs().amax((1, 2)),
                         torch.relu(packed["bb"]).amax(1))
    step = pow2(pow2_exponent(amax, quant)).double().cpu()
    if quant == "fp8":
        step = step * 32.0
    top = {k: v.detach().double().abs().cpu()
           for k, v in params["top"].items()}
    dh = step.repeat_interleave(packed["bw"].shape[2]) @ top["w1"]
    return dh @ top["w2"]


def serve_phase(dev, params, cfg, quant=None):
    """The test set as seeded requests through ``VFLScoringEngine``,
    kernel and plain engines, against ``score_partition``: within the K1
    tolerance in f32; under a quant each within one wire step of
    ``score_partition`` (R3: the engine's slots and score_partition's
    blocks put other rows in a wire block), and the two engines bitwise
    under int8 (an exact pass), within one wire step of each other under
    fp8 (cuBLAS and the kernel's FMA chain round the f32 pass apart, and
    a wire rounding may go the other way)."""
    from repro_torch.kernels.build import LAUNCHES, reset_launches
    from repro_torch.serve.vfl import VFLScoringEngine, score_partition

    _, te = partitions()
    feats = te.client_features
    want = torch.from_numpy(score_partition(params, cfg, te, block_b=512,
                                            quant=quant))
    g = np.random.default_rng(SEED + 2)
    bounds, s = [], 0
    while s < te.n_samples:
        e = min(s + int(g.integers(1, 257)), te.n_samples)
        bounds.append((s, e))
        s = e
    requests = [(rid, [f[a:b] for f in feats])
                for rid, (a, b) in enumerate(bounds)]
    out = {}
    for impl in ("kernel", "ref"):
        eng = VFLScoringEngine(params, cfg, slots=64, bottom_impl=impl,
                               quant=quant)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.score_requests(requests)
        wall = time.perf_counter() - t0
        got = torch.from_numpy(np.concatenate([res[r] for r in
                                               range(len(bounds))]))
        out[impl] = (eng.stats, dict(LAUNCHES), wall, got)
    scale = serve_scale(params, feats)
    step = 0.0 if quant is None else wire_step(params, te, quant, dev)
    rows = []
    for impl, (stats, launches, wall, got) in out.items():
        err = check_close(f"serve[{impl}, {quant}] vs score_partition", got,
                          want, scale, rtol=1e-5, atol=1e-6 + step)
        row = dict(phase="serve", impl=impl, quant=quant,
                   requests=len(bounds), rows=te.n_samples, wall_s=wall,
                   max_abs_err=err, stats=stats.to_dict(),
                   launches=launches)
        if quant is not None:
            row["wire_step_bound_max"] = float(step.max())
        emit(row)
        rows.append(row)
    (sk, lk, _, gk), (sr, _, _, gr) = out["kernel"], out["ref"]
    fields = sk.CONTRACT_FIELDS + ("quant",)
    if [getattr(sk, f) for f in fields] != [getattr(sr, f) for f in fields]:
        raise AssertionError("serve: ServeStats differ between engines")
    if quant == "int8" and not torch.equal(gk, gr):
        raise AssertionError(f"serve[{quant}]: the kernel and plain engines "
                             "differ")
    if quant == "fp8":
        emit({"phase": "serve_engines", "quant": quant,
              "max_abs_err_kernel_vs_plain": check_close(
                  "serve[fp8]: kernel vs plain engine", gk, gr, scale,
                  rtol=1e-5, atol=1e-6 + step)})
    k1 = {None: "splitnn_bottom", "int8": "splitnn_bottom_int8",
          "fp8": "splitnn_bottom_fp8"}[quant]
    if lk[k1] != sk.dispatches:
        raise AssertionError(f"serve: {k1} launched {lk[k1]} times in "
                             f"{sk.dispatches} dispatches")
    if any(out["ref"][1].values()):
        raise AssertionError("serve: the plain engine launched kernels")
    return rows


# (variant, model, lr, quants): the Table-2 jobs of the train phase under
# the quantized wire (``benchmarks/quant_vfl.py``'s sweep at full HI);
# starall × mlp trains on no coreset, so its kernel and plain runs see
# the same rows
QUANT_JOBS = (("treecss", "mlp", 0.01, ("int8", "fp8")),
              ("treecss", "lr", 0.05, ("int8", "fp8")),
              ("starall", "mlp", 0.01, ("int8",)))
MAX_INT8_ACC_DROP = 0.01       # benchmarks/quant_vfl.py's gate (int8)
MAX_PAYLOAD_RATIO = 0.3        # the quantized payload against f32's


def quant_phase(dev, f32_runs):
    """The SplitNN jobs at full HI with the int8 and fp8 wire, kernels
    against plain versions, each held against the f32 run of the same
    job (``f32_runs``, the train phase's): accuracy drop, payload ratio,
    and the launches of the path (int8: K10 every step, K9 every eval
    block, their wire form; fp8: K2 and K1 in their fp8 wire form, the
    f32 form never)."""
    tr, te = partitions()
    n_eval_batches = -(-te.n_samples // 512)
    for model in ("mlp", "lr"):              # untimed: first use of each
        for quant in ("int8", "fp8"):
            drive_split(tr, te, dev, "treecss", train_cfg(
                model, 0.01, tr.n_samples, 2), None, quant=quant)
    runs, rows = {}, []
    for variant, model, lr, quants in QUANT_JOBS:
        cfg = train_cfg(model, lr, tr.n_samples, 200)
        for quant in quants:
            for impl in ("kernel", "ref"):
                job = split_job(tr, te, dev, variant, model, lr, cfg, impl,
                                quant)
                runs[variant, model, quant, impl] = job
                rows.append(job[1])
    for variant, model, _, quants in QUANT_JOBS:
        f32, f32_row = f32_runs[variant, model, "kernel"]
        for quant in quants:
            tag = f"{variant}/{model}/{quant}"
            kernel_run = runs[variant, model, quant, "kernel"]
            rk, row_k = kernel_run
            rr, _ = runs[variant, model, quant, "ref"]
            compare_jobs(tag, kernel_run, runs[variant, model, quant, "ref"])
            if rk.coreset is None and rk.train.losses != rr.train.losses:
                raise AssertionError(f"{tag}: the kernel and plain runs "
                                     "trained on the same rows, but their "
                                     "losses differ")
            if not np.array_equal(rk.mpsi.intersection,
                                  f32.mpsi.intersection):
                raise AssertionError(f"{tag}: alignment differs from f32")
            drop = f32.metric - rk.metric
            ratio = (rk.train.engine_stats.gather_payload_bytes
                     / f32.train.engine_stats.gather_payload_bytes)
            row_k.update(f32_metric=f32.metric, acc_drop=drop,
                         payload_ratio=ratio,
                         comm_ratio=rk.train.comm_bytes / f32.train.comm_bytes,
                         f32_ms_per_step=f32_row["ms_per_step"])
            emit({"phase": "quant_vs_f32", "job": tag, "f32": f32.metric,
                  "quant": rk.metric, "acc_drop": drop,
                  "payload_ratio": ratio, "comm_ratio": row_k["comm_ratio"]})
            if quant == "int8" and drop > MAX_INT8_ACC_DROP:
                raise AssertionError(f"{tag}: accuracy {rk.metric} drops "
                                     f"{drop} below f32's {f32.metric}")
            if ratio > MAX_PAYLOAD_RATIO:
                raise AssertionError(f"{tag}: payload ratio {ratio}")
            int8 = quant == "int8"
            check_launches(tag, row_k["launches"], {
                "splitnn_bottom_int8_gather": rk.train.steps if int8 else 0,
                "splitnn_bottom_int8": n_eval_batches if int8 else 0,
                "splitnn_bottom_fp8_gather": 0 if int8 else rk.train.steps,
                "splitnn_bottom_fp8": 0 if int8 else n_eval_batches,
                "splitnn_bottom_int8_operands": 0,
                "splitnn_bottom_int8_gather_operands": 0,
                "splitnn_bottom_gather": 0, "splitnn_bottom": 0})
    return runs, rows


def profile_phase(dev):
    """Where the time of one full-HI treecss run goes: the obs spans of a
    traced run (host wall per stage), then, under torch.profiler, the
    device time and the top device ops; k-NN, mlp, and mlp under the
    int8 wire (with a cProfile of its host time) and the fp8 wire."""
    from repro_torch.config import AlignOptions, EngineOptions
    from repro_torch.core.splitnn import SplitNNConfig
    from repro_torch.core.treecss import run_pipeline

    tr, te = partitions()
    run = lambda trace=None: run_pipeline(
        tr, te, SplitNNConfig(model="knn", n_classes=2), variant="treecss",
        clusters_per_client=14, seed=SEED,
        options=EngineOptions(device=dev, trace=trace),
        align=AlignOptions(protocol="oprf", psi_backend="device"))
    cfg = train_cfg("mlp", 0.01, tr.n_samples, 200)
    mlp = lambda trace=None: drive_split(tr, te, dev, "treecss", cfg, None,
                                         trace)
    mlp_int8 = lambda trace=None: drive_split(tr, te, dev, "treecss", cfg,
                                              None, trace, quant="int8")
    mlp_fp8 = lambda trace=None: drive_split(tr, te, dev, "treecss", cfg,
                                             None, trace, quant="fp8")
    rows = []
    for model, fn in (("knn", run), ("mlp", mlp), ("mlp/int8", mlp_int8),
                      ("mlp/fp8", mlp_fp8)):
        tracer = fn(trace=True).tracer
        spans = {}
        for sp in tracer.finished():
            spans[sp.name] = spans.get(sp.name, 0.0) + sp.duration * 1e3
        per_name, device_ms, wall_ms = profile_device(fn, reps=1)
        top = sorted(per_name.items(), key=lambda kv: -kv[1])[:10]
        row = {"phase": "profile", "variant": "treecss", "model": model,
               "span_ms": spans, "wall_ms_profiled": wall_ms,
               "device_ms": device_ms,
               "device_busy_share": None if device_ms is None else
               device_ms / wall_ms, "top_device_ops_ms": top}
        if model == "mlp/int8":
            row["host_profile"] = host_profile(fn)
        emit(row)
        rows.append(row)
    return rows


def span_ms(tracer):
    """Total ms per span name of a traced run."""
    out = {}
    for sp in tracer.finished():
        out[sp.name] = out.get(sp.name, 0.0) + sp.duration * 1e3
    return out


def yp_config(n_rows: int):
    """The paper's Table-2 linreg settings for YP
    (``benchmarks/table2_framework.py``): lr 0.05, batches of
    max(8, n // 100) rows, the 200-epoch cap or convergence."""
    from repro_torch.core.splitnn import SplitNNConfig
    return SplitNNConfig(model="linreg", n_classes=0, lr=0.05,
                         batch_size=max(8, n_rows // 100), max_epochs=200,
                         seed=SEED)


def yp_phase(dev):
    """Table-2 YP × linreg ``treecss`` at the paper's full size (357,000
    train / 153,000 test rows, 3 clients × 30 columns, k=12, OPRF on the
    device), with the kernels and with every plain version, then one
    profiled kernel run.  Every Tree-MPSI pair pads to P = 2^19, past the
    reference's single-pass bound, so each round's merge is K8."""
    from repro_torch.config import AlignOptions, EngineOptions
    from repro_torch.core.treecss import run_pipeline
    from repro_torch.kernels.build import LAUNCHES, reset_launches
    from repro_torch.kernels.sorted_intersect.kernel import SINGLE_PASS_MAX_P
    from repro_torch.kernels.sorted_intersect.ops import next_pow2

    tr, te = partitions("YP")
    cfg = yp_config(tr.n_samples)
    drive = lambda impl, trace=True: run_pipeline(
        tr, te, cfg, variant="treecss", clusters_per_client=12,
        kmeans_impl=impl, seed=SEED,
        options=EngineOptions(device=dev, bottom_impl=impl, trace=trace),
        align=AlignOptions(protocol="oprf", psi_backend="device", impl=impl))
    runs, rows = {}, []
    for impl in ("kernel", "ref"):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = drive(impl)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        row = dict(phase="yp", variant="treecss", model="linreg", impl=impl,
                   n_align=int(rep.mpsi.intersection.shape[0]),
                   n_train=rep.n_train, mse=rep.metric,
                   rounds=rep.mpsi.rounds, comm_bytes=rep.mpsi.total_bytes,
                   dispatches=rep.mpsi.device_dispatches,
                   epochs=rep.train.epochs, steps=rep.train.steps,
                   batch_size=cfg.batch_size,
                   ms_per_step=rep.train.train_seconds * 1e3
                   / max(rep.train.steps, 1),
                   align_wall_s=rep.align_wall_seconds,
                   coreset_wall_s=rep.coreset_wall_seconds,
                   train_wall_s=rep.train_wall_seconds,
                   eval_wall_s=rep.tracer.total_seconds("pipeline.serve"),
                   total_wall_s=wall, launches=dict(LAUNCHES),
                   span_ms=span_ms(rep.tracer))
        emit(row)
        runs[impl] = (rep, row)
        rows.append(row)
    (rk, row_k), (rr, row_r) = runs["kernel"], runs["ref"]
    # each client holds the train rows' ids, 70% of them common: 249,900
    if row_k["n_align"] != round(tr.n_samples * 0.7):
        raise AssertionError(f"yp: {row_k['n_align']} ids aligned, "
                             f"expected {round(tr.n_samples * 0.7)}")
    if not np.array_equal(rk.mpsi.intersection, rr.mpsi.intersection):
        raise AssertionError("yp: intersections differ")
    for f in ("rounds", "total_bytes", "total_messages", "schedule",
              "device_dispatches"):
        if getattr(rk.mpsi, f) != getattr(rr.mpsi, f):
            raise AssertionError(f"yp: MPSIStats.{f} differs")
    # every round pads to P = next_pow2(357,000) = 2^19: one K8 launch a
    # round and no K7 (at a size under the bound it would be all K7)
    launched = row_k["launches"]
    merges = {"sorted_intersect": 0, "sorted_intersect_tiled": 0}
    merges["sorted_intersect_tiled" if next_pow2(tr.n_samples)
           > SINGLE_PASS_MAX_P else "sorted_intersect"] = rk.mpsi.rounds
    if {k: launched[k] for k in merges} != merges:
        raise AssertionError(f"yp: merge launches {launched}, expected "
                             f"{merges} in {rk.mpsi.rounds} rounds")
    # every kernel of the f32 path runs; K4 (minibatch coresets), K1/K2's
    # fp8 wire form and the int8 twins K9/K10 (the quantized wires; their
    # operands form, on no path), K11/K12 (LLM serving) and K11's backward
    # (LLM training) have paths of their own
    missing = [k for k, v in launched.items() if not v
               and k not in (*merges, "kmeans_update_gather",
                             "splitnn_bottom_fp8",
                             "splitnn_bottom_fp8_gather",
                             "splitnn_bottom_int8",
                             "splitnn_bottom_int8_gather",
                             "splitnn_bottom_int8_operands",
                             "splitnn_bottom_int8_gather_operands",
                             "flash_attention", "flash_attention_bwd",
                             "ssd_scan")]
    if missing:
        raise AssertionError(f"yp: kernels {missing} were not launched")
    if any(row_r["launches"].values()):
        raise AssertionError("yp: the plain run launched kernels")
    divergence = fit_divergence(tr, dev, k=12, tag="YP")
    same_data = (np.array_equal(rk.coreset.indices, rr.coreset.indices)
                 and np.array_equal(rk.coreset.weights, rr.coreset.weights))
    if not same_data and divergence["first_divergence_step"] is None:
        raise AssertionError("yp: coresets differ with no fit divergence")
    # rtol 1e-2 on the same training data (f32 GEMM orders, and the
    # convergence window may stop at another epoch); 5e-2 where the two
    # coreset fits parted at a near tie and the runs train on other rows
    rtol = 1e-2 if same_data else 5e-2
    row_k["same_train_data"] = same_data
    if not (np.isfinite(rk.metric) and rk.metric > 0
            and abs(rk.metric - rr.metric) <= rtol * abs(rr.metric)):
        raise AssertionError(f"yp: MSE {rk.metric} vs {rr.metric} "
                             f"(rtol {rtol}, same train data {same_data})")
    per_name, device_ms, wall_ms = profile_device(
        lambda: drive("kernel", None), reps=1, warm=False)
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:10]
    prof = {"phase": "profile", "variant": "treecss", "model": "linreg",
            "dataset": "YP", "wall_ms_profiled": wall_ms,
            "device_ms": device_ms,
            "device_busy_share": None if device_ms is None else
            device_ms / wall_ms, "top_device_ops_ms": top,
            "host": host_profile(lambda: drive("kernel", None))}
    emit(prof)
    # a record: each merge round's dispatch (PRF, sort, K8 and the copies
    # back; the traced kernel run's ``align.dispatch`` spans of kind
    # "single") beside the K8 launches' device time in the profiled run
    merge = {"phase": "yp_merge", "single_dispatch_ms": [
        sp.duration * 1e3 for sp in rk.tracer.finished()
        if sp.name == "align.dispatch" and sp.attrs.get("kind") == "single"],
        "k8_launches": launched["sorted_intersect_tiled"],
        "k8_device_ms_in_run": sum(t for k, t in per_name.items()
                            if any(m in k for m in MERGE_MARKS)),
        "dispatch_ops_device_ms": {
            k: t for k, t in per_name.items() if any(
                m in k.lower() for m in ("merge_path_kernel", "prf_kernel",
                                         "sort", "memcpy", "gather"))}}
    emit(merge)
    return row_k["launches"], rows + [divergence, prof, merge]


def minibatch_phase(dev):
    """``benchmarks/beyond_minibatch.py``'s YP job at full size: the
    coreset built with Lloyd and with the minibatch fit (after one warm
    call each) on the 357,000-row train partition, linreg trained on it
    with its weights and evaluated on the 153,000 test rows; then the
    build alone at 510,000 rows (``_build_time_at_scale``).  Kernels and
    plain versions."""
    from repro_torch import rng
    from repro_torch.config import EngineOptions
    from repro_torch.core.coreset import cluster_coreset
    from repro_torch.core.kmeans import kmeans_minibatch_fit
    from repro_torch.core.splitnn import evaluate, train_splitnn
    from repro_torch.data.vertical import partition_features
    from repro_torch.kernels.build import LAUNCHES, reset_launches

    tr, te = partitions("YP")
    cfg = yp_config(tr.n_samples)
    full = partition_features(*dataset("YP"), 3)
    rows, on_path = [], None
    for scale, part in (("train", tr), ("n=510000", full)):
        for impl in ("kernel", "ref"):
            for algo in ("lloyd", "minibatch"):
                css = lambda p: cluster_coreset(
                    p, 12, seed=SEED, kmeans_algo=algo, kmeans_impl=impl,
                    device=dev)
                css(part if scale == "train" else part.take(np.arange(2048)))
                reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = css(part)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launched = dict(LAUNCHES)
                row = dict(phase="minibatch", rows=part.n_samples, impl=impl,
                           algo=algo, coreset=int(res.indices.shape[0]),
                           build_wall_s=wall,
                           build_makespan_s=res.makespan_seconds,
                           fit_s=list(res.per_client_seconds),
                           select_s=res.select_seconds, launches=launched)
                if scale == "train":
                    t0 = time.perf_counter()
                    rep = train_splitnn(
                        tr.take(res.indices), cfg, sample_weights=res.weights,
                        options=EngineOptions(device=dev, bottom_impl=impl))
                    row.update(train_wall_s=time.perf_counter() - t0,
                               epochs=rep.epochs, steps=rep.steps,
                               mse=evaluate(rep.params, cfg, te,
                                            bottom_impl=impl))
                    if not (np.isfinite(row["mse"]) and row["mse"] > 0):
                        raise AssertionError(f"minibatch: MSE {row['mse']}")
                emit(row)
                rows.append(row)
                want = {"kmeans_update_gather": 0, "kmeans_update": 0}
                if impl == "kernel":
                    want[{"lloyd": "kmeans_update",
                          "minibatch": "kmeans_update_gather"}[algo]] = (
                        25 * (1 if algo == "lloyd" else part.n_clients))
                got = {k: launched[k] for k in want}
                if got != want:
                    raise AssertionError(f"minibatch {algo}/{impl} at "
                                         f"{part.n_samples} rows: launches "
                                         f"{got}, expected {want}")
                if impl == "ref" and any(launched.values()):
                    raise AssertionError("minibatch: the plain run launched "
                                         "kernels")
                if (scale, impl, algo) == ("train", "kernel", "minibatch"):
                    on_path = launched
    pts = torch.from_numpy(tr.client_features[0]).to(dev)
    fits = [kmeans_minibatch_fit(rng.PRNGKey(SEED), pts, 12, impl="kernel")
            for _ in range(2)]
    if not all(torch.equal(a, b) for a, b in zip(*fits)):
        raise AssertionError("minibatch: two kernel fits differ")
    return on_path, rows


def delta_phase(dev):
    """``benchmarks/fig7_delta_psi.py``'s device sweep at full size: m = 4
    parties of N = 300,000 ids, overlap 0.7, ``max_runs=3``, no HE, Δ/N
    in {0.001, 0.01, 0.1}, one untimed delta and 6 timed ones each, OPRF
    on the device.  The aligned set must equal the parties' plain
    intersection after every delta and a full Tree-MPSI re-run at the
    end; the probes and compactions pad to P = 2^19, so K8 runs."""
    from functools import reduce

    from repro_torch.config import AlignOptions
    from repro_torch.core.mpsi import tree_mpsi
    from repro_torch.data.synthetic import make_id_universe
    from repro_torch.kernels.build import LAUNCHES, reset_launches
    from repro_torch.kernels.sorted_intersect.kernel import SINGLE_PASS_MAX_P
    from repro_torch.kernels.sorted_intersect.ops import next_pow2
    from repro_torch.psi import DeltaMPSI

    n, m_parties, deltas = DELTA_N, 4, 6
    opts = AlignOptions(protocol="oprf", psi_backend="device",
                        impl="kernel", device=dev)
    merge = ("sorted_intersect_tiled" if next_pow2(n) > SINGLE_PASS_MAX_P
             else "sorted_intersect")
    rows, per_delta = [], {}
    reset_launches()

    def expect(dm, where):
        want = reduce(np.intersect1d, [dm.party_set(q)
                                       for q in range(dm.n_parties)])
        if not np.array_equal(dm.aligned, want):
            raise AssertionError(f"delta: aligned set broke {where}")

    for frac in (0.001, 0.01, 0.1):
        sets, _ = make_id_universe(m_parties, n, 0.7,
                                   seed=int(frac * 10_000))
        t0 = time.perf_counter()
        dm = DeltaMPSI(sets, options=opts, use_he=False, max_runs=3)
        boot_wall = time.perf_counter() - t0
        expect(dm, f"at bootstrap (frac {frac})")
        d = max(2, int(n * frac))
        fresh = int(max(s.max() for s in sets)) + 1
        g = np.random.default_rng(int(frac * 10_000) + 1)
        dm.apply_delta(0, joins=np.arange(fresh, fresh + d // 2,
                                          dtype=np.int64))
        fresh += d // 2
        expect(dm, f"after the untimed delta (frac {frac})")
        d_bytes, d_wall, d_merges = [], [], []
        for k in range(deltas):
            party = k % m_parties
            cur = dm.party_set(party)
            joins = np.arange(fresh, fresh + d // 2, dtype=np.int64)
            fresh += d // 2
            leaves = g.choice(cur, size=d - d // 2, replace=False)
            b0, m0 = dm.stats.total_bytes, LAUNCHES[merge]
            t0 = time.perf_counter()
            dm.apply_delta(party, joins, leaves)
            d_wall.append(time.perf_counter() - t0)
            d_bytes.append(dm.stats.total_bytes - b0)
            d_merges.append(LAUNCHES[merge] - m0)
            expect(dm, f"at frac {frac} step {k}")
        per_delta[frac] = d_merges
        host = None
        if frac == 0.01:        # where one more delta's host time goes
            cur = dm.party_set(1)
            joins = np.arange(fresh, fresh + d // 2, dtype=np.int64)
            fresh += d // 2
            leaves = g.choice(cur, size=d - d // 2, replace=False)
            host = host_profile(lambda: dm.apply_delta(1, joins, leaves))
            expect(dm, "after the profiled delta")
        t0 = time.perf_counter()
        full = tree_mpsi([dm.party_set(q) for q in range(m_parties)],
                         use_he=False, options=opts)
        full_wall = time.perf_counter() - t0
        if not np.array_equal(np.asarray(full.intersection), dm.aligned):
            raise AssertionError(f"delta: full re-run differs (frac {frac})")
        row = dict(phase="delta", n=n, m=m_parties, delta_frac=frac,
                   delta_size=d, deltas=deltas,
                   delta_wall_s=float(np.median(d_wall)),
                   full_wall_s=full_wall, bootstrap_wall_s=boot_wall,
                   delta_bytes=float(np.median(d_bytes)),
                   full_bytes=full.total_bytes,
                   bytes_speedup=full.total_bytes / float(np.median(d_bytes)),
                   wall_speedup=full_wall / float(np.median(d_wall)),
                   compactions=dm.stats.compactions,
                   dispatches=dm.stats.device_dispatches, host=host)
        emit(row)
        rows.append(row)
    launched = dict(LAUNCHES)
    # a record: the merge launches of each timed delta, by Δ/N
    emit({"phase": "delta_launches", "launches": launched,
          f"{merge}_per_delta": {str(f): v for f, v in per_delta.items()}})
    if not launched[merge]:
        raise AssertionError(f"delta: {merge} never launched")
    return rows


# ------------------------------------------------------------ LLM serving

LLM_BATCH, LLM_PROMPT, LLM_NEW = 2, 2048, 32
AUDIO_PROMPT = 4               # whisper's decoder prompt (the source caps at 448)
LLM_F32_RTOL = 1e-3            # kernel vs plain, f32 model, × (1 + max|logits|)
# a route of the f32 moe model may differ between the kernel and plain
# runs only where the plain run's margin (a token's k-th minus (k+1)-th
# probability, or an expert's C-th minus (C+1)-th gate) is at most this
MOE_TIE = 1e-5
# (phase, config) of every LLM path, in the order they run
LLM_PHASES = (("llm_dense", "tinyllama-1.1b"), ("llm_ssm", "mamba2-1.3b"),
              ("llm_hybrid", "hymba-1.5b"), ("llm_moe", "olmoe-1b-7b"),
              ("llm_vlm", "internvl2-1b"), ("llm_audio", "whisper-large-v3"))


def llm_batch(cfg, dev):
    """The seeded numpy inputs of a path: 2 prompts (2,048 tokens, 4 for
    the audio decoder), the vlm's stub patch embeddings (2, 256, D) and
    audio's stub frame embeddings (2, 1,500, D)."""
    rng = np.random.default_rng(SEED)
    n = AUDIO_PROMPT if cfg.family == "audio" else LLM_PROMPT
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (LLM_BATCH, n)).astype(np.int32)).to(dev)}
    extra = {"vlm": ("patches", cfg.vision_tokens),
             "audio": ("frames", cfg.enc_seq)}.get(cfg.family)
    if extra:
        batch[extra[0]] = torch.from_numpy(rng.normal(size=(
            LLM_BATCH, extra[1], cfg.d_model)).astype(np.float32)).to(dev)
    return batch


def extra_of(cfg, batch):
    """``greedy_decode``'s ``extra_embeds``: patches or frames."""
    return batch.get("patches", batch.get("frames"))


def path_launches(cfg, n_prompt, n_new):
    """The kernel launches one ``greedy_decode`` makes: K11 once per
    attention layer of the prefill, K12 once per Mamba2 mixer; audio's K11
    once per encoder layer and per decoder layer of every decode step
    (the prompt's and the new tokens')."""
    if cfg.family == "audio":
        return {"flash_attention": cfg.enc_layers
                + cfg.n_layers * (n_prompt + n_new)}
    out = {}
    if cfg.family != "ssm":
        out["flash_attention"] = cfg.n_layers
    if cfg.family in ("ssm", "hybrid"):
        out["ssd_scan"] = cfg.n_layers
    return out


def serving_steps(cfg, batch, impl):
    """(prefill, step): the engine's ``make_prefill_step`` (last position
    only, the context ``greedy_decode`` sizes) and ``make_serve_step``;
    for audio the prefill is the encoder, the cross K/V and the prompt
    teacher-forced through the decoder's cache, as ``greedy_decode``
    runs them.  prefill(params) -> (logits (B,1,Vp), caches, next
    index)."""
    from repro_torch.models import api, encdec
    from repro_torch.serve import (make_prefill_step, make_serve_step,
                                   serve_context_len)

    step = make_serve_step(cfg, impl=impl)
    toks = batch["tokens"]
    if cfg.family == "audio":
        @torch.no_grad()
        def prefill(params):
            memory = encdec.encode(params, cfg, batch["frames"], impl=impl)
            caches = api.init_serve_state(params, cfg, LLM_BATCH,
                                          toks.shape[1] + LLM_NEW,
                                          memory=memory)
            for t in range(toks.shape[1]):
                _, logits, caches = step(params, caches, t, toks[:, t])
            return logits[:, None], caches, toks.shape[1]
        return prefill, step
    ctx = serve_context_len(cfg, toks.shape[1], LLM_NEW, batch.get("patches"))
    pre = make_prefill_step(cfg, context_len=ctx, impl=impl, last_only=True)
    return (lambda params: pre(params, batch)), step


def decode_chain(params, cfg, batch, impl, n_new=None, feed=None):
    """``serving_steps``' prefill then ``n_new`` serve steps, the steps
    ``greedy_decode`` chains, each fed the last step's argmax or, with
    ``feed`` (B, n_new), that token instead: (prefill ms, decode ms a
    token, logits (n_new + 1, B, Vp) f32 — the prefill's last position,
    then each step's —, tokens (B, n_new), the argmaxes of the first
    n_new)."""
    n_new = LLM_NEW if n_new is None else n_new
    prefill, step = serving_steps(cfg, batch, impl)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches, nxt = prefill(params)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    steps = [logits[:, -1].float()]
    cur = torch.argmax(steps[0], dim=-1).to(torch.int32)
    toks = []
    t0 = time.perf_counter()
    for t in range(n_new):
        toks.append(cur)
        cur, lg, caches = step(params, caches, nxt + t,
                               cur if feed is None else feed[:, t])
        steps.append(lg.float())
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / max(n_new, 1)
    return (prefill_ms, decode_ms, torch.stack(steps),
            torch.stack(toks, 1) if toks else None)


def top2_margin(logits):
    """Top-1 minus top-2 logit, per position: (..., V) -> (...)."""
    top2 = torch.topk(logits, 2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def ssd_layer_probe(params, cfg32, batch, tag):
    """K12 on the inputs every Mamba2 mixer of the f32 model gives it in
    one prefill, against its plain version in f32 and in float64 on the
    same inputs: per layer, max|cum| (the largest decay exponent of a
    chunk), max|y|, the kernel's distance to the plain version, and the
    kernel's and the plain version's distance to the float64 scan, for y
    and the final state.  The model's dt (softplus of a projection, ~0.7)
    and A (down to -16) make |cum| reach ~10^3, where f32 rounding of
    cum_i - cum_j moves exp by ~1e-4.  Each layer's kernel must lie
    within the K12 rows' 1e-5·(1+max) of the plain version and within
    twice the plain version's distance to the float64 scan (+
    1e-6·(1+max)).  The op is
    swapped for the probe for this one prefill (the probe's launches come
    after the main path's counts are read).  Returns (per-layer rows,
    the layers that fail that test)."""
    import torch.nn.functional as F
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref

    op, layers = ssd_ops.ssd_scan, []

    def probe(x, dt, A, B, C, *, chunk=128, impl=None):
        y, st = op(x, dt, A, B, C, chunk=chunk, impl=impl)
        py, pst = ssd_ref.ssd_scan(x, dt, A, B, C, chunk)
        dy, dst = ssd_ref.ssd_scan(*(t.double() for t in (x, dt, A, B, C)),
                                   chunk)
        da = F.pad(dt * A, (0, 0, 0, -dt.shape[1] % chunk))
        cum = da.reshape(da.shape[0], -1, chunk, da.shape[-1]).sum(2)
        gap = lambda a, w: float((a.double() - w).abs().max())
        layers.append(dict(
            max_cum=float(cum.abs().max()), max_y=float(dy.abs().max()),
            max_state=float(dst.abs().max()),
            y_kernel_vs_plain=gap(y, py.double()), y_kernel_vs_f64=gap(y, dy),
            y_plain_vs_f64=gap(py, dy),
            state_kernel_vs_plain=gap(st, pst.double()),
            state_kernel_vs_f64=gap(st, dst),
            state_plain_vs_f64=gap(pst, dst)))
        return y, st

    ssd_ops.ssd_scan = probe
    try:
        serving_steps(cfg32, batch, None)[0](params)
    finally:
        ssd_ops.ssd_scan = op
    faults = []
    for i, r in enumerate(layers):
        for what, scale in (("y", r["max_y"]), ("state", r["max_state"])):
            k, p = r[f"{what}_kernel_vs_f64"], r[f"{what}_plain_vs_f64"]
            if r[f"{what}_kernel_vs_plain"] > 1e-5 * (1 + scale):
                faults.append(f"ssd_scan, {tag} layer {i}: {what} "
                              f"{r[what + '_kernel_vs_plain']} from the plain "
                              f"version > 1e-5·(1 + {scale})")
            if k > 2 * p + 1e-6 * (1 + scale):
                faults.append(f"ssd_scan, {tag} layer {i}: {what} {k} from "
                              f"the float64 scan, more than twice the plain "
                              f"f32 version's {p}")
    return layers, faults


def scan64_chain(params, cfg32, batch, feed):
    """``decode_chain`` of the f32 model with every prefill scan run in
    float64 (the plain version on f64 inputs, rounded once to f32), fed
    ``feed``: the witness the kernel's and the plain version's f32 scans
    are both measured from (decode runs no scan, so the three runs differ
    in the prefill's scans alone)."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref

    op = ssd_ops.ssd_scan

    def scan64(x, dt, A, B, C, *, chunk=128, impl=None):
        y, st = ssd_ref.ssd_scan(*(t.double() for t in (x, dt, A, B, C)),
                                 chunk)
        return y.float(), st.float()

    ssd_ops.ssd_scan = scan64
    try:
        return decode_chain(params, cfg32, batch, "ref", feed=feed)
    finally:
        ssd_ops.ssd_scan = op


class RouteRecorder:
    """Records the routing of every MoE layer call (``moe._route``) while
    active: (gates, probs, top_i) of each call, in call order."""

    def __enter__(self):
        from repro_torch.models import moe as moe_mod

        self.mod, self.op, self.calls = moe_mod, moe_mod._route, []

        def route(xf, router, e, k):
            out = self.op(xf, router, e, k)
            self.calls.append((out[0], out[1], out[3]))
            return out
        moe_mod._route = route
        return self

    def __exit__(self, *exc):
        self.mod._route = self.op


def route_flips(plain, kernel, moe_cfg):
    """Per routing call, the routes the kernel run takes where the plain
    run takes others: tokens whose k experts differ, with the plain run's
    margin (the token's k-th minus (k+1)-th probability), and experts
    whose top-C tokens differ, with the plain run's margin (the expert's
    C-th minus (C+1)-th gate; 0 where C is every token).  An expert that
    a flipped token leaves or joins changes its tokens for that reason:
    such experts are counted apart (``experts_moved``) and carry no
    margin.  -> one dict for each call with any flip, in call order."""
    from repro_torch.models import moe as moe_mod

    out = []
    for j, ((g_p, p_p, i_p), (g_k, _, i_k)) in enumerate(zip(plain, kernel)):
        t, k = i_p.shape
        a, b = i_p.sort(1).values, i_k.sort(1).values
        tok = (a != b).any(1)
        c = moe_mod.capacity(t, moe_cfg)
        exp = (moe_mod.top_k(g_p.T, c)[1].sort(1).values
               != moe_mod.top_k(g_k.T, c)[1].sort(1).values).any(1)
        if not (bool(tok.any()) or bool(exp.any())):
            continue
        moved = torch.zeros_like(exp)
        for row_a, row_b in zip(a[tok].tolist(), b[tok].tolist()):
            moved[list(set(row_a) ^ set(row_b))] = True
        own = exp & ~moved
        top = torch.topk(p_p, min(k + 1, p_p.shape[1]), dim=1).values
        tok_margin = (top[:, k - 1] - top[:, k])[tok]
        exp_margin = torch.zeros(int(own.sum()), device=g_p.device)
        if c < t and bool(own.any()):
            gtop = torch.topk(g_p.T, c + 1, dim=1).values
            exp_margin = (gtop[:, c - 1] - gtop[:, c])[own]
        out.append(dict(
            call=j, tokens=int(tok.sum()),
            token_margin=float(tok_margin.max()) if bool(tok.any()) else 0.0,
            experts=int(own.sum()),
            expert_margin=(float(exp_margin.max()) if bool(own.any())
                           else 0.0),
            experts_moved=int((exp & moved).sum())))
    return out


def flip_margin(flip) -> float:
    return max(flip["token_margin"], flip["expert_margin"])


def moe_block_probe(params, cfg32, batch):
    """Each MoE layer of the f32 model on the plain run's input to it in
    one prefill (the plain blocks chained), as a block with K11 and as a
    block with the plain attention: the routes the two blocks take may
    differ only at near ties (``MOE_TIE``), since K11 alone sets them
    apart.  Returns (per-layer flips, faults)."""
    from repro_torch.models import transformer
    from repro_torch.models.layers import layer_of

    flips, faults = [], []
    with torch.no_grad():
        x, _ = transformer.embed_inputs(params, cfg32, batch["tokens"])
        pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        wins = transformer.layer_windows(cfg32)
        for i in range(cfg32.n_layers):
            lp = layer_of(params["layers"], i)
            with RouteRecorder() as rk:
                transformer.block_forward(lp, x, cfg32, pos, wins[i], None)
            with RouteRecorder() as rp:
                x, _ = transformer.block_forward(lp, x, cfg32, pos, wins[i],
                                                 "ref")
            for f in route_flips(rp.calls, rk.calls, cfg32.moe):
                flips.append(dict(f, layer=i))
                if flip_margin(f) > MOE_TIE:
                    faults.append(f"moe layer {i} fed the plain input: a "
                                  f"route flips at plain margin "
                                  f"{flip_margin(f)} > {MOE_TIE}")
    return flips, faults


def llm_profile(params, cfg, batch, kernels):
    """Device time, wall and top device ops of one prefill (audio: the
    encoder and the prompt through the decoder) and of one decode step
    (kernels), ``torch.profiler`` over 3 calls each, and the device time
    of ``kernels``' launches (every CUDA function whose name starts with
    one of them: K12's ``ssd_scan_cb_kernel`` and
    ``ssd_scan_chunk_kernel``) with its share."""
    prefill, step = serving_steps(cfg, batch, None)
    logits, caches, nxt = prefill(params)
    cur = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    out = {}
    for name, fn in (("prefill", lambda: prefill(params)),
                     ("decode_step", lambda: step(params, caches, nxt,
                                                  cur))):
        per_name, device_ms, wall_ms = profile_device(fn, reps=3)
        mine = sum(t for k, t in per_name.items()
                   if any(kn + "_" in k for kn in kernels))
        out[name] = dict(
            device_ms=device_ms, wall_ms=wall_ms,
            busy=device_ms / wall_ms if device_ms else None,
            kernel_ms=mine,
            kernel_share=mine / device_ms if device_ms else None,
            top=sorted(per_name.items(), key=lambda kv: -kv[1])[:6])
    return out


class AudioSplit:
    """While active, the kernel launches counted when each
    ``encdec.encode`` returns, and each ``encdec.decode_step``'s own
    launches: the audio path's split between the encoder and the decode
    steps, read from the run itself."""

    def __enter__(self):
        from repro_torch.kernels.build import LAUNCHES
        from repro_torch.models import encdec

        self.mod, self.ops = encdec, (encdec.encode, encdec.decode_step)
        self.encodes, self.steps = [], []
        encode_op, step_op = self.ops

        def encode(*args, **kwargs):
            out = encode_op(*args, **kwargs)
            self.encodes.append(dict(LAUNCHES))
            return out

        def decode_step(*args, **kwargs):
            before = dict(LAUNCHES)
            out = step_op(*args, **kwargs)
            self.steps.append({k: v - before[k] for k, v in LAUNCHES.items()
                               if v != before[k]})
            return out
        encdec.encode, encdec.decode_step = encode, decode_step
        return self

    def __exit__(self, *exc):
        self.mod.encode, self.mod.decode_step = self.ops


def llm_phase(dev, phase, arch):
    """One config of the LLM serving slice at full width and depth: seeded
    ``torch.Generator`` params on the card, the seeded numpy inputs of
    ``llm_batch``, ``greedy_decode`` of 32 new tokens with the kernels
    (launched as ``path_launches`` says), then the engine's prefill and
    serve steps with the kernels (timed, 3 runs, bitwise equal) and with
    every plain version.

    The end-to-end gate is the same model in f32 (the config's dtype set
    to float32): the plain versions decode 32 tokens freely, and the
    kernels decode fed those same tokens.  The kernel run's logits at
    the prefill's last position within ``LLM_F32_RTOL``·(1 +
    max|logits|) of the plain run's, and at every step too, but where:
    - ssm, whose 48 random layers and state recurrence grow an f32 gap
      step by step: a step past that bound passes only within a tenth of
      the plain run's distance to the same model with float64 scans
      (``scan64_chain``), the f32 model's own error;
    - moe: the bound holds at every position, but a position over it is
      excused when it comes at or after the chain's first route flip (a
      token's experts, an expert's tokens) and that flip sits at a
      plain-run margin <= ``MOE_TIE``; in every layer fed the plain
      run's input with K11 as the only difference (``moe_block_probe``)
      each flipped route must sit at such a margin too; flips and
      excused positions are counted.
    Argmax tokens follow from the logits wherever the top-2 margin is
    above twice the bound; they are counted.  ``ssd_layer_probe`` holds
    K12 on every Mamba2 mixer's inputs against its plain version and a
    float64 scan (ssm, hybrid).  In the config's bf16, random layers turn
    one flipped rounding into differences as large as bf16's own error
    (for mamba2 larger than the logits), so the bf16 runs are held to
    finiteness, determinism and the engine's own chaining, and their
    gaps are recorded, not gated.  Every number is emitted before a
    failed check raises."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels.build import LAUNCHES, reset_launches
    from repro_torch.models import api
    from repro_torch.serve import greedy_decode

    t_phase = time.perf_counter()
    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(SEED, cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = llm_batch(cfg, dev)
    prompts, extra = batch["tokens"], extra_of(cfg, batch)
    greedy_decode(params, cfg, prompts[:, :64], 2,
                  extra_embeds=extra)                   # first use, untimed
    reset_launches()
    t0 = time.perf_counter()
    with AudioSplit() as split:
        tokens = greedy_decode(params, cfg, prompts, LLM_NEW,
                               extra_embeds=extra)
    torch.cuda.synchronize()
    greedy_s = time.perf_counter() - t0
    launched = {k: v for k, v in LAUNCHES.items() if v}
    want = path_launches(cfg, prompts.shape[1], LLM_NEW)
    if launched != want:
        raise AssertionError(f"{arch}: launches {launched}, expected {want}")
    extra_row = {}
    if cfg.family == "audio":
        # K11 in every encoder layer, then in every decoder layer's
        # cross-attention of every step: the split this run made
        enc = [e.get("flash_attention", 0) for e in split.encodes]
        per_step = [st.get("flash_attention", 0) for st in split.steps]
        n_steps = prompts.shape[1] + LLM_NEW
        if (enc != [cfg.enc_layers] or per_step != [cfg.n_layers] * n_steps
                or any(set(st) - {"flash_attention"} for st in split.steps)):
            raise AssertionError(
                f"{arch}: encodes launched {split.encodes}, decode steps "
                f"{per_step}; expected one encode of {cfg.enc_layers} and "
                f"{n_steps} steps of {cfg.n_layers} flash_attention")
        extra_row = dict(launches_encode=enc[0],
                         launches_steps=sum(per_step),
                         decode_steps=len(per_step),
                         launches_per_step=per_step[0])
    runs = [decode_chain(params, cfg, batch, None) for _ in range(3)]
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = llm_profile(params, cfg, batch, list(want))
    plain = decode_chain(params, cfg, batch, "ref")
    _, _, logits, k_toks = runs[0]
    for _, _, lg, tk in runs[1:]:
        if not (torch.equal(lg, logits) and torch.equal(tk, k_toks)):
            raise AssertionError(f"{arch}: two kernel runs differ")
    if not torch.equal(k_toks, tokens):
        raise AssertionError(f"{arch}: greedy_decode and its steps differ")
    if not (bool(torch.isfinite(logits).all()) and int(tokens.min()) >= 0
            and int(tokens.max()) < cfg.vocab_padded):
        raise AssertionError(f"{arch}: non-finite logits or bad tokens")

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    with RouteRecorder() as rec_p:
        p32 = decode_chain(params, cfg32, batch, "ref")
    with RouteRecorder() as rec_k:
        k32 = decode_chain(params, cfg32, batch, None, feed=p32[3])
    gap = lambda a, b: float((a - b).abs().max())
    err32, err32_prefill = gap(k32[2], p32[2]), gap(k32[2][0], p32[2][0])
    tol32 = LLM_F32_RTOL * (1 + float(p32[2].abs().max()))
    step_errs = (k32[2] - p32[2]).abs().amax((1, 2))
    faults = []
    if not bool(torch.isfinite(k32[2]).all()):
        faults.append("non-finite f32 kernel logits")
    if cfg.family in ("ssm", "hybrid"):
        layers, bad = ssd_layer_probe(params, cfg32, batch, arch)
        faults += bad
        extra_row |= dict(k12_layers=layers, k12_layers_max={
            key: max(r[key] for r in layers) for key in layers[0]})
    if err32_prefill > tol32 and cfg.family != "moe":
        faults.append(f"f32 prefill logits, kernel vs plain {err32_prefill}"
                      f" > {tol32}")
    if cfg.family == "ssm":
        # 48 random Mamba2 layers and the state recurrence turn a small
        # difference in a layer's scan into a large one in the logits: the
        # same model with float64 scans lies d_p from the f32 plain run.
        # Past tol32, the kernel run may differ from the plain run by at
        # most a tenth of that, the f32 model's own error.
        w64 = scan64_chain(params, cfg32, batch, p32[3])[2]
        d_k, d_p = gap(k32[2], w64), gap(p32[2], w64)
        extra_row |= dict(f32_kernel_vs_scan64=d_k, f32_plain_vs_scan64=d_p)
        if err32 > tol32 and err32 > 0.1 * d_p:
            faults.append(f"f32 logits, kernel vs plain {err32} > {tol32} "
                          f"and > a tenth of the plain run's distance {d_p} "
                          "to the float64-scan model")
    elif cfg.family == "moe":
        flips = route_flips(rec_p.calls, rec_k.calls, cfg.moe)
        probe_flips, bad = moe_block_probe(params, cfg32, batch)
        faults += bad
        # call j routes layer j % L of position j // L (0: the prefill),
        # and position p's logits follow its own routes: a position over
        # the bound is excused only at or after the chain's first flip,
        # and only when that flip sits at a plain-run margin <= MOE_TIE
        first = (flips[0]["call"] // cfg.n_layers if flips
                 else len(step_errs))
        tie = bool(flips) and flip_margin(flips[0]) <= MOE_TIE
        if flips and not tie:
            faults.append(f"the chain's first route flip ({flips[0]}) at "
                          f"plain margin {flip_margin(flips[0])} > "
                          f"{MOE_TIE}")
        over = step_errs > tol32
        excused = over & (torch.arange(len(step_errs),
                                       device=over.device) >= first) & tie
        held = over & ~excused
        if bool(held.any()):
            faults.append(f"f32 logits, kernel vs plain, over {tol32} at "
                          f"positions {held.nonzero().flatten().tolist()} "
                          f"(max {float(step_errs[held].max())}), none "
                          "excused by a near-tie route flip before them")
        extra_row |= dict(
            route_calls=len(rec_p.calls), route_flip_calls=len(flips),
            route_flipped_tokens=sum(f["tokens"] for f in flips),
            route_flipped_experts=sum(f["experts"] for f in flips),
            route_first_flip=flips[0] if flips else None,
            route_flip_max_margin=max(map(flip_margin, flips), default=0.0),
            f32_first_flip_position=first if flips else None,
            f32_positions_over_bound=int(over.sum()),
            f32_positions_excused=int(excused.sum()),
            probe_flips=probe_flips)
    elif err32 > tol32:
        faults.append(f"f32 logits, kernel vs plain {err32} > {tol32}")
    # equal argmaxes follow from the logit gate where the margin is above
    # twice it; they are counted, not gated
    sure = (top2_margin(p32[2][:-1]) > 2 * tol32).T          # (B, n_new)
    first = logits[0]
    row = dict(
        phase=phase, arch=arch, batch=LLM_BATCH, prompt=prompts.shape[1],
        new_tokens=LLM_NEW, dtype=cfg.dtype,
        params=sum(t.numel() for t in _leaves(params)),
        init_s=init_s, greedy_s=greedy_s, launches=launched,
        prefill_ms=[r[0] for r in runs], decode_ms_per_token=[
            r[1] for r in runs], plain_prefill_ms=plain[0],
        plain_decode_ms_per_token=plain[1], peak_mem_gb=peak_gb,
        f32_logits_err=err32, f32_prefill_logits_err=err32_prefill,
        f32_tol=tol32, f32_step_errs=step_errs.tolist(),
        f32_logits_max_abs=float(p32[2].abs().max()),
        f32_tokens_equal=int((k32[3] == p32[3]).sum()),
        f32_tokens_above_margin=int(sure.sum()),
        f32_token_slots=sure.numel(),
        f32_min_margin=float(top2_margin(p32[2][:-1]).min()),
        bf16_logits_max_abs=float(first.abs().max()),
        bf16_kernel_vs_plain=float((first - plain[2][0]).abs().max()),
        bf16_plain_vs_f32=float((plain[2][0] - p32[2][0]).abs().max()),
        bf16_tokens_equal_steps=int((k_toks == plain[3]).all(0).to(
            torch.int64).cumprod(0).sum()),
        bf16_min_margin=float(top2_margin(logits[:-1]).min()),
        tokens=tokens[0, :8].tolist(), profile=prof) | extra_row
    del params, runs, plain, p32, k32, rec_p, rec_k
    gc.collect()
    torch.cuda.empty_cache()
    row["phase_s"] = time.perf_counter() - t_phase
    emit({key: v for key, v in row.items() if key != "k12_layers"})
    if faults:
        raise AssertionError(f"{arch}: " + "; ".join(faults))
    return row


# --------------------------------------------------- long-context serving

# long_500k (configs.INPUT_SHAPES): one request (B = 1) decoding at a
# context of 524,288, for the archs ``launch.specs.supports`` allows it
LONG_ARCHS = ("mamba2-1.3b", "hymba-1.5b", "gemma2-9b")
LONG_PROMPT = 32_768           # prefill_32k's seq_len
LONG_NEW = 32
LONG_CHECK_PROMPT = 8_192      # twice gemma2's window: every ring wraps
LONG_CHECK_STEPS = 8           # f32 steps compared after it and far out
ROPE_F64_TOL = 1e-6            # CUDA cos/sin of the f32 angle vs float64
LONG_SLICE = 1024              # query rows of a plain K11 slice


def kept_calls(module, name, keep, shapes=None):
    """A context in which ``module.<name>`` (a kernel's op, which the
    model looks up at each call) runs as before and keeps, on the host,
    the args, keywords and result of its calls numbered ``keep`` (from 0):
    yields {number: (args, kwargs, result)}; launches are counted by the
    op itself, as before.  ``shapes``, a list, gets every call's tensor
    args' shapes."""
    import contextlib

    host = lambda t: t.cpu() if isinstance(t, torch.Tensor) else t

    @contextlib.contextmanager
    def run():
        orig, kept, seen = getattr(module, name), {}, [0]

        def spy(*args, **kw):
            out = orig(*args, **kw)
            if shapes is not None:
                shapes.append([tuple(a.shape) for a in args
                               if isinstance(a, torch.Tensor)])
            if seen[0] in keep:
                kept[seen[0]] = (tuple(map(host, args)), kw,
                                 tuple(map(host, out)) if isinstance(
                                     out, tuple) else host(out))
            seen[0] += 1
            return out

        setattr(module, name, spy)
        try:
            yield kept
        finally:
            setattr(module, name, orig)
    return run()


def long_sdpa(q, k, v, mask):
    """SDPA's time on a long K11 launch's inputs with the same mask as a
    boolean ``attn_mask`` (suffix-aligned), where SDPA can compute it
    (no softcap): the kv heads repeated to the q heads outside the timed
    call, so that the memory-efficient backend takes the mask (with
    ``enable_gqa`` only the math backend takes a mask, and its f32
    scores of B·H·S² would not fit the card at these lengths)."""
    if mask["logit_cap"]:
        return dict(library_ms=None, library="none: SDPA cannot softcap")
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sq, sk, g = q.shape[1], k.shape[1], q.shape[2] // k.shape[2]
    row = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    col = torch.arange(sk, device=q.device)[None, :]
    ok = col <= row if mask["causal"] else col >= 0
    if mask["window"]:
        ok &= ((row - col) < mask["window"]) | (col < mask["prefix"])
    qt, kt, vt = (t.transpose(1, 2) for t in (
        q, k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        ms = cuda_ms(lambda: sdpa(qt, kt, vt, attn_mask=ok), reps=5)
    del ok, qt, kt, vt
    return dict(library_ms=ms, library="torch scaled_dot_product_attention"
                "(a boolean attn_mask, kv heads repeated, memory-efficient "
                "backend)")


@torch.no_grad()
def long_kernel_checks(dev, arch, k11, k12):
    """The K11 and K12 launches kept from the counted bf16 prefill of
    32,768 tokens (the first, middle and last layer's), held against
    their plain versions on the same inputs: K11's output (its bf16
    tensor-core instance, with the layer's window, pinned prefix and
    softcap) on three slices of ``LONG_SLICE`` query rows (the first,
    the middle, the last; the plain version is f32 full attention on
    the keys up to the slice's end, suffix-aligned) within one bf16 ulp,
    2^-7·|plain| + 1e-6, the ``kernels`` line's bf16 bound; K12's y and
    final state (f32) within 1e-5·(1 + max|plain|), its rows' bound.
    Each kept launch is also timed alone (CUDA events); K11's beside its
    bound, as ``flash_row`` counts it (QKᵀ one bf16 pass, P·V three, over
    the pairs the causal window and prefix leave visible), and SDPA's
    time on the same inputs (``long_sdpa``); K12's beside its bound, as
    ``ssd_row`` counts it (``ssd_work``).  Returns (rows, faults)."""
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_cuda
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda

    rows, faults = [], []
    for call, ((q, k, v), kw, out) in sorted(k11.items()):
        q, k, v, out = (t.to(dev).contiguous() for t in (q, k, v, out))
        mask = {key: kw[key] for key in ("causal", "window", "prefix",
                                         "logit_cap")}
        sq, err = q.shape[1], 0.0
        for a in sorted({0, (sq - LONG_SLICE) // 2, sq - LONG_SLICE}):
            e = a + LONG_SLICE
            want = fa_ref.flash_attention(q[:, a:e], k[:, :e], v[:, :e],
                                          **mask).float()
            d = (out[:, a:e].float() - want).abs()
            err = max(err, float(d.max()))
            if bool((d > BF16_ULP * want.abs() + 1e-6).any()):
                faults.append(f"{arch}: K11 launch {call} at the long "
                              f"shape, rows {a}…{e}, {float(d.max())} off "
                              "the plain version (> one bf16 ulp)")
            del want, d
        r = np.arange(sq, dtype=np.int64)         # sq == sk: a prefill
        visible = int((np.minimum(r + 1, mask["window"] or sq) + np.clip(
            np.minimum(mask["prefix"], r - mask["window"] + 1), 0, None)
            * (mask["window"] > 0)).sum())
        b_ms, b_by = bound(
            q.element_size() * (2 * q.numel() + 2 * k.numel()),
            (1 + 3) * 2 * q.shape[0] * q.shape[2] * q.shape[3] * visible,
            BF16_FLOPS)
        rows.append(dict(
            name="flash_attention", launch=call, shape=list(q.shape)
            + [k.shape[2]], dtype=str(q.dtype).split(".")[-1], **mask,
            rows_checked=3 * LONG_SLICE, max_abs_err=err,
            ms=cuda_ms(lambda: flash_attention_cuda(q, k, v, **mask),
                       reps=5), bound_ms=b_ms, bound_by=b_by,
            visible_pairs=visible, **long_sdpa(q, k, v, mask)))
        del q, k, v, out
    for call, (args, kw, (y, fs)) in sorted(k12.items()):
        args = tuple(t.to(dev).float().contiguous() for t in args)
        y, fs = y.to(dev), fs.to(dev)
        wy, wfs = ssd_ref.ssd_scan(*args, kw["chunk"])
        err = 0.0
        for what, got, want in (("y", y, wy), ("state", fs, wfs)):
            d = float((got - want).abs().max())
            err = max(err, d)
            if d > 1e-5 * (1 + float(want.abs().max())):
                faults.append(f"{arch}: K12 launch {call} at the long "
                              f"shape, {what} {d} off the plain version")
        b, s, h, p = args[0].shape
        nbytes, flops, elem, _ = ssd_work(b, s, h, p, args[3].shape[-1],
                                          kw["chunk"])
        b_ms, b_by = bound(nbytes, [(3 * flops, TF32_FLOPS),
                                    (b * h * elem, F32_FLOPS)])
        rows.append(dict(
            name="ssd_scan", launch=call, shape=list(args[0].shape),
            chunk=kw["chunk"], max_abs_err=err,
            ms=cuda_ms(lambda: ssd_scan_cuda(*args, chunk=kw["chunk"]),
                       reps=5), bound_ms=b_ms, bound_by=b_by,
            library_ms=None))
        del args, y, fs, wy, wfs
    torch.cuda.empty_cache()
    return rows, faults


def long_steps(params, step, caches, start, tok, n, feed=None):
    """``n`` serve steps at positions ``start`` … ``start + n - 1``, fed
    ``tok`` then each step's argmax, or the tokens of ``feed`` (B, n):
    (ms a token, logits (n, B, Vp) f32, the tokens fed (B, n))."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, fed, cur = [], [], tok
    for t in range(n):
        cur = cur if feed is None else feed[:, t]
        fed.append(cur)
        cur, lg, caches = step(params, caches, start + t, cur)
        logits.append(lg.float())
    torch.cuda.synchronize()
    return ((time.perf_counter() - t0) * 1e3 / n, torch.stack(logits),
            torch.stack(fed, 1))


def ring_faults(arch, cfg, caches, nxt, force_window):
    """Every windowed cache's ``pos`` against ``attention.cache_slot``'s
    map after a prefill of ``nxt`` positions: the pinned prefix and the
    window's last positions, each in its slot, and nothing else."""
    from repro_torch.models import attention, transformer

    prefix = cfg.hybrid_meta_tokens
    wins = transformer.layer_windows(cfg, force_window=force_window)
    out = []
    for i, e in enumerate(caches):
        if "attn" not in e or not wins[i]:
            continue
        pos = e["attn"]["pos"]
        cap = pos.shape[0]
        want = torch.full_like(pos, -1)
        for p in list(range(prefix)) + list(range(max(prefix, nxt - cap
                                                       + prefix), nxt)):
            want[attention.cache_slot(p, cap, wins[i], prefix)] = p
        if cap != prefix + wins[i] or not torch.equal(pos, want):
            out.append(f"{arch} layer {i}: ring slots hold "
                       f"{pos.tolist()[:8]}…, cache_slot's map "
                       f"{want.tolist()[:8]}… (capacity {cap})")
    return out


def rope_probe(cfg, dev, ctx):
    """Rotary at positions ctx - 32 … ctx - 1 on the card: the ``inv_freq``
    entries that differ from the CPU's, CUDA's cos/sin of the f32 angles
    against float64's of the same angles, and the rotated values against
    the CPU's (seeded x)."""
    from repro_torch.models.layers import rotary_embed

    half = cfg.resolved_head_dim // 2
    pos = torch.arange(ctx - 32, ctx, dtype=torch.int32)
    inv = [1.0 / (cfg.rope_theta ** (torch.arange(
        half, dtype=torch.float32, device=d) / half)) for d in (dev, "cpu")]
    ang = pos.to(dev)[:, None].float() * inv[0]
    a64 = ang.cpu().double()
    trig = max(float((torch.cos(ang).cpu().double() - a64.cos()).abs().max()),
               float((torch.sin(ang).cpu().double() - a64.sin()).abs().max()))
    x = torch.from_numpy(np.random.default_rng(SEED).normal(
        size=(1, 32, 2, 2 * half)).astype(np.float32))
    rot = (rotary_embed(x.to(dev), pos.to(dev), cfg.rope_theta).cpu()
           - rotary_embed(x, pos, cfg.rope_theta)).abs().max()
    return dict(head_dim=2 * half, theta=cfg.rope_theta,
                inv_freq_differ=int((inv[0].cpu() != inv[1]).sum()),
                cos_sin_vs_f64=trig, rotary_card_vs_cpu=float(rot),
                max_abs_x=float(x.abs().max()))


def long_context_run(dev, arch):
    """One long_500k path at full width and depth in the config's bf16:
    seeded params on the card, a seeded prompt of 32,768 tokens through
    the engine's prefill (``force_window`` as ``specs.build_decode`` sets
    it; the caches sized for the 524,288 context) — the run whose
    launches count —, timed over 3 more runs, then 32 greedy serve steps
    from it and 32 from a copy of its caches at positions 524,256 …
    524,287.  Gates: the K11/K12 launches of the counted prefill (the
    first, middle and last layer's) against their plain versions on the
    same inputs (``long_kernel_checks``); the f32 model at 8,192 tokens,
    kernels against plain versions (``impl="ref"``), the prefill's last
    logits and 8 steps after it and 8 far out, each fed the plain run's
    tokens, within ``LLM_F32_RTOL``·(1 + max|logits|) (far out, no prompt
    position lies inside a window: the steps hold the rings' masking and,
    for hymba, the pinned prefix's K/V; for gemma2 the two runs agree
    there by construction); every ring cache's slots as ``cache_slot``
    maps them."""
    import dataclasses
    import gc

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.kernels.build import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch import specs
    from repro_torch.models import api, transformer
    from repro_torch.serve import make_prefill_step, make_serve_step
    from repro_torch.train.optimizer import tree_map

    t_phase = time.perf_counter()
    cfg = get_config(arch)
    shape = INPUT_SHAPES["long_500k"]
    if not specs.supports(cfg, shape)[0]:
        raise AssertionError(f"{arch}: not a long_500k arch")
    b, ctx = shape.global_batch, shape.seq_len
    fw = shape.name == "long_500k" and cfg.family != "ssm"
    torch.cuda.reset_peak_memory_stats()
    params = api.init_params(SEED, cfg, device=dev)
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (b, LONG_PROMPT)).astype(np.int32)).to(dev)
    pre = make_prefill_step(cfg, context_len=ctx, force_window=fw,
                            last_only=True)
    step = make_serve_step(cfg, force_window=fw)
    pre(params, {"tokens": toks[:, :512]})               # first use, untimed
    torch.cuda.synchronize()
    want = path_launches(cfg, LONG_PROMPT, LONG_NEW)
    keep = {op: {0, n // 2, n - 1} for op, n in want.items()}
    reset_launches()
    with kept_calls(fa_ops, "flash_attention",
                    keep.get("flash_attention", ())) as k11, \
            kept_calls(ssd_ops, "ssd_scan", keep.get("ssd_scan", ())) as k12:
        logits, caches, nxt = pre(params, {"tokens": toks})
    torch.cuda.synchronize()
    launched = {k: v for k, v in LAUNCHES.items() if v}
    if launched != want:
        raise AssertionError(f"{arch} long_500k: launches {launched}, "
                             f"expected {want}")
    prefill_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again, _, _ = pre(params, {"tokens": toks})
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        if not torch.equal(again, logits):
            raise AssertionError(f"{arch} long_500k: two prefills differ")
    del again
    state = _tree_bytes(caches)
    with FakeTensorMode():
        full_state = _tree_bytes(transformer.init_decode_state(
            cfg, b, ctx, force_window=False, device="cpu"))
    far = tree_map(torch.clone, caches)
    tok0 = torch.argmax(logits[:, -1], -1).to(torch.int32)
    decode_ms, steps, fed = long_steps(params, step, caches, nxt, tok0,
                                       LONG_NEW)
    far_ms, far_steps, far_fed = long_steps(params, step, far,
                                            ctx - LONG_NEW, tok0, LONG_NEW)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    faults = []
    for name, t in (("prefill", logits), ("decode", steps),
                    ("far decode", far_steps)):
        if not bool(torch.isfinite(t).all()):
            faults.append(f"non-finite {name} logits")
    caps = sorted({e["attn"]["k"].shape[1] for e in caches if "attn" in e})
    if any(c >= ctx for c in caps):
        faults.append(f"a full-context cache under force_window: {caps}")
    del caches, far, steps, far_steps
    gc.collect()
    torch.cuda.empty_cache()

    # the gate: the f32 model at 8,192 tokens, plain versions then kernels
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    batch32 = {"tokens": toks[:, :LONG_CHECK_PROMPT]}
    step32 = make_serve_step(cfg32, force_window=fw)
    runs = {}
    for impl in ("ref", None):
        lg, c32, n32 = make_prefill_step(
            cfg32, context_len=ctx, force_window=fw, impl=impl,
            last_only=True)(params, batch32)
        if impl is None:
            faults += ring_faults(arch, cfg32, c32, n32, fw)
        lg = lg[:, -1].float()
        feed = runs["ref"] if impl is None else None
        first = torch.argmax(lg, -1).to(torch.int32)
        far32 = tree_map(torch.clone, c32)
        _, near, near_fed = long_steps(
            params, step32, c32, n32, first, LONG_CHECK_STEPS,
            feed=feed["near_fed"] if feed else None)
        _, out, out_fed = long_steps(
            params, step32, far32, ctx - LONG_CHECK_STEPS, first,
            LONG_CHECK_STEPS, feed=feed["far_fed"] if feed else None)
        runs["ref" if impl else "kernel"] = dict(
            logits=torch.cat([lg[None], near, out]), near_fed=near_fed,
            far_fed=out_fed)
        del c32, far32
        gc.collect()
        torch.cuda.empty_cache()
    p32, k32 = runs["ref"]["logits"], runs["kernel"]["logits"]
    tol32 = LLM_F32_RTOL * (1 + float(p32.abs().max()))
    errs = (k32 - p32).abs().amax((1, 2))
    if not bool(torch.isfinite(k32).all()):
        faults.append("non-finite f32 kernel logits")
    if float(errs.max()) > tol32:
        faults.append(f"f32 logits, kernel vs plain, {errs.tolist()} > "
                      f"{tol32} (prefill, {LONG_CHECK_STEPS} steps, "
                      f"{LONG_CHECK_STEPS} far steps)")
    rope = rope_probe(cfg, dev, ctx) if cfg.family != "ssm" else None
    if rope and rope["cos_sin_vs_f64"] > ROPE_F64_TOL:
        faults.append(f"rotary at ~5.2e5 rad: CUDA cos/sin "
                      f"{rope['cos_sin_vs_f64']} from float64's")
    row = dict(
        phase="long_context", arch=arch, shape=shape.name, batch=b,
        context=ctx, force_window=fw, prompt=LONG_PROMPT,
        new_tokens=LONG_NEW, dtype=cfg.dtype,
        params=sum(t.numel() for t in _leaves(params)),
        launches=launched, prefill_ms=prefill_ms,
        decode_ms_per_token=decode_ms, far_decode_ms_per_token=far_ms,
        far_positions=[ctx - LONG_NEW, ctx - 1], peak_mem_gb=peak_gb,
        decode_state_bytes=state, decode_state_bytes_without_window=full_state,
        cache_capacities=caps, tokens=fed[0, :8].tolist(),
        far_tokens=far_fed[0, :8].tolist(),
        f32_check_prompt=LONG_CHECK_PROMPT, f32_tol=tol32,
        f32_errs=errs.tolist(), f32_logits_max_abs=float(p32.abs().max()),
        rope=rope)
    del params, runs
    gc.collect()
    torch.cuda.empty_cache()
    row["long_kernels"], more = long_kernel_checks(dev, arch, k11, k12)
    faults += more
    row["phase_s"] = time.perf_counter() - t_phase
    emit(row)
    if faults:
        raise AssertionError(f"{arch} long_500k: " + "; ".join(faults))
    return row


def long_context_phase(dev):
    """The long_500k paths of mamba2-1.3b, hymba-1.5b and gemma2-9b, each
    with its own launch count (K12 / K11 and K12 / K11 a layer of the
    prefill)."""
    return [long_context_run(dev, arch) for arch in LONG_ARCHS]


# ----------------------------------------------------------- LLM training

TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "tinyllama-1.1b", 2, 2048, 6
TRAIN_LR = 1e-5                # Adam; 6 steps on one batch must lower the loss
TRAIN_LOSS_RTOL = 1e-5         # kernel vs plain, f32 model: |Δloss| / |loss|
TRAIN_GRAD_RTOL = 1e-3         # ‖Δg‖ / ‖g‖ of every param leaf
TRAIN_GRAD_FLOOR = 1e-6        # × the largest leaf's ‖g‖ (a key bias's is 0)
REDUCED_SEQ = 64
CKPT_STEPS = 3                 # steps before the checkpoint; one after it


def train_batch(cfg, dev, b, s, seed=SEED):
    """``token_batch_iterator``'s first batch (with stub frames or
    patches where the family takes them) with the Eq.(2) weights 1 +
    rank/B, on the card."""
    from repro_torch.data.pipeline import token_batch_iterator

    nb = next(token_batch_iterator(
        b, s, cfg.vocab, seed=seed, d_model=cfg.d_model,
        frames=cfg.enc_seq if cfg.family == "audio" else 0,
        patches=cfg.vision_tokens if cfg.family == "vlm" else 0,
        weights=True))
    nb["weights"] = (1.0 + np.arange(b) / b).astype(np.float32)
    return {k: torch.from_numpy(v).to(dev) for k, v in nb.items()}


def loss_and_grads(params, cfg, batch, attn_impl):
    """``train.steps.lm_loss`` and its gradient leaves (``tree_leaves``
    order) with K11 (``attn_impl=None``) or its plain version
    (``"ref"``), and the launches that made them."""
    from repro_torch.kernels.build import LAUNCHES, reset_launches
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.steps import lm_loss

    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    reset_launches()
    loss, _ = lm_loss(params, cfg, batch, attn_impl=attn_impl)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    torch.cuda.synchronize()
    launches = {k: v for k, v in LAUNCHES.items() if v}
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    for p in leaves:
        p.requires_grad_(False)
    return loss.detach(), grads, launches


def grad_gate(tag, params, cfg, batch, faults):
    """Kernel vs plain on one f32 loss and gradient: (row, kernel
    launches).  The loss within ``TRAIN_LOSS_RTOL``, each leaf within
    ``TRAIN_GRAD_RTOL``·‖g‖ + ``TRAIN_GRAD_FLOOR``·max‖g‖; the worst
    leaf is named."""
    from repro_torch.checkpoint.store import _paths

    names = [k for k, _ in _paths(params)]
    lk, gk, launches = loss_and_grads(params, cfg, batch, None)
    lp, gp, _ = loss_and_grads(params, cfg, batch, "ref")
    norms = [float(g.double().norm()) for g in gp]
    top = max(norms)
    ratios = [float((a.double() - b.double()).norm())
              / (TRAIN_GRAD_RTOL * n + TRAIN_GRAD_FLOOR * top)
              for a, b, n in zip(gk, gp, norms)]
    worst = int(np.argmax(ratios))
    loss_err = abs(float(lk) - float(lp)) / abs(float(lp))
    row = dict(loss_kernel=float(lk), loss_plain=float(lp),
               loss_rel_err=loss_err, worst_leaf=names[worst],
               worst_leaf_rel_err=float(
                   (gk[worst].double() - gp[worst].double()).norm())
               / max(norms[worst], 1e-300),
               worst_leaf_of_bound=ratios[worst], leaves=len(gk))
    if not (np.isfinite(float(lk)) and loss_err <= TRAIN_LOSS_RTOL):
        faults.append(f"{tag}: loss {float(lk)} vs plain {float(lp)}")
    if ratios[worst] > 1.0:
        faults.append(f"{tag}: leaf {names[worst]} gradient "
                      f"{ratios[worst]}× its bound from the plain one")
    return row, launches


def attention_layers(cfg) -> int:
    """Attention layers of a training forward (the encoder's, and the
    decoder's self- and cross-attention for audio)."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "audio":
        return cfg.enc_layers + 2 * cfg.n_layers
    return cfg.n_layers


def llm_train_phase(dev):
    """LLM training at full width and depth, then the ten reduced configs
    and the checkpoint resume (docstring item 18).  Returns the row;
    every number is emitted before a failed gate raises."""
    import dataclasses
    import gc

    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.kernels.build import LAUNCHES, reset_launches
    from repro_torch.models import api
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.steps import init_train_state, make_train_step

    t_phase = time.perf_counter()
    faults = []
    cfg = get_config(TRAIN_ARCH)
    layers = attention_layers(cfg)
    want = {"flash_attention": 2 * layers, "flash_attention_bwd": layers}
    batch = train_batch(cfg, dev, TRAIN_BATCH, TRAIN_SEQ)

    # the f32 model: one kernel-vs-plain gradient
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = api.init_params(SEED, cfg32, device=dev)
    f32_row, f32_launches = grad_gate(f"{TRAIN_ARCH} f32", params, cfg32,
                                      batch, faults)
    if f32_launches != want:
        faults.append(f"f32 gradient launched {f32_launches}, not {want}")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # the config's bf16: 6 steps on one batch, twice
    def run():
        params, opt = init_train_state(SEED, cfg, device=dev)
        step = make_train_step(cfg, lr=TRAIN_LR)
        losses, ms, launches = [], [], []
        for _ in range(TRAIN_STEPS):
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(m["loss"].item())
            launches.append({k: v for k, v in LAUNCHES.items() if v})
        return params, opt, step, losses, ms, launches

    torch.cuda.reset_peak_memory_stats()
    first = run()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    second = run()
    params, opt, step = second[:3]
    prof_per, prof_device, prof_wall = profile_device(
        lambda: step(params, opt, batch), reps=1)
    bwd_ms = sum(t for k, t in prof_per.items()
                 if "flash_attention_bwd_" in k)
    fwd_ms = sum(t for k, t in prof_per.items()
                 if "flash_attention_" in k and "bwd" not in k)
    losses, all_ms = [first[3], second[3]], [first[4], second[4]]
    step_launches = first[5][0]
    step_ms = float(np.median(first[4][1:] + second[4][1:]))
    bits = [np.asarray(l, np.float32).view(np.int32).tolist()
            for l in losses]
    if bits[0] != bits[1]:
        faults.append(f"bf16 losses differ between two runs: {losses}")
    if not losses[0][-1] < losses[0][0]:
        faults.append(f"bf16 loss did not fall: {losses[0]}")
    for launches in first[5] + second[5]:
        if launches != want:
            faults.append(f"a bf16 step launched {launches}, not {want}")
            break
    del params, opt, first, second
    gc.collect()
    torch.cuda.empty_cache()

    # every reduced config, f32: one kernel-vs-plain gradient each
    reduced = {}
    for arch in ARCH_IDS:
        rcfg = get_config(arch).reduced()
        rparams = api.init_params(SEED, rcfg, device=dev)
        rrow, rl = grad_gate(f"{arch}-reduced", rparams, rcfg,
                             train_batch(rcfg, dev, 2, REDUCED_SEQ), faults)
        n = attention_layers(rcfg)
        rwant = {"flash_attention": 2 * n, "flash_attention_bwd": n} \
            if n else {}
        if rl != rwant:
            faults.append(f"{arch}-reduced launched {rl}, not {rwant}")
        reduced[arch] = rrow | {"launches": rl}
        del rparams

    # checkpoint at reduced tinyllama: step 4 from the loaded state
    ccfg = get_config(TRAIN_ARCH).reduced()
    cbatch = train_batch(ccfg, dev, 2, REDUCED_SEQ)
    cstep = make_train_step(ccfg, lr=1e-3)
    path = os.path.join(ROOT, "build", "llm_train_ckpt.npz")
    sp, so = init_train_state(SEED, ccfg, device=dev)
    for i in range(CKPT_STEPS + 1):
        sp, so, sm = cstep(sp, so, cbatch)
        if i == CKPT_STEPS - 1:
            save_checkpoint(path, (sp, so), step=so.step)
    like = init_train_state(SEED + 1, ccfg, device=dev)
    (lp, lo), meta = load_checkpoint(path, like)
    lp, lo, lm = cstep(lp, lo, cbatch)
    resumed = (lo.step == so.step == CKPT_STEPS + 1
               and meta["step"] == CKPT_STEPS
               and torch.equal(lm["loss"], sm["loss"])
               and all(torch.equal(a, b) for a, b in zip(
                   tree_leaves((lp, lo.mu, lo.nu)),
                   tree_leaves((sp, so.mu, so.nu)))))
    if not resumed:
        faults.append("the step after the checkpoint differs from the "
                      "uninterrupted run's")
    os.remove(path)

    row = dict(
        phase="llm_train", arch=TRAIN_ARCH, batch=TRAIN_BATCH,
        seq=TRAIN_SEQ, lr=TRAIN_LR, f32=f32_row,
        f32_launches=f32_launches, bf16_losses=losses[0],
        bf16_losses_bitwise_equal=bits[0] == bits[1],
        bf16_launches_a_step=step_launches, step_ms=step_ms,
        step_ms_all=all_ms,
        tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3,
        peak_gb=peak_gb,
        profile=dict(device_ms=prof_device, wall_ms=prof_wall,
                     busy=prof_device / prof_wall if prof_device else None,
                     k11_bwd_ms=bwd_ms, k11_fwd_ms=fwd_ms,
                     k11_bwd_share=bwd_ms / prof_device
                     if prof_device else None,
                     top=sorted(prof_per.items(),
                                key=lambda kv: -kv[1])[:8]),
        reduced=reduced, checkpoint_resume_bitwise=resumed,
        launches={"flash_attention_bwd":
                  step_launches.get("flash_attention_bwd", 0)},
        phase_s=time.perf_counter() - t_phase)
    emit(row)
    if faults:
        raise AssertionError("llm_train: " + "; ".join(faults))
    return row


# ------------------------------------------------------------ sharded phase

#: the worlds of the sharded phase: (name, ranks, mesh shape, quant of each
#: run); on one card every rank runs on it over gloo, the collectives
#: staged through host memory
SHARDED_WORLDS = (("data2", 2, (2,), (None,)),
                  ("2x2", 4, (2, 2), (None, "int8")))
SHARDED_TIMEOUT = 400          # seconds a world may take, spawn to join
SHARDED_LOSS_RTOL = 1e-4       # the reference's own (tests/test_sharded.py)
SHARDED_LOSS_ATOL = 1e-6
SHARDED_ACC = 0.02
# int8 on (2, 2): a data rank's 350 rows end mid-block of the wire's 8, so
# the second rank's blocks group other rows than one device's (ROADMAP R3),
# and every activation of a regrouped block may round one wire step apart:
# the sharded int8 losses are held within twice the wire's own effect
# (the int8 run's largest relative distance to the f32 run's) of the
# unsharded int8 run's, plus the f32 tolerance
SHARDED_INT8_WIRE_FACTOR = 2.0
#: K2's and K10's kernels (csrc/splitnn_bottom.cu), as the profiler names them
K2_MARK = {None: "bottom_kernel", "int8": "bottom_int8_kernel"}


def _every_rank(flag: bool, device) -> bool:
    """Whether ``flag`` holds on every rank of the running world."""
    import torch.distributed as dist
    t = torch.tensor([int(flag)], device=device
                     if dist.get_backend() == "nccl" else "cpu")
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())


def sharded_rank(device, shape, quants, tr_raw, te_raw, cfg, seed):
    """One rank of a sharded world: the HI treecss × mlp pipeline on a
    ``("data",)`` or ``(data, model)`` mesh over the world, once for each
    quant in ``quants``, each after an untimed drive (CUDA, cuBLAS, the
    kernel libraries and each shape's first allocations load there),
    with the launch and collective counts set to 0 just before it and
    read just after; then one epoch of its training under the profiler, which must
    see K2's (K10's under int8) kernel on this rank's device."""
    from repro_torch import sharding
    from repro_torch.config import AlignOptions, EngineOptions
    from repro_torch.core.splitnn import train_splitnn
    from repro_torch.core.treecss import _align, run_pipeline
    from repro_torch.data.vertical import VerticalPartition
    from repro_torch.kernels.build import LAUNCHES, reset_launches
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.train.optimizer import tree_leaves

    mesh = make_data_mesh(model=shape[1] if len(shape) == 2 else 1)
    tr, te = (VerticalPartition(list(f), y, list(sl))
              for f, y, sl in (tr_raw, te_raw))
    align = AlignOptions(protocol="oprf", psi_backend="device",
                         impl="kernel", device=device, mesh=mesh)
    options = lambda quant, trace=None: EngineOptions(
        device=device, mesh=mesh, bottom_impl="kernel", quant=quant,
        trace=trace)
    drive = lambda part, test, quant, trace=None: run_pipeline(
        part, test, cfg, variant="treecss", clusters_per_client=14,
        kmeans_impl="kernel", seed=seed, options=options(quant, trace),
        align=align)
    for quant in quants:        # untimed: first use of each shape and wire
        drive(tr, te, quant)
    out = []
    for quant in quants:
        reset_launches()
        sharding.reset_collectives()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = drive(tr, te, quant, trace=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, collectives = dict(LAUNCHES), dict(sharding.COLLECTIVES)
        aligned = _align(tr, "tree", align=align, seed=seed)[0]
        core = aligned.take(rep.coreset.indices)
        one_epoch = dataclasses.replace(cfg, max_epochs=1)
        for _ in range(4):      # a profiler session may record no kernel
            per_name, _, _ = profile_device(lambda: train_splitnn(
                core, one_epoch, sample_weights=rep.coreset.weights,
                options=options(quant)), reps=1, warm=False)
            k2 = sorted(k for k in per_name if K2_MARK[quant] in k)
            if _every_rank(bool(k2), device):
                break
        st = rep.train.engine_stats
        out.append(dict(
            quant=quant, device=str(device),
            intersection=rep.mpsi.intersection, n_train=rep.n_train,
            indices=rep.coreset.indices, weights=rep.coreset.weights,
            coreset_shards=rep.coreset.shards,
            losses=np.asarray(rep.train.losses), epochs=rep.train.epochs,
            steps=rep.train.steps, comm_bytes=rep.train.comm_bytes,
            params=np.concatenate([t.cpu().numpy().ravel()
                                   for t in tree_leaves(rep.train.params)]),
            metric=rep.metric, shards=st.shards,
            model_shards=st.model_shards, padded_batch=st.padded_batch,
            steps_per_epoch=st.steps_per_epoch, host_syncs=st.host_syncs,
            gather_payload_bytes=st.gather_payload_bytes,
            walls=dict(total_s=wall, align_s=rep.align_wall_seconds,
                       coreset_s=rep.coreset_wall_seconds,
                       train_s=rep.train_wall_seconds,
                       eval_s=rep.tracer.total_seconds("pipeline.serve")),
            launches=launches, collectives=collectives, k2_profiled=k2))
    return out


def _unsharded_run(tr, te, dev, cfg, quant):
    """The yardstick: the same job on the card, unsharded, with its
    launch counts."""
    from repro_torch.kernels.build import LAUNCHES, reset_launches
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = drive_split(tr, te, dev, "treecss", cfg, "kernel", trace=True,
                      quant=quant)
    torch.cuda.synchronize()
    return rep, dict(LAUNCHES), dict(
        total_s=time.perf_counter() - t0, align_s=rep.align_wall_seconds,
        coreset_s=rep.coreset_wall_seconds, train_s=rep.train_wall_seconds,
        eval_s=rep.tracer.total_seconds("pipeline.serve"))


def loss_rel_err(got, want) -> float:
    """The largest relative distance of two epoch-loss traces over their
    common epochs."""
    k = min(len(got), len(want))
    got, want = np.asarray(got[:k]), np.asarray(want[:k])
    return float(np.max(np.abs(got - want) / np.abs(want)))


def check_sharded(tag, shape, runs, base, base_launches, n_eval, f32):
    """The faults of one sharded run against its unsharded run on the
    card (``base``): every rank's outputs bitwise rank 0's; alignment
    and coreset bitwise; the mesh in the stats; counters exact (per
    epoch under int8, whose convergence window may stop elsewhere);
    losses and accuracy within the tolerances above; one host sync an
    epoch; the path's kernels launched on every rank as often as
    unsharded; K2 (K10) seen by the profiler on every rank."""
    r0, quant = runs[0], runs[0]["quant"]
    faults = []
    for key in ("intersection", "indices", "weights", "losses", "params",
                "metric", "epochs", "steps", "comm_bytes"):
        if not all(same_bits([torch.from_numpy(np.atleast_1d(r[key]))],
                             [torch.from_numpy(np.atleast_1d(r0[key]))])
                   for r in runs[1:]):
            faults.append(f"{tag}: ranks' {key} differ")
    if not np.array_equal(r0["intersection"], base.mpsi.intersection):
        faults.append(f"{tag}: intersection differs from unsharded")
    if not (np.array_equal(r0["indices"], base.coreset.indices)
            and same_bits([torch.from_numpy(r0["weights"])],
                          [torch.from_numpy(base.coreset.weights)])):
        faults.append(f"{tag}: coreset differs from unsharded")
    n_model = shape[1] if len(shape) == 2 else 1
    if (r0["shards"], r0["model_shards"], r0["coreset_shards"]) != (
            shape[0], n_model, shape[0]):
        faults.append(f"{tag}: shards {r0['shards']}/{r0['model_shards']}"
                      f"/{r0['coreset_shards']} are not the mesh {shape}")
    bst = base.train.engine_stats
    if (r0["steps_per_epoch"], r0["gather_payload_bytes"]) != (
            bst.steps_per_epoch, bst.gather_payload_bytes):
        faults.append(f"{tag}: steps_per_epoch or payload bytes differ")
    per_epoch = lambda r: (r.steps / r.epochs, r.comm_bytes / r.epochs)
    if quant is None and (r0["epochs"], r0["steps"], r0["comm_bytes"]) != (
            base.train.epochs, base.train.steps, base.train.comm_bytes):
        faults.append(f"{tag}: epochs, steps or comm_bytes differ")
    if (r0["steps"] / r0["epochs"], r0["comm_bytes"] / r0["epochs"]) != \
            per_epoch(base.train):
        faults.append(f"{tag}: steps or comm_bytes an epoch differ")
    common = min(r0["epochs"], base.train.epochs)
    if quant is None:
        if not np.allclose(r0["losses"][:common],
                           base.train.losses[:common],
                           rtol=SHARDED_LOSS_RTOL, atol=SHARDED_LOSS_ATOL):
            faults.append(f"{tag}: losses beyond rtol {SHARDED_LOSS_RTOL}")
    else:
        wire = loss_rel_err(base.train.losses, f32.train.losses)
        err = loss_rel_err(r0["losses"], base.train.losses)
        if err > SHARDED_INT8_WIRE_FACTOR * wire + SHARDED_LOSS_RTOL:
            faults.append(f"{tag}: losses {err} apart, the wire's own "
                          f"effect is {wire}")
        if f32.metric - r0["metric"] > MAX_INT8_ACC_DROP:
            faults.append(f"{tag}: accuracy {r0['metric']} drops below "
                          f"f32's {f32.metric}")
    if abs(r0["metric"] - base.metric) > SHARDED_ACC:
        faults.append(f"{tag}: accuracy {r0['metric']} vs {base.metric}")
    k2 = "splitnn_bottom_gather" if quant is None else \
        "splitnn_bottom_int8_gather"
    k1 = "splitnn_bottom" if quant is None else "splitnn_bottom_int8"
    for rank, r in enumerate(runs):
        if r["host_syncs"] != r["epochs"]:
            faults.append(f"{tag}: rank {rank} synced {r['host_syncs']} "
                          f"times in {r['epochs']} epochs")
        want = {k2: r["steps"], k1: n_eval} | {
            k: base_launches[k] for k in ("psi_prf", "sorted_intersect",
                                          "kmeans_update", "kmeans_assign")}
        bad = {k: r["launches"][k] for k, n in want.items()
               if r["launches"][k] != n}
        if bad or any(base_launches[k] == 0 for k in want):
            faults.append(f"{tag}: rank {rank} launches {bad}, want "
                          f"{want}")
        if not r["k2_profiled"]:
            faults.append(f"{tag}: the profiler saw no {K2_MARK[quant]} on "
                          f"rank {rank}")
    return faults


def sharded_phase(dev, smi):
    """The HI treecss × mlp pipeline sharded over ranks (``mesh=``): 2
    ranks on ``("data",)``, 4 on (data 2, model 2) in f32 and under the
    int8 wire, and, where the host has 2 cards, 2 ranks over NCCL, one a
    card; each against the unsharded run on the card (``check_sharded``).
    The kernels were built once, here, before any rank starts; the ranks
    load the libraries and never build."""
    from repro_torch.launch.mesh import default_backend, run_ranks

    t_phase = time.perf_counter()
    tr, te = partitions()
    cfg = train_cfg("mlp", 0.01, tr.n_samples, 200)
    n_eval = -(-te.n_samples // 512)
    raw = lambda p: (p.client_features, p.labels, p.feature_slices)
    for quant in (None, "int8"):                  # untimed: first use
        drive_split(tr, te, dev, "treecss", train_cfg(
            "mlp", 0.01, tr.n_samples, 2), "kernel", quant=quant)
    base = {q: _unsharded_run(tr, te, dev, cfg, q) for q in (None, "int8")}
    worlds = [w + (default_backend(w[1]),) for w in SHARDED_WORLDS]
    if torch.cuda.device_count() >= 2:
        worlds.append(("nccl-data2", 2, (2,), (None,), "nccl"))
    rows, faults = [], []
    for name, n, shape, quants, backend in worlds:
        print(f"sharded: {name}: backend={backend} world={n} mesh={shape}",
              flush=True)
        t0 = time.perf_counter()
        per_rank = run_ranks(
            sharded_rank, n, (shape, quants, raw(tr), raw(te), cfg, SEED),
            backend=backend, timeout=SHARDED_TIMEOUT)
        world_s = time.perf_counter() - t0
        for i, quant in enumerate(quants):
            runs = [r[i] for r in per_rank]
            rep, launches, walls = base[quant]
            tag = f"sharded/{name}/{quant or 'f32'}"
            faults += check_sharded(tag, shape, runs, rep, launches, n_eval,
                                    base[None][0])
            r0 = runs[0]
            row = dict(
                phase="sharded", world=name, backend=backend, world_size=n,
                mesh=list(shape), quant=quant, nvidia_smi=smi,
                world_s=world_s, n_align=int(r0["intersection"].shape[0]),
                n_train=r0["n_train"], epochs=r0["epochs"],
                steps=r0["steps"], padded_batch=r0["padded_batch"],
                metric=r0["metric"], unsharded_metric=rep.metric,
                final_loss=float(r0["losses"][-1]),
                unsharded_final_loss=rep.train.losses[-1],
                max_loss_rel_err=loss_rel_err(r0["losses"],
                                              rep.train.losses),
                wire_loss_rel_err=loss_rel_err(rep.train.losses,
                                               base[None][0].train.losses),
                unsharded_walls=walls,
                per_rank=[dict(device=r["device"], walls=r["walls"],
                               collectives=r["collectives"],
                               host_staged=r["collectives"]["staged"] > 0,
                               launches={k: v for k, v in
                                         r["launches"].items() if v},
                               k2_profiled=r["k2_profiled"])
                          for r in runs])
            emit(row)
            rows.append(row)
    if torch.cuda.device_count() < 2:
        emit({"phase": "sharded_note", "nccl": "not run: the host has "
              f"{torch.cuda.device_count()} card", "nvidia_smi": smi})
    if faults:
        raise AssertionError("sharded: " + "; ".join(faults))
    rows.append({"phase": "sharded_total",
                 "phase_s": time.perf_counter() - t_phase})
    emit(rows[-1])
    return rows


# -------------------------------------------------------- llm_sharded phase

#: the LLM mesh phase: tinyllama-1.1b at full width, its depth cut to 4
#: layers (at 22, 209 s of a script that ran past its 1,200 s on a slow
#: host; every check a layer makes runs on each of the 4), and
#: olmoe-1b-7b at full width, its depth cut to 2 layers (16 layers' f32
#: params, grads and two moments, 6.9B × 16 B, exceed the card's 80 GB,
#: which the ranks share), on a (data 2, model 2) mesh of 4 gloo ranks on
#: the one card, profile "2d"
LLM_SHARDED_MESH = (2, 2)
LLM_SHARDED_DENSE_LAYERS = 4
LLM_SHARDED_STEPS = 3          # bf16 steps a run, two runs
LLM_SHARDED_TIMEOUT = 600      # seconds the world may take, spawn to join
LLM_SHARDED_RESIDENT = 0.30    # a rank's params + moments / the unsharded
LLM_SHARDED_BF16_RTOL = 1e-3   # first bf16 loss against the unsharded one
# bf16 gradient: × the unsharded one's distance from f32.  Measured worst
# 1.68× (embed: its gradient crosses 44 bf16 TP sums); a leaf on the wrong
# rank or dims is about its norm away, 73× for embed (the unsharded bf16
# embed gradient is 1.4% of its norm from the f32 one)
LLM_SHARDED_BF16_SLACK = 3.0
MOE_SHARDED_ARCH, MOE_SHARDED_LAYERS = "olmoe-1b-7b", 2
MOE_SHARDED_BATCH, MOE_SHARDED_SEQ = 2, 1024
MOE_DECODE_RTOL = 1e-4         # S = 1 logits: × (1 + max|logits|)


def _tree_bytes(tree) -> int:
    from repro_torch.train.optimizer import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _sharded_grad_gate(tag, lay, keys, grads, want, faults, allow=None):
    """Each sharded gradient leaf gathered whole (every rank takes part)
    against the unsharded one ``want`` holds on rank 0, within
    ``grad_gate``'s bounds or, where rank 0 gives them, within ``allow``
    (a distance a leaf): ({worst leaf, its distance over its bound} on
    rank 0, else None)."""
    ratios, rel = [], []
    norms = [float(w.double().norm()) for w in want] if want else None
    if want is not None and allow is None:
        top = max(norms)
        allow = [TRAIN_GRAD_RTOL * n + TRAIN_GRAD_FLOOR * top for n in norms]
    for i, (k, g) in enumerate(zip(keys, grads)):
        whole = lay.whole(lay.specs[k], g)
        if want is not None:
            d = float((whole.double() - want[i].double()).norm())
            ratios.append(d / allow[i])
            rel.append(d / max(norms[i], 1e-300))
        del whole
    if want is None:
        return None
    worst = int(np.argmax(ratios))
    if ratios[worst] > 1.0:
        faults.append(f"{tag}: leaf {keys[worst]} gradient {ratios[worst]}"
                      "× its bound from the unsharded one")
    return dict(worst_leaf=keys[worst], worst_leaf_rel_err=rel[worst],
                worst_leaf_of_bound=ratios[worst], leaves=len(keys))


def _count_now():
    from repro_torch import sharding
    from repro_torch.kernels.build import LAUNCHES
    torch.cuda.synchronize()
    return ({k: v for k, v in LAUNCHES.items() if v},
            dict(sharding.COLLECTIVES))


def _reset_counts():
    from repro_torch import sharding
    from repro_torch.kernels.build import reset_launches
    torch.cuda.synchronize()
    reset_launches()
    sharding.reset_collectives()


def llm_sharded_dense(device, mesh, faults):
    """tinyllama-1.1b (``LLM_SHARDED_DENSE_LAYERS`` layers) on ``mesh``:
    the f32 loss and gradients against the
    unsharded ones (rank 0 computes those on the card first), then the
    config's bf16 steps, twice, under the count, the clock and the
    profiler.  Returns this rank's row."""
    import dataclasses
    import gc

    import torch.distributed as dist

    from repro_torch import sharding
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.train.steps import (init_train_state, loss_and_grads,
                                         make_train_step)

    rank = dist.get_rank()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              n_layers=LLM_SHARDED_DENSE_LAYERS)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    batch = train_batch(cfg, device, TRAIN_BATCH, TRAIN_SEQ)
    want_launches = k11_launches(cfg)
    row = dict(rank=rank, device=str(device))

    f32, want, loss_u = _f32_gate(f"{TRAIN_ARCH} f32", cfg32, mesh, device,
                                  batch, faults, want_launches)
    row.update(f32)

    # the config's bf16 compute on the same f32 master params: the first
    # gradient, gathered whole, no more than LLM_SHARDED_BF16_SLACK times
    # as far from the f32 one as the unsharded bf16 gradient is
    allow = loss16 = None
    if rank == 0:
        params = api.init_params(SEED, cfg, device=device)
        loss16, _, g16 = loss_and_grads(params, cfg, batch)
        top = max(float(w.double().norm()) for w in want)
        allow = [LLM_SHARDED_BF16_SLACK * float((g.double() - w.double())
                                                .norm())
                 + TRAIN_GRAD_FLOOR * top for g, w in zip(g16, want)]
        row["bf16_unsharded_first_loss"] = float(loss16)
        del params, g16
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    with sharding.use_mesh(mesh):
        lay = sharding.lm_layout(cfg)
        params = lay.shard(api.init_params(SEED, cfg, device=device))
        keys = [k for k, _ in sharding.flat_tree(params)]
        t0 = time.perf_counter()
        loss_s, _, grads = loss_and_grads(params, cfg, batch)
        row["bf16_grad_ms"] = (time.perf_counter() - t0) * 1e3
        gate = _sharded_grad_gate(f"{TRAIN_ARCH} bf16", lay, keys, grads,
                                  want, faults, allow)
        if rank == 0:
            row["bf16"] = dict(gate, loss_sharded=float(loss_s),
                               loss_unsharded=float(loss16),
                               loss_f32=float(loss_u))
        del params, grads, want
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()

    def run(profiled=False):
        """LLM_SHARDED_STEPS steps from the seed; with ``profiled`` the
        last one under the profiler, which must see K11's forward and
        backward kernels on every rank (a session may record none: that
        step is then timed again unprofiled and the next one profiled,
        up to 3 more)."""
        with sharding.use_mesh(mesh):
            params, opt = init_train_state(SEED, cfg, device=device)
            step = make_train_step(cfg, lr=TRAIN_LR)
            losses, ms, counts, prof = [], [], [], None
            for i in range(LLM_SHARDED_STEPS):
                _reset_counts()
                t0 = time.perf_counter()
                if profiled and i == LLM_SHARDED_STEPS - 1:
                    out = []
                    prof = profile_device(lambda: out.append(
                        step(params, opt, batch)), reps=1, warm=False)
                    params, opt, m = out[0]
                else:
                    params, opt, m = step(params, opt, batch)
                counts.append(_count_now())
                ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(m["loss"].item())
        return params, opt, losses, ms, counts, prof

    torch.cuda.reset_peak_memory_stats()
    first = run()
    row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    second = run(profiled=True)
    params, opt = second[:2]
    resident = _tree_bytes((params, opt.mu, opt.nu))
    whole = 3 * 4 * sum(int(np.prod(s)) for _, s in sharding.flat_tree(
        api.param_shapes(cfg)))
    row["resident_gb"] = resident / 1e9
    row["resident_share"] = resident / whole
    if resident / whole > LLM_SHARDED_RESIDENT:
        faults.append(f"rank {rank} holds {resident / whole:.3f} of the "
                      "unsharded params and moments")
    per_name, dev_ms, wall_ms = second[5]
    seen = sorted({k for k in per_name if "flash_attention" in k})
    if not _every_rank(any("bwd" in k for k in seen)
                       and any("bwd" not in k for k in seen), device):
        with sharding.use_mesh(mesh):   # a session may record no kernel
            step = make_train_step(cfg, lr=TRAIN_LR)
            for _ in range(3):
                per_name, dev_ms, wall_ms = profile_device(
                    lambda: step(params, opt, batch), reps=1, warm=False)
                seen = sorted({k for k in per_name if "flash_attention" in k})
                if _every_rank(any("bwd" in k for k in seen)
                               and any("bwd" not in k for k in seen),
                               device):
                    break
    row["profiled_k11"] = seen
    if not (any("bwd" in k for k in seen)
            and any("bwd" not in k for k in seen)):
        faults.append(f"rank {rank}: the profiler saw no K11 forward and "
                      f"backward ({seen})")
    row["profile"] = dict(device_ms=dev_ms, wall_ms=wall_ms)
    losses = [first[2], second[2]]
    bits = [np.asarray(l, np.float32).view(np.int32).tolist()
            for l in losses]
    row["bf16_losses"] = losses[0]
    row["bf16_losses_bitwise_equal"] = bits[0] == bits[1]
    row["step_ms"] = first[3] + second[3]     # the last one profiled
    row["step_launches"] = first[4][0][0]
    row["step_collectives"] = first[4][-1][1]
    if bits[0] != bits[1]:
        faults.append(f"rank {rank}: bf16 losses differ between two runs: "
                      f"{losses}")
    if not losses[0][-1] < losses[0][0]:
        faults.append(f"rank {rank}: bf16 loss did not fall: {losses[0]}")
    first_loss = row.get("bf16_unsharded_first_loss")
    if first_loss is not None and not abs(losses[0][0] - first_loss) <= \
            LLM_SHARDED_BF16_RTOL * abs(first_loss):
        faults.append(f"bf16 first loss {losses[0][0]} vs unsharded "
                      f"{first_loss}")
    for launches, _ in first[4] + second[4]:
        if launches != want_launches:
            faults.append(f"rank {rank}: a bf16 step launched {launches}, "
                          f"not {want_launches}")
            break
    del params, opt, first, second
    gc.collect()
    torch.cuda.empty_cache()
    return row


def llm_sharded_moe(device, mesh, faults):
    """olmoe-1b-7b at full width, 2 layers, f32, on ``mesh``: one loss and
    gradient with the capacity factor raised until no token drops
    against the unsharded one (rank 0), at S (scheme A's two
    ``all_to_all``s) and at S - 1, which ``model`` does not divide
    (scheme B: each rank its experts, their inputs' gradients summed);
    the config's own capacity factor (finite, aux recorded); a
    ``forward_lm`` at S = 1 (scheme B) against the unsharded one at this
    rank's rows.  Returns this rank's row."""
    import dataclasses
    import gc

    import torch.distributed as dist

    from repro_torch import sharding
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.models.transformer import forward_lm
    from repro_torch.train.steps import loss_and_grads

    rank = dist.get_rank()
    base = dataclasses.replace(get_config(MOE_SHARDED_ARCH),
                               n_layers=MOE_SHARDED_LAYERS, dtype="float32")
    nodrop = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=base.moe.num_experts / base.moe.top_k))
    batch = train_batch(base, device, MOE_SHARDED_BATCH, MOE_SHARDED_SEQ)
    tokens1 = batch["tokens"][:, :1]
    # a sequence that model does not divide: scheme B under training
    odd = {k: v[:, :MOE_SHARDED_SEQ - 1] if k in ("tokens", "labels")
           else v for k, v in batch.items()}
    row = dict(rank=rank)
    params = api.init_params(SEED, base, device=device)
    with torch.no_grad():       # scheme B's yardstick: the whole model
        want1 = forward_lm(params, base, tokens1, remat=False)[0]
    want = loss_u = want_b = loss_ub = None
    if rank == 0:
        loss_u, _, want = loss_and_grads(params, nodrop, batch)
        loss_ub, _, want_b = loss_and_grads(params, nodrop, odd)
    dist.barrier()
    with sharding.use_mesh(mesh):
        lay = sharding.lm_layout(nodrop)
        blocks = lay.shard(params)
        del params
        gc.collect()
        keys = [k for k, _ in sharding.flat_tree(blocks)]
        _reset_counts()
        t0 = time.perf_counter()
        loss_s, (_, aux_s), grads = loss_and_grads(blocks, nodrop, batch)
        launches, coll = _count_now()
        row.update(nodrop_ms=(time.perf_counter() - t0) * 1e3,
                   nodrop_loss=float(loss_s), nodrop_aux=float(aux_s),
                   nodrop_launches=launches, nodrop_collectives=coll)
        gate = _sharded_grad_gate(f"{MOE_SHARDED_ARCH} no drops", lay, keys,
                                  grads, want, faults)
        if rank == 0:
            err = abs(float(loss_s) - float(loss_u)) / abs(float(loss_u))
            row["nodrop"] = dict(gate, loss_sharded=float(loss_s),
                                 loss_unsharded=float(loss_u),
                                 loss_rel_err=err)
            if not err <= TRAIN_LOSS_RTOL:
                faults.append(f"olmoe loss {float(loss_s)} vs unsharded "
                              f"{float(loss_u)}")
        del grads, want
        gc.collect()
        _reset_counts()
        t0 = time.perf_counter()
        loss_s, _, grads = loss_and_grads(blocks, nodrop, odd)
        _, coll = _count_now()
        row.update(odd_ms=(time.perf_counter() - t0) * 1e3,
                   odd_collectives=coll)
        gate = _sharded_grad_gate(
            f"{MOE_SHARDED_ARCH} scheme B, S {MOE_SHARDED_SEQ - 1}, no "
            "drops", lay, keys, grads, want_b, faults)
        if rank == 0:
            err = abs(float(loss_s) - float(loss_ub)) / abs(float(loss_ub))
            row["nodrop_odd"] = dict(gate, seq=MOE_SHARDED_SEQ - 1,
                                     loss_sharded=float(loss_s),
                                     loss_unsharded=float(loss_ub),
                                     loss_rel_err=err)
            if not err <= TRAIN_LOSS_RTOL:
                faults.append(f"olmoe S {MOE_SHARDED_SEQ - 1} loss "
                              f"{float(loss_s)} vs unsharded "
                              f"{float(loss_ub)}")
        del grads, want_b
        gc.collect()
        lay = sharding.lm_layout(base)
        loss_c, (ce_c, aux_c), grads = loss_and_grads(blocks, base, batch)
        finite = bool(np.isfinite(float(loss_c)) and all(
            bool(torch.isfinite(g).all()) for g in grads))
        row.update(config_cf=base.moe.capacity_factor,
                   config_loss=float(loss_c), config_ce=float(ce_c),
                   config_aux=float(aux_c), config_finite=finite)
        if not finite:
            faults.append(f"rank {rank}: olmoe at its capacity factor is "
                          "not finite")
        del grads
        rows = lay.rows(tokens1.shape[0])
        with torch.no_grad():
            got1 = forward_lm(blocks, base, tokens1[rows], remat=False)[0]
        err = float((got1 - want1[rows]).abs().max())
        scale = 1.0 + float(want1.abs().max())
        row.update(decode_max_abs_err=err, decode_scale=scale)
        if not err <= MOE_DECODE_RTOL * scale:
            faults.append(f"rank {rank}: olmoe S = 1 logits {err} from the "
                          f"unsharded ({MOE_DECODE_RTOL}·{scale})")
    del blocks
    gc.collect()
    torch.cuda.empty_cache()
    return row


#: hymba-1.5b at full width on (2, 2): 4 layers (its global layer 0 and
#: three windowed layers), B 2 × S 2,048 (2,176 rows with the 128 meta
#: tokens); its 25 q heads do not divide model = 2, so attention runs
#: context-parallel: model rank 0 its q rows 0…1,087 against keys
#: 0…1,087, rank 1 rows 1,088…2,175 against all 2,176 keys
HYMBA_SHARDED_ARCH, HYMBA_SHARDED_LAYERS = "hymba-1.5b", 4
HYMBA_CP_SQ, HYMBA_CP_SK = 1088, (1088, 2176)
#: (arch, layers, decoder tokens): one f32 step each at full width
GENERIC_SHARDED = (("mamba2-1.3b", 2, 2048), ("internvl2-1b", 2, 2048),
                   ("whisper-large-v3", 2, 448))


def k11_launches(cfg):
    """K11's forward and backward launches in one training forward and
    backward of ``cfg`` under remat (each attention layer's forward
    twice), the kernels that launch at all."""
    n = attention_layers(cfg)
    return {k: v for k, v in (("flash_attention", 2 * n),
                              ("flash_attention_bwd", n)) if v}


def _f32_gate(tag, cfg, mesh, device, batch, faults, want_launches):
    """One f32 loss and gradient of ``cfg`` on ``mesh`` against the
    unsharded one (rank 0 computes that on the card first): the loss
    within ``TRAIN_LOSS_RTOL``, each gradient leaf gathered whole within
    ``grad_gate``'s bounds (``_sharded_grad_gate``), the kernels
    launched as ``want_launches`` says.  Returns (this rank's row: the
    step's ms, launches, collectives, peak GB and kept leaves, on rank 0
    the gate; on rank 0 the unsharded gradient leaves and loss, else
    None, None)."""
    import gc

    import torch.distributed as dist

    from repro_torch import sharding
    from repro_torch.models import api
    from repro_torch.train.steps import loss_and_grads

    rank = dist.get_rank()
    want = loss_u = None
    if rank == 0:
        params = api.init_params(SEED, cfg, device=device)
        loss_u, _, want = loss_and_grads(params, cfg, batch)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    row = {}
    with sharding.use_mesh(mesh):
        lay = sharding.lm_layout(cfg)
        params = lay.shard(api.init_params(SEED, cfg, device=device))
        keys = [k for k, _ in sharding.flat_tree(params)]
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        loss_s, _, grads = loss_and_grads(params, cfg, batch)
        launches, coll = _count_now()
        row.update(f32_ms=(time.perf_counter() - t0) * 1e3,
                   f32_loss=float(loss_s), f32_launches=launches,
                   f32_collectives=coll,
                   f32_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   kept=sorted(lay._kept.get("layers", ({}, set()))[1]
                               | lay._kept.get("dec_layers", ({}, set()))[1]))
        if launches != want_launches:
            faults.append(f"rank {rank}: {tag} gradient launched "
                          f"{launches}, not {want_launches}")
        gate = _sharded_grad_gate(tag, lay, keys, grads, want, faults)
        if rank == 0:
            err = abs(float(loss_s) - float(loss_u)) / abs(float(loss_u))
            row["f32"] = dict(gate, loss_sharded=float(loss_s),
                              loss_unsharded=float(loss_u),
                              loss_rel_err=err)
            if not err <= TRAIN_LOSS_RTOL:
                faults.append(f"{tag}: f32 loss {float(loss_s)} vs "
                              f"unsharded {float(loss_u)}")
        del params, grads
        gc.collect()
        torch.cuda.empty_cache()
    return row, want, loss_u


def _k11_held(kept, faults, tag, device):
    """The kept K11 launches of a context-parallel rank (``kept_calls``'
    {"fwd": ..., "bwd": ...}) against their plain versions on the same
    inputs: the forward's output within one bf16 ulp (2^-7·|plain| +
    1e-6), the backward's dq/dk/dv within ``flash_bwd_row``'s bf16 bound
    (2^-7·|plain| + 1e-4·max|plain|); each launch timed alone (CUDA
    events, median of 5).  Returns its rows."""
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_cuda, flash_attention_cuda)

    dev = lambda ts: tuple(t.to(device) for t in ts)
    rows = []
    for n, (args, kw, out) in sorted(kept["fwd"].items()):
        (q, k, v), out = dev(args), dev(out)
        mask = {x: kw[x] for x in ("causal", "window", "prefix",
                                   "logit_cap")}
        want = fa_ref.flash_attention(q, k, v, **mask).float()
        d = (out[0].float() - want).abs()
        if bool((d > BF16_ULP * want.abs() + 1e-6).any()):
            faults.append(f"{tag}: K11 forward launch {n} (Sq {q.shape[1]}"
                          f", Sk {k.shape[1]}) {float(d.max())} off plain")
        rows.append(dict(kernel="flash_attention", launch=n,
                         sq=q.shape[1], sk=k.shape[1], **mask,
                         max_abs_err=float(d.max()),
                         ms=cuda_ms(lambda: flash_attention_cuda(
                             q, k, v, **mask), reps=5)))
        del want, d
    for n, (args, kw, out) in sorted(kept["bwd"].items()):
        (q, k, v, o, do, lse), out = dev(args), dev(out)
        mask = {x: kw[x] for x in ("causal", "window", "prefix",
                                   "logit_cap")}
        want = fa_ref.flash_attention_bwd(q, k, v, o, do, **mask)
        err = 0.0
        for name, x, w in zip(("dq", "dk", "dv"), out, want):
            w = w.float()
            d = (x.float() - w).abs()
            err = max(err, float(d.max()))
            if bool((d > BF16_ULP * w.abs()
                     + 1e-4 * float(w.abs().max())).any()):
                faults.append(f"{tag}: K11 backward launch {n} {name} "
                              f"(Sq {q.shape[1]}, Sk {k.shape[1]}) "
                              f"{float(d.max())} off plain")
        rows.append(dict(kernel="flash_attention_bwd", launch=n,
                         sq=q.shape[1], sk=k.shape[1], **mask,
                         max_abs_err=err,
                         ms=cuda_ms(lambda: flash_attention_bwd_cuda(
                             q, k, v, o, do, lse, **mask), reps=5)))
        del want
    return rows


def llm_sharded_hymba(device, mesh, faults):
    """hymba-1.5b at full width, ``HYMBA_SHARDED_LAYERS`` layers, B 2 × S
    2,048, on ``mesh``: attention context-parallel (its 25 heads do not
    divide model; each model rank its 1,088 q rows, keys to the block's
    end), the Mamba mixer on 25 of its 50 SSM heads, the MLP on half its
    d_ff.  The f32 loss and gradients against the unsharded ones
    (``_f32_gate``); the config's bf16 steps, 3 from the seed twice, the
    losses bitwise across the runs, the first run's steps counted (K11
    8 forward + 4 backward launches a step a rank: 2 + 1 a layer under
    remat), each K11 launch's (Sq, Sk) recorded, the collectives, ms
    and peak GB a step; a windowed layer's K11 forward and backward
    launch of the first step kept and held against the plain versions,
    and timed alone on each rank in turn.  Returns this rank's row."""
    import dataclasses
    import gc

    import torch.distributed as dist

    from repro_torch import sharding
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import layer_windows
    from repro_torch.train.steps import init_train_state, make_train_step

    rank = dist.get_rank()
    cfg = dataclasses.replace(get_config(HYMBA_SHARDED_ARCH),
                              n_layers=HYMBA_SHARDED_LAYERS)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    batch = train_batch(cfg, device, TRAIN_BATCH, TRAIN_SEQ)
    row = dict(rank=rank, layers=cfg.n_layers, windows=layer_windows(cfg))
    want = k11_launches(cfg)
    f32, _, _ = _f32_gate(f"{HYMBA_SHARDED_ARCH} f32", cfg32, mesh, device,
                          batch, faults, want)
    row.update(f32)
    dist.barrier()

    def run(spy=None):
        with sharding.use_mesh(mesh):
            params, opt = init_train_state(SEED, cfg, device=device)
            step = make_train_step(cfg, lr=TRAIN_LR)
            losses, ms, counts = [], [], []
            for i in range(LLM_SHARDED_STEPS):
                _reset_counts()
                t0 = time.perf_counter()
                if spy is not None and i == 0:
                    with spy[0] as kf, spy[1] as kb:
                        params, opt, m = step(params, opt, batch)
                    kept.update(fwd=kf, bwd=kb)
                else:
                    params, opt, m = step(params, opt, batch)
                counts.append(_count_now())
                ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(m["loss"].item())
        del params, opt
        gc.collect()
        torch.cuda.empty_cache()
        return losses, ms, counts

    # forward launches 0 and 2 (the global layer 0, windowed layer 2) and
    # backward launches 0 and 2 (windowed layers 3 and 1: the recompute
    # and the backward walk the layers from the last)
    from repro_torch.kernels.flash_attention import ops as fa_ops
    shapes, kept = {"fwd": [], "bwd": []}, {}
    spy = (kept_calls(fa_ops, "flash_attention_cuda", (0, 2),
                      shapes["fwd"]),
           kept_calls(fa_ops, "flash_attention_bwd_cuda", (0, 2),
                      shapes["bwd"]))
    torch.cuda.reset_peak_memory_stats()
    first = run(spy)
    row["bf16_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    second = run()
    bits = [np.asarray(r[0], np.float32).view(np.int32).tolist()
            for r in (first, second)]
    row.update(bf16_losses=first[0], bf16_losses_bitwise_equal=bits[0]
               == bits[1], step_ms=first[1] + second[1],
               step_launches=first[2][0][0],
               step_collectives=first[2][0][1],
               k11_fwd_sq_sk=[(a[0][1], a[1][1]) for a in shapes["fwd"]],
               k11_bwd_sq_sk=[(a[0][1], a[1][1]) for a in shapes["bwd"]])
    if bits[0] != bits[1]:
        faults.append(f"rank {rank}: hymba bf16 losses differ between two "
                      f"runs: {first[0]}, {second[0]}")
    for launches, _ in first[2] + second[2]:
        if launches != want:
            faults.append(f"rank {rank}: a hymba bf16 step launched "
                          f"{launches}, not {want}")
            break
    m = sharding.mesh_axis(mesh, "model")
    sk = HYMBA_CP_SK[m.rank]
    ran = set(row["k11_fwd_sq_sk"] + row["k11_bwd_sq_sk"])
    if ran != {(HYMBA_CP_SQ, sk)}:
        faults.append(f"rank {rank}: K11 ran at (Sq, Sk) {sorted(ran)}, "
                      f"not ({HYMBA_CP_SQ}, {sk})")
    # each rank in turn holds and times its kept launches, the card free
    # of the others' work
    for r in range(dist.get_world_size()):
        if r == rank:
            row["k11_held"] = _k11_held(kept, faults, f"rank {rank}",
                                        device)
        dist.barrier()
    del kept
    gc.collect()
    torch.cuda.empty_cache()
    return row


def llm_sharded_generic(device, mesh, faults):
    """mamba2-1.3b, internvl2-1b and whisper-large-v3 at full width, 2
    layers (whisper: 2 encoder and 2 decoder layers, 448 decoder tokens
    over its 1,500 frames), B 2, f32, on ``mesh``: one loss and gradient
    each against the unsharded one (``_f32_gate``): the Mamba mixer on
    32 of its 64 SSM heads; internvl2's attention on 7 of its 14 q heads
    and its MLP on half its d_ff; whisper's self- and cross-attention on
    10 of their 20 heads, its GELU MLPs on half their d_ff.  Returns
    this rank's rows."""
    import dataclasses

    from repro_torch.configs import get_config

    rows = {}
    for arch, layers, seq in GENERIC_SHARDED:
        cfg = get_config(arch)
        over = dict(n_layers=layers, dtype="float32")
        if cfg.family == "audio":
            over["enc_layers"] = layers
        cfg = dataclasses.replace(cfg, **over)
        batch = train_batch(cfg, device, TRAIN_BATCH, seq)
        row, _, _ = _f32_gate(f"{arch} f32", cfg, mesh, device, batch,
                              faults, k11_launches(cfg))
        rows[arch] = dict(row, layers=layers, seq=seq)
    return rows


def llm_sharded_rank(device, shape, profile, parts):
    """One rank of the LLM mesh phase: ``parts`` ("dense", "moe") on a
    ``shape`` mesh over the world under ``profile``.  Returns (rows,
    faults); the phase raises on any rank's fault."""
    from repro_torch import sharding
    from repro_torch.launch.mesh import make_train_mesh

    sharding.set_profile(profile)
    mesh = make_train_mesh(*shape)
    faults, rows = [], {}
    for part, fn in (("dense", llm_sharded_dense), ("moe", llm_sharded_moe),
                     ("hymba", llm_sharded_hymba),
                     ("generic", llm_sharded_generic)):
        if part in parts:
            t0 = time.perf_counter()
            rows[part] = fn(device, mesh, faults)
            rows[part + "_s"] = time.perf_counter() - t0
    return rows, faults


def llm_sharded_phase(dev, smi):
    """LLM training on a (data, model) mesh: tinyllama-1.1b (full width,
    4 layers) and olmoe-1b-7b (full width, 2 layers) on 4 gloo ranks on
    the one card, (2, 2), profile "2d" (``llm_sharded_rank``); where the
    host has 2 or more cards, tinyllama again over NCCL, one rank a
    card.  K11 was built here, before any rank starts; the ranks load
    it.  Every number a rank reports is gloo staged through host memory
    on one card unless the row says NCCL."""
    import gc

    from repro_torch.launch.mesh import default_backend, run_ranks

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    worlds = [("gloo-2x2", 4, LLM_SHARDED_MESH,
               ("dense", "moe", "hymba", "generic"), default_backend(4))]
    n = torch.cuda.device_count()
    if n >= 2:
        shape = (2, 2) if n >= 4 else (1, 2)
        worlds.append((f"nccl-{shape[0]}x{shape[1]}", shape[0] * shape[1],
                       shape, ("dense",), "nccl"))
    out, faults = [], []
    for name, world, shape, parts, backend in worlds:
        print(f"llm_sharded: {name}: backend={backend} world={world} "
              f"mesh={shape} profile=2d", flush=True)
        t0 = time.perf_counter()
        per_rank = run_ranks(llm_sharded_rank, world,
                             (shape, "2d", parts), backend=backend,
                             timeout=LLM_SHARDED_TIMEOUT)
        row = dict(phase="llm_sharded", world=name, backend=backend,
                   world_size=world, mesh=list(shape), profile="2d",
                   staged_through_host=backend == "gloo",
                   nvidia_smi=smi, world_s=time.perf_counter() - t0)
        for part in parts:
            row[part] = [r[0][part] for r in per_rank]
            row[part + "_s"] = [r[0][part + "_s"] for r in per_rank]
        for r in per_rank:
            faults += [f"{name}: {f}" for f in r[1]]
        emit(row)
        out.append(row)
    if n < 2:
        emit({"phase": "llm_sharded_note", "nccl": "not run: the host has "
              f"{n} card", "nvidia_smi": smi})
    total = {"phase": "llm_sharded_total",
             "phase_s": time.perf_counter() - t_phase}
    emit(total)
    if faults:
        raise AssertionError("llm_sharded: " + "; ".join(faults))
    return out + [total]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree

def kmeans_ptxas(report: str, pattern: str, label):
    """The k-means kernels' instances in a ``-Xptxas -v`` report: {"K3
    D=30": "40 registers, 0+0 spill bytes", ...} (D=0: the instance that
    reads the width at run time), and the instances that spill.  An entry
    function whose name matches ``pattern`` is named ``label(match)``."""
    out, spills, name = {}, [], None
    for ln in report.splitlines():
        hit = re.search(pattern, ln)
        if "entry function" in ln:
            name = hit and label(hit)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
        if name and spill:
            out[name] = f"{spill[1]}+{spill[2]} spill bytes"
            if spill[1] != "0" or spill[2] != "0":
                spills.append(name)
        regs = re.search(r"Used (\d+) registers", ln)
        if name and regs:
            out[name] = f"{regs[1]} registers, " + out.get(name, "")
    return out, spills


def spilled(report: str):
    """The kernel instances of a ``-Xptxas -v`` report that spill."""
    out, name = [], None
    for ln in report.splitlines():
        hit = re.search(r"entry function '([^']+)'", ln)
        if hit:
            name = hit[1]
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
        if name and spill and (spill[1] != "0" or spill[2] != "0"):
            out.append(name)
    return out


#: the reference's own contract: its ``pallas_calls`` of each program
#: (structural: a kernel in a loop counts once), under ``+pallas`` where
#: the port says ``+kernel``
REFERENCE_CONTRACT = os.path.join(ROOT, "experiments", "bench",
                                  "static_contract.json")

#: the port's kernel launches a call, and a step where the program loops,
#: of each single-device program on the card (the ``+kernel`` rows on the
#: kernels; the ``+ref`` rows take the plain versions everywhere)
ANALYSIS_LAUNCHES = {
    "psi.prf": ({"psi_prf": 1}, {}),
    "psi.merge": ({"sorted_intersect": 1}, {}),
    "psi.single": ({"psi_prf": 1, "sorted_intersect": 1}, {}),
    "psi.union": ({"sorted_intersect": 1}, {}),
    "serve.score.lr+ref": ({}, {}),
    "serve.score.lr-int8+ref": ({}, {}),
    "serve.score.mlp+kernel": ({"splitnn_bottom": 1}, {}),
    "serve.score.mlp-int8+kernel": ({"splitnn_bottom_int8": 1}, {}),
    "train.epoch.lr+ref": ({}, {}),
    "train.epoch.lr-int8+ref": ({}, {}),
    "train.epoch.lr-fp8+ref": ({}, {}),
    "train.epoch.mlp+kernel": ({"splitnn_bottom_gather": 1},
                               {"splitnn_bottom_gather": 1}),
    "train.epoch.mlp-int8+kernel": ({"splitnn_bottom_int8_gather": 1},
                                    {"splitnn_bottom_int8_gather": 1}),
    "kmeans.fit+ref": ({}, {}),
    "kmeans.fit+kernel": ({"kmeans_update": 1, "kmeans_assign": 1},
                          {"kmeans_update": 1}),
}

#: the reference's PRF calls that one launch stands for: K6 tags both
#: sides of every pair in one launch over 2B rows, where the reference
#: makes one call a side; every other launch stands for one call
REFERENCE_CALLS_A_LAUNCH = {"psi_prf": 2}


def reference_pallas_calls() -> dict:
    """{engine: pallas_calls} of the reference's single-device rows."""
    with open(REFERENCE_CONTRACT) as f:
        rows = json.load(f)["rows"]
    return {r["engine"].replace("+pallas", "+kernel"):
            r["counters"]["pallas_calls"] for r in rows if r["mesh"] == "1"}


def ptxas_static_smem(report: str) -> dict:
    """{entry function: static shared memory in bytes} of a ``-Xptxas -v``
    report (no "bytes smem" on its line: 0)."""
    out, name = {}, None
    for ln in report.splitlines():
        hit = re.search(r"entry function '([^']+)'", ln)
        if hit:
            name = hit[1]
        if name and re.search(r"Used \d+ registers", ln):
            smem = re.search(r"(\d+) bytes smem", ln)
            out[name] = int(smem[1]) if smem else 0
    return out


def analysis_census(dev):
    """The census of every single-device program of the gate
    (``repro_torch.analysis.check``) on the card, the ``+kernel`` rows on
    the kernels: kernel launches a call (and a step) against the
    reference's ``pallas_calls``, zero host syncs inside a train step
    (also read by ``torch.cuda.set_sync_debug_mode``) and exactly the
    epoch's one outside them, zero f64, and the contract's counters."""
    from repro_torch.analysis import check
    from repro_torch.analysis.contracts import diff_rows, load_contract
    rows = check.census_rows(dev, {"1": None}, sync_debug=True)
    reference = reference_pallas_calls()
    faults, out = [], []
    for (engine, mesh), c in sorted(rows.items()):
        want, want_loop = ANALYSIS_LAUNCHES[engine]
        pallas = reference[engine]
        got = {k: v for k, v in c.kernel_launches.items() if v}
        calls = sum(n * REFERENCE_CALLS_A_LAUNCH.get(k, 1)
                    for k, n in got.items())
        if got != want or calls != pallas:
            faults.append(f"{engine}: launches {got} ({calls} reference "
                          f"calls), want {want} (the reference's "
                          f"pallas_calls {pallas})")
        if c.kernel_launches_in_loop != want_loop:
            faults.append(f"{engine}: launches a step "
                          f"{c.kernel_launches_in_loop}, want {want_loop}")
        if c.f64_values or c.f64_widenings:
            faults.append(f"{engine}: f64 in the program")
        if c.host_syncs_in_loop or c.sync_warnings_in_loop:
            faults.append(f"{engine}: host syncs inside a step "
                          f"({c.host_syncs_in_loop} counted, "
                          f"{c.sync_warnings_in_loop} sync warnings)")
        if engine.startswith("train.") and c.round_syncs != 1:
            faults.append(f"{engine}: {c.round_syncs} syncs an epoch "
                          "outside the steps, want the epoch's one")
        out.append(dict(engine=engine, mesh=mesh, launches=got,
                        launches_a_step=c.kernel_launches_in_loop,
                        reference_calls=calls, pallas_calls=pallas,
                        steps=c.steps,
                        host_syncs=c.host_syncs,
                        host_syncs_in_step=c.host_syncs_in_loop,
                        epoch_syncs=c.round_syncs,
                        sync_warnings=c.sync_warnings,
                        sync_warnings_in_step=c.sync_warnings_in_loop,
                        f64=c.f64_values + c.f64_widenings))
    contract = {k: v for k, v in load_contract(check.DEFAULT_CONTRACT,
                                               check.KEY).items()
                if k[1] == "1"}
    diff_rows(contract, check.pinned({k: c.counters()
                                      for k, c in rows.items()}),
              "the card's census", faults)
    return out, faults


def analysis_block_row(dev, rng, r):
    """Launch one ``ok`` row of ``smem_report`` at its shape and hold the
    kernel against its plain version; returns its max abs error."""
    from repro_torch.kernels.kmeans_assign.kernel import kmeans_assign_cuda
    from repro_torch.kernels.kmeans_update import ref as ku_ref
    from repro_torch.kernels.kmeans_update.kernel import (
        kmeans_update_cuda, kmeans_update_gather_cuda)
    from repro_torch.kernels.psi_prf import ref as prf_ref
    from repro_torch.kernels.psi_prf.kernel import prf_tags_cuda
    from repro_torch.kernels.sorted_intersect import ref as si_ref
    from repro_torch.kernels.sorted_intersect.kernel import \
        sorted_intersect_cuda
    from repro_torch.kernels.splitnn_bottom import kernel as sbk
    from repro_torch.kernels.splitnn_bottom import ref as sb_ref
    from repro_torch.kernels.splitnn_bottom.ops import int8_rows

    kernel, p = r["kernel"], r["params"]
    tag = f"analysis {kernel} [{r['shape']}]"
    f32 = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(dev)
    if kernel.startswith("splitnn_bottom"):
        m, n, d, o = p["m"], p["n"], p["d"], p["o"]
        x, w, b = f32(m, n, d), f32(m, d, o), f32(m, o)
        idx = (torch.from_numpy(rng.integers(0, n, p["b"]).astype(
            np.int32)).to(dev) if "b" in p else None)
        if p["quant"] == "int8":
            xq, sx = int8_rows(x)
            got = (sbk.splitnn_bottom_int8_wire_cuda(x, w, b, True)[0]
                   if idx is None else
                   sbk.splitnn_bottom_int8_wire_gather_cuda(
                       idx, xq, sx, w, b, True)[0])
            want = sb_ref.splitnn_bottom_int8_wire(xq, sx, w, b, True,
                                                   idx)[0]
            differ(tag, "the wire values of the kernel and the plain "
                   "composition", got, want)
            return 0.0
        got = (sbk.splitnn_bottom_cuda(x, w, b, True) if idx is None
               else sbk.splitnn_bottom_gather_cuda(idx, x, w, b, True))
        xs = x if idx is None else x.index_select(1, idx)
        want = sb_ref.splitnn_bottom(xs, w, b, True)
        scale = torch.bmm(xs.abs(), w.abs()) + b.abs()[:, None, :]
        return check_close(tag, got, want, scale, rtol=1e-5, atol=1e-6)
    if kernel.startswith("kmeans"):
        m, n, d, k = p["m"], p["n"], p["d"], p["k"]
        pts = f32(m, n, d)
        cents = pts[:, :k].contiguous()
        if kernel == "kmeans_assign":
            return check_assign(tag, pts, cents,
                                kmeans_assign_cuda(pts, cents))[0]
        if kernel == "kmeans_update":
            return check_update(tag, pts, cents,
                                kmeans_update_cuda(pts, cents),
                                ku_ref.kmeans_update(pts, cents))[0]
        idx = torch.from_numpy(rng.integers(0, n, (m, p["b"])).astype(
            np.int32)).to(dev)
        rows = torch.gather(pts, 1, idx.long()[..., None].expand(-1, -1, d))
        return check_update(tag, rows, cents,
                            kmeans_update_gather_cuda(pts, cents, idx),
                            ku_ref.kmeans_update(rows, cents))[0]
    if kernel == "psi_prf":
        ids = torch.from_numpy(rng.integers(0, 2 ** 62, (p["rows"], p["p"]),
                                            dtype=np.int64)).to(dev)
        seeds = torch.from_numpy(rng.integers(0, 2 ** 32, (p["rows"], 2),
                                              dtype=np.int64)).to(dev)
        if not torch.equal(prf_tags_cuda(ids, seeds),
                           prf_ref.prf_tags(ids, seeds)):
            raise AssertionError(f"{tag}: tags differ")
        return 0.0
    if kernel.startswith("sorted_intersect"):
        n_side = p["p"] * 3 // 4
        a, b = merge_operands(rng, p["p"], n_side, n_side // 2, dev,
                              p["pairs"])
        for part, g, w in zip(("sel", "rank", "merged"),
                              sorted_intersect_cuda(a, b),
                              si_ref.sorted_intersect(a, b)):
            if not torch.equal(g, w):
                raise AssertionError(f"{tag}: {part} differs")
        return 0.0
    dtype = torch.float32 if p.get("dtype") == "f32" else torch.bfloat16
    if kernel == "flash_attention":
        return flash_row(dev, rng, 1, 256, 256, 4, 2, p["dh"], dtype,
                         check_only=tag)["max_abs_err"]
    if kernel == "flash_attention_bwd":
        return flash_bwd_row(dev, rng, 1, 256, 256, 4, 2, p["dh"], dtype,
                             check_only=tag)["max_abs_err"]
    if kernel == "ssd_scan":
        return ssd_row(dev, rng, 1, p["s"], p["h"], p["p"], p["n"],
                       p["chunk"], check_only=tag)["max_abs_err"]
    raise AssertionError(f"{tag}: no launch for this kernel")


def analysis_blocks(dev):
    """Every ``ok`` row of ``smem_report`` launched at its shape and held
    against its plain version; the static shared memory of K11's forward
    and K7/K8 against ptxas's; a row that is not ``ok`` (K1 at d = o =
    128, past ``SMEM_CAP``) refused by its wrapper before launch."""
    from repro_torch.analysis import blocks
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.kernel import smem_bytes
    from repro_torch.kernels.sorted_intersect.kernel import merge_smem_bytes
    from repro_torch.kernels.splitnn_bottom.kernel import splitnn_bottom_cuda

    rng = np.random.default_rng(SEED + 20)
    faults, out = [], []
    for r in (b.as_row() for b in blocks.smem_report()):
        if not r["ok"]:
            faults.append(f"smem row not ok: {r}")
            continue
        before = sum(build.LAUNCHES.values())
        err = analysis_block_row(dev, rng, r)
        out.append(dict(kernel=r["kernel"], shape=r["shape"],
                        smem_bytes=r["smem_bytes"], limit=r["limit"],
                        max_abs_err=err,
                        launched=sum(build.LAUNCHES.values()) > before))
        if not out[-1]["launched"]:
            faults.append(f"{r['kernel']} [{r['shape']}]: no launch")
        torch.cuda.empty_cache()
    static = {}
    for source in ("flash_attention", "sorted_intersect"):
        report = build.PTXAS_REPORT.get(source)
        if not report:
            raise AssertionError(f"no ptxas report of {source}: the "
                                 "analysis phase needs a fresh build")
        static.update(ptxas_static_smem(report))
    for fn, got in sorted(static.items()):
        hit = re.search(r"flash_attention_kernel(_bf16_mma)?ILi(\d+)E", fn)
        if hit:
            want = 0 if hit[1] else smem_bytes(int(hit[2]), torch.float32)
        else:
            hit = re.search(r"merge_path_kernelILi(\d+)E", fn)
            if not hit:
                continue
            want = merge_smem_bytes(int(hit[1]))
        if got != want:
            faults.append(f"{fn}: ptxas reports {got} B of static shared "
                          f"memory, the kernel module {want}")
    bad = blocks.splitnn_bottom_blocks(512, 128, 128)
    x = torch.zeros((3, 512, 128), device=dev)
    w = torch.zeros((3, 128, 128), device=dev)
    before = dict(build.LAUNCHES)
    try:
        splitnn_bottom_cuda(x, w, torch.zeros((3, 128), device=dev), True)
        faults.append(f"{bad.shape}: K1 launched a block of "
                      f"{bad.smem_bytes} B past {bad.limit} B")
    except ValueError:
        pass
    if build.LAUNCHES != before or bad.ok:
        faults.append(f"{bad.shape}: not refused before launch")
    return out, {k: v for k, v in static.items()
                 if "flash_attention" in k or "merge_path" in k}, faults


def analysis_phase(dev):
    """The gate's layers on the card (``--only analysis``): the census of
    every single-device program with the kernels on (``analysis_census``)
    and the shared-memory rows launched (``analysis_blocks``)."""
    t0 = time.perf_counter()
    census, faults = analysis_census(dev)
    t1 = time.perf_counter()
    rows, static, block_faults = analysis_blocks(dev)
    row = dict(phase="analysis", census=census, blocks=rows,
               ptxas_static_smem=static, census_seconds=t1 - t0,
               blocks_seconds=time.perf_counter() - t1,
               seconds=time.perf_counter() - t0,
               faults=faults + block_faults)
    emit(row)
    if row["faults"]:
        raise AssertionError(f"analysis: {row['faults']}")
    return [row]


ONLY = {"llm-kernels": ["flash_attention", "flash_attention_bwd",
                        "ssd_scan"],
        "sharded": ["psi_prf", "sorted_intersect", "kmeans_update",
                    "kmeans_assign", "splitnn_bottom"],
        "llm-paths": ["flash_attention", "ssd_scan"],
        "long-context": ["flash_attention", "ssd_scan"],
        "llm-train": ["flash_attention", "flash_attention_bwd", "ssd_scan"],
        "llm-sharded": ["flash_attention", "flash_attention_bwd"],
        "kmeans-kernels": ["kmeans_update", "kmeans_assign"],
        "bottom-kernels": ["splitnn_bottom"],
        "psi-kernels": ["psi_prf", "sorted_intersect"],
        "table2": ["psi_prf", "sorted_intersect", "kmeans_update",
                   "kmeans_assign", "splitnn_bottom"],
        "analysis": None}


def main(argv) -> int:
    only = argv[1] if len(argv) >= 2 and argv[0] == "--only" else None
    phases = argv[2:] if only == "llm-paths" else []
    if (argv and only not in ONLY or len(argv) > 2 and not phases
            or not set(phases) <= {p for p, _ in LLM_PHASES}):
        print("usage: chip_smoke.py [--only llm-kernels|llm-paths [PHASE "
              "...]|llm-train|long-context|kmeans-kernels|bottom-kernels|"
              "psi-kernels|table2|"
              "sharded|llm-sharded|analysis]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    smi = nvidia_smi()
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    emit({"phase": "device", "nvidia_smi": smi,
          "torch_name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    phase_s = {}

    def timed(name, fn, *args):
        """``fn(*args)``, its wall added to ``phase_s[name]``."""
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = phase_s.get(name, 0.0) + time.perf_counter() - t0
        return out

    secs = timed("build", build.build_all, ONLY.get(only))
    sass = ssd_sass = bwd_sass = None
    if only in (None, "llm-kernels", "llm-paths", "llm-train",
                "long-context"):
        # K11's bf16 instances must run both products on the tensor cores;
        # K12's census is a record (its products are f32 FMAs, PERF.md)
        sass = sass_census("flash_attention")
        ssd_sass = sass_census("ssd_scan", marks=("HMMA", "HGMMA", "FFMA"))
    if only in (None, "llm-kernels", "llm-train"):
        # the backward's bf16 kernels must run their five products on the
        # tensor cores, and spill nowhere up to Dh 128
        bwd_sass = sass_census("flash_attention_bwd",
                               marks=("HMMA", "HGMMA", "FFMA"))
    # K3/K4 (33 widths × 2) and K5 (R = 4 at widths 1..32, R = 1 at the
    # run-time width): one line an instance, none may spill
    update_ptxas, spills = kmeans_ptxas(
        build.PTXAS_REPORT.get("kmeans_update", ""),
        r"kmeans_update_kernelILb(\d)ELi(\d+)E",
        lambda h: f"K{4 if h[1] == '1' else 3} D={h[2]}")
    assign_ptxas, assign_spills = kmeans_ptxas(
        build.PTXAS_REPORT.get("kmeans_assign", ""),
        r"assign_kernelILi(\d+)ELi(\d+)E", lambda h: f"K5 D={h[1]} R={h[2]}")
    emit({"phase": "build", "seconds": secs,
          "ptxas": {k: [ln for ln in v.splitlines() if "registers" in ln
                        or "spill" in ln or "entry function" in ln]
                    for k, v in build.PTXAS_REPORT.items()
                    if k not in ("kmeans_update", "kmeans_assign")} | {
                        "kmeans_update": update_ptxas,
                        "kmeans_assign": assign_ptxas},
          "flash_attention_sass": sass, "ssd_scan_sass": ssd_sass,
          "flash_attention_bwd_sass": bwd_sass})
    if spills or assign_spills:
        raise AssertionError(f"kmeans: ptxas spills in "
                             f"{spills + assign_spills}")
    merge_spills = spilled(build.PTXAS_REPORT.get("sorted_intersect", ""))
    if merge_spills:
        raise AssertionError(f"sorted_intersect: ptxas spills in "
                             f"{merge_spills}")
    if only == "psi-kernels":
        # K6, K7 and K8 at their paths' shapes and the merge's edges: the
        # quick check of an edit to psi_prf.cu or sorted_intersect.cu (not
        # the contract run)
        for r in psi_kernel_rows(dev, np.random.default_rng(SEED)):
            emit({"phase": "kernel", **r})
        print(smi, flush=True)
        emit({"ok": True, "only": only, "device": device})
        return 0
    if only == "bottom-kernels":
        # K1/K2 in both forms, K9/K10 in both forms, the quantizers on the
        # card and the fp8 encode sweep: the quick check of an edit to
        # splitnn_bottom.cu (not the contract run)
        rng = np.random.default_rng(SEED)
        slab = client_slab(partitions()[0], 49_000, dev)
        yslab = client_slab(partitions("YP")[0], YP_ALIGNED, dev)
        rows = bottom_kernel_rows(dev, slab, yslab, rng)
        rows += int8_kernel_rows(dev, slab, rng)
        rows += fp8_wire_rows(dev, slab, np.random.default_rng(SEED + 3))
        for r in rows:
            emit({"phase": "kernel", **r})
        quantizer_check(dev, slab, rng)
        print(smi, flush=True)
        emit({"ok": True, "only": only, "device": device})
        return 0
    if only == "sharded":
        # the sharded pipeline: the quick check of an edit to sharding,
        # launch/mesh or a mesh= path (not the contract run)
        sharded_phase(dev, smi)
        print(smi, flush=True)
        emit({"ok": True, "only": only, "device": device})
        return 0
    if only == "llm-sharded":
        # LLM training on a (data, model) mesh: the quick check of an edit
        # to the LLM half of sharding, the models' mesh paths or
        # launch/train (not the contract run)
        llm_sharded_phase(dev, smi)
        print(smi, flush=True)
        emit({"ok": True, "only": only, "device": device})
        return 0
    if only == "table2":
        # the Table-2 jobs on BA, MU, RI and BP: the quick check of an
        # edit to the VFL path at those datasets' shapes (not the
        # contract run)
        timed("table2", table2_phase, dev)
        emit({"phase_s": phase_s})
        print(smi, flush=True)
        emit({"ok": True, "only": only, "device": device})
        return 0
    if only == "analysis":
        # the gate's census and shared-memory rows on the card: the quick
        # check of an edit to analysis/ or an engine program (not the
        # contract run)
        analysis_phase(dev)
        print(smi, flush=True)
        emit({"ok": True, "only": only, "device": device})
        return 0
    if only == "kmeans-kernels":
        # K3 at HI and YP, K4, K5: the quick check of an edit to
        # kmeans_update.cu or kmeans_assign.cu (not the contract run)
        for r in kmeans_kernel_rows(dev, np.random.default_rng(SEED))[0]:
            emit({"phase": "kernel", **r})
        print(smi, flush=True)
        emit({"ok": True, "only": only, "device": device})
        return 0
    no_mma = [fn for fn, c in sass.items()
              if "bf16_mma" in fn and not (c["HMMA"] or c["HGMMA"])]
    if no_mma or not any("bf16_mma" in fn for fn in sass):
        raise AssertionError(f"flash_attention: bf16 instances without "
                             f"tensor-core instructions: {no_mma or sass}")
    if bwd_sass is not None:
        no_mma = [fn for fn, c in bwd_sass.items()
                  if "bf16_mma" in fn and not c["HMMA"]]
        if no_mma or sum("bf16_mma" in fn for fn in bwd_sass) != 10:
            raise AssertionError(f"flash_attention_bwd: bf16 instances "
                                 f"without HMMA: {no_mma or bwd_sass}")
        bwd_spills = [fn for fn in spilled(
            build.PTXAS_REPORT.get("flash_attention_bwd", ""))
            if re.search(r"bf16_mmaILi(32|64|128)E", fn)]
        if bwd_spills:
            raise AssertionError(f"flash_attention_bwd: ptxas spills in "
                                 f"{bwd_spills}")
    if only == "llm-paths":
        # the LLM serving paths (all, or the phases named): the quick check
        # of an edit to the models or the engine (not the contract run)
        for phase, arch in LLM_PHASES:
            if not phases or phase in phases:
                llm_phase(dev, phase, arch)
        print(smi, flush=True)
        emit({"ok": True, "only": only, "device": device})
        return 0
    if only == "long-context":
        # the long_500k serving paths (force_window): the quick check of
        # an edit to the long-context path (not the contract run)
        long_context_phase(dev)
        print(smi, flush=True)
        emit({"ok": True, "only": only, "device": device})
        return 0
    if only == "llm-train":
        # LLM training at full width, the reduced configs and the
        # checkpoint resume: the quick check of an edit to the training
        # path or K11's backward (not the contract run)
        llm_train_phase(dev)
        print(smi, flush=True)
        emit({"ok": True, "only": only, "device": device})
        return 0
    if only == "llm-kernels":
        # K11, its backward and K12 against their plain versions, K11's
        # gradients and K12's refusal under grad: the quick check of an
        # edit to those kernels (not the contract run)
        rows = llm_kernel_rows(dev, np.random.default_rng(SEED))
        for r in rows:
            emit({"phase": "kernel", **r})
        print(smi, flush=True)
        emit({"ok": True, "only": only, "device": device})
        return 0
    rows = timed("kernels", kernel_phase, dev)
    launches, pipe_rows = timed("pipeline", pipeline_phase, dev)
    train_runs, train_rows = timed("train", train_phase, dev)
    rep, mlp_row = train_runs["treecss", "mlp", "kernel"]
    # K1 and K2 count on their own main path, the treecss-mlp job
    launches = launches | {k: mlp_row["launches"][k] for k in
                           ("splitnn_bottom", "splitnn_bottom_gather")}
    pipe_rows += train_rows
    pipe_rows += timed("serve", serve_phase, dev, rep.train.params,
                       train_cfg("mlp", 0.01, 70_000, 200))
    pipe_rows += timed("profile", profile_phase, dev)
    # K8 counts on the YP rounds, K4 on the minibatch coreset
    yp_launches, yp_rows = timed("yp", yp_phase, dev)
    mb_launches, mb_rows = timed("minibatch", minibatch_phase, dev)
    launches = launches | {
        "sorted_intersect_tiled": yp_launches["sorted_intersect_tiled"],
        "kmeans_update_gather": mb_launches["kmeans_update_gather"]}
    pipe_rows += yp_rows + mb_rows + timed("delta", delta_phase, dev)
    # K9 and K10 count on their own main path, treecss × mlp under int8,
    # K1 and K2's fp8 wire form on treecss × mlp under fp8
    quant_runs, quant_rows = timed("quant", quant_phase, dev, train_runs)
    pipe_rows += quant_rows
    for quant, names in (("int8", ("splitnn_bottom_int8",
                                   "splitnn_bottom_int8_gather")),
                         ("fp8", ("splitnn_bottom_fp8",
                                  "splitnn_bottom_fp8_gather"))):
        qrep, qrow = quant_runs["treecss", "mlp", quant, "kernel"]
        launches = launches | {k: qrow["launches"][k] for k in names}
        pipe_rows += timed("serve", serve_phase, dev, qrep.train.params,
                           train_cfg("mlp", 0.01, 70_000, 200), quant)
    # the Table-2 jobs on BA, MU, RI and BP: their own launch counts
    pipe_rows += timed("table2", table2_phase, dev)
    # K11 and K12 count on their own main paths, one greedy_decode each:
    # the K11/K12 rows on tinyllama and mamba2, a ``path`` row on its own
    llm = {phase: timed(phase, llm_phase, dev, phase, arch)
           for phase, arch in LLM_PHASES}
    # K11's backward counts on its own path, a tinyllama train step
    train = timed("llm_train", llm_train_phase, dev)
    launches = (launches | llm["llm_dense"]["launches"]
                | llm["llm_ssm"]["launches"] | train["launches"])
    for phase, arch in LLM_PHASES[1:3]:
        worst = llm[phase]["k12_layers_max"]
        rows.append(dict(
            name="ssd_scan", check_only=f"{arch} layer inputs, f32 model, "
            "vs a float64 scan", max_abs_err=worst["y_kernel_vs_plain"],
            max_abs_y=worst["max_y"], max_cum=worst["max_cum"],
            kernel_vs_f64=worst["y_kernel_vs_f64"],
            plain_vs_f64=worst["y_plain_vs_f64"]))
    pipe_rows += list(llm.values()) + [train]
    # long_500k serving: its own launch counts (K11/K12 a prefill layer)
    pipe_rows += timed("long_context", long_context_phase, dev)
    # the sharded pipeline: its own path, its own launch counts (each rank's)
    pipe_rows += timed("sharded", sharded_phase, dev, smi)
    # LLM training on a (data, model) mesh: its own launch counts (each
    # rank's K11 forward and backward a step)
    pipe_rows += timed("llm_sharded", llm_sharded_phase, dev, smi)
    # the gate's census (launches a call against the reference's
    # pallas_calls, syncs, f64) and shared-memory rows on the card
    pipe_rows += timed("analysis", analysis_phase, dev)
    kernels = []
    for r in rows:
        if "check_only" in r or "timed_at" in r:
            continue
        if "path" in r:
            phase, key = r["path"]
            n = llm[phase]["launches"].get(key, llm[phase].get(key))
        else:
            n = launches[r["name"]]
        kernels.append({key: r[key] for key in (
            "name", "route", "source", "replaces")} | {"launches": n} | {
            key: r[key] for key in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms")}
            | ({"path": r["path"][0], "shape": r["shape"]} if "path" in r
               else {}))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"),
              "w") as f:
        json.dump({"nvidia_smi": smi, "build_seconds": secs,
                   "phase_s": phase_s, "kernels": rows,
                   "pipeline": pipe_rows}, f, indent=1)
    emit({"phase_s": phase_s})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": device})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
