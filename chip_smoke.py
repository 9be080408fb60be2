"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--n-series 1048576] [--length 512]
                          [--lm-prompt 32768] [--subseq-points 20972031]

1. Set-up: the card's name and power limit, the torch and CUDA versions,
   and the build of the CUDA kernels from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, all at once).
2. Data: ``--n-series`` synthetic-ECG series of length ``--length`` made
   from ``--seed`` (the windows of ``make_benchmark_db``, each
   z-normalised as in the UCR suite: raw, the baseline-dominated windows
   collapse onto a few signatures shared by thousands of series, and a
   query's top-512 ties by lowest id can then leave the query itself
   out).  Queries: 4 batches of 64, half database rows (whose top-1 must
   be themselves), half warped copies.
3. Paths, each driven with every kernel's launch count set to 0 just
   before and read just after; each kernel of the path must have grown:
   a. batched: ``TimeSeriesDB.build`` at the full ``ssh-ecg`` config
      (W=80, δ=3, n=15, K=40, L=20), then ``SEARCH`` at the 5 % band,
      topk 10, top_c 512, multiprobe 3 on the 4 batches through
      ``serving.batched.ssh_search_batch`` (the facade's call; its
      ``BatchSearchResult`` carries the batch's counters and stage
      times);
   b. sequential: ``searcher="local"`` on the same index for 16 queries
      of batch 0 (8 database rows, 8 warped copies): self-match at rank 1
      for the rows, ids equal to the batched answers, distances within
      rtol 1e-5 of them;
   c. UCR baseline: ``ucr_search`` for 4 of those queries over the whole
      database at the same band and topk, 2 of them held to
      ``brute_force_topk`` (both exact); SSH precision@10 and NDCG@10
      against the UCR answer and the UCR/SSH time ratio are logged;
   d. streaming: an ``"ssh-cs"`` database (the same sketch and hash
      settings, rows 4, width 4096, base_bits 4) built from the first
      half of the series, the second half ingested through two
      ``StreamIngestor`` shards with out-of-order ``seq``, merged and
      folded in: the merged aggregate must equal the sum of the shards'
      exactly, a 4096-row chunk re-encoded directly must give the stored
      signatures, and 8 streamed rows must find themselves through both
      searchers;
   e. persist (phases ``persist_*``; saved directories live under
      ``build/`` and are removed once read, after a check that the disk
      there holds two saved databases): the batched index saved with
      ``TimeSeriesDB.save`` and loaded onto the card answers the 4
      batches with bit-identical ids and distances (save, load and build
      seconds, bytes and GB/s logged); the streaming database saved and
      loaded, then one more 4096-row chunk ingested into it and into the
      never-saved one: signatures, keys and ``cs/agg`` equal; host
      buckets (``searcher="local", use_host_buckets=True``) on the loaded
      index, their build at 2^20 x 20 and 16 queries timed, the database
      rows self-matched; ``"srp"`` and ``"ssh-multires"`` each built from
      all the series at their defaults, batch 0 through the batched
      searcher with the database rows self-matched, bit-identical after
      one save and load, precision@10 against UCR beside SSH's logged;
      ``launch.build_index --points 70000`` and ``launch.serve --arch
      ssh-ecg --sequential --db-dir`` on its output as subprocesses (exit
      0, ``loaded database``); batch 0 twice on the loaded index from an
      empty signature LRU: 64 hits the second time, the same ids, no
      sketch launch.  The LRU is emptied before the sequential path and
      before the recording run of step 4, which must encode.
4. Kernels: each of the seven against its plain PyTorch version on the
   card, on the very tensors its path handed it (recorded on one more
   run of the path): integers and count-sketch tables exact, DTW
   bit-identical, the sketch within the float32 bound of reordering an
   80-term sum and bit for bit against ``ref.sketch_conv_fma_ref``, the
   exact emulation of its fused multiply-add chain.  Times: ``ms`` is
   the device time a launch (``torch.profiler``'s kernel records,
   ``repro_torch.bench.device_time``), ``call_ms`` the time between
   back-to-back calls by CUDA events, which reads host dispatch when a
   call's host work outlasts its kernel; the same two for one PyTorch
   call computing the same function where there is one
   (``library_ms``, ``library_call_ms``); the plain version's call time.
   The bound is the larger of bytes over 3.35 TB/s and operations over
   the peak rate of their type (H100 SXM: f32 outside the tensor cores
   67 TFLOP/s, int32 33.5 Tops/s; the DTW cell's 6 operations, none of
   which fuses, 33.5e12 a second).  The sketch is timed at a 4096-row
   build chunk and at the query encode, with ptxas's registers and
   spills of each sketch kernel (a spill, a stack frame or local memory
   fails the run) and its SASS instructions a tap
   (``repro_torch.bench.sketch_flash.tap_costs``).  The collision-count
   kernels:
   ptxas's registers and spills of each (a spill, or local memory in the
   SASS, fails the run), the batch kernel's SASS instructions a key
   compared (``repro_torch.bench.collision_count.key_costs``), every
   recorded single-query call checked, and the batched probe stage
   split into its three parts, each timed by CUDA events on batch 0's
   recorded input: the kernel, the max over the multiprobe offsets and
   ``top_c_by_count``.  The top-C select (``topc_select``, three
   launches): ids and counts equal to the composite-key
   ``torch.topk`` it replaced and to its plain version, at the
   benchmark's probe shapes (ssh-ecg's (64, 6,291,456) and
   ssh-randomwalk's (64, 1,572,864), K 40, top 512, counts drawn from the
   seed with the top spread over many counts and as one mass of ties)
   and on batch 0's probe counts, with the key and ``torch.topk`` as
   ``library_ms``; its bound is bytes: every count read once and the
   outputs written, from the shapes alone (``read_bytes``: what this
   design reads, the counts again up to the last selected column of
   each chunk that writes one).
   The DTW kernels: ptxas's
   registers and spills of every DTW kernel (a spill fails the run) and
   the SASS instructions a DP cell of each schedule
   (``repro_torch.bench.dtw_schedules.cell_costs``); every recorded call
   through the schedule rule (``kernels.dtw_wavefront.dtw_schedule``, its
   choice printed per call) and through each schedule that takes its
   radius ("rows", "diagonals"), bit-identical to the plain version;
   both schedules timed in turns, with cells run, Gcells/s and the share
   of the bound, at the batched survivors, the UCR scan and a sequential
   re-rank; launches per schedule per path.
5. Cross-check: 8 queries through the plain CPU path on a CPU copy of the
   index; ids equal, distances within rtol 1e-5.
5a. The paper's functional API (phase ``paper_api``), on the 2^20
   index: ``build_signatures(series, SSHFunctions.create(SSHParams(...)))``
   and ``TimeSeriesDB.build(series, SSHParams(...), config)`` (the
   deprecation shim: one ``DeprecationWarning``) must give the ``spec=``
   build's signatures and keys bit for bit; ``probe_topc_batch`` on batch
   0's 64 queries and ``probe_topc`` on one must equal ``batch_probe``'s
   and ``hash_probe``'s top-C; ``dtw_pairwise`` of the 64 queries against
   the first query's 512 candidates, ``dtw_banded_batch`` of that query at
   its 10th-best distance as the threshold (kept values equal to the
   pairwise row, BIG elsewhere) and ``dtw_pairs_chunked`` of the same
   32,768 pairs at that threshold (likewise); ``cascade_stats`` of 16 queries over all
   the rows against the 10th-best banded DTW (equal to
   ``brute_force_topk``'s for 2 of them), the five fractions logged and 2
   queries' fractions on the first 65,536 rows within 2/65,536 of the
   CPU's; ``srp_search`` (64 planes) for the 16 queries, ids equal to the
   CPU's on the 65,536-row slice (the whole search, DTW included, for 2
   of them); rectangular ``dtw`` at three (m_x, m_y)
   pairs, band 25 and none, within 1e-6 of the float64 DP.  Wall ms of
   each gated call and call ms by CUDA events are logged, the probes'
   split into the collision counts and the top-C ranking.  Then the five
   kernels it launched held to their plain versions on its own inputs
   (every 64th sketch chunk of the builds, the other calls but the
   whole-database DTW scans and all but 2 of ``srp_search``'s
   radius-511 DTW calls) and timed at its shapes (``paper_api_shapes``).
   ``build_signatures`` runs in 4,096-row chunks, the facade's.
5a'. The encoder composition (phase ``pipeline``), on the 2^20 index: a
   ``PipelineEncoder`` of the stock stages registered out of tree, with
   the main index's params and seed, builds a ``TimeSeriesDB`` whose state
   leaves, signatures and band keys must equal the main ``"ssh"`` index's
   bit for bit, and answers batch 0 (64 queries, ``"batched"``) with the
   main path's ids, distances within rtol 1e-5; the multiprobe encode of
   those queries through both encoders is timed in turns.  1,024 rows
   through a shingler with only the protocol's members (the dense route,
   64 rows a block) and the 64 queries' multiprobe signatures must equal
   the active route's; 4,096 rows built as ``"ssh-cs"`` through the
   composition must equal the CPU's draw and encode (state, signatures,
   keys, sketch); 64 rows through ``pure_encode_fn`` must equal
   ``encode_batch`` for ``"ssh"``, ``"ssh-multires"``, ``"ssh-cs"`` and
   ``"srp"``.  Then its ``sketch_conv`` calls (every 64th, the last two)
   and every ``cs_tables`` call held to their plain versions, one of
   each timed (``pipeline_shapes``).
5a''. The reference's public surface (phase ``surface``): the port's
   three examples run on the card at their default sizes through their
   ``run`` functions: ``examples/torch_index_and_search.py`` (20,000
   ECG points, windows of 256: build, save, load, 3 queries with UCR and
   brute force; the loaded database must equal the built one bit for
   bit), ``torch_distributed_search.py`` (8 row shards on the card: the
   fan-out's top-5 must equal the ``"distributed"`` facade's, the query
   row its own top-1 there and in the single-device facade) and
   ``torch_train_recsys_ssh.py`` (BST 5 steps, then SSH over 512 users'
   trajectories: user 7 its own top-1).  Then, on the 2^20 index, the
   call forms the surface walk closed: ``SSHIndex(fns=index.fns, ...)``
   answers batch 0 as the encoder-built index bit for bit (its encoder
   adopting the same tensors); ``dtw_evals`` equals the candidates that
   reached DTW (batch 0 and 4 sequential searches); ``backend="auto"``
   and ``"pallas"`` give the default's signatures and probe;
   ``SearchConfig(max_batch=16, max_wait_ms=1.0)`` warns once, folds
   into ``batch_policy`` and answers 8 queries as the main path;
   ``Checkpointer.restore_latest(shardings=)`` puts 4,096 signature and
   key rows on the card as ``restore_checkpoint`` does; ``backend="jnp"``
   on CUDA tensors is refused by seven entry points.  Every kernel call
   of the examples is then held to its plain version.
5b. Distributed and fleet tiers (phases ``dist``, ``fleet``,
   ``fleet_faulty``, ``fleet_drain``, ``fleet_launcher``; before the
   engine, whose insert makes the index N + 1 rows, which no longer
   divides a mesh), on the 2^20 index at ``SEARCH`` with
   ``multiprobe_offsets=1`` (the tier is single-probe):
   ``searcher="distributed"`` answers batch 0 on the default mesh (one
   shard a visible card) and on the card repeated 4 times (4 row shards,
   local_c 128), µs a query logged; one shard must answer as
   ``ssh_search_batch`` (ids equal, distances within rtol 1e-5) for every
   query with at least top_c positive counts, and as near or nearer at
   every rank for the others (its candidate set holds the batched one:
   the shard probe keeps zero counts, as ``lax.top_k``).  ``searcher=
   "fleet"`` with ``benchmarks/dist_bench.py``'s settings (R 2, W 4,
   adaptive hedging >= 5 ms; artifacts under ``build/``, after a check
   that the disk there holds two sets): publish and fetch seconds, bytes
   on the card a worker and peak memory; batch 0 warms it and must equal
   the 4-shard answers bit for bit, then 50 single-query calls (p50, p99,
   mean µs), each equal to them.  ``fleet_faulty``: the primary of shard
   0 killed and a primary of a shard it does not hold delayed by 10x the
   healthy mean shard time: 50 calls bit-identical to the healthy ones,
   hedges and failovers both > 0, ``p99_ratio`` logged beside the
   reference CI's bar of 3.0.  ``fleet_drain``: a ``ServingEngine`` on
   the fleet config (``BatchPolicy(max_batch=4, max_wait_ms=1.0)``), 50
   requests submitted, ``drain(w0)`` mid-stream: every future resolves,
   every answer the healthy one; then ``resize(6)`` and ``resize(3)``,
   answers unchanged, shards moved logged against ceil(shards /
   workers); ``launch.serve --arch ssh-ecg --replication 2
   --fleet-workers 4 --hedge-ms 5 --requests 16`` as a subprocess: exit
   0, every request its own top-1, a ``fleet:`` line.  One fleet query's
   kernel calls, recorded from the pool's threads, are held to their
   plain versions as in step 4 and timed (the ``fleet_shapes``
   sub-entries of ``sketch_conv``, ``collision_count`` and
   ``dtw_wavefront``).
6. Serving engine (phases ``engine*``, last of the SSH paths because
   its insert grows the index): ``TimeSeriesDB(searcher="engine")`` on
   the batched index at ``SEARCH`` with ``BatchPolicy(max_batch=8,
   max_wait_ms=2.0)``, the signature LRU cut to one entry so that every
   batch encodes.  Every bucket (1, 2, 4, 8) warmed through
   ``engine.searcher``; a full batch's service time ``s8`` (median of
   15) sets the capacity ``8 / s8`` qps and the SLO p99 <= max(100 ms,
   4 s8).  Open-loop Poisson traces from ``repro_torch.loadgen`` (from
   ``--seed``, length 512, topk 10) over batch 0's 64 queries, each
   holding about 2 s of arrivals at its own load (at most 4096
   requests): fixed 2 ms at 0.25, 0.5, 0.75 and 1.1 x capacity through
   ``sweep``, adaptive at 0.5 x over the same trace as fixed's.
   Logged: latency from arrival (p50, p95, p99), achieved against
   offered qps and the trace's own rate (arrivals over its span), queue
   depth p95, batch histogram, mean batch wait and occupancy, padded-row
   share, stage us a batch and ``max_sustainable_qps`` for each policy.
   The three kernels of the path are held to their plain versions as in
   step 4 on the inputs of the engine's own batches, one of 8 and one of
   1 through ``engine.searcher`` (every call checked, one of each
   timed; the kernel entries' ``engine_shapes``).  Gates: fixed and
   adaptive answer the trace alike (``LoadResult.same_answers``); every
   answer's
   ids and distances equal to ``ssh_search_batch`` on the 64 queries as
   one block; database rows their own top-1; 64 requests submitted then
   ``stop()``: every future resolved, answers equal; ``launch.serve
   --arch ssh-ecg --requests 16`` as a subprocess in its default engine
   mode, exit 0, every request its own top-1; one novel series inserted
   through the running engine at 2^20 (insert ms and peak memory
   logged) found at rank 1 as row N of N + 1.
7. Subsequence search (the 2^20 index freed first; phases ``subseq``,
   ``subseq_extend``, ``subseq_hop6``, ``subseq_exact``): one
   synthetic-ECG stream of ``--subseq-points`` points from ``--seed``
   (20,971,520 windows of ``--length`` at hop 1, the paper's count), two
   random-walk patterns planted in its first 2^18 windows; the full
   ``ssh-ecg`` config, ``SEARCH`` at the 5 % band, ``searcher="local"``,
   exclusion zone L//2, raw windows.  The sketch at the stream shape
   first: one (1, n) row at stride 1 and 3 and a suffix view 12 bytes
   past a 16-byte boundary, bit for bit against
   ``ref.sketch_conv_fma_ref``; device, call, plain and ``F.conv1d``
   times at stride 1 (the kernel entry's ``stream_shape``).  Then
   ``TimeSeriesDB.build_stream`` at hop 1 (stride-1 sketch, windows'
   bits gathered) and 16 queries (8 windows cut at offsets from
   ``--seed``, 8 warped copies); ``extend_stream`` of a 4,096-point tail
   with a third pattern planted in it, which must come back at rank 1,
   distance 0; the same build and queries at hop 6 (the aligned route,
   stride 3).  At each hop one warped copy is searched again from an
   empty LRU with its kernel calls recorded: every ``collision_count``
   call (over all the windows' keys) held exact to
   ``ref.collision_count_ref`` and every DTW call bit for bit to
   ``ref.dtw_wavefront_ref`` through the rule and each schedule; the
   first probe row and the survivors' DTW timed with their bounds (the
   kernel entries' ``stream_shape``).  Gates: rolling signatures and
   keys equal ``encode_batch`` of the materialised windows on 65,536
   windows (the
   first and last 4,096, 57,344 drawn) at each hop and on every new
   window of the tail; every answer's top-1 is the float64 DP's minimum
   over its probe pool, offsets are ids x hop, pairwise >= L//2.
   Logged: build s and windows/s beside the per-window encode rate
   (the median of 5 warm ``encode_chunked`` calls on the sample),
   us a query and stage us (``encode_amortized`` among them), cut copies
   at rank 1 and whether top-C ties left the others out, extend us a
   window, peak memory.  ``subseq_exact``, the first 2^18 windows at
   hops 1 and 6: signatures equal ``TimeSeriesDB.build`` of the
   windows; 18 answers equal ``ssh_search`` over those windows at the
   oversampled topk followed by the same greedy pick, ids and distances
   bit for bit; the two planted patterns at rank 1, distance 0, as
   ``brute_force_topk`` over every window in chunks; save under
   ``build/`` (removed once read), load: answers bit-identical, and the
   loaded database grows as the original.
8. LM serving (the SSH state freed first, so its peak memory is its own):
   granite-3-2b CONFIG at full width in bf16, random weights from a
   ``torch.Generator`` seeded by ``--seed``.  First the flash library's
   build report: ptxas's registers, stack and spills of every flash
   kernel (a spill, a stack frame or local memory in the SASS fails the
   run), and the count of tensor-core instructions (HGMMA, HMMA) in the
   SASS of each instance of the tensor-core kernel, (Q/K, V) tiles (64,
   64), (128, 128) and (192, 128) (``cuobjdump -sass``): a 0 fails.
   Then three more counted paths, each with 40 launches of the
   tensor-core kernel ``flash_attention`` (one a layer) and none of the
   CUDA-core ``flash_attention_simt``:
   e1. ``lm``: one prefill of 1 x ``--lm-prompt`` tokens (the
       prefill_32k cell's 32,768 tokens, its batch cut from 32 to 1),
       timed once: tokens/s, seconds, peak memory;
   e2. ``lm_batch``: one prefill of 8 x 2048;
   e3. ``lm_serve``: ``serve_lm`` at batch 8, prompts of 128 tokens
       stepped through ``decode_step``, 32 greedy tokens, one prefill of
       the prompts; gate: the prefill's last-position logits equal the
       decode logits after token 128 within 10 % of max |logit| in bf16
       and, on a float32 copy of the weights (``lm_serve_f32``: 40
       launches of ``flash_attention_simt``, none of the other), within
       1e-4; the argmax equal where the top-2 margin exceeds the
       tolerance.
   Then the tensor-core kernel (its launch counted) on layer 0's own q,
   k, v (all heads at 8 x 2048, heads 0-1 at the long prefill), per
   element with a = sum_j w_j |v_j| (``flash_attention.error_bound``):
   against its plain version within one bf16 ulp, 2^-13 a for float32
   reordering and 2^-8 a for its bf16 weights; against the emulation of
   its own rounding (``ref.flash_attention_tc_ref``) within one ulp,
   2^-13 a and the emulation's spread; the median |o| is printed beside
   each median bound.  At both shapes, in turns
   in one call, its time, the CUDA-core kernel's on the same bf16 inputs
   (through its own entry point, off the path) and
   ``scaled_dot_product_attention``'s (KV heads expanded), the library
   yardstick; the plain version's time at 8 x 2048.  The bound is
   2·(D + Dv) flops per unmasked (query, key) pair at 989 TFLOP/s (bf16
   tensor cores) or the q, k, v and o bytes at 3.35 TB/s, the larger.
   The CUDA-core kernel gets its own entry, held to its plain version and
   timed on the float32 gate's layer-0 inputs (device and call time,
   ``scaled_dot_product_attention`` in float32 beside it), its bound at
   the 67 TFLOP/s of float32 outside the tensor cores.
   Then the rest of the LM suite, each model freed before the next, bf16
   at full width, random weights from ``--seed``: ``lm_8b``
   (granite-3-8b, 40 layers, D 128), ``lm_phi3`` (phi3-mini-3.8b, 32
   layers, MHA, D 96), ``lm_dbrx`` (dbrx-132b, MoE, DEPTH CUT to 8 of 40
   layers: 54.6 GB of the 263.2) and ``lm_deepseek`` (deepseek-v2-lite-16b,
   27 layers, MoE with shared experts and MLA: flash at Q/K 192, V 128).
   Each: one prefill of 8 x 2048 and ``serve_lm`` as in e3 (2 launches of
   ``flash_attention`` a layer, none of the CUDA-core kernel); the gate
   as in e3, for the MoE models on the same prompts at a capacity factor
   that drops nothing (phases ``*_topk``, the config's top-k, and
   ``*_gate``, every expert: top-k routing is discontinuous and the two
   paths' bf16 roundings move near-tied gates across it, so the top-k
   run's gap and its (token, layer) routing flips are logged and the
   10 % gate holds the all-expert run); the share of assignments dropped
   at the config's own factor in the 8 x 2048 prefill and one decode
   step; the prefill's device time; the tensor-core kernel on the
   prefill's layer-0 q, k, v as above (both bounds), timed in turns with
   the CUDA-core kernel and SDPA (the SDPA backends that take the shape
   logged), bound and plain time (``suite_shapes`` of the kernel entry).
   Last ``lm_dbrx_f32`` and ``lm_deepseek_f32``: the MoE models in
   float32, DEPTH CUT to 2 layers, their top-k routing at the drop-free
   factor held by the 1e-4 gate (routing flips logged), 2 launches of
   ``flash_attention_simt`` each, the CUDA-core kernel on layer 0's
   inputs held to its plain version and timed (at MLA's 192/128 for
   deepseek).

9. LM training (the serving models freed first; phases ``train*``), bf16
   at full width, random weights from ``--seed``, through
   ``launch/train.main`` and ``launch/steps`` (``loss_fn`` with per-layer
   remat, attention through ``ops.FlashAttention``: the tensor-core
   kernel's forward, twice a layer a step with the remat recompute, and
   the chunked plain backward; AdamW with float32 master weights):
   ``train``: granite-3-2b at full width and depth, the train_4k cell at
   seq 4,096 with its batch CUT from 256 to 4, 5 steps (s, tokens/s and
   model FLOPs share a step beside the card's name and power limit; peak
   memory; loss and grad norm finite), and one more step under
   ``torch.profiler`` (device ms by kind, busy share); the tensor-core
   kernel on that step's layer-0 q, k, v (4 x 4,096): held as in step 8
   on sequence 0, device and call ms beside SDPA's, the plain version's
   ms and the bound (the kernel entry's ``train_shapes``).  ``train_resume``:
   the same at full width with the depth CUT to 1 layer (a full-depth
   checkpoint is 36.9 GB; a run may write 45 GiB to the machine's disk,
   and the earlier phases write ~31 GB): 4 steps uninterrupted
   (``train_resume_ref``), 2 steps with a checkpoint (``train_ckpt``),
   then the resume from it to step 4: losses within 1e-3 and parameters
   within 2 sum lr_t + one bf16 ulp of the uninterrupted run.
   ``train_learn``: 2 layers at full width, 8 steps at lr 3e-3, warm-up
   1, on one 4 x 1,024 batch: the loss falls by more than 0.1.
   ``train_grad``: the Function's dQ, dK, dV against autograd through
   ``ref.flash_attention_ref`` per element (``grad_check``: one ulp,
   float32 reordering, and the bound of what the kernel's O moves through
   rowsum(dO o O)) at granite-3-2b's layer (1, 32/8, 4,096, 64) and
   deepseek's (1, 16, 2,048, 192/128) in bf16 and at (1, 32/8, 1,024, 64)
   in float32 (the CUDA-core kernel); and one 2-layer float32 model's
   every gradient, the kernel path against the all-plain one, within
   1e-4 of each leaf's max.  ``train_deepseek``: deepseek-v2-lite-16b at
   full width, DEPTH CUT to 2 of 27 layers, 3 steps at 2 x 2,048: finite
   losses, and every remat recompute routes the tokens as its forward.
10. The recsys and GNN families (the LM state freed first; phases
   ``recsys_*`` and ``gnn_*``; no kernel of the port runs in them, and
   their launch counts are logged at 0), float32 as the configs declare,
   parameters drawn on the card from ``--seed``, each model freed before
   the next, through ``launch/steps`` (``init_fn``, ``make_step``) and
   ``launch/train.main``.  For each of dlrm-rm2, bst, mind and dien:
   ``recsys_<model>_check``, the config at full widths with its
   vocabulary alone CUT to 10,000 rows: the serve scores of 512 samples
   and the losses of two train steps on the card against the same
   parameters and batch on the CPU, within 1e-4 of the CPU's largest
   magnitude; ``recsys_<model>``, the config at its published widths and
   vocabulary (dlrm-rm2's 26 x 1,000,000 x 64 tables, 6.66 GB): serve_p99
   (512) and serve_bulk (262,144) on ``data.recsys_data``'s zipf batches
   (ms a batch by CUDA events, samples/s), retrieval_cand (10^6
   candidates, ms a call), then 5 train steps at train_batch (65,536; s a
   step, samples/s, peak GB), the batch CUT by powers of two where the
   reckoning (5 copies of the parameters plus the autograd residuals a
   sample, counted by saved-tensor hooks on the card) passes 60 GB.
   ``recsys_bst_learn``: bst at full width, 8 steps at lr 1e-3, warm-up
   1, on one 4,096-sample batch: the loss falls by 1 %.
   ``recsys_launcher``: ``launch.train --arch bst --steps 2`` at full
   width.  NequIP (5 layers, 32 channels, l_max 2): ``gnn_check``, the
   molecule cell (128 graphs, 3,840 nodes, 8,192 edges) on the card
   against the CPU (energies and forces within 1e-4 of their largest
   magnitude) and rotated and shifted against itself (energies equal,
   forces rotating, within 1e-4); ``gnn_learn``, 8 steps on one molecule
   batch: the loss falls by 1 %; ``gnn_<cell>``, 5 train steps (s a step,
   edges/s, peak GB) at molecule, full_graph_sm (2,708 nodes, 10,556
   edges, d_feat 1,433), minibatch_lg (1,024 seeds sampled at fanout
   15-10 from a random CSR graph of Reddit's 232,965 nodes: 169,984
   nodes, 168,960 edges, d_feat 602) and ogb_products with nodes and
   edges CUT by the smallest power of two whose peak, reckoned from
   minibatch_lg's peak a sampled edge, stays under 60 GB, then halved
   while twice the measured peak stays under 60 GB (the full cell's
   reckoning logged beside it).  No recsys or GNN checkpoint is written
   on the card (a DLRM one is ~33 GB); the round trip is tested on the
   CPU.
11. Attention with a query offset and a key bound (phase ``attn_offset``,
   after the LM suite; ROADMAP item 7.6): ``models.layers.
   chunked_attention``, causal (query i at T - S + i) and not, with a
   seeded ``kv_valid`` holding a 0 and a T, at granite-3-2b's layer (B 8,
   32/8 heads, D 64, S 1,024 against T 2,048), deepseek-v2-lite's MLA
   layer (16 heads, Q/K 192, V 128, S 512) and S 2,048 against T 1,024
   (causal rows before the first key), bf16 and float32: the tensor-core
   and the CUDA-core kernels both launched.  Then on each case's inputs
   both kernels (``ops.flash_attention`` and ``flash_attention_simt``)
   against the plain version (``error_bound``), the tensor-core kernel
   also against ``ref.flash_attention_tc_ref``, every row that sees no
   key exactly 0; device, call and plain ms, SDPA with the mask as a
   boolean ``attn_mask``, and the bound over the pairs the mask leaves
   (the flash entries' ``offset_shapes``).  Row 7 re-timed at 8 x 2,048,
   S = T: no new arguments, a key bound of T (same bits), and SDPA, in
   turns.
12. The SSH steps (phases ``ssh_build_2048``, ``ssh_query_128``,
   ``ssh_query_2048``, after the subsequence phases, on the same seeded
   ECG stream; ROADMAP item 7.8): ``launch.steps``' build and query steps
   of ``ssh-ecg`` at full width, parameters from the spec's seed.
   ``build_2048``: 65,536 windows of 2,048 (stride 256), 5 timed steps
   (ms a step, series/s), the first 16,384 rows' signatures equal on
   the CPU, the sketch at that shape bit for bit against
   ``ref.sketch_conv_fma_ref``.  ``query_128``: the stream's 20,971,520
   windows of 128 at stride 1 (10.74 GB of series) hashed by the build
   step in calls of 2^20 rows (3.36 GB of signatures), 16 queries drawn
   from the database (ms a query; the self-match rate logged, not gated:
   at 17 sign bits and 3 shingles a series ~10^5 rows tie at all 40
   hashes and the top-1,024 takes the lowest ids), its first 65,536 rows
   rebuilt and 2 queries answered on the CPU (signatures and ids equal).
   ``query_2048``: the database CUT from 20,971,520 to 4,194,304 windows
   of 2,048 (34.4 GB; the full one is 171.8 GB), 16 queries, each its
   own top-1 at distance 0, its first 16,384 rows (cut from 65,536, to
   keep the script inside its time limit) rebuilt and 2 queries answered
   on the CPU as at 128.  One query's ``collision_count`` and DTW
   calls held to their plain versions and timed at each query shape
   (the ``ssh_step_shapes`` of the kernel entries).
13. Roofline: for each timed run (the 8 x 2,048 prefill, granite
   training, the four recsys train steps, NequIP ``minibatch_lg``, the
   SSH steps) the analytic MODEL_FLOPS at the run's own batch
   (``launch.analytic``) over its time and the 989-TFLOP/s bf16 peak
   (training's 6·N·tokens share beside it), written to
   ``build/roofline_measured.json`` for ``launch.roofline --measured``.
14. Census: one line a ``torch.profiler`` window
   (``bench.device_time.CENSUS``): the device records kept of each of
   the port's kernels against the launches their counters saw, the gap,
   the kernel-launch calls the profiler saw on the host against the
   kernels it recorded on the card, and the lead-in kernels that went
   unrecorded; a summary.

Prints a ``kernels`` JSON line and, last, ``{"ok": true, "device": ...}``.
Any failure raises and exits non-zero.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
F32_OPS_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
# 32-bit integer compare/add: at most one per FP32 lane per clock (INT32
# ALU plus IMAD on the FMA pipe), half the f32 rate, which counts an FMA
# as two operations
INT32_OPS_PER_S = 33.5e12
# float32 operations that do not fuse (the DTW cell's subtract, multiply,
# add and mins): one per FP32 lane per clock, 132 SMs x 128 lanes x 1.98
# GHz; F32_OPS_PER_S counts an FMA as two
F32_NONFUSED_OPS_PER_S = 33.5e12
BATCHES, BATCH_SIZE = 4, 64     # the batched path: 4 batches of 64 queries
SEQ_ROWS, SEQ_WARPED = 8, 8     # the sequential path: queries of batch 0
UCR_QUERIES, UCR_GOLD = 4, 2    # UCR scans, and how many brute force holds
# the launchers' build: synthetic-ECG points (their windows of --length at
# stride 1 are the database, 69,489 series at length 512)
LAUNCH_POINTS = 70_000
STREAM_SHARDS, STREAM_BLOCKS = 2, 8
# the engine phase: the reference's BatchPolicy defaults (max_batch 8,
# 2 ms), offered loads as fractions of the measured full-batch capacity
# (benchmarks/loadgen_bench.py:45-54), a Poisson trace a load holding
# about ENGINE_TRACE_S seconds of arrivals at that load (at most
# ENGINE_MAX_REQUESTS requests), and the SLO p99 <= max(100 ms, 4 x one
# full batch's service time); the traces were cut from 6 s to 3 s, then
# to 2 s to keep the script inside its time limit
ENGINE_MAX_BATCH, ENGINE_WAIT_MS = 8, 2.0
ENGINE_LOAD_FRACS = (0.25, 0.5, 0.75, 1.1)
ENGINE_ADAPTIVE_FRAC = 0.5
ENGINE_TRACE_S, ENGINE_MAX_REQUESTS = 2.0, 4096
ENGINE_S8_BATCHES = 15
ENGINE_SLO_FLOOR_MS, ENGINE_SLO_MULT = 100.0, 4.0
ENGINE_LAUNCHER_REQUESTS = 16
BF16_TC_OPS_PER_S = 989e12      # H100 SXM bf16 tensor cores, dense
PREFILL_32K_BATCH = 32          # the prefill_32k cell's batch (cut to 1)
LM_BATCH, LM_BATCH_LEN = 8, 2048                   # the batch prefill
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 8, 128, 32  # the serve loop
# prefill against stepped decode, as max |diff| / max |logit|.  In
# float32 the two paths differ by reordering only: 1e-4.  In bf16 each
# path lands about 4 % of max |logit| off the float32 result (the run
# logs both), because the two round to bf16 at other places (batched
# against one-row products, float32 against bf16 softmax weights) and 40
# residual layers of random weights carry the differences on: twice
# that, 10 %.  A wrong mask moves the logits by their own size.
GATE_REL_TOL = {"bfloat16": 0.10, "float32": 1e-4}
# step 8's other LM configs after granite-3-2b, each at full width in bf16:
# (phase, config module, layers kept, None for all).  dbrx's 40 layers are
# 263.2 GB of bf16 weights (6.52 GB a layer, embed and head 2.47 GB) on an
# 80 GB card: 8 layers, 54.6 GB, a cut that leaves room for the prefill's
# expert buffers.  Then deepseek-v2-lite in float32 (the CUDA-core flash
# kernel's MLA shape), 2 of its 27 layers (about 6.4 GB): a cut.
LM_SUITE = (("lm_8b", "granite_3_8b", None),
            ("lm_phi3", "phi3_mini_3_8b", None),
            ("lm_dbrx", "dbrx_132b", 8),
            ("lm_deepseek", "deepseek_v2_lite_16b", None))
# then the MoE models in float32 with their top-k routing held by the
# 1e-4 gate, 2 layers each (a cut): dbrx's (31 GB; the CUDA-core kernel
# at 128/128) and deepseek's (about 6.4 GB; the kernel at MLA's 192/128)
LM_SUITE_F32 = (("lm_dbrx_f32", "dbrx_132b", 2),
                ("lm_deepseek_f32", "deepseek_v2_lite_16b", 2))
SUITE_GEN = 32                  # greedy tokens of a suite phase's serve run
# the subsequence phases: one stream whose windows of 512 at hop 1 are
# the paper's 20,971,520 (configs/ssh_ecg.py's PAPER_N_SERIES), indexed
# at hop 1 (stride-1 sketch) and hop 6 (aligned, stride 3); gate 2's
# sample (the first and last SUBSEQ_EDGE windows and SUBSEQ_DRAWN drawn
# from --seed: 65,536); 8 cut and 8 warped queries; a tail for
# extend_stream with a pattern planted in it; two patterns planted in
# the first 2^18 windows, where subseq_exact compares every answer with
# the fixed-length path and the planted ones with brute force
SUBSEQ_POINTS = 20_972_031
SUBSEQ_HOPS = (1, 6)
SUBSEQ_EDGE, SUBSEQ_DRAWN = 4096, 57_344
SUBSEQ_CUT, SUBSEQ_WARPED = 8, 8
SUBSEQ_TAIL, SUBSEQ_TAIL_PLANT = 4096, 1200
SUBSEQ_PLANT = (6_000, 240_000)
SUBSEQ_SUFFIX = 1_000_003        # 12 bytes past a 16-byte boundary
SUBSEQ_EXACT_WINDOWS = 1 << 18
SUBSEQ_BRUTE_CHUNK = 1 << 17
SUBSEQ_ENC_REPEATS = 5           # timed per-window encodes of the sample
# the fleet phases: dist_bench's settings (benchmarks/dist_bench.py:43-51):
# R = 2 replicas over W = 4 workers, adaptive hedging at >= 5 ms, 50
# single-query calls a scenario, the slow worker 10x the healthy mean
# shard time; the distributed path's second mesh repeats the card 4 times;
# the reference CI's bar on p99 under failure (.github/workflows/ci.yml:138)
FLEET_REPLICATION, FLEET_WORKERS, FLEET_HEDGE_MS = 2, 4, 5.0
FLEET_CALLS, FLEET_SLOW_X, FLEET_DIST_SHARDS = 50, 10.0, 4
FLEET_LAUNCHER_REQUESTS = 16
FLEET_P99_BAR = 3.0
# step 9, LM training: granite-3-2b at full width and depth, the train_4k
# cell (seq 4096) with its batch CUT from 256 to TRAIN_BATCH sequences,
# TRAIN_STEPS steps.  A checkpoint of params and AdamW state is 14 bytes
# a parameter, 36.9 GB at full depth, and the H100 host this runs on
# takes at most 45 GiB of disk writes a run, deleted files included; the
# earlier phases' saved databases and fleet artifacts take most of that:
# so checkpoint and resume run at full width with the depth CUT to
# RESUME_LAYERS (3.7 GB a checkpoint, two written, the embedding and the
# head 2.8 GB of it): RESUME_STEPS steps uninterrupted, then
# RESUME_FROM steps with a checkpoint, then the resume from it to
# RESUME_STEPS.  train_learn at full width cut to 2 layers (the
# reference's test_loss_decreases: lr 3e-3, warm-up 1, one repeated
# batch); train_deepseek at full width cut to 2 of 27 layers
TRAIN_BATCH, TRAIN_STEPS = 4, 5
RESUME_LAYERS, RESUME_FROM, RESUME_STEPS = 1, 2, 4
LEARN_LAYERS, LEARN_BATCH, LEARN_LEN, LEARN_STEPS = 2, 4, 1024, 8
DEEPSEEK_LAYERS, DEEPSEEK_BATCH, DEEPSEEK_LEN, DEEPSEEK_STEPS = 2, 2, 2048, 3
# the resumed run against the uninterrupted one: the loss of the first
# resumed step is computed from the same bits (the checkpoint is exact)
# on the same batch; later ones after updates whose embedding gradient is
# summed with atomics in another order
TRAIN_RESUME_LOSS_RTOL = 1e-3
# train_grad's layer shapes: (tag, (B, H, Hk, S, D, Dv), dtype, scale)
TRAIN_GRAD_CASES = (
    ("granite", (1, 32, 8, 4096, 64, 64), torch.bfloat16, None),
    ("deepseek", (1, 16, 16, 2048, 192, 128), torch.bfloat16, 192 ** -0.5),
    ("float32", (1, 32, 8, 1024, 64, 64), torch.float32, None))
# step 10, the recsys and GNN families at full width in float32.  Recsys:
# each config at its published widths and vocabularies, serve_p99 and
# serve_bulk on data.recsys_data's batches (zipf ids), retrieval_cand,
# RECSYS_TRAIN_STEPS train steps at train_batch; a train cell whose
# reckoned peak (5 copies of the parameters: themselves, gradients, m, v
# and the float32 master; the autograd residuals a sample, counted by
# saved-tensor hooks on a RECKON_BATCH-sample forward on the card, times
# the batch) passes MEMORY_BUDGET_GB has its batch CUT by powers of two.
# The CUDA-against-CPU gate runs each config at full widths with the
# vocabulary alone cut to RECSYS_CHECK_VOCAB rows, on RECSYS_CHECK_BATCH
# samples.  NequIP: GNN_TRAIN_STEPS train steps at each cell on the
# data.graph generators; minibatch_lg samples 1,024 seeds at fanout
# 15-10 from a random CSR graph of Reddit's node count with
# MB_GRAPH_DEGREE in-edges a node; ogb_products has nodes and edges CUT
# by the smallest power of two whose peak, reckoned from minibatch_lg's
# measured peak a sampled edge, stays under MEMORY_BUDGET_GB, then
# halved while twice its own measured peak stays under it.
RECSYS_ARCHS = ("dlrm-rm2", "bst", "mind", "dien")
RECSYS_TRAIN_STEPS = 5
RECSYS_CHECK_VOCAB, RECSYS_CHECK_BATCH = 10_000, 512
RECKON_BATCH = 256
MEMORY_BUDGET_GB = 60.0
# card against CPU, relative to the largest magnitude; the symmetry gates
FAMILY_RTOL = 1e-4
FAMILY_LEARN_STEPS, FAMILY_LEARN_BATCH = 8, 4096
GNN_CELLS = ("molecule", "full_graph_sm", "minibatch_lg", "ogb_products")
GNN_TRAIN_STEPS = 5
# step 11, attention with an offset and a key bound: granite-3-2b's layer
# (B 8, 32/8 heads, D 64) at S 1,024 against T 2,048, deepseek-v2-lite's
# MLA layer (16 heads, Q/K 192, V 128) at S 512, and S 2,048 against T
# 1,024 (rows before the first key)
ATTN_BATCH, ATTN_S, ATTN_T = 8, 1024, 2048
ATTN_MLA_BATCH, ATTN_MLA_S = 8, 512
# step 12, the SSH steps: build_2048's series and the windows of the ECG
# stream they are (at this stride); timed steps; queries a query cell;
# rows the card is held to the CPU on (a query database's first rows, by
# length; build_2048's first rows); rows a build call when the databases
# are made
SSH_BUILD_BATCH, SSH_BUILD_STRIDE = 65_536, 256
SSH_BUILD_STEPS = 5
SSH_QUERIES = 16
SSH_CPU_ROWS = {128: 65_536, 2048: 16_384}     # 2048: cut from 65,536
SSH_CPU_BUILD_ROWS = 16_384
SSH_DB_CHUNK = {128: 1 << 20, 2048: 1 << 16}
# the query databases: query_128's at full size, query_2048's CUT from
# 20,971,520 rows (171.8 GB of float32 series) to 4,194,304 (34.4 GB)
SSH_DB_128_ROWS, SSH_DB_2048_ROWS = 20_971_520, 4_194_304
MB_GRAPH_NODES, MB_GRAPH_DEGREE = 232_965, 50
MB_SEEDS, MB_FANOUTS = 1024, (15, 10)


PAPER_CASCADE_QUERIES = 16      # cascade_stats and srp_search queries
PAPER_CPU_ROWS = 65_536         # rows the card's answers are held to the CPU on
PAPER_BRUTE = 2                 # best_so_far values held to brute_force_topk
# queries of the 16 also run whole on the CPU (cascade_stats ~2.3 s and
# srp_search ~0.45 s each at 65,536 rows on the card's host): a database
# row and a warped copy
PAPER_CPU_QUERIES = (0, 8)
# rows a build_signatures chunk: 256 (the reference's default) took 8.1
# s at 2^20 rows on an H100, host dispatch of 4,096 chunks
PAPER_BUILD_BATCH = 4096
PAPER_PAIRWISE = (64, 512)      # dtw_pairwise: queries x candidates
PAPER_SRP_BITS = 64             # the "srp" encoder's default K
# rectangular dtw: (m_x, m_y) slices of database rows, band 25 and None,
# each held to the float64 DP (pure Python, ~0.1 s a 20,000 cells)
PAPER_RECT = ((160, 128), (128, 160), (256, 200))
PAPER_SKETCH_HOLD = 64          # hold every 64th sketch chunk of the builds
PAPER_SRP_DTW_HOLD = 2          # srp_search DTW calls (radius 511) held
# step 5a', the encoder composition: rows through a shingler with only the
# protocol's members (the dense route: (64, K, 2^15) CWS scores a block),
# "ssh-cs" rows built on the card and on the CPU, rows through each
# encoder's pure_encode_fn
PIPELINE_DENSE_ROWS = 1024
PIPELINE_CS_ROWS = 4096
PIPELINE_PURE_ROWS = 64


def log(*a):
    print(*a, flush=True)


def cuda_time_ms(fn, min_iters=5, budget_ms=300.0):
    """Mean ms per call by CUDA events around back-to-back calls, after a
    warm-up (``repro_torch.bench.device_time.call_ms``)."""
    from repro_torch.bench.device_time import call_ms
    return call_ms(fn, min_iters, budget_ms)


def kernel_times(kernel_fn, library_fn=None):
    """Device ms a call (``torch.profiler``'s kernel time,
    ``repro_torch.bench.device_time``) as ``ms`` and the call time (CUDA
    events around back-to-back calls) as ``call_ms``, of a kernel and of
    its library yardstick when there is one; whether the profiled window
    kept every record, how many windows were profiled to get one that
    kept any (``device_windows``; 1 unless a window came back empty), and
    where the device time came from (``device_source``: ``"profiler"``,
    or ``"events"``, ``device_time.spun_ms``, when every window came
    back empty)."""
    from repro_torch.bench.device_time import timed
    k = timed(kernel_fn)
    out = dict(ms=k["device_ms"], call_ms=k["call_ms"],
               device_window_complete=k["device_complete"],
               device_windows=k["device_windows"],
               device_source=k["device_source"])
    if library_fn is not None:
        lib = timed(library_fn)
        out.update(library_ms=lib["device_ms"],
                   library_call_ms=lib["call_ms"],
                   library_window_complete=lib["device_complete"],
                   library_windows=lib["device_windows"],
                   library_source=lib["device_source"])
    return out


def bound_ms(n_bytes, n_ops, ops_per_s=F32_OPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


class DropCounter:
    """While active, counts the (token, choice) assignments that
    ``models.moe.gating`` makes and those past their expert's capacity
    (one wait for the card, when read), and keeps each call's experts."""

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.saved, self.kept, self.total = moe, moe.gating, [], 0
        self.experts = []

        def spy(logits, cfg, n_g):
            routing, aux = self.saved(logits, cfg, n_g)
            self.kept.append(routing.keep.sum())
            self.total += routing.keep.numel()
            self.experts.append(routing.expert)
            return routing, aux
        moe.gating = spy
        return self

    def __exit__(self, *exc):
        self.moe.gating = self.saved

    @property
    def dropped(self) -> int:
        return self.total - int(sum(self.kept)) if self.kept else 0

    @property
    def share(self) -> float:
        return self.dropped / max(1, self.total)

    def flips(self, b, p, n_layers):
        """Over a ``serve_lm`` run with no generated tokens (p prompt
        steps of b tokens, then one prefill of the b x p prompts in whole
        groups): the (token, layer) pairs whose set of experts the
        stepped decode chose differs from the prefill's, and of how
        many."""
        k = self.experts[0].shape[-1]
        dec = torch.stack([torch.stack([self.experts[i * n_layers + j]
                                        .reshape(b, k)
                                        for j in range(n_layers)])
                           for i in range(p)])                 # (p, L, b, k)
        pre = torch.stack([self.experts[p * n_layers + j].reshape(b, p, k)
                           for j in range(n_layers)])          # (L, b, p, k)
        pre = pre.permute(2, 0, 1, 3)
        differ = (dec.sort(-1).values != pre.sort(-1).values).any(-1)
        return int(differ.sum()), differ.numel()


class _Enough(Exception):
    """Raised by a Recorder once it holds ``stop_after`` calls."""


class Recorder:
    """Pass-through around the ``kernels.ops`` entry points that keeps
    the arguments of every call (a path's own kernel inputs).  With
    ``stop_after=n`` the n-th call is recorded and the run stopped there
    instead of computed (the context swallows the stop)."""

    def __init__(self, ops, names, stop_after=None):
        self.ops, self.names, self.calls = ops, names, {n: [] for n in names}
        self.saved, self.stop_after = {}, stop_after

    def __enter__(self):
        for n in self.names:
            fn = getattr(self.ops, n)
            self.saved[n] = fn

            def spy(*args, _fn=fn, _n=n, **kw):
                self.calls[_n].append((args, kw))
                if len(self.calls[_n]) == self.stop_after:
                    raise _Enough
                return _fn(*args, **kw)
            setattr(self.ops, n, spy)
        return self

    def __exit__(self, exc_type, *exc):
        for n, fn in self.saved.items():
            setattr(self.ops, n, fn)
        return exc_type is _Enough


def arg(call, i, name):
    """Positional argument ``i`` or keyword ``name`` of a recorded call."""
    args, kw = call
    return args[i] if len(args) > i else kw.get(name)


def check_hash_range(qk, dbk):
    if int(max(qk.max(), dbk.max())) >= 1 << 24 or int(qk.min()) < 0:
        raise AssertionError("hash values outside [0, 2^24): the float "
                             "yardstick would not be exact")


def collision_check(q1, dbk1):
    """Hold one ``collision_count`` call exact to its plain version."""
    from repro_torch.kernels import ops, ref
    got = ops.collision_count(q1, dbk1)
    want = ref.collision_count_ref(q1, dbk1)
    if not torch.equal(got, want):
        raise AssertionError(
            f"collision_count is not exact at db {tuple(dbk1.shape)}: "
            f"{int((got != want).sum())} counts differ")
    return want


def collision_at(q1, dbk1):
    """Check and time one ``collision_count`` call, with its bound and
    its cdist yardstick."""
    from repro_torch.kernels import ops, ref
    plain = collision_check(q1, dbk1)
    check_hash_range(q1, dbk1)
    k1 = q1.shape[0]

    def cdist_one():
        return k1 - torch.cdist(q1[None].float(), dbk1.float(), p=0)[0]
    if not torch.equal(cdist_one().to(torch.int32), plain):
        raise AssertionError("cdist yardstick disagrees with the counts")
    del plain
    bms, bkind = bound_ms(4 * (q1.numel() + dbk1.numel() + dbk1.shape[0]),
                          2 * dbk1.shape[0] * k1, INT32_OPS_PER_S)
    return dict(
        max_abs_err=0.0,
        **kernel_times(lambda: ops.collision_count(q1, dbk1), cdist_one),
        plain_ms=cuda_time_ms(lambda: ref.collision_count_ref(q1, dbk1)),
        bound_ms=bms, bound_by=bkind,
        shape=f"query {tuple(q1.shape)} db {tuple(dbk1.shape)}")


DTW_BOUND_NOTE = ("6 operations a DP cell (a subtract, a multiply, an add "
                  "and three mins; none fuses) at 33.5e12 non-fused f32 "
                  "operations a second (132 SMs x 128 lanes x 1.98 GHz); "
                  "cells as the plain wavefront counts them "
                  "(core.dtw.dtw_pairs_work)")


def dtw_call(kernel, call):
    """(q, c, r, thr, plain) of a recorded DTW call, after checking it
    through the rule and each schedule that takes its radius, bit for
    bit against the plain version; the rule's schedule too."""
    from repro_torch.core import dtw as core_dtw
    from repro_torch.kernels import dtw_wavefront as kd
    from repro_torch.kernels import ref
    q, c, band = call[0][:3]
    thr = arg(call, 3, "threshold")
    n_, m_ = c.shape
    r = core_dtw.radius(band, m_)
    pairs = kernel == "dtw_wavefront_pairs"
    plain = (ref.dtw_pairs_ref(q, c, band, thr) if pairs
             else ref.dtw_wavefront_ref(q, c, band, thr))
    fn = kd.dtw_wavefront_pairs if pairs else kd.dtw_wavefront
    for sched in (None, *dtw_schedules_for(r)):
        got = fn(q, c, r, thr, schedule=sched)
        if not torch.equal(got, plain):
            raise AssertionError(
                f"{kernel} ({sched or 'rule'}) is not bit-identical on "
                f"{int((got != plain).sum())} of {n_} pairs "
                f"({n_}, {m_}) radius {r}")
    return q, c, r, thr, plain, kd.dtw_schedule(n_, m_, r)


def dtw_shape(kernel, call, min_plain_iters):
    """Times, bound, rate and schedules of one recorded DTW call."""
    from repro_torch.core import dtw as core_dtw
    from repro_torch.kernels import dtw_wavefront as kd
    from repro_torch.kernels import ref
    q, c, r, thr, plain, rule = dtw_call(kernel, call)
    pairs = kernel == "dtw_wavefront_pairs"
    fn = kd.dtw_wavefront_pairs if pairs else kd.dtw_wavefront
    cells = int(core_dtw.dtw_pairs_work(
        q if pairs else q.expand_as(c), c, r, thr)[1].sum())
    bms, bkind = bound_ms(4 * (q.numel() + c.numel() + 2 * c.shape[0]),
                          6 * cells, F32_NONFUSED_OPS_PER_S)
    per_sched = {s: float(np.mean(v)) for s, v in in_turns(
        {s: (lambda s=s: fn(q, c, r, thr, schedule=s))
         for s in dtw_schedules_for(r)}).items()}
    times = kernel_times(lambda: fn(q, c, r, thr, schedule=rule))
    ms = times["ms"]
    plain_fn = ((lambda: ref.dtw_pairs_ref(q, c, r, thr)) if pairs
                else (lambda: ref.dtw_wavefront_ref(q, c, r, thr)))
    return dict(
        **times,
        plain_ms=cuda_time_ms(plain_fn, min_iters=min_plain_iters),
        bound_ms=bms, bound_by=bkind, schedule=rule,
        schedule_call_ms=per_sched, cells=cells,
        gcells_per_s=cells / ms / 1e6, share_of_bound=bms / ms,
        shape=f"{'pairs' if pairs else 'query'} {tuple(q.shape)} "
              f"candidates {tuple(c.shape)} radius {r} threshold "
              f"{thr is not None}; "
              f"{int((plain >= core_dtw.BIG * 0.5).sum())} abandoned; "
              f"{cells} cells run")


def dtw_calls_log(kernel, calls):
    """The rule's schedule of every recorded call, in order (each call
    checked by ``dtw_call``)."""
    from repro_torch.core import dtw as core_dtw
    return [f"({c[0][1].shape[0]}, {c[0][1].shape[1]}) r "
            f"{core_dtw.radius(c[0][2], c[0][1].shape[1])} thr "
            f"{arg(c, 3, 'threshold') is not None}: "
            f"{dtw_call(kernel, c)[5]}" for c in calls]


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def persist_paths(args, counted, ctx) -> None:
    """Path e: save/load of the batched index and of the streaming
    ``"ssh-cs"`` database, the host-bucket probe, the ``"srp"`` and
    ``"ssh-multires"`` encoders at full scale, the two launchers as
    subprocesses and the signature LRU (step 3e of the docstring).  Every
    saved directory lives under ``build/`` and is removed when read."""
    import shutil
    import tempfile
    from repro_torch.core import search
    from repro_torch.db import TimeSeriesDB
    from repro_torch.encoders import IndexSpec
    from repro_torch.kernels import ops

    series, batches, cfg = ctx["series"], ctx["batches"], ctx["cfg"]
    db, results = ctx["db"], ctx["results"]
    n, m = series.shape
    half = BATCH_SIZE // 2
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="persist_", dir=root))
    free = shutil.disk_usage(tmp).free
    # series and two envelopes a database; one is on disk at a time
    need = 2 * (series.nbytes * 3)
    log(f"persist: saving under {tmp}, {free / 1e9:.1f} GB free there; "
        f"one saved {n} x {m} database holds about "
        f"{3 * series.nbytes / 1e9:.1f} GB")
    if free < need:
        raise AssertionError(f"persist: {free / 1e9:.1f} GB free under "
                             f"{tmp}, fewer than the {need / 1e9:.1f} GB the "
                             f"phase needs at {n} series")

    def same_answers(got, want, what):
        for bi, (g_b, w_b) in enumerate(zip(got, want)):
            for i, (g, w) in enumerate(zip(g_b, w_b)):
                if not (np.array_equal(g.ids, w.ids)
                        and np.array_equal(g.dists, w.dists)):
                    raise AssertionError(
                        f"{what}: batch {bi} query {i} ids {g.ids} dists "
                        f"{g.dists} != {w.ids} {w.dists}")

    def self_matched(res, rows, what):
        bad = [int(rows[i]) for i, r in enumerate(res[:half])
               if int(r.ids[0]) != int(rows[i])]
        if bad:
            raise AssertionError(f"{what}: database rows {bad} are not "
                                 f"their own top-1")

    # 1. the batched index: save, load, the same answers bit for bit
    d1 = tmp / "ssh_ecg"
    t = time.perf_counter()
    db.save(d1)
    save_s = time.perf_counter() - t
    nbytes = dir_bytes(d1)
    torch.cuda.synchronize()
    t = time.perf_counter()
    db2 = TimeSeriesDB.load(d1)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    shutil.rmtree(d1)

    def loaded_path():
        return [db2.search_batch(qs) for _, qs in batches]

    got = counted("persist_load", ("sketch_conv", "collision_count_batch",
                                   "dtw_wavefront_pairs"), loaded_path)
    same_answers(got, results, "loaded index")
    log(f"persist: saved {len(db)} series in {save_s:.2f} s, "
        f"{nbytes / 1e9:.3f} GB ({nbytes / save_s / 1e9:.2f} GB/s); loaded "
        f"onto the card in {load_s:.2f} s ({nbytes / load_s / 1e9:.2f} "
        f"GB/s); the build of the same index took {ctx['build_s']:.2f} s; "
        f"{BATCHES} x {BATCH_SIZE} queries answer bit-identically")

    # 2. the streaming database: save, load, one more chunk into both
    db_cs = ctx["db_cs"]
    d2 = tmp / "ssh_cs"
    t = time.perf_counter()
    db_cs.save(d2)
    cs_save_s = time.perf_counter() - t
    t = time.perf_counter()
    db_cs2 = TimeSeriesDB.load(d2)
    torch.cuda.synchronize()
    cs_load_s = time.perf_counter() - t
    shutil.rmtree(d2)
    chunk = series[:4096] + np.float32(0.01)

    def ingest_both():
        for d in (db_cs, db_cs2):
            d.add_stream(chunk)
            d.flush()

    counted("persist_cs", ("sketch_conv", "cs_tables"), ingest_both)
    for name in ("signatures", "keys", "series"):
        if not torch.equal(getattr(db_cs.index, name),
                           getattr(db_cs2.index, name)):
            raise AssertionError(f"ssh-cs after load and ingest: {name} "
                                 f"differ from the never-saved database")
    if not torch.equal(db_cs.index.encoder.aggregate_sketch(),
                       db_cs2.index.encoder.aggregate_sketch()):
        raise AssertionError("ssh-cs after load and ingest: cs/agg differs")
    log(f"persist: ssh-cs database of {len(db_cs2) - 4096} series saved in "
        f"{cs_save_s:.2f} s, loaded in {cs_load_s:.2f} s; after one more "
        f"4096-row chunk into both, signatures, keys and cs/agg are equal")
    del db_cs2

    # 3. host buckets on the loaded index, through the local searcher
    t = time.perf_counter()
    db_hb = TimeSeriesDB(db2.index, cfg.replace(searcher="local",
                                                use_host_buckets=True))
    hb_s = time.perf_counter() - t
    rows0, qs0 = batches[0]
    hb_pick = ctx["seq_pick"]

    def host_bucket_path():
        out, walls = [], []
        for i in hb_pick:
            torch.cuda.synchronize()
            t = time.perf_counter()
            out.append(db_hb.search(qs0[i]))
            walls.append(time.perf_counter() - t)
        return out, walls

    hb_res, hb_walls = counted("persist_host_buckets", ("dtw_wavefront",),
                               host_bucket_path)
    bad = [int(rows0[i]) for i, r in zip(hb_pick, hb_res)
           if i < half and int(r.ids[0]) != int(rows0[i])]
    if bad:
        raise AssertionError(f"host buckets: database rows {bad} are not "
                             f"their own top-1")
    log(f"persist: host buckets of {len(db2)} x {db2.index.num_tables} keys "
        f"built in {hb_s:.2f} s; {len(hb_pick)} queries, the "
        f"{sum(i < half for i in hb_pick)} database rows self-matched; "
        f"candidates a query {[r.n_candidates for r in hb_res]}; "
        f"us_per_query {np.mean(hb_walls[1:]) * 1e6:.1f} (mean of queries "
        f"2-{len(hb_walls)}; the first {hb_walls[0] * 1e6:.1f}) probe_us "
        f"{np.mean([r.stats.stage_us['probe'] for r in hb_res[1:]]):.1f}")
    db2.index.host_buckets = None

    # 4. the srp and ssh-multires encoders at full scale
    ucr_ids = [u.ids for u in ctx["ucr_res"]]
    precision = {"ssh": ctx["precs"]}
    for name, spec, kernels in (
            ("srp", IndexSpec(encoder="srp"),
             ("collision_count_batch", "dtw_wavefront_pairs")),
            ("ssh-multires", IndexSpec(encoder="ssh-multires"),
             ("sketch_conv", "collision_count_batch",
              "dtw_wavefront_pairs"))):
        rows, qs = batches[0]

        def encoder_path():
            t = time.perf_counter()
            d = TimeSeriesDB.build(series, spec, cfg)
            torch.cuda.synchronize()
            return d, time.perf_counter() - t, d.search_batch(qs)

        d, b_s, res = counted(f"persist_{name}", kernels, encoder_path)
        self_matched(res, rows, name)
        dd = tmp / name
        d.save(dd)
        res2 = TimeSeriesDB.load(dd).search_batch(qs)
        shutil.rmtree(dd)
        same_answers([res2], [res], f"{name} after save and load")
        precision[name] = [search.precision_at_k(res[i].ids, u, cfg.topk)
                           for i, u in zip(ctx["ucr_pick"], ucr_ids)]
        log(f"persist: {name} {d} built in {b_s:.2f} s; batch 0 "
            f"self-matched, answers bit-identical after save and load; "
            f"precision@{cfg.topk} against UCR on the {len(ucr_ids)} UCR "
            f"queries {precision[name]} (ssh {precision['ssh']})")
        del d, res, res2
        gc.collect()
        torch.cuda.empty_cache()

    # 5. the launchers, as a user runs them
    src = Path(__file__).resolve().parent / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    out = tmp / "built"
    cmds = [[sys.executable, "-m", "repro_torch.launch.build_index",
             "--points", str(LAUNCH_POINTS), "--length", str(m),
             "--out", str(out)],
            [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
             "ssh-ecg", "--sequential", "--db-dir", str(out)]]

    def launchers():
        outs = []
        for cmd in cmds:
            t = time.perf_counter()
            p = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=600, cwd=src.parent, env=env)
            outs.append((p, time.perf_counter() - t))
            if p.returncode != 0:
                raise AssertionError(f"{' '.join(cmd[1:4])} exit "
                                     f"{p.returncode}: {p.stderr[-3000:]}")
        return outs

    (b, b_t), (srv, s_t) = counted("persist_launchers", (), launchers)
    shutil.rmtree(out)
    if "loaded database" not in srv.stdout:
        raise AssertionError(f"serve --db-dir did not load the database: "
                             f"{srv.stdout[-2000:]}")
    log(f"persist: build_index --points {LAUNCH_POINTS} --length {m} "
        f"{b_t:.1f} s: {b.stdout.strip().splitlines()[-1]}")
    log(f"persist: serve --sequential --db-dir {s_t:.1f} s: "
        f"{' | '.join(srv.stdout.strip().splitlines()[-3:])}")

    # 6. the signature LRU: batch 0 twice on the loaded index, from an
    # empty LRU (the loaded path above filled it), so the first encodes
    db2.index.sig_cache = None
    first = ops_batch_stats(db2, batches[0][1])
    again = counted("persist_sig_cache", ("collision_count_batch",
                                          "dtw_wavefront_pairs"),
                    lambda: ops_batch_stats(db2, batches[0][1]))
    if ops.launch_counts()["sketch_conv"]:
        raise AssertionError("signature LRU: the repeated batch launched "
                             "sketch_conv")
    if again[1].sig_cache_hit != BATCH_SIZE:
        raise AssertionError(f"signature LRU: {again[1].sig_cache_hit} "
                             f"hits for the repeated batch, expected "
                             f"{BATCH_SIZE}")
    if not np.array_equal(again[0], first[0]):
        raise AssertionError("signature LRU: a cached batch answers "
                             "other ids")
    log(f"persist: repeated batch 0 on the loaded index: sig_cache_hit "
        f"{first[1].sig_cache_hit} then {again[1].sig_cache_hit}, the same "
        f"ids, no sketch_conv launch on the hit; encode stage "
        f"{first[1].stage_us['encode']:.1f} us encoding, "
        f"{again[1].stage_us['encode']:.1f} us on the hit")
    shutil.rmtree(tmp, ignore_errors=True)


def padded_share(hist, buckets) -> float:
    """Share of the rows the engine searched that were bucket padding,
    from its histogram of real batch sizes."""
    real = sum(b * c for b, c in hist.items())
    padded = sum(next(s for s in buckets if s >= b) * c
                 for b, c in hist.items())
    return (padded - real) / padded if padded else 0.0


def engine_paths(args, counted, ctx) -> None:
    """The dynamic-batching ``ServingEngine`` behind
    ``TimeSeriesDB(searcher="engine")`` on the 2^20 index (step 6 of the
    docstring).  Raises on any gate; a batch's exception reaches its
    futures and ``run_trace`` re-raises it.  Returns the kernels' calls
    recorded on one batch of 8 and one of 1, {size: {name: [(args,
    kwargs)]}}."""
    from repro_torch.data.timeseries import extract_subsequences, \
        synthetic_ecg
    from repro_torch.db import BatchPolicy, TimeSeriesDB
    from repro_torch.encoders.sigcache import SignatureCache
    from repro_torch.kernels import ops
    from repro_torch.loadgen import (Mixture, WorkloadSpec, generate_trace,
                                     run_trace, sweep)
    from repro_torch.loadgen.harness import SUSTAINED_FRAC
    from repro_torch.serving import ssh_search_batch

    rows, pool = ctx["batches"][0]
    cfg, index = ctx["cfg"], ctx["db"].index
    n, m = ctx["series"].shape
    half = len(rows) // 2
    policy = BatchPolicy(max_batch=ENGINE_MAX_BATCH,
                         max_wait_ms=ENGINE_WAIT_MS)
    cfg_e = cfg.replace(searcher="engine", batch_policy=policy)
    buckets = cfg_e.buckets()
    # a one-entry signature LRU: the pool's 64 queries repeat within a
    # trace, and a batch whose rows were all cached would skip the sketch;
    # with one entry every batch of two or more rows encodes, as new
    # traffic does (hits are counted and logged)
    index.sig_cache = SignatureCache(capacity=1)
    engines = []

    def make(mode="fixed"):
        tsdb = TimeSeriesDB(index, cfg_e.replace(
            batch_policy=policy.replace(mode=mode)))
        engines.append(tsdb.engine)
        return engines[-1]

    pools, sizes = {m: pool}, {m: len(pool)}
    want = ssh_search_batch(pool, index, config=cfg_e)   # one block of 64
    want = [want.per_query(i) for i in range(len(pool))]

    def check_answers(res, trace, what):
        for k, (ids, dists) in enumerate(zip(res.ids, res.dists)):
            pid, topk = int(trace.pool_ids[k]), int(trace.topks[k])
            w = want[pid]
            if not (np.array_equal(ids, w.ids[:topk])
                    and np.array_equal(dists, w.dists[:topk])):
                raise AssertionError(
                    f"engine {what}: request {k} (pool row {pid}) ids {ids} "
                    f"dists {dists} != the block's {w.ids} {w.dists}")
            if pid < half and int(ids[0]) != int(rows[pid]):
                raise AssertionError(f"engine {what}: database row "
                                     f"{rows[pid]} is not its own top-1")

    def traffic():
        # every bucket warmed through engine.searcher, outside the metrics
        warm = make()
        for size in buckets:
            warm.searcher.search_batch(pool[:size])
        service = {}                # bucket -> seconds a batch, each run
        for size in buckets:
            service[size] = []
            for r in range(ENGINE_S8_BATCHES):
                block = pool[(np.arange(size) + size * r) % len(pool)]
                t = time.perf_counter()
                warm.searcher.search_batch(block)  # ends with host arrays
                service[size].append(time.perf_counter() - t)
        s8s = service[ENGINE_MAX_BATCH]
        s8 = float(np.median(s8s))
        capacity = ENGINE_MAX_BATCH / s8
        slo_ms = max(ENGINE_SLO_FLOOR_MS, ENGINE_SLO_MULT * s8 * 1e3)
        log(f"engine: full batch of {ENGINE_MAX_BATCH} s8 median "
            f"{s8 * 1e3:.3f} ms over {ENGINE_S8_BATCHES} (min "
            f"{min(s8s) * 1e3:.3f}, max {max(s8s) * 1e3:.3f}); capacity "
            f"{capacity:.1f} qps; SLO p99 <= {slo_ms:.1f} ms; median ms "
            f"a batch by bucket { {b: round(float(np.median(v)) * 1e3, 3)
                                   for b, v in service.items()} }")
        base = WorkloadSpec(
            process="poisson", rate_qps=capacity, seed=args.seed,
            n_requests=32, lengths=Mixture((m,)), topks=Mixture((cfg.topk,)))
        with warm:                  # first live replay's one-time costs
            run_trace(warm, generate_trace(base.replace(
                rate_qps=ENGINE_LOAD_FRACS[0] * capacity), sizes), pools)
        points = []
        for mode, fracs in (("fixed", ENGINE_LOAD_FRACS),
                            ("adaptive", (ENGINE_ADAPTIVE_FRAC,))):
            best = 0.0
            for f in fracs:
                # ~ENGINE_TRACE_S of arrivals at this load, so the drain
                # after the last arrival is a small share of the window
                load = f * capacity
                spec = base.replace(n_requests=int(min(
                    ENGINE_MAX_REQUESTS, max(16, round(
                        load * ENGINE_TRACE_S)))))
                (res,), b = sweep(lambda mode=mode: make(mode), spec, [load],
                                  pools, slo_ms)
                best = max(best, b)
                points.append((mode, f, load, spec, res, engines[-1]))
            log(f"engine {mode}: max_sustainable_qps {best:.1f} of offered "
                f"{[round(f * capacity, 1) for f in fracs]} (SLO p99 <= "
                f"{slo_ms:.1f} ms, achieved >= {SUSTAINED_FRAC} x offered)")
        return points

    points = counted("engine", ("sketch_conv", "collision_count_batch",
                                "dtw_wavefront_pairs"), traffic)
    by = {(mode, f): r for mode, f, _, _, r, _ in points}
    if not by[("fixed", ENGINE_ADAPTIVE_FRAC)].same_answers(
            by[("adaptive", ENGINE_ADAPTIVE_FRAC)]):
        raise AssertionError("engine: fixed and adaptive batching answer the "
                             "same trace differently")
    for mode, frac, load, spec, res, eng in points:
        # the trace sweep() replayed at this load
        trace = generate_trace(spec.replace(rate_qps=float(load)), sizes)
        check_answers(res, trace, f"{mode} {frac}")
        snap = eng.metrics.snapshot()
        log(f"engine {mode} {frac} x capacity: offered "
            f"{res.offered_qps:.1f} (the trace's own rate "
            f"{len(trace) / trace.duration_s:.1f}: {len(trace)} arrivals in "
            f"{trace.duration_s:.3f} s) achieved {res.achieved_qps:.1f} qps, "
            f"{res.n_requests} requests in {res.wall_s:.3f} s; latency from "
            f"arrival p50 {res.latency_p50_ms:.3f} p95 "
            f"{res.latency_p95_ms:.3f} p99 {res.latency_p99_ms:.3f} ms; "
            f"queue depth p95 {res.queue_depth_p95:.0f} max "
            f"{res.queue_depth_max:.0f}; batches "
            f"{dict(sorted(res.batch_histogram.items()))} mean "
            f"{res.batch_size_mean:.2f}, wait {res.batch_wait_ms_mean:.3f} "
            f"ms, occupancy {res.batch_occupancy_mean:.3f}; padded rows "
            f"{padded_share(res.batch_histogram, buckets):.3f}; stage_us a "
            f"batch { {k: round(v, 1) for k, v in res.stage_us.items()} }; "
            f"service EWMA {eng.service_ewma_s * 1e3:.3f} ms; sig-cache hits "
            f"{snap['sig_cache_hits_total']}; answers equal to the block's")
    log("engine: fixed and adaptive answers bit-identical over one trace")

    # the kernels' inputs at the engine's own shapes: a full batch (4
    # database rows, 4 warped copies) and a batch of one warped copy
    # through the engine's searcher, each from an empty LRU so it encodes
    # (held to the plain versions in ssh_paths)
    recorded, searcher = {}, make().searcher
    blocks = {ENGINE_MAX_BATCH: list(range(ENGINE_MAX_BATCH // 2))
              + list(range(half, half + ENGINE_MAX_BATCH // 2)), 1: [half]}
    for size, picks in blocks.items():
        index.sig_cache = SignatureCache(capacity=1)
        with Recorder(ops, ("sketch_conv", "collision_count_batch",
                            "dtw_rerank_pairs")) as rec:
            searcher.search_batch(pool[picks])
        missing = [k for k, v in rec.calls.items() if not v]
        if missing:
            raise AssertionError(f"engine: a batch of {size} through the "
                                 f"engine's searcher called no {missing}")
        recorded[size] = rec.calls
    index.sig_cache = SignatureCache(capacity=1)

    # stop() with requests queued: every future resolves, answers right
    def burst():
        eng = make()
        eng.start()
        futs = [eng.submit(q) for q in pool]
        eng.stop()
        return eng, futs

    eng, futs = counted("engine_stop", ("collision_count_batch",), burst)
    if not all(f.done() for f in futs):
        raise AssertionError(f"engine: {sum(not f.done() for f in futs)} "
                             f"futures unresolved after stop()")
    for i, f in enumerate(futs):
        if not np.array_equal(f.result().ids, want[i].ids):
            raise AssertionError(f"engine: pool row {i} answered "
                                 f"{f.result().ids} around stop(), the "
                                 f"block {want[i].ids}")
    log(f"engine: {len(futs)} requests submitted then stop(): all resolved "
        f"({eng.metrics.snapshot()['batches_total']} batches, histogram "
        f"{dict(sorted(eng.metrics.batch_histogram().items()))})")

    # the launcher as a user runs it, in its default engine mode
    src = Path(__file__).resolve().parent / "src"
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "ssh-ecg", "--requests", str(ENGINE_LAUNCHER_REQUESTS)]

    def launcher():
        t = time.perf_counter()
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                           cwd=src.parent,
                           env=dict(os.environ, PYTHONPATH=str(src)))
        return p, time.perf_counter() - t

    srv, srv_s = counted("engine_launcher", (), launcher)
    reqs = [line for line in srv.stdout.splitlines()
            if line.startswith("req ")]
    bad = [line for line in reqs
           if line.split(":")[0].split()[1] !=
           line.split("top1=")[1].split()[0]]
    if srv.returncode != 0 or len(reqs) != ENGINE_LAUNCHER_REQUESTS or bad \
            or "engine: req=" not in srv.stdout:
        raise AssertionError(f"serve --arch ssh-ecg exit {srv.returncode}, "
                             f"{len(reqs)} request lines, not self-matched "
                             f"{bad}: {srv.stdout[-2000:]} "
                             f"{srv.stderr[-2000:]}")
    log(f"engine: serve --arch ssh-ecg --requests "
        f"{ENGINE_LAUNCHER_REQUESTS} {srv_s:.1f} s, every request its own "
        f"top-1: {' | '.join(srv.stdout.strip().splitlines()[-2:])}")

    # a novel series inserted through the running engine at 2^20
    novel = extract_subsequences(synthetic_ecg(8 * m, seed=args.seed + 7),
                                 m, stride=m, max_count=1, znorm=True)

    def insert_path():
        tsdb = TimeSeriesDB(index, cfg_e)
        with tsdb:
            tsdb.search(pool[0])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            t = time.perf_counter()
            tsdb.add(novel)
            tsdb.engine.flush_inserts()
            torch.cuda.synchronize()
            insert_s = time.perf_counter() - t
            peak = torch.cuda.max_memory_allocated() - before
            got = tsdb.search(novel[0])
        return got, insert_s, peak, before

    got, insert_s, peak, before = counted(
        "engine_insert", ("sketch_conv", "collision_count_batch",
                          "dtw_wavefront_pairs"), insert_path)
    if int(got.ids[0]) != n or got.n_database != n + 1:
        raise AssertionError(f"engine insert: the novel series is not found "
                             f"at rank 1 as row {n} of {n + 1}: ids "
                             f"{got.ids}, n_database {got.n_database}")
    log(f"engine: one novel series inserted through the running engine at "
        f"{n} series in {insert_s * 1e3:.1f} ms, peak {peak / 1e9:.2f} GB "
        f"above the {before / 1e9:.2f} GB allocated; found at rank 1 as row "
        f"{n} of {got.n_database}")
    index.sig_cache = None
    return recorded


class Timings:
    """Pass-through around module functions that sums the seconds each
    spends (the fleet's ``publish_shard`` and ``fetch_shard``)."""

    def __init__(self, module, names):
        self.module, self.names = module, names
        self.seconds = {n: 0.0 for n in names}
        self.calls = {n: 0 for n in names}
        self.saved = {}

    def __enter__(self):
        for n in self.names:
            fn = getattr(self.module, n)
            self.saved[n] = fn

            def timed_fn(*args, _fn=fn, _n=n, **kw):
                t = time.perf_counter()
                try:
                    return _fn(*args, **kw)
                finally:
                    self.seconds[_n] += time.perf_counter() - t
                    self.calls[_n] += 1
            setattr(self.module, n, timed_fn)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.module, n, fn)
        return False


def fleet_paths(args, counted, ctx) -> dict:
    """The distributed and fleet tiers on the 2^20 index (step 5b of the
    docstring): phases ``dist``, ``fleet``, ``fleet_faulty``,
    ``fleet_drain`` and ``fleet_launcher``.  Raises on any gate.  Returns
    the kernels' calls recorded on one fleet query, {name: [(args,
    kwargs)]}.  The fleets' artifacts live under ``build/`` and are
    removed when each fleet closes."""
    import math
    import shutil
    import tempfile
    from repro_torch.db import BatchPolicy, TimeSeriesDB
    from repro_torch.fleet import searcher as fleet_searcher
    from repro_torch.kernels import ops
    from repro_torch.serving import ssh_search_batch

    rows, pool = ctx["batches"][0]
    index = ctx["db"].index
    n, m = ctx["series"].shape
    half = len(rows) // 2
    kernels = ("sketch_conv", "collision_count", "dtw_wavefront")
    cfg = ctx["cfg"].replace(multiprobe_offsets=1)     # the tier's probe
    cfg_d = cfg.replace(searcher="distributed")
    cfg_f = cfg.replace(searcher="fleet", replication=FLEET_REPLICATION,
                        fleet_workers=FLEET_WORKERS, hedge_policy="adaptive",
                        hedge_ms=FLEET_HEDGE_MS)
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="fleet_", dir=root))
    set_bytes = (index.series.numel() * index.series.element_size()
                 + index.signatures.numel()
                 * index.signatures.element_size())
    free = shutil.disk_usage(tmp).free
    log(f"fleet: artifacts under {tmp}, {free / 1e9:.1f} GB free there; one "
        f"set of shard artifacts is {set_bytes / 1e9:.2f} GB, two are alive "
        f"at once")
    if free < 2 * set_bytes:
        raise AssertionError(f"fleet: {free / 1e9:.1f} GB free under {tmp}, "
                             f"fewer than two artifact sets "
                             f"({2 * set_bytes / 1e9:.2f} GB)")
    saved_tempdir, tempfile.tempdir = tempfile.tempdir, str(tmp)

    def same(got_ids, got_d, want_ids, want_d, what):
        if not (np.array_equal(got_ids, want_ids)
                and np.array_equal(got_d, want_d)):
            raise AssertionError(f"{what}: ids {got_ids} dists {got_d} != "
                                 f"{want_ids} {want_d}")

    def self_matched(ids, what):
        bad = [int(rows[i]) for i in range(half)
               if int(ids[i][0]) != int(rows[i])]
        if bad:
            raise AssertionError(f"{what}: database rows {bad} are not "
                                 f"their own top-1")

    try:
        # -- dist: one shard a visible card, then four on this card -------
        want = ssh_search_batch(pool, index, config=cfg)

        def dist_path():
            out = {}
            for label, mesh in (("1 shard", None),
                                (f"{FLEET_DIST_SHARDS} shards",
                                 [index.device] * FLEET_DIST_SHARDS)):
                tsdb = TimeSeriesDB(index, cfg_d, mesh=mesh)
                tsdb.search_batch(pool[:2])             # warm
                torch.cuda.synchronize()
                t = time.perf_counter()
                res = tsdb.search_batch(pool)
                wall = time.perf_counter() - t
                out[label] = (np.stack([r.ids for r in res]),
                              np.stack([r.dists for r in res]), wall,
                              len(tsdb.searcher.mesh))
            return out

        dist = counted("dist", kernels, dist_path)
        one_ids, one_d = dist["1 shard"][:2]
        four_ids, four_d = dist[f"{FLEET_DIST_SHARDS} shards"][:2]
        # the batched path re-ranks the top_c candidates with a positive
        # count; the shard probe the top_c by count, zeros included (the
        # reference's lax.top_k).  With top_c positives the sets are one
        # and the answers must agree; with fewer, the shard's set holds the
        # batched one and its k-th best can only be nearer
        qsig = index.encoder.encode_batch(torch.as_tensor(pool).to(
            index.device))
        positive = (ops.collision_count_batch(qsig, index.signatures)
                    > 0).sum(1).cpu().numpy()
        full = positive >= cfg.top_c
        for i in np.flatnonzero(full):
            if not np.array_equal(one_ids[i], want.ids[i]):
                raise AssertionError(
                    f"dist 1 shard query {i}: ids {one_ids[i]} != "
                    f"ssh_search_batch's {want.ids[i]}")
            np.testing.assert_allclose(one_d[i], want.dists[i], rtol=1e-5,
                                       atol=1e-6)
        for i in np.flatnonzero(~full):
            w = want.dists[i][want.ids[i] >= 0]
            if not np.all(one_d[i][:len(w)] <= w * (1 + 1e-5) + 1e-6):
                raise AssertionError(
                    f"dist 1 shard query {i} ({positive[i]} positive "
                    f"counts): dists {one_d[i]} worse than the batched "
                    f"{w} over a candidate set that holds its")
        log(f"dist 1 shard against ssh_search_batch (single probe): "
            f"{int(full.sum())} of {len(pool)} queries with >= top_c "
            f"{cfg.top_c} positive counts answer alike (ids equal, "
            f"distances within rtol 1e-5); the other "
            f"{int((~full).sum())} (fewest positive counts "
            f"{int(positive.min())}) as near or nearer at every rank")
        for label, (ids, d, wall, shards) in dist.items():
            self_matched(ids, f"dist {label}")
            if not (np.all(np.isfinite(d))
                    and np.all(np.diff(d, axis=1) >= 0)):
                raise AssertionError(f"dist {label}: malformed distances")
            log(f"dist {label} (mesh of {shards}, local_c "
                f"{max(cfg.topk, cfg.top_c // shards)}): "
                f"{wall / len(pool) * 1e6:.1f} us a query over "
                f"{len(pool)} queries; queries whose ids equal "
                f"ssh_search_batch's {int((ids == want.ids).all(1).sum())} "
                f"of {len(pool)}")

        # -- fleet: healthy, dist_bench's settings -------------------------
        calls = [pool[i % len(pool)] for i in range(FLEET_CALLS)]

        def run_calls(tsdb):
            ids, dists, lat = [], [], []
            for q in calls:
                t = time.perf_counter()
                r = tsdb.search(q)
                lat.append((time.perf_counter() - t) * 1e6)
                ids.append(r.ids)
                dists.append(r.dists)
            return np.stack(ids), np.stack(dists), lat

        def fleet_path():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            tsdb = TimeSeriesDB(index, cfg_f)
            with Timings(fleet_searcher, ("publish_shard", "fetch_shard")) \
                    as tm:
                t = time.perf_counter()
                fleet = tsdb.searcher.fleet
                place_s = time.perf_counter() - t
            warm = fleet.search_batch(pool)             # seeds the EWMAs
            out = run_calls(tsdb)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - before
            return tsdb, fleet, warm, out, tm, place_s, peak

        tsdb_f, fleet, warm, healthy, tm, place_s, peak = counted(
            "fleet", kernels, fleet_path)
        same(warm.ids, warm.dists, four_ids, four_d,
             f"fleet against dist {FLEET_DIST_SHARDS} shards")
        h_ids, h_d, h_lat = healthy
        for i, q_ids in enumerate(h_ids):
            j = i % len(pool)
            same(q_ids, h_d[i], four_ids[j], four_d[j], f"fleet call {i}")
        per_worker = fleet.nbytes()
        h_p50, h_p99 = np.percentile(h_lat, 50), np.percentile(h_lat, 99)
        log(f"fleet healthy (R={FLEET_REPLICATION}, W={FLEET_WORKERS}, "
            f"{fleet.n_shards} shards, hedge adaptive >= {FLEET_HEDGE_MS} "
            f"ms): {FLEET_CALLS} single-query calls p50 {h_p50:.1f} p99 "
            f"{h_p99:.1f} mean {np.mean(h_lat):.1f} us; warm batch of "
            f"{len(pool)} {warm.wall_seconds / len(pool) * 1e6:.1f} us a "
            f"query; publish {tm.seconds['publish_shard']:.2f} s "
            f"({tm.calls['publish_shard']} shards), fetch "
            f"{tm.seconds['fetch_shard']:.2f} s ({tm.calls['fetch_shard']} "
            f"replicas), placement {place_s:.2f} s; bytes on the card per "
            f"worker {per_worker}; peak {peak / 1e9:.2f} GB above the "
            f"allocated; hedged {fleet.hedged_total} failovers "
            f"{fleet.failovers_total}; ids and distances bit-identical to "
            f"dist {FLEET_DIST_SHARDS} shards")

        # the kernels' inputs at the fleet's shapes, from the pool's threads
        index.sig_cache = None
        with Recorder(ops, ("sketch_conv", "collision_count",
                            "dtw_rerank")) as rec:
            fleet.search_batch(pool[half:half + 1])
        missing = [k for k, v in rec.calls.items() if not v]
        if missing:
            raise AssertionError(f"fleet: a query called no {missing}")

        # -- fleet_faulty: one dead primary, one 10x-slow primary ----------
        mean_shard_s = float(np.mean(list(fleet.policy.ewma.values())))
        dead = fleet.plan.primary(0)
        slow = next((fleet.plan.primary(s) for s in range(fleet.n_shards)
                     if dead not in fleet.plan.replicas(s)),
                    next(w for w in sorted(fleet.workers) if w != dead))
        delay_ms = FLEET_SLOW_X * mean_shard_s * 1e3
        hedged0, failovers0 = fleet.hedged_total, fleet.failovers_total

        def faulty_path():
            fleet.injector.kill(dead)
            fleet.injector.delay(slow, delay_ms)
            try:
                return run_calls(tsdb_f)
            finally:
                fleet.injector.clear()

        f_ids, f_d, f_lat = counted("fleet_faulty", kernels, faulty_path)
        same(f_ids, f_d, h_ids, h_d, "fleet_faulty against fleet")
        hedged = fleet.hedged_total - hedged0
        failovers = fleet.failovers_total - failovers0
        if not (hedged > 0 and failovers > 0):
            raise AssertionError(f"fleet_faulty: hedged {hedged} failovers "
                                 f"{failovers}; both must be > 0")
        f_p99 = np.percentile(f_lat, 99)
        log(f"fleet faulty (dead {dead}, slow {slow} by {delay_ms:.3f} ms = "
            f"{FLEET_SLOW_X} x the healthy mean shard time "
            f"{mean_shard_s * 1e3:.3f} ms): p50 {np.percentile(f_lat, 50):.1f} "
            f"p99 {f_p99:.1f} mean {np.mean(f_lat):.1f} us; p99_ratio "
            f"{f_p99 / h_p99:.3f} (the reference CI's bar "
            f"{FLEET_P99_BAR}, logged, not gated); hedged {hedged} "
            f"failovers {failovers}; ids and distances bit-identical to the "
            f"healthy run")
        tsdb_f.close()
        del fleet, tsdb_f
        gc.collect()

        # -- fleet_drain: the engine's fleet route, drain and resize --------
        cfg_e = cfg_f.replace(searcher="engine", batch_policy=BatchPolicy(
            max_batch=4, max_wait_ms=1.0))

        def drain_path():
            tsdb = TimeSeriesDB(index, cfg_e)
            engine = tsdb.engine
            engine.searcher.search_batch(pool[:4])      # warm
            with tsdb:
                engine.start()
                futs = [engine.submit(q) for q in calls]
                victim = sorted(engine.searcher.workers)[0]
                t = time.perf_counter()
                moved = engine.drain(victim)
                drain_s = time.perf_counter() - t
                results = [f.result(timeout=600) for f in futs]
                after = {}
                for w in (6, 3):
                    before = engine.searcher.n_shards, len(
                        engine.searcher.workers)
                    t = time.perf_counter()
                    k = engine.resize(w)
                    after[w] = (k, time.perf_counter() - t, before,
                                engine.search_batch(pool[:8]))
                snap = engine.metrics.snapshot()
            return victim, moved, drain_s, results, after, snap

        victim, moved, drain_s, results, after, snap = counted(
            "fleet_drain", kernels, drain_path)
        if len(results) != FLEET_CALLS:
            raise AssertionError(f"fleet_drain: {FLEET_CALLS - len(results)}"
                                 f" queries lost")
        for i, r in enumerate(results):
            same(r.ids, r.dists, h_ids[i], h_d[i], f"fleet_drain request {i}")
        for w, (k, secs, (shards, workers), res) in after.items():
            for i, r in enumerate(res):
                same(r.ids, r.dists, four_ids[i], four_d[i],
                     f"fleet_drain after resize({w}) query {i}")
            log(f"fleet_drain: resize({w}) from {workers} workers moved {k} "
                f"shards in {secs:.2f} s (ceil(shards / workers) = "
                f"{math.ceil(shards / w)}); 8 answers unchanged")
        log(f"fleet_drain: {FLEET_CALLS} requests through the engine "
            f"(max_batch 4, 1 ms), drain({victim}) mid-stream moved {moved} "
            f"shards in {drain_s:.2f} s; 0 lost, every answer equal to the "
            f"healthy fleet's; engine hedged {snap['hedged_total']:.0f} "
            f"failovers {snap['failovers_total']:.0f} rebalanced "
            f"{snap['rebalanced_shards_total']:.0f}; batches "
            f"{snap['batches_total']:.0f}")

        # the launcher through the fleet, as a user runs it
        src = Path(__file__).resolve().parent / "src"
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
               "ssh-ecg", "--replication", str(FLEET_REPLICATION),
               "--fleet-workers", str(FLEET_WORKERS), "--hedge-ms",
               str(FLEET_HEDGE_MS), "--requests",
               str(FLEET_LAUNCHER_REQUESTS)]

        def launcher():
            t = time.perf_counter()
            p = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=600, cwd=src.parent,
                               env=dict(os.environ, PYTHONPATH=str(src)))
            return p, time.perf_counter() - t

        srv, srv_s = counted("fleet_launcher", (), launcher)
        reqs = [line for line in srv.stdout.splitlines()
                if line.startswith("req ")]
        bad = [line for line in reqs
               if line.split(":")[0].split()[1] !=
               line.split("top1=")[1].split()[0]]
        fleet_line = [line for line in srv.stdout.splitlines()
                      if line.startswith("fleet: hedged=")]
        if srv.returncode != 0 or len(reqs) != FLEET_LAUNCHER_REQUESTS \
                or bad or not fleet_line:
            raise AssertionError(f"serve --replication exit "
                                 f"{srv.returncode}, {len(reqs)} request "
                                 f"lines, not self-matched {bad}: "
                                 f"{srv.stdout[-2000:]} {srv.stderr[-2000:]}")
        log(f"fleet_launcher: {' '.join(cmd[2:])} {srv_s:.1f} s, every "
            f"request its own top-1: {fleet_line[0]}")
    finally:
        tempfile.tempdir = saved_tempdir
        shutil.rmtree(tmp, ignore_errors=True)
    return rec.calls


def ops_batch_stats(d, qs):
    """(ids, stats) of one batched search through the library call."""
    from repro_torch.serving.batched import ssh_search_batch
    res = ssh_search_batch(qs, d.index, config=d.config)
    return res.ids, res.stats


def event_ms(fn):
    """One call's time by CUDA events (the call already ran once)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def paper_api_paths(args, counted, ctx) -> dict:
    """Step 5a, phase ``paper_api``: the paper's functional API and the
    deprecation shims on the 2^20 index (see the docstring).  Returns
    the recorded kernel calls by ``kernels.ops`` entry point; every gate
    raises."""
    import warnings
    from repro_torch.configs.base import ssh_params
    from repro_torch.core import dtw as core_dtw
    from repro_torch.core import lower_bounds as lb
    from repro_torch.core import rerank, search, srp
    from repro_torch.core.index import (SSHFunctions, band_keys,
                                        build_signatures, probe_topc,
                                        probe_topc_batch,
                                        signature_collisions,
                                        signature_collisions_batch,
                                        top_c_by_count)
    from repro_torch.db import TimeSeriesDB
    from repro_torch.kernels import ops
    from repro_torch.serving.batched import batch_probe

    series, batches, cfg, db = (ctx["series"], ctx["batches"], ctx["cfg"],
                                ctx["db"])
    spec, index = db.spec, db.index
    dev, n, m = index.device, len(db), int(index.series.shape[1])
    params = ssh_params(spec)
    qs = batches[0][1]                                  # (64, m) host
    half = qs.shape[0] // 2
    pick16 = list(range(PAPER_CASCADE_QUERIES // 2)) + list(
        range(half, half + PAPER_CASCADE_QUERIES // 2))
    band, top_c, topk = cfg.band, cfg.top_c, cfg.topk
    times, out = {}, {}

    def timed_call(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t) * 1e3
        return r

    def run():
        fns = timed_call("SSHFunctions.create",
                         lambda: SSHFunctions.create(params))
        sigs = timed_call("build_signatures", lambda: build_signatures(
            index.series, fns, batch=PAPER_BUILD_BATCH))
        keys = band_keys(sigs, params)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            legacy = timed_call("TimeSeriesDB.build(SSHParams)",
                                lambda: TimeSeriesDB.build(series, params,
                                                           cfg))
        # held here, and dropped before the cascade's temporaries
        out["legacy_equal"] = (
            torch.equal(legacy.index.signatures, index.signatures),
            torch.equal(legacy.index.keys, index.keys))
        out["legacy_params"] = legacy.params
        del legacy
        gc.collect()
        torch.cuda.empty_cache()
        qd = torch.as_tensor(qs, device=dev)
        qsig = timed_call("build_signatures(64 queries)",
                          lambda: build_signatures(qd, fns))
        ids_b, cnt_b = timed_call("probe_topc_batch", lambda:
                                  probe_topc_batch(qsig, sigs, top_c))
        ids_1, cnt_1 = timed_call("probe_topc", lambda:
                                  probe_topc(qsig[0], sigs, top_c))
        a, c = PAPER_PAIRWISE
        cands = index.series[ids_b[0, :c]]
        pw = timed_call("dtw_pairwise", lambda: core_dtw.dtw_pairwise(
            qd[:a], cands, band))
        thr = torch.sort(pw[0]).values[topk - 1]
        banded = timed_call("dtw_banded_batch", lambda:
                            core_dtw.dtw_banded_batch(qd[0], cands, band,
                                                      thr))
        chunked = timed_call("dtw_pairs_chunked", lambda:
                             rerank.dtw_pairs_chunked(
                                 qd[:a].repeat_interleave(c, 0),
                                 cands.repeat(a, 1), band, threshold=thr))
        q16 = qd[pick16]
        best = timed_call("best_so_far (dtw_banded_batch over N)", lambda: [
            torch.sort(core_dtw.dtw_banded_batch(q, index.series, band)
                       ).values[topk - 1] for q in q16])
        stats = timed_call("cascade_stats", lambda: [
            lb.cascade_stats(q, index.series, band, b)
            for q, b in zip(q16, best)])
        gen = torch.Generator().manual_seed(args.seed + 5)
        planes = srp.make_srp(PAPER_SRP_BITS, m, gen).to(dev)
        db_bits = srp.srp_bits(index.series, planes)
        srp_res = timed_call("srp_search", lambda: [
            search.srp_search(q, index.series, planes, db_bits, topk)
            for q in q16])
        rect = []
        for k, (mx, my) in enumerate(PAPER_RECT):
            x, y = index.series[k, :mx], index.series[k + 1, :my]
            for b in (band, None):
                rect.append(((mx, my, b), timed_call(
                    f"dtw {mx}x{my} band {b}",
                    lambda: core_dtw.dtw(x, y, b))))
        out.update(sigs=sigs, keys=keys, caught=caught,
                   qsig=qsig, ids_b=ids_b, cnt_b=cnt_b, ids_1=ids_1,
                   cnt_1=cnt_1, cands=cands, pw=pw, thr=thr, banded=banded,
                   chunked=chunked,
                   q16=q16, best=best, stats=stats, planes=planes,
                   db_bits=db_bits, srp_res=srp_res, rect=rect, fns=fns)

    t0 = time.perf_counter()
    with Recorder(ops, ("sketch_conv", "collision_count",
                        "collision_count_batch", "dtw_rerank",
                        "dtw_rerank_pairs")) as rec:
        counted("paper_api", ("sketch_conv", "collision_count",
                              "collision_count_batch", "dtw_wavefront",
                              "dtw_wavefront_pairs"), run)
    run_s = time.perf_counter() - t0
    o = out

    # -- the builds: bit for bit the spec= build; the shim warned ----------
    for name, got, want in (("build_signatures", o["sigs"], index.signatures),
                            ("band_keys", o["keys"], index.keys)):
        if not torch.equal(got, want):
            raise AssertionError(f"paper_api: {name} differ from the spec= "
                                 f"build on {int((got != want).sum())} "
                                 "entries")
    if o["legacy_equal"] != (True, True):
        raise AssertionError(f"paper_api: TimeSeriesDB.build(series, "
                             f"SSHParams(...)) differs from the spec= build "
                             f"(signatures, keys equal: {o['legacy_equal']})")
    deps = [w for w in o["caught"] if issubclass(w.category,
                                                 DeprecationWarning)
            and "passing SSHParams to TimeSeriesDB.build()"
            in str(w.message)]
    if len(deps) != 1:
        raise AssertionError(f"paper_api: the SSHParams shim gave "
                             f"{len(deps)} DeprecationWarnings, not 1: "
                             f"{[str(w.message) for w in o['caught']]}")
    if o["legacy_params"] != params or db.params != params:
        raise AssertionError(f"paper_api: db.params {db.params} is not "
                             f"{params}")

    # -- the probes: top-C equal to the searchers' own --------------------
    ids_s, cnt_s = batch_probe(torch.as_tensor(qs, device=dev), index, top_c,
                               rank_by_signature=True, multiprobe_offsets=1)
    if not (torch.equal(o["ids_b"], ids_s) and torch.equal(o["cnt_b"],
                                                           cnt_s)):
        raise AssertionError("paper_api: probe_topc_batch differs from "
                             "batch_probe's top-C")
    hp = search.hash_probe(torch.as_tensor(qs[0], device=dev), index, top_c)
    if not torch.equal(o["ids_1"][o["cnt_1"] > 0], hp):
        raise AssertionError("paper_api: probe_topc differs from "
                             "hash_probe's top-C")
    if not (torch.equal(o["ids_1"], o["ids_b"][0])
            and torch.equal(o["cnt_1"], o["cnt_b"][0])):
        raise AssertionError("paper_api: probe_topc differs from row 0 of "
                             "probe_topc_batch")

    # -- the DTW family: the batch forms are the pair forms ---------------
    a, c = PAPER_PAIRWISE
    pw, cands, thr = o["pw"], o["cands"], o["thr"]
    if tuple(pw.shape) != (a, c) or not bool(torch.isfinite(pw).all()):
        raise AssertionError(f"paper_api: dtw_pairwise gave {pw.shape}")
    kept = pw[0] <= thr
    want_b = torch.where(kept, pw[0], torch.full_like(pw[0],
                                                      core_dtw.BIG))
    if not torch.equal(o["banded"], want_b):
        raise AssertionError("paper_api: dtw_banded_batch with a threshold "
                             "is not dtw_pairwise's row 0 where kept and "
                             "BIG elsewhere")
    flat = pw.reshape(-1).cpu().numpy()
    want_c = np.where(flat <= float(thr), flat, np.float32(core_dtw.BIG))
    if not np.array_equal(o["chunked"], want_c):
        raise AssertionError("paper_api: dtw_pairs_chunked with a threshold "
                             "is not dtw_pairwise where kept and BIG "
                             "elsewhere")

    # -- cascade_stats: best_so_far held to brute force; card = CPU -------
    t = time.perf_counter()
    for i in range(PAPER_BRUTE):
        _, gold = search.brute_force_topk(o["q16"][i], index.series, topk,
                                          band)
        if float(gold[topk - 1]) != float(o["best"][i]):
            raise AssertionError(f"paper_api: query {i}'s 10th-best banded "
                                 f"DTW {float(o['best'][i])} is not brute "
                                 f"force's {float(gold[topk - 1])}")
    brute_s = time.perf_counter() - t
    keys5 = ("kim", "keogh", "keogh2", "improved", "combined")
    fracs = np.array([[float(s[k]) for k in keys5] for s in o["stats"]])
    t = time.perf_counter()
    cpu_rows = index.series[:PAPER_CPU_ROWS].cpu()
    worst = 0.0
    for i in PAPER_CPU_QUERIES:
        q, b = o["q16"][i], o["best"][i]
        card = lb.cascade_stats(q, index.series[:PAPER_CPU_ROWS], band, b)
        cpu = lb.cascade_stats(q.cpu(), cpu_rows, band, b.cpu())
        for k in keys5:
            gap = abs(float(card[k]) - float(cpu[k]))
            worst = max(worst, gap)
            if gap > 2 / PAPER_CPU_ROWS:
                raise AssertionError(
                    f"paper_api: cascade_stats[{k}] of query {i} on the "
                    f"first {PAPER_CPU_ROWS} rows: card {float(card[k])} "
                    f"CPU {float(cpu[k])}")
    cascade_cpu_s = time.perf_counter() - t

    # -- srp_search: ids equal to the CPU's on the 65,536-row slice (the
    #    ids are srp_topk's; the whole search, DTW included, for 2) -------
    t = time.perf_counter()
    planes_c, bits_c = o["planes"].cpu(), o["db_bits"][:PAPER_CPU_ROWS].cpu()
    for i, q in enumerate(o["q16"]):
        card = search.srp_search(q, index.series[:PAPER_CPU_ROWS],
                                 o["planes"], o["db_bits"][:PAPER_CPU_ROWS],
                                 topk)
        if i in PAPER_CPU_QUERIES:
            cpu = search.srp_search(q.cpu(), cpu_rows, planes_c, bits_c,
                                    topk)
            np.testing.assert_allclose(card.dists, cpu.dists, rtol=1e-6)
            cpu_ids = cpu.ids
        else:
            cpu_ids = srp.srp_topk(srp.srp_bits(q.cpu(), planes_c), bits_c,
                                   topk)[0].numpy()
        if not np.array_equal(card.ids, cpu_ids):
            raise AssertionError(f"paper_api: srp_search query {i}: card "
                                 f"ids {card.ids} != CPU ids {cpu_ids}")
    srp_cpu_s = time.perf_counter() - t
    for r in o["srp_res"]:
        if not (len(r.ids) == topk and np.all(np.isfinite(r.dists))):
            raise AssertionError(f"paper_api: srp_search gave {r}")
    srp_self = sum(int(r.ids[0]) == int(batches[0][0][p])
                   for r, p in zip(o["srp_res"], pick16))
    del cpu_rows, bits_c

    # -- rectangular dtw against the float64 DP ---------------------------
    rect_log = []
    for (mx, my, b), got in o["rect"]:
        k = PAPER_RECT.index((mx, my))
        x = index.series[k, :mx].cpu().numpy()
        y = index.series[k + 1, :my].cpu().numpy()
        want = core_dtw.dtw_dp_reference(x, y, b)
        rel = abs(float(got) - want) / want
        if not rel <= 1e-6:
            raise AssertionError(f"paper_api: dtw ({mx}, {my}) band {b}: "
                                 f"{float(got)} against the float64 DP "
                                 f"{want} ({rel:.3g} relative)")
        rect_log.append(f"({mx},{my}) band {b}: {rel:.3g}")

    # -- call ms by CUDA events, one call each after its gated call ------
    counts_b = signature_collisions_batch(o["qsig"], o["sigs"])
    call_ms = {
        "build_signatures(64 queries)": event_ms(
            lambda: build_signatures(torch.as_tensor(qs, device=dev),
                                     o["fns"])),
        "build_signatures(256 rows)": event_ms(
            lambda: build_signatures(index.series[:256], o["fns"])),
        "probe_topc_batch": event_ms(
            lambda: probe_topc_batch(o["qsig"], o["sigs"], top_c)),
        "probe_topc": event_ms(
            lambda: probe_topc(o["qsig"][0], o["sigs"], top_c)),
        # the probes' two parts: the counts, then the top-C ranking
        "signature_collisions_batch": event_ms(
            lambda: signature_collisions_batch(o["qsig"], o["sigs"])),
        "top_c_by_count (64 rows)": event_ms(
            lambda: top_c_by_count(counts_b, top_c)),
        "signature_collisions": event_ms(
            lambda: signature_collisions(o["qsig"][0], o["sigs"])),
        "top_c_by_count (1 row)": event_ms(
            lambda: top_c_by_count(counts_b[:1], top_c)),
        "dtw_pairwise": event_ms(lambda: core_dtw.dtw_pairwise(
            torch.as_tensor(qs[:a], device=dev), cands, band)),
        "dtw_banded_batch": event_ms(lambda: core_dtw.dtw_banded_batch(
            o["q16"][0], cands, band, thr)),
        "dtw_pairs_chunked": event_ms(lambda: rerank.dtw_pairs_chunked(
            torch.as_tensor(qs[:a], device=dev).repeat_interleave(c, 0),
            cands.repeat(a, 1), band, threshold=thr)),
        "cascade_stats (one query, N rows)": event_ms(
            lambda: lb.cascade_stats(o["q16"][0], index.series, band,
                                     o["best"][0])),
        "srp_search (one query, N rows)": event_ms(
            lambda: search.srp_search(o["q16"][0], index.series,
                                      o["planes"], o["db_bits"], topk)),
    }
    log(f"paper_api: {run_s:.1f} s for the counted run; build_signatures of "
        f"{n} series equal to the spec= build, and TimeSeriesDB.build(series,"
        f" SSHParams(...)) too (one DeprecationWarning: "
        f"{str(deps[0].message)!r}); db.params {db.params}")
    log(f"paper_api: probe_topc_batch ({tuple(o['qsig'].shape)} against "
        f"{tuple(o['sigs'].shape)}) and probe_topc equal to batch_probe's "
        f"and hash_probe's top-{top_c}; dtw_pairwise {tuple(pw.shape)} and "
        f"dtw_banded_batch at threshold {float(thr):.6g} "
        f"({int(kept.sum())} of {c} kept) agree, and dtw_pairs_chunked on "
        f"the same {a * c} pairs at that threshold")
    log(f"paper_api: cascade_stats over {n} rows, band {band}, best_so_far "
        f"the {topk}th-best banded DTW (brute_force_topk equal on "
        f"{PAPER_BRUTE} queries, {brute_s:.1f} s); mean fractions "
        f"{dict(zip(keys5, np.round(fracs.mean(0), 6).tolist()))}, per "
        f"query combined {np.round(fracs[:, 4], 6).tolist()}; card = CPU for "
        f"{len(PAPER_CPU_QUERIES)} queries on the first {PAPER_CPU_ROWS} "
        f"rows within {worst * PAPER_CPU_ROWS:.0f}/{PAPER_CPU_ROWS} "
        f"({cascade_cpu_s:.1f} s)")
    log(f"paper_api: srp_search ({PAPER_SRP_BITS} bits) over {n} rows: "
        f"top-1 self-match {srp_self} of {PAPER_CASCADE_QUERIES // 2} "
        f"database rows; ids equal to the CPU's on the first "
        f"{PAPER_CPU_ROWS} rows for {len(o['q16'])} queries (the whole "
        f"search for {len(PAPER_CPU_QUERIES)}, {srp_cpu_s:.1f} s); "
        f"rectangular dtw against the float64 DP: "
        f"{rect_log}")
    log(f"paper_api: wall ms of each gated call (host clock, synchronised) "
        f"{ {k: round(v, 3) for k, v in times.items()} }; call ms by CUDA "
        f"events {({k: round(v, 4) for k, v in call_ms.items()})}")
    return rec.calls


def pipeline_paths(args, counted, ctx) -> dict:
    """Step 5a', phase ``pipeline``: the encoder composition on the 2^20
    index (see the docstring).  Returns the recorded ``sketch_conv`` and
    ``cs_tables`` calls; every gate raises."""
    from repro_torch.db import TimeSeriesDB
    from repro_torch.encoders import (IndexSpec, PipelineEncoder, SSHEncoder,
                                      make_encoder, register_encoder)
    from repro_torch.kernels import ops
    from repro_torch.serving.batched import ssh_search_batch

    series, batches, cfg, db = (ctx["series"], ctx["batches"], ctx["cfg"],
                                ctx["db"])
    spec, index = db.spec, db.index
    dev, n, m = index.device, len(db), int(index.series.shape[1])
    qs = batches[0][1]

    class ProtocolOnly:
        """A shingler with only the ``Shingler`` protocol's members."""

        def __init__(self, inner):
            self.dim, self.min_bits = inner.dim, inner.min_bits
            self.histogram = inner.histogram
            self.histogram_masked = inner.histogram_masked

    @register_encoder("chip-pipeline")
    class Composed(PipelineEncoder):
        """The stock stages, registered out of tree."""
        DEFAULTS = SSHEncoder.DEFAULTS
        validate_params = SSHEncoder.validate_params
        _build_stages = SSHEncoder._build_stages

    @register_encoder("chip-pipeline-dense")
    class Dense(Composed):
        @classmethod
        def _build_stages(cls, spec_):
            sk, sh, ha, n_tables = SSHEncoder._build_stages(spec_)
            return sk, ProtocolOnly(sh), ha, n_tables

    pspec = IndexSpec("chip-pipeline", spec.params, seed=spec.seed)
    spec_cs = IndexSpec("ssh-cs", dict(spec.params, rows=4, width=4096,
                                       base_bits=4), seed=spec.seed)
    common = {k: v for k, v in spec.params.items() if k != "ngram"}
    pure_specs = {"ssh": spec, "ssh-multires": IndexSpec(
        "ssh-multires", dict(common, ngrams=(10, 15)), seed=spec.seed),
        "ssh-cs": spec_cs, "srp": IndexSpec("srp", seed=spec.seed)}
    out, times = {}, {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t
        return r

    def run():
        # 1. the out-of-tree composition: the main index, bit for bit
        dbp = timed("build", lambda: TimeSeriesDB.build(series, pspec, cfg))
        ours, main = dbp.index.encoder.state(), index.encoder.state()
        out["leaves"] = (sorted(ours) == sorted(main) and all(
            torch.equal(ours[k], v) for k, v in main.items()))
        out["sigs"] = int((dbp.index.signatures != index.signatures).sum())
        out["keys"] = int((dbp.index.keys != index.keys).sum())
        out["routes"] = (dbp.index.encoder.route, index.encoder.route)
        res = timed("search", lambda: ssh_search_batch(
            qs, dbp.index, config=dbp.config))
        out["answers"] = [res.per_query(i) for i in range(res.n_queries)]
        qd = torch.as_tensor(qs, device=dev)
        offsets = cfg.multiprobe_offsets
        enc_p, enc_m = dbp.index.encoder, index.encoder
        out["encode_ms"] = {"pipeline": [], "main": []}
        for _ in range(2):                      # in turns
            for tag, e in (("pipeline", enc_p), ("main", enc_m),
                           ("main", enc_m), ("pipeline", enc_p)):
                out["encode_ms"][tag].append(event_ms(
                    lambda: e.encode_batch_multiprobe(qd, offsets)))
        del dbp, res, enc_p
        gc.collect()
        torch.cuda.empty_cache()
        # 2. the dense route of a protocol-only shingler
        dense = make_encoder(IndexSpec("chip-pipeline-dense", spec.params,
                                       seed=spec.seed), dev)
        rows = index.series[:PIPELINE_DENSE_ROWS]
        out["dense_route"] = dense.route
        out["dense"] = int((timed("dense", lambda: dense.encode_batch(rows))
                            != index.signatures[:PIPELINE_DENSE_ROWS]).sum())
        out["dense_mp"] = int((timed(
            "dense multiprobe", lambda: dense.encode_batch_multiprobe(
                qd, offsets))
            != enc_m.encode_batch_multiprobe(qd, offsets)).sum())
        # 3. "ssh-cs" through the composition on the card
        db_cs = timed("ssh-cs build", lambda: TimeSeriesDB.build(
            series[:PIPELINE_CS_ROWS], spec_cs, cfg))
        out["cs_card"] = (db_cs.index.encoder.state(),
                          db_cs.index.signatures, db_cs.index.keys,
                          db_cs.index.encoder.sketch_batch(
                              db_cs.index.series))
        out["cs_route"] = db_cs.index.encoder.route
        # 4. pure_encode_fn of each encoder against its encode_batch
        x = index.series[:PIPELINE_PURE_ROWS]
        out["pure"] = {}
        for name, sp in pure_specs.items():
            enc = (index.encoder if name == "ssh" else
                   db_cs.index.encoder if name == "ssh-cs" else
                   make_encoder(sp, dev, length=m))
            out["pure"][name] = (enc.pure_encode_fn()(x, enc.state()),
                                 enc.encode_batch(x))

    t0 = time.perf_counter()
    with Recorder(ops, ("sketch_conv", "cs_tables")) as rec:
        counted("pipeline", ("sketch_conv", "cs_tables",
                             "collision_count_batch", "dtw_wavefront_pairs"),
                run)
    run_s = time.perf_counter() - t0
    o = out

    if not o["leaves"]:
        raise AssertionError("pipeline: the out-of-tree PipelineEncoder's "
                             "state differs from the 'ssh' encoder's")
    if o["sigs"] or o["keys"]:
        raise AssertionError(f"pipeline: {o['sigs']} signatures and "
                             f"{o['keys']} band keys of {n} rows differ from "
                             "the main index's")
    if o["routes"] != ("ids", "ids") or o["dense_route"] != "dense" \
            or o["cs_route"] != "entries":
        raise AssertionError(f"pipeline: routes {o['routes']}, "
                             f"{o['dense_route']}, {o['cs_route']}")
    for i, (got, want) in enumerate(zip(o["answers"], ctx["results"][0])):
        if not np.array_equal(got.ids, want.ids):
            raise AssertionError(f"pipeline: query {i}: ids {got.ids} != the "
                                 f"main path's {want.ids}")
        np.testing.assert_allclose(got.dists, want.dists, rtol=1e-5,
                                   atol=1e-6)
    if o["dense"] or o["dense_mp"]:
        raise AssertionError(f"pipeline: the dense route differs from the "
                             f"active one on {o['dense']} of "
                             f"{PIPELINE_DENSE_ROWS} rows' hashes and "
                             f"{o['dense_mp']} multiprobe hashes")

    # "ssh-cs": the CPU's draw and encode, held to the card's bit for bit
    t = time.perf_counter()
    state_c, sigs_c, keys_c, agg_c = o["cs_card"]
    enc_cpu = make_encoder(spec_cs, "cpu")
    rows_cpu = torch.from_numpy(series[:PIPELINE_CS_ROWS])
    sigs_h = enc_cpu.encode_batch(rows_cpu)
    for k, v in enc_cpu.state().items():
        if not torch.equal(state_c[k].cpu(), v):
            raise AssertionError(f"pipeline: ssh-cs leaf {k} differs on "
                                 "the card and on the CPU")
    if not (torch.equal(sigs_c.cpu(), sigs_h)
            and torch.equal(keys_c.cpu(), enc_cpu.band_keys(sigs_h))
            and torch.equal(agg_c.cpu(), enc_cpu.sketch_batch(rows_cpu))):
        raise AssertionError(
            f"pipeline: ssh-cs on the card differs from the CPU: "
            f"{int((sigs_c.cpu() != sigs_h).sum())} hashes")
    cs_cpu_s = time.perf_counter() - t
    for name, (pure, batch) in o["pure"].items():
        if not torch.equal(pure, batch):
            raise AssertionError(f"pipeline: {name} pure_encode_fn differs "
                                 f"from encode_batch on "
                                 f"{int((pure != batch).sum())} entries")
    enc_ms = {k: [round(v, 4) for v in vs]
              for k, vs in o["encode_ms"].items()}
    log(f"pipeline: {run_s:.1f} s for the counted run; an out-of-tree "
        f"PipelineEncoder of the stock stages drew the 'ssh' state and "
        f"built {n} signatures and keys bit for bit in "
        f"{times['build']:.2f} s (the main build {ctx['build_s']:.2f} s), "
        f"batch 0's {len(qs)} queries answered as the main path's")
    log(f"pipeline: encode_batch_multiprobe of {len(qs)} queries x "
        f"{cfg.multiprobe_offsets} offsets, call ms by CUDA events in turns: "
        f"{enc_ms}")
    log(f"pipeline: the dense route (a protocol-only shingler, (64, "
        f"{index.encoder.num_hashes}, {index.encoder.dim}) scores a block) "
        f"on {PIPELINE_DENSE_ROWS} rows equal to the active route in "
        f"{times['dense']:.2f} s, multiprobe in "
        f"{times['dense multiprobe']:.2f} s; ssh-cs on {PIPELINE_CS_ROWS} "
        f"rows equal on the card and the CPU (state, signatures, keys, "
        f"sketch; build {times['ssh-cs build']:.2f} s, CPU check "
        f"{cs_cpu_s:.1f} s); pure_encode_fn = encode_batch on "
        f"{PIPELINE_PURE_ROWS} rows of {sorted(o['pure'])}")
    del out, o
    return rec.calls


def load_example(name):
    """The module ``examples/<name>.py`` of this checkout."""
    import importlib.util
    path = Path(__file__).resolve().parent / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def surface_paths(args, counted, ctx) -> dict:
    """Step 5a'', phase ``surface``: the port's three examples at their
    default sizes and the reference's call forms that the surface walk
    closed, on the 2^20 index (see the docstring).  Returns the calls of
    the five SSH kernels that the examples made; every gate raises."""
    import shutil
    import tempfile
    import warnings
    from repro_torch.checkpoint import Checkpointer, restore_checkpoint
    from repro_torch.core import rerank as rr
    from repro_torch.core import search
    from repro_torch.core.index import SSHIndex
    from repro_torch.db import SearchConfig, TimeSeriesDB
    from repro_torch.kernels import ops
    from repro_torch.serving.batched import ssh_search_batch
    from repro_torch.streaming import StreamIngestor

    series, batches, cfg, db = (ctx["series"], ctx["batches"], ctx["cfg"],
                                ctx["db"])
    index, want = db.index, ctx["results"][0]
    dev = index.device
    qs = batches[0][1]
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="surface_", dir=root))
    out, times = {}, {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t
        return r

    def examples():
        ias = load_example("torch_index_and_search")
        out["index_and_search"] = timed("index_and_search", lambda: ias.run(
            ias.parse_args(["--db-dir", str(tmp / "db")])))
        dist = load_example("torch_distributed_search")
        res = timed("distributed_search", lambda: dist.run(
            dist.parse_args([])))
        out["distributed_search"] = (res, dist.agree(res))
        rec = load_example("torch_train_recsys_ssh")
        out["train_recsys_ssh"] = timed("train_recsys_ssh", lambda: rec.run(
            rec.parse_args([])))

    def entry_points():
        qd = torch.as_tensor(qs, device=dev)
        # SSHIndex(fns=...): the encoder adopts the index's own tensors
        idx_f = SSHIndex(fns=index.fns, signatures=index.signatures,
                         keys=index.keys, series=index.series,
                         env_radius=index.env_radius,
                         env_upper=index.env_upper,
                         env_lower=index.env_lower)
        st_f, st = idx_f.enc.state(), index.encoder.state()
        out["fns_adopts"] = all(st_f[k].data_ptr() == v.data_ptr()
                                for k, v in st.items())
        res_f = timed("fns search", lambda: ssh_search_batch(
            qs, idx_f, config=db.config))
        out["fns"] = [res_f.per_query(i) for i in range(res_f.n_queries)]
        out["batch_dtw_evals"] = (res_f.dtw_evals,
                                  int(res_f.n_candidates.sum()))
        # dtw_evals of sequential searches; backend="auto" and "pallas"
        local = cfg.replace(searcher="local")
        seq = [search.ssh_search(qs[i], index, local) for i in range(4)]
        out["dtw_evals"] = [(r.dtw_evals, r.n_candidates, r.stats.n_dtw)
                            for r in seq]
        sig = index.encoder.encode_batch(qd)
        out["backend"] = {b: (torch.equal(index.encoder.encode_batch(
            qd, backend=b), sig), torch.equal(search.hash_probe(
                qd[0], index, cfg.top_c, backend=b),
                search.hash_probe(qd[0], index, cfg.top_c)))
            for b in ("auto", "pallas")}
        # the flat batcher knobs of older releases
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            legacy = SearchConfig(topk=cfg.topk, top_c=cfg.top_c,
                                  band=cfg.band,
                                  multiprobe_offsets=cfg.multiprobe_offsets,
                                  max_batch=16, max_wait_ms=1.0)
        out["legacy_config"] = (
            [str(x.category.__name__) for x in w], legacy.batch_policy,
            TimeSeriesDB(index, legacy).search_batch(qs[:8]))
        # restore_latest(shardings=): onto the card, as restore_checkpoint
        tree = {"sigs": index.signatures[:4096].cpu().numpy(),
                "keys": index.keys[:4096].cpu().numpy()}
        ck = Checkpointer(tmp / "ck")
        ck.save(1, tree)
        ck.wait()
        where = {"sigs": dev, "keys": dev}
        step, got = ck.restore_latest(tree, shardings=where)
        _, ref_tree = restore_checkpoint(tmp / "ck", tree, shardings=where)
        out["restore"] = (step, all(
            got[k].device == dev and torch.equal(got[k], ref_tree[k])
            and torch.equal(got[k], t_[:4096])
            for k, t_ in (("sigs", index.signatures), ("keys", index.keys))))
        # backend="jnp" on CUDA tensors: refused before any work
        cand = torch.arange(64, device=dev)
        refused = {}
        for name, call in (
                ("encode_batch", lambda: index.encoder.encode_batch(
                    qd, backend="jnp")),
                ("hash_probe", lambda: search.hash_probe(
                    qd[0], index, 8, backend="jnp")),
                ("rerank", lambda: rr.rerank(qd[0], cand, index, cfg.topk,
                                             cfg.band, backend="jnp")),
                ("ucr_search", lambda: search.ucr_search(
                    qd[0], index.series, cfg.topk, cfg.band, backend="jnp")),
                ("SSHIndex.build", lambda: SSHIndex.build(
                    series[:64], spec=db.spec, backend="jnp")),
                ("StreamIngestor", lambda: StreamIngestor(
                    index.encoder, backend="jnp")),
                ("ssh_search_batch", lambda: ssh_search_batch(
                    qs, index, config=cfg.replace(backend="jnp")))):
            try:
                call()
                refused[name] = False
            except ValueError:
                refused[name] = True
        out["refused"] = refused

    def run():
        with Recorder(ops, ("sketch_conv", "collision_count_batch",
                            "collision_count", "dtw_rerank_pairs",
                            "dtw_rerank")) as rec:
            examples()
        entry_points()
        return rec

    t0 = time.perf_counter()
    try:
        rec = counted("surface", ("sketch_conv", "collision_count_batch",
                                  "collision_count", "dtw_wavefront_pairs",
                                  "dtw_wavefront"), run)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    run_s = time.perf_counter() - t0
    o = out

    ias = o["index_and_search"]
    if ias["loaded_equal"] is not True:
        raise AssertionError("surface: torch_index_and_search's loaded "
                             "database differs from the built one")
    res, agreed = o["distributed_search"]
    if not agreed:
        raise AssertionError(f"surface: torch_distributed_search: fan-out "
                             f"{res['fanout']} != facade {res['facade']} or "
                             f"row {res['row']} not its own top-1 (single "
                             f"device {res['single']})")
    rec_res = o["train_recsys_ssh"]
    if int(rec_res["ids"][0]) != rec_res["user"] or not np.all(
            np.isfinite(rec_res["losses"])):
        raise AssertionError(f"surface: torch_train_recsys_ssh: user "
                             f"{rec_res['user']} top-k {rec_res['ids']}, "
                             f"losses {rec_res['losses']}")
    if not o["fns_adopts"]:
        raise AssertionError("surface: SSHIndex(fns=) copied the state")
    for i, (got, w_) in enumerate(zip(o["fns"], want)):
        if not (np.array_equal(got.ids, w_.ids)
                and np.array_equal(got.dists, w_.dists)):
            raise AssertionError(f"surface: query {i}: the fns-built "
                                 f"index's ids {got.ids} != the "
                                 f"encoder-built {w_.ids}")
    if o["batch_dtw_evals"][0] != o["batch_dtw_evals"][1] or any(
            len(set(t_)) != 1 for t_ in o["dtw_evals"]):
        raise AssertionError(f"surface: dtw_evals {o['batch_dtw_evals']}, "
                             f"sequential {o['dtw_evals']}")
    if not all(all(v) for v in o["backend"].values()):
        raise AssertionError(f"surface: backend= changed the bits: "
                             f"{o['backend']}")
    kinds, policy, legacy_res = o["legacy_config"]
    if kinds != ["DeprecationWarning"] or (policy.max_batch,
                                           policy.max_wait_ms) != (16, 1.0):
        raise AssertionError(f"surface: SearchConfig(max_batch=16, "
                             f"max_wait_ms=1.0) warned {kinds}, policy "
                             f"{policy}")
    for i, (got, w_) in enumerate(zip(legacy_res, want)):
        if not np.array_equal(got.ids, w_.ids):
            raise AssertionError(f"surface: legacy config query {i}: ids "
                                 f"{got.ids} != {w_.ids}")
    if o["restore"] != (1, True):
        raise AssertionError(f"surface: restore_latest(shardings=) "
                             f"{o['restore']}")
    if not all(o["refused"].values()):
        raise AssertionError(f"surface: backend='jnp' on CUDA tensors was "
                             f"not refused by "
                             f"{[k for k, v in o['refused'].items() if not v]}")

    q = ias["queries"]
    log(f"surface: {run_s:.1f} s for the counted run; examples at their "
        f"default sizes on the card: torch_index_and_search "
        f"{times['index_and_search']:.2f} s ({ias['n_series']} series, "
        f"loaded = built bit for bit; per query ssh s "
        f"{[round(x['ssh_s'], 4) for x in q]}, ucr s "
        f"{[round(x['ucr_s'], 4) for x in q]}, precision@10 "
        f"{[x['precision'] for x in q]}, ndcg@10 "
        f"{[round(x['ndcg'], 3) for x in q]}, pruned "
        f"{[round(x['ssh_pruned'], 4) for x in q]} against UCR's "
        f"{[round(x['ucr_pruned'], 4) for x in q]}, UCR exact "
        f"{[x['ucr_exact'] for x in q]}), torch_distributed_search "
        f"{times['distributed_search']:.2f} s (top-k {res['fanout'][0]} = "
        f"the facade's; single device {res['single'][0]}), "
        f"torch_train_recsys_ssh {times['train_recsys_ssh']:.2f} s (losses "
        f"{[round(x, 4) for x in rec_res['losses']]}, user "
        f"{rec_res['user']}'s top-5 {rec_res['ids']})")
    log(f"surface: on the {len(db)}-row index, SSHIndex(fns=) answered batch "
        f"0 as the encoder-built index bit for bit in "
        f"{times['fns search']:.3f} s "
        f"(its encoder adopts the index's tensors); dtw_evals batch "
        f"{o['batch_dtw_evals'][0]}, sequential "
        f"{[t_[0] for t_ in o['dtw_evals']]}; backend auto and pallas give "
        f"the default's bits; SearchConfig(max_batch=16, max_wait_ms=1.0) "
        f"warned once and answered 8 queries alike; restore_latest("
        f"shardings=) put 4096 rows on the card as restore_checkpoint; "
        f"backend='jnp' refused by {sorted(o['refused'])}")
    del out, o
    return rec.calls


def ssh_paths(args, counted, phases) -> list:
    """Paths a-d and the six SSH kernels (steps 2-5 of the docstring);
    returns their kernel entries.  Every tensor of the SSH state is freed
    when this returns."""
    from repro_torch.configs import ssh_ecg
    from repro_torch.core import dtw as core_dtw
    from repro_torch.core import search
    from repro_torch.core.index import SSHIndex
    from repro_torch.data.timeseries import (extract_subsequences,
                                             synthetic_ecg, warp_series)
    from repro_torch.db import TimeSeriesDB
    from repro_torch.encoders import IndexSpec
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import dtw_wavefront as kd
    from repro_torch.serving.batched import ssh_search_batch
    from repro_torch.streaming import StreamIngestor

    dev = torch.device("cuda")
    # -- data ---------------------------------------------------------------
    n, m = args.n_series, args.length
    t = time.perf_counter()
    stride = max(1, m // 8)                 # make_benchmark_db's stride
    series = extract_subsequences(
        synthetic_ecg(n * stride + m, seed=args.seed), m, stride=stride,
        max_count=n, znorm=True)
    log(f"database: {n} z-normalised synthetic-ECG series of length {m} "
        f"({series.nbytes / 1e9:.2f} GB), made in "
        f"{time.perf_counter() - t:.1f} s; the paper's scale is "
        f"{ssh_ecg.PAPER_N_SERIES} series, cut "
        f"{ssh_ecg.PAPER_N_SERIES / n:.1f}x")
    rng = np.random.default_rng(args.seed + 1)
    bs, half = BATCH_SIZE, BATCH_SIZE // 2
    batches = []
    for _ in range(BATCHES):
        rows = rng.choice(n, size=bs, replace=False)
        qs = series[rows].copy()
        for i in range(half, bs):
            qs[i] = warp_series(series[rows[i]], shift=int(rng.integers(1, 4)),
                                stretch=1.02, seed=int(rows[i]), noise=0.02)
        batches.append((rows, qs))

    spec = ssh_ecg.CONFIG
    cfg = ssh_ecg.search_config(length=m)
    log(f"spec {spec.to_dict()}; search {cfg.to_dict()}")

    # -- a. batched path ------------------------------------------------------
    def batched_path():
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        db = TimeSeriesDB.build(series, spec, cfg)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        log(f"build: {build_s:.2f} s ({n / build_s:.0f} series/s), index "
            f"{db.index.nbytes() / 1e9:.2f} GB on {dev}, launches "
            f"{ops.launch_counts()}")
        results, walls = [], []
        for bi, (rows, qs) in enumerate(batches):
            before = ops.launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = ssh_search_batch(qs, db.index, config=db.config)
            wall = time.perf_counter() - t
            after = ops.launch_counts()
            st = res.stats
            per_q = [res.per_query(i) for i in range(res.n_queries)]
            results.append(per_q)
            walls.append(wall)
            selfs = [int(r.ids[0]) == int(rows[i])
                     for i, r in enumerate(per_q[:half])]
            if not all(selfs):
                raise AssertionError(
                    f"batch {bi}: self-match failed for rows "
                    f"{[int(rows[i]) for i, ok in enumerate(selfs) if not ok]}")
            for r in per_q:
                if not (len(r.ids) == cfg.topk and r.stats is None
                        and np.all(np.isfinite(r.dists))
                        and np.all(np.diff(r.dists) >= 0)
                        and np.all((r.ids >= 0) & (r.ids < n))):
                    raise AssertionError(f"batch {bi}: malformed result {r}")
            log(f"batch {bi}: us_per_query {wall / bs * 1e6:.1f} stage_us "
                f"{ {k: round(v, 1) for k, v in st.stage_us.items()} } "
                f"(whole batch) n_in {st.n_in} lb_pruned {st.lb_pruned} "
                f"n_dtw {st.n_dtw} abandoned {st.dtw_abandoned} launches "
                f"{ {k: after[k] - before[k] for k in after} }")
        log(f"batched path: peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        return db, results, build_s

    db, results, build_s = counted(
        "batched", ("sketch_conv", "collision_count_batch",
                    "topc_histogram", "topc_threshold", "topc_scatter",
                    "dtw_wavefront_pairs"), batched_path)

    # -- b. sequential path ---------------------------------------------------
    rows0, qs0 = batches[0]
    seq_pick = list(range(SEQ_ROWS)) + list(range(half, half + SEQ_WARPED))
    db_local = TimeSeriesDB(db.index, cfg.replace(searcher="local"))
    # the batched path left batch 0's multiprobe signatures in the index's
    # LRU under the key the sequential encode reads: emptied, so this path
    # encodes (and launches sketch_conv) as a cold query does
    db.index.sig_cache = None

    def sequential_path():
        out, walls = [], []
        for i in seq_pick:
            torch.cuda.synchronize()
            t = time.perf_counter()
            out.append(db_local.search(qs0[i]))
            walls.append(time.perf_counter() - t)
        return out, walls

    seq_res, seq_walls = counted(
        "sequential", ("sketch_conv", "collision_count", "dtw_wavefront"),
        sequential_path)
    max_rel = 0.0
    for j, i in enumerate(seq_pick):
        got, want = seq_res[j], results[0][i]
        if i < half and int(got.ids[0]) != int(rows0[i]):
            raise AssertionError(f"sequential query {i}: top-1 {got.ids[0]} "
                                 f"is not the database row {rows0[i]}")
        if not np.array_equal(got.ids, want.ids):
            raise AssertionError(f"sequential query {i}: ids {got.ids} != "
                                 f"batched ids {want.ids}")
        np.testing.assert_allclose(got.dists, want.dists, rtol=1e-5,
                                   atol=1e-6)
        max_rel = max(max_rel, float(np.max(
            np.abs(got.dists - want.dists) / np.maximum(want.dists, 1e-30))))
        if got.stats.n_dtw != got.n_candidates:
            raise AssertionError(f"sequential query {i}: stats.n_dtw "
                                 f"{got.stats.n_dtw} != n_candidates")
    seq_us = float(np.mean(seq_walls[1:]) * 1e6)
    stage_keys = seq_res[0].stats.stage_us.keys()
    seq_stage = {k: round(float(np.mean([r.stats.stage_us[k]
                                         for r in seq_res[1:]])), 1)
                 for k in stage_keys}
    log(f"sequential: {len(seq_pick)} queries ({SEQ_ROWS} database rows "
        f"self-matched, {SEQ_WARPED} warped), ids equal to the batched "
        f"answers, largest relative distance difference {max_rel:.3g}; "
        f"us_per_query {seq_us:.1f} (mean of queries 2-{len(seq_pick)}; "
        f"the first {seq_walls[0] * 1e6:.1f}) stage_us {seq_stage}; "
        f"n_dtw per query {[r.stats.n_dtw for r in seq_res]}")

    # -- c. UCR baseline ------------------------------------------------------
    # positions in batch 0: database rows first, then warped copies
    ucr_pick = (list(range(UCR_QUERIES // 2))
                + list(range(half, half + UCR_QUERIES // 2)))
    db_series = db.index.series

    def ucr_path():
        out, walls = [], []
        for i in ucr_pick:
            torch.cuda.synchronize()
            t = time.perf_counter()
            out.append(search.ucr_search(qs0[i], db_series, topk=cfg.topk,
                                         band=cfg.band))
            walls.append(time.perf_counter() - t)
        return out, walls

    ucr_res, ucr_walls = counted("ucr", ("dtw_wavefront",), ucr_path)
    precs, ndcgs = [], []
    for j, i in enumerate(ucr_pick):
        u = ucr_res[j]
        if i < half and int(u.ids[0]) != int(rows0[i]):
            raise AssertionError(f"ucr query {i}: top-1 {u.ids[0]} is not "
                                 f"the database row {rows0[i]}")
        ssh_ids = seq_res[seq_pick.index(i)].ids
        precs.append(search.precision_at_k(ssh_ids, u.ids, cfg.topk))
        ndcgs.append(search.ndcg_at_k(ssh_ids, u.ids, cfg.topk))
    t = time.perf_counter()
    for i in (ucr_pick[0], ucr_pick[-1])[:UCR_GOLD]:
        gold_ids, _ = search.brute_force_topk(qs0[i], db_series, cfg.topk,
                                              cfg.band)
        got = ucr_res[ucr_pick.index(i)].ids
        if not np.array_equal(got, gold_ids):
            raise AssertionError(f"ucr query {i}: ids {got} != brute force "
                                 f"{gold_ids}")
    gold_s = time.perf_counter() - t
    ucr_us = float(np.mean(ucr_walls) * 1e6)
    log(f"ucr: {len(ucr_pick)} queries over {n} series, survivors "
        f"{[u.n_candidates for u in ucr_res]}, us_per_query {ucr_us:.1f} "
        f"({[round(w * 1e6, 1) for w in ucr_walls]}); {UCR_GOLD} equal to "
        f"brute force ({gold_s:.1f} s of plain DTW over the database); SSH "
        f"precision@{cfg.topk} {precs} NDCG@{cfg.topk} "
        f"{[round(x, 4) for x in ndcgs]} against UCR; UCR / sequential SSH "
        f"time per query {ucr_us / seq_us:.1f}")

    # -- d. streaming ingest --------------------------------------------------
    spec_cs = IndexSpec(encoder="ssh-cs", params=dict(
        spec.params, rows=4, width=4096, base_bits=4), seed=spec.seed)
    n_base = n // 2
    block = (n - n_base) // STREAM_BLOCKS

    def streaming_path():
        t = time.perf_counter()
        db_cs = TimeSeriesDB.build(series[:n_base], spec_cs, cfg)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        enc = db_cs.index.encoder
        agg0 = enc.aggregate_sketch().clone()
        shards = [StreamIngestor(enc, shard=f"edge{s}")
                  for s in range(STREAM_SHARDS)]
        t = time.perf_counter()
        # shard s takes blocks s, s + 2, ... and appends them last first
        for s, sh in enumerate(shards):
            for seq in reversed(range(s, STREAM_BLOCKS, STREAM_SHARDS)):
                lo = n_base + seq * block
                sh.append(series[lo:lo + block], seq=seq)
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t
        merged = StreamIngestor.merge_all(shards[::-1])
        shard_sum = shards[0].sketch + shards[1].sketch
        if not torch.equal(merged.sketch, shard_sum):
            raise AssertionError("merged cs/agg is not the exact sum of the "
                                 "shard aggregates")
        t = time.perf_counter()
        db_cs.apply_stream(merged)
        torch.cuda.synchronize()
        fold_s = time.perf_counter() - t
        if not torch.equal(enc.aggregate_sketch(), agg0 + shard_sum):
            raise AssertionError("folded cs/agg is not the exact sum")
        n_cs = n_base + STREAM_BLOCKS * block
        if len(db_cs) != n_cs:
            raise AssertionError(f"folded database holds {len(db_cs)} rows, "
                                 f"expected {n_cs}")
        lo = n_base + 3 * block
        again = enc.encode_batch(db_cs.index.series[lo:lo + 4096])
        if not torch.equal(again, db_cs.index.signatures[lo:lo + 4096]):
            raise AssertionError("a re-encoded chunk disagrees with the "
                                 "signatures the ingestor stored")
        if not torch.equal(db_cs.index.series[lo:lo + 4096].cpu(),
                           torch.from_numpy(series[lo:lo + 4096])):
            raise AssertionError("streamed rows are not in seq order")
        picks = np.random.default_rng(args.seed + 2).choice(
            np.arange(n_base, n_cs), size=8, replace=False)
        db_cs_batched = TimeSeriesDB(db_cs.index, cfg)
        db_cs_local = TimeSeriesDB(db_cs.index,
                                   cfg.replace(searcher="local"))
        for name, d in (("batched", db_cs_batched), ("local", db_cs_local)):
            res = d.search_batch(series[picks])
            bad = [int(p) for p, r in zip(picks, res)
                   if int(r.ids[0]) != int(p)]
            if bad:
                raise AssertionError(f"streaming, {name} searcher: streamed "
                                     f"rows {bad} do not find themselves")
        log(f"streaming: ssh-cs build of {n_base} series {build_s:.2f} s, "
            f"ingest of {n_cs - n_base} series through {STREAM_SHARDS} "
            f"shards {ingest_s:.2f} s ({(n_cs - n_base) / ingest_s:.0f} "
            f"series/s), fold {fold_s:.2f} s; cs/agg "
            f"{tuple(enc.sketch_shape)} holds "
            f"{int(enc.aggregate_sketch()[0].abs().sum())} |updates| at "
            f"level 0; merged aggregate exact; re-encoded chunk equal; 8 "
            f"streamed rows self-match through both searchers")
        return db_cs

    db_cs = counted("streaming", ("sketch_conv", "cs_tables",
                                  "collision_count_batch",
                                  "dtw_wavefront_pairs", "collision_count",
                                  "dtw_wavefront"), streaming_path)

    # -- e. persistence, host buckets, the srp and ssh-multires encoders,
    #    the launchers and the signature LRU ---------------------------------
    persist_paths(args, counted, dict(
        series=series, batches=batches, spec=spec, cfg=cfg, db=db,
        results=results, build_s=build_s, db_cs=db_cs, seq_pick=seq_pick,
        ucr_pick=ucr_pick, ucr_res=ucr_res, precs=precs))
    gc.collect()
    torch.cuda.empty_cache()

    # -- 4. kernels, on inputs recorded from one more run of each path ------
    # batch 0 is in the LRU again: emptied, so the recorded run encodes
    db.index.sig_cache = None
    with Recorder(ops, ("sketch_conv", "collision_count_batch",
                        "dtw_rerank_pairs")) as rec_b:
        ssh_search_batch(batches[0][1], db.index, config=db.config)
    with Recorder(ops, ("collision_count", "dtw_rerank")) as rec_s:
        db_local.search(qs0[half])
    with Recorder(ops, ("dtw_rerank",)) as rec_u:
        search.ucr_search(qs0[half], db_series, topk=cfg.topk, band=cfg.band)
    with Recorder(ops, ("cs_tables",)) as rec_c:
        db_cs.index.encoder.encode_batch(db_cs.index.series[:4096])
    entries = []

    # sketch_conv: a build chunk (the rows encode_chunked hands it) and the
    # query encode (B·O rows of the multiprobe slices)
    xq, filt, step = rec_b.calls["sketch_conv"][0][0]
    xb = db.index.series[:4096]

    def conv_at(x, filt, step):
        wconv = filt.t().contiguous()[:, None, :]
        return lambda: torch.nn.functional.conv1d(
            x[:, None, :], wconv, stride=step).transpose(1, 2)

    def sketch_check(x, filt, step, tag):
        """(kernel, plain, |err|) of one call, after holding it bit for
        bit to the emulation and within the bound of the plain version."""
        kern = ops.sketch_conv(x, filt, step)
        emu = ref.sketch_conv_fma_ref(x, filt, step)
        if not torch.equal(kern, emu):
            raise AssertionError(
                f"sketch_conv ({tag} shape) is not bit-identical to "
                f"sketch_conv_fma_ref: {int((kern != emu).sum())} outputs "
                f"differ")
        plain = ref.sketch_conv_ref(x, filt, step)
        scale = ref.sketch_conv_ref(x.abs(), filt.abs(), step)
        err = (kern - plain).abs()
        if not bool((err <= 2 * filt.shape[0] * 2.0 ** -24 * scale).all()):
            raise AssertionError(
                f"sketch_conv ({tag} shape) disagrees with its plain version "
                f"beyond the reordering bound: max err {float(err.max())}")
        return kern, plain, err

    def sketch_at(x, filt, step, tag):
        """Check and time one call."""
        kern, plain, err = sketch_check(x, filt, step, tag)
        w, f_ = filt.shape
        bms, bkind = bound_ms(4 * (x.numel() + filt.numel() + kern.numel()),
                              2 * x.shape[0] * kern.shape[1] * f_ * w)
        out = dict(
            max_abs_err=float(err.max()),
            **kernel_times(lambda: ops.sketch_conv(x, filt, step),
                           conv_at(x, filt, step)),
            plain_ms=cuda_time_ms(lambda: ref.sketch_conv_ref(x, filt, step)),
            bound_ms=bms, bound_by=bkind,
            library_max_abs_err=float(
                (conv_at(x, filt, step)() - plain).abs().max()),
            sign_flips=int(((kern >= 0) != (plain >= 0)).sum()),
            shape=f"x {tuple(x.shape)} filters {tuple(filt.shape)} "
                  f"step {step}")
        out["share_of_bound"] = bms / out["ms"]
        return out

    sk_report = sketch_build_report(_build)
    sk = {tag: sketch_at(x, filt, step, tag)
          for tag, x in (("build", xb), ("query", xq))}
    entries.append(dict(
        name="sketch_conv", route="cuda",
        source="src/repro_torch/csrc/sketch_conv.cu",
        replaces="src/repro/kernels/sketch_conv.py:48",
        launches=phases["batched"]["sketch_conv"], **sk["build"],
        launches_by_phase={p: c["sketch_conv"] for p, c in phases.items()},
        query_shape={k: sk["query"][k] for k in
                     ("shape", "ms", "call_ms", "plain_ms", "bound_ms",
                      "share_of_bound", "library_ms", "library_call_ms",
                      "max_abs_err", "sign_flips")},
        tolerance="bit-identical to ref.sketch_conv_fma_ref; |err| <= "
                  "2*W*2^-24*sum|x*f| against the plain version",
        sass=sk_report["sass"], registers=sk_report["registers"],
        library="F.conv1d(stride=step), cudnn.allow_tf32=False"))

    # collision_count_batch: the probe of B·O signature rows
    cc_report = collision_build_report(_build)

    def counts_check(qk, dbk):
        """The kernel's counts, after holding them exact."""
        kern = ops.collision_count_batch(qk, dbk)
        plain = ref.collision_count_batch_ref(qk, dbk)
        if not torch.equal(kern, plain):
            raise AssertionError(
                f"collision_count_batch is not exact at {tuple(qk.shape)}: "
                f"{int((kern != plain).sum())} counts differ")
        return kern, plain

    def counts_at(qk, dbk):
        """Check and time one call, with its cdist yardstick."""
        kern, plain = counts_check(qk, dbk)
        check_hash_range(qk, dbk)
        k_ = qk.shape[1]

        def cdist_counts():
            return k_ - torch.cdist(qk.float(), dbk.float(), p=0)
        if not torch.equal(cdist_counts().to(torch.int32), plain):
            raise AssertionError("cdist yardstick disagrees with the counts")
        bms, bkind = bound_ms(4 * (qk.numel() + dbk.numel() + kern.numel()),
                              2 * qk.shape[0] * dbk.shape[0] * k_,
                              INT32_OPS_PER_S)
        return dict(
            max_abs_err=0.0,
            **kernel_times(lambda: ops.collision_count_batch(qk, dbk),
                           cdist_counts),
            plain_ms=cuda_time_ms(
                lambda: ref.collision_count_batch_ref(qk, dbk)),
            bound_ms=bms, bound_by=bkind,
            shape=f"queries {tuple(qk.shape)} db {tuple(dbk.shape)}")

    qk, dbk = rec_b.calls["collision_count_batch"][0][0]
    probe_split = probe_split_ms(qk, dbk, cfg)
    entries.append(dict(
        name="collision_count_batch", route="cuda",
        source="src/repro_torch/csrc/collision_count.cu",
        replaces="src/repro/kernels/collision_count.py:68",
        launches=phases["batched"]["collision_count_batch"],
        **counts_at(qk, dbk),
        tolerance="exact", library="K - torch.cdist(q, db, p=0)",
        probe_split=probe_split, sass=cc_report["sass"],
        registers=cc_report["registers"]))

    # topc_select: the probe's top-C, at the benchmark's shapes and batch 0's
    o = cfg.multiprobe_offsets
    best = ops.collision_count_batch(qk, dbk).reshape(
        qk.shape[0] // o, o, -1).amax(1)
    entries.append(topc_select_entry(
        args.seed, {p: phases["batched"][p] for p in
                    ("topc_histogram", "topc_threshold", "topc_scatter")},
        (best, min(cfg.top_c, dbk.shape[0]), qk.shape[1])))
    del best

    # collision_count: one probe row of a sequential query
    cc_calls = rec_s.calls["collision_count"]
    for (q1, dbk1), _ in cc_calls[1:]:
        collision_check(q1, dbk1)
    entries.append(dict(
        name="collision_count", route="cuda",
        source="src/repro_torch/csrc/collision_count.cu",
        replaces="src/repro/kernels/collision_count.py:42",
        launches=phases["sequential"]["collision_count"],
        launches_by_phase={p: c["collision_count"]
                           for p, c in phases.items()},
        **collision_at(*cc_calls[0][0]),
        tolerance="exact", library="K - torch.cdist(q[None], db, p=0)"))
    entries[-1]["shape"] += (f"; {len(cc_calls)} calls (one per probe row) "
                             "checked")

    # DTW: every recorded call through the rule and through each schedule
    # that takes its radius, bit for bit against the plain version; timed
    # (both schedules in turns) at the batched survivors, the UCR scan and
    # a sequential re-rank
    dtw_report = dtw_build_report(_build)
    dtw_calls = rec_b.calls["dtw_rerank_pairs"]
    pairs_calls = dtw_calls_log("dtw_wavefront_pairs", dtw_calls)
    survivors = dtw_shape("dtw_wavefront_pairs", dtw_calls[-1], 2)
    entries.append(dict(
        name="dtw_wavefront_pairs", route="cuda",
        source="src/repro_torch/csrc/dtw_wavefront.cu",
        replaces="src/repro/kernels/dtw_wavefront.py:201",
        launches=phases["batched"]["dtw_wavefront_pairs"], max_abs_err=0.0,
        library_ms=None, **survivors,
        launches_by_schedule={s: phases["batched"][
            f"dtw_wavefront_pairs:{s}"] for s in kd.SCHEDULES},
        calls_checked=pairs_calls, tolerance="bit-identical",
        bound_note=DTW_BOUND_NOTE, sass=dtw_report["sass"]))

    one_calls = rec_s.calls["dtw_rerank"] + rec_u.calls["dtw_rerank"]
    one_log = dtw_calls_log("dtw_wavefront", one_calls)
    ucr_big = dtw_shape("dtw_wavefront", max(
        rec_u.calls["dtw_rerank"], key=lambda cl: cl[0][1].shape[0]), 1)
    seq_surv = dtw_shape("dtw_wavefront", rec_s.calls["dtw_rerank"][-1], 2)
    entries.append(dict(
        name="dtw_wavefront", route="cuda",
        source="src/repro_torch/csrc/dtw_wavefront.cu",
        replaces="src/repro/kernels/dtw_wavefront.py:151",
        launches=phases["sequential"]["dtw_wavefront"]
        + phases["ucr"]["dtw_wavefront"],
        launches_by_phase={p: c["dtw_wavefront"] for p, c in phases.items()},
        launches_by_schedule={p: {s: phases[p][f"dtw_wavefront:{s}"]
                                  for s in kd.SCHEDULES}
                              for p in ("sequential", "ucr")},
        max_abs_err=0.0, **ucr_big, library_ms=None,
        sequential_shape=seq_surv, tolerance="bit-identical",
        calls_checked=one_log, bound_note=DTW_BOUND_NOTE))
    for e in entries[-2:]:
        log(f"dtw {e['name']}: schedules of the recorded calls "
            f"{e['calls_checked']}; launches by schedule "
            f"{e['launches_by_schedule']}")
        for shape in (e, e.get("sequential_shape")):
            if shape:
                log(f"dtw {e['name']} [{shape['shape']}]: {shape['schedule']}"
                    f" {shape['ms']:.4f} ms, {shape['gcells_per_s']:.1f} "
                    f"Gcells/s, {shape['share_of_bound']:.3f} of the "
                    f"{shape['bound_ms']:.4f} ms bound (device time; call "
                    f"time {shape['call_ms']:.4f}); both schedules' call "
                    f"times in turns {shape['schedule_call_ms']}")

    # cs_tables: the level-0 tables of one 4096-row build chunk
    def cs_check(bkt, sgn, width):
        """The kernel's tables, after holding them bit for bit."""
        kern = ops.cs_tables(bkt, sgn, width)
        plain = ref.cs_tables_ref(bkt, sgn, width)
        if not torch.equal(kern, plain):
            raise AssertionError(f"cs_tables is not bit-identical: "
                                 f"{int((kern != plain).sum())} bins differ")
        return kern, plain

    def cs_at(bkt, sgn, width):
        """Check and time one call, with its scatter_add_ yardstick."""
        kern, plain = cs_check(bkt, sgn, width)
        b_, r_, s_ = bkt.shape
        tgt = torch.where(bkt >= 0, bkt, width).to(torch.int64).reshape(
            b_ * r_, s_)
        sg2 = sgn.reshape(b_ * r_, s_)

        def scatter_lib():
            return torch.zeros((b_ * r_, width + 1), dtype=torch.float32,
                               device=bkt.device).scatter_add_(1, tgt, sg2)
        if not torch.equal(scatter_lib()[:, :width].reshape(b_, r_, width),
                           plain):
            raise AssertionError("scatter_add_ yardstick disagrees")
        bms, bkind = bound_ms(4 * (2 * bkt.numel() + kern.numel()),
                              int((bkt >= 0).sum()))
        return dict(
            max_abs_err=0.0,
            **kernel_times(lambda: ops.cs_tables(bkt, sgn, width),
                           scatter_lib),
            plain_ms=cuda_time_ms(lambda: ref.cs_tables_ref(bkt, sgn,
                                                            width)),
            bound_ms=bms, bound_by=bkind,
            shape=f"bucket {tuple(bkt.shape)} width {width}; "
                  f"{float((kern == 0).float().mean()):.4f} of the bins "
                  "zero")

    entries.append(dict(
        name="cs_tables", route="cuda",
        source="src/repro_torch/csrc/count_sketch.cu",
        replaces="src/repro/kernels/count_sketch.py:51",
        launches=phases["streaming"]["cs_tables"],
        **cs_at(*rec_c.calls["cs_tables"][0][0]),
        tolerance="bit-identical",
        library="zeros(B*R, width + 1).scatter_add_(1, bucket, sign)"))

    # -- 5. cross-check on the CPU plain path -------------------------------
    cpu = torch.device("cpu")
    enc_cpu = type(db.index.encoder)(spec).load_state(
        {k: v.cpu() for k, v in db.index.encoder._require_state().items()})
    idx_cpu = SSHIndex(encoder=enc_cpu, signatures=db.index.signatures.cpu(),
                       keys=db.index.keys.cpu(), series=db.index.series.cpu(),
                       env_radius=db.index.env_radius,
                       env_upper=db.index.env_upper.cpu(),
                       env_lower=db.index.env_lower.cpu(),
                       build_backend=db.index.build_backend)
    pick = list(range(4)) + list(range(half, half + 4))
    qs8 = batches[0][1][pick]
    t = time.perf_counter()
    res_cpu = ssh_search_batch(qs8, idx_cpu, cfg)
    cpu_s = time.perf_counter() - t
    for j, i in enumerate(pick):
        g = results[0][i]
        cids, cd = res_cpu.ids[j], res_cpu.dists[j]
        if not np.array_equal(g.ids, cids[cids >= 0]):
            raise AssertionError(f"cross-check query {i}: cuda ids {g.ids} "
                                 f"!= cpu ids {cids}")
        np.testing.assert_allclose(g.dists, cd[cids >= 0], rtol=1e-5,
                                   atol=1e-6)
    log(f"cross-check: 8 queries on the plain CPU path ({cpu_s:.1f} s on "
        f"{cpu}) match the CUDA path: ids equal, distances within rtol 1e-5")

    del idx_cpu, enc_cpu
    gc.collect()

    # -- 5a. the paper's functional API and the deprecation shims ----------
    t = time.perf_counter()
    paper_calls = paper_api_paths(args, counted, dict(
        series=series, batches=batches, cfg=cfg, db=db))
    # its five kernels on the phase's own inputs: the calls held to their
    # plain versions (a sample of the builds' sketch chunks; the DTW calls
    # but the whole-database best_so_far scans, which are held to
    # brute_force_topk in the phase, and most of srp_search's), one of
    # each timed
    by_name = {e["name"]: e for e in entries}
    sk_calls = paper_calls["sketch_conv"]
    held = sk_calls[::PAPER_SKETCH_HOLD] + sk_calls[-2:]
    for (x, filt_p, step_p), _ in held[1:]:
        sketch_check(x, filt_p, step_p, "paper_api")
    paper = {"sketch_conv": dict(sketch_at(*held[0][0], "paper_api"),
                                 calls_held=len(held))}
    cc_calls = paper_calls["collision_count_batch"]
    for (qk_p, dbk_p), _ in cc_calls[1:]:
        counts_check(qk_p, dbk_p)
    paper["collision_count_batch"] = dict(counts_at(*cc_calls[0][0]),
                                          calls_held=len(cc_calls))
    for (q1, dbk1), _ in paper_calls["collision_count"]:
        collision_check(q1, dbk1)
    pair_calls = paper_calls["dtw_rerank_pairs"]
    paper["dtw_wavefront_pairs"] = dict(
        dtw_shape("dtw_wavefront_pairs", pair_calls[0], 1), max_abs_err=0.0,
        calls_checked=dtw_calls_log("dtw_wavefront_pairs", pair_calls))
    # the threshold call, then srp_search's (radius 511, whose plain
    # version takes ~0.6 s a call): the whole-database scans are skipped
    one_calls = [cl for cl in paper_calls["dtw_rerank"]
                 if cl[0][1].shape[0] < db_series.shape[0]]
    one_calls = one_calls[:1 + PAPER_SRP_DTW_HOLD]
    paper["dtw_wavefront"] = dict(
        dtw_shape("dtw_wavefront", one_calls[0], 1), max_abs_err=0.0,
        calls_checked=dtw_calls_log("dtw_wavefront", one_calls))
    for name, got in paper.items():
        by_name[name]["paper_api_shapes"] = got
        by_name[name].setdefault("launches_by_phase", {})["paper_api"] = \
            phases["paper_api"][name]
        log(f"kernel {name} at the paper_api shape, held to the plain "
            f"version: [{got['shape']}] device ms {got['ms']:.4f} call ms "
            f"{got['call_ms']:.4f} plain_ms {got['plain_ms']:.4f} bound_ms "
            f"{got['bound_ms']:.5f} ({got['bound_by']})")
    by_name["collision_count"]["launches_by_phase"]["paper_api"] = \
        phases["paper_api"]["collision_count"]
    log(f"paper_api: {len(paper_calls['collision_count'])} collision_count "
        f"and {len(one_calls)} dtw_wavefront calls held; the phase with its "
        f"checks and timings {time.perf_counter() - t:.1f} s")
    del paper_calls, sk_calls, held, cc_calls, pair_calls, one_calls
    gc.collect()
    torch.cuda.empty_cache()

    # -- 5a'. the encoder composition ----------------------------------------
    t = time.perf_counter()
    pipe_calls = pipeline_paths(args, counted, dict(
        series=series, batches=batches, cfg=cfg, db=db, results=results,
        build_s=build_s))
    # its sketch and cs_tables calls held to their plain versions (every
    # 64th sketch chunk of the 2^20 build, the last two; every cs_tables
    # call), one of each timed
    sk_calls = pipe_calls["sketch_conv"]
    held = sk_calls[::PAPER_SKETCH_HOLD] + sk_calls[-2:]
    for (x, filt_p, step_p), _ in held[1:]:
        sketch_check(x, filt_p, step_p, "pipeline")
    cs_calls = pipe_calls["cs_tables"]
    for (bkt_p, sgn_p, width_p), _ in cs_calls[1:]:
        cs_check(bkt_p, sgn_p, width_p)
    pipe = {"sketch_conv": dict(sketch_at(*held[0][0], "pipeline"),
                                calls_held=len(held)),
            "cs_tables": dict(cs_at(*cs_calls[0][0]),
                              calls_held=len(cs_calls))}
    by_name = {e["name"]: e for e in entries}
    for name in ("sketch_conv", "cs_tables", "collision_count_batch",
                 "dtw_wavefront_pairs"):
        by_name[name].setdefault("launches_by_phase", {})["pipeline"] = \
            phases["pipeline"][name]
    for name, got in pipe.items():
        by_name[name]["pipeline_shapes"] = got
        log(f"kernel {name} at the pipeline shape, {got['calls_held']} calls "
            f"held to the plain version: [{got['shape']}] device ms "
            f"{got['ms']:.4f} call ms {got['call_ms']:.4f} plain_ms "
            f"{got['plain_ms']:.4f} bound_ms {got['bound_ms']:.5f} "
            f"({got['bound_by']})")
    log(f"pipeline: the phase with its checks and timings "
        f"{time.perf_counter() - t:.1f} s")
    del pipe_calls, sk_calls, held, cs_calls
    gc.collect()
    torch.cuda.empty_cache()

    # -- 5a''. the reference's surface: the examples and the closed gaps -----
    t = time.perf_counter()
    surf_calls = surface_paths(args, counted, dict(
        series=series, batches=batches, cfg=cfg, db=db, results=results))
    # every kernel call of the three examples held to its plain version
    for (x, filt_s, step_s), _ in surf_calls["sketch_conv"]:
        sketch_check(x, filt_s, step_s, "surface")
    for (qk_s, dbk_s), _ in surf_calls["collision_count_batch"]:
        counts_check(qk_s, dbk_s)
    for (q1, dbk1), _ in surf_calls["collision_count"]:
        collision_check(q1, dbk1)
    held_dtw = {k: dtw_calls_log(k, surf_calls[c]) for k, c in (
        ("dtw_wavefront_pairs", "dtw_rerank_pairs"),
        ("dtw_wavefront", "dtw_rerank"))}
    by_name = {e["name"]: e for e in entries}
    for name in ("sketch_conv", "collision_count_batch", "collision_count",
                 "dtw_wavefront_pairs", "dtw_wavefront", "cs_tables"):
        by_name[name].setdefault("launches_by_phase", {})["surface"] = \
            phases["surface"][name]
    log(f"surface: launches per kernel {phases['surface']}; the examples' "
        f"calls held to the plain versions: "
        f"{ {k: len(v) for k, v in surf_calls.items()} } (DTW schedules "
        f"{held_dtw}); the phase with its checks "
        f"{time.perf_counter() - t:.1f} s")
    del surf_calls
    gc.collect()
    torch.cuda.empty_cache()

    # -- 5b. the distributed and fleet tiers (before the engine: its insert
    #    makes the index N + 1 rows, which no longer divides a mesh) -------
    fleet_calls = fleet_paths(args, counted, dict(series=series,
                                                  batches=batches, cfg=cfg,
                                                  db=db))
    # its three kernels on the inputs of one fleet query, recorded from
    # the pool's threads: every call held as in step 4, one of each timed
    by_name = {e["name"]: e for e in entries}
    fleet_phases = [p for p in phases if p.startswith(("dist", "fleet"))]
    sk_calls = fleet_calls["sketch_conv"]
    for (x, filt_f, step_f), _ in sk_calls[1:]:
        sketch_check(x, filt_f, step_f, "fleet")
    shapes = {"sketch_conv": (sketch_at(*sk_calls[0][0], "fleet"),
                              len(sk_calls))}
    cc_calls = fleet_calls["collision_count"]
    for (q1, dbk1), _ in cc_calls[1:]:
        collision_check(q1, dbk1)
    shapes["collision_count"] = (collision_at(*cc_calls[0][0]),
                                 len(cc_calls))
    dtw_f = dtw_shape("dtw_wavefront", fleet_calls["dtw_rerank"][-1], 2)
    dtw_f.update(max_abs_err=0.0, calls_checked=dtw_calls_log(
        "dtw_wavefront", fleet_calls["dtw_rerank"]))
    shapes["dtw_wavefront"] = (dtw_f, len(fleet_calls["dtw_rerank"]))
    for name, (got, n_calls) in shapes.items():
        by_name[name]["fleet_shapes"] = dict(got, calls_held=n_calls)
        by_name[name]["launches_by_phase"].update(
            {p: phases[p][name] for p in fleet_phases})
        log(f"kernel {name} at the fleet shape, {n_calls} calls from the "
            f"pool's threads held to the plain version: [{got['shape']}] "
            f"device ms {got['ms']:.4f} call ms {got['call_ms']:.4f} "
            f"plain_ms {got['plain_ms']:.4f} bound_ms "
            f"{got['bound_ms']:.5f} ({got['bound_by']}) max_err "
            f"{got['max_abs_err']}")

    # -- 6. the serving engine (last: its insert grows the index) -----------
    recorded = engine_paths(args, counted, dict(series=series,
                                                batches=batches, cfg=cfg,
                                                db=db))
    # its three kernels on the inputs of its own batches of 8 and 1: every
    # call held as above, the first of each kernel (the last DTW call,
    # the survivors) timed
    by_name = {e["name"]: e for e in entries}
    for size, calls in recorded.items():
        tag = f"engine batch {size}"
        sk_calls = calls["sketch_conv"]
        for (x, filt_e, step_e), _ in sk_calls[1:]:
            sketch_check(x, filt_e, step_e, tag)
        x, filt_e, step_e = sk_calls[0][0]
        sk_e = sketch_at(x, filt_e, step_e, tag)
        cc_calls = calls["collision_count_batch"]
        for (qk_e, dbk_e), _ in cc_calls[1:]:
            counts_check(qk_e, dbk_e)
        cc_e = counts_at(*cc_calls[0][0])
        dtw_e = dtw_shape("dtw_wavefront_pairs",
                          calls["dtw_rerank_pairs"][-1], 2)
        dtw_e.update(max_abs_err=0.0, calls_checked=dtw_calls_log(
            "dtw_wavefront_pairs", calls["dtw_rerank_pairs"]))
        for name, got, n_calls in (
                ("sketch_conv", sk_e, len(sk_calls)),
                ("collision_count_batch", cc_e, len(cc_calls)),
                ("dtw_wavefront_pairs", dtw_e,
                 len(calls["dtw_rerank_pairs"]))):
            by_name[name].setdefault("engine_shapes", {})[
                f"batch {size}"] = dict(got, calls_held=n_calls)
            log(f"kernel {name} at the {tag} shape, {n_calls} calls held "
                f"to the plain version: [{got['shape']}] device ms "
                f"{got['ms']:.4f} call ms {got['call_ms']:.4f} plain_ms "
                f"{got['plain_ms']:.4f} bound_ms {got['bound_ms']:.5f} "
                f"max_err {got['max_abs_err']}")
    return entries


def dtw64_pairs(q, x, band):
    """Float64 banded squared DTW of row-aligned pairs, (P, m) x (P, m)
    -> (P,): an anti-diagonal DP over the cells, written apart from the
    port's DTW; the reference the subsequence gates hold answers to."""
    p, m = q.shape
    q, x = q.double(), x.double()
    r = m - 1 if band is None else int(band)
    i = torch.arange(m, device=q.device)
    inf = torch.full((p, 1), float("inf"), dtype=torch.float64,
                     device=q.device)
    prev2 = inf.expand(p, m).clone()
    prev1 = prev2.clone()
    for d in range(2 * m - 1):
        j = d - i                           # cell (i, d - i) of diagonal d
        ok = (j >= 0) & (j < m) & ((i - j).abs() <= r)
        cost = (q - x[:, j.clamp(0, m - 1)]) ** 2
        up = torch.cat([inf, prev1[:, :-1]], 1)        # (i - 1, j)
        diag = torch.cat([inf, prev2[:, :-1]], 1)      # (i - 1, j - 1)
        best = torch.minimum(torch.minimum(up, prev1), diag)  # prev1: (i, j-1)
        if d == 0:
            best = torch.zeros_like(best)
        prev2, prev1 = prev1, torch.where(ok, cost + best, float("inf"))
    return prev1[:, m - 1]


def subseq_paths(args, counted, phases) -> dict:
    """Paths ``subseq*`` and ``subseq_exact`` (step 7 of the docstring);
    returns the ``stream_shape`` entries of ``sketch_conv``,
    ``collision_count`` and ``dtw_wavefront`` by kernel name.  Every
    tensor is freed when this returns, and the saved directory is
    removed."""
    import shutil
    import tempfile
    import torch.nn.functional as F
    from repro_torch.configs import ssh_ecg
    from repro_torch.core import search
    from repro_torch.data.timeseries import synthetic_ecg, warp_series
    from repro_torch.db import TimeSeriesDB
    from repro_torch.encoders import make_encoder
    from repro_torch.kernels import ops, ref
    from repro_torch.subseq import num_windows
    from repro_torch.subseq.index import exclusion_pick

    dev = torch.device("cuda")
    m, spec = args.length, ssh_ecg.CONFIG
    w_ = spec.params["window"]
    excl = m // 2                            # the default exclusion zone
    kernels = ("sketch_conv", "collision_count", "dtw_wavefront")

    # -- data: one stream, two planted patterns, queries ---------------------
    t = time.perf_counter()
    stream = ecg_stream(args.subseq_points, args.seed).copy()
    rng = np.random.default_rng(args.seed + 11)

    def pattern():
        """A random walk at the stream's scale: unlike any ECG window."""
        walk = rng.normal(size=m).cumsum()
        return ((walk - walk.mean()) / walk.std()
                * stream.std()).astype(np.float32)
    planted = [pattern() for _ in SUBSEQ_PLANT]
    for off, pat in zip(SUBSEQ_PLANT, planted):
        stream[off:off + m] = pat
    n_pts = len(stream)
    nw = {h: num_windows(n_pts, m, h) for h in SUBSEQ_HOPS}
    log(f"subseq: one synthetic-ECG stream of {n_pts} points from seed "
        f"{args.seed} ({stream.nbytes / 1e9:.3f} GB, made in "
        f"{time.perf_counter() - t:.1f} s): {nw[1]} windows of {m} at hop "
        f"1 (the paper's database is {ssh_ecg.PAPER_N_SERIES}), {nw[6]} at "
        f"hop 6; two random-walk patterns planted at {SUBSEQ_PLANT}")

    def cut_and_warped(limit):
        """8 windows cut at offsets (multiples of 6, below ``limit``) and
        8 warped copies of others."""
        offs = [6 * int(o) for o in rng.integers(0, limit // 6, SUBSEQ_CUT)]
        qs = [stream[o:o + m].copy() for o in offs]
        for o in rng.integers(0, limit // 6, SUBSEQ_WARPED):
            o = 6 * int(o)
            qs.append(warp_series(stream[o:o + m], shift=int(rng.integers(
                1, 4)), stretch=1.02, seed=o, noise=0.02))
        return offs, qs
    cut_offs, queries = cut_and_warped(n_pts - m)

    # -- gate 1: the sketch at the stream shape --------------------------------
    filt = make_encoder(spec, dev)._require_state()["filters"]
    xs = torch.as_tensor(stream, device=dev)
    suffix = xs[SUBSEQ_SUFFIX:]
    if suffix.data_ptr() % 16 == 0:
        raise AssertionError("the suffix view should start off a 16-byte "
                             "boundary")
    checked = []
    for x, g, tag in ((xs, 1, "stream, stride 1 (hop 1)"),
                      (xs, 3, "stream, stride 3 (hop 6)"),
                      (suffix, 1, f"suffix from point {SUBSEQ_SUFFIX}, "
                                  "stride 1")):
        kern = ops.sketch_conv(x[None], filt, g)
        emu = ref.sketch_conv_fma_ref(x[None], filt, g)
        if not torch.equal(kern, emu):
            raise AssertionError(
                f"sketch_conv at the stream shape ({tag}) is not "
                f"bit-identical to sketch_conv_fma_ref: "
                f"{int((kern != emu).sum())} outputs differ")
        checked.append(f"{tag}: {tuple(kern.shape)} bit-identical")
        del kern, emu
    x1 = xs[None]
    kern = ops.sketch_conv(x1, filt, 1)
    plain = ref.sketch_conv_ref(x1, filt, 1)
    scale = ref.sketch_conv_ref(x1.abs(), filt.abs(), 1)
    err = (kern - plain).abs()
    if not bool((err <= 2 * w_ * 2.0 ** -24 * scale).all()):
        raise AssertionError(f"sketch_conv at the stream shape disagrees "
                             f"with its plain version beyond the "
                             f"reordering bound: max err {float(err.max())}")
    wconv = filt.t().contiguous()[:, None, :]

    def conv(x, g):
        return lambda: F.conv1d(x[:, None, :], wconv, stride=g).transpose(
            1, 2)
    bms, bkind = bound_ms(4 * (x1.numel() + filt.numel() + kern.numel()),
                          2 * kern.shape[1] * w_)
    stream_shape = dict(
        shape=f"x {tuple(x1.shape)} filters {tuple(filt.shape)} step 1",
        **kernel_times(lambda: ops.sketch_conv(x1, filt, 1), conv(x1, 1)),
        plain_ms=cuda_time_ms(lambda: ref.sketch_conv_ref(x1, filt, 1),
                              min_iters=2),
        bound_ms=bms, bound_by=bkind, max_abs_err=float(err.max()),
        library_max_abs_err=float((conv(x1, 1)() - plain).abs().max()),
        bit_identical=True, checked=checked,
        stride3=dict(kernel_times(lambda: ops.sketch_conv(x1, filt, 3),
                                  conv(x1, 3)),
                     bound_ms=bound_ms(
                         4 * (x1.numel() + filt.numel()
                              + (n_pts - w_) // 3 + 1),
                         2 * ((n_pts - w_) // 3 + 1) * w_)[0]))
    stream_shape["share_of_bound"] = bms / stream_shape["ms"]
    del kern, plain, scale, err, xs, x1, suffix
    log(f"subseq: sketch_conv at the stream shape: {stream_shape}")

    def sample_ids(n_windows):
        """Gate 2's windows: the first and last SUBSEQ_EDGE and
        SUBSEQ_DRAWN drawn from --seed."""
        mid = rng.choice(np.arange(SUBSEQ_EDGE, n_windows - SUBSEQ_EDGE),
                         size=SUBSEQ_DRAWN, replace=False)
        return np.sort(np.concatenate([
            np.arange(SUBSEQ_EDGE), mid,
            np.arange(n_windows - SUBSEQ_EDGE, n_windows)]))

    def rolling_equals_per_window(db, rows, what):
        """Gate 2: the rows' signatures and keys equal ``encode_batch`` of
        the materialised windows.  Returns the seconds of
        ``SUBSEQ_ENC_REPEATS`` more per-window encodes of the sample (the
        checked one warms them up)."""
        sub, enc = db.subseq, db.index.encoder
        idx = torch.as_tensor(rows, device=dev)
        wins = sub.stream.unfold(0, m, sub.hop)[idx]
        sigs = enc.encode_chunked(wins)
        bad = int((sigs != db.index.signatures[idx]).any(1).sum())
        bad_keys = int((enc.band_keys(sigs) != db.index.keys[idx])
                       .any(1).sum())
        if bad or bad_keys:
            raise AssertionError(f"{what}: {bad} of {len(rows)} rolling "
                                 f"signatures and {bad_keys} key rows differ "
                                 f"from the per-window encode")
        enc_s = []
        for _ in range(SUBSEQ_ENC_REPEATS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            enc.encode_chunked(wins)
            torch.cuda.synchronize()
            enc_s.append(time.perf_counter() - t)
        return enc_s

    def check_answers(db, qs, res, what):
        """Gate 3: top-1 is the float64 DP's minimum over the probe pool,
        offsets are ids x hop, pairwise at least the zone apart.  Returns
        whether each query's own window was in its pool."""
        sub, cfg = db.subseq, db.config
        in_pool = []
        for qi, (q, r) in enumerate(zip(qs, res)):
            q_t = torch.as_tensor(q, device=dev)
            cand = search.hash_probe(
                q_t, db.index, cfg.top_c,
                rank_by_signature=cfg.rank_by_signature,
                multiprobe_offsets=cfg.multiprobe_offsets)
            wins = sub.stream[cand[:, None] * sub.hop
                              + torch.arange(m, device=dev)]
            dp = dtw64_pairs(q_t.expand_as(wins), wins, cfg.band)
            dmin = float(dp.min())
            tol = 1e-5 * dmin + 1e-6
            ties = set(cand[dp <= dmin + tol].tolist())
            if abs(float(r.dists[0]) - dmin) > tol or int(r.ids[0]) not in ties:
                raise AssertionError(
                    f"{what} query {qi}: top-1 {int(r.ids[0])} at "
                    f"{float(r.dists[0])!r} is not the float64 minimum "
                    f"{dmin!r} over its {len(cand)} pooled windows "
                    f"(at {sorted(ties)[:4]})")
            if not np.array_equal(r.offsets, r.ids * sub.hop):
                raise AssertionError(f"{what} query {qi}: offsets "
                                     f"{r.offsets} != ids x {sub.hop}")
            gap = np.abs(r.offsets[:, None] - r.offsets[None, :])
            np.fill_diagonal(gap, excl)
            if not (1 <= len(r.ids) <= cfg.topk and gap.min() >= excl
                    and np.all(np.isfinite(r.dists))
                    and np.all(np.diff(r.dists) >= 0)):
                raise AssertionError(f"{what} query {qi}: {len(r.ids)} "
                                     f"answers at offsets {r.offsets}, "
                                     f"distances {r.dists}: malformed or "
                                     f"closer than {excl}")
            if qi < len(cut_offs):
                in_pool.append(cut_offs[qi] // sub.hop in set(
                    cand.tolist()))
        return in_pool

    def search_all(db, qs):
        out, walls = [], []
        for q in qs:
            torch.cuda.synchronize()
            t = time.perf_counter()
            out.append(db.search_subsequence(q))
            walls.append(time.perf_counter() - t)
        return out, walls

    def report(hop, build_s, res, walls, in_pool, enc_s, n_sample):
        n_w = nw[hop]
        stage = {k: round(float(np.mean([r.stats.stage_us[k]
                                         for r in res[1:]])), 3)
                 for k in res[0].stats.stage_us}
        hits = [int(r.offsets[0]) == o and float(r.dists[0]) == 0.0
                for r, o in zip(res, cut_offs)]
        per_window = [n_sample / e for e in enc_s]
        log(f"subseq hop {hop}: build {build_s:.2f} s, {n_w / build_s:.0f} "
            f"windows/s rolling (signatures and keys) against "
            f"{np.median(per_window):.0f} windows/s per-window encode_batch "
            f"(signatures alone; median of {len(enc_s)} warm calls on the "
            f"{n_sample}-window sample, from {min(per_window):.0f} to "
            f"{max(per_window):.0f}; {n_sample} windows equal, signatures "
            f"and keys); "
            f"us_per_query {np.mean(walls[1:]) * 1e6:.1f} (mean of queries "
            f"2-{len(walls)}; the first {walls[0] * 1e6:.1f}) stage_us "
            f"{stage}; n_dtw {[r.stats.n_dtw for r in res]}; cut copies "
            f"at rank 1 and distance 0: {sum(hits)} of {len(hits)}; the "
            f"others' own window in the top-{res[0].stats.n_in} probe pool "
            f"(else top-C ties left it out): "
            f"{[p for p, h in zip(in_pool, hits) if not h]}")
        return dict(build_s=build_s, windows_per_s=n_w / build_s,
                    per_window_encode_per_s=float(np.median(per_window)),
                    per_window_encode_per_s_all=per_window,
                    us_per_query=float(np.mean(walls[1:]) * 1e6),
                    stage_us=stage, cut_hits=sum(hits))

    # -- phase subseq: hop 1, the paper's count ------------------------------
    cfg1 = ssh_ecg.search_config(length=m).replace(
        searcher="local", subseq_window=m, subseq_hop=1)
    log(f"subseq: spec {spec.to_dict()}; search {cfg1.to_dict()}")
    tail = synthetic_ecg(SUBSEQ_TAIL, seed=args.seed + 13)
    tail_pat = pattern()
    tail[SUBSEQ_TAIL_PLANT:SUBSEQ_TAIL_PLANT + m] = tail_pat

    def hop1_path():
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        db = TimeSeriesDB.build_stream(stream, spec, cfg1)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        stream_shape["launches"] = ops.launch_counts()["sketch_conv"]
        log(f"subseq hop 1: index {db.subseq.nbytes() / 1e9:.2f} GB on "
            f"{dev}, build peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        return (db, build_s) + search_all(db, queries)

    def kernels_at_stream(db, phase):
        """The probe's and the re-rank's kernels at this index's shapes:
        one warped copy searched from an empty LRU under a Recorder
        (outside the counted phase), every ``collision_count`` call held
        exact and every DTW call bit-identical through the rule and each
        schedule; the first probe row and the survivors' DTW timed."""
        db.index.sig_cache = None
        with Recorder(ops, ("collision_count", "dtw_rerank")) as rec:
            db.search_subsequence(queries[SUBSEQ_CUT])
        cc, dt = rec.calls["collision_count"], rec.calls["dtw_rerank"]
        for (q1, dbk1), _ in cc[1:]:
            collision_check(q1, dbk1)
        cc_at = dict(collision_at(*cc[0][0]), calls_held=len(cc),
                     launches=phases[phase]["collision_count"])
        dtw_at = dict(dtw_shape("dtw_wavefront", dt[-1], 2), max_abs_err=0.0,
                      calls_checked=dtw_calls_log("dtw_wavefront", dt),
                      launches=phases[phase]["dtw_wavefront"])
        del rec, cc, dt
        for name, got in (("collision_count", cc_at),
                          ("dtw_wavefront", dtw_at)):
            shapes[name][f"hop {db.subseq.hop}"] = got
            log(f"kernel {name} at the subseq hop {db.subseq.hop} shape, "
                f"every call held to the plain version: [{got['shape']}] "
                f"device ms {got['ms']:.4f} ({got['device_source']}) call "
                f"ms {got['call_ms']:.4f} plain_ms {got['plain_ms']:.4f} "
                f"library ms {got.get('library_ms')} bound_ms "
                f"{got['bound_ms']:.5f} ({got['bound_by']}) launches in "
                f"{phase} {got['launches']}")

    shapes = {"sketch_conv": stream_shape, "collision_count": {},
              "dtw_wavefront": {}}
    db, build_s, res, walls = counted("subseq", kernels, hop1_path)
    in_pool = check_answers(db, queries, res, "subseq hop 1")
    kernels_at_stream(db, "subseq")
    rows = sample_ids(nw[1])
    enc_s = rolling_equals_per_window(db, rows, "subseq hop 1")
    summary = {1: report(1, build_s, res, walls, in_pool, enc_s, len(rows))}

    # -- phase subseq_extend: growth -------------------------------------------
    def extend_path():
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        n_new = db.extend_stream(tail)
        torch.cuda.synchronize()
        ext_s = time.perf_counter() - t
        return n_new, ext_s, db.search_subsequence(tail_pat)

    n_new, ext_s, found = counted("subseq_extend", kernels, extend_path)
    if n_new != num_windows(n_pts + SUBSEQ_TAIL, m, 1) - nw[1]:
        raise AssertionError(f"extend_stream: {n_new} new windows")
    new = torch.arange(nw[1], nw[1] + n_new, device=dev)
    enc = db.index.encoder
    own = enc.encode_chunked(db.subseq.stream.unfold(0, m, 1)[new])
    if not (torch.equal(own, db.index.signatures[nw[1]:])
            and torch.equal(enc.band_keys(own), db.index.keys[nw[1]:])):
        raise AssertionError("extend_stream: the new windows' signatures or "
                             "keys differ from the per-window encode")
    want_off = n_pts + SUBSEQ_TAIL_PLANT
    if int(found.offsets[0]) != want_off or float(found.dists[0]) != 0.0:
        raise AssertionError(f"extend_stream: the window planted at "
                             f"{want_off} came back at {found.offsets[0]} "
                             f"({found.dists[0]})")
    log(f"subseq extend: {n_new} windows from a {SUBSEQ_TAIL}-point tail in "
        f"{ext_s * 1e3:.1f} ms ({ext_s / n_new * 1e6:.2f} us a window, the "
        f"concatenation of every signature and key included), peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; signatures and "
        f"keys equal the per-window encode; the planted window found at "
        f"rank 1, distance 0")
    summary["extend_us_per_window"] = ext_s / n_new * 1e6
    del db, res, own, new, enc
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase subseq_hop6: the aligned route -----------------------------------
    cfg6 = cfg1.replace(subseq_hop=6)

    def hop6_path():
        t = time.perf_counter()
        db = TimeSeriesDB.build_stream(stream, spec, cfg6)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        stream_shape["stride3"]["launches"] = \
            ops.launch_counts()["sketch_conv"]
        return (db, build_s) + search_all(db, queries)

    db, build_s, res, walls = counted("subseq_hop6", kernels, hop6_path)
    in_pool = check_answers(db, queries, res, "subseq hop 6")
    kernels_at_stream(db, "subseq_hop6")
    rows = sample_ids(nw[6])
    enc_s = rolling_equals_per_window(db, rows, "subseq hop 6")
    summary[6] = report(6, build_s, res, walls, in_pool, enc_s, len(rows))
    del db, res
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase subseq_exact: the first 2^18 windows against fixed length --------
    ex_offs, ex_queries = cut_and_warped(SUBSEQ_EXACT_WINDOWS)
    ex_queries += planted
    dbs = {}

    def exact_path():
        out = {}
        for hop in SUBSEQ_HOPS:
            pts = (SUBSEQ_EXACT_WINDOWS - 1) * hop + m
            db = TimeSeriesDB.build_stream(stream[:pts], spec,
                                           cfg1.replace(subseq_hop=hop))
            dbs[hop] = db
            out[hop] = search_all(db, ex_queries)[0]
        return out

    ex_res = counted("subseq_exact", kernels, exact_path)
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    for hop in SUBSEQ_HOPS:
        db_s, res_s = dbs[hop], ex_res[hop]
        cfg = db_s.config
        wins = db_s.subseq.stream.unfold(0, m, hop).contiguous()
        db_w = TimeSeriesDB.build(wins, spec, cfg)
        if not torch.equal(db_w.index.signatures, db_s.index.signatures):
            bad = (db_w.index.signatures != db_s.index.signatures).any(1)
            raise AssertionError(
                f"subseq_exact hop {hop}: {int(bad.sum())} window "
                "signatures of the rolling build differ from "
                "TimeSeriesDB.build of the windows")
        oversample = max(2, excl // hop + 1)
        for qi, (q, got) in enumerate(zip(ex_queries, res_s)):
            cand = search.hash_probe(
                torch.as_tensor(q, device=dev), db_w.index, cfg.top_c,
                rank_by_signature=cfg.rank_by_signature,
                multiprobe_offsets=cfg.multiprobe_offsets)
            k_eff = min(len(cand), cfg.topk * oversample)
            r = search.ssh_search(q, db_w.index, cfg.replace(topk=k_eff))
            sel = exclusion_pick(r.ids * hop, excl, cfg.topk)
            if not (np.array_equal(got.ids, r.ids[sel])
                    and np.array_equal(got.dists, r.dists[sel])):
                raise AssertionError(
                    f"subseq_exact hop {hop} query {qi}: ids {got.ids} "
                    f"dists {got.dists} != ssh_search over the windows "
                    f"{r.ids[sel]} {r.dists[sel]}")
        t = time.perf_counter()
        for qi, (off, pat) in enumerate(zip(SUBSEQ_PLANT, planted)):
            q_t = torch.as_tensor(pat, device=dev)
            best = (float("inf"), -1)
            for lo in range(0, SUBSEQ_EXACT_WINDOWS, SUBSEQ_BRUTE_CHUNK):
                ids, d = search.brute_force_topk(
                    q_t, wins[lo:lo + SUBSEQ_BRUTE_CHUNK], 1, cfg.band)
                best = min(best, (float(d[0]), lo + int(ids[0])))
            got = res_s[len(ex_offs) + SUBSEQ_WARPED + qi]
            if best != (0.0, off // hop) or int(got.ids[0]) != best[1] \
                    or float(got.dists[0]) != 0.0:
                raise AssertionError(
                    f"subseq_exact hop {hop}: the pattern planted at {off} "
                    f"came back at {int(got.offsets[0])} "
                    f"({float(got.dists[0])}), brute force at window "
                    f"{best[1]} ({best[0]})")
        brute_s = time.perf_counter() - t
        del db_w, wins
        # persistence: save, load, the same answers and the same growth
        tmp = Path(tempfile.mkdtemp(prefix="subseq_", dir=root))
        try:
            t = time.perf_counter()
            db_s.save(tmp)
            save_s = time.perf_counter() - t
            t = time.perf_counter()
            loaded = TimeSeriesDB.load(tmp)
            load_s = time.perf_counter() - t
            nbytes = dir_bytes(tmp)
        finally:
            shutil.rmtree(tmp)
        for qi, (q, want) in enumerate(zip(ex_queries, res_s)):
            got = loaded.search_subsequence(q)
            if not (np.array_equal(got.ids, want.ids)
                    and np.array_equal(got.dists, want.dists)):
                raise AssertionError(f"subseq_exact hop {hop}: the loaded "
                                     f"database answers query {qi} with "
                                     f"{got.ids} {got.dists}, not "
                                     f"{want.ids} {want.dists}")
        grown = [d.extend_stream(tail) for d in (db_s, loaded)]
        if grown[0] != grown[1] or not (
                torch.equal(db_s.index.signatures, loaded.index.signatures)
                and torch.equal(db_s.index.keys, loaded.index.keys)):
            raise AssertionError(f"subseq_exact hop {hop}: extend_stream "
                                 "of the loaded database differs")
        hits = sum(int(r.offsets[0]) == o and float(r.dists[0]) == 0.0
                   for r, o in zip(res_s, ex_offs))
        log(f"subseq_exact hop {hop}: {SUBSEQ_EXACT_WINDOWS} windows; "
            f"signatures equal TimeSeriesDB.build of the windows; "
            f"{len(ex_queries)} answers equal ssh_search at the "
            f"oversampled topk ({cfg.topk} x {oversample}) then the same "
            f"pick, ids and distances bit for bit; the {len(planted)} "
            f"planted patterns at rank 1, distance 0, as brute force over "
            f"every window ({brute_s:.1f} s of plain DTW in chunks of "
            f"{SUBSEQ_BRUTE_CHUNK}); cut copies at rank 1: {hits} of "
            f"{len(ex_offs)}; saved ({nbytes / 1e6:.1f} MB) in {save_s:.2f} "
            f"s, loaded in {load_s:.2f} s, answers bit-identical, "
            f"{grown[0]} windows grown alike")
        del loaded
    dbs.clear()
    gc.collect()
    torch.cuda.empty_cache()
    log("subseq summary: " + json.dumps({str(k): v
                                          for k, v in summary.items()}))
    return shapes


def causal_pairs(s, t):
    """Unmasked (query i, key j) pairs under the causal mask j <= i, for
    S queries over T keys: the work the kernel must do."""
    m = min(s, t)
    return m * (m + 1) // 2 + (s - m) * t


def device_profile(fn):
    """Run ``fn`` once under ``torch.profiler``; returns the device time
    of every kernel, memcpy and memset it ran (ms), how many there were,
    and the ms of the two flash kernels among them.  The profiler
    slows the host, so a busy share divides this device time by an
    unprofiled wall time."""
    from repro_torch.bench.device_time import Window
    with Window("device_profile") as win:
        fn()
    dev = [e for e in win.events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return dict(
        device_ms=sum(e.self_device_time_total for e in dev) / 1e3,
        device_ops=sum(e.count for e in dev),
        flash_ms=sum(e.self_device_time_total for e in dev
                     if "flash_attention_tc_kernel" in e.key
                     or "flash_attention_simt_kernel" in e.key) / 1e3)


def flash_bound(q, k, v, ops_per_s=BF16_TC_OPS_PER_S, causal=True):
    """(bound_ms, bound_by) of one flash launch: 2·(D + Dv) flops per
    unmasked (query, key) pair of every head (S = Q K^T and P V) at
    ``ops_per_s`` (the bf16 tensor cores by default), and q, k, v, o read
    or written once."""
    b, h, s, d = q.shape
    t, dv = k.shape[2], v.shape[3]
    pairs = causal_pairs(s, t) if causal else s * t
    n_bytes = q.element_size() * (q.numel() + k.numel() + v.numel()
                                  + b * h * s * dv)
    return bound_ms(n_bytes, 2 * b * h * (d + dv) * pairs, ops_per_s)


def in_turns(fns, rounds=2):
    """CUDA-event ms of each callable of ``fns`` (a dict), timed in turns
    (a b c, c b a, ...) so that a drift of the card's clock falls on all
    of them alike; returns {name: [ms of each turn]}."""
    names = list(fns)
    out = {n: [] for n in names}
    for r in range(rounds):
        for n in (names if r % 2 == 0 else names[::-1]):
            out[n].append(cuda_time_ms(fns[n]))
    return out


def ptxas_report(_build, name, label):
    """{kernel label: [ptxas's registers, stack and spill lines]} of the
    library ``name``; ``label`` maps a mangled name to a short one."""
    import re
    kernels, cur = {}, None
    for line in _build.build_log(name).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = label(m.group(1))
            kernels[cur] = []
        elif cur and ("registers" in line or "stack frame" in line
                      or "spill" in line):
            kernels[cur].append(line.replace("ptxas info    :", "").strip())
    for kname, info in kernels.items():
        log(f"ptxas {kname}: {'; '.join(info)}")
    return kernels


def dtw_schedules_for(r):
    """The DTW schedules that take radius ``r``."""
    from repro_torch.kernels import dtw_wavefront as kd
    return tuple(s for s in kd.SCHEDULES
                 if s != "rows" or r <= kd.ROWS_MAX_RADIUS)


def dtw_build_report(_build):
    """Print what ptxas said of every DTW kernel (a spill fails the run)
    and the SASS instructions a DP cell at r = 25 of each schedule
    (``bench.dtw_schedules.cell_costs``, from ``cuobjdump -sass``)."""
    import re
    from repro_torch.bench.dtw_schedules import cell_costs, kernel_of

    def label(mangled):
        k = kernel_of(mangled)
        if not k:
            return mangled
        return k[0] + (f"<{k[1]}>" if k[2] is None
                       else f"<{k[1]},thr={k[2]},one={k[3]}>")
    kernels = ptxas_report(_build, "dtw_wavefront", label)
    spills = {k: i for k, i in kernels.items()
              if any(re.search(r"[1-9]\d* bytes spill", x) for x in i)}
    if spills:
        raise AssertionError(f"DTW kernels spill: {spills}")
    costs = cell_costs(str(_build.library_path("dtw_wavefront")))
    sass = {k: {a: round(v[a], 2) for a in ("per_slot", "row_overhead",
                                            "per_cell") if a in v}
            for k, v in costs.items() if "per_cell" in v}
    log(f"SASS of the DTW kernels, instructions a DP cell at r = 25: "
        f"{sass}")
    regs = {k: next((x for x in i if "registers" in x), "")
            for k, i in kernels.items()}
    return dict(sass=sass, ptxas_kernels=len(kernels), registers=regs)


def collision_build_report(_build):
    """Print what ptxas said of every collision-count kernel (a spill
    fails the run, as does local memory in the SASS) and the batch
    kernel's SASS instructions a key compared
    (``bench.collision_count.key_costs``, from ``cuobjdump -sass``)."""
    import re
    from repro_torch.bench.collision_count import key_costs

    def label(mangled):
        m = re.search(r"(collision_count(?:_batch)?_kernel)ILi(\d+)E"
                      r"(?:Lb([01])E)?", mangled)
        if not m:
            return mangled
        return (f"{m.group(1)}<{m.group(2)}"
                f"{'' if m.group(3) is None else ',vec=' + m.group(3)}>")
    kernels = ptxas_report(_build, "collision_count", label)
    spills = {k: i for k, i in kernels.items()
              if any(re.search(r"[1-9]\d* bytes spill", x) for x in i)}
    if spills:
        raise AssertionError(f"collision-count kernels spill: {spills}")
    costs = key_costs(str(_build.library_path("collision_count")))
    if costs["local_memory"]:
        raise AssertionError(f"collision-count kernels use local memory: "
                             f"{costs['local_memory']}")
    sass = {k: {a: (round(v[a], 3) if isinstance(v[a], float) else v[a])
                for a in ("per_key", "lds_per_key", "instructions",
                          "compares", "ops")}
            for k, v in costs["batch"].items()}
    log(f"SASS of collision_count_batch_kernel, the hot loop: {sass}")
    regs = {k: next((x for x in i if "registers" in x), "")
            for k, i in kernels.items()}
    return dict(sass=sass, ptxas_kernels=len(kernels), registers=regs)


def no_spill(kernels, what):
    """Fail on a ptxas report of spilled bytes or a stack frame."""
    import re
    bad = {k: i for k, i in kernels.items()
           if any(re.search(r"[1-9]\d* bytes (spill|stack)", x) for x in i)}
    if bad:
        raise AssertionError(f"{what} spill or use a stack frame: {bad}")


def sketch_build_report(_build):
    """Print what ptxas said of every sketch kernel (a spill, or local
    memory in the SASS, fails the run) and the SASS instructions a filter
    tap of each (``bench.sketch_flash.tap_costs``)."""
    import re
    from repro_torch.bench.sketch_flash import tap_costs

    def label(mangled):
        m = re.search(r"sketch_conv_kernelILi(\d+)ELi(\d+)E", mangled)
        if not m:
            return mangled
        return ("sketch_conv_kernel<runtime>" if m.group(1) == "0" else
                f"sketch_conv_kernel<{m.group(1)},{m.group(2)}>")
    kernels = ptxas_report(_build, "sketch_conv", label)
    no_spill(kernels, "sketch kernels")
    costs = tap_costs(str(_build.library_path("sketch_conv")))
    if costs["local_memory"]:
        raise AssertionError(f"sketch kernels use local memory: "
                             f"{costs['local_memory']}")
    sass = {k: {a: (round(v[a], 3) if isinstance(v[a], float) else v[a])
                for a in ("per_tap", "scope", "instructions", "ffma", "ops")}
            for k, v in costs["kernels"].items()}
    log(f"SASS of the sketch kernels, the FFMA loop: {sass}")
    regs = {k: next((x for x in i if "registers" in x), "")
            for k, i in kernels.items()}
    return dict(sass=sass, registers=regs)


#: the probe's (B, N) counts the top-C select is timed at: ssh-ecg's and
#: ssh-randomwalk's rows at the benchmark's scale (portbench/configs), a
#: block of 64 queries, K 40, top 512
TOPC_SHAPES = (("ecg", 64, 6_291_456), ("rw", 64, 1_572_864))
TOPC_K, TOPC_C = 40, 512


def topc_probe_counts(kind, b, n, k, seed, dev):
    """Counts shaped like a probe's.  ``"spread"``: most rows agree on
    few of the k hashes (0-11) and one in 5,000 on 12 to k, so a query's
    top 512 spread over many counts and every chunk; ``"ties"``: counts
    skewed towards 0 with 0.4 % of the rows at k, so the top is one mass
    of ties, as on quasi-periodic ECG."""
    g = torch.Generator(device=dev).manual_seed(seed)
    u = torch.rand((b, n), generator=g, device=dev)
    if kind == "ties":
        return (u ** 6 * (k + 1)).floor().clamp_(max=k).to(torch.int32)
    counts = (u ** 3 * 12).floor().to(torch.int32)
    tail = torch.rand((b, n), generator=g, device=dev) < 2e-4
    counts[tail] = torch.randint(12, k + 1, (int(tail.sum()),),
                                 generator=g, device=dev, dtype=torch.int32)
    return counts


def topc_read_bytes(counts, ids):
    """Bytes the select must read for these counts: every count once, and
    again each chunk that writes a column, up to the scatter's tile (4,096
    columns) that holds its last one; a chunk stops there."""
    from repro_torch.kernels import topc_select as tc
    b, n = counts.shape
    chunk = tc.chunk_rows(b, n)
    chunks = -(-n // chunk)
    last = torch.full((b, chunks), -1, dtype=torch.int64,
                      device=counts.device)
    last.scatter_reduce_(1, ids // chunk, ids, "amax")
    lo = torch.arange(chunks, device=counts.device) * chunk
    length = (torch.clamp(n - lo, max=chunk))[None, :]
    tile = tc.CHUNK_MULTIPLE
    again = torch.where(last >= 0, torch.minimum(
        ((last - lo) // tile + 1) * tile, length), 0)
    return 4 * (counts.numel() + int(again.sum()))


def composite_topk(counts, top_c):
    """What ``top_c_by_count`` ran before the kernel: ``torch.topk`` of
    count·2^32 + (N-1-column), the key written first."""
    n = counts.shape[1]
    rev = n - 1 - torch.arange(n, device=counts.device)
    key = (counts.to(torch.int64) << 32) | rev
    top = torch.topk(key, top_c, dim=1, sorted=True).values
    return n - 1 - (top & 0xFFFFFFFF), (top >> 32).to(torch.int32)


def topc_select_at(counts, top_c, max_count, tag):
    """Hold the select to the composite-key ``torch.topk`` and to its
    plain version (ids and counts), then time it: device and call ms,
    the composite key and ``torch.topk`` as the library, the plain
    version's call ms, and the bound: one read of the counts and the
    outputs written, which any exact select moves.  ``read_bytes`` and
    ``two_reads_ms`` are what this design reads and two full reads."""
    from repro_torch.kernels import ops, ref
    ids, vals = ops.top_c_select(counts, top_c, max_count)
    want_ids, want_vals = composite_topk(counts, top_c)
    plain = ref.top_c_select_ref(counts, top_c, max_count)
    for what, got, want in (("ids", ids, want_ids), ("counts", vals,
                            want_vals), ("plain ids", ids, plain[0]),
                            ("plain counts", vals, plain[1])):
        if not torch.equal(got, want):
            raise AssertionError(f"topc_select at {tag} "
                                 f"{tuple(counts.shape)}: {what} differ "
                                 f"in {int((got != want).sum())} places")
    del want_ids, want_vals, plain
    read = topc_read_bytes(counts, ids)
    bms, bkind = bound_ms(4 * counts.numel() + 12 * ids.numel(), 0)
    out = dict(max_abs_err=0.0,
               **kernel_times(lambda: ops.top_c_select(counts, top_c,
                                                       max_count),
                              lambda: composite_topk(counts, top_c)),
               plain_ms=cuda_time_ms(lambda: ref.top_c_select_ref(
                   counts, top_c, max_count), min_iters=2),
               bound_ms=bms, bound_by=bkind, read_bytes=read,
               two_reads_ms=bound_ms(8 * counts.numel(), 0)[0],
               tie_slots=int((vals == vals[:, -1:]).sum()),
               shape=f"counts {tuple(counts.shape)}, max {max_count}, "
                     f"top {top_c}")
    out["share_of_bound"] = bms / out["ms"]
    log(f"topc_select at {tag}: device ms {out['ms']:.4f} call ms "
        f"{out['call_ms']:.4f} composite torch.topk device ms "
        f"{out['library_ms']} plain call ms {out['plain_ms']:.2f} bound "
        f"{bms:.4f} ms ({bkind}, {out['share_of_bound']:.3f} of it; "
        f"this design's reads {bound_ms(read, 0)[0]:.4f} ms, two full "
        f"reads {out['two_reads_ms']:.4f} ms); tie slots "
        f"{out['tie_slots']} [{out['shape']}]")
    return out


def topc_select_entry(seed, launches, probe=None):
    """The top-C select's kernel entry: the ecg and rw shapes with spread
    counts and with a mass of ties and, given (counts, top_c, max_count),
    the batched path's own probe."""
    dev = torch.device("cuda")
    shapes = {}
    for kind in ("spread", "ties"):
        for tag, b, n in TOPC_SHAPES:
            counts = topc_probe_counts(kind, b, n, TOPC_K, seed, dev)
            shapes[f"{tag}_{kind}"] = topc_select_at(
                counts, TOPC_C, TOPC_K, f"{tag}, {kind}")
            del counts
            torch.cuda.empty_cache()
    if probe is not None:
        shapes["batch0"] = topc_select_at(*probe, "batch 0's probe")
    return dict(name="topc_select", route="cuda",
                source="src/repro_torch/csrc/topc_select.cu",
                replaces="none: the reference's lax.top_k "
                         "(src/repro/core/index.py, top_c_by_count)",
                launches=launches, **shapes.pop("ecg_spread"),
                probe_shapes=shapes, tolerance="exact",
                library="torch.topk of count*2^32 + (N-1-column), the key "
                        "included")


def probe_split_ms(qk, dbk, cfg):
    """CUDA-event ms of the batched probe stage's three parts on one
    recorded input (``serving.batched.batch_probe``): the kernel, the max
    over the multiprobe offsets and ``top_c_by_count``."""
    from repro_torch.core.search import top_c_by_count
    from repro_torch.kernels import ops
    o = cfg.multiprobe_offsets
    b = qk.shape[0] // o
    top_c = min(cfg.top_c, dbk.shape[0])
    counts = ops.collision_count_batch(qk, dbk)
    best = counts.reshape(b, o, -1).amax(1)
    split = dict(
        kernel=cuda_time_ms(lambda: ops.collision_count_batch(qk, dbk)),
        offsets_max=cuda_time_ms(lambda: counts.reshape(b, o, -1).amax(1)),
        top_c=cuda_time_ms(lambda: top_c_by_count(best, top_c)))
    split["sum"] = sum(split.values())
    log(f"probe split, ms (batch 0's probe: counts {tuple(counts.shape)}, "
        f"{o} offsets, top {top_c}): "
        f"{ {k: round(v, 4) for k, v in split.items()} }")
    return split


def flash_build_report(_build, lib):
    """Print what ptxas said of every flash kernel (registers, stack and
    spills) and count the tensor-core instructions in the tensor-core
    kernel's SASS; a count of 0 fails the run."""
    import re
    import shutil

    def label(name):
        kind = re.search(r"flash_attention_(tc|simt)_kernel", name)
        args = ("bf16," if "nv_bfloat16" in name else
                "float," if "_kernelIf" in name else "")
        dims = ",".join(re.findall(r"Li(\d+)E", name)) or "?"
        copy = ",cp.async" if "Lb1E" in name else ""
        return f"{kind.group(0) if kind else name}<{args}{dims}{copy}>"
    no_spill(ptxas_report(_build, "flash_attention", label),
             "flash kernels")
    log(f"flash_attention_tc_kernel dynamic shared memory (bytes) by "
        f"instance: " + ", ".join(
            f"{dims} {lib.flash_attention_tc_smem_bytes(*dims)}"
            for dims in ((64, 64), (128, 128), (192, 128))))
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        raise RuntimeError("cuobjdump not found on PATH or in "
                           "/usr/local/cuda/bin: the tensor-core "
                           "instructions cannot be counted")
    sass = subprocess.run([tool, "-sass",
                           str(_build.library_path("flash_attention"))],
                          capture_output=True, text=True, check=True).stdout
    counts, cur, local = {}, None, set()
    for line in sass.splitlines():
        if "Function :" in line:
            cur = line.split("Function :")[1].strip()
            if "flash_attention_tc_kernel" in cur:
                counts[label(cur)] = {"HGMMA": 0, "HMMA": 0}
        elif cur and re.search(r"\b(LDL|STL)\b", line):
            local.add(label(cur))
        elif cur and "flash_attention_tc_kernel" in cur:
            for op in ("HGMMA", "HMMA"):
                if re.search(rf"\b{op}\.", line):
                    counts[label(cur)][op] += 1
    if local:
        raise AssertionError(f"flash kernels use local memory: {local}")
    log(f"SASS of flash_attention_tc_kernel by (Q/K, V) tile instance: "
        f"{counts}")
    if len(counts) != 3 or not all(c["HGMMA"] for c in counts.values()):
        raise AssertionError(f"an instance of flash_attention_tc_kernel "
                             f"has no HGMMA in its SASS: {counts}")
    return counts


def tc_check(q, k, v, tag, scale=None):
    """The tensor-core kernel (its launch counted once) on one causal
    flash call's inputs, per element against its plain version (bf16
    weights allowed for) and against the emulation of its own rounding
    (the tight bound); raises beyond either.  Returns both results, the
    median |o| and the shape."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import error_bound
    ops.reset_launch_counts()
    kern = ops.flash_attention(q, k, v, causal=True, scale=scale)
    torch.cuda.synchronize()
    if ops.launch_counts()["flash_attention"] != 1:
        raise AssertionError(f"flash check ({tag}) did not run the "
                             f"tensor-core kernel: {ops.launch_counts()}")
    plain = ref.flash_attention_ref(q, k, v, causal=True, scale=scale)
    emu = ref.flash_attention_tc_ref(q, k, v, causal=True, scale=scale)
    res = {}
    for against, want, bound in (
            ("plain", plain, error_bound(kern, plain, v, emu.abs_out)),
            ("emulation", emu.out, error_bound(kern, emu.out, v,
                                               emu.abs_out, emu.spread))):
        err = (kern.float() - want.float()).abs()
        ratio = float((err / bound).max())
        res[against] = dict(max_abs_err=float(err.max()),
                            worst_err_over_bound=ratio,
                            median_bound=float(bound.median()))
        if not ratio <= 1.0:
            raise AssertionError(
                f"flash_attention ({tag}) disagrees with its {against} "
                f"version beyond its bound: max err {float(err.max())}, "
                f"worst err/bound {ratio}")
    return dict(res, median_abs_out=float(plain.float().abs().median()),
                shape=f"q {tuple(q.shape)} k {tuple(k.shape)} v "
                      f"{tuple(v.shape)} {str(q.dtype)[6:]} causal")


def lm_path(args, counted, phases) -> dict:
    """Path e: granite-3-2b LM serving at full width (step 6 of the
    docstring); returns the entries of the two flash kernels."""
    from repro_torch.configs import granite_3_2b
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.flash_attention import (error_bound,
                                                     flash_attention_simt)
    from repro_torch.launch.serve import (check_prefill_against_decode,
                                          serve_lm)
    from repro_torch.models import transformer as T

    dev = torch.device("cuda")
    cfg = granite_3_2b.CONFIG
    sass_counts = flash_build_report(_build, _build.load("flash_attention"))
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = T.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    torch.cuda.synchronize()
    n_params = cfg.param_count()
    log(f"lm: {cfg.name} CONFIG at full width ({cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads, {cfg.n_kv_heads} KV "
        f"heads, head_dim {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; "
        f"{n_params} parameters, {torch.cuda.memory_allocated() / 1e9:.2f} "
        f"GB in {cfg.dtype}), random weights from seed {args.seed} drawn "
        f"on the card in {time.perf_counter() - t:.1f} s")
    rng = np.random.default_rng(args.seed + 3)

    def tokens(b, s):
        return torch.as_tensor(rng.integers(0, cfg.vocab, (b, s)),
                               device=dev)

    def timed_prefill(toks):
        """One prefill, timed once; (last logits, s, peak GB)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = T.prefill(params, toks, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        if out.shape != (toks.shape[0], 1, cfg.vocab) or not bool(
                torch.isfinite(out).all()):
            raise AssertionError(f"prefill logits {tuple(out.shape)} are "
                                 f"malformed or not finite")
        return out, wall, torch.cuda.max_memory_allocated() / 1e9

    def expect_launches(phase, n, kernel="flash_attention"):
        """n launches of ``kernel`` (one a layer) and none of the other
        flash kernel."""
        other = ({"flash_attention", "flash_attention_simt"}
                 - {kernel}).pop()
        got = phases[phase][kernel]
        if got != n or phases[phase][other]:
            raise AssertionError(f"phase {phase}: {got} {kernel} launches "
                                 f"and {phases[phase][other]} {other}, "
                                 f"expected {n} and 0 (one a layer)")

    T.prefill(params, tokens(1, 64), cfg)        # first-use set-up
    # -- e1. long prefill --------------------------------------------------
    long_len = args.lm_prompt
    log(f"lm: long prefill of 1 x {long_len} tokens: the prefill_32k "
        f"cell's shape with its batch cut from {PREFILL_32K_BATCH} to 1"
        + ("" if long_len == 32768 else f" and its length cut from 32768 "
           f"to {long_len}") + " to fit one run's time; timed once")
    toks_long = tokens(1, long_len)
    _, long_s, long_peak = counted("lm", ("flash_attention",),
                                   lambda: timed_prefill(toks_long))
    expect_launches("lm", cfg.n_layers)
    log(f"lm prefill 1 x {long_len}: {long_s:.3f} s, "
        f"{long_len / long_s:.1f} tokens/s, peak memory {long_peak:.2f} GB")

    # -- e2. batch prefill -------------------------------------------------
    toks_batch = tokens(LM_BATCH, LM_BATCH_LEN)
    _, batch_s, batch_peak = counted("lm_batch", ("flash_attention",),
                                     lambda: timed_prefill(toks_batch))
    expect_launches("lm_batch", cfg.n_layers)
    from repro_torch.launch import analytic
    measured("granite-3-2b", "prefill_32k", f"prefill {LM_BATCH} x "
             f"{LM_BATCH_LEN}", analytic.lm_model_flops(
                 cfg, "prefill", LM_BATCH, LM_BATCH_LEN), batch_s)
    log(f"lm prefill {LM_BATCH} x {LM_BATCH_LEN}: {batch_s:.3f} s, "
        f"{LM_BATCH * LM_BATCH_LEN / batch_s:.1f} tokens/s, peak memory "
        f"{batch_peak:.2f} GB")

    # -- e3. serve: stepped decode, greedy generation, one prefill ---------
    prompts = rng.integers(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT))
    torch.cuda.reset_peak_memory_stats()
    res = counted("lm_serve", ("flash_attention",),
                  lambda: serve_lm(cfg, params, prompts, gen_len=SERVE_GEN,
                                   device=dev))
    expect_launches("lm_serve", cfg.n_layers)
    serve_peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"lm serve {SERVE_BATCH} prompts of {SERVE_PROMPT} tokens, "
        f"{SERVE_GEN} generated: {res.decode_ms_per_step:.3f} ms per "
        f"generating decode step, {res.generated_tokens_per_s:.1f} "
        f"generated tokens/s; prompt stepping {res.prompt_s:.3f} s "
        f"({res.prompt_s * 1e3 / SERVE_PROMPT:.3f} ms a step, the first "
        f"included); prefill of the same prompts {res.prefill_s:.4f} s; "
        f"peak memory {serve_peak:.2f} GB; sample "
        f"{res.generated[0, :8].tolist()}")
    gate = check_prefill_against_decode(res, GATE_REL_TOL[cfg.dtype])
    # the same prompts through a float32 copy of the weights (the f32
    # kernel): there the two masks must agree to reordering
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = {k: (v.float() if k != "layers" else
                    {n: w.float() for n, w in v.items()})
                for k, v in params.items()}
    with Recorder(ops, ("flash_attention",)) as rec32:
        res32 = counted("lm_serve_f32", ("flash_attention_simt",),
                        lambda: serve_lm(cfg32, params32, prompts,
                                         gen_len=0, device=dev))
    expect_launches("lm_serve_f32", cfg.n_layers, "flash_attention_simt")
    q32, k32, v32 = rec32.calls["flash_attention"][0][0][:3]
    del params32, rec32
    gate32 = check_prefill_against_decode(res32, GATE_REL_TOL["float32"])
    log(f"lm_serve_f32: prefill of {SERVE_BATCH} x {SERVE_PROMPT} in "
        f"float32 {res32.prefill_s:.4f} s ({cfg.n_layers} "
        f"flash_attention_simt launches); prompt stepping "
        f"{res32.prompt_s:.3f} s")
    off = {name: float((a.float() - b).abs().max())
               / gate32["max_abs_logit"]
           for name, a, b in (
               ("prefill", res.prefill_logits, res32.prefill_logits),
               ("decode", res.prompt_logits, res32.prompt_logits))}
    log(f"lm gate: prefill against stepped decode after token "
        f"{SERVE_PROMPT}, bf16: {gate}; float32 copy of the weights: "
        f"{gate32}; max |bf16 - float32| / max |logit| of each path: "
        f"{ {k: round(v, 4) for k, v in off.items()} }")

    # -- device busy share: a batch prefill and 8 decode steps -------------
    prof_prefill = device_profile(lambda: T.prefill(params, toks_batch, cfg))
    cache = T.init_cache(cfg, SERVE_BATCH, SERVE_PROMPT + 8, dev)
    step_toks = torch.as_tensor(prompts, device=dev)

    def decode_8():
        nonlocal cache
        for i in range(8):
            _, cache = T.decode_step(params, cache, step_toks[:, i:i + 1],
                                     cfg)
    decode_8()                                    # steady state first
    cache["length"].zero_()
    prof_decode = device_profile(decode_8)
    if not (prof_prefill["device_ops"] and prof_decode["device_ops"]):
        log(f"lm device time: not measured, the profiler kept no device "
            f"record (prefill {prof_prefill['device_ops']}, decode "
            f"{prof_decode['device_ops']} operations)")
    else:
        log(f"lm device time: prefill {LM_BATCH} x {LM_BATCH_LEN} "
            f"{prof_prefill['device_ms']:.1f} ms on the device in "
            f"{prof_prefill['device_ops']} operations, flash_attention "
            f"{prof_prefill['flash_ms']:.1f} ms of it, busy "
            f"{prof_prefill['device_ms'] / (batch_s * 1e3):.3f} of the "
            f"unprofiled {batch_s * 1e3:.1f} ms; decode at batch "
            f"{SERVE_BATCH} "
            f"{prof_decode['device_ms'] / 8:.3f} ms on the device a step in "
            f"{prof_decode['device_ops'] / 8:.0f} operations, busy "
            f"{prof_decode['device_ms'] / 8 / res.decode_ms_per_step:.3f} of "
            f"the unprofiled {res.decode_ms_per_step:.3f} ms a step")

    # -- kernel against its plain version, on layer 0's own inputs ---------
    with Recorder(ops, ("flash_attention",), stop_after=1) as rec:
        T.prefill(params, toks_batch, cfg)
    with Recorder(ops, ("flash_attention",), stop_after=1) as rec_long:
        T.prefill(params, toks_long, cfg)
    qb, kb, vb = rec.calls["flash_attention"][0][0][:3]
    ql, kl, vl = rec_long.calls["flash_attention"][0][0][:3]
    checks = {}
    # all heads at 8 x 2048; heads 0-1 (both read KV head 0) of the long
    # prefill: all 32 at 32,768 would need 137 GB of float32 logits.  Two
    # bounds, per element: against the plain version, with the bf16
    # weights allowed for (2^-8 sum_j w_j |v_j|); and against the
    # emulation of the kernel's own rounding, the tight one, which sees
    # a wrong key tile where a row averages thousands of keys
    for tag, (q, k, v) in (("batch", (qb, kb, vb)),
                           ("long_2_heads", (ql[:, :2], kl[:, :1],
                                             vl[:, :1]))):
        checks[tag] = tc_check(q, k, v, tag)
    log(f"lm kernel checks against the plain version and the emulation of "
        f"its rounding (median |o| beside each median bound): {checks}")

    lib_b = sdpa_call(qb, kb, vb)
    lib_err = float((lib_b().float() - ref.flash_attention_ref(
        qb, kb, vb, causal=True).float()).abs().max())
    bms, bkind = flash_bound(qb, kb, vb)
    lbms, lbkind = flash_bound(ql, kl, vl)
    # the tensor-core kernel, the CUDA-core kernel on the same bf16 inputs
    # (its own entry point, off the path) and the library call, in turns
    turns = {tag: in_turns({
        "tensor_core": lambda q=q, k=k, v=v: ops.flash_attention(q, k, v),
        "cuda_core": lambda q=q, k=k, v=v: flash_attention_simt(q, k, v),
        "library": sdpa_call(q, k, v)})
        for tag, (q, k, v) in (("batch", (qb, kb, vb)),
                               ("long", (ql, kl, vl)))}
    mean = {tag: {n: sum(ms) / len(ms) for n, ms in t.items()}
            for tag, t in turns.items()}
    log(f"lm flash in turns (call ms of each turn): {turns}")
    dev_t = {tag: kernel_times(lambda q=q, k=k, v=v: ops.flash_attention(
        q, k, v), sdpa_call(q, k, v))
        for tag, (q, k, v) in (("batch", (qb, kb, vb)),
                               ("long", (ql, kl, vl)))}
    log(f"lm flash device and call ms: {dev_t}")
    long_entry = dict(
        **dev_t["long"],
        bound_ms=lbms, bound_by=lbkind,
        cuda_core_call_ms=mean["long"]["cuda_core"],
        share_of_bound=lbms / dev_t["long"]["ms"],
        plain_ms=None,
        plain_note=f"not timed at all {ql.shape[1]} heads: "
                   f"{ql.shape[1] * ql.shape[2] ** 2 * 4 / 1e9:.0f} GB of "
                   f"float32 logits",
        shape=f"q {tuple(ql.shape)} k/v {tuple(kl.shape)} bf16 causal "
              f"(layer 0 of the 1 x {long_len} prefill)",
        check_2_heads=checks["long_2_heads"])

    # the CUDA-core kernel on the float32 gate's layer-0 inputs
    kern32 = ops.flash_attention(q32, k32, v32, causal=True)
    plain32 = ref.flash_attention_ref(q32, k32, v32, causal=True)
    err32 = (kern32 - plain32).abs()
    if not bool((err32 <= error_bound(kern32, plain32, v32)).all()):
        raise AssertionError(f"flash_attention_simt disagrees with its plain "
                             f"version beyond float32 reordering: max err "
                             f"{float(err32.max())}")
    sbms, sbkind = flash_bound(q32, k32, v32, F32_OPS_PER_S)
    simt_times = kernel_times(lambda: ops.flash_attention(q32, k32, v32),
                              sdpa_call(q32, k32, v32))
    simt_entry = dict(
        name="flash_attention_simt", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:67",
        launches=phases["lm_serve_f32"]["flash_attention_simt"],
        max_abs_err=float(err32.max()),
        **simt_times,
        plain_ms=cuda_time_ms(lambda: ref.flash_attention_ref(
            q32, k32, v32, causal=True)),
        bound_ms=sbms, bound_by=sbkind,
        share_of_bound=sbms / simt_times["ms"],
        shape=f"q {tuple(q32.shape)} k/v {tuple(k32.shape)} float32 causal "
              f"(layer 0 of the float32 gate's prefill of {SERVE_BATCH} x "
              f"{SERVE_PROMPT})",
        tolerance="|err| <= 2^-13 * max|v| (float32 reordering)",
        bound_note="operations at the 67 TFLOP/s of float32 outside the "
                   "tensor cores: the float32 route keeps full float32 "
                   "products",
        library="F.scaled_dot_product_attention(is_causal=True), float32, "
                "KV heads expanded by repeat_interleave outside the timing")
    del kern32, plain32, err32
    return [dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:67",
        launches=phases["lm"]["flash_attention"],
        launches_by_phase={p: c["flash_attention"]
                           for p, c in phases.items()},
        max_abs_err=max(c["plain"]["max_abs_err"] for c in checks.values()),
        **dev_t["batch"],
        plain_ms=cuda_time_ms(lambda: ref.flash_attention_ref(
            qb, kb, vb, causal=True), min_iters=2),
        bound_ms=bms, bound_by=bkind,
        cuda_core_call_ms=mean["batch"]["cuda_core"],
        turns_call_ms=turns,
        share_of_bound=bms / dev_t["batch"]["ms"],
        sass=sass_counts,
        library_max_abs_err=lib_err,
        shape=f"q {tuple(qb.shape)} k/v {tuple(kb.shape)} bf16 causal "
              f"(layer 0 of the {LM_BATCH} x {LM_BATCH_LEN} prefill)",
        long_shape=long_entry,
        tolerance="per element, a = sum_j w_j |v_j|: against the plain "
                  "version one bf16 ulp at max(|kernel|, |plain|) + "
                  "(2^-13 + 2^-8) a (float32 reordering, P in bf16); "
                  "against ref.flash_attention_tc_ref one ulp + 2^-13 a + "
                  "its spread",
        library="F.scaled_dot_product_attention(is_causal=True), KV heads "
                "expanded by repeat_interleave outside the timing"),
        simt_entry]


def sdpa_call(q, k, v, scale=None):
    """``scaled_dot_product_attention`` on the flash call's inputs (KV
    heads expanded outside the call): the library yardstick."""
    g = q.shape[1] // k.shape[1]
    ke, ve = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q, ke, ve, is_causal=True, scale=scale)


def sdpa_backends(q, k, v, scale=None):
    """The fused ``scaled_dot_product_attention`` backends that take these
    inputs (each tried alone; a refusal raises RuntimeError), or "none"
    when only the math backend does."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    took = []
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION):
        try:
            with sdpa_kernel([backend]):
                sdpa_call(q, k, v, scale)()
            torch.cuda.synchronize()
            took.append(backend.name)
        except RuntimeError:
            pass
    return took or ["none: only the math backend"]


def flash_at_shape(q, k, v, scale, tag):
    """The tensor-core kernel on one layer-0 flash call of a suite
    prefill: held per element to its plain version and its emulation
    (``tc_check``); device and call ms (``kernel_times``, SDPA beside
    it); the tensor-core kernel, the CUDA-core kernel on the same bf16
    inputs and SDPA in turns; the plain version's ms; the bound."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import flash_attention_simt
    check = tc_check(q, k, v, tag, scale)
    backends = sdpa_backends(q, k, v, scale)
    lib = sdpa_call(q, k, v, scale)
    lib_err = float((lib().float() - ref.flash_attention_ref(
        q, k, v, causal=True, scale=scale).float()).abs().max())
    turns = in_turns({
        "tensor_core": lambda: ops.flash_attention(q, k, v, scale=scale),
        "cuda_core": lambda: flash_attention_simt(q, k, v, scale=scale),
        "library": lib})
    times = kernel_times(lambda: ops.flash_attention(q, k, v, scale=scale),
                         lib)
    bms, bkind = flash_bound(q, k, v)
    return dict(
        **times, bound_ms=bms, bound_by=bkind,
        share_of_bound=bms / times["ms"],
        plain_ms=cuda_time_ms(lambda: ref.flash_attention_ref(
            q, k, v, causal=True, scale=scale), min_iters=2),
        cuda_core_call_ms=sum(turns["cuda_core"]) / len(turns["cuda_core"]),
        turns_call_ms=turns, check=check,
        max_abs_err=check["plain"]["max_abs_err"],
        library_max_abs_err=lib_err, sdpa_backends=backends,
        scale=scale, shape=check["shape"])


def lm_suite(args, counted, phases) -> dict:
    """Step 8's other models (phases ``lm_8b``, ``lm_phi3``, ``lm_dbrx``,
    ``lm_deepseek`` and ``lm_deepseek_f32``, after granite-3-2b); returns
    the flash kernels' entries at their shapes,
    {kernel: {phase: sub-entry}}."""
    import importlib
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import error_bound
    from repro_torch.launch.serve import (check_prefill_against_decode,
                                          serve_lm)
    from repro_torch.models import moe
    from repro_torch.models import transformer as T

    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed + 5)
    shapes = {"flash_attention": {}, "flash_attention_simt": {}}

    def expect(phase, n, kernel="flash_attention"):
        other = ({"flash_attention", "flash_attention_simt"}
                 - {kernel}).pop()
        got = phases[phase][kernel]
        if got != n or phases[phase][other]:
            raise AssertionError(f"phase {phase}: {got} {kernel} launches "
                                 f"and {phases[phase][other]} {other}, "
                                 f"expected {n} and 0 (one a layer a "
                                 f"prefill)")

    def gate_config(cfg):
        """``cfg`` at a capacity factor that drops nothing in the serve
        prefill's groups or a decode step's (C >= n_g, as the reference's
        own decode test, ``tests/test_models_lm.py:21-23``)."""
        gcfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.top_k * 1.001)
        for n_g in (min(cfg.moe_group_size, SERVE_BATCH * SERVE_PROMPT),
                    SERVE_BATCH):
            if moe.capacity(gcfg.moe_cfg, n_g) < n_g:
                raise AssertionError(f"gate capacity below n_g {n_g}")
        return gcfg

    def describe(cfg, full_layers):
        cut = ("" if cfg.n_layers == full_layers else
               f"; DEPTH CUT from {full_layers} to {cfg.n_layers} layers")
        kind = ("MoE " if cfg.moe else "") + ("MLA" if cfg.mla else "GQA")
        return (f"{cfg.name} at full width ({kind}, {cfg.n_layers} layers, "
                f"d_model {cfg.d_model}, {cfg.n_heads} heads, "
                f"{cfg.n_kv_heads} KV heads, head_dim {cfg.hd}"
                + (f", experts {cfg.n_experts} top-{cfg.top_k} shared "
                   f"{cfg.n_shared} expert d_ff {cfg.moe_d_ff} group "
                   f"{cfg.moe_group_size} capacity factor "
                   f"{cfg.capacity_factor}" if cfg.moe else
                   f", d_ff {cfg.d_ff}")
                + (f", MLA rank {cfg.kv_lora_rank} q/k "
                   f"{cfg.qk_nope_dim}+{cfg.qk_rope_dim} v "
                   f"{cfg.v_head_dim}" if cfg.mla else "")
                + f", vocab {cfg.vocab}; {cfg.param_count()} parameters, "
                  f"{torch.cuda.memory_allocated() / 1e9:.2f} GB in "
                  f"{cfg.dtype}{cut})")

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    for phase, module, layers in LM_SUITE:
        full = importlib.import_module(f"repro_torch.configs.{module}").CONFIG
        cfg = (full if layers is None
               else dataclasses.replace(full, n_layers=layers))
        t = time.perf_counter()
        params = T.init_params(
            cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
        torch.cuda.synchronize()
        log(f"{phase}: {describe(cfg, full.n_layers)}, random weights from "
            f"seed {args.seed} drawn on the card in "
            f"{time.perf_counter() - t:.1f} s")
        toks = torch.as_tensor(rng.integers(0, cfg.vocab,
                                            (LM_BATCH, LM_BATCH_LEN)),
                               device=dev)
        prompts = rng.integers(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT))
        T.prefill(params, toks[:1, :64], cfg)        # first-use set-up

        def run():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            last = T.prefill(params, toks, cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if last.shape != (LM_BATCH, 1, cfg.vocab) or not bool(
                    torch.isfinite(last).all()):
                raise AssertionError(f"{phase} prefill logits "
                                     f"{tuple(last.shape)} are malformed "
                                     f"or not finite")
            peak = torch.cuda.max_memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()
            res = serve_lm(cfg, params, prompts, gen_len=SUITE_GEN,
                           device=dev)
            return wall, peak, res, torch.cuda.max_memory_allocated() / 1e9
        pre_s, pre_peak, res, serve_peak = counted(phase, ("flash_attention",),
                                                   run)
        expect(phase, 2 * cfg.n_layers)
        log(f"{phase} prefill {LM_BATCH} x {LM_BATCH_LEN}: {pre_s:.3f} s, "
            f"{LM_BATCH * LM_BATCH_LEN / pre_s:.1f} tokens/s, peak memory "
            f"{pre_peak:.2f} GB; serve {SERVE_BATCH} prompts of "
            f"{SERVE_PROMPT}, {SUITE_GEN} generated: "
            f"{res.decode_ms_per_step:.3f} ms per generating decode step, "
            f"{res.generated_tokens_per_s:.1f} generated tokens/s, prompt "
            f"stepping {res.prompt_s:.3f} s, prefill of the prompts "
            f"{res.prefill_s:.4f} s, peak memory {serve_peak:.2f} GB; "
            f"sample {res.generated[0, :8].tolist()}")
        served = dict(decode_ms_per_step=res.decode_ms_per_step,
                      generated_tokens_per_s=res.generated_tokens_per_s,
                      serve_peak_gb=serve_peak)
        if cfg.moe:
            with DropCounter() as pre_drops:
                T.prefill(params, toks, cfg)
            cache = T.init_cache(cfg, SERVE_BATCH, 1, dev)
            with DropCounter() as dec_drops:
                T.decode_step(params, cache, torch.as_tensor(
                    prompts[:, :1], device=dev), cfg)
            del cache
            # the same prompts at a capacity that drops nothing; in bf16 the
            # two paths' roundings move near-tied gates across the top-k
            # boundary, which no tolerance covers (the gap and the flips
            # are logged); the gate then routes every token to every
            # expert (top_k = E, the softmax weights), where the routing is
            # continuous, and the float32 phases hold the top-k routing
            gcfg = gate_config(cfg)
            with DropCounter() as topk_drops:
                res_k = counted(f"{phase}_topk", ("flash_attention",),
                                lambda: serve_lm(gcfg, params, prompts,
                                                 gen_len=0, device=dev))
            expect(f"{phase}_topk", cfg.n_layers)
            flips, pairs = topk_drops.flips(SERVE_BATCH, SERVE_PROMPT,
                                            cfg.n_layers)
            all_cfg = gate_config(dataclasses.replace(cfg,
                                                      top_k=cfg.n_experts))
            with DropCounter() as gate_drops:
                res = counted(f"{phase}_gate", ("flash_attention",),
                              lambda: serve_lm(all_cfg, params, prompts,
                                               gen_len=0, device=dev))
            expect(f"{phase}_gate", cfg.n_layers)
            log(f"{phase}: dropped (token, choice) assignments at the "
                f"config's capacity factor {cfg.capacity_factor}: "
                f"{pre_drops.dropped} of {pre_drops.total} "
                f"({pre_drops.share:.4f}) in the {LM_BATCH} x "
                f"{LM_BATCH_LEN} prefill, {dec_drops.dropped} of "
                f"{dec_drops.total} ({dec_drops.share:.4f}) in one decode "
                f"step; at factor {gcfg.capacity_factor:.4f}: "
                f"{topk_drops.dropped} of {topk_drops.total} (top-"
                f"{cfg.top_k}), {gate_drops.dropped} of {gate_drops.total} "
                f"(top-{cfg.n_experts})")
            if topk_drops.dropped or gate_drops.dropped:
                raise AssertionError(f"{phase}: the gate's capacity dropped "
                                     f"assignments")
            gap = check_prefill_against_decode(res_k, float("inf"))
            log(f"{phase}: prefill against stepped decode at top-"
                f"{cfg.top_k}, not gated: {gap}; (token, "
                f"layer) pairs whose experts differ between the two paths "
                f"{flips} of {pairs}; the gate below routes to all "
                f"{cfg.n_experts} experts")
        gate = check_prefill_against_decode(res, GATE_REL_TOL[cfg.dtype])
        log(f"{phase} gate: prefill against stepped decode after token "
            f"{SERVE_PROMPT}, {cfg.dtype}: {gate}")
        prof = device_profile(lambda: T.prefill(params, toks, cfg))
        if prof["device_ops"]:
            log(f"{phase} device time: prefill {LM_BATCH} x {LM_BATCH_LEN} "
                f"{prof['device_ms']:.1f} ms on the device in "
                f"{prof['device_ops']} operations, flash_attention "
                f"{prof['flash_ms']:.1f} ms of it, busy "
                f"{prof['device_ms'] / (pre_s * 1e3):.3f} of the "
                f"unprofiled {pre_s * 1e3:.1f} ms")
        else:
            log(f"{phase} device time: not measured, the profiler kept no "
                f"device record")
        with Recorder(ops, ("flash_attention",), stop_after=1) as rec:
            T.prefill(params, toks, cfg)
        call = rec.calls["flash_attention"][0]
        q, k, v = call[0][:3]
        scale = arg(call, 4, "scale")
        del params, rec, call, res
        free()
        sub = flash_at_shape(q, k, v, scale, phase)
        sub.update(launches=phases[phase]["flash_attention"],
                   prefill_s=pre_s, prefill_peak_gb=pre_peak, **served,
                   prefill_device_ms=prof["device_ms"] or None,
                   gate=gate, layers=cfg.n_layers,
                   full_layers=full.n_layers)
        shapes["flash_attention"][phase] = sub
        log(f"kernel flash_attention at the {phase} shape: {sub}")
        del q, k, v
        free()

    # -- the MoE models in float32: the top-k routing and the CUDA-core
    #    kernel at their shapes --------------------------------------------
    for phase, module, layers in LM_SUITE_F32:
        full = importlib.import_module(f"repro_torch.configs.{module}").CONFIG
        cfg32 = gate_config(dataclasses.replace(full, n_layers=layers,
                                                dtype="float32"))
        params32 = T.init_params(
            cfg32, torch.Generator(device=dev).manual_seed(args.seed), dev)
        log(f"{phase}: {describe(cfg32, full.n_layers)}, the gate's "
            f"capacity factor")
        prompts = rng.integers(0, cfg32.vocab, (SERVE_BATCH, SERVE_PROMPT))
        with Recorder(ops, ("flash_attention",)) as rec32, \
                DropCounter() as drops32:
            res32 = counted(phase, ("flash_attention_simt",),
                            lambda: serve_lm(cfg32, params32, prompts,
                                             gen_len=0, device=dev))
        expect(phase, cfg32.n_layers, "flash_attention_simt")
        if drops32.dropped:
            raise AssertionError(f"{phase}: the gate's capacity dropped "
                                 f"{drops32.dropped} assignments")
        flips, pairs = drops32.flips(SERVE_BATCH, SERVE_PROMPT,
                                     cfg32.n_layers)
        gate32 = check_prefill_against_decode(res32, GATE_REL_TOL["float32"])
        log(f"{phase}: prefill of {SERVE_BATCH} x {SERVE_PROMPT} "
            f"{res32.prefill_s:.4f} s, prompt stepping {res32.prompt_s:.3f} "
            f"s; (token, layer) pairs whose top-{cfg32.top_k} experts differ "
            f"between the two paths {flips} of {pairs}; gate: {gate32}")
        call = rec32.calls["flash_attention"][0]
        q32, k32, v32 = call[0][:3]
        scale = arg(call, 4, "scale")
        del params32, rec32, call, res32
        free()
        kern32 = ops.flash_attention(q32, k32, v32, causal=True, scale=scale)
        plain32 = ref.flash_attention_ref(q32, k32, v32, causal=True,
                                          scale=scale)
        err32 = (kern32 - plain32).abs()
        if not bool((err32 <= error_bound(kern32, plain32, v32)).all()):
            raise AssertionError(f"flash_attention_simt at the {phase} shape "
                                 f"disagrees with its plain version beyond "
                                 f"float32 reordering: max err "
                                 f"{float(err32.max())}")
        bms, bkind = flash_bound(q32, k32, v32, F32_OPS_PER_S)
        times = kernel_times(lambda: ops.flash_attention(q32, k32, v32,
                                                         scale=scale),
                             sdpa_call(q32, k32, v32, scale))
        sub = dict(**times, bound_ms=bms, bound_by=bkind,
                   share_of_bound=bms / times["ms"],
                   plain_ms=cuda_time_ms(lambda: ref.flash_attention_ref(
                       q32, k32, v32, causal=True, scale=scale)),
                   max_abs_err=float(err32.max()),
                   launches=phases[phase]["flash_attention_simt"],
                   sdpa_backends=sdpa_backends(q32, k32, v32, scale),
                   gate=gate32, routing_flips=[flips, pairs],
                   layers=cfg32.n_layers, full_layers=full.n_layers,
                   shape=f"q {tuple(q32.shape)} k {tuple(k32.shape)} v "
                         f"{tuple(v32.shape)} float32 causal (layer 0 of "
                         f"the float32 gate's prefill of {SERVE_BATCH} x "
                         f"{SERVE_PROMPT})")
        shapes["flash_attention_simt"][phase] = sub
        log(f"kernel flash_attention_simt at the {phase} shape: {sub}")
        del q32, k32, v32, kern32, plain32, err32
        free()
    return shapes


def written_gb():
    """GB this process has handed to ``write`` calls (``wchar`` of
    ``/proc/self/io``: files, pipes and the log alike; the launchers run
    as subprocesses of their own), or None where that is unreadable.  A
    run on the H100 host may write 45 GiB to its disk in all."""
    try:
        with open("/proc/self/io") as f:
            for line in f:
                if line.startswith("wchar:"):
                    return int(line.split()[1]) / 1e9
    except (OSError, ValueError):
        pass
    return None


def grad_check(q, k, v, scale, tag, seed):
    """``ops.FlashAttention`` (the kernel's forward, the chunked plain
    backward) against autograd through ``ref.flash_attention_ref`` on
    the same inputs and output gradient, causal, per element.

    The two backwards differ in three ways, each bounded from this run's
    tensors: (1) each rounds its gradients once to the inputs' type (bf16:
    one ulp at max(|got|, |want|) covers both roundings); (2) float32
    sums in another order (2^-12 x max |want| of the tensor); (3) the
    Function's delta_i = rowsum(dO_i o O_i) reads the kernel's output,
    the plain one the float32 output: with e_i = |rowsum(dO_i o (O_kernel
    - O_f32))|, dS moves by P e_i, so |d dQ_i| <= scale e_i (P |K|)_i and
    |d dK_j| <= scale (P^T (e |Q|))_j (query heads folded onto their KV
    head); dV does not read O.  The tensor-core kernel's O carries its bf16
    P and its bf16 output rounding, so (3) is what that rounding costs the
    gradient."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=q.device).manual_seed(seed)
    b, h, s, d = q.shape
    hk, g = k.shape[1], h // k.shape[1]
    do = torch.randn((b, h, s, v.shape[-1]), generator=gen,
                     device=q.device).to(q.dtype)
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    o = ops.flash_attention(*leaves, causal=True, scale=scale)
    o.backward(do)
    got = [x.grad for x in leaves]
    plain = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    ref.flash_attention_ref(*plain, causal=True, scale=scale).backward(do)
    want = [x.grad for x in plain]
    sc = d ** -0.5 if scale is None else scale
    with torch.no_grad():
        qf, kf, vf = q.float(), k.float(), v.float()
        o32 = ref.flash_attention_ref(qf, kf, vf, causal=True, scale=scale)
        e = (do.float() * (o.detach().float() - o32)).sum(-1).abs()
        kx = kf.repeat_interleave(g, 1)
        logits = torch.einsum("bhsd,bhtd->bhst", qf, kx).mul_(sc)
        logits.masked_fill_(torch.ones(s, s, dtype=torch.bool,
                                       device=q.device).triu_(1),
                            float("-inf"))
        p = torch.softmax(logits, dim=-1)
        del logits
        moved = [sc * e[..., None] * (p @ kx.abs()),
                 sc * torch.einsum("bhst,bhsd->bhtd", p,
                                   e[..., None] * qf.abs())
                 .reshape(b, hk, g, s, d).sum(2),
                 torch.zeros_like(vf)]
        del p, kx
    out = {"shape": f"q {tuple(q.shape)} k {tuple(k.shape)} v "
                    f"{tuple(v.shape)} {str(q.dtype)[6:]} causal",
           "delta_term_max": float(e.max())}
    ok = True
    for name, gt, wt, mv in zip(("dq", "dk", "dv"), got, want, moved):
        gt, wt = gt.float(), wt.float()
        mag = torch.maximum(gt.abs(), wt.abs())
        ulp = (torch.exp2(torch.floor(torch.log2(mag.clamp_min(2.0 ** -126)))
                          - 7) if q.dtype == torch.bfloat16
               else torch.zeros_like(mag))
        bound = ulp + 2.0 ** -12 * float(wt.abs().max()) + mv
        err = (gt - wt).abs()
        ratio = float((err / bound).max())
        out[name] = dict(max_abs_err=float(err.max()),
                         max_abs=float(wt.abs().max()),
                         rel_to_max=float(err.max() / wt.abs().max()),
                         worst_err_over_bound=ratio,
                         delta_share_of_bound=float((mv / bound).max()))
        ok = ok and ratio <= 1.0
    log(f"train_grad {tag}: {out}")
    if not ok:
        raise AssertionError(f"train_grad {tag}: the Function's gradients "
                             f"leave their bound: {out}")
    return out


def train_profile(step_fn):
    """One training step under ``torch.profiler``: device ms by kind
    (the flash forward kernels, matrix products, the rest), operations,
    wall ms of the same step unprofiled is the caller's."""
    from repro_torch.bench.device_time import Window
    with Window("train_profile") as win:
        step_fn()
    dev = [e for e in win.events
           if e.device_type == torch.autograd.DeviceType.CUDA]

    def kind(key):
        k = key.lower()
        if "flash_attention" in k:
            return "flash_forward"
        if any(w in k for w in ("gemm", "xmma", "cutlass", "cublas",
                                "nvjet", "matmul")):
            return "matrix_products"
        return "other"
    by = {}
    for e in dev:
        by[kind(e.key)] = by.get(kind(e.key), 0.0) + e.self_device_time_total
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:8]
    return dict(device_ms=sum(by.values()) / 1e3,
                device_ops=sum(e.count for e in dev),
                by_kind_ms={k: v / 1e3 for k, v in by.items()},
                top=[(e.key[:60], round(e.self_device_time_total / 1e3, 3),
                      e.count) for e in top])


def train_paths(args, counted, phases, smi) -> dict:
    """Step 9 (phases ``train``, ``train_resume``, ``train_learn``,
    ``train_grad``, ``train_deepseek``); returns the flash kernels'
    training sub-entries, {kernel: {phase: sub-entry}}."""
    import shutil
    from repro_torch.configs import granite_3_2b
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import steps, train
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import AdamW, tree_leaves

    dev = torch.device("cuda")
    cfg = granite_3_2b.CONFIG
    n_params = cfg.param_count()
    out = {"flash_attention": {}, "flash_attention_simt": {}}

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def expect(phase, n, kernel="flash_attention"):
        other = ({"flash_attention", "flash_attention_simt"}
                 - {kernel}).pop()
        got = phases[phase][kernel]
        if got != n or phases[phase][other]:
            raise AssertionError(f"phase {phase}: {got} {kernel} launches "
                                 f"and {phases[phase][other]} {other}, "
                                 f"expected {n} and 0 (a forward and a "
                                 f"remat recompute a layer a step)")

    def report(phase, history, tokens, peak, n):
        for r in history:
            flops_share = 6 * n * tokens / r["seconds"] / BF16_TC_OPS_PER_S
            r.update(tokens_per_s=tokens / r["seconds"],
                     model_flops_share=flops_share)
            log(f"{phase} step {r['step']}: loss {r['loss']:.6f} ce "
                f"{r['ce']:.6f} aux {r['aux']:.6f} grad_norm "
                f"{r['grad_norm']:.6f} lr {r['lr']:.3e}; {r['seconds']:.3f} "
                f"s, {r['tokens_per_s']:.1f} tokens/s, model FLOPs share "
                f"{flops_share:.4f} (6 N tokens / s / 989 TFLOP/s) [{smi}]")
            if not (np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])):
                raise AssertionError(f"{phase} step {r['step']}: loss or "
                                     f"grad norm not finite: {r}")
        log(f"{phase}: peak memory {peak:.2f} GB (max_memory_allocated)")

    # -- train: the launcher at full width and depth -------------------
    seq = granite_3_2b.ARCH.shapes["train_4k"].meta["seq"]
    tokens = TRAIN_BATCH * seq
    log(f"train: {cfg.name} at full width and depth ({n_params} parameters, "
        f"bf16, float32 master, m and v), train_4k at seq {seq}, batch CUT "
        f"from 256 to {TRAIN_BATCH}, {TRAIN_STEPS} steps")
    argv = ["--arch", cfg.name, "--shape", "train_4k", "--batch",
            str(TRAIN_BATCH)]
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    run = counted("train", ("flash_attention",), lambda: train.main(
        argv + ["--steps", str(TRAIN_STEPS)]))
    wall = time.perf_counter() - t
    expect("train", 2 * cfg.n_layers * TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated() / 1e9
    report("train", run.history, tokens, peak, n_params)
    from repro_torch.launch import analytic
    steady = float(np.mean([r["seconds"] for r in run.history[1:]]))
    measured("granite-3-2b", "train_4k", f"train {TRAIN_BATCH} x {seq}",
             analytic.lm_model_flops(cfg, "train", TRAIN_BATCH, seq), steady)
    MEASURED[-1]["six_n_share"] = (6 * n_params * tokens / steady
                                   / BF16_TC_OPS_PER_S)
    log(f"train: {TRAIN_STEPS} steps in {wall:.1f} s with the set-up "
        f"({sum(r['seconds'] for r in run.history):.1f} s in the steps)")
    # one more step, profiled (outside the counted phases)
    batch = train.synthetic_batch(
        train.cut_batch(granite_3_2b.ARCH, "train_4k", TRAIN_BATCH),
        "train_4k", False, TRAIN_STEPS, dev)
    step_fn = steps.make_step(granite_3_2b.ARCH, "train_4k", "train")
    state = {"params": run.params, "opt": run.opt_state}
    history = run.history
    del run

    def one_step():
        state["params"], state["opt"], _ = step_fn(state["params"],
                                                   state["opt"], batch)
    torch.cuda.synchronize()
    t = time.perf_counter()
    one_step()
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t
    prof = train_profile(one_step)
    log(f"train profile of one step (wall {step_s:.3f} s unprofiled): "
        f"device {prof['device_ms']:.1f} ms in {prof['device_ops']} "
        f"operations, busy {prof['device_ms'] / (step_s * 1e3):.3f}; by "
        f"kind {prof['by_kind_ms']}; top {prof['top']}")
    # the kernel at the training shape: layer 0's own q, k, v
    with Recorder(ops, ("flash_attention",), stop_after=1) as rec, \
            torch.no_grad():
        T.forward(state["params"], batch["tokens"], cfg)
    q, k, v = rec.calls["flash_attention"][0][0][:3]
    q, k, v = q.detach(), k.detach(), v.detach()
    del state, step_fn, batch, rec
    free()
    check = tc_check(q[:1], k[:1], v[:1], "train, sequence 0")
    times = kernel_times(lambda: ops.flash_attention(q, k, v),
                         sdpa_call(q, k, v))
    bms, bkind = flash_bound(q, k, v)
    shape_entry = dict(
        **times, bound_ms=bms, bound_by=bkind,
        share_of_bound=bms / times["ms"],
        plain_ms=cuda_time_ms(lambda: ref.flash_attention_ref(
            q, k, v, causal=True), min_iters=2),
        check=check, max_abs_err=check["plain"]["max_abs_err"],
        shape=f"q {tuple(q.shape)} k/v {tuple(k.shape)} bf16 causal "
              f"(layer 0 of a training step's forward; checked on "
              f"sequence 0)")
    log(f"kernel flash_attention at the training shape: {shape_entry}")
    del q, k, v
    free()

    # -- train_ckpt, train_resume: checkpoint and resume at full width,
    #    depth cut (a full-depth checkpoint does not fit the disk's room)
    ckpt = Path("build") / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    ckpt.mkdir(parents=True)
    rcfg = dataclasses.replace(cfg, n_layers=RESUME_LAYERS)
    r_params = rcfg.param_count()
    log(f"train_resume: {cfg.name} at full width, DEPTH CUT from 40 to "
        f"{RESUME_LAYERS} layers ({r_params} parameters, a checkpoint "
        f"{14 * r_params / 1e9:.2f} GB; at full depth "
        f"{14 * n_params / 1e9:.1f} GB, past what one run may write to "
        f"the machine's disk with the other phases), {TRAIN_BATCH} x {seq}")
    rargv = argv + ["--layers", str(RESUME_LAYERS)]
    torch.cuda.reset_peak_memory_stats()
    base = counted("train_resume_ref", ("flash_attention",),
                   lambda: train.main(rargv + ["--steps", str(RESUME_STEPS)]))
    expect("train_resume_ref", 2 * RESUME_LAYERS * RESUME_STEPS)
    report("train_resume_ref", base.history, tokens,
           torch.cuda.max_memory_allocated() / 1e9, r_params)
    uninterrupted = {r["step"]: r for r in base.history}
    lrs = [r["lr"] for r in base.history]
    first = {k: v.detach().cpu() for k, v in T.flatten(base.params).items()}
    del base
    free()
    ck_args = ["--ckpt-dir", str(ckpt), "--ckpt-every", str(RESUME_FROM)]
    t = time.perf_counter()
    counted("train_ckpt", ("flash_attention",), lambda: train.main(
        rargv + ck_args + ["--steps", str(RESUME_FROM)]))
    save_s = time.perf_counter() - t
    expect("train_ckpt", 2 * RESUME_LAYERS * RESUME_FROM)
    t = time.perf_counter()
    resumed = counted("train_resume", ("flash_attention",),
                      lambda: train.main(rargv + ck_args
                                         + ["--steps", str(RESUME_STEPS)]))
    resume_s = time.perf_counter() - t
    expect("train_resume", 2 * RESUME_LAYERS * (RESUME_STEPS - RESUME_FROM))
    if resumed.start != RESUME_FROM:
        raise AssertionError(f"train_resume started at {resumed.start}")
    report("train_resume", resumed.history, tokens,
           torch.cuda.max_memory_allocated() / 1e9, r_params)
    gaps = [abs(r["loss"] - uninterrupted[r["step"]]["loss"])
            / abs(uninterrupted[r["step"]]["loss"]) for r in resumed.history]
    # parameters: Adam moves a parameter by at most lr_t (1 + wd |p|) a
    # step, so a sign flip of a near-zero gradient between the runs moves
    # it by up to 2 sum lr_t over the steps, plus a bf16 ulp
    atol = 2 * sum(lrs) * 1.01
    worst = 0.0
    for path, t1 in T.flatten(resumed.params).items():
        a, b = t1.detach().float().cpu(), first[path].float()
        ulp = torch.exp2(torch.floor(torch.log2(
            torch.maximum(a.abs(), b.abs()).clamp_min(2.0 ** -126))) - 7)
        worst = max(worst, float(((a - b).abs() / (atol + ulp)).max()))
    log(f"train_resume: {RESUME_FROM} steps and a checkpoint in {save_s:.1f}"
        f" s; resumed from step {resumed.start} to {RESUME_STEPS} in "
        f"{resume_s:.1f} s (restore, steps, a checkpoint); loss relative "
        f"gaps to the uninterrupted run at steps "
        f"{[r['step'] for r in resumed.history]}: {gaps} (gate "
        f"{TRAIN_RESUME_LOSS_RTOL}); parameters at step {RESUME_STEPS}: "
        f"worst |diff| / (2 sum lr_t + ulp) = {worst:.4f}")
    if max(gaps) > TRAIN_RESUME_LOSS_RTOL or worst > 1.0:
        raise AssertionError("train_resume: the resumed run leaves the "
                             "uninterrupted one")
    train_entry = dict(
        steps=history, peak_gb=peak, profile=prof,
        step_s_profiled_step=step_s, resumed_steps=resumed.history,
        resume_loss_gaps=gaps, resume_param_worst=worst,
        checkpoint_s=save_s, resume_s=resume_s, train_shape=shape_entry,
        launches=phases["train"]["flash_attention"],
        batch=f"{TRAIN_BATCH} x {seq} (train_4k's 256 CUT to "
              f"{TRAIN_BATCH})")
    del resumed, first
    free()
    shutil.rmtree(ckpt, ignore_errors=True)

    # -- train_learn: 2 layers at full width learn one batch ------------
    cfg2 = dataclasses.replace(cfg, n_layers=LEARN_LAYERS)
    arch2 = dataclasses.replace(granite_3_2b.ARCH, config=cfg2)
    params = T.init_params(cfg2, torch.Generator(device=dev).manual_seed(
        args.seed), dev)
    opt = AdamW(lr=3e-3, warmup_steps=1)
    state = opt.init(params)
    step_fn = steps.make_step(arch2, "train_4k", "train", optimizer=opt)
    toks = torch.as_tensor(np.random.default_rng(args.seed + 7).integers(
        0, cfg.vocab, (LEARN_BATCH, LEARN_LEN)), dtype=torch.int32,
        device=dev)

    def learn():
        nonlocal params, state
        losses = []
        for _ in range(LEARN_STEPS):
            params, state, m = step_fn(params, state, {"tokens": toks,
                                                        "labels": toks})
            losses.append(float(m["loss"]))
        return losses
    losses = counted("train_learn", ("flash_attention",), learn)
    expect("train_learn", 2 * LEARN_LAYERS * LEARN_STEPS)
    log(f"train_learn: {cfg.name} at full width cut to {LEARN_LAYERS} "
        f"layers, {LEARN_STEPS} steps at lr 3e-3, warm-up 1, on one "
        f"{LEARN_BATCH} x {LEARN_LEN} batch (labels = tokens): losses "
        f"{losses}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0] - 0.1):
        raise AssertionError(f"train_learn: the loss did not fall by 0.1: "
                             f"{losses}")
    del params, state, step_fn
    free()

    # -- train_grad: the Function against autograd through the plain
    #    version, at the models' layer shapes, and a whole model ---------
    gen = torch.Generator(device=dev).manual_seed(args.seed + 11)
    checks = {}
    for i, (tag, (b, h, hk, s, d, dv), dt, scale) in enumerate(
            TRAIN_GRAD_CASES):
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dt)
                   for shape in ((b, h, s, d), (b, hk, s, d), (b, hk, s, dv)))
        checks[tag] = grad_check(q, k, v, scale, f"{tag} {str(dt)[6:]}",
                                 args.seed + i)
        del q, k, v
        free()
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    params = T.init_params(cfg32, torch.Generator(device=dev).manual_seed(
        args.seed), dev)
    toks = torch.as_tensor(np.random.default_rng(args.seed + 13).integers(
        0, cfg.vocab, (2, 2, 512)), dtype=torch.int32, device=dev)
    batch = {"tokens": toks[0], "labels": toks[1]}

    def model_grads():
        for p in tree_leaves(params):
            p.requires_grad_(True)
            p.grad = None
        loss, _ = T.loss_fn(params, batch, cfg32)
        loss.backward()
        return float(loss.detach()), {k: v.grad.detach().clone()
                             for k, v in T.flatten(params).items()}
    kernel_loss, kernel_grads = counted("train_grad",
                                        ("flash_attention_simt",),
                                        model_grads)
    expect("train_grad", 2 * cfg32.n_layers, "flash_attention_simt")
    saved = ops.flash_attention
    ops.flash_attention = ref.flash_attention_ref     # all plain
    try:
        plain_loss, plain_grads = model_grads()
    finally:
        ops.flash_attention = saved
    model_worst = 0.0
    for path, gk in kernel_grads.items():
        gp = plain_grads[path]
        model_worst = max(model_worst, float((gk - gp).abs().max())
                          / (1e-4 * float(gp.abs().max())))
    log(f"train_grad model: {cfg.name} full width at 2 layers in float32, "
        f"2 x 512 tokens: loss {kernel_loss} (kernel path) against "
        f"{plain_loss} (plain); every gradient leaf within 1e-4 x its max "
        f"|plain|: worst {model_worst:.4f} of that")
    if model_worst > 1.0 or abs(kernel_loss - plain_loss) > 1e-5 * abs(
            plain_loss):
        raise AssertionError("train_grad: the kernel path's model gradient "
                             "leaves the plain one")
    del params, kernel_grads, plain_grads
    free()

    # -- train_deepseek: MLA 192/128 and the MoE under backward ---------
    from repro_torch.configs import deepseek_v2_lite_16b
    dcfg = dataclasses.replace(deepseek_v2_lite_16b.CONFIG,
                               n_layers=DEEPSEEK_LAYERS)
    darch = dataclasses.replace(deepseek_v2_lite_16b.ARCH, config=dcfg)
    params = T.init_params(dcfg, torch.Generator(device=dev).manual_seed(
        args.seed), dev)
    opt = steps.make_optimizer("lm")
    state = opt.init(params)
    step_fn = steps.make_step(darch, "train_4k", "train")
    rng = np.random.default_rng(args.seed + 17)
    torch.cuda.reset_peak_memory_stats()

    def deepseek():
        nonlocal params, state
        hist = []
        for i in range(DEEPSEEK_STEPS):
            toks = torch.as_tensor(rng.integers(
                0, dcfg.vocab, (2, DEEPSEEK_BATCH, DEEPSEEK_LEN)),
                dtype=torch.int32, device=dev)
            t0 = time.perf_counter()
            with DropCounter() as routes:
                params, state, m = step_fn(params, state,
                                           {"tokens": toks[0],
                                            "labels": toks[1]})
            rec = {"step": i, "seconds": time.perf_counter() - t0,
                   **{k: float(v) for k, v in m.items()}}
            # remat: the layers' forward, then their recompute in reverse
            n = dcfg.n_layers
            first, again = routes.experts[:n], routes.experts[n:][::-1]
            rec["remat_routes_equal"] = len(again) == n and all(
                torch.equal(a, b) for a, b in zip(first, again))
            hist.append(rec)
        return hist
    dhist = counted("train_deepseek", ("flash_attention",), deepseek)
    expect("train_deepseek", 2 * DEEPSEEK_LAYERS * DEEPSEEK_STEPS)
    dpeak = torch.cuda.max_memory_allocated() / 1e9
    log(f"train_deepseek: {dcfg.name} at full width (MLA 192/128, "
        f"{dcfg.n_experts} experts top-{dcfg.top_k} + {dcfg.n_shared} "
        f"shared), DEPTH CUT from 27 to {DEEPSEEK_LAYERS} layers, "
        f"{dcfg.param_count()} parameters, {DEEPSEEK_STEPS} steps at "
        f"{DEEPSEEK_BATCH} x {DEEPSEEK_LEN}: {dhist}; peak {dpeak:.2f} GB")
    if not all(np.isfinite(r["loss"]) and r["remat_routes_equal"]
               for r in dhist):
        raise AssertionError(f"train_deepseek: a loss is not finite or a "
                             f"remat recompute routed otherwise: {dhist}")
    del params, state, step_fn
    free()
    out["flash_attention"]["train"] = dict(
        **train_entry, grad_check_granite=checks["granite"],
        grad_check_deepseek=checks["deepseek"],
        learn_losses=losses, deepseek_steps=dhist, deepseek_peak_gb=dpeak,
        launches_learn=phases["train_learn"]["flash_attention"],
        launches_deepseek=phases["train_deepseek"]["flash_attention"])
    out["flash_attention_simt"]["train"] = dict(
        grad_check=checks["float32"], model_grad_worst=model_worst,
        launches=phases["train_grad"]["flash_attention_simt"])
    return out


def _to(tree, dev):
    """A copy of a parameter tree (or batch dict) on ``dev``."""
    from repro_torch.train.optimizer import tree_map
    return tree_map(lambda t: t.detach().to(dev, copy=True), tree)


def _n_bytes(tree) -> int:
    from repro_torch.train.optimizer import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def saved_bytes(loss_fn, params, batch) -> int:
    """Bytes of the autograd residuals one forward of ``loss_fn`` keeps
    for its backward: every saved tensor's storage once, the parameters'
    own left out (counted by ``saved_tensors_hooks``)."""
    from repro_torch.train.optimizer import tree_leaves
    leaves = tree_leaves(params)
    own = {p.untyped_storage().data_ptr() for p in leaves}
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in own:
            seen[st.data_ptr()] = st.nbytes()
        # a detached alias: the tensor itself would hold its own grad_fn
        # from inside the graph, a cycle no collector sees, which keeps
        # the graph and every parameter alive
        return t.detach()
    for p in leaves:
        p.requires_grad_(True)
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _ = loss_fn(params, batch)
        del loss
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return sum(seen.values())


def rel_err(got, want) -> float:
    """max |got - want| / max |want| (on the CPU, in float64)."""
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def recsys_batch(name, cfg, n, seed, dev, labels=True):
    """``data.recsys_data``'s batch of ``n`` samples for arch ``name``
    (zipf ids) as tensors on ``dev``."""
    from repro_torch.data import recsys_data
    if name == "dlrm-rm2":
        b = recsys_data.dlrm_batch(n, cfg.n_dense, cfg.n_sparse, cfg.vocab,
                                   seed=seed)
    else:
        b = recsys_data.seq_batch(n, cfg.seq_len, cfg.vocab,
                                  getattr(cfg, "n_profile", 8), seed=seed)
        if name != "bst":
            del b["profile"]
    if not labels:
        del b["labels"]
    return {k: torch.as_tensor(v, device=dev) for k, v in b.items()}


def recsys_retrieval_batch(name, cfg, n_cand, seed, dev):
    from repro_torch.data import recsys_data
    r = recsys_data.retrieval_batch(n_cand, getattr(cfg, "seq_len", 1),
                                    cfg.vocab, seed=seed)
    keep = (("dense", "sparse", "cand_ids") if name == "dlrm-rm2"
            else ("history", "cand_ids"))
    return {k: torch.as_tensor(r[k], device=dev) for k in keep}


def finite(t, shape, what):
    if tuple(t.shape) != tuple(shape) or not bool(torch.isfinite(t).all()):
        raise AssertionError(f"{what}: shape {tuple(t.shape)} (expected "
                             f"{tuple(shape)}) or a value not finite")


def recsys_check(name, args, dev) -> dict:
    """Card against CPU at full widths, the vocabulary CUT to
    RECSYS_CHECK_VOCAB rows: serve scores, and the losses of two train
    steps from the same parameters on the same batch."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import steps
    arch = get_arch(name)
    small = dataclasses.replace(arch.config, vocab=RECSYS_CHECK_VOCAB)
    arch = dataclasses.replace(arch, config=small)
    params = steps.init_fn(arch, "train_batch", device=dev)(
        torch.Generator(device=dev).manual_seed(args.seed))
    host = _to(params, "cpu")
    batch = recsys_batch(name, small, RECSYS_CHECK_BATCH, args.seed + 1, dev)
    hbatch = _to(batch, "cpu")
    serve = steps.make_step(arch, "serve_p99", "serve")
    feats = {k: v for k, v in batch.items() if k != "labels"}
    serve_err = rel_err(serve(params, feats),
                        serve(host, {k: v for k, v in hbatch.items()
                                     if k != "labels"}))

    def two_steps(p, b):
        opt = steps.make_optimizer("recsys")
        state = opt.init(p)
        step = steps.make_step(arch, "train_batch", "train")
        losses = []
        for _ in range(2):
            p, state, m = step(p, state, b)
            losses.append(float(m["loss"]))
        return losses
    card, cpu = two_steps(params, batch), two_steps(host, hbatch)
    gaps = [abs(a - b) / abs(b) for a, b in zip(card, cpu)]
    log(f"{name}_check: full widths, vocabulary CUT to {RECSYS_CHECK_VOCAB}"
        f" rows, {RECSYS_CHECK_BATCH} samples: serve scores card against "
        f"CPU max |diff| / max |CPU| {serve_err:.3e}; train losses card "
        f"{card} CPU {cpu}, relative gaps {gaps} (gate {FAMILY_RTOL})")
    if serve_err > FAMILY_RTOL or max(gaps) > FAMILY_RTOL:
        raise AssertionError(f"{name}_check: the card leaves the CPU")
    return dict(serve_rel_err=serve_err, loss_rel_gaps=gaps)


def recsys_full(name, args, dev, smi) -> dict:
    """One recsys config at its published widths and vocabulary: serve at
    serve_p99 and serve_bulk, retrieval at retrieval_cand, then
    RECSYS_TRAIN_STEPS train steps at train_batch (CUT where the
    reckoning passes MEMORY_BUDGET_GB)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import steps, train
    arch = get_arch(name)
    cfg = arch.config
    params = steps.init_fn(arch, "train_batch", device=dev)(
        torch.Generator(device=dev).manual_seed(args.seed))
    p_bytes = _n_bytes(params)
    out = dict(param_gb=p_bytes / 1e9, params=p_bytes // 4)
    for shape in ("serve_p99", "serve_bulk"):
        b = arch.shapes[shape].meta["batch"]
        feats = recsys_batch(name, cfg, b, args.seed + 2, dev, labels=False)
        fn = steps.make_step(arch, shape, "serve")
        finite(fn(params, feats), (b,), f"{name} {shape}")
        ms = cuda_time_ms(lambda: fn(params, feats))
        out[shape] = dict(batch=b, ms=ms, samples_per_s=b / ms * 1e3)
        del feats
    meta = arch.shapes["retrieval_cand"].meta
    rb = recsys_retrieval_batch(name, cfg, meta["n_candidates"],
                                args.seed + 3, dev)
    fn = steps.make_step(arch, "retrieval_cand", "retrieval")
    finite(fn(params, rb), (meta["n_candidates"],), f"{name} retrieval")
    out["retrieval_cand"] = dict(n_candidates=meta["n_candidates"],
                                 ms=cuda_time_ms(lambda: fn(params, rb)))
    del rb
    # the train cell: reckon, cut, run
    full = arch.shapes["train_batch"].meta["batch"]
    per_sample = saved_bytes(
        steps._loss_for(arch, "train_batch", False), params,
        recsys_batch(name, cfg, RECKON_BATCH, args.seed + 4, dev)
    ) / RECKON_BATCH
    static = 5 * p_bytes
    b = full
    while static + per_sample * b > MEMORY_BUDGET_GB * 1e9 and b > 1:
        b //= 2
    reckon = (f"reckoned peak {(static + per_sample * full) / 1e9:.2f} GB at "
              f"{full} samples: 5 x {p_bytes / 1e9:.3f} GB of parameters, "
              f"gradients, m, v and master, plus {per_sample / 1e3:.1f} KB "
              f"of autograd residuals a sample (counted on {RECKON_BATCH})")
    if b < full:
        arch = train.cut_batch(arch, "train_batch", b)
        log(f"{name} train_batch: batch CUT from {full} to {b} samples: "
            f"{reckon}, past the {MEMORY_BUDGET_GB} GB budget; at {b}: "
            f"{(static + per_sample * b) / 1e9:.2f} GB")
    else:
        log(f"{name} train_batch: {reckon}, under {MEMORY_BUDGET_GB} GB: "
            f"no cut")
    opt = steps.make_optimizer("recsys")
    state = opt.init(params)
    step = steps.make_step(arch, "train_batch", "train")
    batches = [recsys_batch(name, cfg, b, args.seed + 10 + i, dev)
               for i in range(RECSYS_TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hist = []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        loss = float(m["loss"])
        s = time.perf_counter() - t0
        hist.append(dict(step=i, loss=loss, grad_norm=float(m["grad_norm"]),
                         seconds=s, samples_per_s=b / s))
        if not np.isfinite(loss):
            raise AssertionError(f"{name} train step {i}: loss {loss}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    steady = float(np.mean([r["seconds"] for r in hist[1:]]))
    out["train_batch"] = dict(
        batch=b, full_batch=full, steps=hist, peak_gb=peak,
        reckoned_gb=(static + per_sample * b) / 1e9,
        residual_kb_per_sample=per_sample / 1e3, s_per_step=steady,
        samples_per_s=b / steady,
        profile=profile_step(step, params, state, batches[0],
                             f"{name} train_batch", steady))
    p99, bulk = out["serve_p99"], out["serve_bulk"]
    log(f"recsys {name}: {p_bytes / 1e9:.3f} GB of parameters; serve_p99 "
        f"{p99['ms']:.4f} ms a batch of {p99['batch']} "
        f"({p99['samples_per_s']:.0f} samples/s); serve_bulk "
        f"{bulk['ms']:.3f} ms a batch of {bulk['batch']} "
        f"({bulk['samples_per_s']:.0f} samples/s); retrieval_cand "
        f"{out['retrieval_cand']['ms']:.4f} ms a call of "
        f"{meta['n_candidates']} candidates; train_batch at {b}: "
        f"{steady:.4f} s a step "
        f"(mean of steps 1-{RECSYS_TRAIN_STEPS - 1}; step 0 "
        f"{hist[0]['seconds']:.4f} s), {b / steady:.0f} samples/s, peak "
        f"{peak:.2f} GB (reckoned {out['train_batch']['reckoned_gb']:.2f}), "
        f"losses {[r['loss'] for r in hist]} [{smi}]")
    return out


def profile_step(step, params, state, batch, what, steady_s) -> dict:
    """One more train step under ``torch.profiler`` (``train_profile``):
    device ms and operations, busy share of the mean unprofiled step."""
    box = {"params": params, "state": state}

    def one():
        box["params"], box["state"], _ = step(box["params"], box["state"],
                                              batch)
    prof = train_profile(one)
    prof["busy"] = prof["device_ms"] / (steady_s * 1e3)
    log(f"{what}: profile of one step: device {prof['device_ms']:.2f} ms in "
        f"{prof['device_ops']} operations, busy {prof['busy']:.3f} of the "
        f"mean step; by kind {prof['by_kind_ms']}; top {prof['top']}")
    return prof


def learn_one_batch(step, params, state, batch, what) -> list:
    """FAMILY_LEARN_STEPS steps on one batch; the loss must fall by 1 %."""
    losses = []
    for _ in range(FAMILY_LEARN_STEPS):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    log(f"{what}: {FAMILY_LEARN_STEPS} steps at lr 1e-3, warm-up 1, on one "
        f"batch: losses {losses}")
    if not (all(np.isfinite(losses)) and losses[-1] < 0.99 * losses[0]):
        raise AssertionError(f"{what}: the loss did not fall: {losses}")
    return losses


def gnn_batch(cell, seed, dev, cut=1) -> dict:
    """A batch of NequIP cell ``cell`` from ``data.graph``: molecule_batch
    (128 graphs of 30 nodes and 64 edges), random_graph (full_graph_sm;
    ogb_products with nodes and edges divided by ``cut``), or the
    neighbourhood of 1,024 seeds sampled at fanout 15-10 from a random
    CSR graph (minibatch_lg; node features drawn on the card for the
    whole graph and gathered, so a node sampled twice keeps its
    features)."""
    from repro_torch.configs import nequip
    from repro_torch.data import graph
    meta = nequip.SHAPES[cell].meta
    if cell == "molecule":
        g = meta["n_graphs"]
        arrays = graph.molecule_batch(g, meta["n_nodes"] // g,
                                      meta["n_edges"] // g, meta["d_feat"],
                                      seed=seed)
    elif cell == "minibatch_lg":
        rng = np.random.default_rng(seed)
        n, e = MB_GRAPH_NODES, MB_GRAPH_NODES * MB_GRAPH_DEGREE
        csr = graph.CSRGraph.from_edges(
            rng.integers(0, n, e).astype(np.int32),
            rng.integers(0, n, e).astype(np.int32), n)
        seeds = rng.choice(n, MB_SEEDS, replace=False).astype(np.int32)
        sub = graph.sample_neighbors(csr, seeds, MB_FANOUTS, seed=seed)
        nodes = torch.as_tensor(sub["nodes"], device=dev).long()
        feats = torch.randn((n, meta["d_feat"]), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(seed))
        pos = torch.as_tensor(rng.normal(0, 3.0, (n, 3)), dtype=torch.float32,
                              device=dev)
        out = {"node_feat": feats[nodes], "positions": pos[nodes],
               "edge_src": torch.as_tensor(sub["edge_src"], device=dev),
               "edge_dst": torch.as_tensor(sub["edge_dst"], device=dev),
               "node_targets": torch.as_tensor(
                   rng.normal(0, 1, len(nodes)), dtype=torch.float32,
                   device=dev)}
        if (len(nodes), len(sub["edge_src"])) != (meta["n_nodes"],
                                                  meta["n_edges"]):
            raise AssertionError(f"minibatch_lg: {len(nodes)} nodes, "
                                 f"{len(sub['edge_src'])} edges")
        return out
    else:
        arrays = graph.random_graph(meta["n_nodes"] // cut,
                                    meta["n_edges"] // cut, meta["d_feat"],
                                    seed=seed)
    return {k: torch.as_tensor(v, device=dev) for k, v in arrays.items()}


def gnn_check(args, dev) -> dict:
    """The molecule cell on the card: against the CPU (energies and
    forces), and invariance under a rotation and a shift."""
    from repro_torch.configs import nequip
    from repro_torch.launch import steps
    from repro_torch.models import equivariant, nequip as NQ
    arch = nequip.ARCH
    cfg = arch.cell_config("molecule")
    n_graphs = arch.shapes["molecule"].meta["n_graphs"]
    params = steps.init_fn(arch, "molecule", device=dev)(
        torch.Generator(device=dev).manual_seed(args.seed))
    batch = gnn_batch("molecule", args.seed + 1, dev)
    host, hbatch = _to(params, "cpu"), _to(batch, "cpu")
    with torch.no_grad():
        e_card = NQ.forward(params, batch, cfg, n_graphs=n_graphs)
        e_cpu = NQ.forward(host, hbatch, cfg, n_graphs=n_graphs)
    f_card = NQ.forces(params, batch, cfg)
    f_cpu = NQ.forces(host, hbatch, cfg)
    rot = torch.as_tensor(equivariant.random_rotation(args.seed + 5),
                          dtype=torch.float32, device=dev)
    moved = dict(batch, positions=batch["positions"] @ rot.T + 3.0)
    with torch.no_grad():
        e_rot = NQ.forward(params, moved, cfg, n_graphs=n_graphs)
    f_rot = NQ.forces(params, moved, cfg)
    errs = dict(energy_cpu=rel_err(e_card, e_cpu),
                forces_cpu=rel_err(f_card, f_cpu),
                energy_rotated=rel_err(e_rot, e_card),
                forces_rotated=rel_err(f_rot, f_card @ rot.T))
    log(f"gnn_check: nequip molecule cell ({n_graphs} graphs, "
        f"{batch['positions'].shape[0]} nodes, {batch['edge_src'].shape[0]} "
        f"edges, float32): max |diff| / max |reference| of energies and "
        f"forces, card against CPU and rotated + shifted against rotated "
        f"by R: {errs} (gate {FAMILY_RTOL}); energies range "
        f"[{float(e_cpu.min()):.4f}, {float(e_cpu.max()):.4f}]")
    if max(errs.values()) > FAMILY_RTOL:
        raise AssertionError(f"gnn_check: {errs}")
    return errs


def gnn_train(cell, args, dev, smi, cut=1) -> dict:
    """GNN_TRAIN_STEPS train steps of NequIP on one batch of ``cell``."""
    from repro_torch.configs import nequip
    from repro_torch.launch import steps
    arch = nequip.ARCH
    batch = gnn_batch(cell, args.seed + 1, dev, cut)
    n, e = batch["positions"].shape[0], batch["edge_src"].shape[0]
    params = steps.init_fn(arch, cell, device=dev)(
        torch.Generator(device=dev).manual_seed(args.seed))
    opt = steps.make_optimizer("gnn")
    state = opt.init(params)
    step = steps.make_step(arch, cell, "train")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hist = []
    for i in range(GNN_TRAIN_STEPS):
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        loss = float(m["loss"])
        s = time.perf_counter() - t0
        hist.append(dict(step=i, loss=loss, seconds=s, edges_per_s=e / s))
        if not np.isfinite(loss):
            raise AssertionError(f"gnn {cell} step {i}: loss {loss}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    steady = float(np.mean([r["seconds"] for r in hist[1:]]))
    out = dict(nodes=n, edges=e, d_feat=arch.cell_config(cell).d_feat,
               cut=cut, steps=hist, s_per_step=steady,
               edges_per_s=e / steady, peak_gb=peak,
               profile=profile_step(step, params, state, batch,
                                    f"gnn {cell}", steady))
    log(f"gnn {cell}{f' CUT 1/{cut}' if cut > 1 else ''}: {n} nodes, {e} "
        f"edges, d_feat {out['d_feat']}: {steady:.4f} s a step (mean of "
        f"steps 1-{GNN_TRAIN_STEPS - 1}; step 0 {hist[0]['seconds']:.4f} "
        f"s), {e / steady:.0f} edges/s, peak {peak:.2f} GB, losses "
        f"{[r['loss'] for r in hist]} [{smi}]")
    return out


def family_paths(args, counted, phases, smi) -> dict:
    """Step 10 (phases ``recsys_*`` and ``gnn_*``): the recsys and GNN
    families at full width on the card; returns their numbers."""
    from repro_torch.configs import nequip
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import steps, train
    from repro_torch.train.optimizer import AdamW

    dev = torch.device("cuda")
    out = {"recsys": {}, "gnn": {}}

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    for name in RECSYS_ARCHS:
        short = name.split("-")[0]
        check = counted(f"recsys_{short}_check", (),
                        lambda: recsys_check(name, args, dev))
        free()
        full = counted(f"recsys_{short}", (),
                       lambda: recsys_full(name, args, dev, smi))
        out["recsys"][name] = dict(full, check=check)
        tb = full["train_batch"]
        from repro_torch.launch import analytic
        measured(name, "train_batch", f"train at {tb['batch']}",
                 analytic.recsys_model_flops(get_arch(name).config, "train",
                                             {"batch": tb["batch"]}),
                 tb["s_per_step"])
        free()

    # BST learns one batch; the launcher at full width
    arch = get_arch("bst")
    params = steps.init_fn(arch, "train_batch", device=dev)(
        torch.Generator(device=dev).manual_seed(args.seed))
    opt = AdamW(lr=1e-3, weight_decay=1e-4, warmup_steps=1)
    batch = recsys_batch("bst", arch.config, FAMILY_LEARN_BATCH,
                         args.seed + 6, dev)
    out["recsys"]["bst"]["learn_losses"] = counted(
        "recsys_bst_learn", (), lambda: learn_one_batch(
            steps.make_step(arch, "train_batch", "train", optimizer=opt),
            params, opt.init(params), batch,
            f"recsys_bst_learn: bst at full width, {FAMILY_LEARN_BATCH} "
            f"samples"))
    del params, batch
    free()
    t = time.perf_counter()
    run = counted("recsys_launcher", (), lambda: train.main(
        ["--arch", "bst", "--steps", "2"]))
    log(f"recsys_launcher: launch.train --arch bst --steps 2 at full width, "
        f"train_batch 65,536: {run.history} ({time.perf_counter() - t:.1f} "
        f"s with the set-up)")
    del run
    free()

    # NequIP
    out["gnn"]["check"] = counted("gnn_check", (),
                                  lambda: gnn_check(args, dev))
    free()
    arch = nequip.ARCH
    params = steps.init_fn(arch, "molecule", device=dev)(
        torch.Generator(device=dev).manual_seed(args.seed))
    opt = AdamW(lr=1e-3, weight_decay=1e-4, warmup_steps=1)
    batch = gnn_batch("molecule", args.seed + 7, dev)
    out["gnn"]["learn_losses"] = counted(
        "gnn_learn", (), lambda: learn_one_batch(
            steps.make_step(arch, "molecule", "train", optimizer=opt),
            params, opt.init(params), batch,
            "gnn_learn: nequip molecule cell"))
    del params, batch
    free()
    for cell in GNN_CELLS[:3]:
        out["gnn"][cell] = counted(f"gnn_{cell}", (),
                                   lambda: gnn_train(cell, args, dev, smi))
        free()
    from repro_torch.launch import analytic
    mb = out["gnn"]["minibatch_lg"]
    measured("nequip", "minibatch_lg", f"{mb['nodes']} nodes, {mb['edges']}"
             f" edges", analytic.gnn_model_flops(
                 arch.cell_config("minibatch_lg"),
                 {"n_nodes": mb["nodes"], "n_edges": mb["edges"]}),
             mb["s_per_step"])
    # ogb_products: reckoned from minibatch_lg's peak a sampled edge
    mb = out["gnn"]["minibatch_lg"]
    per_edge = mb["peak_gb"] * 1e9 / mb["edges"]
    meta = nequip.SHAPES["ogb_products"].meta
    cut = 1
    while per_edge * meta["n_edges"] / cut > MEMORY_BUDGET_GB * 1e9:
        cut *= 2
    gather = meta["n_edges"] * arch.config.channels * 5 * 4
    log(f"gnn ogb_products: {meta['n_nodes']} nodes, {meta['n_edges']} "
        f"edges; minibatch_lg's peak is {per_edge / 1e3:.2f} KB a sampled "
        f"edge ({mb['peak_gb']:.2f} GB over {mb['edges']} edges, "
        f"{arch.config.n_layers} layers, {arch.config.channels} channels, "
        f"l_max {arch.config.l_max}), so the full cell reckons at "
        f"{per_edge * meta['n_edges'] / 1e12:.2f} TB (one l = 2 gather of "
        f"the node features alone {gather / 1e9:.1f} GB), past one card "
        f"and four: nodes and edges CUT by {cut} (the smallest power of two"
        f" under {MEMORY_BUDGET_GB} GB: reckoned "
        f"{per_edge * meta['n_edges'] / cut / 1e9:.2f} GB)")
    res = counted("gnn_ogb_products", (),
                  lambda: gnn_train("ogb_products", args, dev, smi, cut))
    res["reckoned_gb"] = per_edge * meta["n_edges"] / cut / 1e9
    # minibatch_lg has a node an edge, ogb_products one for 25: its own
    # measured peak, doubled, bounds the next power of two from above
    larger = []
    while cut > 1 and 2 * res["peak_gb"] < MEMORY_BUDGET_GB:
        log(f"gnn ogb_products: peak {res['peak_gb']:.2f} GB at 1/{cut}, "
            f"twice that under {MEMORY_BUDGET_GB} GB: the cut halved to "
            f"1/{cut // 2}")
        larger.append(res)
        cut //= 2
        free()
        res = counted("gnn_ogb_products", (),
                      lambda: gnn_train("ogb_products", args, dev, smi, cut))
    res.update(full_reckoned_tb=per_edge * meta["n_edges"] / 1e12,
               larger_cuts=larger)
    out["gnn"]["ogb_products"] = res
    free()
    log(f"step 10 numbers: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# 11. attention with a query offset and a per-batch key bound
# ---------------------------------------------------------------------------

def offset_pairs(s, t, causal, off, kv_len):
    """Unmasked (query, key) pairs of one head summed over the batch: row
    i of batch b sees min(kv_len[b], i + off + 1) keys under causal (at
    least 0), kv_len[b] otherwise."""
    rows = np.arange(s)
    total = 0
    for n in kv_len:
        if causal:
            total += int(np.clip(rows + off + 1, 0, n).sum())
        else:
            total += int(n) * s
    return total


def offset_bound(q, k, v, causal, off, kv_len, ops_per_s):
    """(bound_ms, bound_by) of one launch at a query offset and key bound:
    2·(D + Dv) flops a pair the mask leaves, and q, k, v, o once."""
    b, h, s, d = q.shape
    t, dv = k.shape[2], v.shape[3]
    n_bytes = q.element_size() * (q.numel() + k.numel() + v.numel()
                                  + b * h * s * dv)
    return bound_ms(n_bytes, 2 * h * (d + dv)
                    * offset_pairs(s, t, causal, off, kv_len), ops_per_s)


def masked_sdpa(q, k, v, causal, off, kv, scale=None):
    """``scaled_dot_product_attention`` with the same mask as a boolean
    ``attn_mask`` (KV heads expanded outside the call): the library
    yardstick of an offset case.  A row that sees no key is NaN there."""
    from repro_torch.kernels import ref
    g = q.shape[1] // k.shape[1]
    ke, ve = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    hidden = ref.attention_hidden(q.shape[2], k.shape[2], causal, off, kv,
                                  device=q.device, batch=q.shape[0])
    mask = None if hidden is None else ~hidden
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q, ke, ve, attn_mask=mask, scale=scale)


def offset_case(tag, q, k, v, causal, off, kv, scale=None):
    """Both flash kernels on one offset case against the plain version
    (``error_bound``), the tensor-core kernel per element against
    ``ref.flash_attention_tc_ref`` too where the rule takes it; every row
    that sees no key exactly 0; device, call, plain and masked-SDPA ms
    and the bound of the kernel the rule picks.  Raises beyond a
    bound."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    plain = ref.flash_attention_ref(q, k, v, causal, scale, off, kv)
    hidden = ref.attention_hidden(q.shape[2], k.shape[2], causal, off, kv,
                                  device=q.device, batch=q.shape[0])
    empty = (torch.zeros((1, 1, q.shape[2]), dtype=torch.bool,
                         device=q.device) if hidden is None
             else hidden.all(-1)).expand(q.shape[0], q.shape[1], -1)
    tc = fa.takes_tensor_cores(q, k, v, scale)
    res = dict(shape=f"q {tuple(q.shape)} k {tuple(k.shape)} v "
                     f"{tuple(v.shape)} {str(q.dtype)[6:]} "
                     f"{'causal' if causal else 'full'} q_offset {off} "
                     f"kv_valid {None if kv is None else kv.tolist()}",
               rows_without_keys=int(empty[:, 0].sum()),
               kernel="flash_attention" if tc else "flash_attention_simt")
    emu = ref.flash_attention_tc_ref(q, k, v, causal, scale, off, kv) \
        if tc else None
    abs_out = (emu.abs_out if emu is not None
               else ref.flash_attention_ref(q.float(), k.float(),
                                            v.float().abs(), causal, scale,
                                            off, kv))
    worst = {}
    runs = (("ops.flash_attention", lambda: ops.flash_attention(
                q, k, v, causal, scale, off, kv)),
            ("flash_attention_simt", lambda: fa.flash_attention_simt(
                q, k, v, causal, scale, off, kv)))
    for name, fn in runs:
        got = fn()
        torch.cuda.synchronize()
        on_tc = name == "ops.flash_attention" and tc
        checks = [("plain", plain, fa.error_bound(
            got, plain, v, abs_out if on_tc else None))]
        if on_tc:
            checks.append(("emulation", emu.out, fa.error_bound(
                got, emu.out, v, emu.abs_out, emu.spread)))
        for against, want, bound in checks:
            err = (got.float() - want.float()).abs()
            ratio = float((err / bound).max())
            worst[f"{name} vs {against}"] = dict(
                max_abs_err=float(err.max()), worst_err_over_bound=ratio)
            if not ratio <= 1.0:
                raise AssertionError(
                    f"attn_offset {tag}: {name} disagrees with the "
                    f"{against} version beyond its bound: max err "
                    f"{float(err.max())}, worst err/bound {ratio}")
        if bool(got[empty].any()) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"attn_offset {tag}: {name} wrote a "
                                 f"non-zero or non-finite value in a row "
                                 f"that sees no key")
        del got
    kv_len = ([k.shape[2]] * q.shape[0] if kv is None
              else kv.clamp(0, k.shape[2]).tolist())
    bms, bkind = offset_bound(q, k, v, causal, off, kv_len,
                              BF16_TC_OPS_PER_S if tc else F32_OPS_PER_S)
    times = kernel_times(lambda: ops.flash_attention(q, k, v, causal, scale,
                                                     off, kv),
                         masked_sdpa(q, k, v, causal, off, kv, scale))
    res.update(**times, checks=worst,
               max_abs_err=worst["ops.flash_attention vs plain"][
                   "max_abs_err"],
               plain_ms=cuda_time_ms(lambda: ref.flash_attention_ref(
                   q, k, v, causal, scale, off, kv), min_iters=2),
               bound_ms=bms, bound_by=bkind,
               share_of_bound=bms / times["ms"],
               library="F.scaled_dot_product_attention with the mask as a "
                       "boolean attn_mask, KV heads expanded outside")
    log(f"attn_offset {tag}: [{res['shape']}] {res['kernel']} device ms "
        f"{res['ms']:.4f} ({res['device_source']}) call ms "
        f"{res['call_ms']:.4f} masked SDPA device ms {res['library_ms']} "
        f"plain ms {res['plain_ms']:.3f} bound ms {bms:.4f} ({bkind}, "
        f"{res['share_of_bound']:.3f} of it); rows without keys "
        f"{res['rows_without_keys']}, written 0; checks {worst}")
    return res


def attn_offset_paths(args, counted, phases) -> dict:
    """Step 11 (phase ``attn_offset``): ``chunked_attention`` with the
    queries at the end of the keys and a per-batch key bound, through
    both flash kernels, at granite-3-2b's and deepseek-v2-lite's MLA
    layer shapes, and one causal case with S > T; then row 7 re-timed at
    8 x 2,048, S = T, with and without the new arguments, in turns with
    SDPA.  Returns the ``offset_shapes`` of the two flash entries."""
    from repro_torch.configs import deepseek_v2_lite_16b, granite_3_2b
    from repro_torch.kernels import ops
    from repro_torch.models import layers

    dev = torch.device("cuda")
    g = granite_3_2b.CONFIG
    dcfg = deepseek_v2_lite_16b.CONFIG
    rng = np.random.default_rng(args.seed + 21)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 21)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def kv_valid(b, t):
        kv = rng.integers(1, t, size=b)
        kv[0], kv[-1] = 0, t
        return torch.as_tensor(kv, dtype=torch.int32, device=dev)

    # (tag, B, H, Hk, S, T, D, Dv, dtypes)
    cases = [("granite", ATTN_BATCH, g.n_heads, g.n_kv_heads, ATTN_S,
              ATTN_T, g.hd, g.hd, (torch.bfloat16, torch.float32)),
             ("mla", ATTN_MLA_BATCH, dcfg.n_heads, dcfg.n_heads,
              ATTN_MLA_S, ATTN_T,
              dcfg.qk_nope_dim + dcfg.qk_rope_dim, dcfg.v_head_dim,
              (torch.bfloat16, torch.float32)),
             ("s_gt_t", 2, g.n_heads, g.n_kv_heads, ATTN_T, ATTN_S, g.hd,
              g.hd, (torch.bfloat16, torch.float32))]
    inputs = []
    for tag, b, h, hk, s, t, d, dv, dtypes in cases:
        for dt in dtypes:
            q = randn(b, s, h, d, dtype=dt)
            k = randn(b, t, hk, d, dtype=dt)
            v = randn(b, t, hk, dv, dtype=dt)
            scale = d ** -0.5
            kv = kv_valid(b, t)
            inputs.append((f"{tag} {str(dt)[6:]}", q, k, v, scale, kv))

    def path():
        """The model's entry: ``layers.chunked_attention`` (B, S, H, D),
        causal (query i at T - S + i) and not, each with the key bound."""
        outs = []
        for tag, q, k, v, scale, kv in inputs:
            for causal in ((True,) if tag.startswith("s_gt_t")
                           else (True, False)):
                o = layers.chunked_attention(q, k, v, causal=causal,
                                             scale=scale, kv_valid=kv)
                if not bool(torch.isfinite(o).all()):
                    raise AssertionError(f"attn_offset {tag}: not finite")
                outs.append(o)
        return len(outs)
    n = counted("attn_offset", ("flash_attention", "flash_attention_simt"),
                path)
    log(f"attn_offset: {n} chunked_attention calls through the model's "
        f"entry: launches {phases['attn_offset']}")

    shapes = {"flash_attention": {}, "flash_attention_simt": {}}
    for tag, q, k, v, scale, kv in inputs:
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        s, t = q.shape[1], k.shape[1]
        for causal in ((True,) if tag.startswith("s_gt_t")
                       else (True, False)):
            off = t - s if causal else 0
            key = f"{tag} {'causal' if causal else 'full'}"
            res = offset_case(key, qh, kh, vh, causal, off, kv, scale)
            res["launches"] = phases["attn_offset"][res["kernel"]]
            shapes[res["kernel"]][key] = res
    del inputs

    # row 7 at granite 8 x 2,048, S = T: the old path against the new
    # arguments (a full key bound and offset 0), in turns with SDPA
    q = randn(LM_BATCH, g.n_heads, LM_BATCH_LEN, g.hd, dtype=torch.bfloat16)
    k = randn(LM_BATCH, g.n_kv_heads, LM_BATCH_LEN, g.hd,
              dtype=torch.bfloat16)
    v = randn(LM_BATCH, g.n_kv_heads, LM_BATCH_LEN, g.hd,
              dtype=torch.bfloat16)
    full = torch.full((LM_BATCH,), LM_BATCH_LEN, dtype=torch.int32,
                      device=dev)
    if not torch.equal(ops.flash_attention(q, k, v),
                       ops.flash_attention(q, k, v, True, None, 0, full)):
        raise AssertionError("attn_offset: a key bound of T changes the "
                             "S = T output")
    turns = in_turns({
        "no new arguments": lambda: ops.flash_attention(q, k, v),
        "kv_valid = T": lambda: ops.flash_attention(q, k, v, True, None, 0,
                                                    full),
        "sdpa": sdpa_call(q, k, v)}, rounds=4)
    times = kernel_times(lambda: ops.flash_attention(q, k, v),
                         sdpa_call(q, k, v))
    bms, bkind = flash_bound(q, k, v)
    retime = dict(shape=f"q {tuple(q.shape)} k/v {tuple(k.shape)} bf16 "
                        f"causal", turns_call_ms=turns, **times,
                  bound_ms=bms, bound_by=bkind,
                  share_of_bound=bms / times["ms"])
    shapes["flash_attention"]["retime 8 x 2048"] = retime
    log(f"attn_offset: row 7 at 8 x {LM_BATCH_LEN}, S = T, in turns (call "
        f"ms): {turns}; device ms {times['ms']:.4f} against SDPA's "
        f"{times['library_ms']}; bound {bms:.4f} ms ({bkind})")
    return shapes


# ---------------------------------------------------------------------------
# 12. the SSH build and query steps at full ssh-ecg width
# ---------------------------------------------------------------------------

_ECG = {}


def ecg_stream(n, seed):
    """``synthetic_ecg(n, seed)``, made once a seed for the longest n asked
    and sliced after (the subsequence and SSH-step phases share it)."""
    from repro_torch.data.timeseries import synthetic_ecg
    got = _ECG.get(seed)
    if got is None or len(got) < n:
        got = _ECG[seed] = synthetic_ecg(n, seed=seed)
    return got[:n]


def ssh_step_paths(args, counted, phases, smi) -> dict:
    """Step 12 (phases ``ssh_build_2048``, ``ssh_query_128``,
    ``ssh_query_2048``): ``launch.steps``' SSH build and query steps of
    the ``ssh-ecg`` arch at full width; returns the ``ssh_step_shapes``
    of ``sketch_conv``, ``collision_count`` and ``dtw_wavefront`` and
    the cells' times."""
    from repro_torch.configs import ssh_ecg
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import analytic, steps

    dev, cpu = torch.device("cuda"), torch.device("cpu")
    arch = ssh_ecg.ARCH
    kernels = ("sketch_conv", "collision_count", "dtw_wavefront")
    params = steps.init_fn(arch, "build_2048", device=dev)()
    build = steps.make_step(arch, "build_2048", "build")
    shapes = {k: {} for k in kernels}
    cells = {}
    rng = np.random.default_rng(args.seed + 31)
    n128, n2048 = SSH_DB_128_ROWS, SSH_DB_2048_ROWS
    b_meta = arch.shapes["build_2048"].meta
    batch, m_b = SSH_BUILD_BATCH, b_meta["length"]
    stride = SSH_BUILD_STRIDE
    stream = torch.as_tensor(ecg_stream(
        max(n128 + 127, n2048 + 2047, batch * stride + m_b), args.seed),
        device=dev)
    log(f"ssh_steps: one synthetic-ECG stream of {stream.numel()} points "
        f"from seed {args.seed}; params drawn from the spec's seed "
        f"{arch.config.seed}: filters {tuple(params['filters'].shape)}, "
        f"CWS fields {tuple(params['cws']['r'].shape)}")

    def sync_s(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    # -- build_2048 ----------------------------------------------------------
    series = stream.unfold(0, m_b, stride)[:batch].contiguous()

    def build_path():
        build(params, {"series": series[:4096]})        # first-use set-up
        walls = []
        for _ in range(SSH_BUILD_STEPS):
            sigs, s = sync_s(lambda: build(params, {"series": series}))
            walls.append(s)
        return sigs, walls
    sigs, walls = counted("ssh_build_2048", ("sketch_conv",), build_path)
    if sigs.shape != (batch, 40) or sigs.dtype != torch.int32:
        raise AssertionError(f"ssh build_2048: signatures "
                             f"{tuple(sigs.shape)} {sigs.dtype}")
    step_s = float(np.median(walls))
    mf = analytic.ssh_model_flops(arch.config, "build", dict(
        batch=batch, length=m_b))
    cells["build_2048"] = dict(batch=batch, length=m_b, walls_s=walls,
                               ms_per_step=step_s * 1e3,
                               series_per_s=batch / step_s,
                               model_flops=mf, seconds=step_s)
    log(f"ssh build_2048: {batch} x {m_b} (windows at stride {stride}) -> "
        f"{tuple(sigs.shape)} signatures: {step_s * 1e3:.2f} ms a step "
        f"(median of {len(walls)}: {[round(w * 1e3, 2) for w in walls]}), "
        f"{batch / step_s:.0f} series/s [{smi}]")
    # card against CPU: the signatures of the first rows
    t = time.perf_counter()
    n_cpu = SSH_CPU_BUILD_ROWS
    p_cpu = {"filters": params["filters"].cpu(),
             "cws": {k: v.cpu() for k, v in params["cws"].items()}}
    want = build(p_cpu, {"series": series[:n_cpu].cpu()})
    bad = int((sigs[:n_cpu].cpu() != want).any(1).sum())
    if bad:
        raise AssertionError(f"ssh build_2048: card and CPU signatures "
                             f"differ on {bad} of {n_cpu} rows")
    cells["build_2048"]["cpu_check"] = (
        f"{n_cpu} rows: signatures equal; {time.perf_counter() - t:.1f} s")
    log(f"ssh build_2048: card = CPU, {cells['build_2048']['cpu_check']}")
    # the sketch at the build shape, bit for bit against its emulation
    x = series
    kern = ops.sketch_conv(x, params["filters"], 3)
    emu = ref.sketch_conv_fma_ref(x, params["filters"], 3)
    if not torch.equal(kern, emu):
        raise AssertionError("sketch_conv at the build shape is not "
                             "bit-identical to sketch_conv_fma_ref")
    del emu
    w_ = params["filters"].shape[0]
    filt = params["filters"]
    bms, bkind = bound_ms(4 * (x.numel() + filt.numel() + kern.numel()),
                          2 * kern.shape[1] * kern.shape[0] * w_)
    wconv = filt.t().contiguous()[:, None, :]
    shapes["sketch_conv"]["build_2048"] = dict(
        shape=f"x {tuple(x.shape)} filters {tuple(filt.shape)} step 3",
        **kernel_times(lambda: ops.sketch_conv(x, filt, 3),
                       lambda: torch.nn.functional.conv1d(
                           x[:, None, :], wconv, stride=3)),
        plain_ms=cuda_time_ms(lambda: ref.sketch_conv_ref(x, filt, 3),
                              min_iters=2),
        bound_ms=bms, bound_by=bkind, max_abs_err=0.0, bit_identical=True,
        launches=phases["ssh_build_2048"]["sketch_conv"])
    del kern, series, x, sigs
    log(f"kernel sketch_conv at the build_2048 shape: "
        f"{shapes['sketch_conv']['build_2048']}")

    # -- query steps -------------------------------------------------------
    def query_cell(shape, n_db, gate_self):
        meta = arch.shapes[shape].meta
        m = meta["length"]
        query = steps.make_step(arch, shape, "query")
        t = time.perf_counter()
        db_series = stream.unfold(0, m, 1)[:n_db].contiguous()
        chunk = SSH_DB_CHUNK[m]
        db_sigs = torch.cat([
            build(params, {"series": db_series[lo:lo + chunk]})
            for lo in range(0, n_db, chunk)])
        torch.cuda.synchronize()
        built_s = time.perf_counter() - t
        log(f"ssh {shape}: database of {n_db} windows of {m} (stride 1), "
            f"{db_series.numel() * 4 / 1e9:.2f} GB of series and "
            f"{db_sigs.numel() * 4 / 1e9:.2f} GB of signatures, built by "
            f"the build step in {-(-n_db // chunk)} calls of {chunk} rows: "
            f"{built_s:.1f} s"
            + ("" if n_db == meta["n_database"] else
               f"; CUT from {meta['n_database']} rows"))
        qids = np.sort(rng.choice(n_db, SSH_QUERIES, replace=False))
        batch_q = {"db_sigs": db_sigs, "db_series": db_series}

        def run():
            query(params, dict(batch_q, query=db_series[int(qids[0])]))
            out = []
            for i in qids:
                (ids, d), s = sync_s(lambda: query(
                    params, dict(batch_q, query=db_series[int(i)])))
                out.append((ids.cpu(), d.cpu(), s))
            return out
        res = counted(f"ssh_{shape}", kernels, run)
        walls = [r[2] for r in res]
        top1 = [int(r[0][0]) == int(i) for r, i in zip(res, qids)]
        zero = [float(r[1][0]) == 0.0 for r in res]
        top10 = [int(i) in r[0].tolist() for r, i in zip(res, qids)]
        counts = ops.collision_count(db_sigs[int(qids[0])], db_sigs)
        ties = int((counts == db_sigs.shape[1]).sum())
        q_ms = float(np.median(walls)) * 1e3
        mf = analytic.ssh_model_flops(arch.config, "query", dict(
            meta, n_database=n_db))
        cells[shape] = dict(
            n_database=n_db, queries=qids.tolist(), ms_per_query=q_ms,
            walls_s=walls, self_top1=sum(top1) / len(top1),
            self_in_top10=sum(top10) / len(top10), top1_distance_0=zero,
            ties_at_k_first_query=ties, model_flops=mf,
            seconds=q_ms / 1e3, db_build_s=built_s)
        log(f"ssh {shape}: {len(qids)} queries drawn from the database: "
            f"{q_ms:.3f} ms a query (median; "
            f"{[round(w * 1e3, 2) for w in walls]}); self-match at rank 1 "
            f"{sum(top1)}/{len(top1)}, in the top 10 "
            f"{sum(top10)}/{len(top10)}; the first query ties with {ties} "
            f"rows at all {db_sigs.shape[1]} hashes, and the top-"
            f"{meta['top_c']} takes ties by the lowest id [{smi}]")
        if gate_self and not (all(top1) and all(zero)):
            raise AssertionError(f"ssh {shape}: a query drawn from the "
                                 f"database is not its own top-1 at "
                                 f"distance 0: {top1} {zero}")
        # card against CPU on the database's first SSH_CPU_ROWS[m] rows
        t = time.perf_counter()
        n_cpu = min(SSH_CPU_ROWS[m], n_db)
        sl_series, sl_sigs = db_series[:n_cpu], db_sigs[:n_cpu]
        cpu_sigs = build(p_cpu, {"series": sl_series.cpu()})
        if not torch.equal(cpu_sigs, sl_sigs.cpu()):
            raise AssertionError(f"ssh {shape}: card and CPU signatures "
                                 f"differ on the first {n_cpu} rows")
        for i in rng.choice(n_cpu, 2, replace=False):
            qc = sl_series[int(i)]
            gi, gd = query(params, {"query": qc, "db_sigs": sl_sigs,
                                    "db_series": sl_series})
            ci, cd = query(p_cpu, {"query": qc.cpu(), "db_sigs": cpu_sigs,
                                   "db_series": sl_series.cpu()})
            if not torch.equal(gi.cpu(), ci) or not torch.allclose(
                    gd.cpu(), cd, rtol=1e-5, atol=1e-6):
                raise AssertionError(
                    f"ssh {shape}: card and CPU answers differ on a "
                    f"{n_cpu}-row slice: {gi.tolist()} {ci.tolist()}")
        cells[shape]["cpu_check"] = (
            f"{n_cpu} rows: signatures equal; 2 queries' ids equal, "
            f"distances within 1e-5; {time.perf_counter() - t:.1f} s")
        log(f"ssh {shape}: card = CPU, {cells[shape]['cpu_check']}")
        # the kernels on one query's own inputs
        with Recorder(ops, ("collision_count", "dtw_rerank")) as rec:
            query(params, dict(batch_q, query=db_series[int(qids[0])]))
        (q1, dbk1), _ = rec.calls["collision_count"][0]
        cc = dict(collision_at(q1, dbk1),
                  launches=phases[f"ssh_{shape}"]["collision_count"])
        dt = dict(dtw_shape("dtw_wavefront", rec.calls["dtw_rerank"][0], 2),
                  max_abs_err=0.0,
                  launches=phases[f"ssh_{shape}"]["dtw_wavefront"])
        shapes["collision_count"][shape] = cc
        shapes["dtw_wavefront"][shape] = dt
        shapes["sketch_conv"].setdefault("query_launches", {})[shape] = \
            phases[f"ssh_{shape}"]["sketch_conv"]
        for name, got in (("collision_count", cc), ("dtw_wavefront", dt)):
            log(f"kernel {name} at the ssh {shape} shape: [{got['shape']}] "
                f"device ms {got['ms']:.4f} ({got['device_source']}) call "
                f"ms {got['call_ms']:.4f} plain ms {got['plain_ms']:.4f} "
                f"library ms {got.get('library_ms')} bound ms "
                f"{got['bound_ms']:.5f} ({got['bound_by']}) launches "
                f"{got['launches']}")
        del rec, db_series, db_sigs, batch_q, counts
        gc.collect()
        torch.cuda.empty_cache()

    query_cell("query_128", n128, gate_self=False)
    query_cell("query_2048", n2048, gate_self=True)
    del stream, params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(shapes=shapes, cells=cells)


# ---------------------------------------------------------------------------
# 13. roofline and 14. the profiler's census
# ---------------------------------------------------------------------------

MEASURED = []


def measured(arch, shape, run, model_flops, seconds):
    """One timed run for the roofline: MODEL_FLOPS at the run's own batch
    and its time (``launch.roofline`` reads the list)."""
    MEASURED.append(dict(arch=arch, shape=shape, run=run,
                         model_flops=model_flops, seconds=seconds,
                         n_chips=1))


def roofline_lines(smi):
    """Step 13: each timed run's MODEL_FLOPS over its time and the bf16
    peak; written to ``build/roofline_measured.json``, which
    ``python -m repro_torch.launch.roofline --measured`` reads."""
    from repro_torch.launch.roofline import measured_frac
    for r in MEASURED:
        r["roofline_frac"] = measured_frac(r["model_flops"], r["seconds"])
        log(f"roofline {r['arch']} {r['shape']} ({r['run']}): MODEL_FLOPS "
            f"{r['model_flops']:.4e} in {r['seconds']:.6f} s = "
            f"{r['model_flops'] / r['seconds'] / 1e12:.3f} TFLOP/s, "
            f"{r['roofline_frac']:.5f} of the 989 TFLOP/s bf16 peak "
            + (f"(6 N tokens gives {r['six_n_share']:.4f}) "
               if "six_n_share" in r else "") + f"[{smi}]")
    out = Path(__file__).resolve().parent / "build" / "roofline_measured.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(MEASURED, indent=1))


def census_lines():
    """Step 14: one line a profiled window (``bench.device_time.CENSUS``):
    the device records kept of each of the port's kernels against the
    launches their counters saw, and the gap."""
    from repro_torch.bench.device_time import CENSUS
    lost = [c for c in CENSUS if c["gap"]]
    for c in CENSUS:
        log(f"census window {c['window']} [{c['label']}]: kept "
            f"{c['kept']} launched {c['launched']} gap {c['gap']} device "
            f"records {c['device_records']} (other {c['other']}); lead-in "
            f"kernels unrecorded {c['lead_lost']}; launch calls whose kernel"
            f" went unrecorded {c.get('lost_calls')} at positions "
            f"{c.get('lost_at')}")
    lead = [c["lead_lost"] for c in CENSUS]
    log(f"census: {len(CENSUS)} profiled windows, {len(lost)} lost records "
        f"of the port's kernels ({sum(sum(c['gap'].values()) for c in lost)} "
        f"records), {sum(1 for c in CENSUS if c['device_records'] == 0)} "
        f"kept no device record at all; first window with a gap: "
        f"{lost[0]['window'] if lost else None}; lead-in kernels "
        f"unrecorded a window: first {lead[:1]}, max {max(lead, default=0)}"
        f", last {lead[-1:]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-series", type=int, default=1 << 20)
    ap.add_argument("--length", type=int, default=512)
    ap.add_argument("--lm-prompt", type=int, default=32768,
                    help="tokens of the long LM prefill")
    ap.add_argument("--subseq-points", type=int, default=SUBSEQ_POINTS,
                    help="points of the subsequence phases' stream")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA GPU")
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        raise SystemExit(f"chip_smoke: {src / 'repro_torch'} is missing; "
                         "run this script from a checkout of the repo")
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import dtw_wavefront as kd

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}; tf32 off for matmul and cuDNN")
    t = time.perf_counter()
    _build.build_all()
    for name in _build.SIGNATURES:
        _build.load(name)
    log(f"kernel libraries built and loaded in {time.perf_counter() - t:.1f}"
        f" s ({', '.join(_build.SIGNATURES)}): kernels "
        f"{', '.join(_build.KERNELS)}")

    phases = {}

    def counted(phase, kernels, fn):
        """Run ``fn`` with every launch count at 0 before; require each
        of ``kernels`` to have launched; keep the counts."""
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        phases[phase] = dict(counts, **kd.schedule_counts())
        missing = [k for k in kernels if counts[k] < 1]
        log(f"phase {phase}: launches {counts}")
        if missing:
            raise AssertionError(f"phase {phase}: kernels {missing} never "
                                 f"launched: {counts}")
        return out

    log(f"written by this process: {written_gb()} GB")
    entries = ssh_paths(args, counted, phases)
    log(f"written by this process: {written_gb()} GB")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"SSH state freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"still allocated")
    t = time.perf_counter()
    shapes = subseq_paths(args, counted, phases)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"subsequence phases: {time.perf_counter() - t:.1f} s; state "
        f"freed, {torch.cuda.memory_allocated() / 1e9:.2f} GB still "
        f"allocated; written by this process: {written_gb()} GB")
    for e in entries:
        if "launches_by_phase" in e:
            e["launches_by_phase"].update(
                {p: c[e["name"]] for p, c in phases.items()
                 if p.startswith("subseq")})
    for e in entries:
        if e["name"] in shapes:
            e["stream_shape"] = shapes[e["name"]]
    t = time.perf_counter()
    ssh_steps = ssh_step_paths(args, counted, phases, smi)
    for e in entries:
        if e["name"] in ssh_steps["shapes"]:
            e["ssh_step_shapes"] = ssh_steps["shapes"][e["name"]]
    for shape, cell in ssh_steps["cells"].items():
        measured("ssh-ecg", shape, f"n_database {cell['n_database']}"
                 if "n_database" in cell else f"batch {cell['batch']}",
                 cell["model_flops"], cell["seconds"])
    log(f"ssh step phases: {time.perf_counter() - t:.1f} s; "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated; "
        f"cells {json.dumps(ssh_steps['cells'])}")
    entries.extend(lm_path(args, counted, phases))
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    suite = lm_suite(args, counted, phases)
    log(f"LM suite phases: {time.perf_counter() - t:.1f} s; written by "
        f"this process: {written_gb()} GB")
    for e in entries:
        if e["name"] in suite:
            e["suite_shapes"] = suite[e["name"]]
            e.setdefault("launches_by_phase", {}).update(
                {p: c[e["name"]] for p, c in phases.items()
                 if p.startswith("lm_")})
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    offsets = attn_offset_paths(args, counted, phases)
    for e in entries:
        if e["name"] in offsets:
            e["offset_shapes"] = offsets[e["name"]]
            e.setdefault("launches_by_phase", {})["attn_offset"] = \
                phases["attn_offset"][e["name"]]
    log(f"attention offset phases: {time.perf_counter() - t:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    trained = train_paths(args, counted, phases, smi)
    log(f"training phases: {time.perf_counter() - t:.1f} s; written by "
        f"this process: {written_gb()} GB")
    for e in entries:
        if e["name"] in trained:
            e["train_shapes"] = trained[e["name"]]
            e.setdefault("launches_by_phase", {}).update(
                {p: c[e["name"]] for p, c in phases.items()
                 if p.startswith("train")})
    gc.collect()
    torch.cuda.empty_cache()
    log(f"LM state freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB still "
        f"allocated")
    t = time.perf_counter()
    family_paths(args, counted, phases, smi)
    log(f"recsys and GNN phases: {time.perf_counter() - t:.1f} s")

    roofline_lines(smi)
    census_lines()
    for e in entries:
        log(f"kernel {e['name']}: device ms {e['ms']:.4f} call ms "
            f"{e['call_ms']:.4f} plain_ms {e['plain_ms']:.4f} library "
            f"device ms {e['library_ms']} bound_ms {e['bound_ms']:.4f} "
            f"({e['bound_by']}, {e['bound_ms'] / e['ms']:.3f} of it) "
            f"launches {e['launches']} max_err {e['max_abs_err']} "
            f"[{e['shape']}]")
        log(f"kernel {e['name']}: profiled windows {e.get('device_windows')}"
            f" (library {e.get('library_windows')}), every record kept "
            f"{e.get('device_window_complete')}, device time from "
            f"{e.get('device_source')} (library {e.get('library_source')})")
        for extra in ("query_shape", "sequential_shape", "long_shape",
                      "engine_shapes", "stream_shape", "fleet_shapes",
                      "suite_shapes", "train_shapes", "ssh_step_shapes",
                      "offset_shapes", "paper_api_shapes", "probe_shapes"):
            if extra in e:
                log(f"kernel {e['name']} at the {extra.split('_')[0]} shape: "
                    f"{e[extra]}")

    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(f"{smi}")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
