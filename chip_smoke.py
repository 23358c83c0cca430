#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bifrost_tpu_torch) on one card.

    python3 chip_smoke.py

Run from the repository root on a machine with one NVIDIA H100 and the
CUDA toolkit (nvcc).  It imports nothing of JAX or of bifrost_tpu.  It:

1. prints the card (nvidia-smi name and power limit);
2. builds every CUDA kernel of the port from bifrost_tpu_torch/csrc;
3. runs K2 (Stokes detect) at T=16384, F=4096 on the strided planes of a
   complex FFT output, as the main path gives it, against its plain
   PyTorch version (rtol 1e-6), and times both with CUDA events;
4. runs K1 (fused spectrometer) against the float64 oracle at T=64,
   nfft=4096, r=4 (gate 1e-5 relative to the maximum), over every
   power-of-two nfft from 4 to 8192 at small T and r 1, 4 and nfft
   against the oracle and its plain version (each nfft through the
   kernel its size picks: radix-16 Stockham from 256, radix-2 below,
   counted by path), and against its plain version at full width; times
   the kernel (bracketed and queued), the plain version, the PyTorch
   chain fft -> Stokes -> reduce (the library yardstick) and cuFFT alone
   on the unpacked gulp, and the kernel and cuFFT at nfft 1024, 2048 and
   8192 on gulps of as many samples;
5. drives the Guppi spectrometer chain through the port's Pipeline at
   full width (16384 x 2 x 4096 ci8 gulps, r=4; 3 warm-up and 16 timed
   gulps): system ring -> copy('cuda') -> FusedBlock -> copy('system') ->
   sink, once with the K1 substitution and once without (K2 path).
   Launch counters are zeroed just before and read just after each run;
   each run must launch its kernel once per gulp, and every K1 launch
   must take the radix-16 kernel.  The two outputs must
   agree within 1e-5, and rows are checked against the oracle;
5a. writes GUPPI RAW files at Breakthrough Listen's GBT recording
   geometry (64 coarse channels, 2 pols, 128 MiB blocks) to a temporary
   directory, 4 blocks at NBITS 8 (524288 samples) and 2 at NBITS 4
   (1048576), each seeded noise plus one tone per channel, and runs the
   north star's chain over each through examples/gpuspec_simple_torch.py's
   build() with one block a gulp (read_guppi_raw -> copy('cuda') ->
   fused[FFT -> Stokes -> reduce(4)] -> copy('system') -> merge_axes ->
   transpose -> write_sigproc).  The .fil header fields must equal what
   the Guppi header gives, its data must be within 1e-5 of a float64
   numpy oracle on the first 2 blocks, and every tone must peak at its
   bin; the ci4 block's device representation must equal a numpy
   unpacking bit for bit.  Prints the file-to-file rate (host-bound) and
   each block's host ms per gulp;
5b. drives copy('cuda') -> fft -> detect('stokes') (unfused) ->
   copy('system') on the spectrometer arm's gulps: K2 must launch once
   per gulp and every output equal stokes_detect_plain;
5c. runs bf.map (bifrost_tpu_torch.map) on a spectrometer gulp: the
   polarisation products of tests/test_map.py on its complex64
   voltages (equal to torch's products and to numpy on 64 rows: every
   product of these integers is exact), the fftshift index vector along
   the 4096 axis (equal to torch.fft.fftshift) and the ci8 expression on
   the raw gulp from host memory (equal to the unpacked gulp), each
   timed; dft_matmul_fft on the gulp's 4096-point rows within 1e-4 of
   torch.fft.fft, timed beside it; and fused([FftStage, MapStage('b =
   a.mag2()', dtype='f32'), ReduceStage('freq', 4)]) through the
   pipeline (1 warm-up and 3 timed gulps) within 1e-5 of a float64
   |FFT|^2 summed by 4 on 64 rows;
6. runs the beamformer kernels at the full-width shapes of BASELINE
   config 4 (512 frames x 512 channels x 256 stations x 2 pols ci8, 64
   beams, R=8): K4 (int8, one int8 tensor-core GEMM over every channel)
   on both pols' views bit-identical to its plain version and on pol 0
   to the int64 oracle on three channels, K5 (bf16, one GEMM over every
   channel) within 1e-5 of its plain version and inside the bf16 class of
   the float64 oracle, the K4 and K5 launches on the per-pol views through
   the 16-byte staging, K6 (beamform -> Stokes -> integrate) on its
   int8 tensor-core kernel bit-identical to its plain version and below
   1e-5 against the float64 oracle on a T=64 cut, and over an R sweep
   at T=96 (R 1, 2, 4, 8, 16 on the tensor-core kernel, bit-identical;
   R 32, R = T and a gulp 4 bytes off 16 on the dp4a kernel, within
   1e-6; each launch's kernel by the per-path counter); each timed with
   CUDA events beside its plain version and a library yardstick, and
   queued (K4 against torch._int_mm of the widened block, K5 against
   torch.mm with an f32 output and the bf16-output torch.matmul, K6
   against the torch chain and twice K4's queued time, the unfused
   path's products); K4 and K5 count the whole gulp read by each
   per-pol launch;
7. drives the beamformer chain through the Pipeline at that width (3
   warm-up and 16 timed gulps) in four arms, K6 (fused substitution),
   K4 and K5 (beamform block with the kernel forced -> fused Stokes and
   frame sum) and f32 (the complex64 baseline), zeroing the launch
   counters just before and reading them just after each; K6 must
   launch once per gulp, every launch on its tensor-core kernel, K4 and
   K5 twice (once per pol), every K4 and K5 launch through the 16-byte
   staging.  The K4 and K6 arms must agree
   within 1e-5, each arm must stay inside its accuracy class of the f32
   arm, and every output must be finite and (64, 512, 4, 64).  A fifth
   arm leaves the candidate to the engine's race, in a fresh probe-cache
   directory, prints each candidate's ms and its choice and stays inside
   the int8 class;
7a. drives a 16-tap FIR block over 3 ci8 gulps of that shape, taps per
   (channel, station, pol) at decim 1 and then shared taps at decim 4,
   each within 1e-5 of a float64 oracle over the concatenated stream on
   4 channels, across the gulp boundaries; times Fir.execute on a gulp;
8. checks the capability probe K0: available() is True on the card and
   launches the probe kernel once (a second call is cached); times it
   one call bracketed, queued and replayed from a CUDA graph (device time
   alone) beside torch.mul(x, 2.0);
9. runs the correlator kernels at the FX path's shapes: K7 (xcorr_herm)
   on the (2, 128, 1024, 512) group planes of a (256, 1024, 256, 2) ci8
   gulp, read in place as strided views, in one launch; K8 (xcorr_cross)
   on a 128-input station-row block against all 512 inputs, T=128.  Each
   is bit-identical to its plain version (float64 products on the card)
   and to the int64 oracle on channels 0, 511 and 1023, K7's imaginary
   part nonzero and antisymmetric, K8 equal to K7's rows; each timed
   (bracketed and queued) beside its plain version and the complex64
   einsum yardstick, and beside zero_() of its output (the write
   ceiling).  K8 also at the 2-D mesh's block (T=128, 256 rows) and at
   T=256 (128 rows, chunked jobs), bit-identical and timed queued; every
   K8 launch must take the row-block jobs and the staging that
   xcorr_cross_plan and xcorr_staging give, by its counters;
10. drives the FX correlator through the Pipeline at BASELINE config 5's
   width with config 19's chain (256 stations x 2 pols, 1024 channels,
   256-frame gulps: copy('cuda') -> fft -> quantize('ci8', 1/32) ->
   correlate(128, fusable) -> accumulate(2, fusable) -> copy('system'))
   in three arms, K7 forced (one launch per gulp), the engine's race from
   an empty probe cache (K0 asked afresh), and the complex64 'xla'
   baseline; all three byte-identical to each other and to an oracle
   made on the card (torch's FFT and quantize, float64 products).  A
   fourth arm, BASELINE config 5's X step alone, runs the stateful
   correlate(256) on 64-frame ci8 gulps (one K7 launch per gulp) against
   the int64 oracle; the cross family of xcorr_int8 runs K8 on the four
   station-row blocks of a gulp, as the station-sharded plan calls it,
   each launch on row-block jobs;
10x. runs the transfer engine's phase (xfer): an H2D source overwritten
   while its copy is still queued, pinned-slot recycling by the
   xfer.h2d_staged / xfer.h2d_unstaged counters, futures read out of
   order, and 32 fills issued right behind a producer kernel with no
   synchronize, all byte for byte; a fault at xfer.result that must
   poison the D2H ring and make run() raise; fx-K7 (1 + 2 gulps), fir
   decim 1 (1 + 2) and guppi-ci8 (4 blocks) each async and under
   sync_strict, with a sink that keeps only a CRC-32 of each output: the
   same bytes in both modes (fx-K7's also the oracle's), and each mode's
   host ms a gulp of source, h2d, d2h and sink beside the counters
   xfer.d2h_async, depth_waits, sync_waits and pipeline.sync_waits and
   the pinned bytes the engine holds; and a first-touch probe, one 2 GiB
   complex64 D2H into a fresh 'system' buffer, the same buffer again, a
   pinned 'cuda_host' buffer and a page-locked (cudaHostRegister)
   pageable one, the copy's wait and the host copy apart.  Every arm
   logs the CRC-32 of its outputs, so that a run under BF_SYNC_STRICT=1
   can be held to the same bytes;
10y. races LinAlg.matmul (the linalg phase) from an empty probe cache at
   BASELINE config 4's beamforming GEMM (complex64 weights (512, 64,
   256) @ data (512, 256, 512)) and config 5's array a @ a^H ((1024,
   256, 256) in complex64 and in ci8): the chosen candidate and its
   probe ms, every candidate timed queued with its torch._int_mm calls
   beside the complex64 torch.matmul of the same product and the bound,
   each held to a float64 oracle made on the card (the ci8 family bit
   for bit, the float families within 1e-3, planar_bf16 8e-3);
10z. drills the supervised runtime (the supervision phase) on the K1
   chain at the flagship's width, 2048 frames a gulp: a reference run,
   then a source that fails once and restarts (1 restart, every output
   the reference's bytes), K1's block failing under the default policy
   (run() raises naming it within its shutdown_timeout, no thread left,
   no transfer outstanding, card memory back within a gulp),
   skip_sequence (the second sequence whole), drop_oldest on the H2D
   ring behind a sink that runs K1 and idles (the shed ledger equals the
   gulps it lost, health passes through SHEDDING, every delivered output
   the reference's bytes) with BF_METRICS_FILE parsed (xfer and shed
   counters, the card's bytes in use, slo.exit_age_s), and a wedged sink
   under BF_WATCHDOG_SECS=2 with escalation (PipelineStallError 2-6 s
   after the wedge); then guppi-ci8 with that tier quiet and armed, in
   turns (the tier's overhead);
10m. runs the macro phase (bifrost_tpu_torch.macro and .segments): the
   flagship chain fused (K1) over 9 gulps at gulp_batch 1, 4 and 4 with
   donate=True (9 K1 launches against 3, dispatches/gulps 9/9 against
   3/9, the same bytes, output 0 within the gate of the oracle,
   donation.hits > 0, the fused block's host ms a gulp and peak device
   memory of each); the same chain as separate fft, detect, reduce blocks
   at K = 4 with segments 'off' and 'force' (one segment, its elided
   rings never reserved, K2 launched once a dispatch, the same bytes) and
   at K = 1; config 22's FRB search with K3 forced at K = 4 under
   segments 'auto' (one segment of three, its overlap carried) against
   K = 1 'off', byte for byte, every pulse where the plan puts it; the
   beamformer's K6 block over 5 gulps and the FX chain (K7) over 4 at
   K = 4 against K = 1, byte for byte (FX also against its oracle).
   Launch counts subtract the fused blocks' prewarm runs, one launch at
   sequence start per plan shape;
10a. drives the fx-K7 arm's chain followed by
   convert_visibilities('storage'), as examples/fx_correlator.py builds
   it (1 warm-up and 2 timed gulps, 1.08 GB of storage each): one K7
   launch per gulp, every storage output equal value for value to the
   numpy conversion of the FX oracle's visibilities, a storage -> matrix
   round trip on the card equal to the oracle's full matrix; prints the
   D2H ms per gulp beside fx-K7's;
10b. grids 64 channels of 32,896 points (config 5's baselines with the
   autos) through 7 x 7 complex64 kernels onto a 1024 x 1024 grid with
   ops.romein.Romein (537 MB of grid), within 1e-5 of a float64
   scatter on 2 channels, and again with accumulate=True (the grid
   doubles); each execute timed;
11. runs K3 (the FDMT merge step) over every step of three plans at the
   full-width span (16384 + 1970 frames): 4096 channels over 1200-1600
   MHz to max_delay 1970, the same band in 3000 channels (passthrough
   rows, the rows_hi clamp), and 4096 channels with negative delays.
   Every step is bit-identical to its plain version, the K3 core to the
   torch gather core, and both within fdmt_gate_rtol() (1e-4) of a
   float64 reference (fdmt_numpy on the host for the first plan, the
   float64 gather core on the card, held to it, for the others).  Times
   the 12 launches of a gulp, each step, the plain version and the
   gather core's steps;
12. drives FDMT through the Pipeline at that width on a seeded noise
   stream with dispersed pulses injected at known trials and frames (2
   warm-up and 10 timed 16384-frame gulps) in four arms: fdmt-file
   (BASELINE config 3: an 8-bit .fil written by write_sigproc ->
   read_sigproc -> copy('cuda') -> transpose(['pol', 'freq', 'time']) ->
   fdmt(max_dm=100) -> copy('system'), K3 forced; max_delay must come
   out as 1970, every span equal to the K3 core on its data), and config
   22's FRB search ([freq, time] f32 source -> copy('cuda') ->
   fdmt_stage(1970) -> matched_filter(8) -> threshold(thr) ->
   copy('system'), thr at a false-alarm rate of 1e-3 on a noise-only
   realization) with K3 forced (frb-K3, 12 launches per gulp), with the
   race from an empty probe cache (frb-race) and with the torch gather
   core (frb-torch).  The frb arms are byte-identical, every arm is
   within 1e-4 of the float64 oracle chain, the candidates equal the
   oracle's apart from samples within rtol of the threshold, and every
   pulse peaks within 1 trial and 1 frame of where it was injected;
13. runs K9 (the corner turn's ring hop; right after the build, so a
   broken K9 stops the run early) at the corner turn's shapes on one card: 4 int8 blocks of (64, 1024, 256, 2, 2), 3 such blocks, and 4
   complex64 blocks whose byte count is not a multiple of 16, each
   bit-identical to its plain version; the whole corner turn
   (impl='pallas') of a (256, 1024, 256, 2, 2) gulp over 4 ranks of the
   card equal to the transpose oracle; K9, its plain version and
   torch.roll of the stacked blocks timed with CUDA events;
14. drives BASELINE config 5's array through copy('cuda') ->
   correlate(256, accuracy='int8') under block_scope(mesh=...) ->
   copy('system') on 256-frame gulps (1 warm-up and 1 timed), the mesh's
   ranks all on cuda:0, in six arms: single (no mesh, the reference, held
   to the float64 products and the int64 oracle), mesh-psum ({'sp': 4},
   BF_XCORR_CORNER_TURN=off), mesh-corner-xla and mesh-corner-K9 (the
   corner-turn plan forced with all_to_all or K9 hops), mesh-2d ({'sp':
   2, 'tp': 2}, station-sharded, K8 forced), each with K7 forced, and
   mesh-race (the plans and the X engine race from an empty probe
   cache); every mesh arm byte-identical to the single run, with 4 K7 (or
   4 K8, on row-block jobs) launches per gulp and 3 K9 launches per gulp
   in mesh-corner-K9;
15. drives config 22's [freq, time] stream through copy('cuda') ->
   fdmt(max_delay=1970) -> copy('system'), K3 forced, under an {'sp': 2}
   mesh of the card (spans of 2 x 9177 frames) and without a mesh: every
   span bit-identical;
15a. runs the analysis phase: guppi-ci8 (4 blocks, the GBT geometry)
   through the example's chain under BF_VALIDATE=strict, with
   BF_RINGCHECK off and on, every 'system' ring a NativeRing and no
   'cuda' one; the same two runs on the Python ring core in a child
   process (chip_smoke.py --guppi-child RAW DIR, BF_NO_NATIVE=1), every
   .fil byte-identical (one CRC), no checker violation, the verifier's ms
   at start-up and the four rates printed (the chain's 524,288-point FFT
   runs on cuFFT, above K1's 8192); the unfused spectrometer chain (K2,
   2 gulps) under the gate and the checker; the flagship fused K1 chain
   (1 warm-up and 2 timed gulps) with BF_TORCH_PROFILE armed: one
   capture, its five kernels with the most device time (K1 among them) and the device's
   busy share of the window; each ring.corrupt.* seam on a cuda ring and
   a native system ring raising RingProtocolError with its invariant;
   the drop_oldest card test's scenario 20 times, the ledger equal to
   the skipped frames every time; and the codes the verifier gave every
   pipeline this script ran (main() records each run's gate), none BF-E
   or BF-I199;
15b. runs the capture phase: CHIPS packets laid out as LWA-SV's
   F-engines send them (16 boards, 132 channels x 16 stands x 2 pols of
   ci4 a packet, 4,238-byte datagrams) over loopback from a child
   process into a capture ring, and the LWA-style correlator front end
   on the card: capture ring -> copy('cuda') -> transpose(time, freq,
   src, stand, pol) -> merge_axes(src, stand) -> correlate(1024,
   int8, K7 forced) -> accumulate(2) -> copy('system'), 1,024-frame
   gulps (69.2 MB), with a guaranteed host tap on the capture ring; in
   four arms: the native engine on a native 'system' ring and the
   sharded zero-copy engine (16 workers) on a pinned 'cuda_host' ring,
   each fed by the port's native transmit engine (chip_smoke.py
   --capture-sender PORT RATE SEED, paced from 100,000 packets/s down
   by halves until no packet is lost) and by a sendmmsg blaster
   (--capture-blaster PORT SEED).  Every arm: the loss ledger covers
   every committed cell, every tapped cell holds the sent payload or is
   blank (the throttled arms: every byte as sent, nothing lost), every
   visibility equals the float64 oracle made on the card from the
   tapped bytes, K7 launches once a gulp, and the sharded arms' H2D is
   the direct one (xfer.h2d_direct a gulp, no staged copy); packets/s
   received, Gbit/s, the loss fraction, the ratio to LWA's 25,000
   frames/s and each block's host ms a gulp are printed;
15c. runs the bridge phase: a GUPPI RAW file at the guppi-ci8 arm's GBT
   geometry (4 blocks of 128 MiB) sent by a child process (chip_smoke.py
   --bridge-sender JSON: read_guppi_raw into a native 'system' ring ->
   bridge_sink, host only) over loopback TCP to bridge_source in this
   process -> the example's chain after its reader (copy('cuda') ->
   fused FFT, Stokes, reduce(4) -> copy('system') -> merge_axes ->
   transpose -> write_sigproc), in three arms: bridge-w1 (window 1, one
   stream, a native 'system' ring), bridge-w4s4 (window 4, 4 stripes,
   CRC, a pinned 'cuda_host' ring whose H2D must be all direct) and
   bridge-resume (window 4, the link cut once by testing.faults.LinkCut
   after the third span: the sender redials and retransmits, the
   receiver drops the duplicates, one 'reconnected' record).  Each .fil
   equals the unbridged run's byte for byte, is within 1e-5 of the
   float64 oracle on 2 blocks with every tone at its bin, and every
   span arrives once (bridge.rx.spans 4, no CRC error).  The chain's
   524,288-point FFT is above K1's 8192 and runs on cuFFT (as in
   guppi-ci8), so a fourth arm, bridge-K1, bridges the spectrometer
   arm's 16384 x 2 x 4096 ci8 gulps (4 of 256 MiB, window 4, 2 stripes,
   CRC, into a 'cuda_host' ring) into fused[FFT, Stokes, reduce(4)]: K1
   once a gulp on its radix-16 kernel, each output equal byte for byte
   to K1 on the unbridged gulp and within 1e-5 of the oracle on 4 rows.
   Each arm prints the payload rate over the sender's seconds, the
   send-stall and recv-wait p50/p99, the handshake's round trip, the
   counters of both ends and each block's host ms a gulp;
15d. runs the closed-loop auto-tuner on bench.py's device-resident
   chain at full width: a 'cuda' source that cycles through three
   distinct pre-staged 16384 x 2 x 4096 ci8 gulps (3 sequences of 128
   gulps) -> fused[FFT, Stokes, reduce(4)] (K1) -> a sink that digests
   every output gulp on the card and forces completion after 4 gulps
   and at the last (no D2H).  Six freeze-mode runs climb from the de-tuned cold start (K 1,
   sync_depth 1), each warm-started at the profile the last one dumped,
   and must retune at least once; then, in alternating order, the
   arms detuned (K 1, sync 1), tuned (the cold start, warm-started by
   Pipeline.run(autotune=True) from the dumped profile), hand (K 16,
   sync 4) and hand_ctl (hand with the tuner running and every ceiling
   pinned), three times each.  Every arm's output equals the detuned
   arm's bit for bit (every gulp's digest and gulp 0's bytes), gulp 0
   is within 1e-5 of the oracle on 3 rows, the three distinct gulps
   digest apart, and every K1 launch takes the radix-16 kernel.  Prints each arm's Msamples/s, knobs and K1 launches, the tuned gap to
   hand and hand_ctl's overhead;
15e. runs the fleet plane: a FleetCollector in this process on
   loopback, with an alert rule file (the child host's absence) and an
   incident directory; this process publishes under BF_FLEET_HOST
   smoke-parent, a child (``chip_smoke.py --fleet-child JSON``) runs the
   K1 arm on the same card under smoke-child.  Both hosts must be live
   together; after the child exits its host goes stale and the rule
   fires; this process's K1 arm stalls its source until the health
   monitor's STALLED escalation has written one incident bundle holding
   both hosts' flight timelines with the fused blocks' on_data spans;
   the child runs again and the rule clears.  The rollup must hold both
   hosts, each with its card memory section and its K1 launch counter,
   which must equal the launches that host's arm measured (the counters
   are set to 0 where the phase starts).  Prints the alert and incident timings and fleet.pub.busy_us per
   second of wall;
15f. runs the service tier: four distinct 16384 x 2 x 4096 ci8 gulps
   recorded with serialize; tenants replay the recording (looped) ->
   QuotaGate -> copy('cuda') -> fused[FFT, Stokes, reduce(4)] (K1) ->
   copy('system') -> a sink that keeps each output's CRC-32.  Tenants A,
   B and C first run alone (each equal to A byte for byte, A within 1e-5
   of the float64 oracle on 3 rows of 2 gulps); then together on one
   JobManager: A at priority 2, B shedding at half the rate it showed
   alone (its shed gulps counted, admitted plus shed bytes equal to the
   offered bytes, every admitted gulp equal to A's solo output of that
   recorded gulp), and C with a host-level fault in its fused block
   (BF_FAULTS' block.on_data, matched on the block's full name), which
   fails C while A and B finish unharmed.  K1 launches on the radix-16
   kernel only, split into gulps and prewarm runs.  Then a cold tenant
   of A's topology on a warm-enabled manager and a warm one after it:
   one service.warm.hits, plan-depot hits and no plan build, the same
   bytes.  Prints each tenant's Msamples/s alone and together and the
   submit-to-first-gulp ms cold and warm;
15g. runs the fabric tier: examples/fx_correlator_torch.py and
   examples/fdmt_search_torch.py with --fabric's two loopback hosts at
   their own shapes, K7 and K3 forced, equal to their single-host runs;
   then a full-width drill: a child process (``chip_smoke.py
   --fabric-stations JSON``) is the 'stations' host of a FabricSpec and
   ships the FX phase's ci8 gulps over a 'pipe' link to this process's
   'xhost', which runs the fx-K7 chain and digests every visibility on
   the card.  The child is SIGKILLed after gulp 3 (all it shipped
   acknowledged), membership marks it dead, a relaunched child rejoins
   and replays only the unacknowledged gulps (bridge.rx.sessions_adopted
   >= 1).  Every visibility equals the FX chain's oracle for its gulp
   (card digest; CRC-32 of the first two), K7 launches once a gulp, and
   the sender's journal holds delivered plus shed bytes equal to the
   bytes produced.  Prints the dead-mark latency, the resume frame and
   the delivery MB/s of each session;
15h. runs the scheduler tier: two JobManagers as hosts h1 and h2 of one
   FabricSpec; three synthetic K1 tenants (float32 pairs made ci8 on the
   host, 256 x 2 x 4096 a gulp) whose sinks journal each delivered gulp
   to an AckLedger.  A solo run deposits the warm plans; the tenants are
   placed and applied warm; sc migrates h1 -> h2 at its ledger
   frontier; h1 dies and sa is re-placed at its frontier; one arbiter
   pass moves quota from sb to sa.  Every gulp of every tenant is
   delivered once and equals the solo run's, and the resumes are
   counted (scheduler.resume.skipped_frames).  Prints the migration's and
   the re-placement's ms;
15i. runs the seven tools of bifrost_tpu_torch/tools against live
   pipelines (the monitors phase): a child on the card (``chip_smoke.py
   --monitor-rx JSON``) runs bridge_source -> copy('cuda') -> fused[FFT,
   Stokes, reduce(4)] (K1) fed by a host-only ``--bridge-sender`` child
   with MONGULPS flagship gulps, both writing BF_TRACE_FILE under one
   BF_PROCLOG_DIR.  While the stream runs, ``like_bmon --once`` shows the
   bridge's rx and tx rows moving and ``like_pmap <rx pid>`` maps the
   receiver's rings; afterwards ``trace_merge`` joins the two traces on
   shared (trace, seq, gulp) identities that include K1 compute spans.
   This process then runs the device K1 chain hand-tuned (K 4, sync 4)
   and detuned (K 1, sync 1), MONDIFF gulps each, publishing to a
   ``bf_console`` child whose rollup's K1 counter must equal the launches
   measured, and ``telemetry_diff --strict`` must flag the detuned arm
   (exit 3: its ``pipeline.sync_waits``, a host stall on the card a
   gulp, are several times the hand arm's, whatever the rates do) and
   pass identical snapshots.  ``bf_lint --strict`` lints
   every examples/*_torch.py (no BF-E), and ``mprobe_report`` lists the
   winners of every race this process ran, the beamformer's among them:
   in process, and through ``--json`` children over the cache directory
   of each arm that raced from an empty cache (RACE_CACHES), every
   persisted winner equal to this process's;
15j. runs the mesh tier's frame-local plans on MPD ranks of cuda:0 (the
   mesh_plans phase): the device K1 chain (16384 x 2 x 4096 ci8, r 4,
   MPGULPS gulps) single-rank, then under the mesh (each rank launches
   K1 on its time shard), at gulp_batch MPK, fed from a pinned
   'cuda_host' source through the sharded H2D (each rank's frames copied
   straight from the span): every arm's output digests equal the
   single-rank run's, no collective runs, and K1 launches MPD x
   (dispatches + prewarm runs).  As two fused blocks that a mesh segment
   fuses (its interior ring elided, the members' own FFT and Stokes, no
   K1 across their boundary) the chain stays within 1e-5 of K1's.  The
   beamformer block (K4 forced) and
   the fused beamform-detect chain (K6) under the mesh equal their
   single-rank runs bit for bit, the engine prewarmed at the shard's
   frames and K4's beams equal to the int64 oracle; ``sharded_fft`` and
   ``freq_sharded_dft`` of MPFFTB x 2^20 points stay within 1e-4 of
   torch.fft (three all_to_all calls and none);
16. prints a JSON line of pipeline rates per chain, one of the DSP
   library phases' numbers, one of the xfer phase's, one of the analysis,
   capture, bridge, autotune, fleet, service, fabric and scheduler
   phases' and of the monitors and mesh_plans phases', one JSON line of
   per-kernel numbers
   ({"kernels": [...]}, K0-K9), the nvidia-smi line, and as the last
   line {"ok": true, "device": {...}}.

Any failure raises and exits non-zero before the last line; with no
CUDA device it exits 1 at once.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import time
import zlib

import numpy as np

NTIME, NPOL, NFINE, RFACTOR = 16384, 2, 4096, 4
NWARM, NTIMED = 3, 16
ORACLE_NTIME = 64
GATE = 1e-5              # spectrometer accuracy gate vs the float64 oracle
STOKES_RTOL = 1e-6
NRUNS = 20
# H100 SXM data sheet: HBM3 rate, FP32 rate outside the tensor cores,
# dense bf16 and int8 tensor-core rates
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_BF16_PER_S = 989e12
PEAK_INT8_PER_S = 1979e12
# the beamformer: BASELINE config 4 with config 13's integration
BT, BF, BS, BP, BB, BR = 512, 512, 256, 2, 64, 8
BEAM_ORACLE_NTIME = 64
BEAM_SWEEP_NTIME = 96     # K6's R sweep: R 1 .. 32 and R = T = 96
# the FX correlator: BASELINE config 5's array (256 stations, 2 pols, 1024
# channels) through config 19's chain, 256-frame gulps, R = 128 frames
# per visibility and A = 2 visibilities per output.  A visibility is at
# most 2 * 128^2 * R * A = 8.4e6 < 2^24, so every int32 sum, its float32
# cast and the float32 accumulate are exact whatever the summation
# order: arms and oracles are compared bit for bit.  The quantize scale
# 1/32 = 1/sqrt(1024) keeps the requantized values spread over int8.
XT, XF, XS, XP, XR, XA = 256, 1024, 256, 2, 128, 2
XN = XS * XP
XSCALE = 1. / 32
XWARM, XTIMED = 2, 2
# the stateful X step: 64-frame gulps, 256 frames per integration
XST, XSINT, XSWARM, XSTIMED = 64, 256, 4, 8
XCHANNELS = (0, 511, 1023)
# FDMT dedispersion: an L-band filterbank of 4096 channels (1200-1600 MHz,
# 64 us, one pol) dedispersed to BASELINE config 3's max_dm = 100, which
# FdmtBlock sizes to a max_delay of 1970 frames; 16384-frame gulps, so the
# FDMT reads 16384 + 1970 frames per span.  Config 22's matched filter
# (8 taps) and threshold at a false-alarm rate of 1e-3 on a noise-only
# realization.  FODD channels over the same band give a plan with
# passthrough rows (an odd subband count at three of its steps).
FCH, FF0, FDF, FTSAMP, FMAXDM, FMD = 4096, 1200.0, 400.0 / 4096, 64e-6, \
    100.0, 1970
FG, FNTAP, FFAR, FWARM, FTIMED = 16384, 8, 1e-3, 2, 10
FODD = 3000
# dispersed pulses injected into the stream: (trial, frame), each FPW
# frames wide (the matched filter's width) at FAMP per channel-sample, one
# across the boundary of gulps 4 and 5.  The frame is where the pulse
# starts in the lowest channel; the FDMT's own per-channel delays put its
# peak a frame or so off that (see pulse_expect)
FPULSES = ((100, 5000), (400, 20000), (800, 40000), (1200, 60000),
           (1500, 81915), (1800, 110000), (1969, 120000), (1000, 180000))
FAMP, FPW = 3.0, 8
# the mesh tier: MD ranks that all live on cuda:0 (as the JAX package's
# tests put their 8-device meshes on one CPU).  K9 at the corner turn's
# blocks, MD x (XT / MD, XF, XS, XP, 2) int8; the stateful correlate(XT)
# on XT-frame gulps of BASELINE config 5's array under each mesh plan
# (1 warm-up and 1 timed gulp, a 2.1 GB output each); config 22's FDMT
# stream on an {'sp': 2} mesh (spans of 16384 + 1970 = 2 x 9177 frames)
MD = 4
MWARM, MTIMED = 1, 1
MFDMT = 2
# the Guppi RAW front end (examples/gpuspec_simple_torch.py): Breakthrough
# Listen's GBT L-band recording geometry, 64 coarse channels of 2.9296875
# MHz (-187.5 MHz), 2 pols, 128 MiB blocks (524,288 samples at 8 bits,
# 1,048,576 at 4), one block a gulp, r 4; 4 ci8 blocks and 2 ci4 blocks,
# the first GORACLE of each held to the float64 oracle
GCH, GFREQ, GBW, GBLOCSIZE, GR = 64, 1501.4648, -187.5, 134217728, 4
GBLOCKS = {8: 4, 4: 2}
GORACLE = 2
# the unfused detect('stokes') arm: the spectrometer arm's gulps
DWARM, DTIMED = 1, 3
# the DSP library: map and MapStage on the spectrometer arm's gulps (the
# fused map arm 1 warm-up and 3 timed gulps); the FX chain ending in
# convert_visibilities('storage') (1 warm-up and 2 timed gulps, 1.08 GB
# of storage each); a 16-tap FIR over 3 beamformer gulps, held to the
# float64 oracle on FIR_CHANNELS; Romein gridding of config 5's 32,896
# baselines (autos included) with 7 x 7 kernels onto a 1024 x 1024 grid
# for 64 channels at once (537 MB of grid), held to a float64 scatter on
# ROMEIN_ORACLE channels
PWARM, PTIMED = 1, 3
SWARM, STIMED = 1, 2
FIR_TAPS, FIR_DECIM, FIR_CHANNELS = 16, 4, (0, 171, 340, 511)
RNPTS, RKSIZE, RNGRID, RNCHAN, ROMEIN_ORACLE = XS * (XS + 1) // 2, 7, \
    1024, 64, 2
DFT_GATE = 1e-4


def log(*args):
    print(*args, flush=True)


def require(cond, what):
    if not cond:
        raise RuntimeError('chip_smoke check failed: ' + what)


def crc32(a):
    """CRC-32 of an array's bytes (C order)."""
    return zlib.crc32(memoryview(np.ascontiguousarray(a).reshape(-1)
                                 .view(np.uint8)))


def log_crc(what, outputs):
    """Log the CRC-32 of each output, so that two runs of the script (say
    one under BF_SYNC_STRICT=1) can be held to the same bytes."""
    log('crc32 %s: %s' % (what, json.dumps(outputs)))


def rel_err(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def nvidia_smi_line():
    p = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                        '--format=csv,noheader'],
                       capture_output=True, text=True, timeout=60)
    require(p.returncode == 0, 'nvidia-smi failed: %s' % p.stderr)
    return p.stdout.strip().splitlines()[0]


def cuda_ms(fn, runs=NRUNS, warm=2):
    """Median milliseconds of ``fn`` over ``runs`` launches, each
    bracketed by CUDA events."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def cuda_ms_queued(fn, calls=20, runs=5):
    """Median device milliseconds per call of ``fn`` over ``runs`` batches
    of ``calls`` back-to-back calls, each batch bracketed by CUDA events:
    what a call costs the card when calls queue, the host's preparation
    of one call hidden behind the device work of the one before."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return float(np.median(times))


def cuda_ms_graph(fn, calls=20, runs=5):
    """Median device milliseconds per call of ``fn`` from replays of a
    CUDA graph that holds ``calls`` calls: the device time of a call with
    no host time in it (a launch shorter than its host-side preparation
    keeps the card waiting even when calls queue)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms_queued(graph.replay, calls=1, runs=runs) / calls


def bound(nbyte, nops, peak_ops=PEAK_FP32_PER_S):
    """(bound_ms, bound_by) from the bytes moved once and the operations
    at the peak rate of their type (FP32 unless given)."""
    t_bytes = nbyte / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / peak_ops * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def phase_stokes(gpu_kernels):
    """K2 at the main path's shape: the four strided planes of
    view_as_real of the (T, 2, F) complex64 FFT output."""
    import torch
    T, F = NTIME, NFINE
    g = torch.Generator(device='cuda').manual_seed(2)
    x = torch.randn((T, 2, F), dtype=torch.complex64, device='cuda',
                    generator=g)
    v = torch.view_as_real(x)
    planes = (v[:, 0, :, 0], v[:, 0, :, 1], v[:, 1, :, 0], v[:, 1, :, 1])
    got = gpu_kernels.stokes_detect(*planes)
    want = gpu_kernels.stokes_detect_plain(*planes)
    torch.cuda.synchronize()
    abs_err = float((got - want).abs().max())
    rel = abs_err / float(want.abs().max())
    log('K2 stokes_detect (%d, %d): max abs err %.3g, rel %.3g'
        % (T, F, abs_err, rel))
    require(rel <= STOKES_RTOL, 'K2 disagrees with its plain version: '
            'rel %.3g' % rel)
    ms = cuda_ms(lambda: gpu_kernels.stokes_detect(*planes))
    plain_ms = cuda_ms(lambda: gpu_kernels.stokes_detect_plain(*planes))
    bms, by = bound(32 * T * F, 10 * T * F)
    log('K2 kernel %.4f ms, plain %.4f ms, bound %.4f ms (%s)'
        % (ms, plain_ms, bms, by))
    return {'name': 'stokes_detect', 'route': 'cuda',
            'source': 'bifrost_tpu_torch/csrc/stokes.cu',
            'replaces': 'bifrost_tpu/ops/pallas_kernels.py:86',
            'shape': [T, F], 'max_abs_err': abs_err, 'max_rel_err': rel,
            'ms': ms, 'kernel_ms': ms, 'plain_ms': plain_ms,
            'bound_ms': bms, 'bound_by': by, 'library_ms': None}


def library_chain(volt, rfactor):
    """The PyTorch library chain the kernel replaces (yardstick only):
    cuFFT through torch.fft.fft, then Stokes and the reduce."""
    import torch
    s = torch.fft.fft(torch.view_as_complex(volt.float()), dim=-1)
    x, y = s[:, 0], s[:, 1]
    xx, yy = x.abs().square(), y.abs().square()
    xy = x * y.conj()
    st = torch.stack([xx + yy, xx - yy, 2 * xy.real, -2 * xy.imag], dim=1)
    return st.reshape(st.shape[0], 4, -1, rfactor).sum(-1)


def library_fft(volt):
    """cuFFT alone (yardstick only): torch.fft.fft of the already
    unpacked complex64 gulp."""
    import torch
    return torch.fft.fft(volt, dim=-1)


def spectrometer_bound(T, nfft, rfactor):
    """K1's bound: 2 B in a complex sample and 16 B / rfactor out; the
    FFTs' 5 N log2 N flop and Stokes' 20 a bin."""
    nbyte = 2 * T * NPOL * nfft + 4 * 4 * T * (nfft // rfactor)
    nflop = T * NPOL * 5 * nfft * int(np.log2(nfft)) + 20 * T * nfft
    return bound(nbyte, nflop)


def spectrometer_sweep(spec):
    """Every power-of-two nfft from 4 to MAX_NFFT at small T, r 1, 4 and
    nfft, against the plain version and the float64 oracle, each through
    the kernel that its nfft picks (the per-path counter)."""
    import torch
    worst = {}
    e = 2
    while (1 << e) <= spec.MAX_NFFT:
        nfft = 1 << e
        T = 5 if nfft >= 1024 else 9
        rng = np.random.RandomState(100 + e)
        v = rng.randint(-128, 128, size=(T, NPOL, nfft, 2)).astype(np.int8)
        volt = torch.from_numpy(v).cuda()
        path = spec.kernel_path(nfft)
        for rfactor in sorted({1, min(4, nfft), nfft}):
            before = spec.launches_by_path[path]
            got = spec.fused_spectrometer(volt, rfactor=rfactor)
            plain = spec.spectrometer_plain(volt, rfactor)
            torch.cuda.synchronize()
            require(spec.launches_by_path[path] == before + 1,
                    'K1 at nfft %d did not take the %s kernel' % (nfft, path))
            got = got.cpu().numpy()
            r_oracle = rel_err(got, spec.spectrometer_oracle(v, rfactor))
            r_plain = rel_err(got, plain.cpu().numpy())
            require(r_oracle < GATE and r_plain < GATE,
                    'K1 at nfft %d, r %d: rel %.3g of the oracle, %.3g of '
                    'the plain version' % (nfft, rfactor, r_oracle, r_plain))
            worst[nfft] = max(worst.get(nfft, 0.0), r_oracle)
        e += 1
    log('K1 sweep, nfft 4 to %d at r 1, 4 and nfft, worst rel to the '
        'oracle by nfft: %s' % (spec.MAX_NFFT, json.dumps(
            {str(k): float('%.3g' % v) for k, v in worst.items()})))
    return worst


def spectrometer_by_nfft(spec, nffts=(1024, 2048, 8192)):
    """K1 and cuFFT alone at other nfft, T chosen so a gulp holds the
    main path's samples."""
    import torch
    out = {}
    for nfft in nffts:
        T = NTIME * NFINE // nfft
        g = torch.Generator(device='cuda').manual_seed(nfft)
        volt = torch.randint(-128, 128, (T, NPOL, nfft, 2), dtype=torch.int8,
                             device='cuda', generator=g)
        run = lambda: spec.fused_spectrometer(volt, rfactor=RFACTOR)
        unpacked = torch.view_as_complex(volt.float())
        bms, by = spectrometer_bound(T, nfft, RFACTOR)
        out[nfft] = {'shape': [T, NPOL, nfft, 2], 'ms': cuda_ms(run),
                     'ms_queued': cuda_ms_queued(run),
                     'library_fft_ms': cuda_ms_queued(
                         lambda: library_fft(unpacked)),
                     'bound_ms': bms, 'bound_by': by}
        del volt, unpacked
        torch.cuda.empty_cache()
    log('K1 by nfft (gulps of %d samples, r %d): %s'
        % (NTIME * NFINE, RFACTOR, json.dumps(out)))
    return out


def phase_spectrometer(spec):
    import torch
    # the accuracy gate, against the float64 oracle
    rng = np.random.RandomState(11)
    small = rng.randint(-64, 64, size=(ORACLE_NTIME, NPOL, NFINE, 2)) \
        .astype(np.int8)
    got = spec.fused_spectrometer(torch.from_numpy(small).cuda(),
                                  rfactor=RFACTOR).cpu().numpy()
    oracle_rel = rel_err(got, spec.spectrometer_oracle(small, RFACTOR))
    log('K1 fused_spectrometer vs float64 oracle (T=%d): rel %.3g'
        % (ORACLE_NTIME, oracle_rel))
    require(oracle_rel < GATE, 'K1 fails the 1e-5 oracle gate: %.3g'
            % oracle_rel)
    sweep = spectrometer_sweep(spec)
    # full width, against the plain version
    g = torch.Generator(device='cuda').manual_seed(3)
    volt = torch.randint(-64, 64, (NTIME, NPOL, NFINE, 2),
                         dtype=torch.int8, device='cuda', generator=g)
    got = spec.fused_spectrometer(volt, rfactor=RFACTOR)
    want = spec.spectrometer_plain(volt, RFACTOR)
    torch.cuda.synchronize()
    abs_err = float((got - want).abs().max())
    rel = abs_err / float(want.abs().max())
    log('K1 full width vs plain: max abs err %.4g, rel %.3g'
        % (abs_err, rel))
    require(rel < GATE, 'K1 disagrees with its plain version: %.3g' % rel)
    del got, want
    run = lambda: spec.fused_spectrometer(volt, rfactor=RFACTOR)
    plain = lambda: spec.spectrometer_plain(volt, RFACTOR)
    chain = lambda: library_chain(volt, RFACTOR)
    unpacked = torch.view_as_complex(volt.float())
    fft = lambda: library_fft(unpacked)
    ms = cuda_ms(run)
    plain_ms = cuda_ms(plain)
    library_ms = cuda_ms(chain)
    queued = {'kernel': cuda_ms_queued(run),
              'plain': cuda_ms_queued(plain, calls=5, runs=3),
              'library': cuda_ms_queued(chain, calls=5, runs=3),
              'library_fft': cuda_ms_queued(fft)}
    library_fft_ms = cuda_ms(fft)
    del unpacked
    bms, by = spectrometer_bound(NTIME, NFINE, RFACTOR)
    log('K1 kernel %.4f ms (queued %.4f), plain %.4f ms, torch chain %.4f '
        'ms, cuFFT alone %.4f ms (queued %.4f), bound %.4f ms (%s)'
        % (ms, queued['kernel'], plain_ms, library_ms, library_fft_ms,
           queued['library_fft'], bms, by))
    torch.cuda.empty_cache()
    by_nfft = spectrometer_by_nfft(spec)
    return {'name': 'fused_spectrometer', 'route': 'cuda',
            'source': 'bifrost_tpu_torch/csrc/spectrometer.cu',
            'replaces': 'bifrost_tpu/ops/spectrometer.py:341',
            'shape': [NTIME, NPOL, NFINE, 2], 'rfactor': RFACTOR,
            'kernel_path': spec.kernel_path(NFINE),
            'oracle_rel_err': oracle_rel, 'max_abs_err': abs_err,
            'max_rel_err': rel, 'ms': ms, 'kernel_ms': ms,
            'plain_ms': plain_ms, 'bound_ms': bms, 'bound_by': by,
            'library_ms': library_ms,
            'library': 'torch fft -> Stokes -> sum chain',
            'library_fft_ms': library_fft_ms, 'ms_queued': queued,
            'ms_queued_per': 'launch (median of batches of queued calls: '
                             '5 x 20; plain and chain 3 x 5)',
            'by_nfft': by_nfft,
            'sweep_oracle_rel_err': {str(k): v for k, v in sweep.items()}}


def make_gulps(seed=5, n=2):
    """``n`` full-width ci8 gulps in host memory, as (T, 2, nfft, 2)
    int8 (re, im) pairs."""
    rng = np.random.default_rng(seed)
    return [rng.integers(-64, 64, size=(NTIME, NPOL, NFINE, 2),
                         dtype=np.int8) for _ in range(n)]


def drive(bt, gulps, header, chain, nwarm=NWARM, ntimed=NTIMED, per_out=1,
          scope=None, digest=False, keep_first=False):
    """Drive source -> copy('cuda') -> chain -> copy('system') -> sink.
    ``gulps`` are int8 arrays of one gulp's ci8 bytes each, sent in turn
    (the gulp's frame count is ``gulps[0].shape[0]``); ``chain(h2d)``
    builds the device blocks and returns [(role, block), ...], the last
    one feeding the D2H copy, which sends one output span per ``per_out``
    gulps.  ``scope`` holds Pipeline tunables (``sync_strict``,
    ``gulp_batch``, ``donate``, ``segments``).  Returns (outputs {output
    index: array} of outputs 0, 1 and the last, seconds of the timed
    gulps, per-block host milliseconds per logical gulp).  With
    ``digest`` the sink keeps no copy: the outputs are the CRC-32 of
    every output's bytes, and the sink's ``process`` excludes the time
    of the CRC (kept as ``digest``); ``keep_first`` also keeps output 0
    as an array, under the key 'first'."""
    ngulp = nwarm + ntimed
    nout = ngulp // per_out
    first = nwarm // per_out - 1
    ntime = gulps[0].shape[0]

    class Source(bt.SourceBlock):
        def __init__(self):
            super(Source, self).__init__(['voltages'], ntime,
                                         space='system')
            self.count = 0

        def create_reader(self, name):
            return contextlib.nullcontext()

        def on_sequence(self, reader, name):
            return [json.loads(json.dumps(header))]

        def on_data(self, reader, ospans):
            if self.count == ngulp:
                return [0]
            # copy as int8: numpy copies structured (ci8) arrays
            # element by element, some 40x slower than a memcpy
            dst = ospans[0].data.as_numpy().view(np.int8)
            dst[...] = gulps[self.count % len(gulps)].reshape(dst.shape)
            self.count += 1
            return [ntime]

    class Sink(bt.SinkBlock):
        keep = (0, 1, nout - 1)

        def __init__(self, iring):
            super(Sink, self).__init__(iring)
            self.n = 0
            self.t0 = self.t1 = None
            self.out = {}
            self.digest_s = 0.0

        def on_sequence(self, iseq):
            pass

        def on_data(self, ispan):
            # host bytes here mean the device work of this gulp is done
            if self.n == first:
                self.t0 = time.perf_counter()
            elif self.n == nout - 1:
                self.t1 = time.perf_counter()
            if digest:
                t = time.perf_counter()
                self.out[self.n] = zlib.crc32(memoryview(
                    ispan.data.as_numpy().reshape(-1).view(np.uint8)))
                if keep_first and self.n == 0:
                    self.out['first'] = np.array(ispan.data.as_numpy(),
                                                 copy=True)
                self.digest_s += time.perf_counter() - t
            elif self.n in self.keep:
                self.out[self.n] = np.array(ispan.data.as_numpy(),
                                            copy=True)
            self.n += 1

    with bt.Pipeline(**(scope or {})) as p:
        src = Source()
        h2d = bt.blocks.copy(src, space='cuda')
        blocks = chain(h2d)
        d2h = bt.blocks.copy(blocks[-1][1], space='system')
        sink = Sink(d2h)
        p.run()
    require(sink.n == nout, 'sink received %d of %d outputs'
            % (sink.n, nout))
    per_gulp = {}
    for role, blk in [('source', src), ('h2d', h2d)] + blocks + \
            [('d2h', d2h), ('sink', sink)]:
        tot = blk.perf_totals
        per_gulp[role] = {k: tot[k] / max(tot['nlogical'], 1) * 1e3
                          for k in ('acquire', 'reserve', 'process')}
    if digest:
        per_gulp['sink']['digest'] = sink.digest_s / max(sink.n, 1) * 1e3
        per_gulp['sink']['process'] -= per_gulp['sink']['digest']
    else:
        log_crc('drive outputs', {k: crc32(a) for k, a in sink.out.items()})
    return sink.out, sink.t1 - sink.t0, per_gulp


def run_pipeline(bt, gulps, substitute):
    """The spectrometer chain: ``gulps`` are (T, 2, nfft, 2) int8 arrays.
    Returns (outputs, Msamples/s, impl_info, per-block host ms/gulp)."""
    from bifrost_tpu_torch.stages import FftStage, DetectStage, ReduceStage
    nfine = gulps[0].shape[2]
    header = spec_header(nfine)
    blocks = []

    def chain(h2d):
        blocks.append(('fused', bt.blocks.fused(
            h2d, [FftStage('fine_time', axis_labels='freq'),
                  DetectStage('stokes', axis='pol'),
                  ReduceStage('freq', RFACTOR)], substitute=substitute)))
        return blocks

    out, secs, per_gulp = drive(bt, gulps, header, chain)
    msps = NTIMED * NTIME * NPOL * nfine / secs / 1e6
    return out, msps, blocks[0][1].impl_info, per_gulp


def zero_counts(spec, gpu_kernels):
    spec.launches = 0
    for counts in (spec.launches_by_path, gpu_kernels.launches):
        for k in counts:
            counts[k] = 0


def read_counts(spec, gpu_kernels):
    return dict(gpu_kernels.launches, fused_spectrometer=spec.launches,
                **{'fused_spectrometer_' + k: n
                   for k, n in spec.launches_by_path.items()})


def log_per_gulp(per_gulp):
    for role, t in per_gulp.items():
        log('  %-6s host ms/gulp: acquire %.2f reserve %.2f process %.2f'
            % (role, t['acquire'], t['reserve'], t['process']))


def phase_pipeline(bt, spec, gpu_kernels, smi):
    volts = make_gulps()
    runs = {}
    for substitute in (True, False):
        zero_counts(spec, gpu_kernels)
        out, msps, info, per_gulp = run_pipeline(bt, volts, substitute)
        counts = read_counts(spec, gpu_kernels)
        log('pipeline substitute=%s: impl %s, launches %s, %.1f Msamples/s '
            '(%s)' % (substitute, info, counts, msps, smi))
        log_per_gulp(per_gulp)
        runs[substitute] = (out, msps, info, counts)
    ngulp = NWARM + NTIMED
    out_k1, msps_k1, info_k1, n_k1 = runs[True]
    out_k2, msps_k2, info_k2, n_k2 = runs[False]
    require(info_k1.get('impl') == 'cuda-spectrometer' and
            info_k1.get('kernel') == 'cuda',
            'substituted run did not plan the CUDA spectrometer: %s'
            % info_k1)
    require(info_k2.get('impl') == 'torch-fused',
            'unsubstituted run planned %s' % info_k2)
    require(n_k1['fused_spectrometer'] >= ngulp,
            'K1 launched %d times for %d gulps'
            % (n_k1['fused_spectrometer'], ngulp))
    require(n_k1['fused_spectrometer_radix16'] ==
            n_k1['fused_spectrometer'],
            'K1 took the radix-16 kernel in %d of %d launches'
            % (n_k1['fused_spectrometer_radix16'],
               n_k1['fused_spectrometer']))
    require(n_k2['stokes_detect'] >= ngulp,
            'K2 launched %d times for %d gulps'
            % (n_k2['stokes_detect'], ngulp))
    for k in out_k1:
        a, b = out_k1[k], out_k2[k]
        require(a.shape == (NTIME, 4, NFINE // RFACTOR) and
                np.isfinite(a).all() and np.isfinite(b).all(),
                'gulp %d: bad shape or non-finite output' % k)
        r = rel_err(a, b)
        log('gulp %d: K1 path vs K2 path rel %.3g' % (k, r))
        require(r < GATE, 'the two paths disagree on gulp %d: %.3g'
                % (k, r))
        rows = [0, 1, NTIME // 2, NTIME - 1]
        v = volts[k % len(volts)][rows]
        want = spec.spectrometer_oracle(v, RFACTOR)
        for out in (a, b):
            r = rel_err(out[rows], want)
            require(r < GATE, 'gulp %d rows vs oracle: %.3g' % (k, r))
    return {'msps_cuda_spectrometer': msps_k1, 'msps_torch_fused': msps_k2,
            'launches_k1_run': n_k1, 'launches_k2_run': n_k2}


# ---------------------------------------------------------------------------
# the Guppi RAW front end: the north star's chain, file to file
# ---------------------------------------------------------------------------

def guppi_header(nbits, block, nchan=GCH, blocsize=GBLOCSIZE):
    """A GUPPI block header at Breakthrough Listen's GBT L-band recording
    geometry (64 coarse channels of 2.9296875 MHz, negative bandwidth as
    the GBT writes it)."""
    return {'BACKEND': 'GUPPI', 'TELESCOP': 'GBT', 'SRC_NAME': 'HIP65057',
            'OBSFREQ': GFREQ, 'OBSBW': GBW, 'OBSNCHAN': nchan, 'NPOL': 4,
            'NBITS': nbits, 'BLOCSIZE': blocsize, 'DIRECTIO': 0,
            'STT_IMJD': 58000, 'STT_SMJD': 43200, 'PKTSIZE': 8192,
            'PKTIDX': block * (blocsize // 8192), 'RA': 199.9, 'DEC': -1.5,
            'AZ': 130.5, 'ZA': 40.25, 'CHAN_DM': 0.0}


def guppi_tone_bins(nchan, ntime):
    """One tone per coarse channel, each at its own fine bin."""
    return (ntime // 7 + 7919 * np.arange(nchan)) % ntime


def write_guppi(path, nbits, nblock, nchan=GCH, blocsize=GBLOCSIZE,
                seed=31):
    """Write a GUPPI RAW file of ``nblock`` blocks of seeded uniform noise
    plus, in pol 0, one tone per channel at guppi_tone_bins; returns the
    (nchan, ntime, 2, 2) int8 samples of the first GORACLE blocks."""
    from bifrost_tpu_torch.io import guppi as guppi_io
    ntime = blocsize * 8 // (nchan * NPOL * 2 * nbits)
    amp, noise = (40, 20) if nbits == 8 else (4, 3)
    t = np.arange(ntime)
    ph = 2 * np.pi * np.outer(guppi_tone_bins(nchan, ntime), t) / ntime
    tone_re = np.round(amp * np.cos(ph)).astype(np.int8)
    tone_im = np.round(amp * np.sin(ph)).astype(np.int8)
    del ph
    rng = np.random.default_rng(seed)
    kept = []
    with open(path, 'wb') as f:
        for b in range(nblock):
            v = rng.integers(-noise, noise + 1, size=(nchan, ntime, NPOL, 2),
                             dtype=np.int8)
            v[:, :, 0, 0] += tone_re
            v[:, :, 0, 1] += tone_im
            guppi_io.write_header(f, guppi_header(nbits, b, nchan,
                                                  blocsize))
            if nbits == 8:
                f.write(v.tobytes())
            else:
                u = v.view(np.uint8)
                f.write((((u[..., 0] & 15) << 4) | (u[..., 1] & 15))
                        .astype(np.uint8).tobytes())
            if b < GORACLE:
                kept.append(v)
    return kept


def guppi_oracle(spec, v, rfactor, nthread=8):
    """float64 numpy oracle of the chain on one block: (nchan, ntime, 2,
    2) int8 -> the .fil frame (4, nchan * ntime / r), coarse channel
    major, by ``spectrometer_oracle`` per channel (chunks of channels in
    a thread pool: numpy's FFT releases the GIL)."""
    from concurrent.futures import ThreadPoolExecutor
    nchan = v.shape[0]
    chunk = max(nchan // nthread, 1)

    def one(c0):
        x = np.ascontiguousarray(v[c0:c0 + chunk].transpose(0, 2, 1, 3))
        return spec.spectrometer_oracle(x, rfactor)
    with ThreadPoolExecutor(nthread) as pool:
        st = np.concatenate(list(pool.map(one, range(0, nchan, chunk))))
    return st.transpose(1, 0, 2).reshape(4, -1)


def fil_expect(nbits, nchan=GCH, blocsize=GBLOCSIZE, rfactor=GR):
    """The .fil header fields that the Guppi header gives."""
    ntime = blocsize * 8 // (nchan * NPOL * 2 * nbits)
    df = GBW / nchan
    return {'nchans': nchan * ntime // rfactor, 'nifs': 4, 'nbits': 32,
            'fch1': GFREQ - 0.5 * (nchan - 1) * df,
            'foff': df * rfactor / ntime,
            'tsamp': ntime / abs(df * 1e6),
            'tstart': 58000 + 43200 / 86400.}


def check_ci4_devrep(bt, path, v):
    """The device representation of the file's first ci4 block, unpacked
    on the card, against a numpy unpacking of the same bytes, bit for
    bit, and packed back to the same bytes."""
    from bifrost_tpu_torch import devrep
    from bifrost_tpu_torch.dtype import ci4
    from bifrost_tpu_torch.io import guppi as guppi_io
    with open(path, 'rb') as f:
        h = guppi_io.read_header(f)
        raw = np.frombuffer(f.read(h['BLOCSIZE']), np.uint8)
    s = raw.view(np.int8)
    want = np.stack([s >> 4, (raw << 4).view(np.int8) >> 4], axis=-1)
    got = devrep.to_device_rep(raw.view(ci4), 'ci4')
    require(got.device.type == bt.device.get_device().type,
            'the ci4 block did not reach the device')
    require(np.array_equal(got.cpu().numpy(), want),
            'ci4 device representation differs from the numpy unpacking')
    require(np.array_equal(want.reshape(v.shape), v),
            'the ci4 file does not hold the samples written')
    back = np.zeros(raw.shape, np.uint8)
    devrep.from_device_rep(got, 'ci4', back)
    require(back.tobytes() == raw.tobytes(),
            'ci4 bytes do not survive the device round trip')
    log('guppi-ci4: device representation of block 0 (%d bytes) equal to '
        'the numpy unpacking, bit for bit, and packs back to the same '
        'bytes' % raw.size)


def run_guppi_arm(bt, spec, gpu_kernels, nbits, nblock, tmp,
                  nchan=GCH, blocsize=GBLOCSIZE, rfactor=GR):
    """Write a GUPPI file, run examples/gpuspec_simple_torch.build() over
    it with gulp_nframe 1 and check the .fil: header fields, the float64
    oracle on the first GORACLE blocks, every tone at its bin."""
    import importlib.util
    from bifrost_tpu_torch.io import sigproc as sigproc_io
    arm = 'guppi-ci%d' % nbits
    here = os.path.dirname(os.path.abspath(__file__))
    mod = importlib.util.spec_from_file_location(
        'gpuspec_simple_torch',
        os.path.join(here, 'examples', 'gpuspec_simple_torch.py'))
    example = importlib.util.module_from_spec(mod)
    mod.loader.exec_module(example)
    ntime = blocsize * 8 // (nchan * NPOL * 2 * nbits)
    path = os.path.join(tmp, 'bl%d.raw' % nbits)
    t0 = time.perf_counter()
    kept = write_guppi(path, nbits, nblock, nchan, blocsize)
    t_write = time.perf_counter() - t0
    if nbits == 4:
        check_ci4_devrep(bt, path, kept[0])
    zero_counts(spec, gpu_kernels)
    with bt.Pipeline() as p:
        example.build([path], tmp, gulp_nframe=1, rfactor=rfactor)
        t0 = time.perf_counter()
        p.run()
        secs = time.perf_counter() - t0
    counts = read_counts(spec, gpu_kernels)
    msps = nblock * nchan * ntime * NPOL / secs / 1e6
    per_gulp = {}
    for blk in p.blocks:
        tot = blk.perf_totals
        per_gulp[blk.name] = {k: tot[k] / max(tot['ngulp'], 1) * 1e3
                              for k in ('acquire', 'reserve', 'process')}
    fil = path + '.fil'
    with open(fil, 'rb') as f:
        log_crc('%s .fil' % arm, zlib.crc32(f.read()))
    with sigproc_io.SigprocFile(fil) as f:
        hdr, hsize = f.header, f.header_size
    expect = fil_expect(nbits, nchan, blocsize, rfactor)
    for key, want in expect.items():
        require(np.isclose(hdr[key], want, rtol=1e-12, atol=0),
                '%s: .fil %s is %r, the Guppi header gives %r'
                % (arm, key, hdr[key], want))
    nf = expect['nchans']
    data = np.fromfile(fil, np.float32, offset=hsize)
    require(data.size == nblock * 4 * nf, '%s: .fil holds %d values, not '
            '%d' % (arm, data.size, nblock * 4 * nf))
    data = data.reshape(nblock, 4, nf)
    require(np.isfinite(data).all(), '%s: non-finite output' % arm)
    t0 = time.perf_counter()
    errs = []
    for b, v in enumerate(kept):
        want = guppi_oracle(spec, v, rfactor)
        errs.append(float(np.abs(data[b] - want).max() /
                          np.abs(want).max()))
        require(errs[-1] < GATE, '%s block %d: %.3g of the oracle '
                '(gate %g)' % (arm, b, errs[-1], GATE))
    t_oracle = time.perf_counter() - t0
    peaks = data[:, 0].reshape(nblock, nchan, -1).argmax(-1)
    bins = guppi_tone_bins(nchan, ntime) // rfactor
    require((peaks == bins[None]).all(), '%s: %d of %d tones off their bin'
            % (arm, int((peaks != bins[None]).sum()), peaks.size))
    os.remove(path)
    os.remove(fil)
    log('%s: %d blocks of %d MiB (%d channels x %d samples x 2 pols), '
        '.fil header as the Guppi header gives it, oracle rel %s (gate %g, '
        '%d blocks), all %d tones at their bins; launches %s'
        % (arm, nblock, blocsize >> 20, nchan, ntime,
           ['%.3g' % e for e in errs], GATE, len(kept), peaks.size,
           {k: n for k, n in counts.items() if n}))
    log('%s: %.1f Msamples/s of input, file to file (host-bound rate, '
        'not comparable with any bench), %.2f s for %d blocks; writing the '
        'file %.1f s, oracle %.1f s' % (arm, msps, secs, nblock, t_write,
                                       t_oracle))
    log_per_gulp(per_gulp)
    return {'nbits': nbits, 'blocks': nblock, 'ntime': ntime,
            'msps_file_to_file': msps, 'seconds': secs,
            'oracle_rel_err': errs, 'host_ms_per_gulp': per_gulp,
            'launches': {k: n for k, n in counts.items() if n}}


def phase_guppi(bt, spec, gpu_kernels):
    import tempfile
    import torch
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for nbits in (8, 4):
            out['ci%d' % nbits] = run_guppi_arm(bt, spec, gpu_kernels,
                                                nbits, GBLOCKS[nbits], tmp)
            torch.cuda.empty_cache()
    return out


def phase_detect_block(bt, spec, gpu_kernels, smi):
    """The unfused detect('stokes') block on the (time, pol, freq)
    complex64 ring that an fft block makes of the spectrometer arm's
    gulps: K2 once per gulp, every output equal to stokes_detect_plain of
    the same FFT on the card."""
    import torch
    volts = make_gulps(seed=7)
    header = {'name': 'guppi', 'time_tag': 0,
              '_tensor': {'shape': [-1, NPOL, NFINE], 'dtype': 'ci8',
                          'labels': ['time', 'pol', 'fine_time'],
                          'scales': [[0, 1]] * 3, 'units': [None] * 3}}
    blocks = []

    def chain(h2d):
        b = bt.blocks.fft(h2d, 'fine_time', axis_labels='freq')
        blocks.append(('fft', b))
        blocks.append(('detect', bt.blocks.detect(b, 'stokes')))
        return blocks

    ngulp = DWARM + DTIMED
    zero_counts(spec, gpu_kernels)
    out, secs, per_gulp = drive(bt, volts, header, chain, nwarm=DWARM,
                                ntimed=DTIMED)
    counts = read_counts(spec, gpu_kernels)
    require(counts['stokes_detect'] == ngulp,
            'detect-K2: K2 launched %d times for %d gulps'
            % (counts['stokes_detect'], ngulp))
    worst = 0.0
    dev = bt.device.get_device()
    for k, got in out.items():
        x = torch.fft.fft(torch.view_as_complex(
            torch.from_numpy(volts[k % len(volts)]).to(dev).float()), dim=-1)
        v = torch.view_as_real(x)
        want = gpu_kernels.stokes_detect_plain(
            v[:, 0, :, 0], v[:, 0, :, 1], v[:, 1, :, 0],
            v[:, 1, :, 1]).cpu().numpy()
        require(got.shape == (NTIME, 4, NFINE) and np.isfinite(got).all(),
                'detect-K2 gulp %d: bad shape or non-finite output' % k)
        worst = max(worst, rel_err(got, want))
    require(worst <= STOKES_RTOL, 'detect-K2 differs from '
            'stokes_detect_plain: rel %.3g' % worst)
    msps = DTIMED * NTIME * NPOL * NFINE / secs / 1e6
    log('detect-K2: fft -> detect(stokes) blocks, K2 launched %d times for '
        '%d gulps, outputs %s within %.3g of stokes_detect_plain; %.1f '
        'Msamples/s (%s)' % (counts['stokes_detect'], ngulp,
                             sorted(out), worst, msps, smi))
    log_per_gulp(per_gulp)
    return {'launches': counts['stokes_detect'], 'gulps': ngulp,
            'max_rel_err': worst, 'msps': msps}


def beam_weights(seed=21):
    """Random complex (P, B, S) weights of the beamformer cells."""
    rng = np.random.RandomState(seed)
    shape = (BP, BB, BS)
    return (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)


def int64_beams(wr, wi, re, im):
    """int64 oracle of K4 on numpy planes: (T, F, S) x (B, S)."""
    r, i = re.astype(np.int64), im.astype(np.int64)
    a, c = wr.astype(np.int64), wi.astype(np.int64)
    dot = lambda v, w: np.einsum('tfs,bs->tfb', v, w)
    return dot(r, a) - dot(i, c), dot(r, c) + dot(i, a)


def detect_oracle(eng, x, rfactor):
    """float64 beamform (quantized weights) -> Stokes -> frame sum of a
    (T, F, S, 2, 2) int8 numpy gulp -> (T / R, F, 4, B)."""
    wq = (eng.wr8.astype(np.float64) + 1j * eng.wi8.astype(np.float64)) \
        * eng.wscale
    volt = x[..., 0].astype(np.float64) + 1j * x[..., 1].astype(np.float64)
    y = np.einsum('tfsp,pbs->tfpb', volt, wq)
    bx, by = y[:, :, 0], y[:, :, 1]
    xx, yy = np.abs(bx) ** 2, np.abs(by) ** 2
    xy = bx * np.conj(by)
    st = np.stack([xx + yy, xx - yy, 2 * xy.real, -2 * xy.imag], axis=2)
    T, F = x.shape[:2]
    return st.reshape(T // rfactor, rfactor, F, 4, -1).sum(axis=1)


def max_abs_err(got, want):
    """max |got - want|, one slice of the leading axis at a time, so a
    full-width output needs no full-size temporary."""
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def kernel_entry(name, source, line, got, want, ms, plain_ms, nbyte, nops,
                 peak, library_ms, **extra):
    """The kernels-line entry of one kernel: the error of its output
    ``got`` against its plain version's ``want`` (``max_rel_err`` relative
    to max |want| unless the caller passes its own), its times and its
    bound."""
    abs_err = max_abs_err(got, want)
    if 'max_rel_err' not in extra:
        scale = max(float(w.abs().max()) for w in want)
        extra['max_rel_err'] = abs_err / scale if scale else abs_err
    bms, by = bound(nbyte, nops, peak)
    log('%s kernel %.4f ms, plain %.4f ms, library %s ms, bound %.4f ms '
        '(%s), max abs err vs plain %.4g'
        % (name, ms, plain_ms, library_ms, bms, by, abs_err))
    return dict({'name': name, 'route': 'cuda', 'source': source,
                 'replaces': 'bifrost_tpu/ops/pallas_kernels.py:%d' % line,
                 'max_abs_err': abs_err, 'ms': ms, 'kernel_ms': ms,
                 'plain_ms': plain_ms, 'bound_ms': bms, 'bound_by': by,
                 'library_ms': library_ms}, **extra)


def detect_sweep(gpu_kernels, ws, x, scale):
    """K6 at every R from 1 to 32 and R = T on the frames ``x`` (a cut
    of the full-width gulp), and once on a copy whose rows start 4 bytes
    off 16: each launch on the kernel ``detect_path`` names, by the
    per-path counter; the tensor-core kernel bit-identical to the plain
    version, the dp4a kernel within 1e-6."""
    import torch
    T = x.shape[0]
    flat = torch.empty(x.numel() + 16, dtype=torch.int8, device='cuda')
    off = flat[4:4 + x.numel()].view(x.shape)
    off.copy_(x)
    out = {}
    for R, xv in [(r, x) for r in (1, 2, 4, 8, 16, 32, T)] + [(8, off)]:
        path = gpu_kernels.detect_path(xv, R)
        n, m = (gpu_kernels.launches[k] for k in (
            'beamform_detect_int8', 'beamform_detect_int8_mma'))
        got = gpu_kernels.beamform_detect_int8(*ws, xv, scale, R)
        want = gpu_kernels.beamform_detect_int8_plain(*ws, xv, scale, R)
        torch.cuda.synchronize()
        require(gpu_kernels.launches['beamform_detect_int8'] == n + 1 and
                gpu_kernels.launches['beamform_detect_int8_mma'] ==
                m + (path == 'mma'),
                'K6 at R %d did not count one launch on its %s kernel'
                % (R, path))
        require(path == ('mma' if 16 % R == 0 and xv is x else 'dp4a'),
                'K6 at R %d took the %s kernel' % (R, path))
        rel = float((got - want).abs().max() / want.abs().max())
        same = bool(torch.equal(got, want))
        key = 'R%d%s' % (R, '' if xv is x else '_off16')
        out[key] = {'path': path, 'rel': rel, 'bit_identical': same}
        log('K6 sweep T=%d %s: %s kernel, rel %.3g vs plain (bit-identical:'
            ' %s)' % (T, key, path, rel, same))
        require(same if path == 'mma' else rel <= 1e-6,
                'K6 at R %d (%s kernel) disagrees with its plain version: '
                '%.3g' % (R, path, rel))
    return out


def phase_beamform_kernels(gpu_kernels, beam):
    """K4, K5 and K6 at the full-width shapes of the beamformer path, each
    against its plain version (and the oracle), timed with CUDA events."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    T, F, S, P, B, R = BT, BF, BS, BP, BB, BR
    src = 'bifrost_tpu_torch/csrc/beamform.cu'
    eng = beam.Beamformer(beam_weights(), accuracy='int8')
    g = torch.Generator(device='cuda').manual_seed(7)
    x = torch.randint(-128, 128, (T, F, S, P, 2), dtype=torch.int8,
                      device='cuda', generator=g)
    # the per-pol views BeamformStage hands the kernels (pol 0)
    re, im = x[:, :, :, 0, 0], x[:, :, :, 0, 1]
    cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    wr8, wi8 = cuda(eng.wr8[0]), cuda(eng.wi8[0])
    wr, wi = cuda(eng.wr[0]), cuda(eng.wi[0])
    # widened operands of the library yardsticks, built untimed
    w2 = cuda(beam._wide_weight_block(eng.wr8, eng.wi8)[0])
    z = torch.cat([re, im], dim=-1).reshape(T * F, 2 * S)
    # a pol's view touches every 32-byte sector of the interleaved gulp, so
    # each per-pol launch reads the whole gulp
    out_bytes = 2 * T * F * B * 4
    gulp_bytes = x.numel()
    nops = 8 * T * F * B * S

    # K4: exact int32, one int8 GEMM over every channel; both pols' views
    # of the gulp through the 16-byte staging
    k4_run = lambda: gpu_kernels.beamform_int8(wr8, wi8, re, im)
    plain4 = lambda: gpu_kernels.beamform_int8_plain(wr8, wi8, re, im)
    for p in (1, 0):
        rp, ip = x[:, :, :, p, 0], x[:, :, :, p, 1]
        n4, v4 = (gpu_kernels.launches[k] for k in ('beamform_int8',
                                                     'beamform_int8_vec16'))
        yr, yi = gpu_kernels.beamform_int8(wr8, wi8, rp, ip)
        require(gpu_kernels.launches['beamform_int8'] == n4 + 1 and
                gpu_kernels.launches['beamform_int8_vec16'] == v4 + 1,
                'K4 on the pol %d view did not take the 16-byte staging: %s'
                % (p, gpu_kernels.int8_staging(rp, ip)))
        pr, pi = gpu_kernels.beamform_int8_plain(wr8, wi8, rp, ip)
        torch.cuda.synchronize()
        require(torch.equal(yr, pr) and torch.equal(yi, pi),
                'K4 on pol %d is not bit-identical to its plain version' % p)
        if p:
            del yr, yi, pr, pi
    for f in (0, F // 2, F - 1):
        want_r, want_i = int64_beams(eng.wr8[0], eng.wi8[0],
                                     re[:, f:f + 1].cpu().numpy(),
                                     im[:, f:f + 1].cpu().numpy())
        require(np.array_equal(yr[:, f:f + 1].cpu().numpy(), want_r) and
                np.array_equal(yi[:, f:f + 1].cpu().numpy(), want_i),
                'K4 differs from the int64 oracle on channel %d' % f)
    log('K4 beamform_int8 (%d, %d, %d) x %d beams: both pols bit-identical '
        'to the plain version, pol 0 to the int64 oracle on 3 channels, '
        'both through the 16-byte staging' % (T, F, S, B))
    lib4 = lambda: torch._int_mm(z, w2)
    queued4 = {'kernel': cuda_ms_queued(k4_run),
               'plain': cuda_ms_queued(plain4, calls=5, runs=3),
               'library': cuda_ms_queued(lib4)}
    log('K4 queued (ms per call of 20 back to back): %s' % queued4)
    k4 = kernel_entry(
        'beamform_int8', src, 265, torch.complex(yr.double(), yi.double()),
        torch.complex(pr.double(), pi.double()), cuda_ms(k4_run),
        cuda_ms(plain4, runs=5),
        gulp_bytes + 2 * B * S + out_bytes, nops, PEAK_INT8_PER_S,
        cuda_ms(lib4), shape=[T, F, S, B],
        per='launch (one pol, one call bracketed)',
        staging=gpu_kernels.int8_staging(re, im),
        library='torch._int_mm of [re | im] (T*F, 2S) x widened (2S, 2B)',
        ms_queued=queued4,
        ms_queued_per='launch (median of batches of queued calls: 5 x 20; '
                      'plain 3 x 5)')
    del yr, yi, pr, pi

    # K5: bf16 products, float32 sums, one GEMM over every channel; the
    # main path's launch takes the 16-byte staging
    n5, v5 = (gpu_kernels.launches[k] for k in ('beamform_bf16',
                                                 'beamform_bf16_vec16'))
    yr, yi = gpu_kernels.beamform_bf16(wr, wi, re, im)
    require(gpu_kernels.launches['beamform_bf16'] == n5 + 1 and
            gpu_kernels.launches['beamform_bf16_vec16'] == v5 + 1,
            'K5 on the per-pol view did not take the 16-byte staging: %s'
            % (gpu_kernels.bf16_staging(re, im),))
    pr, pi = gpu_kernels.beamform_bf16_plain(wr, wi, re, im)
    torch.cuda.synchronize()
    got, want = torch.complex(yr, yi), torch.complex(pr, pi)
    rel5 = float((got - want).abs().max() / want.abs().max())
    log('K5 beamform_bf16 vs plain: rel %.3g' % rel5)
    require(rel5 <= 1e-5, 'K5 disagrees with its plain version: %.3g'
            % rel5)
    xs = (re[:, :4].double() + 1j * im[:, :4].double())
    ref = torch.einsum('tfs,bs->tfb', xs, (wr.double() + 1j * wi.double()))
    rel5o = float((got[:, :4] - ref).abs().max() / ref.abs().max())
    log('K5 vs float64 oracle (4 channels): rel %.3g' % rel5o)
    require(rel5o <= beam.BEAM_CLASSES['bf16'],
            'K5 outside the bf16 class of the oracle: %.3g' % rel5o)
    # the yardsticks: one bf16 GEMM of [re | im] against the widened block,
    # with an f32 output (K5's function) and with a bf16 output
    w2b = torch.cat([torch.cat([wr.T, wi.T], 1),
                     torch.cat([-wi.T, wr.T], 1)], 0).bfloat16()
    zb = z.bfloat16()
    k5_run = lambda: gpu_kernels.beamform_bf16(wr, wi, re, im)
    plain5 = lambda: gpu_kernels.beamform_bf16_plain(wr, wi, re, im)
    lib16 = lambda: torch.matmul(zb, w2b)
    lib32 = lambda: torch.mm(zb, w2b, out_dtype=torch.float32)
    try:
        y32 = lib32()
    except (TypeError, RuntimeError, NotImplementedError) as e:
        log('K5 yardstick: torch.mm(..., out_dtype=float32) not available '
            'on this card (%s)' % e)
        lib32 = y32 = None
    if y32 is not None:
        y32 = torch.complex(y32[:, :B], y32[:, B:]).reshape(T, F, B)
        lrel = max_abs_err(y32, want) / float(want.abs().max())
        log('K5 f32-output yardstick vs K5\'s plain version: rel %.3g'
            % lrel)
        del y32
    queued = {'kernel': cuda_ms_queued(k5_run),
              'plain': cuda_ms_queued(plain5, calls=5, runs=3),
              'library_bf16': cuda_ms_queued(lib16)}
    if lib32 is not None:
        queued['library'] = cuda_ms_queued(lib32)
    log('K5 queued (ms per call of 20 back to back): %s' % queued)
    k5 = kernel_entry(
        'beamform_bf16', src, 307, got, want, cuda_ms(k5_run),
        cuda_ms(plain5, runs=5),
        gulp_bytes + 2 * B * S * 4 + out_bytes, nops, PEAK_BF16_PER_S,
        cuda_ms(lib32) if lib32 is not None else None,
        shape=[T, F, S, B], per='launch (one pol, one call bracketed)',
        max_rel_err=rel5, oracle_rel_err=rel5o,
        staging=gpu_kernels.bf16_staging(re, im),
        library='torch.mm(out_dtype=float32) of bf16 [re | im] x widened '
                'f32 block rounded to bf16',
        library_bf16_ms=cuda_ms(lib16),
        library_bf16='bf16-output torch.matmul of the same operands',
        ms_queued=queued,
        ms_queued_per='launch (median of batches of queued calls: 5 x 20; '
                      'plain 3 x 5)')
    del yr, yi, pr, pi, got, want, zb, z
    torch.cuda.empty_cache()

    # K6: beamform -> Stokes -> frame sum, against plain and the oracle
    small = x[:BEAM_ORACLE_NTIME].cpu().numpy()
    got = beam.fused_detect(eng, torch.from_numpy(small).cuda(), R)
    orel = rel_err(got.cpu().numpy(), detect_oracle(eng, small, R))
    log('K6 beamform_detect_int8 vs float64 oracle (T=%d): rel %.3g'
        % (BEAM_ORACLE_NTIME, orel))
    require(orel < 1e-5, 'K6 fails the 1e-5 oracle gate: %.3g' % orel)
    ws = [cuda(a) for a in (eng.wr8[0], eng.wi8[0], eng.wr8[1],
                            eng.wi8[1])]
    sweep6 = detect_sweep(gpu_kernels, ws, x[:BEAM_SWEEP_NTIME],
                          eng.wscale)
    n6, m6 = (gpu_kernels.launches[k] for k in ('beamform_detect_int8',
                                                 'beamform_detect_int8_mma'))
    got = beam.fused_detect(eng, x, R)
    require(gpu_kernels.launches['beamform_detect_int8'] == n6 + 1 and
            gpu_kernels.launches['beamform_detect_int8_mma'] == m6 + 1,
            'K6 at full width did not take its tensor-core kernel (%s)'
            % gpu_kernels.detect_path(x, R))
    want = gpu_kernels.beamform_detect_int8_plain(*ws, x, eng.wscale, R)
    torch.cuda.synchronize()
    rel6 = float((got - want).abs().max() / want.abs().max())
    same6 = bool(torch.equal(got, want))
    log('K6 full width vs plain: rel %.3g (bit-identical: %s)'
        % (rel6, same6))
    require(same6, 'K6 is not bit-identical to its plain version at full '
            'width: rel %.3g' % rel6)
    chain = eng._fn('int8_wide', P)
    stages_re, stages_im = x[..., 0].transpose(2, 3), x[..., 1].transpose(2, 3)

    def library_chain6():
        y = chain(stages_re, stages_im)
        bx, by = y[:, :, 0], y[:, :, 1]
        xx, yy = bx.abs().square(), by.abs().square()
        xy = bx * by.conj()
        st = torch.stack([xx + yy, xx - yy, 2 * xy.real, -2 * xy.imag], 2)
        return st.reshape(T // R, R, F, 4, B).sum(1)

    lib6 = library_chain6()
    lrel = float((lib6 - want).abs().max() / want.abs().max())
    require(lrel < 1e-5, 'the library chain disagrees with K6: %.3g' % lrel)
    del lib6
    k6_run = lambda: beam.fused_detect(eng, x, R)
    plain6 = lambda: gpu_kernels.beamform_detect_int8_plain(
        *ws, x, eng.wscale, R)
    queued6 = {'kernel': cuda_ms_queued(k6_run),
               'plain': cuda_ms_queued(plain6, calls=2, runs=3),
               'library': cuda_ms_queued(library_chain6, calls=5, runs=3),
               'unfused_2x_k4': 2 * queued4['kernel']}
    log('K6 queued (ms per call of 20 back to back; the torch chain 3 x 5, '
        'plain 3 x 2; twice K4 as the unfused yardstick): %s' % queued6)
    k6 = kernel_entry(
        'beamform_detect_int8', src, 384, got, want, cuda_ms(k6_run),
        cuda_ms(plain6, runs=5),
        x.numel() + 4 * B * S + (T // R) * F * 4 * B * 4, 2 * nops,
        PEAK_INT8_PER_S, cuda_ms(library_chain6, runs=10),
        shape=[T, F, S, P, 2], rfactor=R, per='launch (one gulp)',
        max_rel_err=rel6, bit_identical=same6, oracle_rel_err=orel,
        path=gpu_kernels.detect_path(x, R), r_sweep=sweep6,
        library='torch chain int8_wide (torch._int_mm) -> Stokes -> '
                'frame sum',
        unfused_2x_k4='ms_queued: two K4 launches (one per pol), before '
                      'their Stokes and frame sum',
        ms_queued=queued6,
        ms_queued_per='launch (median of batches of queued calls: 5 x 20; '
                      'library 3 x 5, plain 3 x 2)')
    del got, want, x
    torch.cuda.empty_cache()
    return k4, k5, k6


def beam_gulps(seed=9, n=2):
    """``n`` full-width ci8 gulps (T, F, S, P, 2) int8 in host memory."""
    rng = np.random.default_rng(seed)
    return [rng.integers(-64, 64, size=(BT, BF, BS, BP, 2), dtype=np.int8)
            for _ in range(n)]


def run_beam_arm(bt, gulps, w, arm, **kw):
    """One arm of the beamformer pipeline; returns (outputs, seconds of
    the timed gulps, per-block host ms/gulp, the beam block).  ``kw``
    goes to drive() (``nwarm``, ``ntimed``, ``scope``, ``digest``)."""
    from bifrost_tpu_torch.stages import (BeamformStage, DetectStage,
                                          ReduceStage)
    header = {'name': 'beams', 'time_tag': 0,
              '_tensor': {'shape': [-1, BF, BS, BP], 'dtype': 'ci8',
                          'labels': ['time', 'freq', 'station', 'pol'],
                          'scales': [[0, 1]] * 4, 'units': [None] * 4}}
    accuracy, impl = {'K6': ('int8', None), 'K4': ('int8', 'pallas'),
                      'K5': ('bf16', 'pallas_bf16'), 'f32': ('f32', 'xla'),
                      'race': ('int8', None)}[arm]
    blocks = []

    def chain(h2d):
        if arm == 'K6':
            blocks.append(('beam', bt.blocks.fused(
                h2d, [BeamformStage(w, accuracy=accuracy),
                      DetectStage('stokes', axis='pol'),
                      ReduceStage('time', BR)])))
        else:
            b = bt.blocks.beamform(h2d, w, accuracy=accuracy, impl=impl)
            blocks.append(('beam', b))
            blocks.append(('detect', bt.blocks.fused(
                b, [DetectStage('stokes', axis='pol'),
                    ReduceStage('time', BR)])))
        return blocks

    out, secs, per_gulp = drive(bt, gulps, header, chain, **kw)
    return out, secs, per_gulp, blocks[0][1]


def phase_beamform_pipeline(bt, spec, gpu_kernels, beam, smi):
    gulps = beam_gulps()
    w = beam_weights()
    ngulp = NWARM + NTIMED
    nsamp = BT * BF * BS * BP
    gop = 8 * BT * BF * BP * BB * BS / 1e9
    runs, rates = {}, {}
    for arm in ('K6', 'K4', 'K5', 'f32', 'race'):
        with contextlib.ExitStack() as stack:
            if arm == 'race':
                # the engine's own race, from an empty probe cache
                stack.enter_context(race_cache())
            zero_counts(spec, gpu_kernels)
            out, secs, per_gulp, blk = run_beam_arm(bt, gulps, w, arm)
            counts = read_counts(spec, gpu_kernels)
        rates[arm] = {'msps': NTIMED * nsamp / secs / 1e6,
                      'gops': NTIMED * gop / secs}
        info = getattr(blk, 'impl_info', None)
        if info is None:
            info = {'chosen': dict(blk.engine.chosen),
                    'probe_ms': dict(blk.engine.probe_ms)}
        log('beamformer pipeline arm %s: %s, launches %s, %.1f Msamples/s, '
            '%.1f GOP/s (%s)' % (arm, info, counts, rates[arm]['msps'],
                                 rates[arm]['gops'], smi))
        log_per_gulp(per_gulp)
        runs[arm] = (out, counts, info)
        rates[arm]['per_gulp_ms'] = per_gulp
        rates[arm]['info'] = info
    info6 = runs['K6'][2]
    require(info6.get('impl') == 'cuda-beamform-detect' and
            info6.get('kernel') == 'cuda',
            'the K6 arm did not plan the CUDA beamform-detect: %s' % info6)
    for arm, name, per in (('K6', 'beamform_detect_int8', 1),
                           ('K4', 'beamform_int8', BP),
                           ('K5', 'beamform_bf16', BP)):
        n = runs[arm][1][name]
        require(n >= per * ngulp, '%s launched %d times for %d gulps'
                % (name, n, ngulp))
    for arm, name in (('K4', 'beamform_int8'), ('K5', 'beamform_bf16')):
        n = runs[arm][1]
        require(n[name + '_vec16'] == n[name],
                'the %s arm took the 16-byte staging in %d of %d launches'
                % (arm, n[name + '_vec16'], n[name]))
    n = runs['K6'][1]
    require(n['beamform_detect_int8_mma'] == n['beamform_detect_int8'],
            'the K6 arm took the tensor-core kernel in %d of %d launches'
            % (n['beamform_detect_int8_mma'], n['beamform_detect_int8']))
    race = runs['race'][2]
    for key, ms in race.get('probe_ms', {}).items():
        log('beamformer race (%s): ms per call %s; chose %s'
            % (key, ms, race['chosen'].get(key)))
    ref = runs['f32'][0]
    for k in ref:
        for arm in ('K6', 'K4', 'K5', 'f32', 'race'):
            a = runs[arm][0][k]
            require(a.shape == (BT // BR, BF, 4, BB) and
                    np.isfinite(a).all(),
                    'arm %s gulp %d: bad shape %s or non-finite output'
                    % (arm, k, a.shape))
        r46 = rel_err(runs['K4'][0][k], runs['K6'][0][k])
        bounds = {'K6': beam.BEAM_CLASSES['int8'],
                  'K4': beam.BEAM_CLASSES['int8'],
                  'K5': beam.BEAM_CLASSES['bf16'],
                  'race': beam.BEAM_CLASSES['int8']}
        rels = {arm: rel_err(runs[arm][0][k], ref[k]) for arm in bounds}
        log('gulp %d: K4 vs K6 rel %.3g; vs f32: %s'
            % (k, r46, ', '.join('%s %.3g' % kv for kv in rels.items())))
        require(r46 < 1e-5, 'K4 and K6 arms disagree on gulp %d: %.3g'
                % (k, r46))
        for arm, b in bounds.items():
            require(rels[arm] <= b, 'arm %s outside its class on gulp %d: '
                    '%.3g > %g' % (arm, k, rels[arm], b))
    return {'rates': rates,
            'launches': {arm: runs[arm][1] for arm in runs}}


_legacy_fn = {}


def legacy_probe(x):
    """K0 launched the way every wrapper launched before its C entry was
    bound once: the library looked up, argtypes and restype set, each
    pointer wrapped in a ctypes.c_void_p and a torch.cuda.Stream made, on
    every call, through a ctypes.CDLL (which releases the GIL for the
    call).  Same kernel; not counted in the launch counters.  It is timed
    beside K0 as the launch path's "before" in the same run."""
    import ctypes
    import torch
    from bifrost_tpu_torch import _build
    x = x.contiguous()
    out = torch.empty_like(x)
    _build.load('probe')
    # the library as ctypes.CDLL loads it (a call releases the GIL), with
    # its own function object: the cached binding of bf_probe stays as is
    lib = _legacy_fn.get('lib')
    if lib is None:
        lib = _legacy_fn['lib'] = ctypes.CDLL(_build._lib_path('probe')[1])
        lib.bf_error_string.argtypes = [ctypes.c_int]
        lib.bf_error_string.restype = ctypes.c_char_p
    fn = lib.bf_probe
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()),
             x.numel(), ctypes.c_void_p(
                 torch.cuda.current_stream(x.device).cuda_stream))
    _build.check(lib, err, 'legacy probe')
    return out


def phase_probe(gpu_kernels):
    """K0: available() builds and runs the probe kernel on the card once,
    and a second call answers from its cache; K0 timed beside torch.mul
    and beside its launch path before the binding cache."""
    import torch
    gpu_kernels._available_on.clear()
    before = gpu_kernels.launches['probe']
    t0 = time.perf_counter()
    ok = gpu_kernels.available()
    first_ms = (time.perf_counter() - t0) * 1e3
    require(ok is True, 'available() returned %r on the card' % (ok,))
    require(gpu_kernels.launches['probe'] == before + 1,
            'available() launched the probe %d times'
            % (gpu_kernels.launches['probe'] - before))
    require(gpu_kernels.available() is True and
            gpu_kernels.launches['probe'] == before + 1,
            'a second available() did not answer from its cache')
    x = torch.ones((8, 128), dtype=torch.float32, device='cuda')
    got = gpu_kernels.probe(x)
    want = x * 2
    torch.cuda.synchronize()
    log('K0 probe: available() True in %.1f ms (first call, one launch, '
        'library already built)' % first_ms)
    # bracketed, one call's time holds the wrapper's host time; queued (20
    # back to back), what a call costs the card while the host keeps up;
    # replayed from a CUDA graph, the device time alone
    k0_run = lambda: gpu_kernels.probe(x)
    lib0 = lambda: torch.mul(x, 2.0)
    old0 = lambda: legacy_probe(x)
    require(torch.equal(old0(), want), 'the legacy K0 launch differs')
    queued = {'kernel': cuda_ms_queued(k0_run),
              'plain': cuda_ms_queued(lambda: x * 2),
              'library': cuda_ms_queued(lib0),
              'legacy_launch': cuda_ms_queued(old0)}
    graph = {'kernel': cuda_ms_graph(k0_run), 'library': cuda_ms_graph(lib0)}
    legacy_ms = cuda_ms(old0)
    log('K0 queued (ms per call of 20 back to back): %s; device time from '
        'CUDA-graph replays: %s; the legacy launch path bracketed %.4f ms; '
        'K0 queued / torch.mul queued %.3f'
        % (queued, graph, legacy_ms, queued['kernel'] / queued['library']))
    return kernel_entry(
        'probe', 'bifrost_tpu_torch/csrc/probe.cu', 40, got, want,
        cuda_ms(k0_run), cuda_ms(lambda: x * 2),
        2 * x.numel() * 4, x.numel(), PEAK_FP32_PER_S,
        cuda_ms(lambda: torch.mul(x, 2.0)), shape=[8, 128],
        per='launch (one call bracketed)', available_first_call_ms=first_ms,
        library='torch.mul(x, 2.0)', ms_queued=queued,
        ms_queued_per='launch (median of 5 batches of 20 queued calls)',
        ms_graph=graph,
        ms_graph_per='launch (median of 5 replays of a CUDA graph of 20 '
                     'calls)', legacy_launch_ms=legacy_ms,
        legacy_launch='the same kernel through the launch path before the '
                      'binding cache (argtypes set, pointers wrapped and a '
                      'torch.cuda.Stream made on every call, the GIL '
                      'released for the call)')


def xcorr_oracle(re_i, im_i, re_j, im_j):
    """int64 oracle of vis = sum_t x_i conj(x_j) on numpy planes (..., T,
    F, n), cast to complex64 (exact below 2^24)."""
    ri, ii, rj, ij = (v.astype(np.int64) for v in (re_i, im_i, re_j, im_j))
    dot = lambda x, y: np.einsum('...tfa,...tfb->...fab', x, y)
    return (dot(ri, rj) + dot(ii, ij)).astype(np.complex64) + \
        1j * (dot(ii, rj) - dot(ri, ij)).astype(np.complex64)


def check_channels(name, got, planes):
    """``got`` (..., F, ni, nj) against the int64 oracle on XCHANNELS."""
    for f in XCHANNELS:
        sub = [p[..., f:f + 1, :].cpu().numpy() for p in planes]
        want = xcorr_oracle(*sub)
        require(np.array_equal(got[..., f:f + 1, :, :].cpu().numpy(), want),
                '%s differs from the int64 oracle on channel %d' % (name, f))


def xcorr_herm_shapes(gpu_kernels, x):
    """K7 beyond the FX gulp: x-stateful's 64-frame gulp (XST, XF, XN),
    the mesh arms' 256-frame gulp (XT, XF, XN), whose channel does not fit
    in shared memory (staged in time chunks, a tile at a time), and a
    ragged case (3 groups of 33 frames, 3 channels, 200 inputs: a tail of
    one frame past a multiple of 32) through the 16-byte and the scalar
    staging; each bit-identical to the plain version, the first and the
    ragged ones to the int64 oracle.  Returns the kernels-line fields."""
    import torch
    out = {}
    for name, T in (('x_stateful', XST), ('chunked_T256', XT)):
        re = x[:T, ..., 0].reshape(T, XF, XN)
        im = x[:T, ..., 1].reshape(T, XF, XN)
        v0 = gpu_kernels.launches['xcorr_herm_vec16']
        got = gpu_kernels.xcorr_herm(re, im)
        want = gpu_kernels.xcorr_herm_plain(re, im)
        torch.cuda.synchronize()
        require(gpu_kernels.launches['xcorr_herm_vec16'] == v0 + 1,
                'K7 at (%d, %d, %d) did not take the 16-byte staging'
                % (T, XF, XN))
        require(torch.equal(got, want), 'K7 at (%d, %d, %d) is not '
                'bit-identical to its plain version' % (T, XF, XN))
        if T == XST:
            check_channels('K7 (x-stateful)', got, (re, im, re, im))
        del got, want
        run = lambda: gpu_kernels.xcorr_herm(re, im)
        nbyte = 2 * T * XF * XN + 8 * XF * XN * XN
        out[name] = {'shape': [T, XF, XN], 'ms': cuda_ms(run),
                     'ms_queued': cuda_ms_queued(run),
                     'bound_ms': bound(nbyte, 8 * T * XF * XN * XN,
                                       PEAK_INT8_PER_S)[0]}
        log('K7 at (%d, %d, %d): bit-identical to its plain version; %s'
            % (T, XF, XN, out[name]))
    g = torch.Generator(device='cuda').manual_seed(14)
    gulp = torch.randint(-128, 128, (3 * 33, 3, 100, 2, 2), dtype=torch.int8,
                         device='cuda', generator=g)
    re = gulp[..., 0].reshape(3, 33, 3, 200)
    im = gulp[..., 1].reshape(3, 33, 3, 200)
    for layout, planes in (('16-byte', (re, im)),
                           ('scalar', (re.contiguous(), im.contiguous()))):
        v0 = gpu_kernels.launches['xcorr_herm_vec16']
        got = gpu_kernels.xcorr_herm(*planes)
        want = gpu_kernels.xcorr_herm_plain(*planes)
        torch.cuda.synchronize()
        require(gpu_kernels.launches['xcorr_herm_vec16'] - v0 ==
                (layout == '16-byte'), 'K7 (ragged) took the wrong staging')
        require(torch.equal(got, want), 'K7 (ragged, %s staging) is not '
                'bit-identical to its plain version' % layout)
        host = [p.cpu().numpy() for p in planes]
        require(np.array_equal(got.cpu().numpy(),
                               xcorr_oracle(host[0], host[1], host[0],
                                            host[1])),
                'K7 (ragged, %s staging) differs from the int64 oracle'
                % layout)
    log('K7 ragged (3, 33, 3, 200): bit-identical to its plain version and '
        'the int64 oracle through the 16-byte and the scalar staging')
    return out


def phase_xcorr_kernels(gpu_kernels):
    """K7 and K8 at the FX path's shapes, on the strided views of a ci8
    gulp, each against its plain version and the int64 oracle, timed
    beside the plain version and the complex64 einsum yardstick (the
    'xla' candidate; the int8 -> complex64 conversion is not timed)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device='cuda').manual_seed(12)
    x = torch.randint(-128, 128, (XT, XF, XS, XP, 2), dtype=torch.int8,
                      device='cuda', generator=g)
    ng = XT // XR
    re = x[..., 0].reshape(ng, XR, XF, XN)
    im = x[..., 1].reshape(ng, XR, XF, XN)
    require(re.data_ptr() == x.data_ptr(), 'the K7 planes are not views')
    before, v0 = (gpu_kernels.launches[k] for k in ('xcorr_herm',
                                                     'xcorr_herm_vec16'))
    got = gpu_kernels.xcorr_herm(re, im)
    want = gpu_kernels.xcorr_herm_plain(re, im)
    torch.cuda.synchronize()
    require(gpu_kernels.launches['xcorr_herm'] == before + 1,
            'K7 took more than one launch for the gulp')
    require(gpu_kernels.launches['xcorr_herm_vec16'] == v0 + 1,
            'K7 on the gulp views did not take the 16-byte staging')
    require(got.shape == (ng, XF, XN, XN) and got.dtype == torch.complex64,
            'K7 gave %s %s' % (tuple(got.shape), got.dtype))
    require(torch.equal(got, want), 'K7 is not bit-identical to its plain '
            'version')
    check_channels('K7', got, (re, im, re, im))
    require(bool((got.imag != 0).any()), 'K7 gave no imaginary part')
    require(torch.equal(got.imag, -got.imag.transpose(-1, -2)),
            'the imaginary part of K7 is not antisymmetric')
    log('K7 xcorr_herm (%d, %d, %d, %d) -> (%d, %d, %d, %d): bit-identical '
        'to its plain version and to the int64 oracle on channels %s, '
        'imaginary part antisymmetric'
        % (ng, XR, XF, XN, ng, XF, XN, XN, list(XCHANNELS)))
    xc = torch.complex(re.float(), im.float())
    lib = lambda: torch.einsum('...tfi,...tfj->...fij', xc, xc.conj())
    k7_run = lambda: gpu_kernels.xcorr_herm(re, im)
    queued7 = {'kernel': cuda_ms_queued(k7_run),
               'library': cuda_ms_queued(lib, calls=5, runs=3)}
    log('K7 queued (ms per call of 20 back to back; library 3 x 5): %s'
        % queued7)
    k7 = kernel_entry(
        'xcorr_herm', 'bifrost_tpu_torch/csrc/xcorr.cu', 155, got, want,
        cuda_ms(k7_run),
        cuda_ms(lambda: gpu_kernels.xcorr_herm_plain(re, im), runs=3),
        2 * XT * XF * XN + 8 * ng * XF * XN * XN, 8 * XT * XF * XN * XN,
        PEAK_INT8_PER_S, cuda_ms(lib, runs=5),
        shape=[ng, XR, XF, XN], per='launch (one gulp, one call bracketed)',
        staging=gpu_kernels.xcorr_staging(re, im),
        library="complex64 torch.einsum('tfi,tfj->fij', x, x.conj()), the "
                "'xla' candidate, conversion untimed", ms_queued=queued7,
        ms_queued_per='launch (median of 5 batches of 20 queued calls; '
                      'library 3 x 5)')
    # the card's write rate in practice: zeroing the same 4.29 GB, queued
    k7['write_ceiling_ms'] = cuda_ms_queued(lambda: got.zero_())
    k7['write_ceiling'] = "out.zero_() of K7's output, queued"
    log('K7: zeroing its output (the write ceiling) takes %.4f ms'
        % k7['write_ceiling_ms'])
    del xc, want, got
    k7.update(xcorr_herm_shapes(gpu_kernels, x))

    # K8: a 4-way station-row block against all inputs, T = 128
    sb = XS // 4
    ri = x[:XR, :, :sb, :, 0].reshape(XR, XF, sb * XP)
    ii = x[:XR, :, :sb, :, 1].reshape(XR, XF, sb * XP)
    rj = x[:XR, ..., 0].reshape(XR, XF, XN)
    ij = x[:XR, ..., 1].reshape(XR, XF, XN)
    got8, want8, path8 = xcorr_cross_checked(gpu_kernels, 'the table shape',
                                             ri, ii, rj, ij)
    require(path8['rowblock'] == 1 and path8['vec16_i'] == 1 and
            path8['vec16_j'] == 1, 'K8 at the table shape did not take the '
            'row-block jobs and the 16-byte staging: %s' % path8)
    got7 = gpu_kernels.xcorr_herm(re, im)
    require(torch.equal(got8, got7[0, :, :sb * XP, :]),
            "K8's rows differ from K7's")
    check_channels('K8', got8, (ri, ii, rj, ij))
    log('K8 xcorr_cross (%d, %d, %d) x (%d, %d, %d): bit-identical to its '
        'plain version, to the int64 oracle on channels %s and to K7\'s '
        'rows; %s' % (XR, XF, sb * XP, XR, XF, XN, list(XCHANNELS), path8))
    del got7
    xi_c = torch.complex(ri.float(), ii.float())
    xj_c = torch.complex(rj.float(), ij.float())
    lib8 = lambda: torch.einsum('tfi,tfj->fij', xi_c, xj_c.conj())
    k8_run = lambda: gpu_kernels.xcorr_cross(ri, ii, rj, ij)
    queued8 = {'kernel': cuda_ms_queued(k8_run),
               'library': cuda_ms_queued(lib8, calls=5, runs=3)}
    log('K8 queued (ms per call of 20 back to back; library 3 x 5): %s'
        % queued8)
    k8 = kernel_entry(
        'xcorr_cross', 'bifrost_tpu_torch/csrc/xcorr.cu', 199, got8, want8,
        cuda_ms(k8_run),
        cuda_ms(lambda: gpu_kernels.xcorr_cross_plain(ri, ii, rj, ij),
                runs=5),
        2 * XR * XF * (sb * XP + XN) + 8 * XF * sb * XP * XN,
        8 * XR * XF * sb * XP * XN, PEAK_INT8_PER_S, cuda_ms(lib8),
        shape=[XR, XF, sb * XP, XN], per='launch', path=path8,
        library="complex64 torch.einsum('tfi,tfj->fij', x_i, x_j.conj()), "
                "conversion untimed", ms_queued=queued8,
        ms_queued_per='launch (median of 5 batches of 20 queued calls; '
                      'library 3 x 5)')
    # the card's write rate in practice: zeroing the same 537 MB, queued
    k8['write_ceiling_ms'] = cuda_ms_queued(lambda: got8.zero_())
    k8['write_ceiling'] = "out.zero_() of K8's output, queued"
    log('K8: zeroing its output (the write ceiling) takes %.4f ms'
        % k8['write_ceiling_ms'])
    del got8, want8, xi_c, xj_c
    k8.update(xcorr_cross_shapes(gpu_kernels, x))
    del x
    torch.cuda.empty_cache()
    return k7, k8


#: K8's launch counters: launches, rows and columns through the 16-byte
#: staging, row-block jobs
K8_COUNTERS = ('xcorr_cross', 'xcorr_cross_vec16_i', 'xcorr_cross_vec16_j',
               'xcorr_cross_rowblock')


def xcorr_cross_plan(gpu_kernels, T, ni, nj):
    """1 where K8's jobs are row blocks at this shape on this card."""
    import torch
    return gpu_kernels.xcorr_cross_plan(
        T, ni, nj, gpu_kernels.smem_optin(torch.device('cuda', 0)))[0]


def xcorr_cross_checked(gpu_kernels, what, ri, ii, rj, ij):
    """One K8 launch, held bit for bit to its plain version, and the path
    it took by the counters, which must be the one xcorr_staging and
    xcorr_cross_plan give.  Returns (got, want, path)."""
    import torch
    before = [gpu_kernels.launches[k] for k in K8_COUNTERS]
    got = gpu_kernels.xcorr_cross(ri, ii, rj, ij)
    want = gpu_kernels.xcorr_cross_plain(ri, ii, rj, ij)
    torch.cuda.synchronize()
    n, vi, vj, rb = (gpu_kernels.launches[k] - b
                     for k, b in zip(K8_COUNTERS, before))
    require(n == 1, 'K8 at %s took %d launches' % (what, n))
    path = {'vec16_i': vi, 'vec16_j': vj, 'rowblock': rb}
    plan = {'vec16_i': gpu_kernels.xcorr_staging(ri, ii),
            'vec16_j': gpu_kernels.xcorr_staging(rj, ij),
            'rowblock': xcorr_cross_plan(gpu_kernels, ri.shape[-3],
                                         ri.shape[-1], rj.shape[-1])}
    require(path == plan, 'K8 at %s took %s, not the planned %s'
            % (what, path, plan))
    require(torch.equal(got, want), 'K8 at %s is not bit-identical to its '
            'plain version' % what)
    return got, want, path


def xcorr_cross_shapes(gpu_kernels, x):
    """K8 beyond the table shape: the 2-D mesh's block (128 frames, 256
    rows against 512 columns; row-block jobs) and 256 frames of 128 rows
    against 512 columns (chunked jobs), each bit-identical to its plain
    version on the planned path and timed queued beside its bound.
    Returns the kernels-line fields."""
    out = {}
    for name, T, sr in (('mesh_2d', XR, XS // 2),
                        ('chunked_T256', XT, XS // 4)):
        ri = x[:T, :, :sr, :, 0].reshape(T, XF, sr * XP)
        ii = x[:T, :, :sr, :, 1].reshape(T, XF, sr * XP)
        rj = x[:T, ..., 0].reshape(T, XF, XN)
        ij = x[:T, ..., 1].reshape(T, XF, XN)
        shape = (T, XF, sr * XP, XN)
        got, want, path = xcorr_cross_checked(gpu_kernels, str(shape), ri,
                                              ii, rj, ij)
        require(path['rowblock'] == int(name == 'mesh_2d'),
                'K8 at %s took the wrong jobs: %s' % (shape, path))
        del got, want
        nbyte = 2 * T * XF * (sr * XP + XN) + 8 * XF * sr * XP * XN
        out[name] = {'shape': list(shape), 'path': path,
                     'ms_queued': cuda_ms_queued(
                         lambda: gpu_kernels.xcorr_cross(ri, ii, rj, ij)),
                     'bound_ms': bound(nbyte, 8 * T * XF * sr * XP * XN,
                                       PEAK_INT8_PER_S)[0]}
        log('K8 at %s: bit-identical to its plain version; %s'
            % (shape, out[name]))
    return out


def fx_gulps(seed=13, n=2):
    """``n`` full-width ci8 station gulps (T, F, S, P, 2) int8 in host
    memory."""
    rng = np.random.default_rng(seed)
    return [rng.integers(-128, 128, size=(XT, XF, XS, XP, 2), dtype=np.int8)
            for _ in range(n)]


def fx_oracle(gulp):
    """The FX chain's output for one gulp as a host array (1, F, S, P, S,
    P) complex64 (:func:`fx_oracle_device`)."""
    import torch
    vis = fx_oracle_device(gulp)
    out = vis.cpu().numpy()
    del vis
    torch.cuda.empty_cache()
    return out


def fx_oracle_device(gulp):
    """The FX chain's output for one gulp, made on the card: the port's
    F step (torch.fft through fftn_dispatch) and quantize, then the X
    step in float64 products (K7's plain version) and the accumulate.
    Returns a card tensor (1, F, S, P, S, P) complex64."""
    import torch
    from bifrost_tpu_torch.ops.fft import fftn_dispatch
    from bifrost_tpu_torch.ops.gpu_kernels import xcorr_herm_plain
    from bifrost_tpu_torch.ops.quantize import quantize_tensor
    x = torch.from_numpy(gulp).cuda()
    xc = torch.complex(x[..., 0].float(), x[..., 1].float())
    q = quantize_tensor(fftn_dispatch(xc, [1]), 'ci8', XSCALE)
    del x, xc
    ng = XT // XR
    vis = xcorr_herm_plain(q[..., 0].reshape(ng, XR, XF, XN),
                           q[..., 1].reshape(ng, XR, XF, XN))
    vis = vis.reshape(ng // XA, XA, XF, XN, XN).sum(dim=1)
    del q
    return vis.reshape(ng // XA, XF, XS, XP, XS, XP)


def fx_header(labels, nframe):
    return {'name': 'fx', 'time_tag': 0, 'gulp_nframe': nframe,
            '_tensor': {'shape': [-1, XF, XS, XP], 'dtype': 'ci8',
                        'labels': labels, 'scales': [[0, 1]] * 4,
                        'units': [None] * 4}}


def run_fx_arm(bt, gulps, arm, **kw):
    """One arm of the FX correlator pipeline; returns (outputs, seconds
    of the timed gulps, per-block host ms/gulp, the X engine's choice).
    ``kw`` may set ``nwarm``, ``ntimed`` and drive()'s ``scope`` and
    ``digest``.  The blocks, and the device tensors their rings hold, are
    released before it returns: the next arm needs the card's memory."""
    blocks = []
    if arm == 'x-stateful':
        header = fx_header(['time', 'freq', 'station', 'pol'], XST)

        def chain(h2d):
            blocks.append(('correlate', bt.blocks.correlate(
                h2d, XSINT, impl='pallas')))
            return blocks
        out, secs, per_gulp = drive(bt, gulps, header, chain, XSWARM,
                                    XSTIMED, per_out=XSINT // XST)
        return out, secs, per_gulp, engine_info(blocks)
    accuracy, impl = {'fx-K7': ('int8', 'pallas'), 'fx-race': ('int8', None),
                      'fx-f32': ('f32', 'xla'),
                      'fx-storage': ('int8', 'pallas')}[arm]
    header = fx_header(['time', 'fine', 'station', 'pol'], XT)

    def chain(h2d):
        b = bt.blocks.fft(h2d, axes='fine', axis_labels='freq')
        blocks.append(('fft', b))
        b = bt.blocks.quantize(b, 'ci8', scale=XSCALE)
        blocks.append(('quantize', b))
        b = bt.blocks.correlate(b, XR, accuracy=accuracy, impl=impl,
                                fusable=True)
        blocks.append(('correlate', b))
        b = bt.blocks.accumulate(b, XA, fusable=True)
        blocks.append(('accumulate', b))
        if arm == 'fx-storage':
            # examples/fx_correlator.py's chain ends in the storage format
            blocks.append(('convert', bt.blocks.convert_visibilities(
                b, 'storage')))
        return blocks
    nwarm, ntimed = (SWARM, STIMED) if arm == 'fx-storage' else \
        (XWARM, XTIMED)
    nwarm, ntimed = kw.pop('nwarm', nwarm), kw.pop('ntimed', ntimed)
    out, secs, per_gulp = drive(bt, gulps, header, chain, nwarm, ntimed,
                                **kw)
    return out, secs, per_gulp, engine_info(blocks)


def engine_info(blocks):
    """The correlate block's engine choice; drops every block."""
    import gc
    import torch
    eng = dict(blocks)['correlate'].engine
    info = {'chosen': dict(eng.chosen), 'probe_ms': dict(eng.probe_ms)}
    del blocks[:], eng
    gc.collect()
    torch.cuda.empty_cache()
    return info


def phase_fx_pipeline(bt, spec, gpu_kernels, smi):
    import torch
    gulps = fx_gulps()
    oracle = [fx_oracle(gv) for gv in gulps]
    ngulp = XWARM + XTIMED
    nsamp = XT * XF * XS * XP
    gop = 8 * XT * XF * XN * XN / 1e9
    nbl = XS * (XS + 1) // 2 * XF
    runs, rates = {}, {}
    ref = None
    for arm in ('fx-K7', 'fx-race', 'fx-f32'):
        with contextlib.ExitStack() as stack:
            if arm == 'fx-race':
                # the engine's own gate and race from an empty probe
                # cache, asking the capability probe K0 afresh
                stack.enter_context(race_cache())
                gpu_kernels._available_on.clear()
            torch.cuda.reset_peak_memory_stats()
            zero_counts(spec, gpu_kernels)
            out, secs, per_gulp, info = run_fx_arm(bt, gulps, arm)
            counts = read_counts(spec, gpu_kernels)
        peak = torch.cuda.max_memory_allocated() / 1e9
        rates[arm] = {'msps': XTIMED * nsamp / secs / 1e6,
                      'gops': XTIMED * gop / secs,
                      'baseline_channels_per_s':
                          XTIMED * (XT // (XR * XA)) * nbl / secs,
                      'peak_device_gb': peak, 'info': info,
                      'per_gulp_ms': per_gulp}
        log('FX pipeline arm %s: %s, launches %s, %.1f Msamples/s, %.1f '
            'X-step GOP/s, %.4g baseline-channels/s, peak device memory '
            '%.1f GB (%s)' % (arm, info, counts, rates[arm]['msps'],
                              rates[arm]['gops'],
                              rates[arm]['baseline_channels_per_s'], peak,
                              smi))
        log_per_gulp(per_gulp)
        for k, a in out.items():
            require(a.shape == (1, XF, XS, XP, XS, XP) and
                    a.dtype == np.complex64 and np.isfinite(a).all(),
                    'arm %s output %d: bad shape, type or values' % (arm, k))
            if ref is None:
                require(np.array_equal(a, oracle[k % len(gulps)]),
                        'arm %s output %d differs from the oracle' % (arm, k))
            else:
                require(np.array_equal(a, ref[k]), 'arm %s output %d is '
                        'not byte-identical to the fx-K7 arm' % (arm, k))
        if ref is None:
            ref = out
        log('arm %s: outputs %s byte-identical to %s'
            % (arm, sorted(out), 'the oracle' if arm == 'fx-K7'
               else 'the fx-K7 arm (and so to the oracle)'))
        runs[arm] = counts
        del out
    require(runs['fx-K7']['xcorr_herm'] == ngulp,
            'fx-K7: %d K7 launches for %d gulps'
            % (runs['fx-K7']['xcorr_herm'], ngulp))
    require(runs['fx-race']['probe'] >= 1, 'fx-race: K0 was not asked')
    key = [k for k in rates['fx-race']['info']['probe_ms']]
    require(key and 'pallas' in rates['fx-race']['info']['probe_ms'][key[0]],
            'fx-race: K7 did not race: %s' % rates['fx-race']['info'])
    del ref
    torch.cuda.empty_cache()

    # BASELINE config 5's X step alone: the stateful block over 64-frame
    # gulps, one output per 4 gulps, held to the int64 oracle
    xgulps = [g[i * XST:(i + 1) * XST] for g in gulps
              for i in range(XT // XST)]
    torch.cuda.reset_peak_memory_stats()
    zero_counts(spec, gpu_kernels)
    out, secs, per_gulp, info = run_fx_arm(bt, xgulps, 'x-stateful')
    counts = read_counts(spec, gpu_kernels)
    peak = torch.cuda.max_memory_allocated() / 1e9
    nxg = XSWARM + XSTIMED
    per_out = XSINT // XST
    require(counts['xcorr_herm'] == nxg, 'x-stateful: %d K7 launches for %d '
            'gulps' % (counts['xcorr_herm'], nxg))
    for k, a in out.items():
        block = np.concatenate([xgulps[(k * per_out + i) % len(xgulps)]
                                for i in range(per_out)])
        re = block[..., 0].reshape(XSINT, XF, XN)
        im = block[..., 1].reshape(XSINT, XF, XN)
        rc, ic = torch.from_numpy(re).cuda(), torch.from_numpy(im).cuda()
        whole = gpu_kernels.xcorr_herm_plain(rc, ic).cpu().numpy()
        require(np.array_equal(a.reshape(XF, XN, XN), whole),
                'x-stateful output %d differs from the float64 products'
                % k)
        del rc, ic, whole
        for f in XCHANNELS:
            want = xcorr_oracle(re[:, f:f + 1], im[:, f:f + 1],
                                re[:, f:f + 1], im[:, f:f + 1])
            require(np.array_equal(a[0, f].reshape(XN, XN), want[0]),
                    'x-stateful output %d channel %d differs from the int64 '
                    'oracle' % (k, f))
        require(np.isfinite(a).all() and a.shape == (1, XF, XS, XP, XS, XP),
                'x-stateful output %d: bad shape or values' % k)
    samp = XST * XF * XS * XP
    rates['x-stateful'] = {
        'msps': XSTIMED * samp / secs / 1e6,
        'gops': XSTIMED * 8 * XST * XF * XN * XN / 1e9 / secs,
        'baseline_channels_per_s': XSTIMED // per_out * nbl / secs,
        'peak_device_gb': peak, 'per_gulp_ms': per_gulp, 'info': info}
    log('FX pipeline arm x-stateful: launches %s, %.1f Msamples/s, %.1f '
        'X-step GOP/s, %.4g baseline-channels/s, peak device memory %.1f '
        'GB; outputs %s equal the float64 products (exact) and the int64 '
        'oracle on channels %s (%s)'
        % (counts, rates['x-stateful']['msps'], rates['x-stateful']['gops'],
           rates['x-stateful']['baseline_channels_per_s'], peak, sorted(out),
           list(XCHANNELS), smi))
    log_per_gulp(per_gulp)
    runs['x-stateful'] = counts
    del out
    torch.cuda.empty_cache()
    return {'rates': rates, 'launches': runs, 'gulps': gulps,
            'oracle': oracle}


def phase_xcorr_int8(L, gpu_kernels):
    """xcorr_int8's cross family through its public entry point, as the
    station-sharded mesh plan calls it: the four 64-station row blocks of
    a T=128 ci8 cut against all inputs, K8 forced; the rows stacked equal
    the auto family's full matrix."""
    import torch
    g = torch.Generator(device='cuda').manual_seed(14)
    x = torch.randint(-128, 128, (XR, XF, XS, XP, 2), dtype=torch.int8,
                      device='cuda', generator=g)
    rj = x[..., 0].reshape(XR, XF, XN)
    ij = x[..., 1].reshape(XR, XF, XN)
    sb = XS // 4
    for k in K8_COUNTERS:
        gpu_kernels.launches[k] = 0
    rows = [L.xcorr_int8(x[:, :, b * sb:(b + 1) * sb, :, 0]
                         .reshape(XR, XF, sb * XP),
                         x[:, :, b * sb:(b + 1) * sb, :, 1]
                         .reshape(XR, XF, sb * XP), rj, ij, impl='pallas')
            for b in range(4)]
    counts = {k: gpu_kernels.launches[k] for k in K8_COUNTERS}
    n = counts['xcorr_cross']
    full = L.xcorr_int8(rj, ij, impl='pallas')
    torch.cuda.synchronize()
    require(n == 4, 'xcorr_int8 cross: %d K8 launches for 4 blocks' % n)
    require(counts['xcorr_cross_rowblock'] ==
            4 * xcorr_cross_plan(gpu_kernels, XR, sb * XP, XN),
            'xcorr_int8 cross: K8 jobs off the plan: %s' % counts)
    require(torch.equal(torch.cat(rows, dim=1), full),
            'the cross blocks differ from the auto-correlation')
    log('xcorr_int8 cross family: 4 station-row blocks (K8) equal the auto '
        'family (K7) at (%d, %d, %d); K8 counters %s' % (XR, XF, XN, counts))
    del rows, full, x
    torch.cuda.empty_cache()
    return counts


def fdmt_work(plan, T):
    """(bytes, adds) of one gulp's merge steps, from the plan's tables.
    A step reads each (row, delay) of its input state that its tables
    name once: a lo pair (rows_lo, d1) whole, a hi pair (rows_hi, d2)
    from the least shift d1 any output row reads it with; rows a table
    never names (a subband's delays past its own nd) are not read.  It
    writes its whole output once; one add per output element of a merged
    (not passthrough) subband."""
    nbyte = nadd = 0
    for st in plan._plan['steps']:
        nout, nd = st.d1.shape
        nd_in = int(max(st.d1.max(), st.d2.max())) + 1
        lo = np.unique(st.rows_lo[:, None].astype(np.int64) * nd_in + st.d1)
        merged = ~st.passthrough
        hi = (st.rows_hi[merged, None].astype(np.int64) * nd_in +
              st.d2[merged]).ravel()
        shift = np.broadcast_to(st.d1[merged], (int(merged.sum()), nd)) \
            .ravel()
        key, inv = np.unique(hi, return_inverse=True)
        least = np.full(len(key), T, np.int64)
        np.minimum.at(least, inv, shift)
        nread = len(lo) * T + int(np.maximum(T - least, 0).sum())
        nbyte += (nread + nout * nd * T) * 4
        nadd += int(merged.sum()) * nd * T
    return nbyte, nadd


def phase_fdmt_kernel(gpu_kernels, F):
    """K3 over every merge step of three plans at the full-width span
    (16384 + 1970 frames): the 4096-channel plan, a 3000-channel plan over
    the same band (passthrough rows and the rows_hi clamp) and the
    4096-channel plan with negative delays.  Each step is bit-identical to
    the plain version, the K3 core to the torch gather core, and both are
    within fdmt_gate_rtol() of a float64 reference: fdmt_numpy on the host
    for the first plan (which also holds the float64 gather core used as
    the reference of the other two and of the pipeline arms).  Times K3,
    the plain version and the gather core per gulp at the first plan."""
    import torch
    rtol = F.fdmt_gate_rtol()
    T = FG + FMD
    entry = None
    for label, nchan, sgn in (('full', FCH, 1), ('passthrough', FODD, 1),
                              ('negative', FCH, -1)):
        df = 400.0 / nchan
        neg = sgn < 0
        plan = F.Fdmt().init(nchan, FMD, FF0, df)
        g = torch.Generator(device='cuda').manual_seed(31 + nchan + sgn)
        x = torch.randn((1, nchan, T), device='cuda', generator=g)
        tabs = plan._step_tables(x.device)
        state = F._init_state(x, plan._plan['nd_init'], sgn)
        states, npass, err = [], 0, 0.0
        for t, st in zip(tabs, plan._plan['steps']):
            got = gpu_kernels.fdmt_step(state, t['d1'], t['d2'], t['pt'],
                                        sgn)
            want = gpu_kernels.fdmt_step_plain(state, t['d1'], t['d2'],
                                               t['pt'], sgn)
            err = max(err, float((got - want).abs().max()))
            require(torch.equal(got, want), 'K3 (%s plan) differs from its '
                    'plain version at a step of shape %s'
                    % (label, tuple(st.d1.shape)))
            npass += int(st.passthrough.sum())
            states.append(state)
            state = got
        k3 = state[:, 0, :FMD]
        require(torch.equal(k3, plan._core_jax(neg)(x)),
                'the K3 core (%s plan) differs from the gather core' % label)
        ref_s = None
        ref = plan._core_jax(neg)(x.double())[0]
        if label == 'full':
            t0 = time.perf_counter()
            ref_np = F.fdmt_numpy(nchan, FMD, FF0, df, x[0].cpu().numpy(),
                                  negative_delays=neg)
            ref_s = time.perf_counter() - t0
            gref = rel_err(ref.cpu().numpy(), ref_np)
            require(gref < 1e-12, 'the float64 gather core differs from '
                    'fdmt_numpy by %.3g' % gref)
        rel = float((k3[0].double() - ref).abs().max() / ref.abs().max())
        require(rel <= rtol, 'K3 (%s plan) is %.3g from the float64 '
                'reference (gate %g)' % (label, rel, rtol))
        if label == 'passthrough':
            require(npass > 0, 'the %d-channel plan has no passthrough rows'
                    % nchan)
        log('K3 fdmt_step, %s plan (%d channels, sgn %+d, %d steps, %d '
            'passthrough rows, T=%d): every step bit-identical to its plain '
            'version, K3 core bit-identical to the gather core, rel %.3g of '
            'the float64 reference%s'
            % (label, nchan, sgn, len(tabs), npass, T, rel,
               ' (fdmt_numpy on the host in %.1f s; float64 gather core on '
               'the card %.3g from it)' % (ref_s, gref) if ref_s else ''))
        if label != 'full':
            continue
        steps = list(zip(states, tabs))

        def k3_gulp():
            for s, t in steps:
                gpu_kernels.fdmt_step(s, t['d1'], t['d2'], t['pt'], sgn)

        def plain_gulp():
            for s, t in steps:
                gpu_kernels.fdmt_step_plain(s, t['d1'], t['d2'], t['pt'],
                                            sgn)

        def gather_gulp():
            for s, t in steps:
                F._torch_merge_step(s, t, sgn, T)

        ms = cuda_ms(k3_gulp)
        step_ms = [cuda_ms(lambda s=s, t=t: gpu_kernels.fdmt_step(
            s, t['d1'], t['d2'], t['pt'], sgn)) for s, t in steps]
        plain_ms = cuda_ms(plain_gulp, runs=5)
        gather_ms = cuda_ms(gather_gulp, runs=5)
        core_ms = {'pallas': cuda_ms(lambda: plan._core_pallas(neg)(x),
                                     runs=5),
                   'xla': cuda_ms(lambda: plan._core_jax(neg)(x), runs=5)}
        nbyte, nadd = fdmt_work(plan, T)
        bms, by = bound(nbyte, nadd)
        log('K3 per gulp (%d launches): kernel %.4f ms, plain %.4f ms, torch '
            'gather steps %.4f ms (several calls, no single torch call), '
            'bound %.4f ms (%s, %.4g GB); per step %s ms; whole cores '
            '(init + steps) K3 %.4f ms, gather %.4f ms'
            % (len(steps), ms, plain_ms, gather_ms, bms, by, nbyte / 1e9,
               ['%.4f' % m for m in step_ms], core_ms['pallas'],
               core_ms['xla']))
        entry = {'name': 'fdmt_step', 'route': 'cuda',
                 'source': 'bifrost_tpu_torch/csrc/fdmt.cu',
                 'replaces': 'bifrost_tpu/ops/pallas_kernels.py:459',
                 'max_abs_err': err, 'ms': ms, 'kernel_ms': ms,
                 'plain_ms': plain_ms, 'bound_ms': bms, 'bound_by': by,
                 'library_ms': None, 'yardstick_ms': gather_ms,
                 'yardstick': 'the torch gather core\'s merge steps '
                              '(several calls, no single torch call)',
                 'step_ms': step_ms, 'core_ms': core_ms,
                 'per': 'gulp (%d launches, one per merge step)'
                        % len(steps),
                 'shape': [FCH, FMD, T], 'oracle_rel_err': rel,
                 'numpy_reference_s': ref_s}
        del steps, states
    torch.cuda.empty_cache()
    return entry


@contextlib.contextmanager
def environ(**values):
    """Set (a str) or unset (None) environment variables for a block."""
    old = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


#: the probe-cache directories of the arms that race from an empty cache,
#: in the order they ran; kept until the script ends so that the monitors
#: phase reads the winners they persisted back through mprobe_report
RACE_CACHES = []


@contextlib.contextmanager
def race_cache(**values):
    """An empty ``BF_CACHE_DIR`` for an arm that races from scratch (and
    any other variables, as :func:`environ` sets them), recorded in
    :data:`RACE_CACHES` and removed when the script exits."""
    import atexit
    import shutil
    import tempfile
    d = tempfile.mkdtemp(prefix='bf_race_')
    atexit.register(shutil.rmtree, d, True)
    RACE_CACHES.append(d)
    with environ(BF_CACHE_DIR=d, **values):
        yield d


def pulse_delays(d):
    """The injection's delay of each channel for a pulse at trial ``d``:
    round(d * cff(f0, f_c) / cff(f0, f_top)) with f_c the channel's lower
    edge (config 22's injection)."""
    from bifrost_tpu_torch.ops.fdmt import _cff
    band = _cff(FF0, FF0 + FCH * FDF, -2.0)
    frac = np.array([_cff(FF0, FF0 + c * FDF, -2.0) / band
                     for c in range(FCH)])
    return np.rint(d * frac).astype(np.int64)


def fdmt_stream():
    """The seeded [freq, time] f32 noise stream of FWARM + FTIMED gulps on
    the card, and the same stream with the FPULSES injected: in channel c
    a pulse at (trial d, frame t0) adds FAMP to frames t0 + delay_c + [0,
    FPW), delay_c from pulse_delays."""
    import torch
    N = (FWARM + FTIMED) * FG
    g = torch.Generator(device='cuda').manual_seed(41)
    noise = torch.randn((FCH, N), device='cuda', generator=g)
    x = noise.clone()
    chans = torch.arange(FCH, device='cuda')[:, None]
    for d, t0 in FPULSES:
        delay = pulse_delays(d)
        idx = torch.from_numpy(t0 + delay[:, None] +
                               np.arange(FPW)[None]).to('cuda')
        require(int(idx.max()) < N, 'pulse (%d, %d) runs past the stream'
                % (d, t0))
        x[chans, idx] += FAMP
    return noise, x


def fdmt_oracle(plan, window, ntap):
    """The float64 oracle chain on one [freq, time] window: the FDMT (the
    float64 gather core, held to fdmt_numpy in phase_fdmt_kernel), then,
    with ``ntap`` > 1, the fixed-order boxcar.  Returns (max_delay,
    frames) float64 with the frames whose lookahead the window holds."""
    dm = plan._core_jax(False)(window[None].double())[0]
    n = dm.shape[-1] - (ntap - 1)
    out = dm[:, :n].clone()
    for i in range(1, ntap):
        out += dm[:, i:i + n]
    return out


def run_fdmt_arm(bt, source, chain, nout_frames, scope=None):
    """Drive source -> chain -> copy('system') -> a sink that writes every
    output span into one host array of ``nout_frames`` frames on the last
    axis.  Returns (array, output header, seconds of the FTIMED timed
    gulps at the sink, seconds from the source's first gulp to the sink's
    last, per-block host ms/gulp over each block's own gulps after its
    first FWARM, the chain's blocks).  ``scope`` holds Pipeline tunables.

    Six rings of three gulps lie between source and sink, more than the
    run's gulps: a block at the head can run a whole run ahead, and the
    sink's window then times the tail draining.  So each block's own
    steady ms/gulp is taken as well (a thread snapshots its totals when
    it has done FWARM logical gulps); the slowest block's time bounds the
    chain's rate."""
    import threading
    ngulp = FWARM + FTIMED

    class Sink(bt.SinkBlock):
        def __init__(self, iring):
            super(Sink, self).__init__(iring)
            self.n = self.off = 0
            self.t0 = self.t1 = self.out = self.header = None

        def on_sequence(self, iseq):
            self.header = iseq.header
            shape = [s for s in iseq.header['_tensor']['shape'] if s != -1]
            self.out = np.empty(shape + [nout_frames], np.float32)

        def on_data(self, ispan):
            if self.n == FWARM - 1:
                self.t0 = time.perf_counter()
            elif self.n == ngulp - 1:
                self.t1 = time.perf_counter()
            a = ispan.data.as_numpy()
            self.out[..., self.off:self.off + a.shape[-1]] = a
            self.off += a.shape[-1]
            self.n += 1

    snaps, done = {}, threading.Event()

    def running(roles):
        # the blocks that run: a compiled segment stands in for its
        # members (Pipeline(segments=...))
        return [(r, b) for r, b in roles if b in p.blocks] + \
            [('segment', s) for s in p._segments]

    def watch(roles):
        while not done.is_set():
            for role, blk in running(roles):
                if role not in snaps and \
                        blk.perf_totals['nlogical'] >= FWARM:
                    snaps[role] = dict(blk.perf_totals)
            time.sleep(5e-4)

    with bt.Pipeline(**(scope or {})) as p:
        src = source()
        h2d = bt.blocks.copy(src, space='cuda')
        blocks = chain(h2d)
        d2h = bt.blocks.copy(blocks[-1][1], space='system')
        sink = Sink(d2h)
        roles = [('source', src), ('h2d', h2d)] + blocks + \
            [('d2h', d2h), ('sink', sink)]
        watcher = threading.Thread(target=watch, args=(roles,), daemon=True)
        watcher.start()
        t_start = time.perf_counter()
        try:
            p.run()
        finally:
            done.set()
            watcher.join()
    require(sink.n == ngulp and sink.off == nout_frames,
            'the sink received %d spans and %d frames, not %d and %d'
            % (sink.n, sink.off, ngulp, nout_frames))
    log_crc('fdmt outputs', crc32(sink.out))
    per_gulp = {}
    for role, blk in running(roles):
        tot, snap = blk.perf_totals, snaps[role]
        n = tot['nlogical'] - snap['nlogical']
        require(n > 0, '%s ran no gulp after its first %d' % (role, FWARM))
        per_gulp[role] = {k: (tot[k] - snap[k]) / n * 1e3
                          for k in ('acquire', 'reserve', 'process')}
    return (sink.out, sink.header, sink.t1 - sink.t0, sink.t1 - t_start,
            per_gulp, blocks)


def freq_time_source(bt, host):
    """A source of [freq, time] f32 gulps from the host stream ``host``
    (FCH, N): freq lanes are the ring's ringlets."""
    header = {'name': 'frb', 'time_tag': 0,
              '_tensor': {'shape': [FCH, -1], 'dtype': 'f32',
                          'labels': ['freq', 'time'],
                          'scales': [[FF0, FDF], [0.0, FTSAMP]],
                          'units': ['MHz', 's']}}

    class Source(bt.SourceBlock):
        def __init__(self):
            super(Source, self).__init__(['frb'], FG, space='system')
            self.k = 0

        def create_reader(self, name):
            return contextlib.nullcontext()

        def on_sequence(self, reader, name):
            return [json.loads(json.dumps(header))]

        def on_data(self, reader, ospans):
            if self.k * FG >= host.shape[1]:
                return [0]
            ospans[0].data.as_numpy()[...] = \
                host[:, self.k * FG:(self.k + 1) * FG]
            self.k += 1
            return [FG]
    return Source


def write_filterbank(bt, path_dir, u8_tf):
    """Write the 8-bit stream ``u8_tf`` (N, 1, FCH) to <path_dir>/frb.fil
    through the port's write_sigproc block (its header code and data
    writer), from a [time, pol, freq] u8 source."""
    header = {'name': 'frb.fil', 'time_tag': 0, 'telescope': 'Parkes',
              'machine': 'FAKE', 'source_name': 'FRB_SIM', 'refdm': 0.0,
              '_tensor': {'shape': [-1, 1, FCH], 'dtype': 'u8',
                          'labels': ['time', 'pol', 'freq'],
                          'scales': [[59000 * 86400.0 - 40587 * 86400.0,
                                      FTSAMP], None, [FF0, FDF]],
                          'units': ['s', None, 'MHz']}}

    class Source(bt.SourceBlock):
        def __init__(self):
            super(Source, self).__init__(['u8'], FG, space='system')
            self.k = 0

        def create_reader(self, name):
            return contextlib.nullcontext()

        def on_sequence(self, reader, name):
            return [json.loads(json.dumps(header))]

        def on_data(self, reader, ospans):
            if self.k * FG >= u8_tf.shape[0]:
                return [0]
            ospans[0].data.as_numpy()[...] = \
                u8_tf[self.k * FG:(self.k + 1) * FG]
            self.k += 1
            return [FG]

    with bt.Pipeline() as p:
        bt.blocks.write_sigproc(Source(), path=path_dir)
        p.run()
    return os.path.join(path_dir, 'frb.fil')


def pulse_peaks(out, ntap):
    """For every injected pulse, the (trial, frame) of the largest value of
    the ``ntap``-frame box sum of ``out`` (max_delay, frames) near it.
    With ntap 1 the box sum is the boxcar the search's matched filter
    applies; an FPW-wide pulse peaks where it starts."""
    found = []
    for d, t0 in FPULSES:
        d0, d1 = max(d - 4, 0), min(d + 5, out.shape[0])
        f0, f1 = t0 - 24, t0 + 24 + ntap
        w = out[d0:d1, f0:f1].astype(np.float64)
        if ntap > 1:
            w = sum(w[:, i:w.shape[1] - ntap + 1 + i] for i in range(ntap))
        i, j = np.unravel_index(int(np.argmax(w)), w.shape)
        found.append((d0 + int(i), f0 + int(j)))
    return found


def fdmt_windows(plan, trials):
    """The frames each channel adds to output frame t of each FDMT trial
    (positive delays): [t + D[i, c], t + D[i, c] + K[i, c]] for trial
    ``trials[i]``, walked down the plan's tables from the last step (the
    lo half keeps the shift, the hi half adds d1; K is the init delay)."""
    n = len(trials)
    tr, row = np.arange(n), np.zeros(n, np.int64)
    dly, sh = np.asarray(trials, np.int64), np.zeros(n, np.int64)
    for st in reversed(plan._plan['steps']):
        a, b = st.d1[row, dly], st.d2[row, dly]
        m = ~st.passthrough[row]
        tr = np.concatenate([tr, tr[m]])
        sh = np.concatenate([sh, sh[m] + a[m]])
        dly = np.concatenate([a, b[m]])
        row = np.concatenate([st.rows_lo[row], st.rows_hi[row][m]])
    D = np.zeros((n, plan._plan['nchan']), np.int64)
    K = np.zeros_like(D)
    D[tr, row], K[tr, row] = sh, dly
    return D, K


def pulse_expect(plan):
    """For every injected pulse, {trial: frames} for the trials within 1
    of its own: the frames where the noiseless FPW-frame box sum of that
    trial's FDMT row peaks, from the plan's per-channel windows
    (fdmt_windows) over the injected frames (pulse_delays)."""
    us = np.arange(-24, 24 + FPW)
    expect = []
    for d, t0 in FPULSES:
        trials = [i for i in (d - 1, d, d + 1) if 0 <= i < FMD]
        D, K = fdmt_windows(plan, trials)
        inj = pulse_delays(d)
        lo = us[None, :, None] + D[:, None, :]
        hit = np.minimum(lo + K[:, None, :], inj + FPW - 1) - \
            np.maximum(lo, inj) + 1
        r = np.maximum(hit, 0).sum(-1)
        box = sum(r[:, j:r.shape[1] - FPW + 1 + j] for j in range(FPW))
        expect.append({i: tuple(int(t0 + u) for u in
                                us[:box.shape[1]][box[k] == box[k].max()])
                       for k, i in enumerate(trials)})
    return expect


def check_peaks(arm, found, expect):
    """Each pulse peaks within 1 trial of its own, at the very frame the
    plan's windows give for that trial (pulse_expect)."""
    for (d, t0), (fd, ft), want in zip(FPULSES, found, expect):
        require(fd in want and ft in want[fd],
                '%s: the pulse injected at trial %d, frame %d peaks at %d, '
                '%d; expected at a frame of %s' % (arm, d, t0, fd, ft, want))
    log('%s: all %d injected pulses peak within 1 trial of where they were '
        'injected, each at the frame the plan gives: %s'
        % (arm, len(FPULSES), found))


def phase_fdmt_pipeline(bt, spec, gpu_kernels, F, smi):
    """The FDMT arms through the port's Pipeline at full width (see the
    module docstring), each checked against the float64 oracle chain."""
    import tempfile
    import torch
    rtol = F.fdmt_gate_rtol()
    ngulp = FWARM + FTIMED
    N = ngulp * FG
    nsamp = FTIMED * FG * FCH
    t_setup = time.perf_counter()
    noise, x = fdmt_stream()
    plan = F.Fdmt().init(FCH, FMD, FF0, FDF)
    nsteps = len(plan._plan['steps'])
    halo = FMD + FNTAP - 1
    # where the plan's own per-channel delays put each pulse's peak: within
    # a frame of its injected frame at its own trial
    expect = pulse_expect(plan)
    offs = [[f - t0 for f in want[d]]
            for (d, t0), want in zip(FPULSES, expect)]
    require(all(abs(o) <= 1 for off in offs for o in off),
            'the plan puts a pulse more than a frame from where it was '
            'injected: %s' % offs)
    log('FDMT pulses: the plan puts each peak, at its own trial, at these '
        'frames from the injected one: %s' % offs)
    # the threshold: config 22's false-alarm rule on the noise-only
    # realization of the first span
    thr = float(np.quantile(fdmt_oracle(plan, noise[:, :FG + halo], FNTAP)
                            .cpu().numpy(), 1.0 - FFAR))
    del noise
    host = x.cpu().numpy()
    u8 = (x * 16 + 128).round().clamp(0, 255).to(torch.uint8)
    rates = {}
    log('FDMT stream: %d gulps of %d x %d f32 (%.2f GB), %d pulses, '
        'threshold %.6g at FAR %g; set-up %.1f s'
        % (ngulp, FCH, FG, host.nbytes / 1e9, len(FPULSES), thr, FFAR,
           time.perf_counter() - t_setup))
    # xfer.to_device makes a strided host span contiguous before staging
    # it: the frb source's span is FCH ringlets of FG frames
    copies = []
    for _ in range(5):
        t0 = time.perf_counter()
        np.ascontiguousarray(host[:, :FG])
        copies.append((time.perf_counter() - t0) * 1e3)
    span_copy_ms = float(np.median(copies))
    log('contiguous copy of a %d-ringlet host span (%.0f MB), as '
        'xfer.to_device makes it per frb gulp: %.2f ms (host clock, median '
        'of 5)' % (FCH, FCH * FG * 4 / 1e6, span_copy_ms))

    def report(arm, secs, secs_run, per_gulp, counts, extra):
        peak = torch.cuda.max_memory_allocated() / 1e9
        slow = max(per_gulp, key=lambda r: per_gulp[r]['process'])
        slow_ms = per_gulp[slow]['process']
        rates[arm] = dict({
            'msps': nsamp / secs / 1e6, 'seconds': secs,
            'msps_run': ngulp * FG * FCH / secs_run / 1e6,
            'seconds_run': secs_run, 'slowest_block': slow,
            'slowest_block_ms': slow_ms,
            'msps_slowest_block': FG * FCH / slow_ms / 1e3,
            'peak_device_gb': peak, 'per_gulp_ms': per_gulp,
            'launches': counts}, **extra)
        log('FDMT arm %s (Msamples/s of channel-samples of input): %.1f at '
            'the sink over the %d timed gulps, %.1f over the whole run with '
            'its start (%.2f s), %.1f at the slowest block (%s, %.2f ms of '
            'process per gulp); launches %s, peak device memory %.1f GB, '
            '%s (%s)'
            % (arm, rates[arm]['msps'], FTIMED, rates[arm]['msps_run'],
               secs_run, rates[arm]['msps_slowest_block'], slow, slow_ms,
               counts, peak, extra, smi))
        log_per_gulp(per_gulp)

    # fdmt-file: BASELINE config 3's path from an 8-bit .fil file
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = write_filterbank(bt, tmp, u8.T.contiguous().cpu().numpy()
                                .reshape(N, 1, FCH))
        write_s = time.perf_counter() - t0
        blocks = []

        def file_chain(h2d):
            b = bt.blocks.transpose(h2d, ['pol', 'freq', 'time'])
            blocks.append(('transpose', b))
            blocks.append(('fdmt', bt.blocks.fdmt(b, max_dm=FMAXDM)))
            return blocks

        with environ(BF_FDMT_IMPL='pallas'):
            torch.cuda.reset_peak_memory_stats()
            zero_counts(spec, gpu_kernels)
            out, hdr, secs, secs_run, per_gulp, _ = run_fdmt_arm(
                bt, lambda: bt.blocks.read_sigproc([path], FG), file_chain,
                N - FMD)
            counts = read_counts(spec, gpu_kernels)
    md = hdr['_tensor']['shape'][-2]
    require(md == FMD, 'fdmt(max_dm=%g) sized max_delay %d, not %d'
            % (FMAXDM, md, FMD))
    # one run of the core per gulp, and one in the block's on_sequence
    # warm-up
    require(counts['fdmt_step'] == (ngulp + 1) * nsteps,
            'fdmt-file: %d K3 launches for %d gulps and the warm-up'
            % (counts['fdmt_step'], ngulp))
    report('fdmt-file', secs, secs_run, per_gulp, counts,
           {'max_delay': md, 'file_gb': N * FCH / 1e9,
            'file_write_s': write_s, 'core': dict(blocks)['fdmt']
            .fdmt.chosen_core})
    del blocks
    # equal to the kernel phase's path (K3 core on the u8 data as f32) and
    # within the gate of the float64 oracle, span by span
    out = out[0]
    k3core = plan._core_pallas(False)
    err = scale = 0.0
    for k in range(ngulp):
        a, n = k * FG, min(FG, N - FMD - k * FG)
        win = u8[:, a:min(a + FG + FMD, N)].float()
        got = torch.from_numpy(np.ascontiguousarray(out[:, a:a + n])) \
            .to('cuda')
        require(torch.equal(got, k3core(win[None])[0, :, :n]),
                'fdmt-file span %d differs from the K3 core on its data' % k)
        ref = fdmt_oracle(plan, win, 1)[:, :n]
        err = max(err, float((got.double() - ref).abs().max()))
        scale = max(scale, float(ref.abs().max()))
    rel = err / scale
    require(rel <= rtol, 'fdmt-file is %.3g from the float64 oracle' % rel)
    log('fdmt-file: max_delay %d from max_dm %g; every span equal to the '
        'K3 core on its data and %.3g of the float64 oracle'
        % (md, FMAXDM, rel))
    check_peaks('fdmt-file', pulse_peaks(out, FPW), expect)
    rates['fdmt-file']['oracle_rel_err'] = rel
    del out, u8

    # the FRB search (config 22's chain) in three arms
    nout = N - halo
    ref_out = None
    launches = {}
    for arm, impl in (('frb-K3', 'pallas'), ('frb-race', None),
                      ('frb-torch', 'xla')):
        blocks = []

        def frb_chain(h2d):
            b = bt.blocks.fdmt_stage(h2d, max_delay=FMD)
            blocks.append(('fdmt_stage', b))
            b = bt.blocks.matched_filter(b, FNTAP)
            blocks.append(('matched_filter', b))
            blocks.append(('threshold', bt.blocks.threshold(b, thr)))
            return blocks

        with contextlib.ExitStack() as stack:
            if arm == 'frb-race':
                stack.enter_context(race_cache(BF_FDMT_IMPL=None))
            else:
                stack.enter_context(environ(BF_FDMT_IMPL=impl))
            torch.cuda.reset_peak_memory_stats()
            zero_counts(spec, gpu_kernels)
            out, hdr, secs, secs_run, per_gulp, _ = run_fdmt_arm(
                bt, freq_time_source(bt, host), frb_chain, nout)
            counts = read_counts(spec, gpu_kernels)
        eng = dict(blocks)['fdmt_stage']._stage.engine
        extra = {'core': eng.chosen_core, 'probe_ms': eng.core_probe_ms,
                 'gate_ms': eng.gate_ms, 'ncand': int(np.count_nonzero(out))}
        report(arm, secs, secs_run, per_gulp, counts, extra)
        launches[arm] = counts
        if arm == 'frb-K3':
            require(counts['fdmt_step'] == ngulp * nsteps,
                    'frb-K3: %d K3 launches for %d gulps of %d steps'
                    % (counts['fdmt_step'], ngulp, nsteps))
            ref_out = out
        else:
            require(np.array_equal(out.view(np.uint32),
                                   ref_out.view(np.uint32)),
                    '%s is not byte-identical to frb-K3' % arm)
            log('%s: output byte-identical to frb-K3' % arm)
        if arm == 'frb-race':
            require(eng.gate_ms is not None and eng.core_probe_ms and
                    'pallas' in eng.core_probe_ms,
                    'frb-race: the race did not run with K3: %s' % extra)
        del out, blocks
    # the float64 oracle chain, span by span; candidates and pulses
    err = scale = 0.0
    ncand = nwant = nmiss = nnear = 0
    chunks = []
    for k in range(ngulp):
        a, n = k * FG, min(FG, nout - k * FG)
        chunks.append((a, fdmt_oracle(plan, x[:, a:min(a + FG + halo, N)],
                                      FNTAP)[:, :n]))
    scale = max(float(r.abs().max()) for _, r in chunks)
    for a, ref in chunks:
        n = ref.shape[-1]
        got = torch.from_numpy(np.ascontiguousarray(ref_out[:, a:a + n])) \
            .to('cuda').double()
        cand, want = got != 0, ref >= thr
        both = cand & want
        if bool(both.any()):
            err = max(err, float((got - ref)[both].abs().max()))
        near = (ref - thr).abs() <= rtol * scale
        miss = cand ^ want
        require(not bool((miss & ~near).any()), 'a candidate differs from '
                'the oracle away from the threshold at span from %d' % a)
        ncand += int(cand.sum())
        nwant += int(want.sum())
        nmiss += int(miss.sum())
        nnear += int(near.sum())
    del chunks
    rel = err / scale
    require(rel <= rtol, 'the FRB arms are %.3g from the float64 oracle' % rel)
    log('FRB search: %d candidates, oracle %d; %d differ, all among the %d '
        'samples within rtol*scale of the threshold; candidates %.3g of the '
        'float64 oracle chain' % (ncand, nwant, nmiss, nnear, rel))
    check_peaks('frb arms', pulse_peaks(ref_out, 1), expect)
    del ref_out, x, host
    torch.cuda.empty_cache()
    launches['fdmt-file'] = rates['fdmt-file']['launches']
    return {'rates': rates, 'launches': launches, 'threshold': thr,
            'candidates': ncand, 'oracle_candidates': nwant,
            'candidates_differing': nmiss, 'samples_near_threshold': nnear,
            'oracle_rel_err': rel, 'strided_span_copy_ms': span_copy_ms}


def phase_ring_permute(gpu_kernels, par):
    """K9 at the corner turn's shapes on one card: MD and 3 int8 blocks of
    (XT / MD, XF, XS, XP, 2) and MD complex64 blocks whose byte count is
    not a multiple of 16, each bit-identical to its plain version; the
    whole corner turn (impl='pallas') over MD ranks of the card equal to
    the transpose oracle; K9, its plain version and torch.roll timed."""
    import torch
    g = torch.Generator(device='cuda').manual_seed(51)
    shape = (XT // MD, XF, XS, XP, 2)
    blocks = [torch.randint(-128, 128, shape, dtype=torch.int8,
                            device='cuda', generator=g) for _ in range(MD)]
    cshape = (63, 1023, 3)
    cblocks = [torch.complex(torch.randn(cshape, device='cuda', generator=g),
                             torch.randn(cshape, device='cuda', generator=g))
               for _ in range(MD)]
    nbytes_c = cblocks[0].numel() * 8
    require(nbytes_c % 16, 'the complex64 case is a multiple of 16 bytes')
    for name, bl in (('int8 D=%d' % MD, blocks), ('int8 D=3', blocks[:3]),
                     ('complex64 D=%d, %d bytes' % (MD, nbytes_c), cblocks)):
        before = gpu_kernels.launches['ring_permute']
        got = gpu_kernels.ring_permute(bl)
        want = gpu_kernels.ring_permute_plain(bl)
        torch.cuda.synchronize()
        require(gpu_kernels.launches['ring_permute'] == before + 1,
                'K9 (%s): %d launches for one hop'
                % (name, gpu_kernels.launches['ring_permute'] - before))
        D = len(bl)
        require(all(torch.equal(a, b) for a, b in zip(got, want)) and
                all(torch.equal(got[(i + 1) % D], bl[i]) for i in range(D)),
                'K9 (%s) is not bit-identical to its plain version' % name)
        log('K9 ring_permute %s of %s: bit-identical to its plain version'
            % (name, tuple(bl[0].shape)))
        del got, want
    # the corner turn of a whole gulp over MD ranks of the card
    x = torch.randint(-128, 128, (XT, XF, XS, XP, 2), dtype=torch.int8,
                      device='cuda', generator=g)
    mesh = par.create_mesh({'sp': MD}, devices=['cuda'] * MD)
    before = gpu_kernels.launches['ring_permute']
    ct = par.corner_turn(mesh, 'sp', impl='pallas', stacked=True)(x)
    torch.cuda.synchronize()
    nhop = gpu_kernels.launches['ring_permute'] - before
    fc = XF // MD
    require(nhop == MD - 1, 'the K9 corner turn made %d launches, not %d'
            % (nhop, MD - 1))
    require(ct.shape == (MD, XT, fc, XS, XP, 2) and
            all(torch.equal(ct[d], x[:, d * fc:(d + 1) * fc])
                for d in range(MD)),
            'the K9 corner turn differs from the transpose oracle')
    log('corner turn (impl=pallas) of a (%d, %d, %d, %d, 2) gulp over %d '
        'ranks of one card: %d K9 launches, equal to the transpose oracle'
        % (XT, XF, XS, XP, MD, nhop))
    del ct, x
    got = gpu_kernels.ring_permute(blocks)
    want = gpu_kernels.ring_permute_plain(blocks)
    stacked = torch.stack(blocks)
    # ms brackets one call, as for every kernel; a hop moves 537 MB in some
    # 0.2 ms, near the host's own cost of one wrapper call, so the device
    # time per call of queued calls is kept beside it as ms_queued
    hop = lambda: gpu_kernels.ring_permute(blocks)
    plain = lambda: gpu_kernels.ring_permute_plain(blocks)
    roll = lambda: torch.roll(stacked, 1, 0)
    ms, plain_ms, library_ms = cuda_ms(hop), cuda_ms(plain), cuda_ms(roll)
    queued = {'kernel': cuda_ms_queued(hop), 'plain': cuda_ms_queued(plain),
              'library': cuda_ms_queued(roll)}
    nbyte = 2 * MD * blocks[0].numel()
    entry = kernel_entry(
        'ring_permute', 'bifrost_tpu_torch/csrc/ring_permute.cu', 504,
        [b.view(torch.uint8) for b in got],
        [b.view(torch.uint8) for b in want], ms, plain_ms, nbyte, 0,
        PEAK_FP32_PER_S, library_ms, shape=[MD] + list(shape),
        per='hop (one call bracketed alone)',
        library='torch.roll(stacked, 1, 0) on the (D, ...) stack',
        error_unit='bytes', ms_queued=queued,
        ms_queued_per='hop (median of 5 batches of 20 queued calls)')
    log('K9 queued (ms per call of 20 back to back): %s' % queued)
    del got, want, stacked, blocks, cblocks
    torch.cuda.empty_cache()
    return entry


def mesh_oracle(gulp):
    """The stateful correlate(XT) output of one gulp: the single-device
    product in float64 on the card (K7's plain version), held to the int64
    oracle on XCHANNELS.  Returns a host array (1, XF, XS, XP, XS, XP)."""
    import torch
    from bifrost_tpu_torch.ops.gpu_kernels import xcorr_herm_plain
    re = gulp[..., 0].reshape(XT, XF, XN)
    im = gulp[..., 1].reshape(XT, XF, XN)
    whole = xcorr_herm_plain(torch.from_numpy(re).cuda(),
                             torch.from_numpy(im).cuda()).cpu().numpy()
    for f in XCHANNELS:
        sl = slice(f, f + 1)
        want = xcorr_oracle(re[:, sl], im[:, sl], re[:, sl], im[:, sl])
        require(np.array_equal(whole[sl], want),
                'the float64 products differ from the int64 oracle on '
                'channel %d' % f)
    torch.cuda.empty_cache()
    return whole.reshape(1, XF, XS, XP, XS, XP)


def run_mesh_arm(bt, par, gulps, axes, impl):
    """The stateful correlate(XT, accuracy='int8', impl) under
    block_scope(mesh=...) (no mesh when ``axes`` is None), the mesh's
    ranks all on cuda:0.  Returns (outputs, seconds of the timed gulps,
    per-block host ms/gulp, what the block chose)."""
    import gc
    import torch
    mesh = None
    if axes is not None:
        n = int(np.prod(list(axes.values())))
        mesh = par.create_mesh(axes, devices=['cuda'] * n)
    blocks = []

    def chain(h2d):
        with bt.block_scope(mesh=mesh):
            blocks.append(('correlate', bt.blocks.correlate(
                h2d, XT, accuracy='int8', impl=impl)))
        return blocks

    out, secs, per_gulp = drive(bt, gulps, fx_header(
        ['time', 'freq', 'station', 'pol'], XT), chain, MWARM, MTIMED)
    blk = blocks[0][1]
    info = {'plan': blk._mesh_plan if mesh is not None else None,
            'plan_probe_ms': blk.mesh_probe_ms,
            'chosen': dict(blk.engine.chosen),
            'probe_ms': dict(blk.engine.probe_ms)}
    del blocks[:], blk
    gc.collect()
    torch.cuda.empty_cache()
    return out, secs, per_gulp, info


#: the mesh correlator's arms: (name, mesh axes, environment, impl); the
#: first is the single-device run the others are held to
MESH_ARMS = (
    ('single', None, {}, 'pallas'),
    ('mesh-psum', {'sp': MD}, {'BF_XCORR_CORNER_TURN': 'off'}, 'pallas'),
    ('mesh-corner-xla', {'sp': MD}, {'BF_XCORR_CORNER_TURN': 'xla'},
     'pallas'),
    ('mesh-corner-K9', {'sp': MD}, {'BF_XCORR_CORNER_TURN': 'pallas'},
     'pallas'),
    ('mesh-2d', {'sp': 2, 'tp': 2}, {'BF_LINALG_XCORR_IMPL': 'pallas'},
     'pallas'),
    ('mesh-race', {'sp': MD}, {'BF_XCORR_CORNER_TURN': 'auto'}, None))


def phase_mesh_correlator(bt, spec, gpu_kernels, par, smi):
    """BASELINE config 5's array through copy('cuda') -> correlate(XT)
    under block_scope(mesh=...) -> copy('system'), in the arms of
    MESH_ARMS: each byte-identical to the single-device run, which equals
    the float64 products and the int64 oracle."""
    import torch
    gulps = fx_gulps(seed=17)
    oracle = [mesh_oracle(gv) for gv in gulps]
    ngulp = MWARM + MTIMED
    nsamp = XT * XF * XS * XP
    runs, rates, ref = {}, {}, None
    for arm, axes, env, impl in MESH_ARMS:
        with contextlib.ExitStack() as stack:
            stack.enter_context(environ(**dict(
                {'BF_XCORR_CORNER_TURN': None, 'BF_LINALG_XCORR_IMPL': None},
                **env)))
            if arm == 'mesh-race':
                # the plans and the engine race from an empty probe cache
                stack.enter_context(race_cache())
            torch.cuda.reset_peak_memory_stats()
            zero_counts(spec, gpu_kernels)
            for k in par.collectives:
                par.collectives[k] = 0
            out, secs, per_gulp, info = run_mesh_arm(bt, par, gulps, axes,
                                                     impl)
            counts = read_counts(spec, gpu_kernels)
            coll = dict(par.collectives)
        peak = torch.cuda.max_memory_allocated() / 1e9
        per = {k: v / float(ngulp) for k, v in counts.items() if v}
        rates[arm] = {'msps': MTIMED * nsamp / secs / 1e6, 'seconds': secs,
                      'peak_device_gb': peak, 'launches': counts,
                      'launches_per_gulp': per, 'collectives': coll,
                      'info': info, 'per_gulp_ms': per_gulp}
        log('mesh correlator arm %s (%s): plan %s, %.1f Msamples/s, launches '
            '%s (per gulp %s), collectives %s, peak device memory %s GB '
            '(%s)' % (arm, axes, info['plan'], rates[arm]['msps'], counts,
                      per, coll, peak, smi))
        if info['plan_probe_ms']:
            log('  plan race (ms per call): %s' % info['plan_probe_ms'])
        log_per_gulp(per_gulp)
        for k, a in out.items():
            require(a.shape == (1, XF, XS, XP, XS, XP) and
                    a.dtype == np.complex64 and np.isfinite(a).all(),
                    'arm %s output %d: bad shape, type or values' % (arm, k))
            if ref is None:
                require(np.array_equal(a, oracle[k % len(gulps)]),
                        'arm %s output %d differs from the float64 products'
                        % (arm, k))
            else:
                require(np.array_equal(a, ref[k]), 'arm %s output %d is not '
                        'byte-identical to the single-device run' % (arm, k))
        if ref is None:
            ref = out
        log('arm %s: outputs %s byte-identical to %s'
            % (arm, sorted(out), 'the float64 products and the int64 oracle'
               if arm == 'single' else 'the single-device run'))
        runs[arm] = counts
        del out
    want = {'single': ('xcorr_herm', ngulp),
            'mesh-psum': ('xcorr_herm', MD * ngulp),
            'mesh-corner-xla': ('xcorr_herm', MD * ngulp),
            'mesh-corner-K9': ('xcorr_herm', MD * ngulp),
            # one more: xcorr_prewarm's call at on_sequence
            'mesh-2d': ('xcorr_cross', MD * ngulp + 1)}
    for arm, (kern, n) in want.items():
        require(runs[arm][kern] == n, '%s: %d %s launches, not %d'
                % (arm, runs[arm][kern], kern, n))
    # every K8 launch of the 2-D plan (the gulps' station-row blocks and
    # the prewarm's) on row-block jobs where the plan says so
    rb = xcorr_cross_plan(gpu_kernels, XT // 2, XN // 2, XN)
    require(runs['mesh-2d']['xcorr_cross_rowblock'] ==
            rb * runs['mesh-2d']['xcorr_cross'],
            'mesh-2d: K8 jobs off the plan: %s'
            % {k: runs['mesh-2d'][k] for k in K8_COUNTERS})
    require(runs['mesh-corner-K9']['ring_permute'] == (MD - 1) * ngulp,
            'mesh-corner-K9: %d K9 launches for %d gulps'
            % (runs['mesh-corner-K9']['ring_permute'], ngulp))
    race = rates['mesh-race']['info']
    require(race['plan_probe_ms'] and 'corner:pallas' in race['plan_probe_ms'],
            'mesh-race: K9 did not race: %s' % race)
    del ref, oracle
    torch.cuda.empty_cache()
    return {'rates': rates, 'launches': runs}


def phase_fdmt_mesh(bt, spec, gpu_kernels, F, par, smi):
    """Config 22's [freq, time] stream through copy('cuda') ->
    fdmt(max_delay=FMD) -> copy('system'), K3 forced, under an {'sp':
    MFDMT} mesh of the card and without one: every span bit-identical."""
    import torch
    ngulp = FWARM + FTIMED
    N = ngulp * FG
    _, x = fdmt_stream()
    host = x.cpu().numpy()
    del x
    nsteps = len(F.Fdmt().init(FCH, FMD, FF0, FDF)._plan['steps'])
    rates, outs = {}, {}
    for arm, axes in (('fdmt-single', None), ('fdmt-mesh', {'sp': MFDMT})):
        mesh = None if axes is None else \
            par.create_mesh(axes, devices=['cuda'] * MFDMT)
        blocks = []

        def chain(h2d):
            with bt.block_scope(mesh=mesh):
                blocks.append(('fdmt', bt.blocks.fdmt(h2d, max_delay=FMD)))
            return blocks

        with environ(BF_FDMT_IMPL='pallas'):
            torch.cuda.reset_peak_memory_stats()
            zero_counts(spec, gpu_kernels)
            for k in par.collectives:
                par.collectives[k] = 0
            out, hdr, secs, secs_run, per_gulp, _ = run_fdmt_arm(
                bt, freq_time_source(bt, host), chain, N - FMD)
            counts = read_counts(spec, gpu_kernels)
            coll = dict(par.collectives)
        blk = dict(blocks)['fdmt']
        engaged = sorted(str(k) for k, fn in blk._mesh_fns.items()
                         if fn is not None)
        peak = torch.cuda.max_memory_allocated() / 1e9
        slow = max(per_gulp, key=lambda r: per_gulp[r]['process'])
        nshard = 1 if axes is None else MFDMT
        rates[arm] = {
            'msps': FTIMED * FG * FCH / secs / 1e6,
            'msps_run': ngulp * FG * FCH / secs_run / 1e6,
            'slowest_block': slow,
            'msps_slowest_block':
                FG * FCH / per_gulp[slow]['process'] / 1e3,
            'peak_device_gb': peak, 'launches': counts, 'collectives': coll,
            'mesh_shapes': engaged, 'core': blk.fdmt.chosen_core,
            'per_gulp_ms': per_gulp}
        log('FDMT arm %s (%s): mesh path on spans %s, %.1f Msamples/s at the '
            'sink, %.1f over the whole run, %.1f at the slowest block (%s); '
            'launches %s, collectives %s, peak device memory %s GB (%s)'
            % (arm, axes, engaged, rates[arm]['msps'], rates[arm]['msps_run'],
               rates[arm]['msps_slowest_block'], slow, counts, coll, peak,
               smi))
        log_per_gulp(per_gulp)
        require(hdr['_tensor']['shape'][-2] == FMD, 'max_delay %s'
                % hdr['_tensor']['shape'][-2])
        # one run of the core per shard per gulp, and one in on_sequence
        require(counts['fdmt_step'] == (ngulp + 1) * nsteps * nshard,
                '%s: %d K3 launches for %d gulps on %d shards'
                % (arm, counts['fdmt_step'], ngulp, nshard))
        if axes is not None:
            require(engaged, 'fdmt-mesh: the mesh path never engaged')
        outs[arm] = out
        del blocks, blk
    require(np.array_equal(outs['fdmt-mesh'].view(np.uint32),
                           outs['fdmt-single'].view(np.uint32)),
            'fdmt-mesh is not bit-identical to the chain without a mesh')
    log('fdmt-mesh: every span bit-identical to the chain without a mesh')
    del outs, host
    torch.cuda.empty_cache()
    return {'rates': rates}


# ---------------------------------------------------------------------------
# the DSP library: map, the FX chain's storage format, FIR, Romein
# ---------------------------------------------------------------------------

def event_ms(fn):
    """(result, milliseconds) of one call of ``fn`` bracketed by CUDA
    events."""
    import torch
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


POL_PRODUCTS = """
    auto x = a(_,0);
    auto y = a(_,1);
    b(_,0).assign(x.mag2(), y.mag2());
    b(_,1) = x*y.conj();
    """


def phase_map(bt, smi):
    """bf.map on the spectrometer arm's gulp (16384 x 2 x 4096 ci8): the
    polarisation products of tests/test_map.py on its complex64 voltages,
    the fftshift index vector along the 4096 axis, and the ci8 expression
    on the raw gulp from host memory; then fused([FFT, MapStage('b =
    a.mag2()'), reduce(freq, 4)]) through the pipeline against a float64
    oracle, and dft_matmul_fft against torch.fft.fft on the gulp's rows."""
    import torch
    from bifrost_tpu_torch.ndarray import ndarray
    from bifrost_tpu_torch.ops import map as M
    from bifrost_tpu_torch.ops.fft import dft_matmul_fft
    from bifrost_tpu_torch.stages import FftStage, MapStage, ReduceStage
    dev = bt.device.get_device()
    volts = make_gulps(seed=17)
    raw = volts[0]
    v = torch.view_as_complex(torch.from_numpy(raw).to(dev).float())
    ms = {}
    # the polarisation products, pol last: (T, F, 2)
    a = v.permute(0, 2, 1).contiguous()
    b = torch.empty_like(a)
    ms['pol_products'] = cuda_ms(lambda: M.map(
        POL_PRODUCTS, {'a': a, 'b': b}, shape=a.shape[:2]), runs=3, warm=1)
    x, y = a[..., 0], a[..., 1]
    require(torch.equal(b[..., 0], torch.complex(x.real ** 2 + x.imag ** 2,
                                                 y.real ** 2 + y.imag ** 2))
            and torch.equal(b[..., 1], x * y.conj()),
            'map: polarisation products differ from the torch products')
    h = a[:ORACLE_NTIME].cpu().numpy()
    m2 = lambda z: z.real ** 2 + z.imag ** 2
    want = np.stack([m2(h[..., 0]) + 1j * m2(h[..., 1]),
                     h[..., 0] * h[..., 1].conj()], -1)
    require(np.array_equal(b[:ORACLE_NTIME].cpu().numpy(), want),
            'map: polarisation products differ from numpy')
    del a, b, x, y
    # the fftshift index vector along the 4096 axis
    out = torch.empty_like(v)
    ms['fftshift'] = cuda_ms(lambda: M.map(
        'b(t,p,f) = a(t,p,f-a.shape(2)/2)', {'a': v, 'b': out},
        shape=v.shape, axis_names=('t', 'p', 'f')), runs=3, warm=1)
    require(torch.equal(out, torch.fft.fftshift(v, dim=2)),
            'map: the fftshift index vector differs from torch.fft.fftshift')
    del out
    # the ci8 expression on the raw gulp, from host memory
    flat = raw.view(np.dtype([('re', 'i1'), ('im', 'i1')])).reshape(-1)
    c = torch.empty(flat.shape[0], dtype=torch.complex64, device=dev)
    ms['ci8'] = cuda_ms(lambda: M.map(
        'b(i) = a(i)', {'a': ndarray(flat, dtype='ci8'), 'b': c},
        shape=flat.shape, axis_names=('i',)), runs=3, warm=1)
    require(torch.equal(c, v.reshape(-1)),
            'map: the ci8 expression differs from the unpacked gulp')
    del c
    log('map (16384 x 2 x 4096; medians of 3 after a warm-up): polarisation '
        'products %.2f ms, equal to torch and to numpy on %d rows; fftshift '
        'along 4096 %.2f ms, equal to torch.fft.fftshift; ci8 from host '
        '%.2f ms, equal to the unpacked gulp (%s)' % (ms['pol_products'], ORACLE_NTIME,
                                ms['fftshift'], ms['ci8'], smi))
    # DFT-matmul FFT on the gulp's 4096-point rows
    ref = torch.fft.fft(v, dim=-1)
    got = dft_matmul_fft(v, -1)
    dft_rel = float((got - ref).abs().max() / ref.abs().max())
    del got, ref
    require(dft_rel < DFT_GATE, 'dft_matmul_fft differs from torch.fft.fft: '
            'rel %.3g' % dft_rel)
    ms['dft_matmul_fft'] = cuda_ms(lambda: dft_matmul_fft(v, -1), runs=5)
    ms['cufft'] = cuda_ms(lambda: torch.fft.fft(v, dim=-1), runs=5)
    log('dft_matmul_fft (4096 = 64 x 64) on 32768 rows: rel %.3g of '
        'torch.fft.fft, %.3f ms against cuFFT %.3f ms (%s)'
        % (dft_rel, ms['dft_matmul_fft'], ms['cufft'], smi))
    del v
    torch.cuda.empty_cache()
    # MapStage fused between the FFT and the reduce, through the pipeline
    header = {'name': 'guppi', 'time_tag': 0,
              '_tensor': {'shape': [-1, NPOL, NFINE], 'dtype': 'ci8',
                          'labels': ['time', 'pol', 'fine_time'],
                          'scales': [[0, 1]] * 3, 'units': [None] * 3}}
    blocks = []

    def chain(h2d):
        blocks.append(('fused', bt.blocks.fused(
            h2d, [FftStage('fine_time', axis_labels='freq'),
                  MapStage('b = a.mag2()', dtype='f32'),
                  ReduceStage('freq', RFACTOR)])))
        return blocks
    outs, secs, per_gulp = drive(bt, volts, header, chain, PWARM, PTIMED)
    info = blocks[0][1].impl_info
    require(info.get('impl') == 'torch-fused', 'map arm planned %s' % info)
    worst = 0.0
    for k, o in outs.items():
        require(o.shape == (NTIME, NPOL, NFINE // RFACTOR) and
                o.dtype == np.float32 and np.isfinite(o).all(),
                'map arm output %d: bad shape, type or values' % k)
        g = volts[k % len(volts)][:ORACLE_NTIME].astype(np.float64)
        spec64 = np.fft.fft(g[..., 0] + 1j * g[..., 1], axis=-1)
        want = (np.abs(spec64) ** 2).reshape(
            ORACLE_NTIME, NPOL, NFINE // RFACTOR, RFACTOR).sum(-1)
        worst = max(worst, rel_err(o[:ORACLE_NTIME], want))
    require(worst < GATE, 'map arm differs from the float64 oracle: %.3g'
            % worst)
    msps = PTIMED * NTIME * NPOL * NFINE / secs / 1e6
    log('map arm fused[FFT -> MapStage(mag2) -> reduce(freq, 4)]: impl %s, '
        'outputs %s within %.3g of the float64 oracle on %d rows, %.1f '
        'Msamples/s (%s)' % (info, sorted(outs), worst, ORACLE_NTIME, msps,
                             smi))
    log_per_gulp(per_gulp)
    del blocks
    return {'ms': ms, 'dft_rel_err': dft_rel, 'map_arm_rel_err': worst,
            'map_arm_msps': msps, 'map_arm_per_gulp_ms': per_gulp}


def storage_numpy(full, b_i, b_j):
    """numpy matrix -> storage conversion of a full Hermitian
    (t, f, S, 2, S, 2) visibility: Stokes I, Q, U, V of each baseline,
    four (t, f, nbl) arrays (a storage output's [..., k] swapped on its
    last two axes)."""
    t, f, nstand = full.shape[:3]
    n = 2 * nstand
    p = np.arange(2)
    idx = ((2 * b_i[:, None, None] + p[None, :, None]) * n +
           2 * b_j[:, None, None] + p[None, None, :]).ravel()
    v = np.take(full.reshape(t, f, n * n), idx, axis=2) \
        .reshape(t, f, len(b_i), 2, 2)
    xx, xy, yx, yy = v[..., 0, 0], v[..., 0, 1], v[..., 1, 0], v[..., 1, 1]
    return [xx + yy, xx - yy, xy + yx, (xy - yx) * 1j]


def phase_fx_storage(bt, spec, gpu_kernels, fx, smi):
    """The fx-K7 arm's chain followed by convert_visibilities('storage'),
    as examples/fx_correlator.py builds it: every K7 launch counted, each
    storage output equal value for value to the numpy conversion of the
    oracle's visibilities (the FX phase's, made on the card in float64
    products), a storage -> matrix round trip equal to the oracle's full
    Hermitian matrix."""
    import torch
    from bifrost_tpu_torch.blocks.convert_visibilities import (
        baseline_indices, storage_to_matrix)
    gulps, oracle = fx.pop('gulps'), fx.pop('oracle')
    ngulp = SWARM + STIMED
    torch.cuda.reset_peak_memory_stats()
    zero_counts(spec, gpu_kernels)
    out, secs, per_gulp, info = run_fx_arm(bt, gulps, 'fx-storage')
    counts = read_counts(spec, gpu_kernels)
    peak = torch.cuda.max_memory_allocated() / 1e9
    require(counts['xcorr_herm'] == ngulp, 'fx-storage: %d K7 launches for '
            '%d gulps' % (counts['xcorr_herm'], ngulp))
    dev = bt.device.get_device()
    bi, bj, _ = baseline_indices(XS, dev)
    b_i, b_j = bi.cpu().numpy(), bj.cpu().numpy()
    nbl = len(b_i)
    t0 = time.perf_counter()
    want = [storage_numpy(o, b_i, b_j) for o in oracle]
    numpy_s = time.perf_counter() - t0
    for k, a in out.items():
        require(a.shape == (1, nbl, XF, 4) and a.dtype == np.complex64 and
                np.isfinite(a).all(),
                'fx-storage output %d: bad shape, type or values' % k)
        require(all(np.array_equal(a[..., j], w.swapaxes(1, 2))
                    for j, w in enumerate(want[k % len(gulps)])),
                'fx-storage output %d differs from the numpy storage '
                'conversion of the oracle' % k)
    del want
    back, rt_ms = event_ms(lambda: storage_to_matrix(
        torch.from_numpy(out[0]).to(dev), bi, bj, XS))
    require(np.array_equal(back.cpu().numpy(), oracle[0]),
            'fx-storage: the storage -> matrix round trip differs from the '
            "oracle's full matrix")
    del back, oracle
    d2h = per_gulp['d2h']['process']
    d2h_k7 = fx['rates']['fx-K7']['per_gulp_ms']['d2h']['process']
    rate = {'msps': STIMED * XT * XF * XS * XP / secs / 1e6,
            'baseline_channels_per_s':
                STIMED * (XT // (XR * XA)) * nbl * XF / secs,
            'd2h_ms_per_gulp': d2h, 'fx_k7_d2h_ms_per_gulp': d2h_k7,
            'storage_gb_per_gulp': nbl * XF * 4 * 8 / 1e9,
            'round_trip_ms': rt_ms, 'numpy_conversion_s': numpy_s,
            'peak_device_gb': peak, 'launches': counts, 'info': info,
            'per_gulp_ms': per_gulp}
    log('fx-storage: fx-K7 chain -> convert_visibilities(storage), %d K7 '
        'launches for %d gulps; outputs %s (%d baselines x %d x 4, %.2f GB) '
        'equal the numpy conversion of the oracle; storage -> matrix round '
        'trip %.1f ms equals the oracle (numpy conversions %.1f s); %.1f '
        'Msamples/s, %.4g baseline-channels/s, D2H %.1f ms a gulp against '
        'fx-K7\'s %.1f, peak device memory %.1f GB (%s)'
        % (counts['xcorr_herm'], ngulp, sorted(out), nbl, XF,
           rate['storage_gb_per_gulp'], rt_ms, numpy_s, rate['msps'],
           rate['baseline_channels_per_s'], d2h, d2h_k7, peak, smi))
    log_per_gulp(per_gulp)
    del out
    torch.cuda.empty_cache()
    return rate


def fir_oracle(coeffs, x):
    """Causal FIR of complex128 ``x`` along axis 0 with zero history,
    float64 taps ``coeffs`` (ntap,) or (ntap, *x.shape[1:])."""
    ntap = coeffs.shape[0]
    xp = np.concatenate([np.zeros((ntap - 1,) + x.shape[1:], x.dtype), x])
    out = np.zeros_like(x)
    for t in range(ntap):
        out += coeffs[t] * xp[ntap - 1 - t: xp.shape[0] - t]
    return out


def phase_fir(bt, smi):
    """FirBlock on 3 ci8 gulps of BASELINE config 4's shape (512 x 512 x
    256 x 2): a 16-tap filter with real taps per (channel, station, pol),
    decim 1, as fir.cu filters across ant-pols; then shared (16,) taps
    and decim 4.  Both within 1e-5 (of the largest magnitude) of a
    float64 oracle over the concatenated stream, on FIR_CHANNELS, across
    the gulp boundaries."""
    import torch
    from bifrost_tpu_torch.ops.fir import Fir
    gulps = beam_gulps(seed=23, n=3)
    header = {'name': 'fir', 'time_tag': 0, 'gulp_nframe': BT,
              '_tensor': {'shape': [-1, BF, BS, BP], 'dtype': 'ci8',
                          'labels': ['time', 'freq', 'station', 'pol'],
                          'scales': [[0, 1e-3]] + [[0, 1]] * 3,
                          'units': ['s'] + [None] * 3}}
    rng = np.random.default_rng(29)
    taps = {'fir-perchan': (rng.standard_normal(
                (FIR_TAPS, BF, BS, BP), dtype=np.float32), 1),
            'fir-shared': (rng.standard_normal(FIR_TAPS, dtype=np.float32),
                           FIR_DECIM)}
    chans = list(FIR_CHANNELS)
    stream = np.concatenate([g[:, chans] for g in gulps]).astype(np.float64)
    xc = stream[..., 0] + 1j * stream[..., 1]
    del stream
    res = {}
    for arm, (coeffs, decim) in taps.items():
        blocks = []

        def chain(h2d):
            blocks.append(('fir', bt.blocks.fir(h2d, coeffs, decim)))
            return blocks
        outs, secs, per_gulp = drive(bt, gulps, header, chain, 1, 2)
        require(sorted(outs) == [0, 1, 2], '%s: outputs %s' % (arm,
                                                               sorted(outs)))
        for k, o in outs.items():
            require(o.shape == (BT // decim, BF, BS, BP) and
                    o.dtype == np.complex64 and np.isfinite(o).all(),
                    '%s output %d: bad shape, type or values' % (arm, k))
        got = np.concatenate([outs[k][:, chans] for k in range(3)])
        c = coeffs[:, chans].astype(np.float64) if coeffs.ndim > 1 \
            else coeffs.astype(np.float64)
        want = fir_oracle(c, xc)[::decim]
        rel = rel_err(got, want)
        require(rel < GATE, '%s differs from the float64 oracle: %.3g'
                % (arm, rel))
        del outs, got, want, blocks
        # one gulp's FIR on the card, state carried
        x = torch.view_as_complex(torch.from_numpy(gulps[0]).to(
            bt.device.get_device()).float())
        fir = Fir().init(coeffs, decim=decim)
        ms = cuda_ms(lambda: fir.execute(x), runs=5)
        del x, fir
        torch.cuda.empty_cache()
        res[arm] = {'rel_err': rel, 'execute_ms': ms,
                    'msps': 2 * BT * BF * BS * BP / secs / 1e6,
                    'per_gulp_ms': per_gulp}
        log('%s: 16 taps %s, decim %d, 3 gulps; within %.3g of the float64 '
            'oracle on channels %s across the gulp boundaries; Fir.execute '
            '%.3f ms a gulp on the card, %.1f Msamples/s through the '
            'pipeline (%s)' % (arm, 'per (channel, station, pol)'
                               if coeffs.ndim > 1 else 'shared', decim, rel,
                               chans, ms, res[arm]['msps'], smi))
        log_per_gulp(per_gulp)
    return res


# ---------------------------------------------------------------------------
# the transfer engine: copy streams, pinned slots, deferred fills
# ---------------------------------------------------------------------------

XFER_COUNTERS = ('xfer.d2h_async', 'xfer.depth_waits', 'xfer.sync_waits',
                 'pipeline.sync_waits', 'xfer.d2h_staged',
                 'xfer.d2h_direct', 'xfer.h2d_staged', 'xfer.h2d_unstaged')
XFER_ROLES = ('source', 'h2d', 'd2h', 'sink')


def hold_h2d_stream(eng, ms=50):
    """Queue ``ms`` of spinning on the current stream and make the
    engine's H2D stream wait for it: its next copies stay queued."""
    import torch
    dev = torch.device('cuda:0')
    torch.cuda._sleep(int(ms * 1.5e6))
    eng._stream('h2d', dev).wait_stream(torch.cuda.current_stream(dev))


def run_with_timeout(p, secs=300):
    """``p.run()`` on a daemon thread; raises if it has not ended within
    ``secs`` (after shutting the pipeline down), re-raises its error."""
    import threading
    box = {}

    def target():
        try:
            p.run()
        except BaseException as exc:
            box['exc'] = exc

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(secs)
    if t.is_alive():
        p.shutdown()
        raise RuntimeError('chip_smoke check failed: pipeline still '
                           'running after %d s' % secs)
    if 'exc' in box:
        raise box['exc']


def xfer_engine_checks():
    """The engine on the card: H2D alias safety with the copy still
    queued, pinned-slot recycling by the counters, out-of-order futures,
    and 32 fills issued right behind a producer kernel with no explicit
    synchronize, byte for byte."""
    import torch
    from bifrost_tpu_torch import xfer
    from bifrost_tpu_torch.telemetry import counters
    rng = np.random.default_rng(41)
    eng = xfer.TransferEngine()
    src = rng.standard_normal(1 << 24, dtype=np.float32)
    want = src.copy()
    hold_h2d_stream(eng)
    d = eng.to_device(src)
    src[...] = -1.0
    require(np.array_equal(d.cpu().numpy(), want),
            'xfer: overwriting an H2D source changed the device copy')
    del d
    eng = xfer.TransferEngine(staging=1)
    arrs = [rng.standard_normal((1024, 1024), dtype=np.float32)
            for _ in range(3)]
    # the key's one slot exists before the copy stream is held (a pinned
    # allocation may wait for the card)
    warm = eng.to_device(arrs[2])
    torch.cuda.synchronize()
    counters.reset()
    hold_h2d_stream(eng, 200)
    outs = [eng.to_device(arrs[0])]
    slot = [sl for sl in eng._pool._busy if sl.ref() is outs[0]][0]
    require(not slot.event.query(), 'xfer: the held H2D copy already ran')
    outs.append(eng.to_device(arrs[1]))
    busy = [counters.get('xfer.h2d_staged'),
            counters.get('xfer.h2d_unstaged')]
    torch.cuda.synchronize()
    outs.append(eng.to_device(arrs[2]))
    done = [counters.get('xfer.h2d_staged'),
            counters.get('xfer.h2d_unstaged')]
    require(busy == [1, 1] and done == [2, 1],
            'xfer: slot recycling: staged/unstaged %s while busy, %s after '
            '(want [1, 1], [2, 1])' % (busy, done))
    del warm
    for a, o in zip(arrs, outs):
        require(np.array_equal(o.cpu().numpy(), a),
                'xfer: a staged H2D gave wrong bytes')
    eng = xfer.TransferEngine(depth=16)
    xs = [torch.full((1 << 20,), float(i), device='cuda') for i in range(8)]
    futs = [eng.to_host_async(x) for x in xs]
    for i in (5, 1, 6, 2, 7, 0, 3, 4):
        require((futs[i].result() == i).all(),
                'xfer: future %d out of order gave wrong bytes' % i)
    require(eng.outstanding == 0, 'xfer: futures left outstanding')
    eng = xfer.TransferEngine()
    host = np.zeros((32, 1024, 1024), np.int32)
    g = torch.Generator(device='cuda').manual_seed(42)
    wants, fills = [], []
    for i in range(32):
        x = torch.randint(-1000, 1000, (1024, 1024), device='cuda',
                          generator=g, dtype=torch.int32)
        wants.append(x.cpu().numpy() * 3 + i)
        torch.cuda._sleep(int(2e6))
        fills.append(eng.host_fill(x * 3 + i, 'i32', host[i]))
        del x
    eng.drain(block=True)
    for f in fills:
        f.wait()
    bad = [i for i in range(32) if not np.array_equal(host[i], wants[i])]
    require(not bad, 'xfer: fills behind a producer kernel differ at gulps '
            '%s' % bad)
    log('xfer: H2D source recycled at once, slots %s busy -> %s after '
        '(staged, unstaged), 8 futures out of order, 32 fills behind a '
        'producer kernel with no synchronize: all byte for byte'
        % (busy, done))
    return {'slots_busy': busy, 'slots_after_sync': done,
            'fills_behind_producer': 32}


def xfer_fault_check(bt):
    """A fault at ``xfer.result`` poisons the D2H ring, and run() raises."""
    from bifrost_tpu_torch.testing import faults
    from bifrost_tpu_torch.telemetry import counters
    header = {'name': 'f', 'time_tag': 0, 'gulp_nframe': 64,
              '_tensor': {'shape': [-1, 4096], 'dtype': 'f32',
                          'labels': ['time', 'chan'], 'scales': [[0, 1]] * 2,
                          'units': [None] * 2}}

    class Source(bt.SourceBlock):
        def __init__(self):
            super(Source, self).__init__(['x'], 64, space='system')
            self.n = 0

        def create_reader(self, name):
            return contextlib.nullcontext()

        def on_sequence(self, reader, name):
            return [json.loads(json.dumps(header))]

        def on_data(self, reader, ospans):
            if self.n == 8:
                return [0]
            ospans[0].data.as_numpy()[...] = self.n
            self.n += 1
            return [64]

    class Sink(bt.SinkBlock):
        def on_sequence(self, iseq):
            pass

        def on_data(self, ispan):
            pass

    counters.reset()
    with bt.Pipeline() as p:
        d2h = bt.blocks.copy(bt.blocks.copy(Source(), space='cuda'),
                             space='system')
        Sink(d2h)
    raised = None
    with faults.injected('xfer.result', count=1, after=2) as f:
        try:
            run_with_timeout(p, 120)
        except Exception as exc:
            raised = exc
    require(raised is not None and f.fired == 1 and
            'injected fault at xfer.result' in str(raised),
            'xfer.result fault: run() did not raise it (fired %d, %r)'
            % (f.fired, raised))
    require(d2h.orings[0].poisoned,
            'xfer.result fault: the D2H ring was not poisoned')
    log('xfer: a fault at xfer.result poisoned the D2H ring and run() raised '
        '(%s); xfer.fill_errors %d'
        % (str(raised).splitlines()[0][:120],
           counters.get('xfer.fill_errors')))
    return {'raised': True, 'fill_errors': counters.get('xfer.fill_errors')}


def first_touch_probe():
    """One 2 GiB complex64 D2H (an FX visibility) into a fresh 'system'
    buffer (pages never touched), into the same buffer again (pages now
    mapped), and into a pinned 'cuda_host' buffer (no slot, no host
    copy): the DMA's wait and the host copy out of the slot apart."""
    import torch
    from bifrost_tpu_torch import xfer
    n = 1 << 28
    t = torch.randn(n, dtype=torch.complex64, device='cuda')
    eng = xfer.TransferEngine()
    t0 = time.perf_counter()
    pinned = torch.empty(n * 8, dtype=torch.uint8,
                         pin_memory=True).numpy().view(np.complex64)
    pin_alloc = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    slot = eng._pool.acquire((n,), np.complex64, kind='d2h',
                             cap=eng._bound(t.numel() * 8) + 1)
    eng._pool.release_unused(slot)
    slot_alloc = (time.perf_counter() - t0) * 1e3

    def one(target):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fill = eng.host_fill(t, 'cf32', target)
        fill.future._event.synchronize()
        t1 = time.perf_counter()
        fill.wait()
        t2 = time.perf_counter()
        return {'dma_ms': (t1 - t0) * 1e3, 'host_copy_ms': (t2 - t1) * 1e3,
                'total_ms': (t2 - t0) * 1e3}

    fresh = np.zeros(n, np.complex64)
    res = {'cuda_host': one(pinned), 'system_fresh': one(fresh),
           'system_touched': one(fresh),
           'pinned_alloc_ms': pin_alloc, 'slot_alloc_ms': slot_alloc}
    # the other way to a pageable ring: page-lock its buffer in place
    # (cudaHostRegister), after which the copy lands there directly
    reg = np.empty(n, np.complex64)
    cudart = torch.cuda.cudart()
    t0 = time.perf_counter()
    err = int(cudart.cudaHostRegister(reg.ctypes.data, reg.nbytes, 0))
    res['register_ms'] = (time.perf_counter() - t0) * 1e3
    res['register_error'] = err
    if err == 0:
        try:
            res['system_registered'] = one(reg)
            require(np.array_equal(reg, pinned), 'first-touch probe: the '
                    'registered copy differs')
        finally:
            cudart.cudaHostUnregister(reg.ctypes.data)
    del reg
    require(np.array_equal(fresh, pinned),
            'first-touch probe: the system and cuda_host copies differ')
    require(np.array_equal(pinned[:1 << 20], t[:1 << 20].cpu().numpy()),
            'first-touch probe: the D2H bytes differ from the tensor')
    del t, pinned, fresh
    log('first-touch probe, 2 GiB complex64 D2H (ms; dma = issue to the '
        "copy's event, host_copy = slot to target): cuda_host %s, system "
        'fresh %s, system touched %s, system registered %s; 2 GiB pinned '
        'alloc %.1f, the slot %.1f, cudaHostRegister %.1f (error %d)'
        % tuple([json.dumps({k: round(v, 1) for k, v in
                             res.get(a, {}).items()})
                 for a in ('cuda_host', 'system_fresh', 'system_touched',
                           'system_registered')] +
                [pin_alloc, slot_alloc, res['register_ms'], err]))
    return res


def xfer_report(arm, mode, per_gulp, secs, smi):
    from bifrost_tpu_torch import xfer
    from bifrost_tpu_torch.telemetry import counters
    snap = counters.snapshot()
    rec = {'per_gulp_ms': per_gulp, 'seconds': secs,
           'counters': {k: snap.get(k, 0) for k in XFER_COUNTERS},
           'pinned_bytes': xfer.engine().pinned_bytes()}
    log('xfer arm %s %s: %s; counters %s; engine pinned %.2f GB (%s)'
        % (arm, mode, ', '.join(
            '%s %s' % (r, '/'.join('%.1f' % per_gulp[r][k] for k in
                                   ('acquire', 'reserve', 'process')))
            for r in XFER_ROLES),
           json.dumps(rec['counters']), rec['pinned_bytes'] / 1e9, smi))
    return rec


def xfer_drive_arm(bt, arm, run, smi):
    """``run(scope)`` -> (CRC-32 list, seconds, per-block ms/gulp) in
    async and in strict mode: the same bytes required."""
    from bifrost_tpu_torch import xfer
    from bifrost_tpu_torch.telemetry import counters
    res = {}
    crcs = {}
    for mode, scope in (('async', {}), ('strict', {'sync_strict': True})):
        xfer.reset_engine()
        counters.reset()
        crcs[mode], secs, per_gulp = run(scope)
        res[mode] = xfer_report(arm, mode, per_gulp, secs, smi)
    require(crcs['async'] == crcs['strict'], '%s: async outputs %s differ '
            'from strict %s' % (arm, crcs['async'], crcs['strict']))
    res['crc32'] = crcs['async']
    return res


def phase_xfer(bt, fx, smi):
    """The engine checks, the xfer.result fault, fx-K7, fir decim 1 and
    guppi-ci8 async and strict, and the first-touch probe; async is the
    engine's default mode whatever BF_SYNC_STRICT says for the rest of
    the script."""
    with environ(BF_SYNC_STRICT=None, BF_XFER_ASYNC=None):
        return xfer_phase(bt, fx, smi)


def xfer_phase(bt, fx, smi):
    import tempfile
    import importlib.util
    import torch
    from bifrost_tpu_torch import xfer
    free_before = subprocess.run(['free', '-g'], capture_output=True,
                                 text=True).stdout
    res = {'engine': xfer_engine_checks(), 'fault': xfer_fault_check(bt)}
    torch.cuda.empty_cache()

    def fx_run(scope):
        out, secs, per_gulp, _ = run_fx_arm(bt, fx['gulps'], 'fx-K7',
                                            nwarm=1, ntimed=2, scope=scope,
                                            digest=True)
        return [out[k] for k in sorted(out)], secs, per_gulp
    res['fx-K7'] = xfer_drive_arm(bt, 'fx-K7', fx_run, smi)
    want = [crc32(fx['oracle'][k % len(fx['gulps'])]) for k in range(3)]
    require(res['fx-K7']['crc32'] == want,
            'fx-K7 (xfer phase): outputs differ from the oracle')
    free_fx = subprocess.run(['free', '-g'], capture_output=True,
                             text=True).stdout
    torch.cuda.empty_cache()

    fgulps = beam_gulps(seed=23, n=3)
    fheader = {'name': 'fir', 'time_tag': 0, 'gulp_nframe': BT,
               '_tensor': {'shape': [-1, BF, BS, BP], 'dtype': 'ci8',
                           'labels': ['time', 'freq', 'station', 'pol'],
                           'scales': [[0, 1e-3]] + [[0, 1]] * 3,
                           'units': ['s'] + [None] * 3}}
    coeffs = np.random.default_rng(29).standard_normal(
        (FIR_TAPS, BF, BS, BP), dtype=np.float32)

    def fir_run(scope):
        def chain(h2d):
            return [('fir', bt.blocks.fir(h2d, coeffs, 1))]
        out, secs, per_gulp = drive(bt, fgulps, fheader, chain, 1, 2,
                                    scope=scope, digest=True)
        return [out[k] for k in sorted(out)], secs, per_gulp
    res['fir'] = xfer_drive_arm(bt, 'fir decim 1', fir_run, smi)
    del fgulps
    torch.cuda.empty_cache()

    here = os.path.dirname(os.path.abspath(__file__))
    mod = importlib.util.spec_from_file_location(
        'gpuspec_simple_torch',
        os.path.join(here, 'examples', 'gpuspec_simple_torch.py'))
    example = importlib.util.module_from_spec(mod)
    mod.loader.exec_module(example)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'bl8.raw')
        write_guppi(path, 8, GBLOCKS[8])

        def guppi_run(scope):
            with bt.Pipeline(**scope) as p:
                example.build([path], tmp, gulp_nframe=1, rfactor=GR)
            t0 = time.perf_counter()
            run_with_timeout(p, 300)
            secs = time.perf_counter() - t0
            copies = [b for b in p.blocks if type(b).__name__ == 'CopyBlock']
            roles = dict(zip(XFER_ROLES, [p.blocks[0], copies[0], copies[1],
                                          p.blocks[-1]]))
            per_gulp = {}
            for role, blk in roles.items():
                tot = blk.perf_totals
                per_gulp[role] = {k: tot[k] / max(tot['ngulp'], 1) * 1e3
                                  for k in ('acquire', 'reserve',
                                            'process')}
            with open(path + '.fil', 'rb') as f:
                crc = zlib.crc32(f.read())
            os.remove(path + '.fil')
            return [crc], secs, per_gulp
        res['guppi-ci8'] = xfer_drive_arm(bt, 'guppi-ci8', guppi_run, smi)
    torch.cuda.empty_cache()
    res['first_touch'] = first_touch_probe()
    xfer.reset_engine()
    res['free_g'] = {'before': free_before, 'after_fx': free_fx}
    log('free -g before the xfer phase:\n%s\nafter its fx-K7 arms:\n%s'
        % (free_before.strip(), free_fx.strip()))
    return res


def phase_romein(bt, smi):
    """Romein gridding at imaging size: RNPTS points (config 5's
    baselines, autos included) with 7 x 7 complex64 kernels onto a 1024 x
    1024 grid, 64 channels at once; within 1e-5 (of the largest
    magnitude) of a float64 scatter on ROMEIN_ORACLE channels, and a
    second call with accumulate=True doubles the grid to the same
    tolerance.  Each execute timed."""
    import torch
    from bifrost_tpu_torch.ops.romein import Romein
    rng = np.random.default_rng(31)
    pos = rng.integers(0, RNGRID, size=(RNPTS, 2)).astype(np.int32)
    cplx = lambda *shape: (rng.standard_normal(shape) + 1j *
                           rng.standard_normal(shape)).astype(np.complex64)
    kern = cplx(RNPTS, RKSIZE, RKSIZE)
    data = cplx(RNCHAN, RNPTS)
    rom = Romein().init(pos, kern, RNGRID)
    x = torch.from_numpy(data).to(bt.device.get_device())
    grid, ms1 = event_ms(lambda: rom.execute(x))
    require(tuple(grid.shape) == (RNCHAN, RNGRID, RNGRID) and
            grid.dtype == torch.complex64, 'romein: grid %s %s'
            % (tuple(grid.shape), grid.dtype))
    d = np.arange(RKSIZE)
    gy = (pos[:, 1, None, None] + d[None, :, None]) % RNGRID
    gx = (pos[:, 0, None, None] + d[None, None, :]) % RNGRID
    lin = np.broadcast_to(gy * RNGRID + gx, kern.shape).reshape(-1)
    want = []
    for c in range(ROMEIN_ORACLE):
        w = (data[c, :, None, None].astype(np.complex128) * kern).reshape(-1)
        want.append((np.bincount(lin, w.real, RNGRID * RNGRID) + 1j *
                     np.bincount(lin, w.imag, RNGRID * RNGRID))
                    .reshape(RNGRID, RNGRID))
    want = np.stack(want)
    got = grid[:ROMEIN_ORACLE].cpu().numpy()
    rel1 = rel_err(got, want)
    require(np.isfinite(got).all() and rel1 < GATE,
            'romein differs from the float64 scatter: %.3g' % rel1)
    _, ms2 = event_ms(lambda: rom.execute(x, odata=grid, accumulate=True))
    rel2 = rel_err(grid[:ROMEIN_ORACLE].cpu().numpy(), 2 * want)
    require(rel2 < GATE, 'romein accumulate=True does not double the grid: '
            '%.3g' % rel2)
    ms_steady = cuda_ms(lambda: rom.execute(x), runs=5)
    del grid, x
    torch.cuda.empty_cache()
    log('romein: %d points x %d channels, %dx%d kernels onto %d^2 '
        '(%.0f MB of grid): execute %.2f ms (first), accumulate %.2f ms, '
        'median of 5 %.2f ms; within %.3g / %.3g (accumulated) of the '
        'float64 scatter on %d channels (%s)'
        % (RNPTS, RNCHAN, RKSIZE, RKSIZE, RNGRID,
           RNCHAN * RNGRID * RNGRID * 8 / 1e6, ms1, ms2, ms_steady, rel1,
           rel2, ROMEIN_ORACLE, smi))
    return {'execute_ms': ms1, 'accumulate_ms': ms2,
            'median_ms': ms_steady, 'rel_err': rel1,
            'rel_err_accumulated': rel2}


# ---------------------------------------------------------------------------
# linalg: LinAlg.matmul at the reference's shapes
# ---------------------------------------------------------------------------

#: beamformer config 4: c64 weights (channel, beam, station) @ data
#: (channel, station, frame); the FX array: (channel, input, frame) for
#: a @ a^H, in complex64 and in ci8
LA_AB = ((512, 64, 256), (512, 256, 512))
LA_AAH = (1024, 256, 256)
LA_GATE = 1e-3
LA_GATE_BF16 = 8e-3


def count_int_mm(fn):
    """(result of ``fn()``, torch._int_mm calls it made)."""
    import torch
    real = torch._int_mm
    n = [0]

    def counted(a, b):
        n[0] += 1
        return real(a, b)
    torch._int_mm = counted
    try:
        return fn(), n[0]
    finally:
        torch._int_mm = real


def la_rel(y, want):
    """max |y - want| / max |want| against the complex128 oracle."""
    import torch
    return float((y.to(torch.complex128) - want).abs().max() /
                 want.abs().max())


def la_case(L, name, family, la, result, args, want, nbyte, ncmac, peak,
            library, exact=False, calls=4, runs=3):
    """Time and check every candidate of ``family`` on ``args`` and the
    chosen one's ``result`` against the oracle ``want``: the i8 family bit
    for bit, the float ones within LA_GATE (planar_bf16 LA_GATE_BF16).
    Returns the case's record."""
    import torch
    import bifrost_tpu_torch.ops.linalg as LM
    out = {'chosen': la.chosen.get(family), 'probe_ms': la.probe_ms.get(
        family), 'candidates': {}}
    bms, by = bound(nbyte, 8 * ncmac, peak)
    out.update(bound_ms=bms, bound_by=by)
    if exact:
        require(bool(torch.equal(result, want.to(torch.complex64))),
                'linalg %s: the chosen %s differs from the int64 oracle'
                % (name, out['chosen']))
        out['chosen_err'] = 0.0
    else:
        out['chosen_err'] = la_rel(result, want)
        require(out['chosen_err'] <= LA_GATE, 'linalg %s: the chosen %s is '
                '%.3g of the float64 oracle (limit %g)'
                % (name, out['chosen'], out['chosen_err'], LA_GATE))
    del result
    for cand in LM._IMPLS[family]:
        fn = LM.LinAlg._impl(family, cand)
        y, nmm = count_int_mm(lambda: fn(*args, None, alpha=1.0, beta=0.0))
        if exact:
            ok = bool(torch.equal(y, want.to(torch.complex64)))
            err = 0.0 if ok else la_rel(y, want)
            require(ok, 'linalg %s: %s differs from the int64 oracle '
                    '(%.3g)' % (name, cand, err))
        else:
            err = la_rel(y, want)
            lim = LA_GATE_BF16 if cand in LM.LinAlg._LOSSY else LA_GATE
            require(err <= lim, 'linalg %s: %s is %.3g of the float64 '
                    'oracle (limit %g)' % (name, cand, err, lim))
        del y
        ms = cuda_ms_queued(lambda: fn(*args, None, alpha=1.0, beta=0.0),
                            calls=calls, runs=runs)
        out['candidates'][cand] = {'ms': ms, 'rel_err': err,
                                   'int_mm_calls': nmm}
        torch.cuda.empty_cache()
    out['library_ms'] = cuda_ms_queued(library, calls=calls, runs=runs)
    out['library'] = 'complex64 torch.matmul'
    log('linalg %s: chosen %s (probe ms %s), chosen rel err %.3g; '
        'candidates %s; %s %.4f ms; bound %.4f ms (%s)'
        % (name, out['chosen'], json.dumps(out['probe_ms']),
           out['chosen_err'], json.dumps(out['candidates']), out['library'],
           out['library_ms'], bms, by))
    return out


def phase_linalg(bt, L, ab=LA_AB, aah=LA_AAH, calls=4, runs=3, seed=37):
    """LinAlg.matmul on the card at the beamformer's a @ b and the FX
    array's a @ a^H (complex64 and ci8), each raced from an empty probe
    cache and held to a float64 oracle made on the card; every candidate
    timed queued beside the complex64 torch.matmul of the same product."""
    import torch
    from bifrost_tpu_torch.dtype import DataType
    from bifrost_tpu_torch.ndarray import ndarray
    dev = bt.device.get_device()
    gen = torch.Generator(device=dev).manual_seed(seed)

    def crandn(shape):
        return torch.randn(tuple(shape), dtype=torch.complex64, device=dev,
                           generator=gen)

    c128 = torch.complex128
    res = {}
    unset = dict.fromkeys(('BF_LINALG_PROBE', 'BF_LINALG_AB_IMPL',
                           'BF_LINALG_AAH_IMPL', 'BF_LINALG_I8_IMPL',
                           'BF_LINALG_GATE_RTOL'))
    with race_cache(**unset):
        # a @ b: weights @ data
        w, x = crandn(ab[0]), crandn(ab[1])
        want = torch.matmul(w.to(c128), x.to(c128))
        la = L.LinAlg()
        y = la.matmul(1.0, w, x, 0.0, None)
        b_, m, k = ab[0]
        n = ab[1][2]
        res['ab'] = la_case(
            L, 'ab c64 %s @ %s' % (ab[0], ab[1]), 'ab', la, y, (w, x), want,
            w.nbytes + x.nbytes + y.nbytes, b_ * m * n * k, PEAK_FP32_PER_S,
            lambda: torch.matmul(w, x), calls=calls, runs=runs)
        del w, x, y, want
        torch.cuda.empty_cache()
        # a @ a^H, complex64
        a = crandn(aah)
        want = torch.matmul(a.to(c128), a.to(c128).transpose(-1, -2).conj())
        la = L.LinAlg()
        y = la.matmul(1.0, a, None, 0.0, None)
        b_, n, k = aah
        ah = a.transpose(-1, -2).conj()
        res['aah_c64'] = la_case(
            L, 'aah c64 %s' % (aah,), 'aah', la, y, (a,), want,
            a.nbytes + y.nbytes, b_ * n * n * k, PEAK_FP32_PER_S,
            lambda: torch.matmul(a, ah), calls=calls, runs=runs)
        del a, ah, y, want
        torch.cuda.empty_cache()
        # a @ a^H, ci8: the host array LinAlg takes, its planes on the card
        rng = np.random.default_rng(seed)
        host = np.empty(aah, dtype=DataType('ci8').as_numpy_dtype())
        host['re'] = rng.integers(-128, 128, aah, dtype=np.int8)
        host['im'] = rng.integers(-128, 128, aah, dtype=np.int8)
        re = torch.from_numpy(np.ascontiguousarray(host['re'])).to(dev)
        im = torch.from_numpy(np.ascontiguousarray(host['im'])).to(dev)
        z = torch.complex(re.double(), im.double())
        # exact: every sum stays below 2**53 (and below 2**24)
        want = torch.matmul(z, z.transpose(-1, -2).conj())
        del z
        la = L.LinAlg()
        y = la.matmul(1.0, ndarray(host, dtype='ci8'), None, 0.0, None)
        zc = torch.complex(re.float(), im.float())
        zh = zc.transpose(-1, -2).conj()
        res['aah_ci8'] = la_case(
            L, 'aah ci8 %s' % (aah,), 'i8', la, y, (re, im), want,
            re.nbytes + im.nbytes + y.nbytes, b_ * n * n * k,
            PEAK_INT8_PER_S, lambda: torch.matmul(zc, zh), exact=True,
            calls=calls, runs=runs)
        del re, im, zc, zh, y, want
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# supervision: the K1 chain under each failure policy, shedding, the
# watchdog and the exporter
# ---------------------------------------------------------------------------

#: the drills' gulp: the flagship's width (2 pols x 4096 channels, r 4)
#: at 2048 frames a gulp (the depth cut: each gulp's output is CRC'd)
DT = 2048
DRILL_TIMEOUT = 120


def drill_header(ntime=DT, nfine=NFINE):
    return {'name': 'drill', 'time_tag': 0, 'gulp_nframe': ntime,
            '_tensor': {'shape': [-1, NPOL, nfine], 'dtype': 'ci8',
                        'labels': ['time', 'pol', 'fine_time'],
                        'scales': [[0, 1]] * 3, 'units': [None] * 3}}


def drill_blocks(bt):
    """The drills' source, K1 chain and sinks, as classes of the port."""
    from bifrost_tpu_torch.stages import FftStage, DetectStage, ReduceStage

    class Source(bt.SourceBlock):
        """``ngulp`` gulps a sequence, cycling over ``gulps``, one every
        ``pace`` seconds at most; a (re)opened reader starts at gulp 0."""

        def __init__(self, gulps, ngulp, names=('a',), pace=0.0, **kw):
            super(Source, self).__init__(list(names), gulps[0].shape[0],
                                         space='system', **kw)
            self.gulps, self.ngulp, self.pace = gulps, ngulp, pace

        def create_reader(self, name):
            return contextlib.nullcontext([0])

        def on_sequence(self, reader, name):
            hdr = drill_header(self.gulps[0].shape[0],
                               self.gulps[0].shape[2])
            hdr['name'] = 'drill-%s' % name
            return [hdr]

        def on_data(self, reader, ospans):
            if reader[0] == self.ngulp:
                return [0]
            if self.pace:
                time.sleep(self.pace)
            dst = ospans[0].data.as_numpy().view(np.int8)
            dst[...] = self.gulps[reader[0] % len(self.gulps)].reshape(
                dst.shape)
            reader[0] += 1
            return [self.gulps[0].shape[0]]

    class CrcSink(bt.SinkBlock):
        """Keeps (sequence, input gulp, CRC-32, all zero) of each output
        gulp; ``block`` (an Event) wedges it at ``block_at``."""

        def __init__(self, iring, block=None, block_at=1, **kw):
            super(CrcSink, self).__init__(iring, **kw)
            self.seen, self.nseq = [], 0
            self.block, self.block_at, self.blocked_at = block, block_at, \
                None

        def on_sequence(self, iseq):
            self.nseq += 1

        def on_data(self, ispan):
            if self.block is not None and len(self.seen) == self.block_at:
                self.blocked_at = time.monotonic()
                self.block.wait()
            a = ispan.data.as_numpy()
            self.seen.append((self.nseq - 1, ispan.frame_offset //
                              ispan.nframe, crc32(a), not a.any()))

    class SlowK1Sink(bt.SinkBlock):
        """A guaranteed reader that runs the K1 chain on each span (the
        function FusedBlock runs, ``stages.compose_stages``), copies the
        result to the host, releases the span, then idles: the backlog it
        leaves is what a drop_oldest writer sheds.  Keeps (gulp index,
        CRC-32 of the K1 output) and the frames it was skipped past."""

        def __init__(self, iring, idle, **kw):
            super(SlowK1Sink, self).__init__(iring, **kw)
            self.idle, self.seen, self.skipped = idle, [], 0

        def main(self, orings):
            from bifrost_tpu_torch.header_standard import trace_context
            from bifrost_tpu_torch.stages import compose_stages, walk_headers
            stages = k1_stages()
            for seq in self.iring.read(guarantee=True):
                # no output sequence to open: release the init barrier
                self.begin_sequences(None, [], [], [], [])
                hdrs = walk_headers(stages, seq.header)
                self._trace_ctx = trace_context(seq.header)
                nframe = seq.header['gulp_nframe']
                off, fn = 0, None
                while True:
                    try:
                        span = seq.acquire(off, nframe)
                    except bt.EndOfDataStop:
                        break
                    self.skipped += span.frame_offset - off
                    got = span.nframe
                    if got:
                        x = span.data
                        if fn is None:
                            fn = compose_stages(stages, hdrs, x.shape,
                                                x.dtype)[0]
                        self.seen.append(
                            (span.frame_offset // nframe,
                             crc32(fn(x).cpu().numpy())))
                        self._observe_exit_age(seq.header,
                                               span.frame_offset + got)
                    nxt = span.frame_offset + got
                    span.release()
                    self.heartbeat()
                    if not got and nxt <= off:
                        break
                    off = nxt
                    if got:
                        time.sleep(self.idle)

    def k1_stages():
        return [FftStage('fine_time', axis_labels='freq'),
                DetectStage('stokes', axis='pol'),
                ReduceStage('freq', RFACTOR)]

    def k1(h2d, **kw):
        return bt.blocks.fused(h2d, k1_stages(), **kw)

    return Source, CrcSink, SlowK1Sink, k1


def drill_chain(bt, blocks, gulps, ngulp, src_kw=None, h2d_kw=None,
                k1_kw=None, sink_kw=None, names=('a',)):
    """source -> copy('cuda') -> fused K1 -> copy('system') -> CRC sink in
    a new pipeline; returns (pipeline, {role: block})."""
    Source, CrcSink, _tap, k1 = blocks
    with bt.Pipeline() as p:
        src = Source(gulps, ngulp, names, **(src_kw or {}))
        h2d = bt.blocks.copy(src, space='cuda', **(h2d_kw or {}))
        fused = k1(h2d, **(k1_kw or {}))
        d2h = bt.blocks.copy(fused, space='system')
        sink = CrcSink(d2h, **(sink_kw or {}))
    return p, {'source': src, 'h2d': h2d, 'fused': fused, 'd2h': d2h,
               'sink': sink}


def check_delivered(what, seen, expect):
    """Every non-zero output gulp equals the reference CRC of its input
    gulp; returns the count of zero-filled ones."""
    zeros = 0
    for seq, g, crc, zero in seen:
        if zero:
            zeros += 1
            continue
        require(crc == expect[g % len(expect)], '%s: output gulp %d of '
                'sequence %d differs from the K1 arm\'s bytes'
                % (what, g, seq))
    return zeros


def drill_run(p, expect_exc=None):
    """``run_with_timeout`` of a drill: (seconds, exception raised); the
    monotonic time it returned is left in ``p.drill_end``."""
    t0 = time.monotonic()
    try:
        run_with_timeout(p, DRILL_TIMEOUT)
        exc = None
    except Exception as e:
        if expect_exc is None or not isinstance(e, expect_exc):
            raise
        exc = e
    p.drill_end = time.monotonic()
    return p.drill_end - t0, exc


def parse_prometheus(path):
    """{(metric, labels string): value} of a Prometheus textfile."""
    out = {}
    with open(path) as f:
        for line in f:
            if line.startswith('#') or not line.strip():
                continue
            key, _, val = line.rpartition(' ')
            name, _, labels = key.partition('{')
            out[(name, labels.rstrip('}'))] = float(val)
    return out


def phase_supervision(bt, spec, gpu_kernels, ngulp=12, tap_gulps=48,
                      tap_idle=0.1, gulps=None):
    """The K1 chain under the supervised runtime: a reference run, then
    the restart, abort, skip_sequence, drop_oldest, watchdog and exporter
    drills, each held to the reference's bytes and the runtime's
    counters; and the guppi-ci8 arm plain and with the watchdog, health
    monitor and metrics exporter armed."""
    import gc
    import tempfile
    import threading
    import torch
    from bifrost_tpu_torch import xfer
    from bifrost_tpu_torch.telemetry import counters, histograms
    from bifrost_tpu_torch.testing import faults
    gulps = gulps if gulps is not None else [
        g[:DT] for g in make_gulps(seed=41, n=2)]
    blocks = drill_blocks(bt)
    res = {}
    gulp_bytes = gulps[0].nbytes

    # reference: each distinct gulp through the chain, no fault
    zero_counts(spec, gpu_kernels)
    p, b = drill_chain(bt, blocks, gulps, len(gulps))
    secs, _ = drill_run(p)
    seen = b['sink'].seen
    require(len(seen) == len(gulps) and not any(z for *_x, z in seen),
            'drill reference: %d outputs' % len(seen))
    expect = [crc for _s, _g, crc, _z in seen]
    launches = spec.launches
    # (the CPU rehearsal runs K1's plain version, which counts nothing);
    # the fused block's prewarm launches K1 once at sequence start
    require(launches == len(gulps) + b['fused'].prewarm_runs or
            not bt.device.on_cuda(),
            'drill reference: %d K1 launches for %d gulps and %d prewarm '
            'runs' % (launches, len(gulps), b['fused'].prewarm_runs))
    res['reference'] = {'seconds': secs, 'k1_launches': launches}
    del p, b
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()

    # restart: the source fails once at its third gulp and restarts
    counters.reset()
    zero_counts(spec, gpu_kernels)
    p, b = drill_chain(bt, blocks, gulps, ngulp,
                       src_kw={'on_failure': 'restart',
                               'restart_backoff': 0.05})
    with faults.injected('block.on_data', match=b['source'].name, count=1,
                         after=2):
        secs, _ = drill_run(p)
    seen = b['sink'].seen
    require(counters.get('block_restarts') == 1 and
            counters.get('block_failures') == 1,
            'restart drill: restarts %d, failures %d'
            % (counters.get('block_restarts'),
               counters.get('block_failures')))
    require(len(seen) == 2 + ngulp, 'restart drill: %d outputs, not %d'
            % (len(seen), 2 + ngulp))
    require(check_delivered('restart drill', seen, expect) == 0,
            'restart drill: zero-filled outputs')
    res['restart'] = {'seconds': secs, 'outputs': len(seen),
                      'sequences': b['sink'].nseq,
                      'block_restarts': counters.get('block_restarts'),
                      'k1_launches': spec.launches}
    log('supervision restart: %s' % json.dumps(res['restart']))
    del p, b

    # abort: K1's block fails at its third gulp under the default policy
    counters.reset()
    p, b = drill_chain(bt, blocks, gulps, ngulp)
    p.shutdown_timeout = 10.0
    with faults.injected('block.on_data', match=b['fused'].name, count=1,
                         after=2):
        secs, exc = drill_run(p, bt.PipelineRuntimeError)
    require(exc is not None, 'abort drill: run() did not raise')
    require(exc.primary.block_name == b['fused'].name and
            b['fused'].name in str(exc), 'abort drill: the error names %s'
            % exc.primary.block_name)
    require(secs < p.shutdown_timeout, 'abort drill: run() took %.2f s'
            % secs)
    alive = [t.name for t in p.threads if t.is_alive()]
    require(not alive, 'abort drill: threads alive %s' % alive)
    outstanding = xfer.engine().outstanding
    require(outstanding == 0, 'abort drill: %d transfers outstanding'
            % outstanding)
    res['abort'] = {'seconds': secs, 'health': p.health()['state'],
                    'cancelled_fills': counters.get('xfer.fills_cancelled'),
                    'ring_poisoned': counters.get('ring_poisoned')}
    del p, b, exc
    gc.collect()
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()
    require(mem1 <= mem0 + gulp_bytes, 'abort drill: %d bytes allocated '
            'after the run, %d before' % (mem1, mem0))
    res['abort'].update(mem_before=mem0, mem_after=mem1)
    log('supervision abort: %s' % json.dumps(res['abort']))

    # skip_sequence: two sequences, the first one's second gulp fails
    counters.reset()
    p, b = drill_chain(bt, blocks, gulps, 4, names=('a', 'b'),
                       k1_kw={'on_failure': 'skip_sequence'})
    with faults.injected('block.on_data', match=b['fused'].name, count=1,
                         after=1):
        secs, _ = drill_run(p)
    seen = b['sink'].seen
    second = [s for s in seen if s[0] == 1]
    require(counters.get('block_failures') == 1,
            'skip drill: %d failures' % counters.get('block_failures'))
    require([g for _s, g, _c, _z in second] == [0, 1, 2, 3],
            'skip drill: the second sequence delivered gulps %s'
            % [g for _s, g, _c, _z in second])
    require(len(seen) == 5 and check_delivered('skip drill', seen,
                                               expect) == 0,
            'skip drill: %d outputs' % len(seen))
    res['skip_sequence'] = {'seconds': secs, 'outputs': len(seen),
                            'sequences': b['sink'].nseq}
    log('supervision skip_sequence: %s' % json.dumps(res['skip_sequence']))
    del p, b

    # drop_oldest + exporter: the H2D ring sheds behind a sink that
    # runs K1 and sleeps between gulps
    Source, _c, SlowK1Sink, _k = blocks
    counters.reset()
    histograms.reset()
    zero_counts(spec, gpu_kernels)
    with tempfile.TemporaryDirectory() as tmp, environ(
            BF_HEALTH_INTERVAL='0.1', BF_METRICS_INTERVAL='0.5',
            BF_METRICS_FILE=os.path.join(tmp, 'metrics.prom'),
            BF_PROCLOG_DIR=os.path.join(tmp, 'proclog')):
        with bt.Pipeline() as p:
            src = Source(gulps, tap_gulps, pace=tap_idle / 5)
            h2d = bt.blocks.copy(src, space='cuda',
                                 overload_policy='drop_oldest')
            tap = SlowK1Sink(h2d, tap_idle, shed_tolerant=True)
        states, stop = [], threading.Event()

        def sample():
            while not stop.wait(0.02):
                states.append(p.health()['state'])
        st = threading.Thread(target=sample, daemon=True)
        st.start()
        try:
            secs, _ = drill_run(p)
        finally:
            stop.set()
            st.join(5)
        # the sheds since the monitor's last tick
        states.append(p.health()['state'])
        ring = h2d.orings[0]
        shed = ring.shed_stats()
        fb = gulp_bytes // gulps[0].shape[0]
        require(shed['shed_gulps'] > 0, 'drop_oldest drill: nothing shed')
        require(shed['shed_bytes'] == tap.skipped * fb,
                'drop_oldest drill: shed %d bytes, the sink skipped %d '
                'frames' % (shed['shed_bytes'], tap.skipped))
        require(shed['shed_gulps'] == tap_gulps - len(tap.seen),
                'drop_oldest drill: shed %d gulps, %d not delivered'
                % (shed['shed_gulps'], tap_gulps - len(tap.seen)))
        for g, crc in tap.seen:
            require(crc == expect[g % len(expect)], 'drop_oldest drill: '
                    'output of gulp %d differs from the K1 arm\'s bytes'
                    % g)
        require(spec.launches == len(tap.seen) or not bt.device.on_cuda(),
                'drop_oldest drill: %d K1 launches for %d gulps'
                % (spec.launches, len(tap.seen)))
        require('SHEDDING' in states, 'drop_oldest drill: health never '
                'SHEDDING (%s; %d monitor errors)'
                % (sorted(set(states)), counters.get('health.hook_errors')))
        prom = parse_prometheus(os.path.join(tmp, 'metrics.prom'))
        names = {k[1] for k in prom if k[0] == 'bifrost_tpu_counter_total'}
        for want_name in ('name="xfer.h2d_issued"',
                          'name="ring.%s.shed_gulps"' % ring.name,
                          'name="ring.%s.shed_bytes"' % ring.name):
            require(want_name in names, 'exporter drill: %s missing from '
                    'BF_METRICS_FILE' % want_name)
        require(prom.get(('bifrost_tpu_counter_total',
                          'name="ring.%s.shed_gulps"' % ring.name)) ==
                shed['shed_gulps'], 'exporter drill: shed count differs')
        require(prom.get(('bifrost_tpu_device_bytes',
                          'device="0",kind="in_use"'), 0) > 0 or
                not bt.device.on_cuda(),
                'exporter drill: no device-memory gauge')
        require(prom.get(('bifrost_tpu_hist_count',
                          'name="slo.exit_age_s"'), 0) == len(tap.seen),
                'exporter drill: slo.exit_age_s counts %s, not %d'
                % (prom.get(('bifrost_tpu_hist_count',
                             'name="slo.exit_age_s"')), len(tap.seen)))
        res['drop_oldest'] = {
            'seconds': secs, 'shed': shed, 'delivered': len(tap.seen),
            'k1_launches': spec.launches, 'states': sorted(set(states)),
            'transitions': counters.get('health.transitions')}
        res['exporter'] = {
            'series': len(prom),
            'device_in_use': prom.get(('bifrost_tpu_device_bytes',
                                       'device="0",kind="in_use"')),
            'exit_age_count': prom[('bifrost_tpu_hist_count',
                                    'name="slo.exit_age_s"')]}
        del p, src, h2d, tap
    log('supervision drop_oldest: %s' % json.dumps(res['drop_oldest']))
    log('supervision exporter: %s' % json.dumps(res['exporter']))

    # watchdog: the sink wedges; the run must raise PipelineStallError
    counters.reset()
    wedge = threading.Event()
    with environ(BF_WATCHDOG_SECS='2', BF_WATCHDOG_ESCALATE='1'):
        p, b = drill_chain(bt, blocks, gulps, ngulp,
                           sink_kw={'block': wedge, 'block_at': 1})
        p.shutdown_timeout = 1.0
        try:
            secs, exc = drill_run(p, bt.PipelineStallError)
        finally:
            wedge.set()
    require(exc is not None, 'watchdog drill: run() did not raise')
    stall_s = p.drill_end - b['sink'].blocked_at
    require(2.0 <= stall_s <= 6.0, 'watchdog drill: raised %.2f s after '
            'the sink wedged' % stall_s)
    require(counters.get('watchdog_stalls') == 1,
            'watchdog drill: %d stalls' % counters.get('watchdog_stalls'))
    res['watchdog'] = {'seconds': secs, 'raised_after_wedge_s': stall_s,
                       'stalls': counters.get('watchdog_stalls')}
    del p, b, exc
    log('supervision watchdog: %s' % json.dumps(res['watchdog']))
    return res


def phase_tier_overhead(bt, smi, runs=('plain', 'armed', 'armed', 'plain')):
    """Seconds of the guppi-ci8 arm (examples/gpuspec_simple_torch.py over
    GBLOCKS[8] blocks) with this tier quiet (no health thread, no watchdog,
    no metrics file) and armed (health monitor at 0.5 s, watchdog at
    10 s, metrics file every 1 s), in turns."""
    import importlib.util
    import tempfile
    here = os.path.dirname(os.path.abspath(__file__))
    mod = importlib.util.spec_from_file_location(
        'gpuspec_simple_torch',
        os.path.join(here, 'examples', 'gpuspec_simple_torch.py'))
    example = importlib.util.module_from_spec(mod)
    mod.loader.exec_module(example)
    out = {'plain': [], 'armed': []}
    crcs = set()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'bl8.raw')
        write_guppi(path, 8, GBLOCKS[8])
        modes = {
            'plain': dict(BF_HEALTH_INTERVAL='0', BF_WATCHDOG_SECS=None,
                          BF_METRICS_FILE=None, BF_METRICS_INTERVAL=None),
            'armed': dict(BF_HEALTH_INTERVAL='0.5', BF_WATCHDOG_SECS='10',
                          BF_METRICS_FILE=os.path.join(tmp, 'm.prom'),
                          BF_METRICS_INTERVAL='1')}
        for mode in runs:
            with environ(**modes[mode]):
                with bt.Pipeline() as p:
                    example.build([path], tmp, gulp_nframe=1, rfactor=GR)
                t0 = time.perf_counter()
                run_with_timeout(p, 300)
                out[mode].append(time.perf_counter() - t0)
            with open(path + '.fil', 'rb') as f:
                crcs.add(zlib.crc32(f.read()))
            os.remove(path + '.fil')
    require(len(crcs) == 1, 'tier overhead: the .fil differs between runs')
    out['overhead'] = (sum(out['armed']) / sum(out['plain'])) - 1.0
    log('guppi-ci8 seconds, tier quiet %s, armed %s: overhead %.1f%% (%s)'
        % (['%.3f' % x for x in out['plain']],
           ['%.3f' % x for x in out['armed']], 100 * out['overhead'], smi))
    return out


# ---------------------------------------------------------------------------
# the macro phase: macro-gulp spans, compiled segments, the halo carry and
# donation (bifrost_tpu_torch.macro, bifrost_tpu_torch.segments)
# ---------------------------------------------------------------------------

MACRO_K = 4
# spec arms: 9 gulps, so K = 4 runs two full batches and a partial batch of
# 1; beam-K4 5 gulps (4 + 1); fx-K4 4 gulps (one span: its D2H moves 8.6
# GB a span)
MSPEC_GULPS, MBEAM_GULPS, MFX_GULPS = 9, 5, 4


def settle_memory():
    """Free what earlier runs left (pipelines hold reference cycles) and
    start a fresh peak; returns the bytes still allocated, which an arm's
    peak is counted above."""
    import gc
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def block_gulps(snap, blk):
    """(dispatches, logical gulps) of ``blk`` on the counters."""
    return (snap.get('block.%s.dispatches' % blk.name, 0),
            snap.get('block.%s.gulps' % blk.name, 0))


def prewarm_runs(blocks):
    """Plan runs the FusedBlocks (and segments) of ``blocks`` made at
    sequence start: each launches the chain's kernels once."""
    return sum(getattr(b, 'prewarm_runs', 0) for b in blocks)


def check_elided(arm, seg):
    """No span was ever reserved or committed on a segment's interior
    rings."""
    for ring in seg._elided_rings:
        occ = ring.occupancy()
        require(occ['head'] == 0 and occ['reserve_head'] == 0 and
                not ring._storage.chunks,
                '%s: a span was reserved on the elided ring %s: %s'
                % (arm, ring.name, occ))


def macro_spec_arm(bt, spec, gpu_kernels, gulps, k, donate=None,
                   segments=None, unfused=False):
    """The flagship chain over MSPEC_GULPS gulps at batch ``k``: fused
    (K1) or, ``unfused``, separate fft, detect('stokes') and reduce blocks
    (K2); returns a record of its CRCs, first output, launches,
    dispatches, host ms a gulp and peak device memory."""
    import torch
    from bifrost_tpu_torch.stages import FftStage, DetectStage, ReduceStage
    from bifrost_tpu_torch.telemetry import counters
    header = {'name': 'guppi', 'time_tag': 0,
              '_tensor': {'shape': [-1, NPOL, NFINE], 'dtype': 'ci8',
                          'labels': ['time', 'pol', 'fine_time'],
                          'scales': [[0, 1]] * 3, 'units': [None] * 3}}
    blocks = []

    def chain(h2d):
        if unfused:
            b = bt.blocks.fft(h2d, axes='fine_time', axis_labels='freq')
            blocks.append(('fft', b))
            b = bt.blocks.detect(b, mode='stokes', axis='pol')
            blocks.append(('detect', b))
            blocks.append(('reduce', bt.blocks.reduce(b, 'freq', RFACTOR)))
        else:
            blocks.append(('fused', bt.blocks.fused(
                h2d, [FftStage('fine_time', axis_labels='freq'),
                      DetectStage('stokes', axis='pol'),
                      ReduceStage('freq', RFACTOR)])))
        return blocks

    counters.reset()
    zero_counts(spec, gpu_kernels)
    base = settle_memory()
    out, secs, per_gulp = drive(
        bt, gulps, header, chain, 1, MSPEC_GULPS - 1, digest=True,
        keep_first=True, scope={'gulp_batch': k, 'donate': donate,
                           'segments': segments})
    torch.cuda.synchronize()
    p = blocks[0][1].pipeline
    ran = p._segments + [b for _r, b in blocks if b in p.blocks]
    snap = counters.snapshot()
    rec = {'crc32': [out[i] for i in range(MSPEC_GULPS)],
           'first': out['first'], 'seconds': secs,
           'peak_bytes': torch.cuda.max_memory_allocated() - base,
           'base_bytes': base,
           'launches': read_counts(spec, gpu_kernels),
           'prewarm_runs': prewarm_runs(ran),
           'dispatches': {b.name.split('/')[-1]: block_gulps(snap, b)
                          for b in ran},
           # the chain's host time a logical gulp: working (process,
           # the dispatch and its ring commits) and in all
           'process_ms_per_gulp': {
               b.name.split('/')[-1]: b.perf_totals['process'] /
               max(b.perf_totals['nlogical'], 1) * 1e3 for b in ran},
           'host_ms_per_gulp': {
               b.name.split('/')[-1]:
                   sum(b.perf_totals[x] for x in
                       ('acquire', 'reserve', 'process')) /
                   max(b.perf_totals['nlogical'], 1) * 1e3 for b in ran},
           'per_gulp_ms': per_gulp,
           'donation': [snap.get('donation.hits', 0),
                        snap.get('donation.misses', 0)],
           'segments': [s.name for s in p._segments],
           'members': [s._members for s in p._segments],
           'elided': [s._elided for s in p._segments],
           'segment_compiled': snap.get('segment.compiled', 0),
           'impl': [getattr(b, 'impl_info', None) for b in ran],
           'batches': sorted({i.get('batch', 1) for b in ran
                              for i in getattr(b, '_plan_impls', {})
                              .values()})}
    for seg in p._segments:
        check_elided('spec %s' % seg.name, seg)
    del blocks[:], p, ran
    return rec


def phase_macro(bt, spec, gpu_kernels, beam, fx, smi):
    """The macro phase (see the module docstring's item 10m)."""
    import gc
    import torch
    from bifrost_tpu_torch.ops import fdmt as F
    from bifrost_tpu_torch.telemetry import counters
    res = {'k': MACRO_K}
    volts = make_gulps()
    rows = [0, 1, NTIME // 2, NTIME - 1]
    want0 = spec.spectrometer_oracle(volts[0][rows], RFACTOR)

    def show(arm, r):
        log('macro %s: crc32 %s; launches %s (%d prewarm runs); '
            'dispatches/gulps %s; process ms a gulp %s, host ms a gulp in '
            'all %s; peak device %.3f GB above the %.3f GB held before; '
            'donation hits/misses %s; %.3f s (%s)'
            % (arm, r['crc32'], {k: n for k, n in r['launches'].items()
                                 if n}, r['prewarm_runs'], r['dispatches'],
               {b: round(ms, 4)
                for b, ms in r['process_ms_per_gulp'].items()},
               {b: round(ms, 3) for b, ms in r['host_ms_per_gulp'].items()},
               r['peak_bytes'] / 1e9, r['base_bytes'] / 1e9, r['donation'],
               r['seconds'], smi))
        log_per_gulp(r['per_gulp_ms'])

    # spec-K4: the fused K1 chain at K = 1, K = 4, K = 4 donating
    spec_runs = {}
    for arm, k, donate in (('spec-K1', 1, None), ('spec-K4', MACRO_K, None),
                           ('spec-K4-donate', MACRO_K, True)):
        r = macro_spec_arm(bt, spec, gpu_kernels, volts, k, donate=donate)
        show(arm, r)
        spec_runs[arm] = r
        n = r['launches']
        nk1 = n['fused_spectrometer'] - r['prewarm_runs']
        ndisp = -(-MSPEC_GULPS // k)
        require(nk1 == ndisp, '%s: %d K1 launches for %d dispatches'
                % (arm, nk1, ndisp))
        require(n['fused_spectrometer_radix16'] == n['fused_spectrometer'],
                '%s: K1 off the radix-16 kernel' % arm)
        require(list(r['dispatches'].values()) == [(ndisp, MSPEC_GULPS)],
                '%s: dispatches/gulps %s, not %d/%d'
                % (arm, r['dispatches'], ndisp, MSPEC_GULPS))
        info = r['impl'][0]
        require(info.get('impl') == 'cuda-spectrometer' and
                info.get('kernel') == 'cuda' and k in r['batches'],
                '%s: the plan that ran last is %s, batches %s'
                % (arm, info, r['batches']))
        require(rel_err(r['first'][rows], want0) < GATE,
                '%s: output 0 is outside the gate of the oracle' % arm)
        if arm != 'spec-K1':
            require(r['crc32'] == spec_runs['spec-K1']['crc32'],
                    '%s: outputs differ from spec-K1' % arm)
        del r['first']
    require(spec_runs['spec-K4-donate']['donation'][0] > 0 and
            spec_runs['spec-K4-donate']['impl'][0].get('donate_argnums'),
            'spec-K4-donate: no donation (%s)'
            % spec_runs['spec-K4-donate']['donation'])
    fused_ms = {a: list(r['process_ms_per_gulp'].values())[0]
                for a, r in spec_runs.items()}
    log('macro spec: K = %d byte-identical to K = 1 with and without '
        'donation; the fused block\'s process ms a gulp %s; peak device '
        'memory above the start %s GB (%s)'
        % (MACRO_K, {a: round(v, 4) for a, v in fused_ms.items()},
           {a: round(r['peak_bytes'] / 1e9, 3)
            for a, r in spec_runs.items()}, smi))
    gc.collect()

    # spec-seg: separate fft, detect, reduce blocks at K = 4, segments off
    # and forced; and at K = 1 off (cuFFT at G against K * G frames)
    seg_runs = {}
    for arm, k, mode in (('seg-off', MACRO_K, 'off'),
                         ('seg-force', MACRO_K, 'force'),
                         ('seg-off-K1', 1, 'off')):
        r = macro_spec_arm(bt, spec, gpu_kernels, volts, k, segments=mode,
                           unfused=True)
        show('spec-%s' % arm, r)
        seg_runs[arm] = r
        ndisp = -(-MSPEC_GULPS // k)
        nk2 = r['launches']['stokes_detect'] - r['prewarm_runs']
        require(nk2 == ndisp, 'spec-%s: %d K2 launches for %d dispatches'
                % (arm, nk2, ndisp))
        require(r['launches']['fused_spectrometer'] == 0,
                'spec-%s: K1 ran in the unfused chain' % arm)
        require(rel_err(r['first'][rows], want0) < GATE,
                'spec-%s: output 0 is outside the gate of the oracle' % arm)
        del r['first']
    force = seg_runs['seg-force']
    require(force['segment_compiled'] == 1 and len(force['segments']) == 1,
            'spec-seg: %d segments compiled' % force['segment_compiled'])
    require([m.split('/')[-1].rsplit('_', 1)[0]
             for m in force['members'][0]] ==
            ['FftBlock', 'DetectBlock', 'ReduceBlock'],
            'spec-seg: the segment holds %s' % force['members'])
    require(list(force['dispatches'].values()) ==
            [(-(-MSPEC_GULPS // MACRO_K), MSPEC_GULPS)],
            'spec-seg: the segment\'s dispatches/gulps %s'
            % force['dispatches'])
    require(force['crc32'] == seg_runs['seg-off']['crc32'],
            'spec-seg: the segment\'s outputs differ from the unfused '
            'chain\'s at K = %d' % MACRO_K)
    cufft_equal = seg_runs['seg-off-K1']['crc32'] == \
        seg_runs['seg-off']['crc32']
    log('macro spec-seg: segment %s of %s, elided rings %s untouched, '
        'byte-identical to the unfused chain at K = %d; the unfused chain '
        'at K = 1 %s the K = %d bytes (cuFFT at %d against %d frames)'
        % (force['segments'][0], force['members'][0], force['elided'][0],
           MACRO_K, 'gives' if cufft_equal else 'does NOT give', MACRO_K,
           NTIME, NTIME * MACRO_K))
    res['spec'] = {k: {x: v for x, v in r.items() if x != 'impl'}
                   for k, r in spec_runs.items()}
    res['spec_seg'] = {k: {x: v for x, v in r.items() if x != 'impl'}
                       for k, r in seg_runs.items()}
    res['spec_seg']['cufft_k_gulp_bytes_equal'] = cufft_equal
    del force, volts
    gc.collect()
    torch.cuda.empty_cache()

    # frb-seg: config 22's stream, K3 forced, K = 4 segments 'auto' against
    # K = 1 segments 'off'
    t0 = time.perf_counter()
    ngulp = FWARM + FTIMED
    N = ngulp * FG
    noise, x = fdmt_stream()
    plan = F.Fdmt().init(FCH, FMD, FF0, FDF)
    nsteps = len(plan._plan['steps'])
    halo = FMD + FNTAP - 1
    thr = float(np.quantile(fdmt_oracle(plan, noise[:, :FG + halo], FNTAP)
                            .cpu().numpy(), 1.0 - FFAR))
    del noise
    host = x.cpu().numpy()
    del x
    expect = pulse_expect(plan)
    nout = N - halo
    frb = {}
    for arm, k, mode in (('frb-K1', 1, 'off'),
                         ('frb-seg', MACRO_K, 'auto')):
        blocks = []

        def frb_chain(h2d):
            b = bt.blocks.fdmt_stage(h2d, max_delay=FMD)
            blocks.append(('fdmt_stage', b))
            b = bt.blocks.matched_filter(b, FNTAP)
            blocks.append(('matched_filter', b))
            blocks.append(('threshold', bt.blocks.threshold(b, thr)))
            return blocks

        counters.reset()
        zero_counts(spec, gpu_kernels)
        base = settle_memory()
        with environ(BF_FDMT_IMPL='pallas'):
            out, _hdr, secs, secs_run, per_gulp, _ = run_fdmt_arm(
                bt, freq_time_source(bt, host), frb_chain, nout,
                scope={'gulp_batch': k, 'segments': mode})
        snap = counters.snapshot()
        p = blocks[0][1].pipeline
        ran = p._segments + [b for _r, b in blocks if b in p.blocks]
        n = read_counts(spec, gpu_kernels)['fdmt_step']
        ndisp = -(-ngulp // k)
        pre = prewarm_runs(ran)
        require(n == (ndisp + pre) * nsteps,
                '%s: %d K3 launches for %d dispatches and %d prewarm runs '
                'of %d steps' % (arm, n, ndisp, pre, nsteps))
        frb[arm] = {'seconds': secs, 'seconds_run': secs_run,
                    'k3_launches': n, 'prewarm_runs': pre,
                    'dispatches': {b.name.split('/')[-1]:
                                   block_gulps(snap, b) for b in ran},
                    'peak_bytes': torch.cuda.max_memory_allocated() - base,
                    'segment_compiled': snap.get('segment.compiled', 0),
                    'overlap_carried': snap.get('segment.overlap_carried',
                                                0),
                    'crc32': crc32(out)}
        log('macro %s: %s; per-gulp host ms %s (%s)'
            % (arm, json.dumps({x: v for x, v in frb[arm].items()}),
               {r: round(t['process'], 3) for r, t in per_gulp.items()},
               smi))
        if arm == 'frb-K1':
            ref = out
        else:
            require(len(p._segments) == 1 and
                    frb[arm]['overlap_carried'] == 1,
                    'frb-seg: segments %s, overlap_carried %d'
                    % (p._segments, frb[arm]['overlap_carried']))
            seg = p._segments[0]
            require([m.split('/')[-1].rsplit('_', 1)[0]
                     for m in seg._members] ==
                    ['FdmtStageBlock', 'MatchedFilterBlock',
                     'ThresholdBlock'],
                    'frb-seg: the segment holds %s' % seg._members)
            check_elided('frb-seg', seg)
            require(np.array_equal(out.view(np.uint32),
                                   ref.view(np.uint32)),
                    'frb-seg is not byte-identical to frb-K1')
            check_peaks('frb-seg', pulse_peaks(out, 1), expect)
            del seg
        del out, blocks, p, ran
        gc.collect()
    del ref, host
    torch.cuda.empty_cache()
    frb['setup_and_arms_s'] = time.perf_counter() - t0
    res['frb'] = frb

    # beam-K4: the beamformer pipeline's K6 block at K = 4 against K = 1
    bgulps = beam_gulps()
    w = beam_weights()
    beam_runs = {}
    for arm, k in (('beam-K1', 1), ('beam-K4', MACRO_K)):
        counters.reset()
        zero_counts(spec, gpu_kernels)
        out, secs, per_gulp, blk = run_beam_arm(
            bt, bgulps, w, 'K6', nwarm=1, ntimed=MBEAM_GULPS - 1,
            digest=True, scope={'gulp_batch': k})
        snap = counters.snapshot()
        n = read_counts(spec, gpu_kernels)
        ndisp = -(-MBEAM_GULPS // k)
        nk6 = n['beamform_detect_int8'] - blk.prewarm_runs
        require(nk6 == ndisp, '%s: %d K6 launches for %d dispatches'
                % (arm, nk6, ndisp))
        require(n['beamform_detect_int8_mma'] ==
                n['beamform_detect_int8'],
                '%s: K6 off its tensor-core kernel' % arm)
        require(blk.impl_info.get('impl') == 'cuda-beamform-detect',
                '%s: planned %s' % (arm, blk.impl_info))
        beam_runs[arm] = {'crc32': [out[i] for i in range(MBEAM_GULPS)],
                          'seconds': secs, 'k6_launches':
                          n['beamform_detect_int8'],
                          'prewarm_runs': blk.prewarm_runs,
                          'dispatches': block_gulps(snap, blk),
                          'per_gulp_ms': per_gulp}
        log('macro %s: %s (%s)' % (arm, json.dumps(beam_runs[arm]), smi))
        del blk
    require(beam_runs['beam-K4']['crc32'] == beam_runs['beam-K1']['crc32'],
            'beam-K4: outputs differ from K = 1')
    res['beam'] = beam_runs
    del bgulps
    gc.collect()
    torch.cuda.empty_cache()

    # fx-K4: the FX chain's CorrelateStageBlock (K7) at K = 4 against
    # K = 1, both against the FX phase's oracle
    fx_runs = {}
    want = [crc32(fx['oracle'][i % len(fx['gulps'])])
            for i in range(MFX_GULPS)]
    for arm, k in (('fx-K1', 1), ('fx-K4', MACRO_K)):
        counters.reset()
        zero_counts(spec, gpu_kernels)
        base = settle_memory()
        out, secs, per_gulp, info = run_fx_arm(
            bt, fx['gulps'], 'fx-K7', nwarm=1, ntimed=MFX_GULPS - 1,
            digest=True, scope={'gulp_batch': k})
        n = read_counts(spec, gpu_kernels)['xcorr_herm']
        ndisp = -(-MFX_GULPS // k)
        require(n == ndisp, '%s: %d K7 launches for %d dispatches'
                % (arm, n, ndisp))
        crcs = [out[i] for i in range(MFX_GULPS)]
        require(crcs == want, '%s: outputs differ from the oracle' % arm)
        fx_runs[arm] = {'crc32': crcs, 'seconds': secs, 'k7_launches': n,
                        'peak_bytes': torch.cuda.max_memory_allocated() -
                        base,
                        'per_gulp_ms': per_gulp}
        log('macro %s: %s (%s)' % (arm, json.dumps(fx_runs[arm]), smi))
        gc.collect()
        torch.cuda.empty_cache()
    res['fx'] = fx_runs
    res['launches'] = {
        'K1': {a: r['launches']['fused_spectrometer']
               for a, r in res['spec'].items()},
        'K2': {a: r['launches']['stokes_detect']
               for a, r in res['spec_seg'].items()
               if isinstance(r, dict)},
        'K3': {a: r['k3_launches'] for a, r in frb.items()
               if isinstance(r, dict)},
        'K6': {a: r['k6_launches'] for a, r in beam_runs.items()},
        'K7': {a: r['k7_launches'] for a, r in fx_runs.items()}}
    log('macro launches: %s' % json.dumps(res['launches']))
    return res


# ---------------------------------------------------------------------------
# the analysis phase: the static verifier, the ring-protocol checker, the
# native ring core, the one-shot profiler and the repaired shed ledger
# ---------------------------------------------------------------------------

# pipelines the verifier checked in this process: (pipeline, sorted codes,
# ms of the check), recorded by the wrapper main() puts around gate_run
VERIFIED = []
# the flagship K1 chain under BF_TORCH_PROFILE: 1 warm-up and 2 timed
# full-width gulps; the repaired drop_oldest ledger's runs
AWARM, ATIMED, LEDGER_RUNS = 1, 2, 20
CORRUPT_CASES = (('double_commit', 'double_commit'),
                 ('double_release', 'double_release'),
                 ('acquire_uncommitted', 'acquire_uncommitted'),
                 ('guarantee_jump', 'guarantee_pin'),
                 ('poison_nowake', 'poison_wake'),
                 ('resize_under_span', 'resize_quiescence'))


def record_verifier():
    """Wrap the verifier's run() gate so that every pipeline this process
    runs leaves its diagnostics' codes and the check's ms in VERIFIED."""
    from bifrost_tpu_torch.analysis import verify
    gate = verify.gate_run

    def recorded(pipeline, mode):
        t0 = time.perf_counter()
        diags = gate(pipeline, mode)
        VERIFIED.append((pipeline.name, sorted(d.code for d in diags),
                         (time.perf_counter() - t0) * 1e3))
        return diags
    verify.gate_run = recorded


def load_example():
    import importlib.util
    here = os.path.dirname(os.path.abspath(__file__))
    mod = importlib.util.spec_from_file_location(
        'gpuspec_simple_torch',
        os.path.join(here, 'examples', 'gpuspec_simple_torch.py'))
    example = importlib.util.module_from_spec(mod)
    mod.loader.exec_module(example)
    return example


def analysis_guppi_run(bt, spec, gpu_kernels, path, tmp, checker, native):
    """One guppi-ci8 run of the example's chain under BF_VALIDATE=strict,
    with BF_RINGCHECK on or off; the 'system' rings must be on the core
    asked for.  Returns the .fil's CRC, the rate and the kernel launches
    (none: the chain's 524,288-point FFT is above K1's 8192 and runs on
    cuFFT, as in the guppi phase)."""
    from bifrost_tpu_torch.analysis import ringcheck
    from bifrost_tpu_torch.ring_native import NativeRing
    example = load_example()
    ntime = GBLOCSIZE * 8 // (GCH * NPOL * 2 * 8)
    ringcheck.reset()
    with environ(BF_VALIDATE='strict',
                 BF_RINGCHECK='1' if checker else None):
        with bt.Pipeline() as p:
            example.build([path], tmp, gulp_nframe=1, rfactor=GR)
        rings = {id(r): r for b in p.blocks for r in b.orings}.values()
        for r in rings:
            want = native and r.space == 'system'
            require(isinstance(r, NativeRing) == want,
                    'analysis: %s ring %s is %s' % (r.space, r.name,
                                                    type(r).__name__))
        zero_counts(spec, gpu_kernels)
        t0 = time.perf_counter()
        run_with_timeout(p, 300)
        secs = time.perf_counter() - t0
        launches = {k: n for k, n in read_counts(spec, gpu_kernels).items()
                    if n}
    ringcheck.set_enabled(False)
    viol = ringcheck.violations()
    require(not viol, 'analysis: ringcheck violations %s' % viol[:3])
    fil = path + '.fil'
    with open(fil, 'rb') as f:
        crc = zlib.crc32(f.read())
    os.remove(fil)
    return {'crc32': crc, 'seconds': secs, 'launches': launches,
            'msps': GBLOCKS[8] * GCH * ntime * NPOL / secs / 1e6,
            'system_rings': sum(1 for r in rings if r.space == 'system')}


def guppi_child(path, tmp):
    """``chip_smoke.py --guppi-child RAW DIR``: the guppi-ci8 runs on the
    Python ring core (BF_NO_NATIVE=1), checker off then on; prints one
    JSON line with their CRCs and rates."""
    import torch
    import bifrost_tpu_torch as bt
    from bifrost_tpu_torch import _build
    from bifrost_tpu_torch.ops import gpu_kernels
    from bifrost_tpu_torch.ops import spectrometer as spec
    os.environ['BF_NO_NATIVE'] = '1'
    bt.device.set_device('cuda:0')
    _build.build()
    out = {}
    for checker in (False, True):
        out['checker_on' if checker else 'checker_off'] = \
            analysis_guppi_run(bt, spec, gpu_kernels, path, tmp, checker,
                               native=False)
        torch.cuda.empty_cache()
    print('GUPPI_CHILD ' + json.dumps(out), flush=True)
    return 0


def profile_summary(trace):
    """The five kernels with the most device time in a torch.profiler
    Chrome trace, and the device's busy share of the capture's window
    (kernels and copies, overlaps merged)."""
    with open(trace) as f:
        events = [e for e in json.load(f)['traceEvents']
                  if 'ts' in e and 'dur' in e]
    by_name = {}
    busy = []
    for e in events:
        if e.get('cat') == 'kernel':
            by_name[e['name']] = by_name.get(e['name'], 0.0) + e['dur']
        if e.get('cat') in ('kernel', 'gpu_memcpy', 'gpu_memset'):
            busy.append((e['ts'], e['ts'] + e['dur']))
    t0 = min(e['ts'] for e in events)
    t1 = max(e['ts'] + e['dur'] for e in events)
    merged, end = 0.0, None
    for a, b in sorted(busy):
        if end is None or a > end:
            merged += b - a
            end = b
        elif b > end:
            merged += b - end
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return ([{'name': n, 'ms': us / 1e3} for n, us in top],
            merged / (t1 - t0) if t1 > t0 else 0.0, (t1 - t0) / 1e3)


def analysis_profile(bt, spec, gpu_kernels, tmp):
    """The flagship fused K1 chain (16384 x 2 x 4096, r 4) with
    BF_TORCH_PROFILE armed: one capture of its first dispatch."""
    from bifrost_tpu_torch.stages import FftStage, DetectStage, ReduceStage
    from bifrost_tpu_torch.telemetry import counters, profiling
    volts = make_gulps(n=2)
    blocks = []

    def chain(h2d):
        blocks.append(('fused', bt.blocks.fused(
            h2d, [FftStage('fine_time', axis_labels='freq'),
                  DetectStage('stokes', axis='pol'),
                  ReduceStage('freq', RFACTOR)])))
        return blocks
    profiling.reset()
    counters.reset()
    zero_counts(spec, gpu_kernels)
    with environ(BF_TORCH_PROFILE=os.path.join(tmp, 'torchprof')):
        _out, secs, _pg = drive(bt, volts, spec_header(NFINE), chain,
                                nwarm=AWARM, ntimed=ATIMED, digest=True)
    launches = spec.launches
    trace = profiling.last_trace()
    profiling.reset()
    require(counters.get('torchprof.captures') == 1,
            'analysis: %d profiler captures' %
            counters.get('torchprof.captures'))
    require(trace is not None and os.path.exists(trace),
            'analysis: no profiler trace')
    # the fused block's prewarm runs the plan once at sequence start
    want = AWARM + ATIMED + prewarm_runs([b for _r, b in blocks])
    require(launches == want, 'analysis: %d K1 launches for %d gulps and '
            'the prewarm' % (launches, AWARM + ATIMED))
    top, share, window_ms = profile_summary(trace)
    require(any('spectrometer' in k['name'] for k in top),
            'analysis: K1 not among the profiled kernels %s' % top)
    return {'top_kernels': top, 'busy_share': share,
            'window_ms': window_ms, 'k1_launches': launches,
            'msps': ATIMED * NTIME * NPOL * NFINE / secs / 1e6}


def corrupt_drill(bt, space, case):
    """One ring.corrupt.* seam on a ``space`` ring; returns the invariant
    the checker raised."""
    import threading
    import torch
    from bifrost_tpu_torch.analysis import ringcheck
    from bifrost_tpu_torch.analysis.ringcheck import RingProtocolError
    from bifrost_tpu_torch.ring import Ring, RingPoisonedError
    from bifrost_tpu_torch.testing import faults
    ring = Ring(space=space, name='drill_%s_%s' % (space, case))
    hdr = {'name': 's', 'gulp_nframe': 8,
           '_tensor': {'shape': [-1, 1024], 'dtype': 'f32'}}
    seq = ring.begin_writing().begin_sequence(hdr, 8, 16)
    site = 'ring.corrupt.' + case

    def put(val):
        with seq.reserve(8) as sp:
            if space == 'cuda':
                sp.set(torch.full((8, 1024), val, device='cuda'))
            else:
                sp.data.as_numpy()[...] = val
            sp.commit(8)
    try:
        if case == 'double_commit':
            with faults.injected(site, match=ring.name):
                put(1.0)
        elif case == 'resize_under_span':
            seq.reserve(8)
            with faults.injected(site, match=ring.name):
                ring.request_resize(1, ring.total_span * 2)
        elif case == 'poison_nowake':
            woke = []

            def reader():
                try:
                    ring.open_earliest_sequence().acquire(0, 8)
                except RingPoisonedError:
                    woke.append(True)
            t = threading.Thread(target=reader, daemon=True)
            t.start()
            time.sleep(0.2)
            with faults.injected(site, match=ring.name):
                ring.poison(RuntimeError('drill'))
            deadline = time.monotonic() + 5
            while not ringcheck.violations() and \
                    time.monotonic() < deadline:
                time.sleep(0.05)
            ring._wake_all()
            t.join(5)
            require(woke, 'analysis: the poisoned reader never woke')
            seq.reserve(8)      # the next seam touch raises the record
        else:
            put(1.0)
            put(2.0)
            rseq = ring.open_earliest_sequence(guarantee=True)
            if case == 'double_release':
                span = rseq.acquire(0, 8)
                with faults.injected(site, match=ring.name):
                    span.release()
            elif case == 'acquire_uncommitted':
                with faults.injected(site, match=ring.name):
                    rseq.acquire(8, 8)
            else:
                with faults.injected(site, match=ring.name):
                    rseq.acquire(0, 8)
                put(3.0)
    except RingProtocolError as exc:
        return exc.invariant
    finally:
        faults.clear()
    return None


def ledger_run(bt):
    """The drop_oldest card test's scenario: a reader that idles between
    spans of a cuda ring is shed past whole gulps.  Returns (shed bytes,
    skipped frames, shed gulps, gulps read, values right, peak held
    bytes within capacity)."""
    import threading
    import torch
    from bifrost_tpu_torch.ring import Ring, EndOfDataStop
    ring = Ring(space='cuda', name='drop_oldest_ledger')
    ring.set_overload_policy('drop_oldest')
    hdr = {'name': 's', 'gulp_nframe': 4,
           '_tensor': {'shape': [-1, 1024], 'dtype': 'f32'}}
    gulps = [torch.full((4, 1024), float(i), device='cuda')
             for i in range(40)]
    held, got, skipped = [], [], [0]
    ready = threading.Event()

    def reader():
        seq = ring.open_earliest_sequence(guarantee=True)
        ready.set()
        off = 0
        while True:
            try:
                sp = seq.acquire(off, 4)
            except EndOfDataStop:
                break
            skipped[0] += sp.frame_offset - off
            if sp.nframe:
                got.append((sp.frame_offset // 4, float(sp.data[0, 0])))
            nxt = sp.frame_offset + sp.nframe
            sp.release()
            if not sp.nframe and nxt <= off:
                break
            off = nxt
            time.sleep(0.01)
        seq.close()

    with ring.begin_writing() as w:
        with w.begin_sequence(hdr, 4, 12) as s:
            t = threading.Thread(target=reader, daemon=True)
            t.start()
            require(ready.wait(10), 'analysis: the ledger reader never '
                    'started')
            for g in gulps:
                with s.reserve(4) as sp:
                    sp.set(g)
                    sp.commit(4)
                held.append(sum(c[0] for c in
                                ring._storage.chunks.values()))
    t.join(30)
    require(not t.is_alive(), 'analysis: the ledger reader hung')
    shed = ring.shed_stats()
    return (shed['shed_bytes'], skipped[0], shed['shed_gulps'], len(got),
            all(v == float(i) for i, v in got),
            max(held) <= ring.total_span)


def phase_analysis(bt, spec, gpu_kernels, smi):
    """The static verifier, the ring-protocol checker and the native ring
    core on the Guppi chain, the profiler on the flagship K1 chain, the
    ring.corrupt.* drills, the repaired drop_oldest ledger and the
    verifier's codes for every pipeline this script ran."""
    import tempfile
    import torch
    from bifrost_tpu_torch.analysis import ringcheck
    out = {'card': smi}
    here = os.path.abspath(__file__)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'bl8.raw')
        write_guppi(path, 8, GBLOCKS[8])
        runs = {}
        for checker in (False, True):
            key = 'checker_on' if checker else 'checker_off'
            n_before = len(VERIFIED)
            runs[key] = analysis_guppi_run(bt, spec, gpu_kernels, path,
                                           tmp, checker, native=True)
            require(len(VERIFIED) == n_before + 1,
                    'analysis: the verifier did not run at start-up')
            runs[key]['codes'] = VERIFIED[-1][1]
            runs[key]['verify_ms'] = VERIFIED[-1][2]
            torch.cuda.empty_cache()
        p = subprocess.run([sys.executable, here, '--guppi-child', path,
                            tmp], capture_output=True, text=True,
                           timeout=600)
        child = [line for line in p.stdout.splitlines()
                 if line.startswith('GUPPI_CHILD ')]
        require(p.returncode == 0 and child, 'analysis: the Python-core '
                'child failed (rc %d): %s' % (p.returncode,
                                              p.stderr[-2000:]))
        python = json.loads(child[-1][len('GUPPI_CHILD '):])
        crcs = {r['crc32'] for r in list(runs.values()) +
                list(python.values())}
        require(len(crcs) == 1, 'analysis: the .fil differs between the '
                'native and Python cores: %s' % crcs)
        log_crc('analysis guppi-ci8 .fil (both cores)', crcs.pop())
        out['guppi_ci8'] = {'native': runs, 'python': python,
                            'blocks': GBLOCKS[8]}
        log('analysis guppi-ci8 (BF_VALIDATE=strict): codes %s, verifier '
            '%.1f ms at start-up; Msamples/s native %.1f / %.1f, Python '
            '%.1f / %.1f (checker off / on) (%s)'
            % (runs['checker_off']['codes'],
               runs['checker_off']['verify_ms'],
               runs['checker_off']['msps'], runs['checker_on']['msps'],
               python['checker_off']['msps'],
               python['checker_on']['msps'], smi))
        # K2 on its path under the gate and the checker: the unfused
        # spectrometer chain (substitute off)
        from bifrost_tpu_torch.stages import FftStage, DetectStage, \
            ReduceStage

        k2_blocks = []

        def k2_chain(h2d):
            k2_blocks.append(('fused', bt.blocks.fused(
                h2d, [FftStage('fine_time', axis_labels='freq'),
                      DetectStage('stokes', axis='pol'),
                      ReduceStage('freq', RFACTOR)], substitute=False)))
            return k2_blocks
        ringcheck.reset()
        zero_counts(spec, gpu_kernels)
        with environ(BF_VALIDATE='strict', BF_RINGCHECK='1'):
            drive(bt, make_gulps(n=1), spec_header(NFINE), k2_chain,
                  nwarm=1, ntimed=1, digest=True)
        ringcheck.set_enabled(False)
        k2 = gpu_kernels.launches['stokes_detect']
        require(k2 == 2 + prewarm_runs([b for _r, b in k2_blocks]) and
                not ringcheck.violations(),
                'analysis: K2 arm %d launches, violations %s'
                % (k2, ringcheck.violations()[:2]))
        out['k2_arm'] = {'launches': k2, 'codes': VERIFIED[-1][1]}
        out['profile'] = analysis_profile(bt, spec, gpu_kernels, tmp)
        log('analysis profile (one K1 dispatch of 16384 x 2 x 4096, '
            'not a cell): window %.3f ms, device busy %.1f%%, top '
            'kernels %s (%s)'
            % (out['profile']['window_ms'],
               100 * out['profile']['busy_share'],
               json.dumps(out['profile']['top_kernels']), smi))
    # the corruption drills on a cuda ring and a native system ring
    from bifrost_tpu_torch.ring import Ring
    from bifrost_tpu_torch.ring_native import NativeRing
    require(isinstance(Ring(space='system'), NativeRing),
            'analysis: a system ring is not native')
    drills = {}
    with environ(BF_RINGCHECK_WAKE_SECS='0.2'):
        ringcheck.set_enabled(True)
        try:
            for space in ('cuda', 'system'):
                for case, invariant in CORRUPT_CASES:
                    ringcheck.reset()
                    got = corrupt_drill(bt, space, case)
                    require(got == invariant, 'analysis: %s on a %s ring '
                            'raised %r, not %r' % (case, space, got,
                                                   invariant))
                    drills['%s/%s' % (space, case)] = got
        finally:
            ringcheck.set_enabled(False)
            ringcheck.reset()
    out['drills'] = drills
    log('analysis drills: every ring.corrupt.* seam raised its invariant '
        'on a cuda ring and a native system ring: %s' % json.dumps(drills))
    ledgers = []
    for _ in range(LEDGER_RUNS):
        shed, skipped, shed_gulps, nread, values_ok, held_ok = \
            ledger_run(bt)
        require(shed > 0 and shed == skipped * 4096 and
                shed_gulps == 40 - nread and values_ok and held_ok,
                'analysis: drop_oldest ledger %d bytes for %d skipped '
                'frames, %d shed gulps for %d read, values %s, held %s'
                % (shed, skipped, shed_gulps, nread, values_ok, held_ok))
        ledgers.append([shed, skipped])
    out['ledger_runs'] = ledgers
    log('analysis drop_oldest ledger: %d runs, shed bytes = skipped '
        'frames x 4096 every time: %s' % (LEDGER_RUNS, ledgers))
    # every pipeline of this process: no BF-E, no BF-I199
    bad = [(n, c) for n, c, _ms in VERIFIED
           if any(x.startswith('BF-E') or x == 'BF-I199' for x in c)]
    require(VERIFIED and not bad, 'analysis: verifier errors %s' % bad[:5])
    per_chain = {}
    for n, c, ms in VERIFIED:
        key = ' '.join(c) or '(none)'
        per_chain.setdefault(key, []).append(round(ms, 2))
    out['verified_pipelines'] = len(VERIFIED)
    out['codes_per_chain'] = {k: {'pipelines': len(v), 'max_ms': max(v)}
                              for k, v in per_chain.items()}
    log('analysis verifier: %d pipelines, no BF-E and no BF-I199; codes '
        'per chain %s' % (len(VERIFIED), json.dumps(out['codes_per_chain'])))
    return out


# ---------------------------------------------------------------------------
# capture: live CHIPS packets over loopback into an LWA-style correlator
# front end (the port's io tier: UDP sockets, the CHIPS codec, the native
# and sharded capture engines, the native transmit engine)
# ---------------------------------------------------------------------------

CS, CCH, CST, CPOL = 16, 132, 16, 2   # boards, channels, stands a board, pols
CPAY = CCH * CST * CPOL               # ci4 payload: 4,224 bytes
CHDR = 16                             # the CHIPS header
CG = 1024                             # frames a gulp (one capture span)
CR, CA = 1024, 2                      # correlate's R, accumulate's A
CNG = 4                               # gulps an arm sends
CRATES = (100000, 50000, 25000, 12500, 6250)   # throttled arms, packets/s
CREAL_FPS = 25000.0                   # LWA real time: ~25 kHz channels
CSEED = 41
CTHREADS = 16                         # sharded workers, one a board
CVLEN = 64
CTIMEOUT = 0.5                        # idle seconds that end a capture
CSHARDED_SPACE = 'cuda_host'


def capture_payloads(seed=CSEED, ngulp=CNG):
    """The arm's payloads, (frames, boards, 4,224) uint8: random ci4
    bytes, made alike by the sender, the blaster and the checks."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(ngulp * CG, CS, CPAY), dtype=np.uint8)


def capture_header(desc):
    """The capture ring's sequence header: (time, src, freq, stand, pol)
    ci4; a board's stands continue the one before (src's scale step is
    CST), so merge_axes(src, stand) gives the station axis."""
    return 0, {'name': 'chips-lwa', 'time_tag': 0, '_tensor': {
        'shape': [-1, CS, CCH, CST, CPOL], 'dtype': 'ci4',
        'labels': ['time', 'src', 'freq', 'stand', 'pol'],
        'scales': [[0, 1], [0, CST], [0, 1], [0, 1], [0, 1]],
        'units': [None] * 5}}


def capture_sender(port, rate, seed):
    """Child process of a throttled arm: the port's UDPTransmit (the
    native transmit engine) paced at ``rate`` packets/s, one frame (16
    packets) a call.  Frame 0 goes first; the rest after a line on
    stdin."""
    from bifrost_tpu_torch.io.udp_socket import Address, UDPSocket
    from bifrost_tpu_torch.io.packet_writer import (HeaderInfo, UDPTransmit,
                                                    NativeUDPTransmit)
    data = capture_payloads(int(seed))
    sock = UDPSocket().connect(Address('127.0.0.1', int(port)))
    hi = HeaderInfo()
    hi.set_nsrc(CS)
    hi.set_nchan(CCH)
    tx = UDPTransmit('chips', sock)
    require(isinstance(tx, NativeUDPTransmit),
            'the sender is not the native transmit engine')
    tx.send(hi, 1, 1, 0, 1, data[:1])          # CHIPS wire seq is 1-based
    print('READY', flush=True)
    sys.stdin.readline()
    tx.set_rate_limit(int(rate))               # the bucket starts now
    t0 = time.perf_counter()
    for i in range(1, data.shape[0]):
        tx.send(hi, i + 1, 1, 0, 1, data[i:i + 1])
    print('SENT %d %.6f' % (tx.npackets_sent - CS,
                            time.perf_counter() - t0), flush=True)
    sock.close()
    return 0


def capture_blaster(port, seed):
    """Child process of an unthrottled arm: ``sendmmsg`` as fast as the
    host goes, one socket (one flow) a board, the iovec tables built
    over the frame buffers before the clock starts (after the JAX
    package's bench_suite.py blaster).  Frame 0 goes first; the rest
    after a line on stdin, 64 frames a board in turn."""
    import ctypes
    import errno
    import select
    import socket
    import struct

    class _iovec(ctypes.Structure):
        _fields_ = [('iov_base', ctypes.c_void_p),
                    ('iov_len', ctypes.c_size_t)]

    class _msghdr(ctypes.Structure):
        _fields_ = [('msg_name', ctypes.c_void_p),
                    ('msg_namelen', ctypes.c_uint),
                    ('msg_iov', ctypes.c_void_p),
                    ('msg_iovlen', ctypes.c_size_t),
                    ('msg_control', ctypes.c_void_p),
                    ('msg_controllen', ctypes.c_size_t),
                    ('msg_flags', ctypes.c_int)]

    class _mmsghdr(ctypes.Structure):
        _fields_ = [('msg_hdr', _msghdr), ('msg_len', ctypes.c_uint)]

    libc = ctypes.CDLL(None, use_errno=True)
    msize = ctypes.sizeof(_mmsghdr)
    hdr = struct.Struct('>BBBBBBHQ')
    data = capture_payloads(int(seed))
    nt, frame = data.shape[0], CHDR + CPAY
    seqs = np.arange(nt, dtype=np.int64)
    socks, tables = [], []
    for s in range(CS):
        sk = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sk.connect(('127.0.0.1', int(port)))
        buf = np.empty((nt, frame), np.uint8)
        buf[:, :CHDR] = np.frombuffer(
            hdr.pack(s + 1, 0, CCH, 1, 0, CS, 0, 0), np.uint8)
        buf[:, 8:16] = (seqs + 1).astype('>u8').view(np.uint8).reshape(-1, 8)
        buf[:, CHDR:] = data[:, s]
        iov = (_iovec * nt)()
        mh = (_mmsghdr * nt)()
        iov_np = np.frombuffer(iov, np.uint64).reshape(nt, 2)
        iov_np[:, 0] = buf.ctypes.data + np.arange(nt, dtype=np.uint64) * \
            frame
        iov_np[:, 1] = frame
        mh_np = np.frombuffer(mh, np.uint64).reshape(nt, msize // 8)
        mh_np[:, 2] = ctypes.addressof(iov) + \
            np.arange(nt, dtype=np.uint64) * ctypes.sizeof(_iovec)
        mh_np[:, 3] = 1
        socks.append(sk)
        tables.append((buf, iov, mh, ctypes.addressof(mh)))
    del data

    def blast(fd, base, off, want):
        done = 0
        while done < want:
            ctypes.set_errno(0)
            n = libc.sendmmsg(fd, ctypes.cast(base + (off + done) * msize,
                                              ctypes.POINTER(_mmsghdr)),
                              want - done, 0)
            if n < 0:
                err = ctypes.get_errno()
                if err in (errno.EAGAIN, errno.EWOULDBLOCK, errno.ENOBUFS):
                    select.select([], [fd], [], 0.05)
                    continue
                if err == errno.EINTR:
                    continue
                raise OSError(err, 'sendmmsg')
            done += n
        return done

    for s in range(CS):
        blast(socks[s].fileno(), tables[s][3], 0, 1)
    print('READY', flush=True)
    sys.stdin.readline()
    sent = 0
    t0 = time.perf_counter()
    for k in range(1, nt, 64):
        want = min(64, nt - k)
        for s in range(CS):
            sent += blast(socks[s].fileno(), tables[s][3], k, want)
    print('SENT %d %.6f' % (sent, time.perf_counter() - t0), flush=True)
    for sk in socks:
        sk.close()
    return 0


def capture_oracle(gulp):
    """One gulp's visibilities on the card from its tapped ci4 bytes:
    the nibbles unpacked with shifts (re high, im low), reordered to
    (time, freq, station, pol) and multiplied in float64 (K7's plain
    version).  Returns (F, N, N) on the card."""
    import torch
    from bifrost_tpu_torch.ops.gpu_kernels import xcorr_herm_plain
    from bifrost_tpu_torch.device import get_device
    u = torch.from_numpy(gulp).to(get_device()).view(CG, CS, CCH, CST, CPOL)
    re = u.view(torch.int8) >> 4
    im = (u << 4).view(torch.int8) >> 4
    n = CS * CST * CPOL
    re = re.permute(0, 2, 1, 3, 4).reshape(1, CG, CCH, n)
    im = im.permute(0, 2, 1, 3, 4).reshape(1, CG, CCH, n)
    return xcorr_herm_plain(re, im)[0]


def capture_child(which, port, rate=None):
    """Start a sender or blaster child; returns the Popen once it has
    sent frame 0 (its READY line)."""
    import select
    here = os.path.abspath(__file__)
    args = [sys.executable, here, '--capture-' + which, str(port)]
    if rate is not None:
        args.append(str(rate))
    args.append(str(CSEED))
    child = subprocess.Popen(args, stdin=subprocess.PIPE,
                             stdout=subprocess.PIPE, text=True)
    ready, _, _ = select.select([child.stdout], [], [], 120)
    line = child.stdout.readline() if ready else ''
    if line.strip() != 'READY':
        child.kill()
        child.wait()
        raise RuntimeError('chip_smoke check failed: capture %s child did '
                           'not start (%r)' % (which, line))
    return child


def capture_arm(bt, gpu_kernels, arm, engine, which, rate, payloads, smi):
    """One arm: the capture engine fills a host ring from the child's
    packets while the chain runs on the card:

        capture ring -> copy('cuda') -> transpose(time, freq, src, stand,
        pol) -> merge_axes(src, stand) -> correlate(CR, int8, K7 forced)
        -> accumulate(CA) -> copy('system') -> sink

    with a guaranteed host tap on the capture ring.  Checks the ledger,
    the tapped bytes against what was sent, every visibility against
    the float64 oracle made from the tapped bytes, K7 once a gulp and
    (sharded) the direct H2D.  Returns the arm's numbers."""
    import threading
    import torch
    from bifrost_tpu_torch.io import packet_capture as pc
    from bifrost_tpu_torch.io.udp_socket import Address, UDPSocket
    from bifrost_tpu_torch.ring_native import NativeRing
    from bifrost_tpu_torch.telemetry import counters
    name = '%s-%d' % (arm, rate or 0)
    nt = CNG * CG
    rx = None
    if engine == 'native':
        ring = bt.Ring(space='system', name=name)
        rx = UDPSocket().bind(Address('127.0.0.1', 0))
        rx.set_timeout(CTIMEOUT)
        cap = pc.UDPCapture('chips', rx, ring, CS, 0, CPAY, CG, CG,
                            capture_header)
        require(isinstance(ring, NativeRing) and
                isinstance(cap, pc.NativeUDPCapture),
                '%s: not the native engine on a native ring (%s on %s)'
                % (arm, type(cap).__name__, type(ring).__name__))
        socks = [rx]
    else:
        ring = bt.Ring(space=CSHARDED_SPACE, name=name)
        cap = pc.ShardedUDPCapture(
            'chips', Address('127.0.0.1', 0), ring, CS, 0, CPAY, CG, CG,
            capture_header, nthreads=CTHREADS, vlen=CVLEN,
            frame_size=CHDR + CPAY, timeout=CTIMEOUT)
        require(cap._zero_copy_ok, '%s: zero-copy scatter not possible' % arm)
        socks = cap._socks
    import socket as socket_mod
    rcvbuf = socks[0].sock.getsockopt(socket_mod.SOL_SOCKET,
                                      socket_mod.SO_RCVBUF)
    port = socks[0].sock.getsockname()[1]
    tapped = np.zeros((nt, CS, CPAY), np.uint8)
    outs = []

    class Tap(bt.SinkBlock):
        def on_sequence(self, iseq):
            self.f = 0

        def on_data(self, ispan):
            n = min(ispan.nframe, nt - self.f)
            a = ispan.data.as_numpy().reshape(ispan.nframe, CS, CPAY)
            tapped[self.f:self.f + n] = a[:n]
            self.f += ispan.nframe

    class VisSink(bt.SinkBlock):
        def on_sequence(self, iseq):
            pass

        def on_data(self, ispan):
            outs.append(np.array(ispan.data.as_numpy(), copy=True))

    x0 = {k: counters.get('xfer.' + k) for k in ('h2d_direct', 'h2d_staged')}
    for k in gpu_kernels.launches:
        gpu_kernels.launches[k] = 0
    box = {}
    with bt.Pipeline() as p:
        h2d = bt.blocks.copy(ring, space='cuda')
        tap = Tap(ring)
        b = bt.blocks.transpose(h2d, ['time', 'freq', 'src', 'stand', 'pol'])
        tr = b
        b = bt.views.merge_axes(b, 'src', 'stand', label='station')
        corr = bt.blocks.correlate(b, CR, accuracy='int8', impl='pallas')
        acc = bt.blocks.accumulate(corr, CA)
        d2h = bt.blocks.copy(acc, space='system')
        sink = VisSink(d2h)

        def run_pipe():
            try:
                p.run()
            except BaseException as exc:
                box['pipe'] = exc

        def run_cap():
            try:
                # an idle socket ends the capture only once the child
                # is done: it waits for the readers after frame 0
                while True:
                    st = cap.recv()
                    if st in (pc.CAPTURE_NO_DATA, pc.CAPTURE_INTERRUPTED) \
                            and done.is_set():
                        break
            except BaseException as exc:
                box['cap'] = exc
            finally:
                cap.end()

        tp = threading.Thread(target=run_pipe, daemon=True)
        tc = threading.Thread(target=run_cap, daemon=True)
        done = threading.Event()
        tp.start()
        tc.start()
        try:
            child = capture_child(which, port, rate)
        except BaseException:
            done.set()
            raise
        try:
            # the chain and the tap must hold the ring before the stream
            # goes on (frame 0 opened the sequence)
            t_end = time.monotonic() + 120
            while len(ring._readers) < 2 and time.monotonic() < t_end and \
                    not box:
                time.sleep(0.01)
            require(len(ring._readers) >= 2, '%s: the pipeline did not '
                    'attach to the capture ring (%s)' % (arm, box))
            child.stdin.write('GO\n')
            child.stdin.flush()
            out, _ = child.communicate(timeout=300)
        finally:
            done.set()
            if child.poll() is None:
                child.kill()
                child.wait()
        require(child.returncode == 0, '%s: the %s child exited %s'
                % (arm, which, child.returncode))
        sent_line = [ln for ln in out.splitlines() if ln.startswith('SENT')]
        require(sent_line, '%s: the %s child reported nothing' % (arm, which))
        _, nsent, send_s = sent_line[0].split()
        nsent, send_s = int(nsent), float(send_s)
        tc.join(120)
        require(not tc.is_alive(), '%s: the capture did not end' % arm)
        tp.join(300)
        if tp.is_alive():
            p.shutdown()
            raise RuntimeError('chip_smoke check failed: %s: pipeline still '
                               'running' % arm)
    for k in ('cap', 'pipe'):
        if k in box:
            raise box[k]
    if rx is not None:
        rx.close()
    counts = dict(gpu_kernels.launches)
    x1 = {k: counters.get('xfer.' + k) - x0[k] for k in x0}
    st = cap.stats
    ngood, nmiss = int(st['ngood_bytes']), int(st['nmissing_bytes'])
    ngulp = tap.f // CG
    require(ngulp >= CA, '%s: %d gulps committed' % (arm, ngulp))
    require(ngood + nmiss == ngulp * CG * CS * CPAY,
            '%s: ledger %d good + %d missing bytes for %d gulps'
            % (arm, ngood, nmiss, ngulp))
    cells = tapped[:ngulp * CG]
    sent = payloads[:ngulp * CG]
    same = (cells == sent).all(axis=-1)
    zero = ~cells.any(axis=-1)
    require(bool((same | zero).all()), '%s: a tapped cell is neither the '
            'sent payload nor blank' % arm)
    loss = nmiss / float(ngood + nmiss)
    if which == 'sender' and nmiss:
        return {'rate_pps': rate, 'loss': loss, 'missing_bytes': nmiss,
                'retry': True}
    if which == 'sender':
        require(tap.f == nt and np.array_equal(tapped, payloads),
                '%s: the tapped bytes differ from the sent payloads' % arm)
    require(counts['xcorr_herm'] == ngulp, '%s: %d K7 launches for %d gulps'
            % (arm, counts['xcorr_herm'], ngulp))
    if engine == 'sharded':
        require(x1['h2d_direct'] == ngulp and x1['h2d_staged'] == 0,
                '%s: the H2D did not take the direct path: %s' % (arm, x1))
    nout = ngulp // CA
    require(len(outs) == nout, '%s: %d visibilities for %d gulps'
            % (arm, len(outs), ngulp))
    for k, a in enumerate(outs):
        require(a.shape == (1, CCH, CS * CST, CPOL, CS * CST, CPOL) and
                a.dtype == np.complex64 and np.isfinite(a).all(),
                '%s output %d: bad shape, type or values' % (arm, k))
        want = None
        for g in range(k * CA, (k + 1) * CA):
            v = capture_oracle(cells[g * CG:(g + 1) * CG])
            want = v if want is None else want + v
        got = torch.from_numpy(a.reshape(CCH, CS * CST * CPOL,
                                         CS * CST * CPOL)).to(want.device)
        require(bool(torch.equal(got, want.to(got.dtype))),
                '%s output %d differs from the float64 oracle' % (arm, k))
        del want, got
    log_crc('capture %s' % arm, {k: crc32(a) for k, a in enumerate(outs)})
    pkts = ngood // CPAY
    pps = pkts / send_s if send_s > 0 else float('nan')
    per_gulp = {}
    for role, blk in (('h2d', h2d), ('tap', tap), ('transpose', tr),
                      ('correlate', corr), ('accumulate', acc),
                      ('d2h', d2h), ('sink', sink)):
        tot = blk.perf_totals
        per_gulp[role] = {k: tot[k] / max(tot['nlogical'], 1) * 1e3
                          for k in ('acquire', 'reserve', 'process')}
    res = {'engine': type(cap).__name__, 'ring': type(ring).__name__,
           'space': ring.space, 'rate_pps': rate, 'packets_sent': nsent + CS,
           'send_s': send_s, 'gulps': ngulp, 'outputs': nout,
           'packets_good': pkts, 'pps_received': pps,
           'gbps_received': pps * (CHDR + CPAY) * 8 / 1e9,
           'loss': loss, 'missing_bytes': nmiss,
           'realtime_ratio': pps / CS / CREAL_FPS,
           'pps_offered': nsent / send_s if send_s > 0 else float('nan'),
           'rcvbuf_bytes': rcvbuf, 'launches_k7': counts['xcorr_herm'],
           'h2d': x1, 'per_gulp_ms': per_gulp}
    if engine == 'sharded':
        res['zero_copy_packets'] = sum(w['zero_copy'] for w in cap._wstats)
        res['steered'] = cap._steered
        res['nlate'], res['nalien'], res['ndup'] = \
            st['nlate'], st['nalien'], st['ndup']
    log('capture arm %s: %s (%s)' % (arm, json.dumps(
        {k: v for k, v in res.items() if k != 'per_gulp_ms'}), smi))
    log_per_gulp(per_gulp)
    return res


CAPTURE_ARMS = (('capture-native', 'native', 'sender'),
                ('capture-native-blast', 'native', 'blaster'),
                ('capture-sharded', 'sharded', 'sender'),
                ('capture-sharded-blast', 'sharded', 'blaster'))


def phase_capture(bt, gpu_kernels, smi):
    import gc
    import torch
    try:
        with open('/proc/sys/net/core/rmem_max') as f:
            rmem_max = int(f.read())
    except (OSError, ValueError):
        rmem_max = None
    log('capture: %d boards x %d channels x %d stands x %d pols ci4, %d-byte '
        'packets, gulps of %d frames (%.1f MB), R %d, A %d, %d gulps an arm; '
        'net.core.rmem_max %s' % (CS, CCH, CST, CPOL, CHDR + CPAY, CG,
                                  CG * CS * CPAY / 1e6, CR, CA, CNG,
                                  rmem_max))
    payloads = capture_payloads()
    arms = {}
    for arm, engine, which in CAPTURE_ARMS:
        if which == 'blaster':
            arms[arm] = capture_arm(bt, gpu_kernels, arm, engine, which,
                                    None, payloads, smi)
        else:
            tried = []
            for rate in CRATES:
                r = capture_arm(bt, gpu_kernels, arm, engine, which, rate,
                                payloads, smi)
                if not r.get('retry'):
                    break
                log('capture arm %s at %d packets/s lost %d bytes (%.3g); '
                    'halving the rate' % (arm, rate, r['missing_bytes'],
                                          r['loss']))
                tried.append(r)
            require(not r.get('retry'), '%s lost packets at every rate %s'
                    % (arm, list(CRATES)))
            r['lossy_rates'] = tried
            arms[arm] = r
        gc.collect()
        torch.cuda.empty_cache()
    return {'geometry': {'boards': CS, 'channels': CCH, 'stands': CST,
                         'pols': CPOL, 'payload': CPAY, 'gulp': CG,
                         'R': CR, 'A': CA, 'gulps': CNG},
            'rmem_max': rmem_max, 'arms': arms,
            'launches': {a: r['launches_k7'] for a, r in arms.items()}}


# ---------------------------------------------------------------------------
# the bridge phase: a GUPPI stream shipped across a ring bridge
# ---------------------------------------------------------------------------

# arm -> (stream, receiver ring space, window, stripes, CRC, cut after
# span frame N or 0); the sender is a child process, the receiver this one
BRIDGE_ARMS = (('bridge-w1', 'guppi', 'system', 1, 1, False, 0),
               ('bridge-w4s4', 'guppi', 'cuda_host', 4, 4, True, 0),
               ('bridge-resume', 'guppi', 'system', 4, 1, False, 3),
               ('bridge-K1', 'k1', 'cuda_host', 4, 2, True, 0))
BNBLOCK = 4                # GUPPI blocks (128 MiB) a GUPPI arm ships
BK1GULPS = 4               # spectrometer gulps (256 MiB) of bridge-K1
BK1SEED = 43
BTIMEOUT = 300             # seconds an arm's sender or receiver may take


def k1_source_class(bt, gulps, ngulp, name, pace_s=0.0):
    """A source of ``ngulp`` spectrometer gulps (T, 2, nfft ci8), cycling
    through ``gulps``, one each ``pace_s`` seconds at most."""
    ntime = gulps[0].shape[0]

    class Source(bt.SourceBlock):
        def __init__(self):
            super(Source, self).__init__([name], ntime, space='system')
            self.count = 0

        def create_reader(self, sourcename):
            return contextlib.nullcontext()

        def on_sequence(self, reader, sourcename):
            hdr = spec_header(gulps[0].shape[2])
            hdr['name'] = name
            return [hdr]

        def on_data(self, reader, ospans):
            if self.count == ngulp:
                return [0]
            if pace_s:
                time.sleep(pace_s)
            dst = ospans[0].data.as_numpy().view(np.int8)
            dst[...] = gulps[self.count % len(gulps)].reshape(dst.shape)
            self.count += 1
            return [ntime]
    return Source


def bridge_sender(args):
    """``chip_smoke.py --bridge-sender JSON``: the sending host of a
    bridge arm, a host-only chain that imports bifrost_tpu_torch and
    nothing of the card: read_guppi_raw (or the K1 arm's gulps) into a
    native 'system' ring sized once at the sender's final geometry ->
    bridge_sink.  With ``cut`` the first dial's sockets go through
    testing.faults.LinkCut, which cuts the link after span frame ``cut``.
    Prints one BRIDGE_SENDER line of JSON: the sink's seconds, its
    bridge counters, the send-stall histogram, the handshake's round
    trip and clock offset, and the failure history."""
    import bifrost_tpu_torch as bt
    from bifrost_tpu_torch.telemetry import counters, histograms
    from bifrost_tpu_torch.testing.faults import LinkCut
    a = json.loads(args)
    window = a['window']
    with bt.Pipeline() as p:
        if a['stream'] == 'guppi':
            src = bt.blocks.read_guppi_raw([a['raw']], gulp_nframe=1)
        else:
            gulps = make_gulps(BK1SEED)
            src = k1_source_class(bt, gulps, a.get('ngulp', BK1GULPS),
                                  'k1', a.get('pace_s', 0.0))()
        # ``span_nframe`` ships each gulp as several spans
        span = {'gulp_nframe': a['span_nframe']} \
            if a.get('span_nframe') else {}
        sink = bt.blocks.bridge_sink(src, '127.0.0.1', a['port'],
                                     window=window, nstreams=a['nstreams'],
                                     crc=a['crc'], **span)
    # the native core clears its buffer at each growth: allocate the
    # window's depth (RingSender resizes to window + 2 spans) once
    src.orings[0].resize(a['gulp_nbyte'], (window + 2) * a['gulp_nbyte'])
    if a['cut']:
        dial = sink._connect
        first = [True]

        def cut_dial():
            socks = dial()
            if first[0]:
                first[0] = False
                socks = [LinkCut(s, a['cut']) for s in socks]
            return socks
        sink._connect = cut_dial
    main = sink.main
    box = {}

    def timed_main(orings):
        t0 = time.perf_counter()
        try:
            return main(orings)
        finally:
            box['secs'] = time.perf_counter() - t0
    sink.main = timed_main
    p.run()
    sender = sink._sender
    h = histograms.get('bridge.%s.send_stall_s' % sink.name)
    out = {'secs': box['secs'],
           'counters': {k: v for k, v in counters.snapshot().items()
                        if k.startswith('bridge.')},
           'send_stall_s': h.snapshot() if h is not None else None,
           'rtt_us': sender._wall_rtt_us,
           'wall_offset_ns': sender.wall_offset_ns,
           'failures': [(f.kind, type(f.exc).__name__)
                        for f in p.supervisor.failures]}
    if out['send_stall_s'] is not None:
        out['send_stall_s'].pop('buckets')
    print('BRIDGE_SENDER ' + json.dumps(out), flush=True)
    return 0


def bridge_child(args):
    """Start a bridge sender child."""
    here = os.path.abspath(__file__)
    return subprocess.Popen([sys.executable, here, '--bridge-sender',
                             json.dumps(args)], stdin=subprocess.DEVNULL,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def bridge_child_result(arm, child, timeout=BTIMEOUT):
    """Wait for a sender child (killed on time-out); its exit code and
    stderr are checked and its BRIDGE_SENDER line returned."""
    try:
        out, err = child.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        child.kill()
        out, err = child.communicate()
        raise RuntimeError('chip_smoke check failed: %s sender still '
                           'running after %d s; stderr:\n%s'
                           % (arm, timeout, err[-4000:]))
    if child.returncode != 0:
        raise RuntimeError('chip_smoke check failed: %s sender exited %d; '
                           'stderr:\n%s' % (arm, child.returncode,
                                            err[-4000:]))
    lines = [ln for ln in out.splitlines()
             if ln.startswith('BRIDGE_SENDER ')]
    require(len(lines) == 1, '%s: the sender printed no result' % arm)
    return json.loads(lines[0][len('BRIDGE_SENDER '):])


def hist_pct(h):
    if h is None:
        return None
    return {'count': h['count'], 'p50': h['p50'], 'p99': h['p99']}


def bridge_arm(bt, spec, gpu_kernels, arm, stream, space, window, nstreams,
               crc, cut, ctx, smi):
    """One arm: a child sends the stream over loopback; this process
    receives it into a ``space`` ring and runs the spectrometer on the
    card, then holds the output to the unbridged run and the oracle."""
    from bifrost_tpu_torch.telemetry import counters, histograms
    from bifrost_tpu_torch.stages import (FftStage, DetectStage,
                                          ReduceStage)
    outdir = os.path.join(ctx['tmp'], arm)
    os.makedirs(outdir)
    before = counters.snapshot()
    zero_counts(spec, gpu_kernels)
    sink = None
    with bt.Pipeline() as p:
        src = bt.blocks.bridge_source('127.0.0.1', 0, space=space)
        if stream == 'guppi':
            ctx['example'].build_after(src, outdir, GR)
            gulp_nbyte, ngulp = GBLOCSIZE, BNBLOCK
        else:
            h2d = bt.blocks.copy(src, space='cuda')
            fused = bt.blocks.fused(
                h2d, [FftStage('fine_time', axis_labels='freq'),
                      DetectStage('stokes', axis='pol'),
                      ReduceStage('freq', RFACTOR)])
            sink = ctx['k1_sink'](bt.blocks.copy(fused, space='system'))
            gulp_nbyte, ngulp = NTIME * NPOL * NFINE * 2, BK1GULPS
    child = bridge_child({'port': src.port, 'stream': stream,
                          'raw': ctx.get('raw'), 'window': window,
                          'nstreams': nstreams, 'crc': crc, 'cut': cut,
                          'gulp_nbyte': gulp_nbyte})
    t0 = time.perf_counter()
    try:
        run_with_timeout(p, BTIMEOUT)
    except BaseException:
        child.kill()
        child.communicate()
        raise
    rx_secs = time.perf_counter() - t0
    tx = bridge_child_result(arm, child)
    counts = read_counts(spec, gpu_kernels)
    after = counters.snapshot()
    d = {k: after.get(k, 0) - before.get(k, 0)
         for k in set(after) | set(before)}
    txc = tx['counters']
    require(d.get('bridge.rx.spans') == ngulp,
            '%s: bridge.rx.spans %s, not %d' % (arm, d.get('bridge.rx.spans'),
                                                 ngulp))
    retransmitted = txc.get('bridge.tx.spans', 0) - ngulp
    if cut:
        # bridge.tx.spans counts every span frame sent, retransmits too
        require(txc.get('bridge.tx.reconnects', 0) >= 1 and
                retransmitted >= 1, '%s: no reconnect and retransmit (%s)'
                % (arm, txc))
        require(d.get('bridge.rx.dups', 0) >= 1,
                '%s: the receiver dropped no duplicate' % arm)
        recs = [f for f in p.supervisor.failures if f.kind == 'reconnected']
        require(len(recs) == 1, '%s: %d reconnected records in the '
                'receiver\'s failure history, not 1' % (arm, len(recs)))
    else:
        require(retransmitted == 0 and
                not txc.get('bridge.tx.reconnects') and
                not d.get('bridge.rx.dups'),
                '%s: an uncut link reconnected or retransmitted (%s)'
                % (arm, txc))
    require(not d.get('bridge.rx.crc_errors'), '%s: %s CRC errors'
            % (arm, d.get('bridge.rx.crc_errors', 0)))
    if not cut:
        require(txc.get('bridge.tx.bytes') == d.get('bridge.rx.bytes'),
                '%s: %s bytes sent, %s received' % (
                    arm, txc.get('bridge.tx.bytes'),
                    d.get('bridge.rx.bytes')))
    if space == 'cuda_host':
        require(src.orings[0]._storage.pinned,
                '%s: the cuda_host ring is not pinned' % arm)
        require(d.get('xfer.h2d_direct') == ngulp and
                not d.get('xfer.h2d_staged') and
                not d.get('xfer.h2d_unstaged'),
                '%s: the H2D was not all direct: direct %s, staged %s, '
                'unstaged %s' % (arm, d.get('xfer.h2d_direct'),
                                 d.get('xfer.h2d_staged'),
                                 d.get('xfer.h2d_unstaged')))
    out = {'stream': stream, 'space': space, 'window': window,
           'nstreams': nstreams, 'crc': crc, 'cut_after_span': cut or None,
           'gulps': ngulp, 'gulp_bytes': gulp_nbyte,
           'launches': {k: n for k, n in counts.items() if n},
           'rx_counters': {k: v for k, v in d.items()
                           if k.startswith('bridge.') and v},
           'tx_counters': txc, 'retransmitted_spans': retransmitted,
           'tx_failures': tx['failures'],
           'rx_failures': [(f.kind, type(f.exc).__name__)
                           for f in p.supervisor.failures],
           'h2d': {k: d.get(k, 0) for k in ('xfer.h2d_direct',
                                            'xfer.h2d_staged',
                                            'xfer.h2d_unstaged')}}
    if stream == 'guppi':
        fil = os.path.join(outdir, os.path.basename(ctx['raw']) + '.fil')
        with open(fil, 'rb') as f:
            blob = f.read()
        log_crc('%s .fil' % arm, zlib.crc32(blob))
        require(blob == ctx['ref_fil'], '%s: the .fil differs from the '
                'unbridged run' % arm)
        check_guppi_fil(arm, fil, ctx['oracle'], ctx['ntime'])
        os.remove(fil)
        require(not counts.get('fused_spectrometer'),
                '%s: K1 ran on the GUPPI chain' % arm)
    else:
        # the fused block's prewarm runs K1 once at sequence start
        launches = counts.get('fused_spectrometer', 0)
        prewarm = fused.prewarm_runs
        require(launches == ngulp + prewarm and
                counts.get('fused_spectrometer_radix16') == launches,
                '%s: K1 launched %d times (radix16 %s) for %d gulps and '
                '%d prewarm runs' % (arm, launches,
                                     counts.get('fused_spectrometer_radix16'),
                                     ngulp, prewarm))
        require(len(sink.out) == ngulp, '%s: %d outputs of %d'
                % (arm, len(sink.out), ngulp))
        for i, got in enumerate(sink.out):
            want = ctx['k1_want'][i % len(ctx['k1_want'])]
            require(got.shape == want.shape and got.tobytes() ==
                    want.tobytes(), '%s gulp %d: output differs from K1 '
                    'on the unbridged gulp' % (arm, i))
            r = rel_err(got[ctx['k1_rows']], ctx['k1_oracle'][i % 2])
            require(r < GATE, '%s gulp %d rows vs oracle: %.3g'
                    % (arm, i, r))
        log_crc('%s outputs' % arm, {i: crc32(a)
                                     for i, a in enumerate(sink.out)})
        out['k1_launches'] = launches
        out['k1_prewarm_runs'] = prewarm
    payload = txc.get('bridge.tx.bytes', 0)
    per_gulp = {}
    for blk in p.blocks:
        tot = blk.perf_totals
        if not tot['ngulp']:
            continue        # the bridge source keeps no gulp loop times
        per_gulp[blk.name] = {k: tot[k] / tot['ngulp'] * 1e3
                              for k in ('acquire', 'reserve', 'process')}
    wait = histograms.get('bridge.%s.recv_wait_s' % src.name)
    out.update({
        'sender_s': tx['secs'], 'receiver_s': rx_secs,
        'payload_MBps': payload / tx['secs'] / 1e6,
        'payload_Gbps': payload * 8 / tx['secs'] / 1e9,
        'send_stall_s': hist_pct(tx['send_stall_s']),
        'recv_wait_s': hist_pct(wait.snapshot() if wait else None),
        'rtt_us': tx['rtt_us'], 'wall_offset_ns': tx['wall_offset_ns'],
        'host_ms_per_gulp': per_gulp, 'card': smi})
    log('%s: %s stream, %d gulps of %d MiB, window %d, %d stripe(s), CRC '
        '%s%s -> %s ring: %.1f MB/s = %.2f Gbit/s of payload over the '
        'sender\'s %.2f s (receiver %.2f s); send stall %s, recv wait %s; '
        'handshake rtt %s us; rx %s; tx %s; launches %s (%s)'
        % (arm, stream, ngulp, gulp_nbyte >> 20, window, nstreams,
           'on' if crc else 'off',
           ', cut after span %d' % cut if cut else '', space,
           out['payload_MBps'], out['payload_Gbps'], tx['secs'], rx_secs,
           out['send_stall_s'], out['recv_wait_s'], tx['rtt_us'],
           out['rx_counters'], txc, out['launches'], smi))
    log_per_gulp(per_gulp)
    return out


def check_guppi_fil(arm, fil, oracle, ntime, nblock=BNBLOCK):
    """The .fil's data within GATE of the float64 oracle on the first
    blocks, and every tone at its bin."""
    from bifrost_tpu_torch.io import sigproc as sigproc_io
    with sigproc_io.SigprocFile(fil) as f:
        hsize = f.header_size
    nf = GCH * ntime // GR
    data = np.fromfile(fil, np.float32, offset=hsize)
    require(data.size == nblock * 4 * nf, '%s: .fil holds %d values, not %d'
            % (arm, data.size, nblock * 4 * nf))
    data = data.reshape(nblock, 4, nf)
    require(np.isfinite(data).all(), '%s: non-finite output' % arm)
    errs = []
    for b, want in enumerate(oracle):
        errs.append(float(np.abs(data[b] - want).max() /
                          np.abs(want).max()))
        require(errs[-1] < GATE, '%s block %d: %.3g of the oracle (gate %g)'
                % (arm, b, errs[-1], GATE))
    peaks = data[:, 0].reshape(nblock, GCH, -1).argmax(-1)
    bins = guppi_tone_bins(GCH, ntime) // GR
    require((peaks == bins[None]).all(), '%s: %d of %d tones off their bin'
            % (arm, int((peaks != bins[None]).sum()), peaks.size))
    return errs


def phase_bridge(bt, spec, gpu_kernels, smi):
    """The bridge phase (module docstring, 15c)."""
    import tempfile
    import gc
    import torch
    from bifrost_tpu_torch.stages import (FftStage, DetectStage,
                                          ReduceStage)
    ctx = {'example': load_example()}
    arms = {}
    with tempfile.TemporaryDirectory() as tmp:
        ctx['tmp'] = tmp
        raw = ctx['raw'] = os.path.join(tmp, 'bridged.raw')
        t0 = time.perf_counter()
        kept = write_guppi(raw, 8, BNBLOCK, GCH, GBLOCSIZE)
        ctx['ntime'] = ntime = GBLOCSIZE // (GCH * NPOL * 2)
        t_write = time.perf_counter() - t0
        # the unbridged reference run, and the oracle of its first blocks
        refdir = os.path.join(tmp, 'reference')
        os.makedirs(refdir)
        zero_counts(spec, gpu_kernels)
        t0 = time.perf_counter()
        with bt.Pipeline() as p:
            ctx['example'].build([raw], refdir, gulp_nframe=1, rfactor=GR)
        run_with_timeout(p, BTIMEOUT)
        t_ref = time.perf_counter() - t0
        ref_counts = read_counts(spec, gpu_kernels)
        fil = os.path.join(refdir, 'bridged.raw.fil')
        with open(fil, 'rb') as f:
            ctx['ref_fil'] = f.read()
        log_crc('bridge reference .fil', zlib.crc32(ctx['ref_fil']))
        t0 = time.perf_counter()
        ctx['oracle'] = [guppi_oracle(spec, v, GR) for v in kept]
        del kept
        ref_errs = check_guppi_fil('bridge reference', fil, ctx['oracle'],
                                   ntime)
        t_oracle = time.perf_counter() - t0
        log('bridge: GUPPI file of %d blocks of %d MiB written in %.1f s; '
            'unbridged reference run %.2f s, launches %s, oracle rel %s '
            '(%.1f s)' % (BNBLOCK, GBLOCSIZE >> 20, t_write, t_ref,
                          {k: n for k, n in ref_counts.items() if n},
                          ['%.3g' % e for e in ref_errs], t_oracle))
        # bridge-K1's reference: K1 on each unbridged gulp, and the
        # oracle on a few rows
        gulps = make_gulps(BK1SEED)
        ctx['k1_rows'] = rows = [0, 1, NTIME // 2, NTIME - 1]
        ctx['k1_want'] = [spec.fused_spectrometer(
            torch.from_numpy(g).cuda(), rfactor=RFACTOR).cpu().numpy()
            for g in gulps]
        ctx['k1_oracle'] = [spec.spectrometer_oracle(g[rows], RFACTOR)
                            for g in gulps]
        del gulps

        class K1Sink(bt.SinkBlock):
            def __init__(self, iring):
                super(K1Sink, self).__init__(iring)
                self.out = []

            def on_sequence(self, iseq):
                pass

            def on_data(self, ispan):
                self.out.append(np.array(ispan.data.as_numpy(), copy=True))
        ctx['k1_sink'] = K1Sink
        for arm, stream, space, window, nstreams, crc, cut in BRIDGE_ARMS:
            arms[arm] = bridge_arm(bt, spec, gpu_kernels, arm, stream, space,
                                   window, nstreams, crc, cut, ctx, smi)
            gc.collect()
            torch.cuda.empty_cache()
    return {'guppi': {'nchan': GCH, 'blocsize': GBLOCSIZE, 'blocks': BNBLOCK,
                      'ntime': ntime, 'rfactor': GR,
                      'reference_run_s': t_ref,
                      'reference_launches': {k: n for k, n in
                                             ref_counts.items() if n},
                      'oracle_rel_err': ref_errs},
            'k1': {'gulp': [NTIME, NPOL, NFINE], 'gulps': BK1GULPS,
                   'rfactor': RFACTOR},
            'arms': arms,
            'launches_k1': arms['bridge-K1']['k1_launches']}


# ---------------------------------------------------------------------------
# the auto-tuner and the fleet plane (items 15d and 15e)
# ---------------------------------------------------------------------------

#: autotune phase: sequences an arm runs, gulps a sequence, gulps before
#: the clock starts, freeze-mode rounds of the tuned arm's climb, and
#: repetitions of the measured arms (interleaved, order alternating)
TSEQ, TGULPS, TWARM, TROUNDS, TREPS = 3, 128, 4, 6, 3
#: distinct pre-staged gulps the tuner phase's source cycles through: 3
#: is prime to every power-of-two gulp_batch, so a K-gulp span that
#: drops, repeats or reorders chunks changes some gulp's digest
TDISTINCT = 3
#: the oracle rows of the tuner phase's K1 check
TROWS = [0, 5000, 16383]
#: fleet phase: gulps of the parent's arm (it stalls after FSTALL_AT),
#: of the first child's and of the second child's
FGULPS, FSTALL_AT, FCHILD_GULPS, FCHILD2_GULPS = 16, 8, 24, 4
FHOST, FCHILD_HOST = 'smoke-parent', 'smoke-child'
#: the telemetry counter of K1 launches that the fleet plane carries
K1_COUNTER = 'kernel.fused_spectrometer.launches'
FTIMEOUT = 300             # seconds a fleet child may take


def device_gulps(n, seed=14):
    """``n`` distinct pre-staged flagship gulps on the card, each
    (16384, 2, 4096, 2) int8, the ci8 device representation; and their
    host copies."""
    import torch
    from bifrost_tpu_torch.device import get_device
    rng = np.random.RandomState(seed)
    hosts = [rng.randint(-64, 64, (NTIME, NPOL, NFINE, 2)).astype(np.int8)
             for _ in range(n)]
    return [torch.from_numpy(h).to(get_device()) for h in hosts], hosts


def device_k1_chain(bt, gulps, nseq, ngulp, nwarm, hold=None, scope=None,
                    name='tune', split=False, source=None):
    """The device-resident K1 chain of bench.py: a 'cuda' source that
    publishes ``ngulp`` gulps in each of ``nseq`` sequences, gulp i being
    the pre-staged ``gulps[i % len(gulps)]``
    -> fused[FFT, Stokes, reduce(4)] (K1 by
    match_spectrometer) -> a device sink that digests every output gulp
    on the card (no D2H but gulp 0's) and forces completion after
    ``nwarm`` gulps and at the last.  ``hold(count)`` runs before each
    gulp is published.  With ``split`` the chain is two fused blocks,
    [FFT] and [Stokes, reduce(4)] (a segment fuses them back); with
    ``source(bt)`` that block feeds the chain instead (its output is
    copied to 'cuda' inside ``scope``).  Returns (pipeline, fused block,
    sink)."""
    import torch
    from bifrost_tpu_torch.stages import FftStage, DetectStage, ReduceStage
    total = nseq * ngulp

    class Source(bt.SourceBlock):
        def __init__(self):
            super(Source, self).__init__(
                ['%s%d' % (name, i) for i in range(nseq)], NTIME,
                space='cuda')
            self.count = 0

        def create_reader(self, sourcename):
            return contextlib.nullcontext()

        def on_sequence(self, reader, sourcename):
            self.count = 0
            hdr = spec_header(NFINE)
            hdr['name'] = sourcename
            return [hdr]

        def on_data(self, reader, ospans):
            if self.count == ngulp:
                return [0]
            if hold is not None:
                hold(self.count)
            ospans[0].set(gulps[self.count % len(gulps)])
            self.count += 1
            return [NTIME]

    class DeviceSink(bt.SinkBlock):
        """Keeps an exact int64 digest of each gulp's output bits on the
        card: per-row sums of the int32 view, weighted by row."""

        def __init__(self, iring):
            super(DeviceSink, self).__init__(iring)
            self.n = 0
            self.digests = []
            self.first = None
            self.weights = None
            self.t0 = self.t1 = None

        def define_valid_input_spaces(self):
            return ('cuda',)

        def on_sequence(self, iseq):
            pass

        def on_data(self, ispan):
            x = ispan.data
            rows = x.view(torch.int32).reshape(x.shape[0], -1, x.shape[-1]) \
                .sum(dim=-1, dtype=torch.int64)
            if self.weights is None:
                self.weights = torch.arange(
                    1, rows.numel() + 1, dtype=torch.int64,
                    device=rows.device).reshape(rows.shape) * 2654435761
            self.digests.append((rows * self.weights).sum())
            if self.n == 0:
                self.first = x.cpu().numpy()
            self.n += 1
            if self.n == nwarm:
                torch.cuda.synchronize()
                self.t0 = time.perf_counter()
            elif self.n == total:
                torch.cuda.synchronize()
                self.t1 = time.perf_counter()

    with bt.Pipeline(**(scope or {})) as p:
        src = Source() if source is None else \
            bt.blocks.copy(source(bt), space='cuda')
        if split:
            fb = bt.blocks.fused(bt.blocks.fused(src, [
                FftStage('fine_time', axis_labels='freq')]), [
                    DetectStage('stokes', axis='pol'),
                    ReduceStage('freq', RFACTOR)])
        else:
            fb = bt.blocks.fused(src, [
                FftStage('fine_time', axis_labels='freq'),
                DetectStage('stokes', axis='pol'),
                ReduceStage('freq', RFACTOR)])
        sink = DeviceSink(fb)
    return p, fb, sink


class _Run(object):
    """``run_with_timeout`` calls ``run()``: this passes ``autotune``."""

    def __init__(self, p, autotune):
        self.p, self.autotune = p, autotune

    def run(self):
        return self.p.run(autotune=self.autotune)

    def shutdown(self):
        self.p.shutdown()


def tune_arm(bt, spec, gulps, arm, gulp_batch, sync_depth, autotune=None,
             env=None):
    """One run of the tuner phase's chain; returns its record."""
    from bifrost_tpu_torch.telemetry import counters, histograms
    with environ(**(env or {})):
        counters.reset()
        histograms.reset()
        settle_memory()
        p, fb, sink = device_k1_chain(
            bt, gulps, TSEQ, TGULPS, TWARM,
            scope={'gulp_batch': gulp_batch, 'sync_depth': sync_depth})
        l0, r0 = spec.launches, spec.launches_by_path['radix16']
        t = time.perf_counter()
        run_with_timeout(_Run(p, autotune))
        secs = time.perf_counter() - t
    total = TSEQ * TGULPS
    require(sink.n == total and sink.t1 is not None,
            'autotune %s: the sink saw %d of %d gulps' % (arm, sink.n, total))
    snap = counters.snapshot()
    launches = spec.launches - l0
    rec = {'arm': arm, 'gulp_batch': gulp_batch, 'sync_depth': sync_depth,
           'autotune': autotune, 'seconds': secs,
           'msps': (total - TWARM) * NTIME * NPOL * NFINE /
                   (sink.t1 - sink.t0) / 1e6,
           'launches': launches,
           'launches_radix16': spec.launches_by_path['radix16'] - r0,
           'prewarm_runs': fb.prewarm_runs,
           'dispatches': block_gulps(snap, fb),
           'digests': [int(d) for d in sink.digests],
           'first': sink.first,
           'knobs': {k: snap.get('autotune.' + k)
                     for k in ('gulp_batch', 'sync_depth')},
           'retunes': snap.get('autotune.retunes', 0),
           'reverts': snap.get('autotune.reverts', 0),
           'rejected': snap.get('autotune.rejected', 0),
           'ticks': snap.get('autotune.ticks', 0),
           'tick_busy_us': snap.get('autotune.tick_busy_us', 0)}
    require(rec['launches_radix16'] == launches and launches > 0,
            'autotune %s: %d K1 launches, %d on the radix-16 kernel'
            % (arm, launches, rec['launches_radix16']))
    del p, fb, sink
    return rec


def phase_autotune(bt, spec, smi):
    """The tuner phase (item 15d of the module docstring)."""
    import tempfile
    from bifrost_tpu_torch import autotune
    gulps, hosts = device_gulps(TDISTINCT)
    out = {'gulp': [NTIME, NPOL, NFINE], 'rfactor': RFACTOR,
           'distinct_gulps': TDISTINCT,
           'sequences': TSEQ, 'gulps_per_sequence': TGULPS,
           'gulps_untimed': TWARM, 'freeze_rounds': TROUNDS,
           'card': smi}
    with tempfile.TemporaryDirectory() as tmp:
        profile = os.path.join(tmp, 'autotune_profile.json')
        # the climb: freeze-mode runs from the de-tuned cold start, each
        # warm-starting at the profile the previous one dumped (a fast
        # tick and a 15% min-gain for the climb only, as the JAX
        # package's config 14 does)
        climb = {'BF_AUTOTUNE_PROFILE': profile,
                 'BF_AUTOTUNE_INTERVAL': '0.04',
                 'BF_AUTOTUNE_COOLDOWN': '1',
                 'BF_AUTOTUNE_MIN_GAIN': '0.15'}
        rounds = []
        for i in range(TROUNDS):
            rec = tune_arm(bt, spec, gulps, 'climb%d' % i, 1, 1,
                           autotune='freeze', env=climb)
            rounds.append({k: rec[k] for k in (
                'msps', 'knobs', 'retunes', 'reverts', 'rejected', 'ticks',
                'launches', 'dispatches')})
            log('autotune climb %d: %.1f Msamples/s, knobs %s, %d retunes, '
                '%d reverts, %d K1 launches, dispatches/gulps %s'
                % (i, rec['msps'], rec['knobs'], rec['retunes'],
                   rec['reverts'], rec['launches'], rec['dispatches']))
        retunes = sum(r['retunes'] for r in rounds)
        require(retunes > 0, 'autotune: the controller never retuned in '
                '%d freeze rounds' % TROUNDS)
        prof = autotune.load_profile(profile)
        require(prof is not None, 'autotune: no profile was dumped')
        out['climb'] = rounds
        out['retunes'] = retunes
        out['converged_knobs'] = prof['knobs']
        arms = {
            'detuned': dict(gulp_batch=1, sync_depth=1),
            'tuned': dict(gulp_batch=1, sync_depth=1, autotune=True,
                          env={'BF_AUTOTUNE_PROFILE': profile}),
            'hand': dict(gulp_batch=16, sync_depth=4),
            # every ceiling pinned: the controller reads and judges but
            # can take no step
            'hand_ctl': dict(gulp_batch=16, sync_depth=4, autotune=True,
                             env={'BF_AUTOTUNE_PROFILE':
                                  os.path.join(tmp, 'unused.json'),
                                  'BF_AUTOTUNE_MAX_BATCH': '16',
                                  'BF_AUTOTUNE_MAX_DEPTH': '4',
                                  'BF_AUTOTUNE_MAX_RING_BYTES': '1'}),
        }
        recs = {a: [] for a in arms}
        for rep in range(TREPS):
            order = list(arms) if rep % 2 == 0 else list(reversed(arms))
            for a in order:
                recs[a].append(tune_arm(bt, spec, gulps, a, **arms[a]))
    ref = recs['detuned'][0]
    require(len(set(ref['digests'][:TDISTINCT])) == TDISTINCT,
            'autotune: the %d distinct gulps do not digest apart: %s'
            % (TDISTINCT, ref['digests'][:TDISTINCT]))
    rows = spec.spectrometer_oracle(hosts[0][TROWS], RFACTOR)
    err = rel_err(ref['first'][TROWS], rows)
    require(err < GATE, 'autotune: K1 output %.3g from the oracle' % err)
    for a, rs in recs.items():
        for r in rs:
            require(r['digests'] == ref['digests'] and
                    r['first'].tobytes() == ref['first'].tobytes(),
                    'autotune: the %s arm differs from the detuned arm'
                    % a)
    best = {a: max(r['msps'] for r in rs) for a, rs in recs.items()}
    tuned = max(recs['tuned'], key=lambda r: r['msps'])
    out['arms'] = {a: {
        'msps_max': best[a], 'msps_all': [r['msps'] for r in rs],
        'gulp_batch_set': rs[0]['gulp_batch'],
        'sync_depth_set': rs[0]['sync_depth'],
        'knobs': rs[0]['knobs'], 'retunes': [r['retunes'] for r in rs],
        'k1_launches': rs[0]['launches'],
        'prewarm_runs': rs[0]['prewarm_runs'],
        'dispatches_gulps': rs[0]['dispatches'],
        'tick_busy_us': [r['tick_busy_us'] for r in rs]}
        for a, rs in recs.items()}
    out['oracle_rel_err'] = err
    out['outputs_identical'] = True
    out['tuned_knobs'] = tuned['knobs']
    out['tuned_over_detuned'] = best['tuned'] / best['detuned']
    out['tuned_gap_to_hand_pct'] = (best['tuned'] / best['hand'] - 1) * 100
    pairs = sorted(c['msps'] / h['msps'] for c, h in
                   zip(recs['hand_ctl'], recs['hand']))
    out['hand_ctl_overhead_pct'] = (1 - pairs[len(pairs) // 2]) * 100
    rings = prof['knobs'].get('ring_total_bytes') or {}
    out['ring_knob'] = (
        'inert: every ring already holds more than MAX_RING_BYTES (%d), '
        'the smallest %d bytes; one gulp is %d bytes'
        % (autotune.MAX_RING_BYTES, min(rings.values() or [0]),
           hosts[0].nbytes))
    for a in arms:
        log('autotune %s: %s Msamples/s (max %.1f), K %s sync %s -> knobs '
            '%s, K1 launches %d (%d plan runs), dispatches/gulps %s'
            % (a, ['%.1f' % r['msps'] for r in recs[a]], best[a],
               arms[a]['gulp_batch'], arms[a]['sync_depth'],
               recs[a][0]['knobs'], recs[a][0]['launches'],
               recs[a][0]['prewarm_runs'], recs[a][0]['dispatches']))
    log('autotune: tuned/detuned %.3f, tuned gap to hand %.2f%%, hand_ctl '
        'overhead %.2f%%, converged profile %s, %s'
        % (out['tuned_over_detuned'], out['tuned_gap_to_hand_pct'],
           out['hand_ctl_overhead_pct'], json.dumps(prof['knobs']),
           out['ring_knob']))
    out['launches_k1'] = {a: [r['launches'] for r in rs]
                          for a, rs in recs.items()}
    del recs, ref, tuned, gulps
    return out


def fleet_k1_run(bt, spec, ngulp, hold=None, name='fleet', nwarm=1):
    """The device-resident K1 arm for the fleet phase: ``ngulp`` gulps in
    one sequence, timed after ``nwarm``; returns (Msamples/s, K1
    launches, fused block name)."""
    gulps, _hosts = device_gulps(1, seed=15)
    l0 = spec.launches
    p, fb, sink = device_k1_chain(bt, gulps, 1, ngulp, nwarm, hold=hold,
                                  name=name)
    run_with_timeout(p)
    require(sink.n == ngulp, 'fleet: the sink saw %d of %d gulps'
            % (sink.n, ngulp))
    msps = (ngulp - nwarm) * NTIME * NPOL * NFINE / (sink.t1 - sink.t0) \
        / 1e6
    return msps, spec.launches - l0, fb.name


def fleet_child(arg):
    """``chip_smoke.py --fleet-child JSON``: a second publisher on the
    same card, under its own BF_FLEET_HOST, running the K1 arm."""
    cfg = json.loads(arg)
    import bifrost_tpu_torch as bt
    from bifrost_tpu_torch import _build
    from bifrost_tpu_torch.ops import spectrometer as spec
    from bifrost_tpu_torch.telemetry import counters, fleet
    bt.device.set_device('cuda:0')
    _build.build()
    os.environ.update(BF_FLEET_COLLECTOR='127.0.0.1:%d' % cfg['port'],
                      BF_FLEET_HOST=cfg['host'], BF_FLEET_INTERVAL='0.25')
    pub = fleet.acquire_publisher()
    require(pub is not None, 'fleet child: no publisher')
    try:
        msps, launches, fused = fleet_k1_run(bt, spec, cfg['ngulp'],
                                             name='child')
    finally:
        fleet.release_publisher(pub)
    counter = counters.get(K1_COUNTER)
    require(counter == launches, 'fleet child: K1 counter %s, %d launches'
            % (counter, launches))
    print(json.dumps({'fleet_child': {'msps': msps, 'launches': launches,
                                      'counter': counter,
                                      'fused': fused}}), flush=True)
    return 0


def start_fleet_child(port, ngulp):
    here = os.path.dirname(os.path.abspath(__file__))
    cfg = json.dumps({'port': port, 'host': FCHILD_HOST, 'ngulp': ngulp})
    return subprocess.Popen([sys.executable, os.path.join(here,
                                                          'chip_smoke.py'),
                             '--fleet-child', cfg],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finish_fleet_child(child, what):
    try:
        out, err = child.communicate(timeout=FTIMEOUT)
    except subprocess.TimeoutExpired:
        child.kill()
        child.communicate()
        raise RuntimeError('chip_smoke check failed: %s did not end in '
                           '%d s' % (what, FTIMEOUT))
    require(child.returncode == 0, '%s exited %s: %s'
            % (what, child.returncode, err[-2000:]))
    return json.loads(out.strip().splitlines()[-1])['fleet_child']


def wait_for(pred, what, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise RuntimeError('chip_smoke check failed: %s (waited %g s)'
                               % (what, timeout))
        time.sleep(0.05)
    return time.monotonic()


def flight_spans(path, suffix):
    """X events of a bundle's Chrome trace whose name ends in
    ``suffix``."""
    try:
        with open(path) as f:
            trace = json.load(f)
    except (OSError, ValueError):
        return []
    return [e['name'] for e in trace.get('traceEvents', [])
            if e.get('ph') == 'X' and e['name'].endswith(suffix)]


def phase_fleet(bt, spec, gpu_kernels, smi):
    """The fleet phase (item 15e of the module docstring)."""
    import tempfile
    from bifrost_tpu_torch.telemetry import counters, fleet
    # the rollup's K1 counter must count this phase's launches alone
    counters.reset()
    zero_counts(spec, gpu_kernels)
    out = {'card': smi}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, environ(
            BF_FLEET_HOST=FHOST, BF_FLEET_INTERVAL='0.25',
            BF_HEALTH_INTERVAL='0.1', BF_HEALTH_STALL_SECS='1'):
        rules = os.path.join(tmp, 'rules.json')
        with open(rules, 'w') as f:
            json.dump({'rules': [{'name': 'child-stale', 'kind': 'absence',
                                  'host': FCHILD_HOST, 'for_ticks': 1,
                                  'clear_ticks': 1, 'severity': 'page'}]},
                      f)
        coll = fleet.FleetCollector(
            bind=('127.0.0.1', 0), rules=fleet.load_rules(rules),
            interval=0.1, deadline=1.5,
            incident_dir=os.path.join(tmp, 'incidents'),
            rollup_file=os.path.join(tmp, 'rollup.json'))
        coll.recorder.settle = 0.5
        coll.start()
        child = None
        os.environ['BF_FLEET_COLLECTOR'] = '127.0.0.1:%d' % coll.port
        pub = fleet.acquire_publisher()
        busy0 = counters.get('fleet.pub.busy_us')
        try:
            require(pub is not None and pub.host == FHOST,
                    'fleet: the parent has no publisher')
            # two publishers at once: the child's arm beside the parent's
            child = start_fleet_child(coll.port, FCHILD_GULPS)
            both = {'live': 0}

            def two_live():
                r = coll.rollup()
                both['live'] = max(both['live'], r['fleet']['hosts_live'])
                return both['live'] >= 2 or child.poll() is not None
            wait_for(two_live, 'fleet: the child never published',
                     timeout=FTIMEOUT)
            c1 = finish_fleet_child(child, 'the first fleet child')
            t_exit = time.time()
            child = None
            require(both['live'] == 2, 'fleet: the two hosts were never '
                    'live together')

            def fired():
                return any(e['name'] == 'child-stale' and
                           e['event'] == 'FIRING'
                           for e in coll.engine.history)
            wait_for(fired, 'fleet: the staleness rule did not fire')
            t_fired = next(e['wall'] for e in coll.engine.history
                           if e['event'] == 'FIRING')
            # the parent's arm, with a stall drill: its source wedges
            # until the STALLED escalation has written a bundle
            stall = {}

            def stalled():
                return [b for b in coll.recorder.bundles
                        if 'STALLED' in os.path.basename(b)]

            def hold(count):
                if count == FSTALL_AT and 't0' not in stall:
                    stall['t0'] = time.monotonic()
                    stall['t1'] = wait_for(
                        stalled, 'fleet: no incident bundle after the '
                        'stall')
            # timed after the stall
            msps, launches, fused = fleet_k1_run(bt, spec, FGULPS,
                                                 hold=hold,
                                                 nwarm=FSTALL_AT + 2)
            require(len(stalled()) == 1, 'fleet: %d STALLED bundles'
                    % len(stalled()))
            bundle = stalled()[0]
            hosts_dir = os.path.join(bundle, 'hosts')
            wait_for(lambda: flight_spans(os.path.join(
                hosts_dir, FHOST, 'flight.json'), fused + '.on_data'),
                'fleet: the parent flight timeline lacks %s.on_data'
                % fused)
            child_spans = flight_spans(os.path.join(
                hosts_dir, FCHILD_HOST, 'flight.json'), '.on_data')
            require([s for s in child_spans if 'FusedBlock' in s],
                    'fleet: the child flight timeline lacks the fused '
                    "block's on_data spans: %s" % child_spans[:8])
            # the child comes back: its host is fresh again, the rule
            # clears
            t_back = time.time()
            child = start_fleet_child(coll.port, FCHILD2_GULPS)

            def cleared():
                return any(e['name'] == 'child-stale' and
                           e['event'] == 'RESOLVED'
                           for e in coll.engine.history)
            wait_for(cleared, 'fleet: the staleness rule did not clear',
                     timeout=FTIMEOUT)
            t_cleared = next(e['wall'] for e in coll.engine.history
                             if e['event'] == 'RESOLVED')
            c2 = finish_fleet_child(child, 'the second fleet child')
            child = None
            wait_for(lambda: coll.rollup()['hosts'].get(
                FCHILD_HOST, {}).get('final'),
                'fleet: the second child sent no final snapshot')
        finally:
            if child is not None:
                child.kill()
                child.communicate()
            fleet.release_publisher(pub)
            os.environ.pop('BF_FLEET_COLLECTOR', None)
        wait_for(lambda: coll.rollup()['hosts'].get(FHOST, {}).get('final'),
                 'fleet: this process sent no final snapshot')
        busy_us = counters.get('fleet.pub.busy_us') - busy0
        wall = time.perf_counter() - t_phase
        rollup = coll.rollup()
        coll.stop()
        with open(os.path.join(tmp, 'rollup.json')) as f:
            written = json.load(f)
        require(sorted(written['hosts']) == [FCHILD_HOST, FHOST],
                'fleet: the rollup file holds %s' % sorted(written['hosts']))
        # the rollup keeps a host's last session: the second child's
        for h, want in ((FHOST, launches), (FCHILD_HOST, c2['launches'])):
            e = rollup['hosts'].get(h) or {}
            n = e.get('counters', {}).get(K1_COUNTER)
            dev = (e.get('devices') or {}).get('0') or {}
            require(want > 0 and n == want, 'fleet: host %s has K1 launch '
                    'counter %s in the rollup, %d launches measured'
                    % (h, n, want))
            require(dev.get('platform') == 'cuda' and
                    dev.get('bytes_in_use', 0) > 0 and
                    dev.get('bytes_limit', 0) > 0,
                    'fleet: host %s has no device memory section: %s'
                    % (h, dev))
        others = [os.path.basename(b) for b in coll.recorder.bundles
                  if b != bundle]
        require(others in ([], ['incident_001_dead-host-' + FCHILD_HOST]),
                'fleet: unexpected incident bundles %s' % others)
        with open(os.path.join(bundle, 'meta.json')) as f:
            meta = json.load(f)
        require(sorted(meta['hosts']) == [FCHILD_HOST, FHOST] and
                'STALLED' in meta['reason'],
                'fleet: bundle meta %s' % {k: meta[k] for k in
                                           ('reason', 'hosts')})
        out.update({
            'hosts': sorted(rollup['hosts']),
            'live_together': both['live'],
            'k1_counters_rollup': {h: rollup['hosts'][h]['counters'][
                K1_COUNTER] for h in (FHOST, FCHILD_HOST)},
            'devices': {h: rollup['hosts'][h]['devices']['0']
                        for h in (FHOST, FCHILD_HOST)},
            'parent_msps': msps, 'parent_launches': launches,
            'child_msps': [c1['msps'], c2['msps']],
            'child_launches': [c1['launches'], c2['launches']],
            'child_counters': [c1['counter'], c2['counter']],
            'alert_fired_after_exit_s': t_fired - t_exit,
            'alert_cleared_after_restart_s': t_cleared - t_back,
            'incident_after_stall_s': stall['t1'] - stall['t0'],
            'incident': os.path.basename(bundle),
            'other_incidents': others,
            'incident_reason': meta['reason'],
            'alert_history': [{k: e[k] for k in ('name', 'instance',
                                                 'event')}
                              for e in rollup['alerts']['history']],
            'fleet_counters': {k: v for k, v in counters.snapshot().items()
                               if k.split('.')[0] in ('fleet', 'alerts',
                                                      'incident')},
            'pub_busy_us': busy_us, 'wall_s': wall,
            'pub_busy_fraction': busy_us / 1e6 / wall})
    log('fleet: hosts %s (live together %d), K1 launches measured: parent '
        '%d, children %s; K1 counters in the rollup %s, in the children %s; '
        'parent %.1f Msamples/s, children %s Msamples/s'
        % (out['hosts'], out['live_together'], launches,
           out['child_launches'], out['k1_counters_rollup'],
           out['child_counters'], msps,
           ['%.1f' % m for m in out['child_msps']]))
    log('fleet: staleness alert fired %.2f s after the child exited, '
        'cleared %.2f s after it restarted; incident %s %.2f s after the '
        'stall; fleet.pub.busy_us %d over %.1f s of wall (%.4f%%)'
        % (out['alert_fired_after_exit_s'],
           out['alert_cleared_after_restart_s'], out['incident'],
           out['incident_after_stall_s'], busy_us, wall,
           100 * out['pub_busy_fraction']))
    return out


# ---------------------------------------------------------------------------
# the service, fabric and scheduler tiers (items 15f, 15g and 15h)
# ---------------------------------------------------------------------------

#: service phase: distinct recorded flagship gulps, the replay passes of
#: tenants A (solo and together), B (solo and together, shedding) and C,
#: of the cold and warm tenants; the oracle's rows; C's faulted gulp
SGULPS, SA_LOOPS, SB_LOOPS, SC_LOOPS, SW_LOOPS = 4, 2, 3, 2, 1
SSEED, SROWS, SFAULT_AFTER = 61, [0, 8191, 16383], 1
#: fabric phase: gulps the stations child ships (two distinct FX gulps in
#: turn) and the one after which it is killed; membership timers
FNGULP, FKILL_AFTER = 6, 3
FHEARTBEAT, FDEADLINE, FREJOIN_CAP = '0.1', '1.0', '0.2'
FXTIMEOUT = 300
#: scheduler phase: the synthetic tenants' gulps (SCH_T frames of
#: NPOL x NFINE ci8 made from as many float32 pairs), gulps a stream,
#: each tenant's pacing (seconds a gulp), the migration's and the host
#: death's frontier (gulps delivered first)
SCH_T, SCH_N, SCH_SEED = 256, 12, 71
SCH_TICK = {'sa': 0.6, 'sb': 1.2, 'sc': 0.25}
SCH_MIGRATE_AT, SCH_KILL_AT = 2, 3


def card_digest(x):
    """An order-sensitive digest of a card tensor's bytes, made on the
    card: int32 words summed along the last axis, weighted by position."""
    import torch
    words = x.contiguous().view(torch.int32)
    rows = words.reshape(words.shape[0], -1, words.shape[-1]) \
        .sum(dim=-1, dtype=torch.int64)
    w = torch.arange(1, rows.numel() + 1, dtype=torch.int64,
                     device=rows.device).reshape(rows.shape) * 2654435761
    return int((rows * w).sum().item())


def spectrometer_build(bt, out, tid, sink_cls):
    """A tenant's chain past its quota gate: copy('cuda') -> fused[FFT,
    Stokes, reduce(4)] (K1 substituted) -> copy('system') ->
    ``sink_cls``; ``out[tid]`` gets (sink, fused block)."""
    from bifrost_tpu_torch.stages import (FftStage, DetectStage,
                                          ReduceStage)

    def build(gate):
        fb = bt.blocks.fused(
            bt.blocks.copy(gate, space='cuda'),
            [FftStage('fine_time', axis_labels='freq'),
             DetectStage('stokes', axis='pol'),
             ReduceStage('freq', RFACTOR)])
        out[tid] = (sink_cls(bt.blocks.copy(fb, space='system')), fb)
    return build


def crc_sink_class(bt):
    class CrcSink(bt.SinkBlock):
        """CRC-32 of every output gulp as (sequence, crc), the host
        clock at each, and the oracle rows of the first gulps."""

        def __init__(self, iring):
            super(CrcSink, self).__init__(iring)
            self.out, self.times, self.rows = [], [], []
            self.nseq = -1

        def on_sequence(self, iseq):
            self.nseq += 1

        def on_data(self, ispan):
            a = ispan.data.as_numpy()
            self.out.append((self.nseq, zlib.crc32(memoryview(
                a.reshape(-1).view(np.uint8)))))
            if len(self.rows) < SGULPS:
                self.rows.append(np.array(a[SROWS], copy=True))
            self.times.append(time.perf_counter())
    return CrcSink


def record_stream(bt, gulps, tmp):
    """Record ``gulps`` with the port's serialize; returns the basename
    a replay tenant names."""
    src_cls = k1_source_class(bt, gulps, len(gulps), 'svc')
    with bt.Pipeline() as p:
        bt.blocks.serialize(src_cls(), path=tmp)
    run_with_timeout(p, FXTIMEOUT)
    return os.path.join(tmp, 'svc')


def replay_spec(service, tid, base, loops, **kw):
    return service.TenantSpec(tid, gulp_nframe=NTIME, source={
        'kind': 'replay', 'basenames': [base], 'gulp_nframe': NTIME,
        'loop': loops}, **kw)


def tenant_rate(sink):
    """Msamples/s of a tenant between its first and last output."""
    t = sink.times
    if len(t) < 2:
        return None
    return (len(t) - 1) * NTIME * NPOL * NFINE / (t[-1] - t[0]) / 1e6


def check_tenant_bytes(what, sink, ref, ordered=True):
    """Every output of ``sink`` is the solo run's output of one recorded
    gulp; within a replay pass (a sequence) the gulps keep their order.
    Returns the recorded gulp index of each output."""
    idx = {c: i for i, c in enumerate(ref)}
    found, last = [], {}
    for seq, c in sink.out:
        require(c in idx, '%s: an output differs from every solo output'
                % what)
        i = idx[c]
        require(not ordered or i > last.get(seq, -1),
                '%s: outputs out of order in pass %d' % (what, seq))
        last[seq] = i
        found.append(i)
    return found


def service_solo(bt, TS, base, tid, loops, crc_sink, **kw):
    """One tenant alone on a JobManager of its own (no warm state)."""
    out = {}
    mgr = TS.JobManager(max_tenants=1, warm=False)
    job = mgr.submit(replay_spec(TS, tid, base, loops, **kw),
                     spectrometer_build(bt, out, tid, crc_sink))
    mgr.start()
    states = mgr.wait(FXTIMEOUT)
    mgr.shutdown()
    require(states == {tid: 'DONE'}, 'service: solo %s ended %s (%s)'
            % (tid, states, job.error))
    sink, fb = out[tid]
    require(len(sink.out) == loops * SGULPS, 'service: solo %s delivered '
            '%d of %d gulps' % (tid, len(sink.out), loops * SGULPS))
    return sink, fb, job


def phase_service(bt, spec, gpu_kernels, smi):
    """The service phase (item 15f of the module docstring)."""
    import tempfile
    import torch
    from bifrost_tpu_torch import service as TS
    from bifrost_tpu_torch.telemetry import counters
    from bifrost_tpu_torch.testing import faults
    crc_sink = crc_sink_class(bt)
    gulps = make_gulps(SSEED, SGULPS)
    gulp_nbyte = gulps[0].nbytes
    nsamp = NTIME * NPOL * NFINE
    out = {'gulp': [NTIME, NPOL, NFINE], 'rfactor': RFACTOR,
           'recorded_gulps': SGULPS, 'card': smi}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        base = record_stream(bt, gulps, tmp)
        out['record_s'] = time.perf_counter() - t0
        oracle = [spec.spectrometer_oracle(g[SROWS], RFACTOR)
                  for g in gulps]
        del gulps
        # solo runs: each tenant's chain alone (C without its fault)
        solo = {}
        for tid, loops in (('A', SA_LOOPS), ('B', SB_LOOPS),
                           ('C', SC_LOOPS)):
            sink, _fb, _job = service_solo(bt, TS, base, tid, loops,
                                           crc_sink)
            solo[tid] = sink
        ref = [c for _s, c in solo['A'].out[:SGULPS]]
        require(len(set(ref)) == SGULPS, 'service: the recorded gulps do '
                'not digest apart')
        for tid, sink in solo.items():
            require([c for _s, c in sink.out] ==
                    ref * (len(sink.out) // SGULPS),
                    'service: solo %s differs from solo A' % tid)
        errs = []
        for k in range(2):
            errs.append(rel_err(solo['A'].rows[k], oracle[k]))
            require(errs[-1] < GATE, 'service: solo A gulp %d rows vs the '
                    'oracle: %.3g' % (k, errs[-1]))
        log_crc('service solo A outputs', ref)
        alone = {t: tenant_rate(s) for t, s in solo.items()}
        # B's quota: half the ci8 bytes (2 a sample) a second it showed
        # alone
        quota = alone['B'] * 1e6 * 2 * 0.5
        # together: A (priority 2), B (shed at half its rate), C with a
        # host-level fault in its fused block
        counters.reset()
        faults.clear()
        run = {}
        mgr = TS.JobManager(max_tenants=4, warm=False)
        for tid, loops, kw in (
                ('A', SA_LOOPS, {'priority': 2}),
                ('B', SB_LOOPS, {'quota_bytes_per_s': quota,
                                 'quota_policy': 'shed'}),
                ('C', SC_LOOPS, {})):
            mgr.submit(replay_spec(TS, tid, base, loops, **kw),
                       spectrometer_build(bt, run, tid, crc_sink))
        cname = run['C'][1].name
        fault = faults.inject('block.on_data', match=cname,
                              count=1, after=SFAULT_AFTER)
        zero_counts(spec, gpu_kernels)
        t0 = time.perf_counter()
        mgr.start()
        states = mgr.wait(FXTIMEOUT)
        wall = time.perf_counter() - t0
        counts = read_counts(spec, gpu_kernels)
        faults.clear()
        stats = {t: mgr.job(t).stats() for t in ('A', 'B', 'C')}
        mgr.shutdown()
        require(states == {'A': 'DONE', 'B': 'DONE', 'C': 'FAILED'},
                'service: tenants ended %s (C: %s)' % (
                    states, stats['C'].get('error')))
        require(fault.fired == 1 and 'injected fault' in
                stats['C'].get('error', ''), 'service: C failed otherwise: '
                '%s' % stats['C'].get('error'))
        for tid in ('A', 'B'):
            require(stats[tid]['rings_poisoned'] == 0 and
                    stats[tid]['ring_shed_gulps'] == 0,
                    'service: %s felt C\'s fault: %s' % (tid, stats[tid]))
        a_sink, b_sink = run['A'][0], run['B'][0]
        require([c for _s, c in a_sink.out] == ref * SA_LOOPS,
                'service: A together differs from A alone')
        b_found = check_tenant_bytes('service B', b_sink, ref)
        for what, sink, idx in (('A', a_sink, [0, 1]),
                                ('B', b_sink, b_found[:2])):
            for k, i in enumerate(idx):
                errs.append(rel_err(sink.rows[k], oracle[i]))
                require(errs[-1] < GATE, 'service: %s output %d rows vs '
                        'the oracle: %.3g' % (what, k, errs[-1]))
        shed = counters.get('service.B.quota_shed_gulps')
        admitted = counters.get('service.B.admitted_gulps')
        offered = SB_LOOPS * SGULPS
        require(shed >= 1 and admitted == len(b_sink.out) >= 1 and
                admitted + shed == offered,
                'service: B admitted %d, shed %d of %d gulps, delivered %d'
                % (admitted, shed, offered, len(b_sink.out)))
        require(counters.get('service.B.admitted_bytes') +
                counters.get('service.B.quota_shed_bytes') ==
                offered * gulp_nbyte, 'service: B\'s admitted and shed '
                'bytes do not add up to the offered bytes')
        fused = [run[t][1] for t in ('A', 'B', 'C')]
        prewarm = sum(fb.prewarm_runs for fb in fused)
        k1 = counts['fused_spectrometer']
        delivered = len(a_sink.out) + len(b_sink.out)
        require(k1 > delivered + prewarm and
                counts['fused_spectrometer_radix16'] == k1,
                'service: K1 launched %d times (radix16 %s) for %d delivered '
                'gulps, %d prewarm runs and C\'s gulps'
                % (k1, counts['fused_spectrometer_radix16'], delivered,
                   prewarm))
        log_crc('service together B outputs', [c for _s, c in b_sink.out])
        together = {t: tenant_rate(run[t][0]) for t in ('A', 'B')}
        out.update({
            'alone_msps': alone, 'together_msps': together,
            'together_aggregate_msps': (len(a_sink.out) + len(b_sink.out) +
                                        len(run['C'][0].out)) * nsamp /
            wall / 1e6,
            'together_wall_s': wall, 'quota_b_bytes_per_s': quota,
            'b_admitted_gulps': admitted, 'b_shed_gulps': shed,
            'b_offered_gulps': offered, 'b_recorded_gulp_of_each_output':
                b_found, 'c_gulps_before_fault': len(run['C'][0].out),
            'c_error': stats['C'].get('error', '').splitlines()[0],
            'oracle_rel_err': errs,
            'k1_launches': k1, 'k1_prewarm_runs': prewarm,
            'k1_launches_gulps': k1 - prewarm, 'launches': {
                k: n for k, n in counts.items() if n}})
        del run, solo, fused
        settle_memory()
        # warm start: A's topology resubmitted as a new tenant after a
        # cold tenant of it finished on a warm-enabled manager
        counters.reset()
        mgr = TS.JobManager(max_tenants=2, warm=True)
        TS.reset_warm_registry()
        lat, warm = {}, {}
        for tid in ('Acold', 'Awarm'):
            t0 = time.perf_counter()
            job = mgr.submit(replay_spec(TS, tid, base, SW_LOOPS),
                             spectrometer_build(bt, warm, tid, crc_sink))
            zero_counts(spec, gpu_kernels)
            mgr.start(tid)
            require(job.wait(FXTIMEOUT) == 'DONE', 'service: %s ended %s '
                    '(%s)' % (tid, job.state, job.error))
            sink, fb = warm[tid]
            c = read_counts(spec, gpu_kernels)
            lat[tid] = {'warm': job.warm,
                        'submit_to_first_gulp_ms':
                            (sink.times[0] - t0) * 1e3,
                        'run_start_to_first_admitted_ms':
                            job.start_latency_s * 1e3,
                        'k1_launches': c['fused_spectrometer_radix16'],
                        'k1_prewarm_runs': fb.prewarm_runs,
                        'plan_depot_hits':
                            counters.get('fused.plan_depot_hits'),
                        'plan_builds': counters.get('fused.plan_builds')}
            require([x for _s, x in sink.out] == ref * SW_LOOPS,
                    'service: %s differs from A alone' % tid)
        mgr.shutdown()
        require(not lat['Acold']['warm'] and lat['Awarm']['warm'] and
                counters.get('service.warm.hits') == 1 and
                counters.get('service.warm.rejected_stale') == 0,
                'service: warm start %s, hits %d' % (
                    lat, counters.get('service.warm.hits')))
        require(lat['Awarm']['plan_depot_hits'] -
                lat['Acold']['plan_depot_hits'] >= 1 and
                lat['Awarm']['plan_builds'] == lat['Acold']['plan_builds'],
                'service: the warm tenant built plans: %s' % lat)
        for tid in ('Acold', 'Awarm'):
            n = lat[tid]['k1_launches']
            require(n == SW_LOOPS * SGULPS + lat[tid]['k1_prewarm_runs'],
                    'service: %s launched K1 %d times' % (tid, n))
        out['warm'] = lat
        out['warm_counters'] = {k: v for k, v in counters.snapshot().items()
                                if k.startswith(('service.warm', 'fused.',
                                                 'autotune.profile'))}
        del warm
        settle_memory()
    torch.cuda.empty_cache()
    log('service: 3 tenants of %d x %d x %d ci8 (r %d) replayed from a '
        'recording; alone %s Msamples/s, together A %.1f and B %.1f '
        '(aggregate %.1f over %.1f s); B shed %d of %d gulps at a quota of '
        '%.3g B/s; C failed after %d gulps (%s); K1 %d launches (%d gulps, %d '
        'prewarm); warm start %s (%s)'
        % (NTIME, NPOL, NFINE, RFACTOR,
           {t: round(v, 1) for t, v in out['alone_msps'].items()},
           together['A'], together['B'] or 0,
           out['together_aggregate_msps'], wall, shed, offered, quota,
           out['c_gulps_before_fault'], out['c_error'], k1, k1 - prewarm,
           prewarm, {t: (round(v['submit_to_first_gulp_ms'], 1),
                         v['k1_prewarm_runs']) for t, v in lat.items()},
           smi))
    return out


# -- the fabric phase -------------------------------------------------------

def fx_fabric_spec(ports):
    return {'name': 'smoke_fx', 'hosts': {
        'stations': {'address': '127.0.0.1', 'control_port': ports[0],
                     'role': 'capture'},
        'xhost': {'address': '127.0.0.1', 'control_port': ports[1],
                  'role': 'reduce'}},
        'links': {'voltages': {'kind': 'pipe', 'src': 'stations',
                               'dst': 'xhost', 'port': ports[2],
                               'window': 2,
                               'gulp_nbyte': XT * XF * XS * XP * 2}}}


def fabric_stations(arg):
    """``chip_smoke.py --fabric-stations JSON``: the 'stations' host of
    the fabric drill, host only.  It resumes where the xhost's receiver
    (or its own ledger) says, ships the FX phase's ci8 gulps in turn up
    to FNGULP, prints a FABRIC_PRODUCED line (its bytes so far) at each
    gulp and one FABRIC_STATIONS line of JSON at the end."""
    import bifrost_tpu_torch as bt
    from bifrost_tpu_torch import fabric
    from bifrost_tpu_torch.telemetry import counters
    a = json.loads(arg)
    gulps = fx_gulps()
    box = {}
    hold = a.get('hold_after')

    class Stations(bt.SourceBlock):
        def __init__(self, start):
            super(Stations, self).__init__(['fx'], XT, space='system')
            self.count = start

        def create_reader(self, name):
            return contextlib.nullcontext()

        def on_sequence(self, reader, name):
            return [fx_header(['time', 'fine', 'station', 'pol'], XT)]

        def on_data(self, reader, ospans):
            if self.count == FNGULP:
                return [0]
            if self.count == hold:
                # the drill's kill lands here, once every span shipped so
                # far is acknowledged and journalled (the ledger writes at
                # most every AckLedger.SAVE_INTERVAL), none in flight
                led = fh.ledger('voltages')
                while led.acked_frames('fx') < hold * XT:
                    if self.shutdown_event.wait(0.01):
                        return [0]
                led.save(force=True)
                self.shutdown_event.wait()
                return [0]
            dst = ospans[0].data.as_numpy().view(np.int8)
            dst[...] = gulps[self.count % len(gulps)].reshape(dst.shape)
            self.count += 1
            box['produced'] = box.get('produced', 0) + dst.nbytes
            print('FABRIC_PRODUCED %d' % box['produced'], flush=True)
            return [XT]

    def build(ctx):
        box['resume_frames'] = ctx.resume_offset('voltages', 'fx')
        require(box['resume_frames'] % XT == 0, 'stations: resume at frame '
                '%d' % box['resume_frames'])
        ctx.sink('voltages', Stations(box['resume_frames'] // XT))

    fh = fabric.FabricHost(a['spec'], 'stations', build)
    t0 = time.perf_counter()
    fh.build()
    fh.run()
    print('FABRIC_STATIONS ' + json.dumps({
        'secs': time.perf_counter() - t0, 'rejoining': fh.rejoining,
        'resume_frames': box['resume_frames'],
        'counters': {k: v for k, v in counters.snapshot().items()
                     if k.startswith(('bridge.tx', 'fabric.'))}}),
        flush=True)
    return 0


def produced_bytes(stdout):
    """The last FABRIC_PRODUCED count a stations child printed."""
    lines = [ln for ln in stdout.splitlines()
             if ln.startswith('FABRIC_PRODUCED ')]
    return int(lines[-1].split()[1]) if lines else 0


def stations_child(spec, hold_after=None):
    here = os.path.abspath(__file__)
    return subprocess.Popen([sys.executable, here, '--fabric-stations',
                             json.dumps({'spec': spec,
                                         'hold_after': hold_after})],
                            stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def load_module(name, path):
    import importlib.util
    mod = importlib.util.spec_from_file_location(name, path)
    m = importlib.util.module_from_spec(mod)
    mod.loader.exec_module(m)
    return m


def fabric_examples(bt, spec, gpu_kernels, smi):
    """The two examples' --fabric runs at their own shapes against their
    single-host runs, K7 and K3 forced; returns their record."""
    here = os.path.dirname(os.path.abspath(__file__))
    fx = load_module('fx_correlator_torch',
                     os.path.join(here, 'examples', 'fx_correlator_torch.py'))
    fd = load_module('fdmt_search_torch',
                     os.path.join(here, 'examples', 'fdmt_search_torch.py'))
    out = {}
    with environ(BF_XCORR_IMPL='pallas', BF_FDMT_IMPL='pallas'):
        single = fx.run_single(quiet=True)
        zero_counts(spec, gpu_kernels)
        t0 = time.perf_counter()
        hosts, sinks = fx.build_fabric(quiet=True)
        fx.run_hosts(hosts, FXTIMEOUT)
        secs = time.perf_counter() - t0
        counts = read_counts(spec, gpu_kernels)
        got = sinks[0].visibilities
        require(len(got) == len(single.visibilities) == fx.NGULP and all(
            a.tobytes() == b.tobytes()
            for a, b in zip(got, single.visibilities)),
            'fabric: fx_correlator_torch --fabric differs from its single '
            'host run')
        require(counts['xcorr_herm'] >= fx.NGULP, 'fabric: the FX example '
                'launched K7 %d times' % counts['xcorr_herm'])
        log_crc('fabric fx example visibilities', [crc32(a) for a in got])
        out['fx_example'] = {'gulps': fx.NGULP, 'secs': secs,
                             'k7_launches': counts['xcorr_herm']}
        peak1 = fd.run_single()
        zero_counts(spec, gpu_kernels)
        t0 = time.perf_counter()
        peak2 = fd.run_fabric(FXTIMEOUT)
        secs = time.perf_counter() - t0
        counts = read_counts(spec, gpu_kernels)
        require(peak1.best == peak2.best and
                peak1.ncandidates == peak2.ncandidates,
                'fabric: fdmt_search_torch --fabric found %s (%d), single '
                'host %s (%d)' % (peak2.best, peak2.ncandidates, peak1.best,
                                  peak1.ncandidates))
        require(counts['fdmt_step'] >= 1, 'fabric: the FDMT example '
                'launched K3 %d times' % counts['fdmt_step'])
        out['fdmt_example'] = {'peak': list(peak2.best),
                               'candidates': peak2.ncandidates,
                               'secs': secs,
                               'k3_launches': counts['fdmt_step']}
    log('fabric: examples --fabric equal their single-host runs: FX %d '
        'integrations (K7 %d launches, %.1f s), FDMT peak %s (K3 %d '
        'launches, %.1f s) (%s)'
        % (len(got), out['fx_example']['k7_launches'],
           out['fx_example']['secs'], list(peak2.best),
           out['fdmt_example']['k3_launches'], out['fdmt_example']['secs'],
           smi))
    return out


def fx_xhost_build(bt, box):
    """The xhost's chain: the link's system ring -> copy('cuda') -> fft ->
    quantize -> correlate (K7 forced) -> accumulate -> a sink that
    digests each visibility on the card (and keeps the host CRC-32 of the
    first two)."""
    class DigestSink(bt.SinkBlock):
        def __init__(self, iring):
            super(DigestSink, self).__init__(iring)
            self.digests, self.times, self.crcs = [], [], []

        def define_valid_input_spaces(self):
            return ('cuda',)

        def on_sequence(self, iseq):
            pass

        def on_data(self, ispan):
            self.digests.append(card_digest(ispan.data))
            if len(self.crcs) < 2:
                self.crcs.append(crc32(ispan.data.cpu().numpy()))
            self.times.append(time.perf_counter())

    def build(ctx):
        b = bt.blocks.copy(ctx.source('voltages'), space='cuda')
        b = bt.blocks.fft(b, axes='fine', axis_labels='freq')
        b = bt.blocks.quantize(b, 'ci8', scale=XSCALE)
        b = bt.blocks.correlate(b, XR, accuracy='int8', impl='pallas',
                                fusable=True)
        b = bt.blocks.accumulate(b, XA, fusable=True)
        box['sink'] = DigestSink(b)
    return build


def phase_fabric(bt, spec, gpu_kernels, smi):
    """The fabric phase (item 15g of the module docstring)."""
    import tempfile
    import threading
    import torch
    from bifrost_tpu_torch import fabric
    from bifrost_tpu_torch.scheduler import ledger_frontier
    from bifrost_tpu_torch.telemetry import counters
    out = {'examples': fabric_examples(bt, spec, gpu_kernels, smi),
           'card': smi}
    # the reference: the FX chain's output for each distinct gulp, made
    # on the card in float64 products (the FX phase's oracle)
    gulps = fx_gulps()
    want_digest, want_crc = [], []
    for g in gulps:
        vis = fx_oracle_device(g)
        want_digest.append(card_digest(vis))
        want_crc.append(crc32(vis.cpu().numpy()))
        del vis
    del gulps
    torch.cuda.empty_cache()
    gulp_nbyte = XT * XF * XS * XP * 2
    with tempfile.TemporaryDirectory() as tmp, environ(
            BF_FABRIC_STATE=os.path.join(tmp, 'state'),
            BF_FABRIC_HEARTBEAT_SECS=FHEARTBEAT,
            BF_FABRIC_DEADLINE_SECS=FDEADLINE,
            BF_FABRIC_REJOIN_CAP=FREJOIN_CAP):
        fspec = fx_fabric_spec(free_ports('udp', 2) +
                               free_ports('tcp', 1))
        counters.reset()
        box = {}
        fh = fabric.FabricHost(fspec, 'xhost', fx_xhost_build(bt, box),
                               jitter=False)
        fh.build()
        zero_counts(spec, gpu_kernels)
        err = {}

        def run():
            try:
                fh.run(install_signals=False)
            except BaseException as exc:
                err['exc'] = exc
        xt = threading.Thread(target=run, daemon=True)
        xt.start()
        sink = box['sink']
        child = stations_child(fspec, hold_after=FKILL_AFTER)
        second = None
        try:
            member = fh.membership

            def alive():
                snap = member.peers_snapshot().get('stations') or {}
                return snap.get('alive') and 'stations' not in member._dead
            wait_for(lambda: len(sink.digests) >= FKILL_AFTER and
                     ledger_frontier(fspec['name'], 'stations', 'voltages')
                     >= FKILL_AFTER * XT and alive(),
                     'fabric: the stations child delivered no %d gulps'
                     % FKILL_AFTER, timeout=FXTIMEOUT)
            frontier_before = ledger_frontier(fspec['name'], 'stations',
                                              'voltages')
            t_kill = time.monotonic()
            child.kill()
            produced = [produced_bytes(child.communicate()[0])]
            t_dead = wait_for(lambda: 'stations' in member._dead,
                              'fabric: membership never marked the killed '
                              'stations host dead', timeout=30)
            dead_ms = (t_dead - t_kill) * 1e3
            second = stations_child(fspec)
            try:
                sout, serr = second.communicate(timeout=FXTIMEOUT)
            except subprocess.TimeoutExpired:
                second.kill()
                sout, serr = second.communicate()
                raise RuntimeError('chip_smoke check failed: the second '
                                   'stations child still running')
            require(second.returncode == 0, 'fabric: the second stations '
                    'child exited %d: %s' % (second.returncode,
                                             serr[-3000:]))
            second = None
            xt.join(FXTIMEOUT)
            require(not xt.is_alive(), 'fabric: the xhost still running')
        finally:
            for c in (child, second):
                if c is not None and c.poll() is None:
                    c.kill()
                    c.communicate()
            if xt.is_alive():
                fh.pipeline.shutdown()
                xt.join(30)
        if 'exc' in err:
            raise err['exc']
        counts = read_counts(spec, gpu_kernels)
        tx = json.loads([ln for ln in sout.splitlines()
                         if ln.startswith('FABRIC_STATIONS ')][0]
                        .split(' ', 1)[1])
        produced.append(produced_bytes(sout))
        led = fabric.AckLedger(fspec['name'], 'stations', 'voltages')
        snap = counters.snapshot()
        ring_shed = sum(r.shed_stats().get('shed_bytes', 0)
                        for b in fh.pipeline.blocks
                        for r in getattr(b, 'orings', ()))
    require(len(sink.digests) == FNGULP, 'fabric: the xhost received %d of '
            '%d gulps' % (len(sink.digests), FNGULP))
    for i, d in enumerate(sink.digests):
        require(d == want_digest[i % 2], 'fabric: visibility %d differs '
                'from the FX chain\'s for its gulp' % i)
    require(sink.crcs == want_crc, 'fabric: crc32 of the first two '
            'visibilities %s, of the FX chain\'s %s' % (sink.crcs, want_crc))
    require(counts['xcorr_herm'] == FNGULP, 'fabric: K7 launched %d times '
            'for %d gulps' % (counts['xcorr_herm'], FNGULP))
    require(snap.get('bridge.rx.sessions_adopted', 0) >= 1,
            'fabric: the relaunched stations host was not adopted')
    resumed = tx['resume_frames']
    require(tx['rejoining'] and resumed >= FKILL_AFTER * XT and
            resumed % XT == 0 and resumed < FNGULP * XT,
            'fabric: the relaunched stations host resumed at frame %d'
            % resumed)
    delivered = len(sink.digests) * gulp_nbyte
    shed = led.shed_bytes + ring_shed
    require(produced == [FKILL_AFTER * gulp_nbyte,
                         FNGULP * XT * 2 * XF * XS * XP - resumed * 2 * XF *
                         XS * XP] and sum(produced) == delivered + shed and
            frontier_before == FKILL_AFTER * XT,
            'fabric: the two stations runs produced %s bytes, the xhost '
            'delivered %d and the journal and rings shed %d (journal '
            'frontier at the kill %d frames)' % (
                produced, delivered, shed, frontier_before))
    t = sink.times
    seg1 = [t[i] for i in range(FKILL_AFTER)]
    seg2 = t[resumed // XT:]
    rates = [(len(s) - 1) * gulp_nbyte / (s[-1] - s[0]) / 1e6
             for s in (seg1, seg2) if len(s) > 1]
    out.update({
        'gulps': FNGULP, 'gulp_bytes': gulp_nbyte,
        'killed_after_gulp': FKILL_AFTER,
        'ledger_frontier_at_kill': frontier_before,
        'resumed_at_frame': resumed,
        'replayed_frames': FNGULP * XT - resumed,
        'dead_mark_ms': dead_ms, 'deadline_s': float(FDEADLINE),
        'link_MBps': rates, 'k7_launches': counts['xcorr_herm'],
        'produced_bytes': produced, 'delivered_bytes': delivered,
        'shed_bytes': shed,
        'journal': {'acked_bytes': led.acked_bytes,
                    'acked_frames': led.acked_frames('fx'),
                    'shed_bytes': led.shed_bytes},
        'rx_counters': {k: v for k, v in snap.items()
                        if k.startswith(('bridge.rx', 'fabric.'))},
        'tx_counters_second': tx['counters']})
    log_crc('fabric xhost visibilities', sink.crcs)
    log('fabric: stations child -> xhost over loopback, %d gulps of %d '
        'MiB; killed after gulp %d (journal frontier %d frames), marked dead '
        'in %.0f ms (deadline %s s); relaunched, resumed at frame %d '
        '(%d frames replayed); K7 %d launches; every visibility equals the '
        'FX chain\'s; delivered MB/s per session %s; produced %s = %d '
        'delivered + %d shed bytes (%s)'
        % (FNGULP, gulp_nbyte >> 20, FKILL_AFTER, frontier_before, dead_ms,
           FDEADLINE, resumed, FNGULP * XT - resumed, counts['xcorr_herm'],
           ['%.1f' % r for r in rates], produced, delivered, shed, smi))
    return out


def free_ports(kind, n):
    """``n`` free loopback ports of ``kind`` ('udp' or 'tcp')."""
    import socket
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM
                          if kind == 'udp' else socket.SOCK_STREAM)
        s.bind(('127.0.0.1', 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


# -- the scheduler phase ----------------------------------------------------

def sched_blocks(bt):
    """The scheduler phase's host blocks: float32 pairs to ci8 spectrometer
    gulps, and a sink that journals each delivered gulp to an AckLedger
    and keeps its CRC-32 by absolute gulp index."""
    from bifrost_tpu_torch import fabric

    class ToCi8(bt.TransformBlock):
        def on_sequence(self, iseq):
            hdr = dict(iseq.header)
            hdr['_tensor'] = spec_header(NFINE)['_tensor']
            return hdr

        def on_data(self, ispan, ospan):
            x = ispan.data.as_numpy()
            dst = ospan.data.as_numpy().view(np.int8)
            dst[...] = np.clip(np.rint(x * 24), -128, 127) \
                .astype(np.int8).reshape(dst.shape)

    class LedgerSink(bt.SinkBlock):
        def __init__(self, iring, fab, host, tid, store):
            super(LedgerSink, self).__init__(iring)
            self.ledger = fabric.AckLedger(fab, host, tid)
            self.store = store

        def on_sequence(self, iseq):
            self.seq = iseq.header['name']
            self.f0 = self.ledger.acked_frames(self.seq)

        def on_data(self, ispan):
            a = ispan.data.as_numpy()
            off = self.f0 + ispan.frame_offset
            self.store.append((off // SCH_T, zlib.crc32(memoryview(
                a.reshape(-1).view(np.uint8))), time.perf_counter()))
            self.ledger.note_acked(self.seq, off, ispan.nframe, a.nbytes)
            self.ledger.save(force=True)
    return ToCi8, LedgerSink


def sched_tenant(TS, tid, **kw):
    return TS.TenantSpec(tid, gulp_nframe=SCH_T, source={
        'kind': 'synthetic', 'nframe_total': SCH_T * SCH_N,
        'gulp_nframe': SCH_T, 'nchan': NPOL * NFINE * 2, 'seed': SCH_SEED,
        'tick_s': SCH_TICK.get(tid, 0.0)}, **kw)


def phase_scheduler(bt, spec, gpu_kernels, smi):
    """The scheduler phase (item 15h of the module docstring)."""
    import tempfile
    import torch
    from bifrost_tpu_torch import fabric, scheduler
    from bifrost_tpu_torch import service as TS
    from bifrost_tpu_torch.stages import (FftStage, DetectStage,
                                          ReduceStage)
    from bifrost_tpu_torch.telemetry import counters
    ToCi8, LedgerSink = sched_blocks(bt)
    out = {'gulp': [SCH_T, NPOL, NFINE], 'gulps': SCH_N, 'card': smi}
    with tempfile.TemporaryDirectory() as tmp, environ(
            BF_FABRIC_STATE=os.path.join(tmp, 'state')):
        fspec = fabric.FabricSpec('smoke_sched', hosts={
            'h1': {'control_port': 7001, 'cores': [0, 1, 2, 3]},
            'h2': {'control_port': 7002, 'cores': [4, 5, 6, 7]}})
        stores, fused = {}, {}

        def build(tid, host):
            def b(gate):
                fb = bt.blocks.fused(
                    bt.blocks.copy(ToCi8(gate), space='cuda'),
                    [FftStage('fine_time', axis_labels='freq'),
                     DetectStage('stokes', axis='pol'),
                     ReduceStage('freq', RFACTOR)])
                fused.setdefault(tid, []).append(fb)
                LedgerSink(bt.blocks.copy(fb, space='system'),
                           fspec.name, host, tid,
                           stores.setdefault(tid, []))
            return b
        # the solo reference, on a warm-enabled manager: its plans are
        # what the placed tenants (and the migrated one) start warm from
        TS.reset_warm_registry()
        counters.reset()
        ref_mgr = TS.JobManager(max_tenants=1, warm=True)
        job = ref_mgr.submit(sched_tenant(TS, 'ref'), build('ref', 'ref'))
        ref_mgr.start()
        require(job.wait(FXTIMEOUT) == 'DONE', 'scheduler: the solo run '
                'ended %s (%s)' % (job.state, job.error))
        ref_mgr.shutdown()
        ref = [c for _i, c, _t in sorted(stores.pop('ref'))]
        require(len(ref) == SCH_N and len(set(ref)) == SCH_N,
                'scheduler: the solo run gave %d gulps, %d distinct'
                % (len(ref), len(set(ref))))
        fused.pop('ref')
        mgrs = {h: TS.JobManager(max_tenants=4, warm=True)
                for h in ('h1', 'h2')}
        sched = scheduler.Scheduler(
            fspec, managers=mgrs,
            resume_of=lambda tid, dead: scheduler.ledger_frontier(
                fspec.name, dead, tid))
        tenants = [sched_tenant(TS, 'sa', priority=3, slo_ms=1,
                                quota_bytes_per_s=1e12),
                   sched_tenant(TS, 'sb', priority=1,
                                quota_bytes_per_s=1e12),
                   sched_tenant(TS, 'sc', priority=2)]
        pins = {'sa': 'h1', 'sb': 'h2', 'sc': 'h1'}
        zero_counts(spec, gpu_kernels)
        try:
            placement = sched.place(tenants, pinned=pins)
            require(dict(placement.assignments) == pins and
                    not placement.displaced and not [
                        d for d in placement.diagnostics if d.is_error],
                    'scheduler: placement %r, diagnostics %s'
                    % (placement, placement.diagnostics))
            jobs = sched.apply(build={t: build(t, h)
                                      for t, h in pins.items()})
            require(all(j.warm for j in jobs.values()), 'scheduler: the '
                    'placed tenants did not start warm')

            def frontier(tid, host='h1'):
                return scheduler.ledger_frontier(fspec.name, host, tid)
            # migrate sc from h1 to h2 once it delivered a few gulps
            wait_for(lambda: frontier('sc') >= SCH_MIGRATE_AT * SCH_T,
                     'scheduler: sc delivered no %d gulps' % SCH_MIGRATE_AT,
                     timeout=FXTIMEOUT)
            t0 = time.perf_counter()
            mgrs['h1'].job('sc').stop(FXTIMEOUT)
            f_sc = frontier('sc')
            n_sc = len(stores['sc'])
            moved = sched.migrate('sc', 'h2', resume_frame=f_sc)
            wait_for(lambda: len(stores['sc']) > n_sc, 'scheduler: the '
                     'migrated sc delivered nothing', timeout=FXTIMEOUT)
            migrate_ms = (stores['sc'][n_sc][2] - t0) * 1e3
            require(moved.warm and sched.placement.assignments['sc'] ==
                    'h2', 'scheduler: the migration was not warm on h2')
            # h1 dies: its manager's tenants stop, then the re-placement
            wait_for(lambda: frontier('sa') >= SCH_KILL_AT * SCH_T,
                     'scheduler: sa delivered no %d gulps' % SCH_KILL_AT,
                     timeout=FXTIMEOUT)
            t0 = time.perf_counter()
            mgrs['h1'].shutdown(FXTIMEOUT)
            f_sa = frontier('sa')
            n_sa = len(stores['sa'])
            require(f_sa < SCH_N * SCH_T, 'scheduler: sa ended before h1 '
                    'died')
            replaced = sched.handle_host_death('h1')
            require(sorted(replaced) == ['sa'] and replaced['sa'].warm,
                    'scheduler: the host death moved %s' % sorted(replaced))
            wait_for(lambda: len(stores['sa']) > n_sa, 'scheduler: the '
                     're-placed sa delivered nothing', timeout=FXTIMEOUT)
            replace_ms = (stores['sa'][n_sa][2] - t0) * 1e3
            # one arbiter pass: sa (priority 3) misses its 1 ms budget, sb
            # (priority 1) holds quota
            wait_for(lambda: (replaced['sa'].slo_rollup().get('ok') is
                              False), 'scheduler: sa recorded no exit age',
                     timeout=FXTIMEOUT)
            require(mgrs['h2'].job('sb').state == 'RUNNING',
                    'scheduler: sb ended before the arbiter pass')
            transfers = sched.arbitrate(frac=0.5)
            require(transfers == [('sa', 'sb', 0.5e12)], 'scheduler: the '
                    'arbiter moved %s' % transfers)
            gates = {t: scheduler.Scheduler._quota_gate(
                mgrs['h2'].job(t)).quota_bytes_per_s for t in ('sa', 'sb')}
            require(gates == {'sa': 1.5e12, 'sb': 0.5e12},
                    'scheduler: quotas after the arbiter %s' % gates)
            states = mgrs['h2'].wait(FXTIMEOUT)
            require(states == {'sb': 'DONE', 'sc': 'DONE', 'sa': 'DONE'},
                    'scheduler: h2 ended %s' % states)
        finally:
            sched.shutdown()
        counts = read_counts(spec, gpu_kernels)
        snap = counters.snapshot()
    for tid, store in stores.items():
        idx = sorted(i for i, _c, _t in store)
        require(idx == list(range(SCH_N)), 'scheduler: %s delivered gulps '
                '%s' % (tid, idx))
        for i, c, _t in store:
            require(c == ref[i], 'scheduler: %s gulp %d differs from the '
                    'solo run' % (tid, i))
    require(snap.get('scheduler.resume.skipped_frames') == f_sc + f_sa and
            snap.get('scheduler.migrations') == 2 and
            snap.get('scheduler.replacements') == 1 and
            snap.get('scheduler.arbiter.retunes') == 1,
            'scheduler: counters %s' % {k: v for k, v in snap.items()
                                        if k.startswith('scheduler.')})
    prewarm = sum(fb.prewarm_runs for fbs in fused.values() for fb in fbs)
    delivered = sum(len(s) for s in stores.values())
    k1 = counts['fused_spectrometer']
    require(k1 >= delivered + prewarm and
            counts['fused_spectrometer_radix16'] == k1,
            'scheduler: K1 launched %d times (radix16 %s) for %d delivered '
            'gulps and %d prewarm runs' % (
                k1, counts['fused_spectrometer_radix16'], delivered,
                prewarm))
    log_crc('scheduler solo outputs', ref)
    out.update({
        'migrate_ms': migrate_ms, 'replace_ms': replace_ms,
        'resume_frames': {'sc': f_sc, 'sa': f_sa},
        'assignments': dict(sched.placement.assignments),
        'arbiter': [list(t) for t in transfers],
        'k1_launches': k1, 'k1_prewarm_runs': prewarm,
        'k1_launches_gulps': k1 - prewarm,
        'counters': {k: v for k, v in snap.items()
                     if k.startswith(('scheduler.', 'service.warm',
                                      'fused.plan'))}})
    log('scheduler: 3 K1 tenants of %d x %d x %d ci8 on h1/h2; sc migrated '
        'h1 -> h2 warm at frame %d in %.0f ms (stop to its first gulp); h1 '
        'died, sa re-placed warm at frame %d in %.0f ms; arbiter moved %s; '
        'every gulp delivered once and equal to the solo run; K1 %d launches '
        '(%d gulps, %d prewarm) (%s)'
        % (SCH_T, NPOL, NFINE, f_sc, migrate_ms, f_sa, replace_ms,
           transfers, k1, k1 - prewarm, prewarm, smi))
    torch.cuda.empty_cache()
    return out


# -- the monitors phase -----------------------------------------------------

#: gulps the monitors phase bridges (256 MiB each), and the gulps of each
#: of its two telemetry_diff arms (hand: K = 4, sync depth 4; detuned:
#: K = 1, sync depth 1)
MONGULPS, MONDIFF = 8, 32
#: frames of each span the monitors phase's sender ships (16 a gulp), and
#: the seconds its source waits before each gulp (so that the monitors,
#: each a fresh Python process, see the stream move)
MONSPAN, MONPACE = 1024, 0.5
MONTIMEOUT = 300           # seconds the monitors phase's children may take
#: the arguments an example needs to build its pipeline (the output
#: directory follows them)
LINT_ARGS = {'gpuspec_simple_torch.py': ['--demo']}


def port_examples(root):
    """Every examples/*_torch.py of the checkout at ``root``."""
    return sorted(f for f in os.listdir(os.path.join(root, 'examples'))
                  if f.endswith('_torch.py'))


def monitor_rx(args):
    """``chip_smoke.py --monitor-rx JSON``: the receiving host of the
    monitors phase, on the card: bridge_source(port) -> copy('cuda') ->
    fused[FFT, Stokes, reduce(4)] (K1) -> a sink that keeps each output's
    CRC-32.  Its ProcLogs go under the caller's BF_PROCLOG_DIR and its
    trace to BF_TRACE_FILE; it writes the file ``ready`` once its
    listener is bound.  Prints one MONITOR_RX line of JSON: the
    gulps, CRCs, K1 launches and the fused block's name."""
    import bifrost_tpu_torch as bt
    from bifrost_tpu_torch.ops import spectrometer as spec
    from bifrost_tpu_torch.stages import FftStage, DetectStage, ReduceStage
    a = json.loads(args)
    bt.device.set_device(a.get('device', 'cuda:0'))

    class Sink(bt.SinkBlock):
        def __init__(self, iring):
            super(Sink, self).__init__(iring)
            self.crcs = []
            self.frames = 0

        def on_sequence(self, iseq):
            pass

        def on_data(self, ispan):
            self.crcs.append(crc32(ispan.data.as_numpy()))
            self.frames += ispan.nframe

    l0 = spec.launches
    with bt.Pipeline() as p:
        src = bt.blocks.bridge_source('127.0.0.1', a['port'])
        fb = bt.blocks.fused(bt.blocks.copy(src, space='cuda'), [
            FftStage('fine_time', axis_labels='freq'),
            DetectStage('stokes', axis='pol'),
            ReduceStage('freq', RFACTOR)])
        sink = Sink(bt.blocks.copy(fb, space='system'))
    # the listener is bound: the sender may dial
    with open(a['ready'], 'w') as f:
        f.write(str(src.port))
    run_with_timeout(p, MONTIMEOUT)
    print('MONITOR_RX ' + json.dumps({
        'gulps': len(sink.crcs), 'crcs': sink.crcs,
        'frames': sink.frames,
        'launches': spec.launches - l0, 'prewarm_runs': fb.prewarm_runs,
        'fused': fb.name}), flush=True)
    return 0


def tail_file(f, n=4000):
    """The last ``n`` characters written to the open file ``f``."""
    f.flush()
    f.seek(0)
    return f.read()[-n:]


def run_tool(name, *args, env=None, timeout=120):
    """``python -m bifrost_tpu_torch.tools.<name> args``; returns the
    completed process."""
    here = os.path.dirname(os.path.abspath(__file__))
    return subprocess.run(
        [sys.executable, '-m', 'bifrost_tpu_torch.tools.' + name] +
        [str(x) for x in args], capture_output=True, text=True, cwd=here,
        env=dict(os.environ, **(env or {})), timeout=timeout)


def bmon_rates(text):
    """{pid: (RX B/s, TX B/s)} of like_bmon's summary table."""
    scale = {'B/s': 1.0, 'kB/s': 1024.0, 'MB/s': 1024.0 ** 2,
             'GB/s': 1024.0 ** 3}
    out = {}
    for line in text.splitlines():
        f = line.split()
        if len(f) == 7 and f[2] in scale and f[5] in scale:
            out[f[0]] = (float(f[1]) * scale[f[2]],
                         float(f[4]) * scale[f[5]])
    return out


def trace_identities(merged):
    """{pid: {(trace, seq, gulp): [span names]}} of a merged trace's
    complete events."""
    out = {}
    for e in merged['traceEvents']:
        a = e.get('args') or {}
        if e.get('ph') == 'X' and a.get('trace') and 'gulp' in a:
            key = (a['trace'], a.get('seq'), a['gulp'])
            out.setdefault(e['pid'], {}).setdefault(key, []).append(
                e.get('name', ''))
    return out


def diff_arm(bt, spec, gulps, arm, gulp_batch, sync_depth):
    """One telemetry_diff arm: the device K1 chain over MONDIFF gulps;
    returns its snapshot record (gulps_per_s, Msamples/s, the
    pipeline.sync_waits it made, K1 launches)."""
    from bifrost_tpu_torch.telemetry import counters
    p, fb, sink = device_k1_chain(
        bt, gulps, 1, MONDIFF, 4, name='diff_' + arm,
        scope={'gulp_batch': gulp_batch, 'sync_depth': sync_depth})
    l0 = spec.launches
    w0 = counters.get('pipeline.sync_waits')
    run_with_timeout(p)
    require(sink.n == MONDIFF, 'monitors %s: the sink saw %d of %d gulps'
            % (arm, sink.n, MONDIFF))
    secs = sink.t1 - sink.t0
    return {'arm': arm, 'gulp_batch': gulp_batch, 'sync_depth': sync_depth,
            'gulps_per_s': (MONDIFF - 4) / secs,
            'sync_waits': counters.get('pipeline.sync_waits') - w0,
            'Msamples_per_s': (MONDIFF - 4) * NTIME * NPOL * NFINE / secs
            / 1e6, 'launches': spec.launches - l0,
            'digests': [int(d) for d in sink.digests]}


def phase_monitors(bt, spec, gpu_kernels, smi):
    """The monitors phase (item 15i of the module docstring)."""
    import tempfile
    import signal
    from bifrost_tpu_torch.ops import mprobe
    from bifrost_tpu_torch.telemetry import counters, fleet
    from bifrost_tpu_torch.tools import mprobe_report
    out = {'card': smi}
    steps = {}
    with tempfile.TemporaryDirectory() as tmp:
        pl = os.path.join(tmp, 'proclog')
        env = {'BF_PROCLOG_DIR': pl}
        port, = free_ports('tcp', 1)
        # the bridged K1 stream: a receiving child on the card, a sending
        # child on the host, both tracing
        t = time.perf_counter()
        here = os.path.abspath(__file__)
        with environ(BF_PROCLOG_DIR=pl,
                     BF_TRACE_FILE=os.path.join(tmp, 'rx.json')):
            ready = os.path.join(tmp, 'rx.ready')
            from bifrost_tpu_torch.device import get_device
            # the children's output goes to files: a full pipe would
            # stall them
            rx_log = open(os.path.join(tmp, 'rx.log'), 'w+')
            rx = subprocess.Popen(
                [sys.executable, here, '--monitor-rx',
                 json.dumps({'port': port, 'ready': ready,
                             'device': str(get_device())})],
                stdin=subprocess.DEVNULL, stdout=rx_log,
                stderr=subprocess.STDOUT, text=True)
        try:
            # while the receiver starts: this process's K1 arms, published
            # to a bf_console child; telemetry_diff --strict flags the
            # detuned arm against the hand one
            t_arms = time.perf_counter()
            cport, = free_ports('udp', 1)
            rollup_path = os.path.join(tmp, 'rollup.json')
            c_log = open(os.path.join(tmp, 'console.log'), 'w+')
            console = subprocess.Popen(
                [sys.executable, '-m', 'bifrost_tpu_torch.tools.bf_console',
                 '--bind', '127.0.0.1:%d' % cport, '--interval', '0.5',
                 '--rollup-file', rollup_path],
                cwd=os.path.dirname(here), stdin=subprocess.DEVNULL,
                stdout=c_log, stderr=subprocess.STDOUT, text=True)
            counters.reset()
            l0 = spec.launches
            arms = {}
            try:
                with environ(BF_FLEET_COLLECTOR='127.0.0.1:%d' % cport,
                             BF_FLEET_HOST='smoke-monitors',
                             BF_FLEET_INTERVAL='0.25'):
                    pub = fleet.acquire_publisher()
                    try:
                        gulps, _h = device_gulps(2, seed=16)
                        for arm, k, depth in (('hand', 4, 4),
                                              ('detuned', 1, 1)):
                            arms[arm] = diff_arm(bt, spec, gulps, arm, k,
                                                 depth)
                        launches = spec.launches - l0

                        def rolled():
                            try:
                                with open(rollup_path) as f:
                                    r = json.load(f)
                            except (OSError, ValueError):
                                return False
                            h = r.get('hosts', {}).get('smoke-monitors',
                                                       {})
                            return h.get('counters', {}).get(
                                K1_COUNTER) == launches
                        wait_for(rolled, 'monitors: the console rollup '
                                 'never showed %d K1 launches' % launches,
                                 timeout=30)
                    finally:
                        fleet.release_publisher(pub)
            finally:
                console.send_signal(signal.SIGINT)
                try:
                    console.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    console.kill()
                    console.wait()
                c_log.seek(0)
                c_out = c_log.read()
                c_log.close()
            require(console.returncode == 0 and 'smoke-monitors' in c_out,
                    'monitors: bf_console rc %s, no host row: %s'
                    % (console.returncode, c_out[-2000:]))
            frames = c_out.split('fleet - ')
            log('bf_console (last frame):\nfleet - ' + frames[-1].strip())
            require(arms['hand']['digests'][:2] ==
                    arms['detuned']['digests'][:2],
                    'monitors: the detuned arm computed other bytes')
            snaps = {}
            for arm, rec in arms.items():
                snaps[arm] = os.path.join(tmp, arm + '.json')
                with open(snaps[arm], 'w') as f:
                    json.dump({'k1': {k: rec[k] for k in
                                      ('gulps_per_s', 'Msamples_per_s')},
                               'counters': {'pipeline.sync_waits':
                                            rec['sync_waits']}}, f)
            r = run_tool('telemetry_diff', snaps['hand'],
                         snaps['detuned'], '--strict')
            log('telemetry_diff --strict hand -> detuned: rc %d\n%s'
                % (r.returncode, r.stdout.strip()))
            require(r.returncode == 3, 'monitors: telemetry_diff --strict '
                    'did not flag the detuned K1 arm (rc %d)'
                    % r.returncode)
            r2 = run_tool('telemetry_diff', snaps['hand'], snaps['hand'],
                          '--strict')
            require(r2.returncode == 0, 'monitors: telemetry_diff flagged '
                    'identical snapshots')
            out.update({'k1_counter_rollup': launches,
                        'launches_k1_local': launches, 'diff_arms': {
                            a: {k: v for k, v in rec.items()
                                if k != 'digests'}
                            for a, rec in arms.items()},
                        'telemetry_diff_rc': r.returncode})
            steps['console_and_diff'] = time.perf_counter() - t_arms
            t = time.perf_counter()
            wait_for(lambda: rx.poll() is not None or
                     os.path.exists(ready),
                     'monitors: the receiver never listened', timeout=120)
            require(rx.poll() is None, 'monitors: the receiver exited '
                    'before it listened: %s' % tail_file(rx_log))
            with environ(BF_PROCLOG_DIR=pl,
                         BF_TRACE_FILE=os.path.join(tmp, 'tx.json')):
                tx = bridge_child({
                    'stream': 'k1', 'port': port, 'window': 4,
                    'nstreams': 1, 'crc': False, 'cut': 0,
                    'ngulp': MONGULPS, 'span_nframe': MONSPAN,
                    'pace_s': MONPACE,
                    'gulp_nbyte': NTIME * NPOL * NFINE * 2})
            # while the stream runs: like_bmon sees the bridge's two ends
            # move, like_pmap maps the receiver's rings, each polled on a
            # thread of its own until it has or the sender ends
            import threading
            seen = {'bmon': None, 'pmap': None, 'rx': None, 'tx': None,
                    'last': None}

            def poll_bmon():
                while tx.poll() is None and seen['bmon'] is None:
                    r = run_tool('like_bmon', '--once', env=env)
                    seen['last'] = (r.returncode, r.stdout, r.stderr)
                    rates = bmon_rates(r.stdout)
                    if r.returncode == 0 and '[bridge]' in r.stdout:
                        for end, pid, i in (('rx', rx.pid, 0),
                                            ('tx', tx.pid, 1)):
                            rate = rates.get(str(pid), (0, 0))[i]
                            if rate > 0 and seen[end] is None:
                                seen[end] = rate
                                log('like_bmon --once, the %s end moving:'
                                    '\n%s' % (end, r.stdout))
                        if seen['rx'] and seen['tx']:
                            seen['bmon'] = rates

            def poll_pmap():
                while tx.poll() is None and seen['pmap'] is None:
                    r = run_tool('like_pmap', rx.pid, env=env)
                    if r.returncode == 0 and 'Ring Mappings:' in r.stdout \
                            and 'Rings: 0' not in r.stdout:
                        seen['pmap'] = r.stdout
            pollers = [threading.Thread(target=f, daemon=True)
                       for f in (poll_bmon, poll_pmap)]
            for th in pollers:
                th.start()
            for th in pollers:
                th.join(MONTIMEOUT)
            sent = bridge_child_result('monitors', tx, MONTIMEOUT)
            rx.wait(timeout=MONTIMEOUT)
        except BaseException:
            if rx.poll() is None:
                rx.kill()
                rx.wait()
            log('monitors: the receiver\'s output:\n%s' % tail_file(rx_log))
            raise
        rx_log.seek(0)
        rx_out = rx_log.read()
        rx_log.close()
        require(rx.returncode == 0, 'monitors: the receiver exited %s: %s'
                % (rx.returncode, rx_out[-3000:]))
        lines = [ln for ln in rx_out.splitlines()
                 if ln.startswith('MONITOR_RX ')]
        require(len(lines) == 1, 'monitors: the receiver printed no result')
        got = json.loads(lines[0][len('MONITOR_RX '):])
        out['stream_s'] = time.perf_counter() - t
        require(seen['bmon'] is not None,
                'monitors: like_bmon never showed both bridge ends moving '
                '(%s); its last run: %s' % (
                    {k: seen[k] for k in ('rx', 'tx')}, seen['last']))
        require(seen['pmap'] is not None,
                'monitors: like_pmap never mapped the receiver\'s rings')
        log('like_pmap %d (head):\n%s' % (
            rx.pid, '\n'.join(seen['pmap'].splitlines()[:12])))
        require(got['frames'] == MONGULPS * NTIME and
                got['launches'] == got['gulps'] + got['prewarm_runs'],
                'monitors: the receiver ran %d gulps (%d frames), %d K1 '
                'launches' % (got['gulps'], got['frames'], got['launches']))
        out.update({'bridged_gulps': got['gulps'],
                    'launches_k1_rx': got['launches'],
                    'bmon_rates': {'rx': seen['rx'], 'tx': seen['tx']},
                    'bridge_tx_bytes': sent['counters'].get(
                        'bridge.tx.bytes')})
        # trace_merge joins the two hosts' traces
        merged_path = os.path.join(tmp, 'merged.json')
        r = run_tool('trace_merge', '-o', merged_path,
                     os.path.join(tmp, 'tx.json'),
                     os.path.join(tmp, 'rx.json'))
        require(r.returncode == 0 and 'WARNING' not in r.stderr,
                'monitors: trace_merge rc %d: %s' % (r.returncode,
                                                     r.stderr[-2000:]))
        with open(merged_path) as f:
            merged = json.load(f)
        ids = trace_identities(merged)
        require(len(ids) == 2, 'monitors: merged trace has %d hosts'
                % len(ids))
        (pa, ia), (pb, ib) = sorted(ids.items())
        shared = set(ia) & set(ib)
        k1_shared = [k for k in shared
                     if any(got['fused'] in n for n in ia[k] + ib[k])]
        require(len(k1_shared) >= MONGULPS // 2,
                'monitors: %d shared (trace, seq, gulp) identities, %d '
                'with a K1 compute span' % (len(shared), len(k1_shared)))
        steps['stream'] = time.perf_counter() - t
        out['trace_merge'] = {
            'shared_identities': len(shared),
            'with_k1_compute_span': len(k1_shared),
            'shift_us': {os.path.basename(k): v['shift_us'] for k, v in
                         merged['otherData']['bf_merged_from'].items()}}
        log('trace_merge: %s' % json.dumps(out['trace_merge']))
        t = time.perf_counter()
        # bf_lint --strict over every port example, all at once
        here_dir = os.path.dirname(here)
        procs = {ex: subprocess.Popen(
            [sys.executable, '-m', 'bifrost_tpu_torch.tools.bf_lint',
             '--strict', os.path.join('examples', ex)] +
            LINT_ARGS.get(ex, []) + ([os.path.join(tmp, 'demo')]
                                     if ex in LINT_ARGS else []),
            cwd=here_dir, stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
            for ex in port_examples(here_dir)}
        lint = {}
        for ex, proc in procs.items():
            o, e = proc.communicate(timeout=300)
            lint[ex] = proc.returncode
            log('bf_lint --strict examples/%s: rc %d; %s'
                % (ex, proc.returncode, (o.strip().splitlines() or
                                          [e.strip()[-300:]])[-1]))
            require(proc.returncode == 0 and 'BF-E' not in o,
                    'monitors: bf_lint --strict failed on %s: %s%s'
                    % (ex, o[-1500:], e[-1500:]))
        out['bf_lint'] = lint
        steps['bf_lint'] = time.perf_counter() - t
        out['steps_s'] = steps
        out['mprobe'] = mprobe_winners(mprobe, mprobe_report)
    return out


def mprobe_winners(mprobe, mprobe_report):
    """``mprobe_report`` over the races the earlier phases ran: in this
    process, every winner of the in-process cache; through ``--json``
    children, one over each race arm's cache directory, every winner
    those arms persisted, each equal to this process's winner.  The
    beamformer's race (its pipeline arm and K4-K6) must be among them.
    Returns {family: (keys in process, keys persisted)}."""
    races = {fam: dict(e) for fam, e in mprobe._cache.items() if e}
    require('beamform' in races, 'monitors: no beamform race in this '
            'process (families %s)' % sorted(races))
    rep = mprobe_report.report()
    log('mprobe_report (in process):\n' +
        '\n'.join(mprobe_report.render(rep)))
    for fam, entries in races.items():
        for key, (winner, _ms, _e) in entries.items():
            require(rep.get(fam, {}).get(key, {}).get('winner') == winner,
                    'monitors: mprobe_report lost %s %s' % (fam, key))
    disk = {}
    for d in RACE_CACHES:
        r = run_tool('mprobe_report', '--json', env={'BF_CACHE_DIR': d})
        require(r.returncode == 0, 'monitors: mprobe_report --json rc %d '
                'over %s: %s' % (r.returncode, d, r.stderr[-500:]))
        for fam, entries in json.loads(r.stdout).items():
            disk.setdefault(fam, {}).update(entries)
    for fam, entries in disk.items():
        for key, e in entries.items():
            want = races.get(fam, {}).get(key, (None,))[0]
            require(e.get('winner') == want, 'monitors: mprobe_report '
                    '--json lists %s %s -> %s, this process raced %s'
                    % (fam, key, e.get('winner'), want))
    require(disk.get('beamform'), 'monitors: mprobe_report --json lists '
            'no beamform winner over the race arms\' caches %s'
            % RACE_CACHES)
    counts = {fam: (len(races.get(fam, {})), len(disk.get(fam, {})))
              for fam in sorted(set(races) | set(disk))}
    for fam, (n_in, n_disk) in counts.items():
        log('mprobe_report %s: %d key(s) in process, %d persisted and '
            'listed by --json' % (fam, n_in, n_disk))
    return counts


# -- the mesh_plans phase ---------------------------------------------------

#: ranks on cuda:0 and gulps of each arm of the mesh_plans phase; the
#: macro arm's K; the sharded FFT's length and batch
MPD, MPGULPS, MPK = 4, 8, 4
MPFFT, MPFFTB = 1 << 20, 4


def mesh_k1_arm(bt, spec, gulps, arm, scope, split=False, source=None):
    """One arm of the mesh_plans phase: the device K1 chain over MPGULPS
    gulps under ``scope``; returns its record and the fused block."""
    from bifrost_tpu_torch import parallel
    from bifrost_tpu_torch.telemetry import counters
    settle_memory()
    counters.reset()
    p, fb, sink = device_k1_chain(bt, gulps, 1, MPGULPS, 1, name=arm,
                                  scope=scope, split=split, source=source)
    l0 = spec.launches
    since = parallel.collective_counts()
    t = time.perf_counter()
    run_with_timeout(p)
    secs = time.perf_counter() - t
    require(sink.n == MPGULPS, 'mesh_plans %s: the sink saw %d of %d '
            'gulps' % (arm, sink.n, MPGULPS))
    blk = [b for b in p.blocks if getattr(b, 'prewarm_runs', None)
           is not None]
    snap = counters.snapshot()
    rec = {'arm': arm, 'seconds': secs,
           'Msamples_per_s': (MPGULPS - 1) * NTIME * NPOL * NFINE /
           (sink.t1 - sink.t0) / 1e6,
           'launches': spec.launches - l0,
           'dispatches': sum(block_gulps(snap, b)[0] for b in blk),
           'prewarm_runs': prewarm_runs(blk),
           'collectives': parallel.collective_counts(since),
           'impl': [dict(b.impl_info or {}) for b in blk],
           'digests': [int(d) for d in sink.digests], 'first': sink.first,
           'counters': {k: v for k, v in snap.items() if
                        k.startswith(('mesh.', 'segment.', 'xfer.h2d'))}}
    return rec


def pinned_source(hosts):
    """A factory of a 'cuda_host' source publishing MPGULPS flagship
    gulps, gulp i being ``hosts[i % len(hosts)]``."""
    def make(bt):
        class Pinned(bt.SourceBlock):
            def __init__(self):
                super(Pinned, self).__init__(['pinned'], NTIME,
                                             space='cuda_host')
                self.count = 0

            def create_reader(self, name):
                return contextlib.nullcontext()

            def on_sequence(self, reader, name):
                return [spec_header(NFINE)]

            def on_data(self, reader, ospans):
                if self.count == MPGULPS:
                    return [0]
                dst = ospans[0].data.as_numpy().view(np.int8)
                dst[...] = hosts[self.count % len(hosts)].reshape(dst.shape)
                self.count += 1
                return [NTIME]
        return Pinned()
    return make


def mesh_beam_arm(bt, gulps, w, arm, mesh):
    """The beamformer block (K4 forced) or the fused beamform-detect chain
    (K6) over the beamformer cells' gulps, under ``mesh``; returns (the
    outputs, the beam block, its launches)."""
    from bifrost_tpu_torch.ops import gpu_kernels
    from bifrost_tpu_torch.stages import (BeamformStage, DetectStage,
                                          ReduceStage)
    header = {'name': 'beams', 'time_tag': 0,
              '_tensor': {'shape': [-1, BF, BS, BP], 'dtype': 'ci8',
                          'labels': ['time', 'freq', 'station', 'pol'],
                          'scales': [[0, 1]] * 4, 'units': [None] * 4}}
    blocks = []

    def chain(h2d):
        with bt.block_scope(mesh=mesh):
            if arm == 'K6':
                blocks.append(('beam', bt.blocks.fused(h2d, [
                    BeamformStage(w, accuracy='int8'),
                    DetectStage('stokes', axis='pol'),
                    ReduceStage('time', BR)])))
            else:
                blocks.append(('beam', bt.blocks.beamform(
                    h2d, w, accuracy='int8', impl='pallas')))
        return blocks
    n0 = dict(gpu_kernels.launches)
    with environ(BF_BEAM_FUSED='force'):
        outs, _secs, _pg = drive(bt, gulps, header, chain, nwarm=1,
                                 ntimed=2)
    launches = {k: gpu_kernels.launches[k] - n0.get(k, 0) for k in
                ('beamform_int8', 'beamform_detect_int8')}
    return outs, blocks[0][1], launches


def phase_mesh_plans(bt, spec, gpu_kernels, beam, par, smi):
    """The mesh_plans phase (item 15j of the module docstring)."""
    import torch
    from bifrost_tpu_torch.device import get_device
    dev = get_device()
    mesh = par.create_mesh({'sp': MPD}, devices=[str(dev)] * MPD)
    gulps, hosts = device_gulps(3, seed=17)
    out = {'card': smi, 'ranks_on_one_card': MPD}
    runs = {}
    arms = (('single', {}, False, None),
            ('mesh', {'mesh': mesh}, False, None),
            ('mesh-macro', {'mesh': mesh, 'gulp_batch': MPK}, False, None),
            ('mesh-pinned', {'mesh': mesh}, False, pinned_source(hosts)),
            ('mesh-segment', {'mesh': mesh, 'segments': 'force'}, True,
             None))
    for arm, scope, split, source in arms:
        rec = runs[arm] = mesh_k1_arm(bt, spec, gulps, arm, scope, split,
                                      source)
        log('mesh_plans %s: %.1f Msamples/s, %.2f s, K1 launches %d '
            '(%d dispatches, %d prewarm runs), collectives %s, impl %s, '
            '%s (%s)' % (arm, rec['Msamples_per_s'], rec['seconds'],
                         rec['launches'], rec['dispatches'],
                         rec['prewarm_runs'], rec['collectives'],
                         rec['impl'], rec['counters'], smi))
        if arm == 'mesh-segment':
            # the segment runs its members' own functions (no K1 across
            # a former block boundary): held to K1's output at the gate
            r = rel_err(rec['first'], runs['single']['first'])
            require(r < GATE, 'mesh_plans %s: rel %.3g of the single-rank '
                    'K1 run' % (arm, r))
        else:
            require(rec['digests'] == runs['single']['digests'],
                    'mesh_plans %s: outputs differ from the single-rank '
                    'run' % arm)
        if arm == 'single':
            continue
        require(rec['collectives'] == {},
                'mesh_plans %s: collectives %s' % (arm, rec['collectives']))
        require(any(i.get('mesh') == 'shard_map[%d]' % MPD and
                    i.get('impl') == ('segment' if arm == 'mesh-segment'
                                      else 'cuda-spectrometer')
                    for i in rec['impl']),
                'mesh_plans %s: no frame-local plan: %s'
                % (arm, rec['impl']))
        require(rec['launches'] == (0 if arm == 'mesh-segment' else MPD) *
                (rec['dispatches'] + rec['prewarm_runs']),
                'mesh_plans %s: %d K1 launches, %d ranks x (%d dispatches '
                '+ %d prewarm runs)' % (arm, rec['launches'], MPD,
                                        rec['dispatches'],
                                        rec['prewarm_runs']))
    c = runs['mesh-pinned']['counters']
    require(c.get('xfer.h2d_sharded') == MPGULPS and
            (dev.type != 'cuda' or
             c.get('xfer.h2d_direct') == MPGULPS * MPD),
            'mesh_plans: the pinned arm did not copy each rank\'s frames '
            'straight from its span: %s' % c)
    require(runs['mesh-segment']['counters'].get('segment.elided_rings')
            == 1, 'mesh_plans: the mesh segment elided no ring: %s'
            % runs['mesh-segment']['counters'])
    require(runs['mesh-macro']['dispatches'] == MPGULPS // MPK,
            'mesh_plans: the macro arm made %d dispatches'
            % runs['mesh-macro']['dispatches'])
    out['arms'] = {a: {k: v for k, v in r.items()
                       if k not in ('digests', 'first')}
                   for a, r in runs.items()}
    del gulps
    # the beamformer under the mesh: K4 per shard, exact against the
    # single-rank run and the int64 oracle; K6 through the fused chain
    bg = beam_gulps(n=3)
    w = beam_weights()
    beams = {}
    for arm in ('K4', 'K6'):
        for m in (None, mesh):
            key = '%s-%s' % (arm, 'mesh' if m else 'single')
            settle_memory()
            beams[key] = mesh_beam_arm(bt, bg, w, arm, m)
            log('mesh_plans beamformer %s: launches %s, info %s' % (
                key, beams[key][2], getattr(beams[key][1], 'impl_info',
                                            None)))
        for k in beams[arm + '-single'][0]:
            a, b = beams[arm + '-single'][0][k], beams[arm + '-mesh'][0][k]
            require(a.shape == b.shape and a.tobytes() == b.tobytes(),
                    'mesh_plans %s gulp %d: mesh and single-rank outputs '
                    'differ' % (arm, k))
    blk = beams['K4-mesh'][1]
    shard_t = BT // MPD
    require(any(' v=(%d,' % shard_t in k for k in blk.engine.chosen),
            'mesh_plans: the beamformer engine was not prewarmed at the '
            'shard\'s %d frames: %s' % (shard_t, sorted(blk.engine.chosen)))
    eng = blk.engine
    x = bg[0]
    got = beams['K4-mesh'][0][0]
    s32 = np.float32(eng.wscale)
    for p in range(BP):
        for f in (0, BF // 2, BF - 1):
            wr, wi = int64_beams(eng.wr8[p] if eng.wr8.ndim == 3
                                 else eng.wr8, eng.wi8[p]
                                 if eng.wi8.ndim == 3 else eng.wi8,
                                 x[:, f:f + 1, :, p, 0],
                                 x[:, f:f + 1, :, p, 1])
            want = (wr.astype(np.float32) * s32) + \
                1j * (wi.astype(np.float32) * s32)
            require(np.array_equal(got[:, f:f + 1, p, :], want.astype(
                np.complex64)), 'mesh_plans: K4 under the mesh differs '
                'from the int64 oracle on pol %d channel %d' % (p, f))
    n4 = beams['K4-mesh'][2]['beamform_int8']
    n6 = beams['K6-mesh'][2]['beamform_detect_int8']
    require(n4 > 0 and n6 > 0, 'mesh_plans: K4 %d / K6 %d launches under '
            'the mesh' % (n4, n6))
    out['beamformer'] = {'launches': {k: v[2] for k, v in beams.items()},
                         'shard_frames': shard_t}
    del beams, bg
    # the distributed FFT and the frequency-sharded channelizer against
    # torch.fft at 2^20 channels
    settle_memory()
    g = torch.Generator(device=dev).manual_seed(23)
    xr = torch.randn(MPFFTB, MPFFT, device=dev, generator=g)
    xi = torch.randn(MPFFTB, MPFFT, device=dev, generator=g)
    xc = torch.complex(xr, xi)
    ref = torch.fft.fft(xc.to(torch.complex128))
    fft_rec = {}
    for name, fn in (('sharded_fft', par.sharded_fft(mesh, MPFFT,
                                                     nbatch=1)),
                     ('freq_sharded_dft', par.freq_sharded_dft(
                         mesh, MPFFT, nbatch=1))):
        since = par.collective_counts()
        y = fn(xc)
        calls = par.collective_counts(since)
        rel = float((y.to(torch.complex128) - ref).abs().max() /
                    ref.abs().max())
        ms = cuda_ms(lambda: fn(xc), runs=5)
        fft_rec[name] = {'rel': rel, 'ms': ms, 'collectives': calls}
        require(rel < 1e-4, 'mesh_plans: %s rel %.3g of torch.fft'
                % (name, rel))
    fft_rec['torch_fft_ms'] = cuda_ms(lambda: torch.fft.fft(xc), runs=5)
    log('mesh_plans FFT at %d points x %d, %d ranks: %s (%s)'
        % (MPFFT, MPFFTB, MPD, json.dumps(fft_rec), smi))
    require(fft_rec['freq_sharded_dft']['collectives'] == {} and
            fft_rec['sharded_fft']['collectives'] == {'all_to_all': 3},
            'mesh_plans: FFT collectives %s' % fft_rec)
    out['fft'] = fft_rec
    out['launches_k1'] = {a: r['launches'] for a, r in runs.items()}
    return out


# ---------------------------------------------------------------------------
# the runtime surface: auto-fusion, fused scopes, placement, ring readers
# ---------------------------------------------------------------------------

#: gulps an arm of the surface phase (the first is warm-up)
SURFACE_GULPS = 8
#: the surface phase's arms
SURFACE_ARMS = ('auto-fused', 'unfused', 'explicit', 'fused-scope',
                'tapped')


def surface_chain(bt, arm, tap_blocks):
    """The device blocks of one surface arm, for ``drive``: the reference
    style fft -> detect('stokes') -> reduce('freq', 4) as three stage
    blocks (``explicit``: one ``blocks.fused`` block; ``fused-scope``:
    the three under ``block_scope(fuse=True, gpu=0)``; ``tapped``: a
    second reader on the fft ring, appended to ``tap_blocks``)."""
    import torch
    from bifrost_tpu_torch.stages import FftStage, DetectStage, ReduceStage

    class DeviceTap(bt.SinkBlock):
        """A second reader of the FFT ring that only counts its spans."""

        def __init__(self, iring):
            super(DeviceTap, self).__init__(iring)
            self.n = 0

        def define_valid_input_spaces(self):
            return ('cuda',)

        def on_sequence(self, iseq):
            pass

        def on_data(self, ispan):
            require(isinstance(ispan.data, torch.Tensor),
                    'tapped: the tap read no device span')
            self.n += 1

    def stage_blocks(h2d):
        f = bt.blocks.fft(h2d, axes='fine_time', axis_labels='freq')
        d = bt.blocks.detect(f, mode='stokes')
        r = bt.blocks.reduce(d, 'freq', RFACTOR)
        return [('fft', f), ('detect', d), ('reduce', r)]

    def chain(h2d):
        if arm == 'explicit':
            return [('fused', bt.blocks.fused(h2d, [
                FftStage('fine_time', axis_labels='freq'),
                DetectStage('stokes', axis='pol'),
                ReduceStage('freq', RFACTOR)]))]
        if arm == 'fused-scope':
            with bt.block_scope(fuse=True, gpu=0):
                return stage_blocks(h2d)
        blocks = stage_blocks(h2d)
        if arm == 'tapped':
            tap_blocks.append(DeviceTap(blocks[0][1]))
        return blocks
    return chain


def surface_arm(bt, spec, gpu_kernels, arm, volts, smi):
    """One arm of the surface phase over SURFACE_GULPS full-width gulps;
    returns its record (rate, K1 and K2 launches, blocks, interior ring sizes,
    output CRCs and gulp 0's output)."""
    settle_memory()
    zero_counts(spec, gpu_kernels)
    taps, built = [], {}
    chain = surface_chain(bt, arm, taps)

    def keep(h2d):
        built['h2d'] = h2d
        built['blocks'] = chain(h2d)
        return built['blocks']
    t = time.perf_counter()
    out, secs, per_gulp = drive(
        bt, volts, spec_header(NFINE), keep, nwarm=1,
        ntimed=SURFACE_GULPS - 1,
        scope={'auto_fuse': arm in ('auto-fused', 'tapped')}, digest=True,
        keep_first=True)
    wall = time.perf_counter() - t
    counts = read_counts(spec, gpu_kernels)
    p = built['h2d'].pipeline
    chain_blocks = [b for b in p.blocks if b.type in (
        'FftBlock', 'DetectBlock', 'ReduceBlock', 'FusedBlock')]
    rec = {'arm': arm, 'seconds': wall,
           'Msamples_per_s':
           (SURFACE_GULPS - 1) * NTIME * NPOL * NFINE / secs / 1e6,
           'k1_launches': counts['fused_spectrometer'],
           'k2_launches': counts['stokes_detect'],
           'prewarm_runs': prewarm_runs(chain_blocks),
           'nblocks': len(p.blocks),
           'blocks': [b.name.split('/')[-1] for b in p.blocks],
           'ring_bytes': {b.name.split('/')[-1]: b.orings[0].total_span
                          for b in chain_blocks},
           'impl': [dict(b.impl_info or {}) for b in chain_blocks
                    if hasattr(b, 'impl_info')],
           'crc': [out[k] for k in range(SURFACE_GULPS)],
           'first': out['first'],
           'tap_spans': [tp.n for tp in taps]}
    log('surface %s: %.1f Msamples/s, K1 %d, K2 %d launches, %d blocks '
        '%s, ring bytes %s (%s)'
        % (arm, rec['Msamples_per_s'], rec['k1_launches'],
           rec['k2_launches'], rec['nblocks'], rec['blocks'],
           rec['ring_bytes'], smi))
    log_per_gulp(per_gulp)
    return rec


def surface_ring_readers(bt, space):
    """Write 3 sequences into a ``space`` ring, then check that
    ``open_sequence``, ``open_sequence_at``, ``open_latest_sequence`` and
    ``read(whence='latest')`` each open the right one, its data included;
    returns the names they opened."""
    import torch
    from bifrost_tpu_torch.device import get_device
    seqs = (('alpha', 10), ('beta', 20), ('gamma', 30))
    ring = bt.Ring(space=space)
    with ring.begin_writing() as w:
        for k, (name, ttag) in enumerate(seqs):
            hdr = {'name': name, 'time_tag': ttag,
                   '_tensor': {'shape': [-1, 1024], 'dtype': 'f32',
                               'labels': ['time', 'x'],
                               'scales': [[0, 1]] * 2, 'units': [None] * 2}}
            with w.begin_sequence(hdr, 4, 16) as ws:
                with ws.reserve(4) as span:
                    if space == 'cuda':
                        span.set(torch.full((4, 1024), k + 1.0,
                                            device=get_device()))
                    else:
                        span.data.as_numpy()[...] = k + 1.0
                    span.commit(4)
    require(ring.writing_ended, '%s ring: writing_ended is False' % space)

    def value(rseq):
        with rseq:
            vals = set()
            for sp in rseq.read(4):
                x = sp.data
                x = x.cpu().numpy() if isinstance(x, torch.Tensor) \
                    else x.as_numpy()
                vals.update(np.unique(x).tolist())
            return rseq.name, rseq.time_tag, sorted(vals)
    got = {'open_sequence': value(ring.open_sequence('beta')),
           'open_sequence_at': value(ring.open_sequence_at(30)),
           'open_latest_sequence': value(ring.open_latest_sequence()),
           'read_latest': [sq.name for sq in ring.read(whence='latest')]}
    want = {'open_sequence': ('beta', 20, [2.0]),
            'open_sequence_at': ('gamma', 30, [3.0]),
            'open_latest_sequence': ('gamma', 30, [3.0]),
            'read_latest': ['gamma']}
    require(got == want, '%s ring readers: %s, want %s'
            % (space, got, want))
    log('ring readers on %s (%s core): %s' % (space, type(ring).__name__,
                                              got))
    return {'core': type(ring).__name__, 'opened': got}


def surface_bad_device(bt):
    """``block_scope(device=torch.cuda.device_count())`` must fail the
    run before its init barrier; returns the error's first line."""
    import torch
    n = torch.cuda.device_count()

    class Source(bt.SourceBlock):
        def __init__(self):
            super(Source, self).__init__(['one'], 4, space='system')

        def create_reader(self, name):
            return contextlib.nullcontext()

        def on_sequence(self, reader, name):
            return [{'name': 'one', 'time_tag': 0, '_tensor': {
                'shape': [-1, 8], 'dtype': 'f32', 'labels': ['time', 'x'],
                'scales': [[0, 1]] * 2, 'units': [None] * 2}}]

        def on_data(self, reader, ospans):
            return [0]

    class Sink(bt.SinkBlock):
        def on_sequence(self, iseq):
            pass

        def on_data(self, ispan):
            pass

    with bt.Pipeline() as p:
        src = Source()
        with bt.block_scope(device=n):
            Sink(bt.blocks.copy(src, space='cuda'))
    err = None
    try:
        with contextlib.redirect_stderr(io.StringIO()):
            run_with_timeout(p, secs=60)
    except bt.PipelineInitError as exc:
        err = str(exc)
    require(err is not None and 'device index %d' % n in err,
            'block_scope(device=%d) did not raise: %r' % (n, err))
    first = err.splitlines()[0]
    log('block_scope(device=%d) on %d card(s) raised: %s'
        % (n, n, [ln for ln in err.splitlines() if 'device index' in ln]))
    return first


def phase_surface(bt, spec, gpu_kernels, smi):
    """The runtime surface on the card at the flagship's full width: the
    reference-style chain through ``Pipeline(auto_fuse=True)`` (one
    AutoFused_x3 block running K1), unfused (cuFFT and K2), as one
    explicit ``blocks.fused`` block (K1), under ``block_scope(fuse=True,
    gpu=0)`` (cuFFT and K2 with one gulp of buffering inside) and with a
    second reader on the fft ring (which must not fuse); then placement
    past the last card, and the ring's readers on a 'cuda' ring and a
    native 'system' ring."""
    volts = make_gulps(seed=31, n=2)
    runs = {arm: surface_arm(bt, spec, gpu_kernels, arm, volts, smi)
            for arm in SURFACE_ARMS}
    rows = [0, 1, NTIME // 2, NTIME - 1]
    want = spec.spectrometer_oracle(volts[0][rows], RFACTOR)
    for arm, rec in runs.items():
        first = rec.pop('first')
        require(first.shape == (NTIME, 4, NFINE // RFACTOR) and
                np.isfinite(first).all(),
                'surface %s: bad output shape or non-finite values' % arm)
        rec['rel_err_oracle'] = rel_err(first[rows], want)
        require(rec['rel_err_oracle'] < GATE,
                'surface %s: gulp 0 against the oracle: %.3g'
                % (arm, rec['rel_err_oracle']))
    fused, explicit, unfused = (runs['auto-fused'], runs['explicit'],
                                runs['unfused'])
    for rec in (fused, explicit):
        require(rec['k1_launches'] == SURFACE_GULPS + 1 and
                rec['k2_launches'] == 0,
                'surface %s: K1 %d (want %d gulps + 1 prewarm run), K2 %d '
                '(want 0)' % (rec['arm'], rec['k1_launches'], SURFACE_GULPS,
                              rec['k2_launches']))
    require(unfused['k2_launches'] == SURFACE_GULPS and
            unfused['k1_launches'] == 0,
            'surface unfused: K2 %d (want %d), K1 %d (want 0)'
            % (unfused['k2_launches'], SURFACE_GULPS,
               unfused['k1_launches']))
    require(fused['crc'] == explicit['crc'],
            'surface: auto-fused output differs from the explicit fused '
            'block\'s: %s vs %s' % (fused['crc'], explicit['crc']))
    auto = [n for n in fused['blocks'] if n.startswith('AutoFused_x3_')]
    require(len(auto) == 1 and
            fused['nblocks'] == unfused['nblocks'] - 2,
            'surface auto-fused: blocks %s against unfused %s'
            % (fused['blocks'], unfused['blocks']))
    require(fused['impl'][0].get('impl') == 'cuda-spectrometer' and
            fused['impl'][0].get('kernel') == 'cuda',
            'surface auto-fused: planned %s' % fused['impl'])
    scope, tapped = runs['fused-scope'], runs['tapped']
    require(scope['k2_launches'] == SURFACE_GULPS and
            scope['k1_launches'] == 0,
            'surface fused-scope: K2 %d, K1 %d' % (scope['k2_launches'],
                                                   scope['k1_launches']))
    for name in ('FftBlock', 'DetectBlock'):
        inside = [v for k, v in scope['ring_bytes'].items()
                  if k.startswith(name)]
        outside = [v for k, v in unfused['ring_bytes'].items()
                   if k.startswith(name)]
        require(inside and outside and inside[0] < outside[0],
                'surface fused-scope: %s ring %s bytes, unfused %s'
                % (name, inside, outside))
    require(not any(n.startswith('AutoFused_x3_') for n in tapped['blocks'])
            and any(n.startswith('FftBlock') for n in tapped['blocks'])
            and tapped['k1_launches'] == 0
            and tapped['tap_spans'] == [SURFACE_GULPS],
            'surface tapped: blocks %s, K1 %d, tap spans %s'
            % (tapped['blocks'], tapped['k1_launches'],
               tapped['tap_spans']))
    ref = explicit['crc']
    for rec in runs.values():
        rec['crc_equals_explicit'] = rec.pop('crc') == ref
    out = {'gulp': [NTIME, NPOL, NFINE], 'rfactor': RFACTOR,
           'gulps_per_arm': SURFACE_GULPS, 'arms': runs,
           'bad_device': surface_bad_device(bt),
           'ring_readers': {space: surface_ring_readers(bt, space)
                            for space in ('cuda', 'system')},
           'card': smi}
    out['launches_k1'] = {a: r['k1_launches'] for a, r in runs.items()}
    out['launches_k2'] = {a: r['k2_launches'] for a, r in runs.items()}
    return out


def spec_header(nfine):
    """The spectrometer chain's input header (ci8, time x pol x
    fine_time)."""
    return {'name': 'guppi', 'time_tag': 0,
            '_tensor': {'shape': [-1, NPOL, nfine], 'dtype': 'ci8',
                        'labels': ['time', 'pol', 'fine_time'],
                        'scales': [[0, 1]] * 3, 'units': [None] * 3}}


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    if sys.argv[1:2] == ['--capture-sender']:
        return capture_sender(*sys.argv[2:5])
    if sys.argv[1:2] == ['--capture-blaster']:
        return capture_blaster(*sys.argv[2:4])
    if sys.argv[1:2] == ['--bridge-sender']:
        return bridge_sender(sys.argv[2])
    if sys.argv[1:2] == ['--fabric-stations']:
        return fabric_stations(sys.argv[2])
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write('chip_smoke: no CUDA device is available\n')
        return 1
    if sys.argv[1:2] == ['--guppi-child']:
        return guppi_child(*sys.argv[2:4])
    if sys.argv[1:2] == ['--fleet-child']:
        return fleet_child(sys.argv[2])
    if sys.argv[1:2] == ['--monitor-rx']:
        return monitor_rx(sys.argv[2])
    import bifrost_tpu_torch as bt
    from bifrost_tpu_torch import _build
    from bifrost_tpu_torch.ops import gpu_kernels
    from bifrost_tpu_torch.ops import spectrometer as spec
    from bifrost_tpu_torch.ops import beamform as beam
    from bifrost_tpu_torch.ops import linalg as L
    from bifrost_tpu_torch.ops import fdmt as F
    from bifrost_tpu_torch import parallel as par

    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    log('card: %s | torch.cuda.get_device_name: %s | torch %s, CUDA %s'
        % (smi, name, torch.__version__, torch.version.cuda))
    bt.device.set_device('cuda:0')

    t0 = time.perf_counter()
    built = _build.build()
    log('built %s in %.1f s' % (sorted(built) or 'nothing (cached)',
                                time.perf_counter() - t0))
    for lib, text in sorted(_build.build_logs.items()):
        for line in text.splitlines():
            if 'registers' in line or 'smem' in line:
                log('  %s: %s' % (lib, line.strip()))

    phase_s = {}
    record_verifier()

    def run(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.empty_cache()
        phase_s[name] = time.perf_counter() - t
        log('phase %s: %.1f s' % (name, phase_s[name]))
        return out

    k9 = run('K9', phase_ring_permute, gpu_kernels, par)
    k2 = run('K2', phase_stokes, gpu_kernels)
    k1 = run('K1', phase_spectrometer, spec)
    pipe = run('spectrometer pipeline', phase_pipeline, bt, spec,
               gpu_kernels, smi)
    guppi = run('guppi', phase_guppi, bt, spec, gpu_kernels)
    dk2 = run('detect-K2', phase_detect_block, bt, spec, gpu_kernels, smi)
    dsp = {'map': run('map', phase_map, bt, smi)}
    k4, k5, k6 = run('K4-K6', phase_beamform_kernels, gpu_kernels, beam)
    bpipe = run('beamformer pipeline', phase_beamform_pipeline, bt, spec,
                gpu_kernels, beam, smi)
    dsp['fir'] = run('fir', phase_fir, bt, smi)
    k0 = run('K0', phase_probe, gpu_kernels)
    k7, k8 = run('K7, K8', phase_xcorr_kernels, gpu_kernels)
    fx = run('FX pipeline', phase_fx_pipeline, bt, spec, gpu_kernels, smi)
    xf = run('xfer', phase_xfer, bt, fx, smi)
    la = run('linalg', phase_linalg, bt, L)
    sup = run('supervision', phase_supervision, bt, spec, gpu_kernels)
    sup['tier_overhead'] = run('tier overhead', phase_tier_overhead, bt,
                               smi)
    mac = run('macro', phase_macro, bt, spec, gpu_kernels, beam, fx, smi)
    dsp['fx_storage'] = run('fx-storage', phase_fx_storage, bt, spec,
                            gpu_kernels, fx, smi)
    dsp['romein'] = run('romein', phase_romein, bt, smi)
    n8 = run('xcorr_int8 cross', phase_xcorr_int8, L, gpu_kernels)
    k3 = run('K3', phase_fdmt_kernel, gpu_kernels, F)
    fdmt = run('FDMT pipeline', phase_fdmt_pipeline, bt, spec, gpu_kernels,
               F, smi)
    mesh = run('mesh correlator', phase_mesh_correlator, bt, spec,
               gpu_kernels, par, smi)
    fmesh = run('FDMT mesh', phase_fdmt_mesh, bt, spec, gpu_kernels, F,
                par, smi)
    ana = run('analysis', phase_analysis, bt, spec, gpu_kernels, smi)
    capt = run('capture', phase_capture, bt, gpu_kernels, smi)
    brg = run('bridge', phase_bridge, bt, spec, gpu_kernels, smi)
    tune = run('autotune', phase_autotune, bt, spec, smi)
    flt = run('fleet', phase_fleet, bt, spec, gpu_kernels, smi)
    svc = run('service', phase_service, bt, spec, gpu_kernels, smi)
    fab = run('fabric', phase_fabric, bt, spec, gpu_kernels, smi)
    sch = run('scheduler', phase_scheduler, bt, spec, gpu_kernels, smi)
    mon = run('monitors', phase_monitors, bt, spec, gpu_kernels, smi)
    mpl = run('mesh_plans', phase_mesh_plans, bt, spec, gpu_kernels, beam,
              par, smi)
    srf = run('surface', phase_surface, bt, spec, gpu_kernels, smi)
    k1['launches'] = pipe['launches_k1_run']['fused_spectrometer']
    k1['launches_radix16'] = \
        pipe['launches_k1_run']['fused_spectrometer_radix16']
    k1['launches_bridge'] = brg['launches_k1']
    k1['launches_bridge_of'] = 'the bridge-K1 arm (%d gulps)' % BK1GULPS
    k1['launches_autotune'] = tune['launches_k1']
    k1['launches_autotune_of'] = (
        'each arm of the autotune phase (%d sequences x %d gulps, plan '
        'runs included)' % (TSEQ, TGULPS))
    k1['launches_fleet'] = {FHOST: flt['parent_launches'],
                            FCHILD_HOST: flt['child_launches']}
    k1['launches_fleet_of'] = (
        "the fleet phase: this process's arm (%d gulps) and the child's two "
        '(%d and %d gulps), prewarm runs included; each equal to its '
        "process's K1 counter" % (FGULPS, FCHILD_GULPS, FCHILD2_GULPS))
    k1['launches_service'] = svc['k1_launches']
    k1['launches_service_of'] = (
        'the service phase\'s three tenants together (%d gulps and %d '
        'prewarm runs)' % (svc['k1_launches_gulps'], svc['k1_prewarm_runs']))
    k1['launches_scheduler'] = sch['k1_launches']
    k1['launches_scheduler_of'] = (
        'the scheduler phase\'s tenants, migrated and re-placed ones '
        'included (%d gulps and %d prewarm runs)'
        % (sch['k1_launches_gulps'], sch['k1_prewarm_runs']))
    k1['launches_monitors'] = {
        'bridged receiver child': mon['launches_k1_rx'],
        'telemetry_diff arms': mon['launches_k1_local']}
    k1['launches_monitors_of'] = (
        'the monitors phase: the bridged receiver (%d gulps, prewarm '
        'included) and the hand and detuned arms (%d gulps each)'
        % (MONGULPS, MONDIFF))
    k1['launches_surface'] = srf['launches_k1']
    k2['launches_surface'] = srf['launches_k2']
    for k in (k1, k2):
        k['launches_surface_of'] = (
            'each arm of the surface phase, %d gulps (auto-fused and '
            'explicit: gulps + 1 prewarm run)' % SURFACE_GULPS)
    k1['launches_mesh_plans'] = mpl['launches_k1']
    k1['launches_mesh_plans_of'] = (
        'the mesh_plans phase, %d gulps an arm; under the mesh each of %d '
        'ranks launches K1 a dispatch and a prewarm run' % (MPGULPS, MPD))
    bl = mpl['beamformer']['launches']
    k4['launches_mesh_plans'] = {a: bl[a]['beamform_int8']
                                 for a in ('K4-single', 'K4-mesh')}
    k6['launches_mesh_plans'] = {a: bl[a]['beamform_detect_int8']
                                 for a in ('K6-single', 'K6-mesh')}
    for k in (k4, k6):
        k['launches_mesh_plans_of'] = (
            'the mesh_plans phase\'s beamformer arms, 3 gulps each, '
            'single-rank and under %d ranks' % MPD)
    k2['launches'] = pipe['launches_k2_run']['stokes_detect']
    k2['launches_detect_block'] = dk2['launches']
    k2['launches_detect_block_of'] = \
        'the detect-K2 arm (%d gulps, unfused detect block)' % dk2['gulps']
    k4['launches'] = bpipe['launches']['K4']['beamform_int8']
    k5['launches'] = bpipe['launches']['K5']['beamform_bf16']
    k4['launches_vec16'] = bpipe['launches']['K4']['beamform_int8_vec16']
    k5['launches_vec16'] = bpipe['launches']['K5']['beamform_bf16_vec16']
    k6['launches'] = bpipe['launches']['K6']['beamform_detect_int8']
    k6['launches_mma'] = bpipe['launches']['K6']['beamform_detect_int8_mma']
    for k in (k1, k2, k4, k5, k6):
        k['launches_per_gulp'] = k['launches'] / float(NWARM + NTIMED)
    k0['launches'] = fx['launches']['fx-race']['probe']
    k0['launches_of'] = 'the fx-race arm (one available() per process)'
    k7['launches'] = fx['launches']['fx-K7']['xcorr_herm']
    k7['launches_per_gulp'] = k7['launches'] / float(XWARM + XTIMED)
    k7['launches_x_stateful'] = fx['launches']['x-stateful']['xcorr_herm']
    k7['launches_vec16'] = fx['launches']['fx-K7']['xcorr_herm_vec16']
    k7['launches_capture'] = capt['launches']
    k7['launches_fabric'] = {
        'xhost drill': fab['k7_launches'],
        'fx_correlator_torch --fabric':
            fab['examples']['fx_example']['k7_launches']}
    k7['launches_x_stateful_vec16'] = \
        fx['launches']['x-stateful']['xcorr_herm_vec16']
    k8['launches'] = n8['xcorr_cross']
    k8['launches_of'] = 'xcorr_int8 cross family, 4 station-row blocks'
    k8['launches_rowblock'] = n8['xcorr_cross_rowblock']
    k8['launches_vec16'] = [n8['xcorr_cross_vec16_i'],
                            n8['xcorr_cross_vec16_j']]
    k8['launches_mesh_2d'] = {k: mesh['launches']['mesh-2d'][k]
                              for k in K8_COUNTERS}
    k3['launches'] = fdmt['launches']['frb-K3']['fdmt_step']
    k3['launches_per_gulp'] = k3['launches'] / float(FWARM + FTIMED)
    k3['launches_fdmt_file'] = fdmt['launches']['fdmt-file']['fdmt_step']
    k3['launches_fabric'] = fab['examples']['fdmt_example']['k3_launches']
    k3['launches_fabric_of'] = \
        "the search host of fdmt_search_torch.py --fabric"
    k9['launches'] = mesh['launches']['mesh-corner-K9']['ring_permute']
    k9['launches_per_gulp'] = k9['launches'] / float(MWARM + MTIMED)
    k9['launches_of'] = 'the mesh-corner-K9 arm (%d ranks, %d hops a gulp)' \
        % (MD, MD - 1)
    # the macro phase's arms, K = 1 against K = MACRO_K (prewarm runs
    # included)
    for k, key in ((k1, 'K1'), (k2, 'K2'), (k3, 'K3'), (k6, 'K6'),
                   (k7, 'K7')):
        k['launches_macro'] = mac['launches'][key]
    kernels = [k0, k1, k2, k3, k4, k5, k6, k7, k8, k9]
    # the wrappers' host time: one call bracketed less a call's share of
    # 20 queued back to back
    for k in (k0, k1, k4, k5, k6, k7, k8, k9):
        k['host_ms'] = k['ms'] - k['ms_queued']['kernel']
    log('wrapper host time (bracketed less queued, ms): %s' % json.dumps(
        {k['name']: round(k['host_ms'], 4)
         for k in (k0, k1, k4, k5, k6, k7, k8, k9)}))
    log('total %.1f s; by phase %s' % (
        time.perf_counter() - t_start,
        json.dumps({k: round(v, 1) for k, v in phase_s.items()})))
    log(json.dumps({'pipeline': {
        'gulp': [NTIME, NPOL, NFINE], 'rfactor': RFACTOR,
        'gulps_timed': NTIMED,
        'msps_cuda_spectrometer': pipe['msps_cuda_spectrometer'],
        'msps_torch_fused': pipe['msps_torch_fused']}, 'card': smi}))
    log(json.dumps({'guppi_pipeline': {
        'nchan': GCH, 'blocsize': GBLOCSIZE, 'rfactor': GR,
        'obsfreq_mhz': GFREQ, 'obsbw_mhz': GBW, 'gulp_nframe': 1,
        'rate': 'Msamples/s of input, file to file, host clock (host-bound)',
        'arms': guppi, 'detect_k2': dk2}, 'card': smi}))
    log(json.dumps({'beamformer_pipeline': {
        'gulp': [BT, BF, BS, BP], 'nbeam': BB, 'rfactor': BR,
        'gulps_timed': NTIMED, 'arms': bpipe['rates']}, 'card': smi}))
    log(json.dumps({'fx_pipeline': {
        'gulp': [XT, XF, XS, XP], 'nframe_per_vis': XR, 'naccumulate': XA,
        'scale': XSCALE, 'gulps_timed': XTIMED,
        'x_stateful_gulp': [XST, XF, XS, XP], 'x_stateful_integration': XSINT,
        'x_stateful_gulps_timed': XSTIMED, 'arms': fx['rates'],
        'launches': fx['launches']}, 'card': smi}))
    log(json.dumps({'fdmt_pipeline': {
        'nchan': FCH, 'f0_mhz': FF0, 'df_mhz': FDF, 'tsamp_s': FTSAMP,
        'max_dm': FMAXDM, 'max_delay': FMD, 'gulp': FG, 'ntap': FNTAP,
        'far': FFAR, 'gulps_timed': FTIMED, 'pulses': FPULSES,
        **fdmt}, 'card': smi}))
    log(json.dumps({'mesh_pipeline': {
        'ranks_on_one_card': MD, 'gulp': [XT, XF, XS, XP],
        'nframe_per_integration': XT, 'gulps_timed': MTIMED,
        'arms': mesh['rates'], 'fdmt': {
            'mesh': {'sp': MFDMT}, 'nchan': FCH, 'gulp': FG,
            'max_delay': FMD, 'gulps_timed': FTIMED,
            'arms': fmesh['rates']}}, 'card': smi}))
    log(json.dumps({'dsp_library': dict(dsp, phase_s={
        k: phase_s[k] for k in ('map', 'fx-storage', 'fir', 'romein')}),
        'card': smi}))
    log(json.dumps({'xfer': xf, 'card': smi}))
    log(json.dumps({'linalg': la, 'card': smi}))
    log(json.dumps({'supervision': sup, 'card': smi}))
    mac['phase_s'] = phase_s['macro']
    log(json.dumps({'macro': mac, 'card': smi}))
    ana['phase_s'] = phase_s['analysis']
    log(json.dumps({'analysis': ana}))
    capt['phase_s'] = phase_s['capture']
    log(json.dumps({'capture': capt, 'card': smi}))
    brg['phase_s'] = phase_s['bridge']
    log(json.dumps({'bridge': brg, 'card': smi}))
    tune['phase_s'] = phase_s['autotune']
    log(json.dumps({'autotune': tune}))
    flt['phase_s'] = phase_s['fleet']
    log(json.dumps({'fleet': flt}))
    for rec, key in ((svc, 'service'), (fab, 'fabric'), (sch, 'scheduler'),
                     (mon, 'monitors'), (mpl, 'mesh_plans'),
                     (srf, 'surface')):
        rec['phase_s'] = phase_s[key]
        log(json.dumps({key: rec}))
    log(json.dumps({'kernels': kernels}))
    log(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
