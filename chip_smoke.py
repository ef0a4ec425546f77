"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

1. Prints the card's name and power limit.
2. Builds the sequential-biquad kernel (``firewheel_tpu_torch/csrc/
   biquad.cu``, K1), the megakernel (``csrc/megakernel.cu``, K2 and K3),
   the IMA ADPCM encoder (``csrc/adpcm.cu``, K4), the sample scans
   (``csrc/sample_scan.cu``, K5) and the threefry noise draw
   (``csrc/noise.cu``, K6) with nvcc, one process each, all at once, and
   prints ptxas's registers, spills and stack frame for K1 (16-byte and
   4-byte copies), for K2 and K3, each with blocks of 128 frames fixed (the
   main path) and of any length, with the rows beyond the mixer's compiled
   in and without, and with the arena spilled to device memory, and for
   K4-K9 (K8, ``csrc/assoc_scan_bwd.cu``, and K9, ``csrc/sample_scan_bwd.cu``:
   the backwards of K7 and K5).
3. Holds K1 against its plain PyTorch version on the card, with a
   different filter per lane: at the main path's shape, at F = 1, 100, 127
   and 4096 (longer than its ring of stages), at 33 lanes (a ragged warp),
   with state carried across two calls, with x starting one float into its
   storage (its 4-byte copies), and with coefficients per instance, one for
   all lanes and one per channel (lane divisors 2 and 2B, and a broadcast
   the wrapper materialises).  Times K1 at the main path's shape and at
   2048 lanes: its device time (``torch.profiler``) and a call with the
   wrapper's host work (CUDA events); and its plain version.
   3(b). Holds K4 (int16[8192, 4096, 2], the adpcm4 fleet's chunk, and
   six ragged shapes: odd batches, S not a multiple of the kernel's
   64-sample stage, 1, 3 and 33 channels), K5 (each of its four kinds: the
   envelope, the limiter's release and the gate's latch at 8192 lanes, the
   pink filter at 16 384, F=128; each also at the streams' [1, 256] and
   [2, 256], at [3, 127] and [33, 4096]; coefficients per lane, as
   numbers, as 0-d tensors and as broadcast views, the pink's poles as one
   state read in place) and K6 (f32[8192, 2, 128], the stream's
   [1, 2, 256], the hybrid's [1024, 2, 128], and ragged draws [3, 1, 1],
   [5, 2, 127], [33, 2, 100], [2, 3, 257], [1024, 2, 127], [300, 3, 257],
   [4200, 2, 127]; each at the blocks before and after the 2^32 wrap of
   the stream clock) against their plain versions on the card, bit for bit,
   and times each (K5 and K6 at their main and the streams' shapes).
   3(c). Holds K7's entry points (``ops/iir.py:biquad_scan``,
   ``one_pole_scan`` and ``biquad_cascade``) against their plain versions
   on the card, bit for bit, at f32[16384, 128] (the eager filter, a
   batched EQ band), [16384, 256] (the bus's meter), [2, 128] and
   [2, 256] (the streams' rows), 32 and 64 frames (the register kernels'
   other lengths), [2, 1024] (a stream's dispatch), F = 512, 1, 3 and 127
   (the shared design), rows longer than a CTA's shared memory holds,
   whose levels go to a device-memory workspace ([2, 16384] and
   [16384, 16384], a stream's 16 384-frame block, and [2, 32768]), the
   spatializers' pooled one-pole rows [1048576, 128], and cascades of 2,
   3 and 9 sections at the batched and the streams' rows and at ragged and
   long ones; a different filter a row (lowpasses, the EQ's 150 Hz shelf,
   the meter's 38 Hz high-pass).  Times each entry at the main paths' and
   the streams' shapes and at [16384, 16384] beside its bound.
4. Renders the 64-node mixer (filter on the kernel) with a BatchRenderer
   at B=8192 instances, K=32 blocks a chunk; checks finite outputs, the
   kernel's launch count (K per chunk) and the first instances against a
   CPU render of the same instances by the plain path; prints the
   realtime factor and the peak device memory.
5. Renders the same mixer at B=8192, K=32 with the megakernel
   (``csrc/megakernel.cu``) and, from the same params and state, with the
   eager BatchRenderer on the card (its plain version at full size):
   outputs, masks and every state leaf must agree; the first instances
   must match the CPU plain version; the kernel must launch once a chunk
   and K1 never (the filter runs inside it); state handed from an eager
   chunk to a megakernel chunk must render what two eager chunks do; the
   shared memory the wrapper counts must be the kernel's.  Times K2 on the
   device (``torch.profiler``) and prints both lowerings' wall per chunk
   and realtime factor.
6. Holds the megakernel against its plain version on the card on seven
   seeded random graphs at B=64 over four chunks of about 2048 frames, in
   which every smoother ramps, settles and rests: four in blocks of 128
   frames (K=16), one of 64 (K=32), one of 256 (K=8) and one of 127 (K=16,
   the arena rows padded).
7. Renders the effects chain (sampler → filter → echo → clip → reverb,
   ``mixer.effects_chain_graph``) with ``BatchRenderer(lowering="hybrid")``
   at B=1024, K=8 and at B=8192, K=32: torch stages for the sampler and the
   reverb, one launch of the island kernel (K3, ``csrc/megakernel.cu:
   island_kernel``) a chunk for filter·echo·clip.  From the same params and
   state the eager BatchRenderer renders it on the card: masks and integer
   leaves must be equal, floats within 1e-5; the first instances must match
   the CPU plain hybrid; K3 must launch once a chunk and K1 never; state
   handed from an eager chunk to a hybrid chunk must render what two eager
   chunks do.  Times K3 (its device time by ``torch.profiler``, and a call
   by CUDA events) against its plain version (``executor_mega.
   island_chunk_reference``, a call by CUDA events) on the card at the same
   operands, and prints both lowerings' wall per chunk, realtime factor and
   peak memory.
8. Correctness only, at B=64, K=8: the hybrid against the eager path on the
   card for BASELINE config 4 (the FFT reverb), a graph with stream inputs,
   and the mixer as a graph that is one island.
9. The streaming engine (``FirewheelCtx`` → ``GraphContext`` →
   ``GraphProcessor``) on the card, one instance: the beep test rendered
   offline (FFT peak at 440 Hz, peak amplitude 0.2512); the 64-node mixer
   streamed offline for 94 buffers of 1024 frames in 128-frame blocks (a
   volume change scheduled mid-buffer, a voice dropped and one added before
   buffer 40, the last buffer 1000 frames), one and eight buffers a pump,
   against the same stream on the CPU (1e-5, final state, K1 once a block,
   K2 and K3 never); the same edit staged (deferred swap: installed within
   two pumps, no NaN, no silent buffer, a surviving voice's state equal to
   the immediate swap's); the effects chain with the sampler's scheduled
   commands, card against CPU.  It prints the stream's realtime factor,
   wall a buffer (p50, p99), kernels a block and copies a dispatch
   (``torch.profiler``), K1's device time at the stream's 2 lanes, and the
   underflows of a 2 s realtime run on the native paced consumer, which
   are a measurement and fail nothing.
10. The serving fleet (``SessionServer`` over ``BatchRenderer``) on the
   card.  (a) The 64-node mixer at capacity 8192, K=32, pcm16, eager with
   K1: 1024 sessions connected, each with its own volumes and pans; 8
   chunks shipped through ``render_fetched`` and a flush; slots 3, 7 and
   12 disconnected and reconnected; two chunks more with a poll between
   two ``render_fetched`` calls.  Slots 0..15 are held against a CPU
   SessionServer of capacity 16 that runs the same operations in the same
   order (pcm16 within 1 LSB, the samples 1 LSB apart counted; clip events
   equal in every poll); every vacant slot is all zeros; K1 launches 32 a
   chunk.  (b) ``render_stream`` at capacity 8192 equals ``render_chunk``
   and a plain ``.cpu()`` chunk by chunk, bit for bit; the walls per chunk
   with egress and without it (the same chunks back to back, one
   synchronize at the end), the bytes shipped, a chunk's copy to pinned
   memory alone, and the realtime factor of the shipped audio.  (c) The
   fleet saved mid-stream and restored into a fresh server: the next two
   chunks bit for bit, the bytes and the seconds; at capacity 64 saved on
   the card and restored on the CPU (1e-5).  (d) The effects chain at
   capacity 1024, K=8, on the hybrid, pcm16, with per-slot rates, loops
   and one-shots, against a CPU fleet on slots 0..15 (pcm16 within 1 LSB,
   sampler events equal); one K3 launch a chunk, no K1.  (e) The mixer
   streamed through ``FirewheelCtx``, saved at buffer 20 and continued to
   40; a fresh ctx loads the checkpoint and renders buffers 20..40 bit for
   bit; ``output_latency_frames`` after ``compensate_latency``.  (f) The
   mixer fleet of (a) with ``output_format="adpcm4"`` beside the same
   fleet in pcm16: three chunks through ``render_fetched``, each a quarter
   of pcm16's bytes plus the headers, the first bit-equal to K4's plain
   version on the card applied to the pcm16 fleet's chunk and to the host
   codec (``utils/adpcm.encode_ima``) for slots 0..15; K4 once a chunk;
   ``render_stream`` against ``render_chunk`` and ``.cpu()``; both fleets'
   shipped realtime factor, in turns.
11. The spatial scene (BASELINE config 5, ``examples/spatial_scene.py``:
   128 beeps through 3D spatializers, 4 group sums, a metered and clipped
   master, 266 nodes, 258 arena buffers) on the card.  (a) Streamed through
   ``FirewheelCtx`` as the example streams it (1024-frame buffers of
   128-frame blocks, 8 a pump, 1.5 s, every 4th emitter orbiting 90°) with a
   ``SpatialScene`` listener turn mid-stream, against the same stream on the
   CPU, which the first worker renders (1e-5: audio, the meter's reading,
   every state leaf); its realtime
   factor, wall a buffer, kernels a block and device busy share
   (``torch.profiler``), and the pooled groups of beeps and spatializers.
   (b) Eager at B=8192, K=32, every instance with its own positions,
   volumes and occlusion, the first instances against a CPU render; wall
   per chunk and peak memory.  (c) K2 at B=8192, K=32, tile 1 (the arena
   fits one instance a CTA): at rest and with every 4th spatializer moving,
   against the eager render on the card (outputs, masks, every state leaf)
   and the first instances against the plain version on the card; one
   launch a chunk; the shared memory against the kernel's count; device
   time and bound.  In blocks of 256 frames at B=1024, K=8, where the
   arena fits no CTA and spills to device memory: against eager and the
   plain version, one launch a chunk, timed.  (d) Every 4th emitter doppler (torch stages) on the hybrid at
   B=1024, K=8: against eager and the CPU plain hybrid, K3 once an island a
   chunk, K3 timed on the beeps' island against its plain version.  (e) The
   binaural variant eager at B=1024, K=8 against a CPU render.
12. The mastering bus (``examples/mastering_bus.py``: pink noise ducked
   under a beep dialogue, compressor, 255-tap FIR shelf, lookahead
   limiter, loudness meter; ``mixer.mastering_bus_graph``).  (a) Streamed
   through ``FirewheelCtx`` as the example streams it (256-frame buffers,
   4 s, the dialogue on from 1.0 s to 2.5 s, the meter read every 100 ms
   into ``IntegratedLoudness``) against the same stream on the CPU, which
   a worker process runs while the card runs phases 2-11: audio and state
   within 1e-5, every reading and the integrated loudness within 1e-3 LU;
   its realtime factor, wall a buffer, K5 and K6 launches a block and the
   kernels a block (``torch.profiler``).  (b) Eager at B=8192, K=32 with
   per-instance seeds, thresholds, duck depth, makeup and dialogue, the
   first instances against a CPU render; wall a chunk, peak memory, K5 and
   K6 launches a chunk.  (c) ``MegaRenderer`` refuses it (the noise and
   the FIR have no row); the hybrid at B=1024, K=8 and B=8192, K=32 is the
   JAX package's partition, [noise] torch | [beep, ducker, sum,
   compressor] K3 | [FIR] torch | [limiter, loudness meter] K3: two K3
   launches a chunk, no K7; against eager on the card, outputs, masks and
   every state leaf bit for bit but the meter's ring (1e-5 relative: each
   hop's energy is summed in another order); each island against its plain
   version and timed.  (d) The witness graph (a beep through a limiter and
   dry, the latency pass's delay compensators, an LFO, a sum, a 0-output
   meter) through K2 and the hybrid against eager on the card in blocks of
   128 and 127 frames.
13. The FX palette of ``examples/interactive_graph.py``.  (a) The example's
   engine (two voices → sum → clip → meter, ``mixer.add_fx_engine``)
   streamed through ``FirewheelCtx`` (1024-frame buffers of 128-frame
   blocks, 8 a pump, 3.07 s) while its master insert switches through every
   kind of the palette (EQ, chorus, flanger, tremolo, waveshaper, gate) and
   back to none, each switch a topology edit hot-swapped with state
   migration, then a volume, a pan and a frequency change, a voice removed
   and one added; against the same stream on the CPU (the worker of
   12(a)), audio and state within 1e-5; K7 one launch a block while the
   EQ is in (its three bands one cascade); its realtime factor, wall a buffer and each kind's kernels
   a block (``torch.profiler``).  (b) ``mixer.fx_palette_graph`` (eight
   voices, every insert in series, a DC-blocked fold, stereo width, a
   pitch-shifted mono leg, a meter) eager at B=8192, K=32 with per-instance
   params (``vary_fx_params``): its first chunk again with the plain scans
   in K7's place, bit for bit, and the first instances against a CPU render
   (1e-4: the EQ's 150 Hz shelf, JAX's scan in float32, turns the devices'
   ulps into ~2.5e-5); wall a chunk, peak memory, K7 launches a chunk.  (c)
   ``MegaRenderer`` refuses it; the hybrid at B=1024, K=8 (the voices, sum
   and clip one K3 island, the FX chain one torch stage) equals eager on
   the card bit for bit.
14. The sampler and formats slice: no kernel of the port's lies on it, and
   K1-K7 must launch no time.  (a) ``examples/music_player.py``'s session
   through ``FirewheelCtx`` (``MusicPlayer`` over two streaming decks,
   512-frame buffers of 128-frame blocks): tracks written from a seed (a
   2 s WAV intro, a 2.7 s FLAC bed by ``encode_flac`` of 129 600 frames, not
   a block multiple, a 2 s WAV outro); the intro, the bed queued with a
   0.5 s crossfade, re-played looped past its seam, a 0.5 s crossfade to
   the outro, a 0.3 s faded stop, 6.9 s in all; in one-buffer dispatches
   and, in a worker process at the same time, four-buffer dispatches, each
   against the same session on the CPU, run by the worker of 12(a) (1e-5,
   equal finish events);
   the stream's realtime factor, wall a buffer (p50, p99), the decks'
   refills, kernels a block and the device's busy share (``torch.profiler``).
   (b) One ``GranularSamplerNode`` at its defaults (2048-frame grains, 4
   overlapping, SOLA on) on a 20 s stereo tone sequence streamed for 3 s:
   tempo 0.75 at +3 st, tempo 1.25 at −5 st, a pause, a resume, a seek;
   against the CPU in lockstep through the card's state after each buffer
   (1e-5; every integer leaf and the anchors exactly) under the lag rule:
   where the state differs, the CPU replays the buffer's blocks and accepts
   the difference only where a spawn's best two SOLA scores lie within
   1e-5 relative, counting it.  (c) ``BatchRenderer`` (eager) at B=8192,
   K=32: one 2 s stereo clip broadcast (f32[8192, 2, 96000]), each instance
   its own tempo (0.5-2.0), pitch (±12 st) and start, one in sixteen
   starting near the end (every one's finish event fires); three chunks,
   eight rows held against a CPU render of the same instances from the
   card's state at each chunk (audio 1e-5, the anchors, slot and phase
   exactly, finish counts equal) under the lag rule; wall a chunk, the
   realtime factor, kernels a block, the busy share, peak memory.  (d) A
   scene saved by ``save_graph`` (granular, a looped sampler, a streaming
   deck on a WAV file, a beep, a sum, volume, pan, echo and a clip) loaded
   by ``load_graph`` renders on the card bit for bit as the graph built
   directly, and within 1e-5 of the CPU.
15. The voice pool, MIDI playback, HTTP streaming and the node validator.
   No kernel of the port's lies on (a)-(c): K1-K7 must launch no time there.
   (a) ``examples/voice_pool_game.py``'s battle on an 8-voice ``VoicePool``
   through ``FirewheelCtx`` (1024-frame buffers of 128-frame blocks, 3 s):
   shots scheduled 50 ms ahead, inside blocks, overlapping; a volley of
   seven priority-3 lasers after which a footstep is dropped (``play``
   returns ``None``); an explosion that steals a laser's voice; the looping
   hum ducked and then stopped by its handle; ``finished_handles(cx.
   poll_events())`` each tick; the clips' noise seeded from a stable hash
   of their names.  Against the same session on the CPU (the worker of
   12(a)): audio within 1e-5, the handles, dropped shots, steals and
   finished handles equal; the pool's samplers one pooled group of 8 in
   the executor's plan.  Its realtime factor, wall a buffer (p50, p99) and
   kernels a block (``torch.profiler``).  (b) ``examples/midi_jukebox.py``:
   its ``demo_song`` with a control track on the bass's channel (RPN 0,0
   sets a 7-semitone bend range, an NRPN select and its data entry follow
   and must leave it, then bends) parsed by ``parse_midi`` and played by
   ``MidiSequencer`` on a 24-voice pool, ``update()`` every 4 buffers, 3 s,
   against the CPU: audio within 1e-5, skipped and dropped notes equal; its
   realtime factor, wall a buffer and kernels a block.
   (c) A seeded 2 s 48 kHz stereo pcm16 WAV served by a localhost
   ``ThreadingHTTPServer`` with byte ranges, streamed by a
   ``StreamingSamplerNode`` through ``HttpWavStreamReader``: bit for bit the
   same node reading the file from disk on the card, within 1e-5 of the
   CPU.  (d) ``testing.validate_node(..., device="cuda")`` on
   ``FilterNode(backend="pallas")`` (K1), ``CompressorNode`` (K5),
   ``NoiseNode("pink")`` (K6, K5) and ``ParametricEQNode`` (K7): every
   check passes and each kernel launches.
16. Scale-out over ``torch.distributed``.  (a) One process joins an NCCL
   group of one (``initialize_multihost``, the default backend); a
   ``BatchRenderer`` over ``make_mesh({"dp": 1})`` renders the mixer of
   phase 4 at B=8192, K=32 bit for bit as the unmeshed renderer from the
   same params and state (K1 32 launches a chunk); a ``VoiceParallelMixer``
   over ``make_mesh({"vp": 1})`` runs (c)'s configuration, its
   ``all_reduce`` an NCCL call.  (b) Two processes (this script with
   ``--mesh-rank``) share the card over gloo, a stand-in for two cards
   (NCCL refuses two ranks on one device): the mixer fleet at dp=2, B=8192,
   K=32, 4096 rows a rank: each rank's rows within 1e-6 of the unsharded
   render on the card over six chunks; splices at instances 3 and 6000 and
   a reset at 4099 land only on their owners; the ranks' clip events, by
   global instance, equal the unsharded poll; both ranks checkpoint
   mid-stream, and a fresh two-rank fleet and this process (2 → 1) restore
   it, the next two chunks bit for bit, the first instances within 1e-5 of
   the CPU.  Each rank's wall a chunk, the fleet's instances a second and
   phase 4's beside them, measured.  (c) ``VoiceParallelMixer``: 64 voices
   of the mixer's voice (beep → volume → pan, each its own frequency,
   volume and pan) into its bus (lowpass 8 kHz on K1 → echo → clip →
   meter), K=32, three chunks, at vp=1 and at vp=2 over (b)'s ranks (one
   ``all_reduce`` of f32[32, 2, 128] a chunk, CUDA tensors over gloo),
   within 1e-5 of the unmeshed mixer on the card and the CPU, master state
   included; K1 once a block; the wall a chunk and each collective's time.
   (d) ``utils.profiler.trace`` with ``annotate("render-chunk")`` around one
   chunk of (a): the trace holds the annotation and names K1's kernel.
17. Differentiable rendering.  (a) K8 (``ops/iir.py:biquad_cascade_backward``
   and ``one_pole_scan_backward``) against its plain backward on the card,
   within 1e-5 of each gradient's largest magnitude, at 3(c)'s operands:
   f32[16384, 128] (one section, the EQ's three, two and eight), the
   one-pole there and at [1048576, 128], the streams' [2, 128] and [2,
   256] (a cascade of three at [2, 128]), [33, 4096] (one section and
   three), [33, 127] and [1000, 127] (4-byte copies, a ragged last stage,
   three sections) and nine sections through autograd (two launches each
   way); timed as K7 is.  (b) K9 (``ops/dynamics.py:scan_lanes_backward``)
   likewise, each kind at 3(b)'s shapes, the gate also at [1000, 127] and,
   at [1, 256], [2, 256], [33, 4096] and [1000, 127], with sparse bursts
   of level (its hold counting down across stages, the gate closing), the
   carry-out gradients non-zero.  (a) and (b) run right after
   3(c): from phase 11 on a profile has seen no device activity, and these
   kernels are shorter than their wrappers' host work, which CUDA events
   would time in its place.  (c) The 64-node mixer with
   its filter on the associative scan (``"auto"``, the JAX package's
   default) trained on the card: B=1024, K=8 through ``chunk_fn``, each
   instance's 19 gains, 19 pans and the lowpass's frequency and Q leaves
   ``[B]``; the loss each instance's channel energies against a target
   rendered from other params; 5 SGD steps, the loss falling at each; the
   first step's gradients of the first instances within 1e-4 of the CPU's
   (autograd of the plain scans); K7 once a block a forward, K8 once a block
   a backward, no other kernel in either; the wall a step, peak memory and
   a profiled step's kernels and device time.  (d) ``examples/
   autotune_mix.py``'s configuration (three voices, 24 blocks of 256
   frames, 80 steps at rate 8.0, clipped to [0, 4]; the three probes as
   instances of one batch) converges to loss < 1e-6.  (e) The mastering
   bus at B=256, K=16: each instance's gradient with respect to the
   compressor's threshold and makeup and the limiter's ceiling within 1e-4
   of the CPU's for the first instances; K9 launches in the backward.  (f)
   K1, K2 and K3 raise ``NotImplementedError`` where an operand requires a
   gradient under grad mode (as ``jax.grad`` through the JAX package's
   ``pallas_call`` raises), and run bit for bit as before under
   ``torch.no_grad``.  (g) Where the machine has two devices, K5, K7, K8
   and K9 on cuda:0's tensors with another device current equal the same
   launches with cuda:0 current (with one device the log says so).  (h)
   The FX palette's voices → its three-band EQ → a gate that opens and
   closes within the chunk (``mixer.eq_gate_graph``) at B=8192, K=8, each
   instance's voices and EQ gains from ``vary_fx_params``: one SGD step
   (forward, backward, update) of Σ over instances of the mean square with
   respect to each band's gain in dB (its coefficients designed from it
   inside the gradient) and the gate's floor, per instance; K7 and K5 once
   a block forward, K8 (S=3) and K9 (the gate) once a block backward and
   nothing else; the gradients equal on the card to the same step's with
   the kernels' plain versions in their place (``plain_kernels``), the
   first instances' within 1e-4 of the CPU's by that arithmetic (and the
   CPU's autograd through the plain scans beside it, logged); the floor's
   gradient non-zero in every instance; the step's wall, a profiled step's
   kernels, idle share and K8's and K9's device time, and peak memory.
18. The JAX package's differential fuzzers on the card, run last.  (a) ``mixer.fuzz_graph``'s seeds 0-24 (the CPU tests' 0-11,
   the next 12, and 24, the sixth seed K2 takes) and the pooling-heavy
   graph at B=8192, K=32, two chunks, rows 0-7 on their own params
   (``mixer.fuzz_instance_params``) and stream inputs from eight seeded
   patterns: eager, K2 where ``supports_megakernel`` and the hybrid from
   the same params and state; K2 and K3 against eager (masks and integer
   leaves equal, floats within 1e-5: bit for bit so far), rows 0, 3, 7 and
   8191 against ``testing.NaiveGraphRenderer`` on the CPU (1e-5, 1e-4 for a
   graph with the EQ, as phase 13), which a second worker process renders
   while the card runs phases 2-3; each chunk's launches of K1-K7 against
   what the schedule and its pooled groups imply (K2 once, K3 once an
   island, K5-K7 once a plan entry a block, K1 never), and the first
   chunk's also by ``torch.profiler``: a profile that differs is taken once
   more, and one that still sees more launches than the wrappers counted
   fails the phase; the log names the graphs where it saw no device
   activity or missed launches; the wall a chunk per graph of each
   lowering.  (b) ``testing.edit_fuzz``'s seeds 0-3 (7 rounds of live
   edits) with the processor on the card, against the interpreter on the
   CPU (1e-5).  (c) ``testing.chunked_fuzz``'s seeds 1000-1003 at
   ``chunk_blocks=4`` (2e-5).  (d) The window of scheduled commands across
   2^32 bit for bit as in a small epoch, and a ``SessionServer`` of 8192
   parked one chunk before 2^32 rendering two chunks, finite and
   phase-continuous.
19. BASELINE config 3 (``examples/voice_mixer_64.py``: 64 poolable
   samplers looping their own clips at ±3 semitones, four group sums, a
   mixer sum, volume → pan → clip; ``mixer.voice_mixer_64_graph``) and the
   ported examples (``firewheel_tpu_torch/examples/``), run last.  (a) The
   example's stream on the card (1024-frame buffers and blocks, 8 a
   dispatch, 2 s) against the same stream on the CPU, which the second
   worker renders after 18(a)'s oracle (1e-5, audio and state); K1-K9
   launch no time; its realtime factor, wall a buffer (p50, p99) and
   kernels a block.  (b) B=8192, K=32 with every instance its own rates,
   playheads, bus volume and pan (``vary_voice_mixer_params``), three
   chunks carrying state, eager and ``BatchRenderer(lowering="hybrid")``:
   the 64 samplers a torch stage, the sums and the bus one K3 island; K3
   once a chunk and nothing else; the hybrid equal to eager (outputs,
   masks, every state leaf); rows 0, 1, 4097 and 8191 within 1e-5 of the
   CPU's render; K3 against its plain version at the last chunk's
   operands, timed beside its bound; the walls a chunk and peak memory.
   (c) ``examples.game_server`` (16 instances, the per-instance control
   plane), ``examples.input_effects`` (2 s of the two-tone through the
   filter's scan, K7 once a block), ``examples.visual_node_graph`` against
   the same examples on the CPU (the second worker), and
   ``examples.interactive_graph``'s HTTP editor on an ephemeral localhost
   port: a voice added and the EQ inserted by POST, ``/state`` showing a
   finite meter and stats that advance, K7 launching with the EQ in.
20. The port's entry point (``firewheel_tpu_torch/entry.py``, the
   counterpart of ``__graft_entry__.py``).  (a) ``entry()``'s chunk (the
   64-node mixer with the ``"auto"`` filter, K=4, B=2) on the card against
   ``entry(device="cpu")``'s (1e-5, state included; masks equal), and
   the same step (``entry.chunk_step``) on the mixer built with
   ``strip_masks`` (every mask not silent) and with ``state_light``; K7
   once a block; the wall a chunk.  (b) ``dryrun_multichip(1)`` in place
   in a world of one on NCCL.  (c) ``dryrun_multichip(4)``: four started
   ranks share the card over gloo with CUDA tensors, dp=2 × vp=2, each
   rank's rows against the unsharded step (1e-5), then ``BatchRenderer``,
   ``VoiceParallelMixer`` and ``SessionServer`` over meshes; K7 once a
   block in each rank's sharded step (the master's lowpass).

The last line of standard output is one JSON object with ``"ok": true``;
the line before the card's line lists each kernel with its launches on the
batched main path (``launches``), in phase 9's stream (``stream_launches``;
K1's device time, call and plain version at the stream's 2 lanes beside
them), in phase 10's fleets (``serve_launches``) and in 15(d)'s validator
(``validator_launches``) and in phase 16 (``mesh_launches``), in 18(a)'s
fuzz graphs by lowering (``fuzz_launches``, on K2, K3, K5, K6 and K7's
rows), K7's biquad in 19(c)'s examples (``example_launches``) and in
phase 20 (``entry_launches``), K3 on
config 3's island in 19(b), K2 and K3 once
more for the spatial scene of phase 11 (and K2 with the arena spilled at
256 frames), K3 for the mastering bus of 12(c), K4-K6 (launches in 10(f)'s
fleet and 12(b)'s batched bus, times from 3(b)) and K7's two kernels, the
biquad (``biquad_scan``, timed as 13(b)'s cascade of the EQ's three bands)
and the one-pole (launches in 13(b)'s batched FX palette,
``stream_launches`` in 13(a) and 12(a), times from 3(c), every other shape
3(c) timed under ``at``), K8 (``assoc_scan_backward``: launches in 17(c),
times at the EQ's cascade from 17(a), its other shapes under ``at``) and
K9 (``sample_scan_backward``: launches in 17(e), the limiter's; times at
the limiter's [8192, 128] from 17(b), under ``timed_at``), both with
their launches in 17(h)'s backward (``eq_gate_launches``), its error
against its plain version, its device time on the card (``ms``, by
``torch.profiler``, or by CUDA events where the profile saw no device
activity: ``ms_by`` says which) and a call's time with its wrapper's
host work (``call_ms``, by CUDA events), the plain version's, and its
bound: the larger of the bytes it must move over 3.35 TB/s and its
operations over 67 TFLOP/s, the f32 rate (NVIDIA's H100 SXM data sheet;
K4's and K6's 32-bit integer operations are counted at that rate; the
one-pole's float64 operations at 34 TFLOP/s, the f64 rate).
Any failure raises and exits non-zero without that line.  Without a CUDA
device, or without the package beside this file, it exits non-zero too.
"""

from __future__ import annotations

import functools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

B = 8192              # instances (the README's headline configuration)
K = 32                # blocks per chunk
TIMED_CHUNKS = 3
CHECK_INSTANCES = 2   # instances re-rendered on the CPU by the plain path
KERNEL_TOL = 1e-6     # kernel vs plain version on the card
SLICE_TOL = 1e-5      # card render vs CPU render of the same instances
# megakernel vs eager on the card: masks and integer leaves exactly, floats
# to 1e-5 (the meter's mean sums in another order; sin/exp round alike)
MEGA_TOL = 1e-5
# (seed, frames a block): the mixer's 128, and 64, 256 and 127 (any length
# goes through the kernel); K = 2048 // F blocks a chunk.  Seed 4 has an
# instance whose pan's first ramp value sits at the settle threshold
RANDOM_GRAPHS = ((0, 128), (1, 128), (2, 128), (4, 128), (3, 64), (1, 256),
                 (4, 127))
RANDOM_B, RANDOM_CHUNKS, RANDOM_CHUNK_FRAMES = 64, 4, 2048
# the effects chain: bench.py --hybrid's configuration and the README's
HYBRID_CONFIGS = ((1024, 8), (8192, 32))
HYBRID_TOL = 1e-5     # hybrid vs eager and K3 vs its plain version on the card
PHASE8_B, PHASE8_K = 64, 8
KERNEL_REPS = 10      # launches per device-time measurement
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12      # H100 SXM f32 outside the tensor cores
F64_OPS_PER_S = 34e12      # H100 SXM f64 outside the tensor cores (NVIDIA's data sheet)


def log(msg: str) -> None:
    print(msg, flush=True)


def _port():
    """The port beside this file (for the functions a worker process runs)."""
    here = os.path.dirname(os.path.abspath(__file__))
    if here not in sys.path:
        sys.path.insert(0, here)
    import firewheel_tpu_torch as ft

    return ft


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


class Timed(float):
    """A time in ms with how it was taken (``how``): "torch.profiler", the
    kernel's own device time, or "CUDA events", calls back to back with
    their wrappers' host work.  A sum keeps its terms' method ("torch.profiler
    and CUDA events" where they differ)."""

    def __new__(cls, ms: float, how: str):
        t = super().__new__(cls, ms)
        t.how = how
        return t

    def __add__(self, other):
        how = getattr(other, "how", self.how)
        return Timed(float(self) + float(other),
                     self.how if how == self.how else "torch.profiler and CUDA events")

    __radd__ = __add__


def device_ms(fn, kernel: str, reps: int, launches: int = 1) -> Timed:
    """Mean device time per call of ``fn`` in the CUDA kernel whose name
    contains ``kernel``, which each call launches ``launches`` times, over
    ``reps`` calls, by ``torch.profiler`` (host
    and device activity): the kernel alone, without the host work its
    wrapper does between launches (which CUDA events around the calls
    would count when it is longer).

    Minutes into this script a profile has seen no device activity at all
    (in each of four calls, in phase 11(c) or 11(d), at a profile that
    another call took without fault; a fresh process profiled every
    launch), or has seen the card but only some of the launches (one of
    ten K3 launches in phase 11(d)).  A profile that misses launches is
    taken once more; if that one misses them too, the launches are timed
    by CUDA events instead, back to back, and the log says so: for a
    kernel that outlasts its wrapper's host work, as phase 11's do, that
    is its device time too; for a kernel shorter than its wrapper's host
    work it is the call's.  The result says which (:class:`Timed`), and the
    kernels line gives it beside each time (``ms_by``)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        averages = prof.key_averages()
        if not any(e.device_type == torch.autograd.DeviceType.CUDA for e in averages):
            seen.append("no device activity")
            continue
        hits = [e for e in averages if kernel in e.key]
        # the mean over the launches the profiler recorded: all of them, or
        # all but one (a launch at the edge of the trace may be left out)
        n = reps * launches
        if (len(hits) == 1 and n - 1 <= hits[0].count <= n
                and hits[0].device_time_total > 0):
            log(f"{kernel}: {hits[0].count} of {n} launches profiled")
            return Timed(hits[0].device_time_total / hits[0].count * launches / 1e3,
                         "torch.profiler")
        seen.append(str([(e.key, e.count) for e in hits]))
    ms = cuda_ms(fn, reps)
    log(f"{kernel}: torch.profiler saw {' then '.join(seen)} for {reps * launches} "
        f"launches; timed by CUDA events instead, {ms:.4f} ms a call")
    return Timed(ms, "CUDA events")


def bound(nbytes: float, ops: float, f64_ops: float = 0.0):
    """``(bound_ms, bound_by)``: the least time the card could take to move
    ``nbytes`` (each input read once, each output written once) and do
    ``ops`` f32 and ``f64_ops`` f64 operations, and which of the two sets
    it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S + f64_ops / F64_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def row_ops(code: int, n_in: int, n_out: int, aux0: int = 0) -> int:
    """f32 operations a megakernel row does per frame (a transcendental
    counts as one; the smoothers' per-block work is left out).  The
    spatializer (9): the gain, the one-pole's two products and sum, and the
    two pan gains.  The FX rows (10..18) per channel: the width's mid, side
    and merge; the LFO phase (4), its cosine and the gain of the tremolo;
    the waveshaper's drive, curve, mix and gain and, with the DC blocker,
    the scan (~4 a frame, counted at the f32 rate); the gate's level, latch
    and gains; the EQ's scan, ~28 a frame a band (csrc/assoc_scan.cu); the
    mod delay's phase, delay, interpolated tap and mix; the pitch
    shifter's two phases and two crossfaded taps.  The mastering bus's rows
    (19..25): the compressor's level, envelope, dB gain with its knee (its
    log10 and pow count one each) and the gains; the ducker's the same over
    its sidechain; the limiter's level, the window's maximum over its
    lookahead (aux0 + 1 samples), the release and the gains; the loudness
    meter's two scans a channel (~28 a frame each), the weighted power and
    the hops' sums; the LFO's phase, wave and scale; the delay compensator
    moves samples only; the sink meter is the meter."""
    return {0: 0, 1: 4, 2: n_in, 3: 4, 4: n_in - n_out, 5: 9 * n_in,
            6: 5 * n_in, 7: 3 * n_in, 8: 3 * n_in, 9: 6, 10: 0, 11: 2, 12: 7,
            13: 10 * n_in, 14: 12 * n_in, 15: 10 + 2 * n_in, 16: 28 * aux0 * n_in,
            17: 20 * n_in, 18: 33 * n_in, 19: 20 + 2 * n_in, 20: 10 + 2 * n_in,
            21: aux0 + 6 + 3 * n_in, 22: 59 * n_in + 1, 23: 7, 24: 0,
            25: 3 * n_in}[code]


def kernel_work(em, prog, lw, params, state, batch: int, k: int, io_bytes: int):
    """``(bytes, ops)`` of one launch of K2 or K3 on ``lw``: its leaves read
    (params, state, derived filter coefficients), its state written, the
    operands ``io_bytes`` (outputs and masks, K3's live-ins), and its rows'
    operations over every frame."""
    values = em._leaf_values(prog, lw, params, state)
    nbytes = io_bytes + sum(
        v.nbytes * (2 if leaf.tree == "state" else 1)
        for leaf, v in zip(lw.leaves, values))
    ops = batch * k * lw.frames * sum(
        row_ops(int(r[em.OP]), int(r[em.N_IN]), int(r[em.N_OUT]), int(r[em.AUX0]))
        for r in lw.ops)
    return nbytes, ops


def ptxas_report(log: str, kernel: str) -> dict:
    """ptxas's registers, spills and stack frame for each entry function
    whose mangled name contains ``kernel``, by that name, from a verbose
    nvcc log."""
    current, found = None, {}
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            current = m.group(1)
        elif current and kernel in current and ("stack frame" in line
                                                or "registers" in line):
            found.setdefault(current, []).append(
                line.replace("ptxas info    :", "").strip())
    if not found:
        raise AssertionError(f"no ptxas report for {kernel} in the build log")
    return {name: "; ".join(lines) for name, lines in found.items()}


def tree_err(a: dict, b: dict) -> float:
    """Largest difference between two trees of tensors: float leaves by
    max abs difference, others (masks, int32/int64) inf unless equal."""
    errs = []

    def err(x, y):
        x, y = x.cpu(), y.cpu()
        if x.shape != y.shape:
            errs.append(float("inf"))
        elif x.dtype.is_floating_point:
            errs.append(float((x - y).abs().max()) if x.numel() else 0.0)
        else:
            errs.append(0.0 if torch.equal(x, y) else float("inf"))

    from firewheel_tpu_torch.convert import tree_map
    tree_map(err, a, b)
    return max(errs, default=0.0)


def device_tree_err(a: dict, b: dict) -> float:
    """:func:`tree_err` on the device: one host sync for the whole tree (an
    echo's line at B=8192 is 250 MB)."""
    from firewheel_tpu_torch.convert import tree_map

    errs = []

    def err(x, y):
        inf = torch.full((), float("inf"), device=x.device)
        if x.shape != y.shape:
            errs.append(inf)
        elif x.dtype.is_floating_point:
            if x.numel():
                errs.append((x - y).abs().max().float())
        else:
            errs.append(torch.where((x == y).all(), torch.zeros_like(inf), inf))

    tree_map(err, a, b)
    return float(torch.stack(errs).max()) if errs else 0.0


def check_kernel(seq_iir, iir):
    """Phase 3: the kernel against its plain version on the card."""
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(1234)

    def lowpass(lead):
        # a different lowpass per element of lead: 200 Hz .. 20 kHz, Q 0.5 .. 4
        freq = 200.0 + 19800.0 * torch.rand(lead, generator=gen)
        q = 0.5 + 3.5 * torch.rand(lead, generator=gen)
        return iir.biquad_lowpass(freq.to(dev), q.to(dev), 48000)

    def case(lanes, frames, coef_shape=None, offset=0):
        """x f32[lanes, F] (``offset`` floats into its storage), its state,
        and coefficients of ``coef_shape`` (per lane by default)."""
        n = lanes * frames
        x = torch.randn((n + offset,), generator=gen).to(dev)[offset:].view(lanes, frames)
        z = tuple(0.1 * torch.randn((lanes,), generator=gen).to(dev)
                  for _ in range(2))
        return x, z, lowpass((lanes,) if coef_shape is None else coef_shape)

    def err(a, b):
        return float((a - b).abs().max())

    def check(tag, x, z, c):
        y, (z1, z2) = seq_iir.biquad_seq(x, z, c)
        yr, (r1, r2) = seq_iir.biquad_seq_reference(x, z, c)
        torch.cuda.synchronize()
        e = max(err(y, yr), err(z1, r1), err(z2, r2))
        log(f"K1 vs plain, {tag}: max_abs_err={e:.3e}")
        if not e <= KERNEL_TOL:
            raise AssertionError(f"K1 disagrees with its plain version ({tag}): {e}")
        return e

    worst = 0.0
    # the main path's shape (B instances x 2 channels), ragged frames (100,
    # 127: its 4-byte copies; 1), a ragged warp, and a ring that turns over
    for lanes, frames in ((2 * B, 128), (1000, 100), (2 * B, 127), (2 * B, 1),
                          (33, 128), (1000, 4096)):
        worst = max(worst, check(f"lanes={lanes} F={frames}", *case(lanes, frames)))

    # x starting one float into its storage: not 16-byte aligned
    x, z, c = case(2 * B, 128, offset=1)
    if x.data_ptr() % 16 == 0 or not x.is_contiguous():
        raise AssertionError("the misaligned case is aligned")
    worst = max(worst, check(f"lanes={2 * B} F=128, x misaligned", x, z, c))

    # coefficients per instance [B, 1] over [B, 2] lanes (the filter node's),
    # one filter for all lanes, and one per channel [2] (materialised)
    for tag, shape in (("per instance", (B, 1)), ("one for all lanes", ()),
                       ("per channel", (2,))):
        x, z, c = case(2 * B, 128, shape)
        x, z = x.view(B, 2, 128), tuple(t.view(B, 2) for t in z)
        worst = max(worst, check(f"lanes={2 * B} F=128, coefficients {tag} "
                                 f"{tuple(c.b0.shape)}", x, z, c))

    # state carried across two calls == one call over both halves
    x, z, c = case(2 * B, 256)
    y1, zm = seq_iir.biquad_seq(x[:, :128].contiguous(), z, c)
    y2, (z1, z2) = seq_iir.biquad_seq(x[:, 128:].contiguous(), zm, c)
    yr, (r1, r2) = seq_iir.biquad_seq_reference(x, z, c)
    torch.cuda.synchronize()
    e = max(err(torch.cat([y1, y2], 1), yr), err(z1, r1), err(z2, r2))
    log(f"K1 vs plain, state carried over 2 calls: max_abs_err={e:.3e}")
    if not e <= KERNEL_TOL:
        raise AssertionError(f"K1 state carry disagrees: {e}")
    worst = max(worst, e)

    # times at the main path's shape and the effects chain's at B=1024: the
    # kernel's device time, a call with the wrapper's host work, the plain
    # version's call
    times = {}
    for lanes in (2 * B, 2048):
        x, z, c = case(lanes, 128)
        ms = device_ms(lambda: seq_iir.biquad_seq(x, z, c), "biquad", KERNEL_REPS)
        call_ms = cuda_ms(lambda: seq_iir.biquad_seq(x, z, c), 200)
        plain_ms = cuda_ms(lambda: seq_iir.biquad_seq_reference(x, z, c), 10)
        log(f"K1 time at lanes={lanes} F=128: kernel {ms:.4f} ms on the device "
            f"({KERNEL_REPS} launches, torch.profiler), {call_ms:.4f} ms a call "
            f"with the wrapper's host work (CUDA events), plain {plain_ms:.4f} ms")
        times[lanes] = ms, call_ms, plain_ms
    return worst, *times[2 * B]


# phase 3(b): the kernels of the adpcm4 egress and the mastering bus
# the bound counts K4's and K6's 32-bit integer operations at the f32 rate
# of F32_OPS_PER_S (the data sheet gives no INT32 rate): a lower bound
K4_OPS = 35         # 32-bit integer operations a sample (one step of the encoder)
# K6's operations, each charged where the draw needs it (csrc/noise.cu).
# A sample: its count into the hash (x1 = i + k1, 1 add; x0 is k0, a move,
# since the count's high word is 0), 20 rounds of an add, a rotate (one
# funnel shift) and an XOR (60), five key injections of 2 adds (10), and
# its float (an XOR of the two words, a shift, an OR, and a fused
# multiply-add counted as two: 5).  A lane: its key, the hash of (0,
# sample) under (0, seed) (the parity word 1 XOR, x1 = sample + seed 1
# add, 60, five injections of 3 adds: 77), and its samples' key schedule
# (the parity word, 2 XORs, and the injections' five key-plus-round
# constants, 5 adds: 7), the same for all its samples
K6_SAMPLE_OPS = 76
K6_LANE_OPS = 84
#: f32 operations a sample of each K5 kind (a fused multiply-add counts two)
K5_OPS = {"envelope": 6, "limiter": 5, "gate": 14, "pink": 20}
NOISE_SAMPLE = 2**32 - 128   # the block before the stream clock wraps
#: (lanes, channels, frames) where 3(b) holds K6 bit for bit: the batched
#: bus's draw, the stream's (one instance, 256-frame blocks), the hybrid's
#: at B=1024, ragged small draws (one element a thread: one element; 127
#: and 100 frames; 771 elements, a row past a CTA's 256 threads) and
#: ragged larger ones (runs of 4 and 8 cut by the row's end, rows that
#: start off 16 bytes: 4-byte stores)
K6_SHAPES = ((B, 2, 128), (1, 2, 256), (1024, 2, 128), (3, 1, 1), (5, 2, 127),
             (33, 2, 100), (2, 3, 257), (1024, 2, 127), (300, 3, 257), (4200, 2, 127))
#: where 3(b) times K6: the batched bus's draw and the stream's
K6_TIMED = ((B, 2, 128), (1, 2, 256))


def once_ms(fn) -> float:
    """One call of ``fn`` timed by the host clock between two synchronizes
    (for plain versions of thousands of small launches)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


#: K5's kinds by name (``ops/dynamics.py``'s kind codes are attributes there)
K5_KINDS = ("envelope", "limiter", "gate", "pink")
#: (lanes, frames) where 3(b) holds K5 bit for bit, each kind: the batched
#: bus (the dynamics' B lanes, the pink filter's B x 2 channels), the
#: streams' 1 and 2 lanes at 256 frames, a ragged warp at 127 frames (the
#: 4-byte copies) and rows longer than the ring of stages
K5_SHAPES = ((B, 128), (2 * B, 128), (1, 256), (2, 256), (3, 127), (33, 4096))
#: where 3(b) times K5: each kind at its main path's lanes and the streams'
K5_TIMED = ((B, 128), (1, 256), (2, 256))
#: K4 beside the fleet's chunk: ragged batches, S not a multiple of the
#: kernel's 64-sample stage, 1, 3 and 33 channels
K4_SHAPES = ((3, 8, 2), (5, 136, 1), (33, 512, 2), (9, 1000, 2), (4, 72, 3), (2, 200, 33))


def k5_lanes(kind: str, lanes: int) -> int:
    """The pink filter runs two lanes an instance (its stereo channels)."""
    return 2 * lanes if kind == "pink" and lanes == B else lanes


def scan_operands(dynamics, kind: str, lanes: int, gen, frames: int = 128,
                  form: str = "lane"):
    """``(kind code, x, carry, coefs)`` for K5 at ``f32[lanes, frames]``:
    levels, gains or white noise and each kind's state and coefficients on
    the card, the coefficients per lane (``form="lane"``), numbers, 0-d
    tensors, or one an instance of two lanes (``"broadcast"``: x
    ``[lanes / 2, 2, frames]``, coefficients ``[lanes / 2, 1]`` read in
    place); the pink's poles per lane or as one ``[lanes, 3]`` state
    (``"stacked"``, the node's)."""
    dev = torch.device("cuda")
    lead = (lanes // 2, 2) if form == "broadcast" else (lanes,)

    def u(lo, hi, shape=lead):
        return (lo + (hi - lo) * torch.rand(shape, generator=gen)).to(dev)

    def coef(lo, hi):
        if form == "number":
            return float(lo + (hi - lo) * torch.rand((), generator=gen))
        if form == "zero_d":
            return u(lo, hi, ())
        if form == "broadcast":
            return u(lo, hi, (lanes // 2, 1))
        return u(lo, hi)

    x = lambda lo, hi: u(lo, hi, lead + (frames,))  # noqa: E731
    if kind == "envelope":
        return dynamics.ENVELOPE, x(0.0, 1.0), (u(0.0, 1.0),), (coef(0.99, 0.999),
                                                                coef(0.999, 0.99999))
    if kind == "limiter":
        return dynamics.LIMITER, x(0.2, 1.0), (u(0.2, 1.0),), (coef(0.999, 0.9999),)
    if kind == "gate":
        carry = ((torch.rand(lead, generator=gen) < 0.5).float().to(dev),
                 torch.randint(0, 60, lead, generator=gen).float().to(dev),
                 u(0.0, 1.0))
        coefs = (coef(0.02, 0.05), coef(0.005, 0.02), coef(0.0, 0.5), coef(0.9, 0.99),
                 coef(0.999, 0.9999), 48.0 if form == "number" else
                 torch.full(lead, 48.0, device=dev))
        return dynamics.GATE, x(0.0, 0.06), carry, coefs
    carry = (u(-20.0, 20.0, lead + (3,)) if form == "stacked"
             else tuple(u(-20.0, 20.0) for _ in range(3)))
    return dynamics.PINK, x(-1.0, 1.0), carry, ()


def k6_work(lanes: int, per_lane: int):
    """Bytes and operations K6 must do for ``lanes`` rows of ``per_lane``
    samples: the f32 output written and the int64 seeds read; a sample's
    hash and float, a lane's key hash and key schedule."""
    n = lanes * per_lane
    return 4 * n + 8 * lanes, K6_SAMPLE_OPS * n + K6_LANE_OPS * lanes


def k5_work(x, carry, coefs):
    """Bytes K5 must move: x read and y written, the carry in and out, the
    per-lane coefficients (a number or a 0-d tensor read once)."""
    lanes = x.numel() // x.shape[-1]
    n_carry = carry.shape[-1] if isinstance(carry, torch.Tensor) else len(carry)
    per_lane = sum(isinstance(c, torch.Tensor) and c.numel() > 1 for c in coefs)
    return 4 * (2 * x.numel() + lanes * (2 * n_carry + per_lane))


def check_new_kernels(adpcm_device, dynamics, noise):
    """Phase 3(b): K4, K5 (each of its four step kinds) and K6 against their
    plain versions on the card, bit for bit (tolerance 0.0: integer-exact,
    or the same fused multiply-adds): K4 at the fleet's chunk and at
    K4_SHAPES, K5 at K5_SHAPES with the coefficients per lane, and at its
    main shapes also as numbers, 0-d tensors and broadcast views, and the
    pink's poles as one state read in place; each one's device time
    (``torch.profiler``), a call's (CUDA events), the plain version's, and
    its work at the main shapes (K5 also at the streams') → ``{name: (err,
    ms, call_ms, plain_ms, (bytes, ops))}``, K5's other timed shapes under
    ``"sample_scan_at"`` by label, K6's under ``"noise_uniform_at"``."""
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(4321)
    res = {}

    # K4 at the adpcm4 fleet's chunk (B=8192, S=K·128=4096, stereo), one
    # instance saturating the step index at both ends; and ragged cases
    s = K * 128
    pcm = (torch.randn((B, s, 2), generator=gen) * 6000).clamp(-32768, 32767)
    pcm = pcm.to(torch.int16)
    pcm[0, : s // 2] = -32768
    pcm[0, s // 2:] = 32767
    pcm = pcm.to(dev)
    for shape in K4_SHAPES:
        x = (torch.randn(shape, generator=gen) * 9000).clamp(-32768, 32767)
        x = x.to(torch.int16).to(dev)
        if not torch.equal(adpcm_device.encode_ima_chunk(x),
                           adpcm_device.encode_ima_chunk_reference(x)):
            raise AssertionError(f"K4 disagrees with its plain version at {shape}")
    rows = adpcm_device.encode_ima_chunk(pcm)
    ref = {}
    plain_ms = once_ms(lambda: ref.setdefault(
        "rows", adpcm_device.encode_ima_chunk_reference(pcm)))
    if not torch.equal(rows, ref["rows"]):
        bad = int((rows != ref["rows"]).sum())
        raise AssertionError(f"K4 disagrees with its plain version: {bad} bytes")
    ms = device_ms(lambda: adpcm_device.encode_ima_chunk(pcm), "adpcm_encode",
                   KERNEL_REPS)
    call_ms = cuda_ms(lambda: adpcm_device.encode_ima_chunk(pcm), 20)
    work = (pcm.numel() * 2 + rows.numel(), K4_OPS * pcm.numel())
    log(f"K4 vs plain at int16{tuple(pcm.shape)} → uint8{tuple(rows.shape)}: bit "
        f"for bit (and at {list(K4_SHAPES)}); kernel {ms:.4f} ms on the device, "
        f"{call_ms:.4f} ms a call, plain {plain_ms:.1f} ms (one call); serial "
        f"chain {ms / s * 1e6:.2f} ns a sample")
    res["adpcm_encode"] = (0.0, ms, call_ms, plain_ms, work)
    del pcm, rows, ref

    # K5: each kind at K5_SHAPES, carry and output bit for bit; at the main
    # shapes each form of operand
    def check(code, kind, x, carry, coefs, label):
        (c_k, y_k), (c_r, y_r) = (fn(code, x, carry, coefs) for fn in
                                  (dynamics.scan_lanes, dynamics.scan_reference))
        torch.cuda.synchronize()
        c_k, c_r = ((c,) if isinstance(c, torch.Tensor) else c for c in (c_k, c_r))
        if not (torch.equal(y_k, y_r) and all(map(torch.equal, c_k, c_r))):
            e = float((y_k - y_r).abs().max())
            raise AssertionError(f"K5 ({kind}, {label}) disagrees with its plain "
                                 f"version: {e}")

    cases = 0
    for kind in K5_KINDS:
        for lanes, n in K5_SHAPES:
            if lanes in (B, 2 * B) and lanes != k5_lanes(kind, B):
                continue  # the pink at 2B lanes, the others at B
            forms = (("lane", "stacked") if kind == "pink" else
                     ("lane", "number", "zero_d", "broadcast") if lanes >= B else ("lane",))
            for form in forms:
                code, x, carry, coefs = scan_operands(dynamics, kind, lanes, gen, n, form)
                check(code, kind, x, carry, coefs, f"f32[{lanes}, {n}], {form}")
                cases += 1
    log(f"K5 vs plain: bit for bit in {cases} cases, each kind at "
        f"{[list(sh) for sh in K5_SHAPES]} (the pink at {2 * B} lanes, the others at "
        f"{B}), coefficients per lane, as numbers, 0-d tensors and broadcast views, "
        f"the pink's poles in place")
    times = {}
    for kind in K5_KINDS:
        for lanes, n in K5_TIMED:
            lanes = k5_lanes(kind, lanes)
            code, x, carry, coefs = scan_operands(dynamics, kind, lanes, gen, n)
            ms = device_ms(lambda: dynamics.scan_lanes(code, x, carry, coefs),
                           "sample_scan", KERNEL_REPS)
            call_ms = cuda_ms(lambda: dynamics.scan_lanes(code, x, carry, coefs), 50)
            plain_ms = cuda_ms(lambda: dynamics.scan_reference(code, x, carry, coefs), 1)
            work = (k5_work(x, carry, coefs), K5_OPS[kind] * x.numel())
            times[f"{kind} f32[{lanes}, {n}]"] = (0.0, ms, call_ms, plain_ms, work)
            b_ms = bound(*work)[0]
            log(f"K5 {kind} at f32[{lanes}, {n}]: kernel {ms:.4f} ms on the device, "
                f"{call_ms:.4f} ms a call, plain {plain_ms:.2f} ms; bound {b_ms:.4f} ms "
                f"by bytes ({work[0] / 1e6:.3f} MB), {100 * b_ms / ms:.1f}% of it")
    res["sample_scan"] = times[f"pink f32[{2 * B}, 128]"]
    res["sample_scan_at"] = times

    # K6 at K6_SHAPES, the block before the clock wraps and the first after it
    def k6_seeds(lanes):
        return torch.randint(0, 2**32, (lanes,), generator=gen, dtype=torch.int64).to(dev)

    for lanes, ch, f in K6_SHAPES:
        seeds = k6_seeds(lanes)
        for sample in (NOISE_SAMPLE, 0):
            at = torch.tensor(sample, dtype=torch.int64, device=dev)
            got = noise.noise_uniform(seeds, at, ch, f)
            want = noise.noise_uniform_reference(seeds, at, ch, f)
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"K6 disagrees with its plain version at "
                                     f"[{lanes}, {ch}, {f}], stream sample {sample}")
    log(f"K6 vs plain: bit for bit at {[list(sh) for sh in K6_SHAPES]}, stream "
        f"samples {NOISE_SAMPLE} and 0")
    at = torch.tensor(NOISE_SAMPLE, dtype=torch.int64, device=dev)
    times = {}
    for lanes, ch, f in K6_TIMED:
        seeds = k6_seeds(lanes)
        ms = device_ms(lambda: noise.noise_uniform(seeds, at, ch, f), "noise_uniform",
                       KERNEL_REPS)
        call_ms = cuda_ms(lambda: noise.noise_uniform(seeds, at, ch, f), 50)
        plain_ms = cuda_ms(lambda: noise.noise_uniform_reference(seeds, at, ch, f), 3)
        work = k6_work(lanes, ch * f)
        times[f"f32[{lanes}, {ch}, {f}]"] = (0.0, ms, call_ms, plain_ms, work)
        b_ms, b_by = bound(*work)
        log(f"K6 at f32[{lanes}, {ch}, {f}]: kernel {ms:.4f} ms on the device, "
            f"{call_ms:.4f} ms a call, plain {plain_ms:.2f} ms; bound {b_ms:.4f} ms by "
            f"{b_by} ({work[0] / 1e6:.3f} MB, {work[1] / 1e9:.4f} G operations), "
            f"{100 * b_ms / ms:.1f}% of it")
    res["noise_uniform"] = times[f"f32[{B}, 2, 128]"]
    res["noise_uniform_at"] = times
    return res


# phase 3(c): K7, the associative scans (csrc/assoc_scan.cu)
#: (rows, frames): the eager effects filter and the batched EQ band (B x 2
#: channels, 128 frames), the mastering bus's meter (256-frame blocks), the
#: streams' stereo rows (128- and 256-frame blocks), a stream's 1024-frame
#: dispatch of one instance, the register kernels' other lengths (32, 64),
#: and lengths the shared design runs (512, 1, 3, 127)
SCAN_SHAPES = ((2 * B, 128), (2 * B, 256), (2, 128), (2, 256), (2, 1024), (1000, 32),
               (1000, 64), (1000, 512), (1000, 1), (1000, 3), (1000, 127))
#: rows past a CTA's shared memory (the biquad's levels past 9686 frames, the
#: one-pole's past 29 057 keep to a device-memory workspace): a stream's
#: stereo block of 16 384 frames, the same for every instance of the batch,
#: and 32 768 frames, where the one-pole's levels leave shared memory too
LONG_SCAN_SHAPES = ((2, 16384), (2 * B, 16384), (2, 32768))
#: the one-pole's rows in spatial-b8192-k32: 128 spatializers pooled over
#: B instances (nodes/spatial.py), 128 frames
POOLED_ONE_POLE = (128 * B, 128)
#: (rows, frames, sections) of biquad_cascade: the batched EQ's three bands
#: and the bus's K-weighting (two), the streams' rows, ragged and long rows
#: (the shared design, the intermediate outputs in the workspace), and more
#: sections than a launch takes (two launches)
CASCADE_SHAPES = ((2 * B, 128, 3), (2 * B, 128, 2), (2, 128, 3), (2, 256, 2),
                  (1000, 127, 3), (2, 1024, 2), (2, 16384, 2), (2, 128, 9))
#: where 3(c) times K7: (kind, rows, frames, sections)
SCAN_TIMED = (("biquad", 2 * B, 128, 1), ("one_pole", 2 * B, 128, 1),
              ("one_pole", *POOLED_ONE_POLE, 1), ("biquad", 2, 128, 1),
              ("one_pole", 2, 128, 1), ("biquad", 2, 256, 1), ("one_pole", 2, 256, 1),
              ("cascade", 2 * B, 128, 3), ("cascade", 2 * B, 128, 2),
              ("cascade", 2, 128, 3), ("cascade", 2, 256, 2))
#: and the rows past shared memory (the shared design, three launches each)
SCAN_TIMED_LONG = (("biquad", 2 * B, 16384, 1), ("one_pole", 2 * B, 16384, 1))
#: K7's kernels by name in a profile (both designs of each entry)
K7_KERNEL = {"biquad": "biquad_scan_kernel", "cascade": "biquad_scan_kernel",
             "one_pole": "one_pole_scan_kernel"}


def scan_composes(n: int):
    """``(up, down)``: the compositions ``lax.associative_scan``'s recursion
    makes over ``n`` elements, up-sweep and down-sweep (level 0's included)."""
    up = down = 0
    while n >= 2:
        up += n // 2
        down += (n - 1) // 2
        n //= 2
    return up, down


def scan_work(kind: str, rows: int, n: int, sections: int = 1):
    """``(bytes, f32 ops, f64 ops)`` of one K7 call over ``rows`` rows of
    ``n`` frames: x read and y written once, the per-row coefficients and
    state; a biquad composition is 20 f32 operations, a leaf 2, the carry 8
    and the output 2 a frame, each section; a one-pole composition 1 f32 and
    2 f64 (its fused multiply-add in float64), a leaf 1 f32, the carry 2 f64
    a frame."""
    composes = sum(scan_composes(n))
    if kind in ("biquad", "cascade"):
        return (4 * rows * (2 * n + sections * (5 + 4)),
                sections * rows * (20 * composes + 12 * n), 0)
    return (4 * rows * (2 * n + 2 + 2), rows * (composes + n),
            rows * (2 * composes + 2 * n))


def k7_operands(iir, kind: str, rows: int, n: int, gen, sections: int = 1):
    """``(fn, ref, args)`` for K7's ``kind`` (``biquad``, ``cascade`` of
    ``sections``, ``one_pole``) at f32[rows, n] on the card: a different
    filter a row (lowpasses 200 Hz–20 kHz, the EQ's 150 Hz low shelf and
    the meter's 38 Hz high-pass in turn, each section its own; one-poles b
    in [0.05, 0.999)) and state or carry in."""
    dev = torch.device("cuda")
    x = torch.randn((rows, n), generator=gen).to(dev)
    if kind == "one_pole":
        b = (0.05 + 0.949 * torch.rand((rows, 1), generator=gen)).to(dev)
        y0 = torch.randn((rows,), generator=gen).to(dev)
        return iir.one_pole_scan, iir.one_pole_scan_reference, (x, y0, 1.0 - b, b)

    def section(s):
        kinds = (torch.arange(rows) + s) % 3
        freq = torch.where(kinds == 0, 200.0 + 19800.0 * torch.rand(rows, generator=gen),
                           torch.where(kinds == 1, 150.0, 38.0))
        q = torch.where(kinds == 0, 0.5 + 3.5 * torch.rand(rows, generator=gen),
                        torch.full((rows,), 0.8))
        lp = iir.biquad_lowpass(freq, q, 48000)
        ls = iir.biquad_low_shelf(freq, q, torch.full((rows,), 4.0), 48000)
        hp = iir.biquad_highpass(freq, q, 48000)
        c = iir.BiquadCoeffs(*(torch.where(kinds == 0, a, torch.where(kinds == 1, b, h))
                               .to(dev) for a, b, h in zip(lp, ls, hp)))
        z = tuple(0.1 * torch.randn((rows,), generator=gen).to(dev) for _ in range(2))
        return c, z

    if kind == "biquad":
        c, z = section(0)
        return iir.biquad_scan, iir.biquad_scan_reference, (x, z, c)
    cs, zs = zip(*(section(s) for s in range(sections)))
    return iir.biquad_cascade, iir.biquad_cascade_reference, (x, zs, cs)


def k7_label(kind: str, rows: int, n: int, sections: int = 1) -> str:
    return f"{kind} f32[{rows}, {n}]" + (f" S={sections}" if kind == "cascade" else "")


def check_assoc_scan(iir):
    """Phase 3(c): K7's entry points (``biquad_scan``, ``one_pole_scan``,
    ``biquad_cascade``) against their plain versions on the card, bit for
    bit (tolerance 0.0: the same compositions rounded the same way), at the
    callers' shapes and ragged lengths (both designs: the tree in registers
    for 32, 64, 128 and 256 frames, the shared one otherwise), at rows
    longer than a CTA's shared memory holds, at the spatializers' pooled
    rows, and the DC blocker's scalar coefficients; at SCAN_TIMED each
    one's device time (``torch.profiler``), a call's (CUDA events), the
    plain version's and its work → ``{label: (err, ms, call_ms, plain_ms,
    work)}`` (``k7_label``), f32[16384, 16384] included."""
    gen = torch.Generator(device="cpu").manual_seed(77)
    timed = set(SCAN_TIMED + SCAN_TIMED_LONG)
    cases = [(kind, rows, n, 1) for kind in ("biquad", "one_pole")
             for rows, n in SCAN_SHAPES + LONG_SCAN_SHAPES]
    cases += [("one_pole", *POOLED_ONE_POLE, 1)]
    cases += [("cascade", rows, n, s) for rows, n, s in CASCADE_SHAPES]
    flat = lambda t: [t] if isinstance(t, torch.Tensor) else [  # noqa: E731
        u for v in t for u in flat(v)]
    res = {}
    for kind, rows, n, s in cases:
        fn, ref, args = k7_operands(iir, kind, rows, n, gen, s)
        got, want = fn(*args), ref(*args)
        torch.cuda.synchronize()
        label = k7_label(kind, rows, n, s)
        if not all(map(torch.equal, flat(got), flat(want))):
            e = max(float((a - b).abs().max()) for a, b in zip(flat(got), flat(want)))
            raise AssertionError(f"K7 {label} disagrees with its plain version: {e}")
        del got, want
        if (kind, rows, n, s) in timed:
            # the biquad's workspace takes 6.4 GB at f32[16384, 16384]
            reps = 3 if n > 1024 else KERNEL_REPS
            ms = device_ms(lambda: fn(*args), K7_KERNEL[kind], reps)
            call_ms = cuda_ms(lambda: fn(*args), reps if n > 1024 else 50)
            plain_ms = cuda_ms(lambda: ref(*args), 1)
            work = scan_work(kind, rows, n, s)
            res[label] = (0.0, ms, call_ms, plain_ms, work)
            b_ms, b_by = bound(*work)
            log(f"K7 {label}: kernel {ms:.4f} ms on the device, {call_ms:.4f} ms a "
                f"call, plain {plain_ms:.3f} ms; bound {b_ms:.4f} ms by {b_by} "
                f"({work[0] / 1e6:.2f} MB, {work[1] / 1e6:.1f} M f32 and "
                f"{work[2] / 1e6:.1f} M f64 operations), {100 * b_ms / ms:.1f}% of it")
        del args
        torch.cuda.empty_cache()
    # the DC blocker's numbers: a = 1, b = R
    x = torch.randn((2 * B, 128), generator=gen).to("cuda")
    y0 = torch.randn((2 * B,), generator=gen).to("cuda")
    got = iir.one_pole_scan(x, y0, 1.0, 0.9973857)
    want = iir.one_pole_scan_reference(x, y0, 1.0, 0.9973857)
    if not all(map(torch.equal, got, want)):
        raise AssertionError("K7 one_pole_scan disagrees at scalar coefficients")
    log(f"K7 vs plain: bit for bit at {len(cases) + 1} shapes: biquad_scan and "
        f"one_pole_scan at f32{[list(s) for s in SCAN_SHAPES + LONG_SCAN_SHAPES]}, "
        f"one_pole_scan at f32{list(POOLED_ONE_POLE)} and with scalar coefficients, "
        f"biquad_cascade at (rows, frames, sections) {list(CASCADE_SHAPES)}")
    return res


def render_mixer(ft, seq_iir, card: str):
    """Phase 4: the 64-node mixer at B x K on the card."""
    from firewheel_tpu_torch.convert import tree_map

    prog = ft.mixer_graph(filter_backend="pallas", device="cuda")
    n_nodes = len(prog.schedule.schedule)
    if n_nodes != 64:
        raise AssertionError(f"mixer has {n_nodes} nodes, expected 64")
    br = ft.BatchRenderer(prog, B, device="cuda")
    # a different cutoff per instance, so the kernel runs per-lane filters
    params = mixer_params(br)
    state = br.init_state()

    cpu_prog = ft.mixer_graph(filter_backend="pallas", device="cpu")
    cpu_br = ft.BatchRenderer(cpu_prog, CHECK_INSTANCES, device="cpu")
    cpu_params = tree_map(lambda t: t[:CHECK_INSTANCES].cpu(), params)
    cpu_state = tree_map(lambda t: t[:CHECK_INSTANCES].cpu(), state)

    worst = 0.0

    def compare(tag, out, cpu_out):
        nonlocal worst
        e = float((out[:CHECK_INSTANCES].cpu() - cpu_out).abs().max())
        worst = max(worst, e)
        if not e <= SLICE_TOL:
            raise AssertionError(f"{tag}: card vs CPU max_abs_err {e}")

    sample = 0
    # warm-up chunk (allocator, kernel load), checked like the others
    out, om, state = br.render_chunk(params, state, start_sample=sample,
                                     num_blocks=K)
    cpu_out, cpu_om, cpu_state = cpu_br.render_chunk(
        cpu_params, cpu_state, start_sample=sample, num_blocks=K)
    compare("warm-up chunk", out, cpu_out)
    sample += K * prog.max_block_frames

    seq_iir.biquad_seq.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    outs = []
    t0 = time.perf_counter()
    for _ in range(TIMED_CHUNKS):
        out, om, state = br.render_chunk(params, state, start_sample=sample,
                                         num_blocks=K)
        outs.append((out, om, sample))
        sample += K * prog.max_block_frames
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / TIMED_CHUNKS
    launches = seq_iir.biquad_seq.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    if launches != K * TIMED_CHUNKS:
        raise AssertionError(
            f"K1 launched {launches} times in {TIMED_CHUNKS} chunks of K={K}"
        )
    for out, om, start in outs:
        if tuple(out.shape) != (B, K, prog.num_graph_outputs,
                                prog.max_block_frames):
            raise AssertionError(f"output shape {tuple(out.shape)}")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError("non-finite output")
        cpu_out, cpu_om, cpu_state = cpu_br.render_chunk(
            cpu_params, cpu_state, start_sample=start, num_blocks=K)
        compare(f"chunk at sample {start}", out, cpu_out)
        if not torch.equal(om[:CHECK_INSTANCES].cpu(), cpu_om):
            raise AssertionError("silence masks differ between card and CPU")
    final = tree_map(lambda t: t[:CHECK_INSTANCES].cpu(), state)

    e = tree_err(final, cpu_state)
    if not e <= SLICE_TOL:
        raise AssertionError(f"final state differs: {e}")
    peak = float(out.abs().max())
    if not 0.01 < peak <= 1.0:
        raise AssertionError(f"output peak {peak} outside (0.01, 1]")

    audio_secs = B * K * prog.max_block_frames / prog.sample_rate
    log(f"mixer: {n_nodes} nodes, B={B}, K={K}, {TIMED_CHUNKS} timed chunks "
        f"on {card}")
    log(f"mixer: card vs CPU plain path (first {CHECK_INSTANCES} instances, "
        f"{TIMED_CHUNKS + 1} chunks and final state): max_abs_err={worst:.3e}")
    log(f"mixer: wall per chunk {wall * 1e3:.3f} ms, realtime factor "
        f"{audio_secs / wall:.1f}, peak device memory {peak_gb:.3f} GB, "
        f"K1 launches {launches} ({launches // TIMED_CHUNKS} per chunk)")
    return launches, wall


def mixer_params(renderer, rows: slice = slice(0, B)):
    """The mixer's params with a different cutoff per instance (phase 4's),
    for the global ``rows`` the renderer holds (a meshed renderer's
    ``local_rows``)."""
    params = renderer.stack_params()
    fkey = next(k for k in params if k.startswith("filter"))
    params[fkey]["freq"] = 8000.0 - 100.0 * (
        torch.arange(B, device="cuda")[rows] % 64
    ).to(torch.float32)
    return params


def render_mega(ft, seq_iir, em, card: str):
    """Phase 5: the megakernel on the mixer at B x K, against the eager
    BatchRenderer on the card and the CPU plain version."""
    from firewheel_tpu_torch.convert import tree_map

    prog = ft.mixer_graph(filter_backend="pallas", device="cuda")
    mega = em.MegaRenderer(prog, B, K, device="cuda")
    eager = ft.BatchRenderer(prog, B, device="cuda")
    params = mixer_params(mega)
    state0 = mega.init_state()
    frames = prog.max_block_frames
    lw = mega.lowered
    smem = em.shared_bytes(lw, mega.tile)
    lib = em.LIBRARY.load()
    kernel_smem = lib.fw_mega_shared_bytes(*em.shared_sizes(lw, mega.tile))
    if kernel_smem != smem:
        raise AssertionError(f"shared memory: the wrapper counts {smem} B, the "
                             f"kernel {kernel_smem} B")
    log(f"megakernel: {len(lw.keys)} rows, {len(lw.leaves)} leaves in "
        f"{lw.num_words} words, {lw.num_buffers} buffers, {smem} B shared "
        f"memory per CTA of {mega.tile} instance(s) (the kernel's count too)")

    worst = 0.0

    def agree(tag, mo, mm, ms, eo, emk, es):
        nonlocal worst
        out_e, state_e = float((mo - eo).abs().max()), tree_err(ms, es)
        e = max(out_e, state_e)
        if not torch.equal(mm, emk):
            raise AssertionError(f"{tag}: masks differ between megakernel and eager")
        if not e <= MEGA_TOL:
            raise AssertionError(f"{tag}: megakernel vs eager max_abs_err {e}")
        log(f"megakernel vs eager, {tag}: outputs {out_e:.3e}, state {state_e:.3e}")
        worst = max(worst, e)

    # warm-up chunk (kernel load, allocator), checked like the others
    m_out, m_mask, m_state = mega.render_chunk(params, state0, 0)
    e_out, e_mask, e_state = eager.render_chunk(params, state0, start_sample=0,
                                                num_blocks=K)
    torch.cuda.synchronize()
    agree("warm-up chunk", m_out, m_mask, m_state, e_out, e_mask, e_state)
    warm = (m_out, m_mask, m_state)
    starts = [(c + 1) * K * frames for c in range(TIMED_CHUNKS)]

    # the main path: the megakernel only, counts set to 0 just before
    em.MegaRenderer.launches = 0
    seq_iir.biquad_seq.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m_runs = []
    for start in starts:
        m_out, m_mask, m_state = mega.render_chunk(params, m_state, start)
        m_runs.append((m_out, m_mask, m_state))
    torch.cuda.synchronize()
    mega_wall = (time.perf_counter() - t0) / TIMED_CHUNKS
    launches = em.MegaRenderer.launches
    k1_launches = seq_iir.biquad_seq.launches
    if launches != TIMED_CHUNKS:
        raise AssertionError(f"megakernel launched {launches} times in "
                             f"{TIMED_CHUNKS} chunks")
    if k1_launches != 0:
        raise AssertionError(f"K1 launched {k1_launches} times inside "
                             "megakernel chunks")

    # the plain version at full size: the eager BatchRenderer on the card
    t0 = time.perf_counter()
    e_runs = []
    for start in starts:
        e_out, e_mask, e_state = eager.render_chunk(
            params, e_state, start_sample=start, num_blocks=K)
        e_runs.append((e_out, e_mask, e_state))
    torch.cuda.synchronize()
    eager_wall = (time.perf_counter() - t0) / TIMED_CHUNKS
    for start, m, e in zip(starts, m_runs, e_runs):
        agree(f"chunk at sample {start}", *m, *e)
        if not bool(torch.isfinite(m[0]).all()):
            raise AssertionError("non-finite megakernel output")
    peak = float(m_runs[-1][0].abs().max())
    if not 0.01 < peak <= 1.0:
        raise AssertionError(f"megakernel output peak {peak} outside (0.01, 1]")

    # K2's device time, and its work for the bound
    def k2_chunk():
        return mega.render_chunk(params, m_runs[-2][2], starts[-1])

    k2_ms = device_ms(k2_chunk, "mega_kernel", KERNEL_REPS)
    k2_call_ms = cuda_ms(k2_chunk, KERNEL_REPS)
    out, masks = m_runs[-1][0], m_runs[-1][1]
    work = kernel_work(em, prog, lw, params, m_runs[-2][2], B, K,
                       out.nbytes + masks.nbytes)

    # mid-stream handoff: eager chunk 1 → megakernel chunk 2 == eager, eager
    h_out, h_mask, h_state = mega.render_chunk(params, e_runs[0][2], starts[1])
    torch.cuda.synchronize()
    agree("handoff eager → megakernel", h_out, h_mask, h_state, *e_runs[1])
    log(f"megakernel: handoff eager chunk → megakernel chunk matches two "
        f"eager chunks")

    # the first instances against the CPU plain version
    cpu_prog = ft.mixer_graph(filter_backend="pallas", device="cpu")
    cpu_mega = em.MegaRenderer(cpu_prog, CHECK_INSTANCES, K, device="cpu")
    cpu_params = tree_map(lambda t: t[:CHECK_INSTANCES].cpu(), params)
    cpu_state = tree_map(lambda t: t[:CHECK_INSTANCES].cpu(), state0)
    cpu_worst = 0.0
    for start, (m_out, m_mask, m_state) in zip([0] + starts, [warm] + m_runs):
        c_out, c_mask, cpu_state = cpu_mega.render_chunk(cpu_params, cpu_state,
                                                         start)
        e = float((m_out[:CHECK_INSTANCES].cpu() - c_out).abs().max())
        if not e <= SLICE_TOL or not torch.equal(m_mask[:CHECK_INSTANCES].cpu(),
                                                 c_mask):
            raise AssertionError(f"megakernel vs CPU plain version at sample "
                                 f"{start}: max_abs_err {e} or masks differ")
        cpu_worst = max(cpu_worst, e)
    e = tree_err(tree_map(lambda t: t[:CHECK_INSTANCES], m_runs[-1][2]), cpu_state)
    if not e <= SLICE_TOL:
        raise AssertionError(f"megakernel final state vs CPU: {e}")
    cpu_worst = max(cpu_worst, e)

    audio_secs = B * K * frames / prog.sample_rate
    log(f"megakernel vs eager on the card ({TIMED_CHUNKS + 2} chunks, outputs, "
        f"masks and every state leaf): max_abs_err={worst:.3e}")
    log(f"megakernel vs CPU plain version (first {CHECK_INSTANCES} instances, "
        f"{TIMED_CHUNKS + 1} chunks and final state): max_abs_err={cpu_worst:.3e}")
    log(f"megakernel: launches {launches} in {TIMED_CHUNKS} chunks, K1 launches "
        f"{k1_launches}")
    log(f"mixer B={B} K={K} on {card}: megakernel wall per chunk "
        f"{mega_wall * 1e3:.3f} ms (realtime factor {audio_secs / mega_wall:.1f}); "
        f"eager {eager_wall * 1e3:.3f} ms (realtime factor "
        f"{audio_secs / eager_wall:.1f})")
    log(f"megakernel: K2 {k2_ms:.4f} ms on the device a chunk "
        f"({KERNEL_REPS} launches, torch.profiler), {k2_call_ms:.4f} ms a call "
        f"(CUDA events); {work[0] / 1e9:.3f} GB to move, {work[1] / 1e9:.2f} G "
        f"f32 operations")
    return launches, worst, k2_ms, k2_call_ms, eager_wall * 1e3, work


def check_random_graphs(ft, em):
    """Phase 6: the megakernel against its plain version on the card, on
    seeded random graphs, over chunks in which every pan and volume
    smoother ramps from its new per-instance value, settles and rests."""
    from firewheel_tpu_torch.mixer import random_graph, vary_params

    worst = 0.0
    for seed, frames in RANDOM_GRAPHS:
        k = RANDOM_CHUNK_FRAMES // frames
        prog = random_graph(seed, device="cuda", block_frames=frames)
        mega = em.MegaRenderer(prog, RANDOM_B, k, device="cuda")
        smem = em.shared_bytes(mega.lowered, mega.tile)
        if em.LIBRARY.load().fw_mega_shared_bytes(
                *em.shared_sizes(mega.lowered, mega.tile)) != smem:
            raise AssertionError(f"random graph {seed}, F={frames}: the wrapper's "
                                 f"{smem} B of shared memory is not the kernel's")
        params = vary_params(mega.stack_params(), seed)
        ms = rs = mega.init_state()
        statuses = []
        for c in range(RANDOM_CHUNKS):
            start = c * k * frames
            mo, mm, ms = mega.render_chunk(params, ms, start)
            ro, rm, rs = em.mega_chunk_reference(
                prog, mega.lowered, params, rs, start, k, RANDOM_B)
            torch.cuda.synchronize()
            out_e = float((mo - ro).abs().max())
            state_e = tree_err(ms, rs)
            e = max(out_e, state_e)
            if not torch.equal(mm, rm) or not e <= MEGA_TOL:
                raise AssertionError(
                    f"random graph {seed}, chunk {c}: megakernel vs plain "
                    f"max_abs_err {e}, masks equal {torch.equal(mm, rm)}")
            worst = max(worst, e)
            statuses.append(smoother_statuses(ms))
        # ramping after the first chunk, all at rest after the last
        if not bool((statuses[0] == 1).any()) or bool(statuses[-1].any()):
            raise AssertionError(f"random graph {seed}: smoother statuses "
                                 f"{statuses[0].tolist()} → {statuses[-1].tolist()}")
        log(f"random graph {seed}, F={frames}, K={k}: "
            f"{len(prog.schedule.schedule)} nodes, "
            f"{prog.schedule.num_buffers} buffers, megakernel vs plain version "
            f"on the card: outputs {out_e:.3e}, state {state_e:.3e} (last chunk), "
            f"masks equal; smoothers ramping after chunk 0: "
            f"{int((statuses[0] == 1).sum())} of {statuses[0].numel()}, at rest "
            f"after chunk {RANDOM_CHUNKS - 1}")
    log(f"random graphs {RANDOM_GRAPHS} (seed, F) at B={RANDOM_B}: "
        f"max_abs_err={worst:.3e}")
    return worst


def smoother_statuses(state):
    """Every pan and volume smoother's status in ``state``, flattened."""
    found = [v[name]["status"].reshape(-1) for v in state.values()
             for name in ("gain", "pan") if name in v]
    return torch.cat(found) if found else torch.zeros(0, dtype=torch.int32)


def render_hybrid(ft, seq_iir, em, eh, card: str, b: int, k: int):
    """Phase 7: the effects chain through the hybrid lowering at B x K,
    against the eager BatchRenderer on the card and the CPU plain hybrid;
    K3 against its plain version at the same operands."""
    from firewheel_tpu_torch.convert import tree_map
    from firewheel_tpu_torch.mixer import vary_effects_params

    prog = ft.effects_chain_graph(filter_backend="pallas", device="cuda")
    hybrid = ft.BatchRenderer(prog, b, device="cuda", lowering="hybrid")
    eager = ft.BatchRenderer(prog, b, device="cuda")
    params = vary_effects_params(hybrid.stack_params())
    state0 = hybrid.init_state()
    frames = prog.max_block_frames
    tag = f"hybrid B={b} K={k}"

    worst = 0.0

    def agree(what, ho, hm, hs, eo, emk, es):
        nonlocal worst
        out_e, state_e = float((ho - eo).abs().max()), tree_err(hs, es)
        if not torch.equal(hm, emk):
            raise AssertionError(f"{tag}, {what}: masks differ between hybrid and eager")
        if not max(out_e, state_e) <= HYBRID_TOL:
            raise AssertionError(f"{tag}, {what}: hybrid vs eager outputs {out_e}, "
                                 f"state {state_e}")
        worst = max(worst, out_e, state_e)
        return out_e, state_e

    # warm-up chunk (kernel load, allocator), checked like the others
    h_out, h_mask, h_state = hybrid.render_chunk(params, state0, start_sample=0,
                                                 num_blocks=k)
    e_out, e_mask, e_state = eager.render_chunk(params, state0, start_sample=0,
                                                num_blocks=k)
    torch.cuda.synchronize()
    agree("warm-up chunk", h_out, h_mask, h_state, e_out, e_mask, e_state)
    hy = hybrid._chunk_cache[("hybrid", k)]
    islands = len(hy.islands)
    log(f"{tag}: segments {[kind for kind, _ in hy.segments]}, island rows "
        f"{[list(lw.keys) for lw in hy.islands.values()]}, live-ins "
        f"{[lw.in_bufs.tolist() for lw in hy.islands.values()]}")
    warm = (h_out, h_mask, h_state)
    starts = [(c + 1) * k * frames for c in range(TIMED_CHUNKS)]

    # the main path: hybrid chunks only, counts set to 0 just before
    eh.HybridMegaRenderer.launches = 0
    em.MegaRenderer.launches = 0
    seq_iir.biquad_seq.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    h_runs = []
    for start in starts:
        h_out, h_mask, h_state = hybrid.render_chunk(params, h_state,
                                                     start_sample=start, num_blocks=k)
        h_runs.append((h_out, h_mask, h_state))
    torch.cuda.synchronize()
    h_wall = (time.perf_counter() - t0) / TIMED_CHUNKS
    launches = eh.HybridMegaRenderer.launches
    k1 = seq_iir.biquad_seq.launches
    k2 = em.MegaRenderer.launches
    h_peak = torch.cuda.max_memory_allocated() / 1e9
    if launches != islands * TIMED_CHUNKS:
        raise AssertionError(f"{tag}: K3 launched {launches} times in "
                             f"{TIMED_CHUNKS} chunks of {islands} island(s)")
    if k1 != 0 or k2 != 0:
        raise AssertionError(f"{tag}: K1 launched {k1}, K2 {k2} times in hybrid chunks")

    # the same chunks with the eager BatchRenderer on the card
    from firewheel_tpu_torch.ops import iir

    iir.biquad_cascade.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    e_runs = []
    for start in starts:
        e_out, e_mask, e_state = eager.render_chunk(params, e_state,
                                                    start_sample=start, num_blocks=k)
        e_runs.append((e_out, e_mask, e_state))
    torch.cuda.synchronize()
    e_wall = (time.perf_counter() - t0) / TIMED_CHUNKS
    e_peak = torch.cuda.max_memory_allocated() / 1e9
    e_k7 = iir.biquad_cascade.launches
    for start, h, e in zip(starts, h_runs, e_runs):
        out_e, state_e = agree(f"chunk at sample {start}", *h, *e)
        if not bool(torch.isfinite(h[0]).all()):
            raise AssertionError(f"{tag}: non-finite hybrid output")
    peak = float(h_runs[-1][0].abs().max())
    if not 0.01 < peak <= 4.0:
        raise AssertionError(f"{tag}: output peak {peak} outside (0.01, 4]")
    silent = [float(r[1].float().mean()) for r in h_runs]
    log(f"{tag}: silent share of output channels per chunk {silent}")

    # mid-stream handoff: eager chunk 1 → hybrid chunk 2 == eager, eager
    ho, hm, hs = hybrid.render_chunk(params, e_runs[0][2], start_sample=starts[1],
                                     num_blocks=k)
    torch.cuda.synchronize()
    agree("handoff eager → hybrid", ho, hm, hs, *e_runs[1])

    # the first instances against the CPU plain hybrid
    cpu = ft.BatchRenderer(ft.effects_chain_graph(filter_backend="pallas", device="cpu"),
                           CHECK_INSTANCES, device="cpu", lowering="hybrid")
    cpu_params = tree_map(lambda t: t[:CHECK_INSTANCES].cpu(), params)
    cpu_state = tree_map(lambda t: t[:CHECK_INSTANCES].cpu(), state0)
    cpu_worst = 0.0
    for start, (o, m, _) in zip([0] + starts, [warm] + h_runs):
        c_out, c_mask, cpu_state = cpu.render_chunk(cpu_params, cpu_state,
                                                    start_sample=start, num_blocks=k)
        e = float((o[:CHECK_INSTANCES].cpu() - c_out).abs().max())
        if not e <= SLICE_TOL or not torch.equal(m[:CHECK_INSTANCES].cpu(), c_mask):
            raise AssertionError(f"{tag} vs CPU plain hybrid at sample {start}: "
                                 f"max_abs_err {e} or masks differ")
        cpu_worst = max(cpu_worst, e)
    e = tree_err(tree_map(lambda t: t[:CHECK_INSTANCES], h_runs[-1][2]), cpu_state)
    if not e <= SLICE_TOL:
        raise AssertionError(f"{tag}: final state vs CPU plain hybrid: {e}")
    cpu_worst = max(cpu_worst, e)

    # K3 against its plain version at the same operands (the island's
    # live-ins as the sampler's torch stage makes them at the last start)
    i = next(iter(hy.islands))
    lw = hy.islands[i]
    pseg = {key: params[key] for key in hy._keys[i]}
    sseg = {key: h_runs[-2][2][key] for key in hy._keys[i]}
    rows, flags = {}, {}
    infos = em._chunk_clocks(prog, starts[-1], k, hy.device)
    for j in range(i):
        pj = {key: params[key] for key in hy._keys[j]}
        sj = {key: h_runs[-2][2][key] for key in hy._keys[j]}
        out_j, flags_j, _ = hy._torch_stage(j, pj, sj, rows, flags, infos)
        rows.update(out_j)
        flags.update(flags_j)
    env = torch.stack([rows[j] for j in lw.in_bufs.tolist()], 2).contiguous()
    env_flags = torch.stack([flags[j] for j in lw.in_bufs.tolist()], 2).contiguous()
    ko, kf, ks = hy._launch(i, pseg, sseg, env, env_flags)
    ro, rf, rs = em.island_chunk_reference(prog, lw, pseg, sseg, env, env_flags,
                                           starts[-1], k, b)
    torch.cuda.synchronize()
    k3_err = max(float((ko - ro).abs().max()), tree_err(ks, rs))
    if not torch.equal(kf, rf) or not k3_err <= HYBRID_TOL:
        raise AssertionError(f"{tag}: K3 vs its plain version max_abs_err {k3_err}, "
                             f"flags equal {torch.equal(kf, rf)}")
    silent_in = float(env_flags.float().mean())
    def launch():
        return hy._launch(i, pseg, sseg, env, env_flags)

    log(f"{tag}: K3 {em.shared_bytes(lw, hy.tile)} B shared memory per CTA")
    k3_ms = device_ms(launch, "island_kernel", KERNEL_REPS)
    k3_call_ms = cuda_ms(launch, KERNEL_REPS)
    work = kernel_work(em, prog, lw, pseg, sseg, b, k, env.nbytes + env_flags.nbytes
                       + ko.nbytes + kf.nbytes)
    plain_ms = cuda_ms(lambda: em.island_chunk_reference(
        prog, lw, pseg, sseg, env, env_flags, starts[-1], k, b), 2)

    audio_secs = b * k * frames / prog.sample_rate
    log(f"{tag} vs eager on the card ({TIMED_CHUNKS + 2} chunks, outputs, masks "
        f"and every state leaf): max_abs_err={worst:.3e}")
    log(f"{tag} vs CPU plain hybrid (first {CHECK_INSTANCES} instances, "
        f"{TIMED_CHUNKS + 1} chunks and final state): max_abs_err={cpu_worst:.3e}")
    log(f"{tag}: K3 launches {launches} in {TIMED_CHUNKS} chunks ({islands} "
        f"island), K1 {k1}, K2 {k2}; the eager arm K7 {e_k7} (its filter is K1's "
        f"\"pallas\" backend)")
    log(f"{tag}: K3 vs plain on the card at the same operands (live-ins "
        f"{silent_in:.3f} silent): max_abs_err={k3_err:.3e}, flags equal; "
        f"K3 {k3_ms:.4f} ms on the device ({k3_call_ms:.4f} ms a call with the "
        f"wrapper's host work, CUDA events), plain {plain_ms:.4f} ms a call")
    log(f"effects chain B={b} K={k} on {card}: hybrid wall per chunk "
        f"{h_wall * 1e3:.3f} ms (realtime factor {audio_secs / h_wall:.1f}, peak "
        f"{h_peak:.3f} GB); eager {e_wall * 1e3:.3f} ms (realtime factor "
        f"{audio_secs / e_wall:.1f}, peak {e_peak:.3f} GB)")
    return launches, max(worst, k3_err), k3_ms, k3_call_ms, plain_ms, work


def stream_in_graph(ft):
    """graph_in → volume → pan → clip → out, stereo: stream inputs as the
    island's live-ins."""
    from firewheel_tpu_torch import nodes

    g = ft.AudioGraph(ft.AudioGraphConfig(2, 2))
    vol = g.add_node(2, 2, nodes.VolumeNode(80.0))
    pan = g.add_node(2, 2, nodes.StereoPanNode(0.25))
    clip = g.add_node(2, 2, nodes.HardClipNode(0.0))
    chain = [g.graph_in_node(), vol, pan, clip, g.graph_out_node()]
    for a, b in zip(chain[:-1], chain[1:]):
        for ch in range(2):
            g.connect(a, ch, b, ch)
    pkg = g.compile(48000, 128)
    return ft.ScheduleProgram(pkg.schedule, dict(pkg.new_node_processors), 48000,
                              device="cuda")


def check_hybrid_graphs(ft, em, eh):
    """Phase 8: the hybrid against the eager path on the card, for
    correctness only, on three more graphs."""
    from firewheel_tpu_torch.mixer import (
        effects_chain_config4_graph, vary_effects_params, vary_params,
    )

    b, k = PHASE8_B, PHASE8_K
    gen = torch.Generator(device="cpu").manual_seed(8)
    worst = 0.0
    for name, prog in (("config 4 (FFT reverb)",
                        effects_chain_config4_graph(filter_backend="pallas", device="cuda")),
                       ("stream inputs", stream_in_graph(ft)),
                       ("mixer, one island",
                        ft.mixer_graph(filter_backend="pallas", device="cuda"))):
        hybrid = ft.BatchRenderer(prog, b, device="cuda", lowering="hybrid")
        eager = ft.BatchRenderer(prog, b, device="cuda")
        params = vary_params(vary_effects_params(hybrid.stack_params()), 8)
        hs = es = hybrid.init_state()
        ni = prog.num_graph_inputs
        for c in range(2):
            gi = (0.3 * torch.randn((b, k, ni, 128), generator=gen)).to("cuda")
            im = (torch.rand((b, k, ni), generator=gen) < 0.25).to("cuda")
            gi = gi.masked_fill(im[..., None], 0.0)
            eh.HybridMegaRenderer.launches = 0
            ho, hm, hs = hybrid.render_chunk(params, hs, gi, im,
                                             start_sample=c * k * 128, num_blocks=k)
            launches = eh.HybridMegaRenderer.launches
            eo, emk, es = eager.render_chunk(params, es, gi, im,
                                             start_sample=c * k * 128, num_blocks=k)
            torch.cuda.synchronize()
            islands = len(hybrid._chunk_cache[("hybrid", k)].islands)
            out_e, state_e = float((ho - eo).abs().max()), tree_err(hs, es)
            if (not torch.equal(hm, emk) or not max(out_e, state_e) <= HYBRID_TOL
                    or launches != islands or islands != 1):
                raise AssertionError(
                    f"{name}, chunk {c}: hybrid vs eager outputs {out_e}, state "
                    f"{state_e}, masks equal {torch.equal(hm, emk)}, "
                    f"{launches} K3 launches for {islands} island(s)")
            worst = max(worst, out_e, state_e)
        if not float(ho.abs().max()) > 0.01:
            raise AssertionError(f"{name}: silent output")
        segs = [kind for kind, _ in hybrid._chunk_cache[("hybrid", k)].segments]
        log(f"{name}: segments {segs}, B={b} K={k}, hybrid vs eager on the card: "
            f"outputs {out_e:.3e}, state {state_e:.3e} (last chunk), masks equal")
    log(f"phase 8 graphs at B={b} K={k}: max_abs_err={worst:.3e}")
    return worst


# phase 9: the streaming engine (FirewheelCtx → GraphContext → GraphProcessor)
STREAM_BUFFER = 1024        # frames a stream buffer (the cpal default)
STREAM_BLOCK = 128          # frames a graph block
STREAM_BUFFERS = 94         # ~2 s at 48 kHz; the last buffer is STREAM_TAIL frames
STREAM_TAIL = 1000          # 7 blocks and one of 104 frames
STREAM_VOLUME_AT = 10 * STREAM_BUFFER + 300  # voice 3's volume moves mid-buffer
STREAM_EDIT_AT = 40         # buffer before which voice 0 goes and a voice comes
STREAM_TOL = 1e-5           # the card's stream vs the CPU's (PERF.md §2)
PROFILED_BUFFERS = 4
EFFECTS_BUFFERS = 47        # ~1 s
REALTIME_SECS = 2.0


def stream_mixer(ft, device, chunk_buffers=1, deferred=False, buffers=STREAM_BUFFERS,
                 profile_from=None):
    """The 64-node mixer streamed offline through ``FirewheelCtx`` on
    ``device``: 1024-frame buffers of 128-frame blocks, ``chunk_buffers``
    buffers a pump, the last buffer 1000 frames (a partial block), voice 3's
    volume scheduled at a sample inside buffer 10, and before buffer
    ``STREAM_EDIT_AT`` voice 0 dropped and a voice added at its sum inputs
    (installed at once, or staged with ``deferred``).  With
    ``profile_from``, ``torch.profiler`` traces ``PROFILED_BUFFERS`` pumps
    from that buffer.  Returns a dict of the audio, the final state on the
    CPU, the wall of each pump, the stream's stats, the K1 launches, and a
    surviving voice's state and the pending flag just after the edit's
    pump."""
    from firewheel_tpu_torch.convert import tree_map
    from firewheel_tpu_torch.mixer import add_mixer, add_voice
    from firewheel_tpu_torch.ops import seq_iir

    cx = ft.FirewheelCtx(device=device)
    g = cx.graph_mut()
    s, voices = add_mixer(g, 19, "pallas")
    g.node(voices[3][1]).set_percent_volume(30.0, at_sample=STREAM_VOLUME_AT)
    frames = (buffers - 1) * STREAM_BUFFER + STREAM_TAIL
    sink = ft.ArraySink()
    cfg = ft.StreamConfig(buffer_frames=STREAM_BUFFER, block_frames=STREAM_BLOCK,
                          chunk_buffers=chunk_buffers, deferred_swap=deferred)
    cx.activate(cfg, sink=sink, duration_secs=(frames + 0.5) / 48000)
    stream, proc = cx.stream, cx.stream._processor
    survivor = [ft.node_key(nid) for nid in voices[5]]
    out = {"walls": [], "pending": []}
    trace = PumpTrace()
    seq_iir.biquad_seq.launches = 0
    t_start = time.perf_counter()
    i = 0
    while stream.frames_rendered < frames:
        if i == STREAM_EDIT_AT:
            for nid in voices[0]:
                g.remove_node(nid)
            voices[0] = add_voice(g, s, 0, 19)
        if i == profile_from:
            trace.start()
        trace.pump(cx, cfg.chunk_buffers, out["walls"])  # ships the edit's schedule
        i += cfg.chunk_buffers
        if trace.on and i == profile_from + PROFILED_BUFFERS * cfg.chunk_buffers:
            out["profile"], out["profile_wall"] = trace.stop(stream)
        if i == STREAM_EDIT_AT + cfg.chunk_buffers:
            out["survivor"] = {k: tree_map(lambda t: t.cpu(), proc.state_dict()[k])
                               for k in survivor}
        if i > STREAM_EDIT_AT:
            out["pending"].append(proc.has_pending())
    stream.flush()
    if device != "cpu":
        torch.cuda.synchronize()
    out["wall"] = time.perf_counter() - t_start
    out["k1"] = seq_iir.biquad_seq.launches
    out["state"] = tree_map(lambda t: t.cpu(), proc.state_dict())
    out["stats"] = stream.stats()
    out["audio"] = sink.audio(2)
    cx.deactivate()
    if out["audio"].shape != (2, frames):
        raise AssertionError(f"stream rendered {out['audio'].shape}, expected "
                             f"{(2, frames)}")
    return out


def stream_effects(ft, device):
    """The effects chain (``mixer.add_effects_chain``, filter on K1)
    streamed offline for ~1 s: the sampler's one-shot replays from sample
    12 077, stops at 14 405, plays at 24 011 and seeks to 0.1 s at 26 400,
    each on its block through the per-block timelines."""
    from firewheel_tpu_torch.convert import tree_map
    from firewheel_tpu_torch.mixer import add_effects_chain, effects_chain_audio

    cx = ft.FirewheelCtx(device=device)
    g = cx.graph_mut()
    sn = g.node(add_effects_chain(g, *effects_chain_audio(), 0.01, "pallas"))
    sn.play(at_sample=12077)
    sn.stop(at_sample=14405)
    sn.play(at_sample=24011)
    sn.set_playhead(0.1, at_sample=26400)
    sink = ft.ArraySink()
    cx.activate(ft.StreamConfig(buffer_frames=STREAM_BUFFER, block_frames=STREAM_BLOCK),
                sink=sink)
    for _ in range(EFFECTS_BUFFERS):
        cx.update(max_pump_buffers=0)
        cx.stream.pump(1)
    cx.stream.flush()
    state = tree_map(lambda t: t.cpu(), cx.stream._processor.state_dict())
    events = [(e.name, e.count, e.total) for e in cx.poll_events()]
    audio = sink.audio(2)
    cx.deactivate()
    return audio, state, events


def stream_counts(prof, buffers: int, blocks: int):
    """``(kernels a block, launch calls a block, host→device copies a
    dispatch, device→host copies a dispatch, device busy microseconds, K1's
    device microseconds)`` from a profile of ``buffers`` one-buffer
    dispatches of ``blocks`` blocks each: kernels and copies as the device
    ran them, launch calls as the host made them, K1's time as each of its
    launches in the stream took it."""
    h2d = d2h = 0
    k1 = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if "biquad_seq_kernel" in e.name:
                k1.append(e.time_range.elapsed_us())
            if "Memcpy HtoD" in e.name:
                h2d += 1
            elif "Memcpy DtoH" in e.name:
                d2h += 1
    n = buffers * blocks
    if len(k1) != n:
        # a profile minutes into the script may lose launches (see
        # ``device_ms``): then K1's stream time is not read from it
        log(f"stream: the profile saw {len(k1)} K1 launches in {n} blocks; K1 "
            f"is timed at the stream's width by ``device_ms`` instead")
        k1 = []
    per_block, calls, busy = profile_busy(prof, n)
    return per_block, calls, h2d / buffers, d2h / buffers, busy, k1


def profile_busy(prof, blocks: int):
    """``(kernels a block, launch calls a block, device busy microseconds)``
    from a profile of ``blocks`` blocks: kernels as the device ran them
    (copies and memsets left out), launch calls as the host made them."""
    kernels = calls = 0
    busy = 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy += e.time_range.elapsed_us()
            if not e.name.startswith(("Memcpy", "Memset")):
                kernels += 1
        elif e.name in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"):
            calls += 1
    return kernels / blocks, calls / blocks, busy


class PumpTrace:
    """``torch.profiler`` over a run of a stream's pumps: ``start()`` before
    the first pump it traces, ``stop(stream)`` after the last (the stream
    flushed and the card synchronised) returns the profile and the run's
    wall; ``pump(cx, n, walls)`` updates the graph and times one pump of
    ``n`` buffers into ``walls``."""

    def __init__(self):
        self.prof = None

    @property
    def on(self) -> bool:
        return self.prof is not None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile as tprofile

        torch.cuda.synchronize()
        self.prof = tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self, stream):
        stream.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        prof, self.prof = self.prof, None
        return prof, wall

    @staticmethod
    def pump(cx, n: int, walls: list) -> None:
        cx.update(max_pump_buffers=0)
        t0 = time.perf_counter()
        cx.stream.pump(n)
        walls.append(time.perf_counter() - t0)


def check_stream(ft, seq_iir, em, eh, card: str):
    """Phase 9: the streaming engine on the card, against the same streams
    on the CPU; its numbers."""
    # 9.1 the beep test: examples.beep_test's graph, 2 s offline
    from firewheel_tpu_torch.examples import beep_test

    cx = ft.FirewheelCtx(device="cuda")
    beep_test.add_beep(cx.graph_mut())
    sink = ft.ArraySink()
    cx.activate(ft.StreamConfig(), sink=sink)
    cx.render_offline(2.0)
    cx.deactivate()
    audio = sink.audio(2)
    peak_hz = float(np.argmax(np.abs(np.fft.rfft(audio[0])))) * 48000 / audio.shape[1]
    amp = float(np.abs(audio).max())
    if abs(peak_hz - 440.0) > 1.0 or abs(amp - 0.2512) > 1e-4:
        raise AssertionError(f"beep test: peak at {peak_hz} Hz, amplitude {amp}")
    log(f"stream, beep test on the card: {audio.shape[1]} frames, FFT peak "
        f"{peak_hz:.2f} Hz, peak amplitude {amp:.6f}")

    # 9.2 the mixer on the card (one buffer a pump, and eight) and the CPU
    cpu = stream_mixer(ft, "cpu")
    em.MegaRenderer.launches = eh.HybridMegaRenderer.launches = 0
    runs = {"chunk 1": stream_mixer(ft, "cuda"),
            "chunk 8": stream_mixer(ft, "cuda", chunk_buffers=8)}
    if em.MegaRenderer.launches or eh.HybridMegaRenderer.launches:
        raise AssertionError("the stream launched K2 or K3")
    blocks = (STREAM_BUFFERS - 1) * STREAM_BUFFER // STREAM_BLOCK + (
        -(-STREAM_TAIL // STREAM_BLOCK))
    worst = 0.0
    for tag, run in runs.items():
        e = float(np.abs(run["audio"] - cpu["audio"]).max())
        state_e = tree_err(run["state"], cpu["state"])
        if not ((run["audio"] == 0) == (cpu["audio"] == 0)).all():
            raise AssertionError(f"stream {tag}: silent samples differ from the CPU's")
        if not max(e, state_e) <= STREAM_TOL:
            raise AssertionError(f"stream {tag} vs CPU: audio {e}, state {state_e}")
        if run["k1"] != blocks:
            raise AssertionError(f"stream {tag}: K1 launched {run['k1']} times for "
                                 f"{blocks} blocks")
        worst = max(worst, e, state_e)
        log(f"stream, mixer {tag} on the card vs the CPU ({STREAM_BUFFERS} buffers, "
            f"{blocks} blocks, volume at sample {STREAM_VOLUME_AT}, edit before "
            f"buffer {STREAM_EDIT_AT}, last buffer {STREAM_TAIL} frames): audio "
            f"{e:.3e}, final state {state_e:.3e}, silent samples equal; K1 "
            f"launches {run['k1']} (one a block)")
    peak = float(np.abs(cpu["audio"]).max())
    if not 0.01 < peak <= 1.0 or not np.isfinite(runs["chunk 1"]["audio"]).all():
        raise AssertionError(f"stream output peak {peak}")

    # 9.3 the same edit staged (deferred swap)
    d = stream_mixer(ft, "cuda", deferred=True, buffers=STREAM_EDIT_AT + 8)
    installed = d["pending"].index(False) if False in d["pending"] else None
    per_buffer = np.abs(d["audio"][:, :(STREAM_EDIT_AT + 7) * STREAM_BUFFER]).reshape(
        2, -1, STREAM_BUFFER).max(axis=(0, 2))
    if installed is None or installed > 2:
        raise AssertionError(f"deferred swap: pending after the edit {d['pending'][:8]}")
    if not np.isfinite(d["audio"]).all() or not (per_buffer > 0.01).all():
        raise AssertionError("deferred swap: NaN or a silent buffer in the stream")
    mig = tree_err(d["survivor"], runs["chunk 1"]["survivor"])
    if mig != 0.0:
        raise AssertionError(f"deferred swap: a surviving voice's state differs from "
                             f"the immediate swap's by {mig}")
    log(f"stream, deferred swap: installed {installed} pump(s) after the edit's, "
        f"every buffer audible (quietest peak {per_buffer.min():.4f}), no NaN; "
        f"voice 5's state just after the swap equals the immediate swap's")

    # 9.4 the effects chain (the sampler's timelines), card vs CPU
    ea, es, ev = stream_effects(ft, "cuda")
    ca, cs, cv = stream_effects(ft, "cpu")
    e_fx = max(float(np.abs(ea - ca).max()), tree_err(es, cs))
    if not e_fx <= STREAM_TOL or ev != cv or float(np.abs(ea).max()) < 0.01:
        raise AssertionError(f"effects stream vs CPU: {e_fx}, events {ev} vs {cv}")
    log(f"stream, effects chain on the card vs the CPU ({EFFECTS_BUFFERS} buffers, "
        f"scheduled play/stop/play/seek): max_abs_err={e_fx:.3e}, events {ev}")

    # 9.5 the numbers
    t = runs["chunk 1"]
    audio_secs = t["audio"].shape[1] / 48000
    walls = np.asarray(t["walls"][1:-1]) * 1e3  # whole 1024-frame buffers
    log(f"stream, mixer on {card}: {audio_secs:.3f} s of audio in {t['wall']:.3f} s, "
        f"realtime factor {audio_secs / t['wall']:.3f}; wall a 1024-frame buffer "
        f"(a pump, pipelined) p50 {np.percentile(walls, 50):.3f} ms, p99 "
        f"{np.percentile(walls, 99):.3f} ms (budget 21.333 ms); the stream's host "
        f"time a buffer p50 {t['stats']['render_ms_p50']:.3f} ms, p99 "
        f"{t['stats']['render_ms_p99']:.3f} ms")
    c8 = runs["chunk 8"]
    log(f"stream, mixer on {card}, 8 buffers a pump: realtime factor "
        f"{c8['audio'].shape[1] / 48000 / c8['wall']:.3f}")
    p = stream_mixer(ft, "cuda", buffers=12, profile_from=4)
    per_block, calls, h2d, d2h, busy, k1_us = stream_counts(
        p["profile"], PROFILED_BUFFERS, STREAM_BUFFER // STREAM_BLOCK)
    top = sorted(p["profile"].key_averages(), key=lambda e: -e.self_cpu_time_total)[:8]
    log("stream, host time by op in the profile (self CPU ms, calls): " + "; ".join(
        f"{e.key} {e.self_cpu_time_total / 1e3:.1f} ms {e.count}" for e in top))
    log(f"stream, torch.profiler over {PROFILED_BUFFERS} pumps on {card}: "
        f"{per_block:.1f} kernels a block on the device ({calls:.1f} launch calls "
        f"a block on the host), {h2d:.1f} host→device and "
        f"{d2h:.1f} device→host copies a dispatch, device busy "
        f"{busy / 1e3:.3f} ms of {p['profile_wall'] * 1e3:.3f} ms "
        f"({100 * busy / 1e6 / p['profile_wall']:.1f}%)")

    # K1 at the stream's width, 2 lanes (one instance, stereo): its device
    # time in the profiled stream, and a call and its plain version here
    gen = torch.Generator(device="cpu").manual_seed(9)
    x = torch.randn((2, STREAM_BLOCK), generator=gen).to("cuda")
    z = tuple(torch.zeros(2, device="cuda") for _ in range(2))
    from firewheel_tpu_torch.ops import iir

    c = iir.biquad_lowpass(torch.full((1,), 8000.0, device="cuda"),
                           torch.full((1,), 0.7071, device="cuda"), 48000)
    y, _ = seq_iir.biquad_seq(x, z, c)
    yr, _ = seq_iir.biquad_seq_reference(x, z, c)
    torch.cuda.synchronize()
    k1_err = float((y - yr).abs().max())
    if not k1_err <= KERNEL_TOL:
        raise AssertionError(f"K1 at 2 lanes vs plain: {k1_err}")
    if k1_us:
        k1_ms = float(np.mean(k1_us)) / 1e3
    else:
        k1_ms = device_ms(lambda: seq_iir.biquad_seq(x, z, c), "biquad", 200)
        k1_us = [k1_ms * 1e3]
    k1_call = cuda_ms(lambda: seq_iir.biquad_seq(x, z, c), 200)
    k1_plain = cuda_ms(lambda: seq_iir.biquad_seq_reference(x, z, c), 10)
    k1_bound, k1_by = bound(4 * 2 * (2 * STREAM_BLOCK + 5 + 2 * 2), 9 * 2 * STREAM_BLOCK)
    log(f"stream: K1 at 2 lanes, F={STREAM_BLOCK} on {card}: {k1_ms * 1e3:.3f} us on "
        f"the device (mean of its {len(k1_us)} launches in the profiled stream, "
        f"{min(k1_us):.3f}–{max(k1_us):.3f} us), {k1_call:.4f} ms a call "
        f"(CUDA events), plain {k1_plain:.4f} ms, bound {k1_bound * 1e3:.5f} us by "
        f"{k1_by}; vs plain max_abs_err={k1_err:.3e}")

    # underflows on the paced native consumer, realtime, into an ArraySink
    cx = ft.FirewheelCtx(device="cuda")
    from firewheel_tpu_torch.mixer import add_mixer
    add_mixer(cx.graph_mut(), 19, "pallas")
    sink = ft.ArraySink()
    cx.activate(ft.StreamConfig(buffer_frames=STREAM_BUFFER, block_frames=STREAM_BLOCK,
                                realtime=True), sink=sink)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < REALTIME_SECS:
        cx.update()
        time.sleep(0.001)
    rt = cx.stream.stats()
    cx.deactivate()
    if rt.get("consumer") != "native":
        raise AssertionError(f"realtime stream on the {rt.get('consumer')} consumer")
    log(f"stream, realtime {REALTIME_SECS} s on the native paced consumer on {card}: "
        f"{rt['consumer_underflows']} underflows in {rt['consumer_periods']} periods "
        f"(a measurement, not a failure), {rt['underflow_count']} seen by the "
        f"stream, {sink.audio(2).shape[1]} frames to the sink, render p50 "
        f"{rt.get('render_ms_p50', float('nan')):.3f} ms, p99 "
        f"{rt.get('render_ms_p99', float('nan')):.3f} ms a buffer")
    return max(worst, e_fx), t["k1"], (k1_ms, k1_call, k1_plain, k1_bound)


# phase 10: the serving fleet (SessionServer over BatchRenderer)
SERVE_CAPACITY, SERVE_K = B, K   # the README's headline batch
SERVE_SESSIONS = 1024            # live sessions; the other slots stay vacant
SERVE_CHUNKS = 8                 # chunks through render_fetched, then flush
SERVE_CHECK = 16                 # slots held against a CPU SessionServer
SERVE_RECONNECT = (3, 7, 12)     # slots below SERVE_CHECK disconnected, reconnected
EGRESS_CHUNKS = 4                # chunks a render_stream measurement
CKPT_SMALL = 64                  # capacity of the card → CPU restore
FX_CAPACITY, FX_K, FX_SESSIONS, FX_CHUNKS = 1024, 8, 1000, 6
CKPT_STREAM_AT, CKPT_STREAM_END = 20, 40   # buffers: save at 20, go on to 40


def scratch_dir(prefix: str) -> str:
    """A fresh directory for checkpoints under the package's gitignored
    build directory, inside the checkout."""
    import tempfile

    from firewheel_tpu_torch.ops.cuda_build import BUILD_DIR

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return tempfile.mkdtemp(prefix=prefix, dir=BUILD_DIR)


def mixer_template(ft, device):
    """The 64-node mixer (filter on K1) as a SessionServer template, idle:
    every voice's volume at 0.  Returns the program and each voice's
    (volume, pan) node."""
    from firewheel_tpu_torch.mixer import SR as MIX_SR, add_mixer

    g = ft.AudioGraph(ft.AudioGraphConfig(0, 2))
    _, voices = add_mixer(g, 19, "pallas")
    handles = [(g.node(v), g.node(p)) for _, v, p in voices]
    for vol, _ in handles:
        vol.set_percent_volume(0.0)
    pkg = g.compile(MIX_SR, 128)
    prog = ft.ScheduleProgram(pkg.schedule, dict(pkg.new_node_processors), MIX_SR,
                              device=device)
    return prog, handles


def mixer_session(handles, i: int):
    """Session ``i``'s configure (the slot it gets, for the first sessions):
    every voice's volume and pan from ``i``; one session in four loud
    enough to clip at the 0 dB clip, the others too quiet to."""
    def configure():
        for v, (vol, pan) in enumerate(handles):
            vol.set_percent_volume(100.0 if i % 4 == 0 else 15.0 + (i * 7 + v * 13) % 20)
            pan.set_pan(((i + 3 * v) % 21) / 10.0 - 1.0)
    return configure


def events_of(srv) -> list:
    """``srv.poll_events()`` as sorted (slot, node, event, count, total, lane)."""
    return sorted((h.slot, repr(e.node_id), e.name, e.count, e.total, e.lane)
                  for h, es in srv.poll_events().items() for e in es)


def lsb_off(a: np.ndarray, b: np.ndarray) -> int:
    """Samples of two pcm16 arrays 1 LSB apart; raises if any are further."""
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    if d.size and d.max() > 1:
        raise AssertionError(f"pcm16 differs by {d.max()} LSB")
    return int((d == 1).sum())


def serve_mixer(ft, seq_iir, em, eh, card: str):
    """10(a): the mixer fleet at capacity 8192, K=32, pcm16, eager with K1;
    1024 sessions; slots 0..15 against a CPU SessionServer of capacity 16
    that runs the same operations in the same order."""
    cap, k = SERVE_CAPACITY, SERVE_K
    prog, handles = mixer_template(ft, "cuda")
    srv = ft.SessionServer(prog, cap, chunk_blocks=k, device="cuda",
                           output_format="pcm16")
    cprog, chandles = mixer_template(ft, "cpu")
    cpu = ft.SessionServer(cprog, SERVE_CHECK, chunk_blocks=k, device="cpu",
                           output_format="pcm16")
    fleets = ((srv, handles, {}), (cpu, chandles, {}))
    t0 = time.perf_counter()
    for i in range(SERVE_SESSIONS):
        for s, hs, live in fleets:
            h = s.connect(mixer_session(hs, i))
            if h is not None:
                live[h.slot] = h
    torch.cuda.synchronize()
    connect_s = time.perf_counter() - t0
    if (sorted(fleets[0][2]) != list(range(SERVE_SESSIONS))
            or sorted(fleets[1][2]) != list(range(SERVE_CHECK))):
        raise AssertionError("slot assignment is not deterministic")

    def drive(s, hs, live):
        """The operations: SERVE_CHUNKS chunks through render_fetched and a
        flush; a poll; the reconnects; two chunks more with a poll between
        two render_fetched calls (the first chunk in flight) and one after
        the flush.  Returns the shipped chunks, the polls and the polls'
        milliseconds."""
        outs = [s.render_fetched() for _ in range(SERVE_CHUNKS)][1:] + [s.flush()]
        t = time.perf_counter()
        polls = [events_of(s)]
        ms = [(time.perf_counter() - t) * 1e3]
        for slot in SERVE_RECONNECT:
            s.disconnect(live.pop(slot))
        for j in range(len(SERVE_RECONNECT)):
            h = s.connect(mixer_session(hs, SERVE_SESSIONS + j))
            live[h.slot] = h
        if s.render_fetched() is not None:
            raise AssertionError("render_fetched after a flush returned a chunk")
        t = time.perf_counter()
        polls.append(events_of(s))
        ms.append((time.perf_counter() - t) * 1e3)
        outs += [s.render_fetched(), s.flush()]
        polls.append(events_of(s))
        return outs, polls, ms

    # the main path, counts set to 0 just before it
    seq_iir.biquad_seq.launches = 0
    em.MegaRenderer.launches = eh.HybridMegaRenderer.launches = 0
    t0 = time.perf_counter()
    card_out, ev, poll_ms = drive(*fleets[0])
    wall = (time.perf_counter() - t0) / (SERVE_CHUNKS + 2)
    k1 = seq_iir.biquad_seq.launches
    chunks = SERVE_CHUNKS + 2
    if k1 != k * chunks or em.MegaRenderer.launches or eh.HybridMegaRenderer.launches:
        raise AssertionError(f"serving: K1 launched {k1} times in {chunks} chunks of "
                             f"K={k}, K2 {em.MegaRenderer.launches}, K3 "
                             f"{eh.HybridMegaRenderer.launches}")
    if sorted(fleets[0][2]) != list(range(SERVE_SESSIONS)):
        raise AssertionError(f"reconnects did not reuse slots {SERVE_RECONNECT}")
    cpu_out, cpu_ev, _ = drive(*fleets[1])

    off = 0
    for c, (a, b) in enumerate(zip(card_out, cpu_out, strict=True)):
        if a.shape != (cap, k, 128, 2) or a.dtype != np.int16:
            raise AssertionError(f"shipped chunk {c}: {a.dtype}{a.shape}")
        off += lsb_off(a[:SERVE_CHECK], b)
        if np.any(a[SERVE_SESSIONS:]):
            raise AssertionError(f"chunk {c}: a vacant slot is not silent")
    ev_check = [[e for e in poll if e[0] < SERVE_CHECK] for poll in ev]
    clipped = sum(e[3] for poll in ev_check for e in poll)
    if ev_check != cpu_ev or not clipped:
        raise AssertionError(f"events differ or none: card {ev_check[0][:6]}..., "
                             f"CPU {cpu_ev[0][:6]}...")
    loud = int(np.abs(card_out[-1][:SERVE_SESSIONS].astype(np.int32)).max())
    if loud < 16000:
        raise AssertionError(f"fleet output peak {loud} LSB")
    n_cmp = SERVE_CHECK * k * 128 * 2 * len(card_out)
    audio_secs = cap * k * 128 / 48000
    log(f"serving 10(a), mixer fleet on {card}: capacity {cap}, K={k}, pcm16, "
        f"{SERVE_SESSIONS} sessions connected in {connect_s:.3f} s (with the CPU "
        f"fleet's); {len(card_out)} chunks shipped through render_fetched/flush, "
        f"slots {SERVE_RECONNECT} disconnected and reconnected after chunk "
        f"{SERVE_CHUNKS}")
    log(f"serving 10(a): slots 0..{SERVE_CHECK - 1} vs the CPU SessionServer: "
        f"{off} of {n_cmp} samples 1 LSB apart, none further; vacant slots "
        f"{SERVE_SESSIONS}..{cap - 1} all zero; clip events of the compared slots "
        f"equal in all {len(ev)} polls ({clipped} clipped samples; "
        f"{sum(len(p) for p in ev)} events in the fleet); K1 {k1} launches "
        f"({k1 // chunks} a chunk), K2 and K3 none")
    log(f"serving 10(a): wall per chunk through render_fetched {wall * 1e3:.3f} ms "
        f"(realtime factor of the shipped audio {audio_secs / wall:.1f}); a poll "
        f"with nothing in flight {poll_ms[0]:.3f} ms, between two render_fetched "
        f"calls (it waits for the chunk in flight) {poll_ms[1]:.3f} ms")
    return srv, k1, off


def serve_egress(srv, card: str):
    """10(b): render_stream at capacity 8192, pcm16, against render_chunk and
    a plain ``.cpu()``, chunk by chunk; the walls with and without egress."""
    br, k = srv._br, SERVE_K
    params, state0, s0 = srv._params, srv._state, srv.sample
    ref, state, s = [], state0, s0
    for _ in range(EGRESS_CHUNKS):
        out, _, state = br.render_chunk(params, state, start_sample=s, num_blocks=k)
        ref.append(out.cpu().numpy())
        s += k * 128
    def bare():
        """The same chunks back to back with no egress, one synchronize at
        the end: the host enqueues chunk t+1 while the card renders chunk
        t, as in render_stream."""
        st, at = state0, s0
        for _ in range(EGRESS_CHUNKS):
            _, _, st = br.render_chunk(params, st, start_sample=at, num_blocks=k)
            at += k * 128

    def shipped():
        br.render_stream(params, state0, num_chunks=EGRESS_CHUNKS, num_blocks=k,
                         start_sample=s0, on_chunk=lambda x: None)

    # bare, shipped, shipped, bare: the eager host's drift over the four
    # runs falls on both arms alike
    walls = {bare: [], shipped: []}
    for fn in (bare, shipped, shipped, bare):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls[fn].append((time.perf_counter() - t0) / EGRESS_CHUNKS)
    wall_bare, wall_egress = (sum(walls[f]) / 2 for f in (bare, shipped))
    seen = []

    def check(x):
        if not np.array_equal(x, ref[len(seen)]):
            raise AssertionError(f"render_stream chunk {len(seen)} differs from "
                                 "render_chunk + .cpu()")
        seen.append(x.nbytes)

    _, _, end = br.render_stream(params, state0, num_chunks=EGRESS_CHUNKS,
                                 num_blocks=k, start_sample=s0, on_chunk=check)
    if len(seen) != EGRESS_CHUNKS or end != s:
        raise AssertionError(f"render_stream delivered {len(seen)} chunks")
    # one chunk's copy to pinned host memory alone, by CUDA events
    out = torch.from_numpy(ref[0]).to("cuda")
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    copy_ms = cuda_ms(lambda: host.copy_(out, non_blocking=True), 5)
    nbytes = seen[0]
    f32_bytes = nbytes * 2
    audio_secs = SERVE_CAPACITY * k * 128 / 48000
    log(f"serving 10(b), render_stream on {card}: {EGRESS_CHUNKS} chunks equal to "
        f"render_chunk + .cpu() bit for bit; {nbytes / 1e6:.1f} MB shipped a chunk "
        f"as pcm16 ({f32_bytes / 1e6:.1f} MB as f32); one chunk's copy to pinned "
        f"memory alone {copy_ms:.3f} ms ({nbytes / copy_ms / 1e6:.2f} GB/s)")
    ms = {f.__name__: " and ".join(f"{w * 1e3:.3f}" for w in walls[f])
          for f in walls}
    log(f"serving 10(b): wall per chunk with egress {wall_egress * 1e3:.3f} ms "
        f"({ms['shipped']}), without (render back to back + synchronize) "
        f"{wall_bare * 1e3:.3f} ms ({ms['bare']}), run bare, shipped, shipped, "
        f"bare; the fetch leaves {(wall_egress - wall_bare) * 1e3:.3f} ms a chunk "
        f"exposed; egress {nbytes / wall_egress / 1e9:.3f} GB/s of wall; realtime "
        f"factor of the shipped audio {audio_secs / wall_egress:.1f}")


def serve_checkpoint(ft, srv, card: str):
    """10(c): a fleet checkpoint mid-stream at capacity 8192 restored into a
    fresh server, bit for bit; at capacity 64 saved on the card, restored on
    the CPU."""
    import shutil

    root = scratch_dir("ckpt_")
    try:
        path = os.path.join(root, "fleet")
        t0 = time.perf_counter()
        nbytes = srv.save_checkpoint(path)
        save_s = time.perf_counter() - t0
        truth = [srv.render() for _ in range(2)]
        prog, _ = mixer_template(ft, "cuda")
        fresh = ft.SessionServer(prog, SERVE_CAPACITY, chunk_blocks=SERVE_K,
                                 device="cuda", output_format="pcm16")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handles = fresh.restore_checkpoint(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        got = [fresh.render() for _ in range(2)]
        if not all(torch.equal(a, b) for a, b in zip(truth, got)):
            raise AssertionError("the restored fleet's chunks differ from the "
                                 "uninterrupted fleet's")
        if sorted(handles) != sorted(srv._live) or fresh.sample != srv.sample:
            raise AssertionError("the restored fleet's sessions or clock differ")
        del fresh, truth, got
        log(f"serving 10(c), fleet checkpoint on {card}: capacity "
            f"{SERVE_CAPACITY}, {len(handles)} sessions; {nbytes / 1e9:.3f} GB "
            f"written in {save_s:.3f} s, restored into a fresh server in "
            f"{load_s:.3f} s; the next 2 chunks equal the uninterrupted fleet's "
            f"bit for bit")

        # capacity 64, f32: saved on the card, restored on the CPU
        sprog, sh = mixer_template(ft, "cuda")
        small = ft.SessionServer(sprog, CKPT_SMALL, chunk_blocks=SERVE_K,
                                 device="cuda")
        for i in range(CKPT_SMALL // 2):
            small.connect(mixer_session(sh, i))
        small.render()
        path = os.path.join(root, "small")
        small.save_checkpoint(path)
        want = small.render().cpu()
        cprog, _ = mixer_template(ft, "cpu")
        cpu = ft.SessionServer(cprog, CKPT_SMALL, chunk_blocks=SERVE_K, device="cpu")
        cpu.restore_checkpoint(path)
        e = float((cpu.render() - want).abs().max())
        if not e <= SLICE_TOL or not float(want.abs().max()) > 0.05:
            raise AssertionError(f"card checkpoint restored on the CPU: {e}")
        log(f"serving 10(c): capacity {CKPT_SMALL} saved on the card, restored on "
            f"the CPU: the next chunk max_abs_err={e:.3e} against the card's")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return nbytes, save_s, load_s


def fx_template(ft, device):
    """The effects chain (sampler → filter (K1's recurrence) → echo → clip →
    reverb) as a SessionServer template, its sampler paused."""
    from firewheel_tpu_torch.mixer import add_effects_chain, effects_chain_audio

    g = ft.AudioGraph(ft.AudioGraphConfig(0, 2))
    sn = g.node(add_effects_chain(g, *effects_chain_audio(), 0.01, "pallas"))
    sn.pause()
    pkg = g.compile(48000, 128)
    prog = ft.ScheduleProgram(pkg.schedule, dict(pkg.new_node_processors), 48000,
                              device=device)
    return prog, sn


def fx_session(sn, i: int):
    """Session ``i``: rate 0.75 + 0.25·(i mod 6); a loop over the clip for
    even i, a one-shot from frame 1024·(i mod 8) for odd i."""
    from firewheel_tpu_torch.nodes import LoopRange

    def configure():
        sn.set_playback_rate(0.75 + 0.25 * (i % 6))
        if i % 2 == 0:
            sn.set_loop_range(LoopRange.FULL)
        else:
            sn.set_playhead(1024 * (i % 8) / 48000)
        sn.play()
    return configure


def serve_hybrid(ft, seq_iir, em, eh, card: str):
    """10(d): the effects chain fleet on the hybrid lowering, pcm16, with
    per-slot rates and loops; slots 0..15 against a CPU fleet."""
    cap, k = FX_CAPACITY, FX_K
    prog, sn = fx_template(ft, "cuda")
    srv = ft.SessionServer(prog, cap, chunk_blocks=k, device="cuda",
                           lowering="hybrid", output_format="pcm16")
    cprog, csn = fx_template(ft, "cpu")
    cpu = ft.SessionServer(cprog, SERVE_CHECK, chunk_blocks=k, device="cpu",
                           lowering="hybrid", output_format="pcm16")
    for i in range(FX_SESSIONS):
        srv.connect(fx_session(sn, i))
        cpu.connect(fx_session(csn, i))
    eh.HybridMegaRenderer.launches = em.MegaRenderer.launches = 0
    seq_iir.biquad_seq.launches = 0
    t0 = time.perf_counter()
    outs = [srv.render_fetched() for _ in range(FX_CHUNKS)][1:] + [srv.flush()]
    wall = (time.perf_counter() - t0) / FX_CHUNKS
    k3, k1, k2 = (eh.HybridMegaRenderer.launches, seq_iir.biquad_seq.launches,
                  em.MegaRenderer.launches)
    ev = events_of(srv)
    cpu_outs = [cpu.render_fetched() for _ in range(FX_CHUNKS)][1:] + [cpu.flush()]
    cpu_ev = events_of(cpu)
    if k3 != FX_CHUNKS or k1 or k2:
        raise AssertionError(f"hybrid fleet: K3 {k3} launches in {FX_CHUNKS} chunks, "
                             f"K1 {k1}, K2 {k2}")
    off = 0
    for c, (a, b) in enumerate(zip(outs, cpu_outs, strict=True)):
        off += lsb_off(a[:SERVE_CHECK], b)
        if np.any(a[FX_SESSIONS:]):
            raise AssertionError(f"hybrid fleet chunk {c}: a vacant slot is not silent")
    def sampler_events(events, slots):
        return [e for e in events if e[0] < slots and e[2] in ("finished", "loop")]

    mine = sampler_events(ev, SERVE_CHECK)
    names = {e[2] for e in mine}
    if mine != sampler_events(cpu_ev, SERVE_CHECK) or names != {"finished", "loop"}:
        raise AssertionError(f"hybrid fleet events: card {mine[:6]}, CPU {cpu_ev[:6]}")
    audio_secs = cap * k * 128 / 48000
    log(f"serving 10(d), effects chain fleet on the hybrid on {card}: capacity "
        f"{cap}, K={k}, pcm16, {FX_SESSIONS} sessions (per-slot rates, loops and "
        f"one-shots), {FX_CHUNKS} chunks; slots 0..{SERVE_CHECK - 1} vs the CPU "
        f"fleet: {off} samples 1 LSB apart, none further, sampler events equal "
        f"({len(mine)}: {sorted(names)}), {len(sampler_events(ev, cap))} sampler "
        f"events in the fleet; K3 {k3} "
        f"launches (1 a chunk), K1 {k1}, K2 {k2}; wall per chunk "
        f"{wall * 1e3:.3f} ms (realtime factor {audio_secs / wall:.1f})")
    return k3, off


def stream_checkpoint(ft, card: str):
    """10(e): the 64-node mixer streamed through FirewheelCtx, saved at
    buffer 20, continued to 40; a fresh ctx loads the checkpoint and renders
    buffers 20..40 bit for bit the same.  Then output_latency_frames on a
    compensated graph, and its render."""
    import shutil

    from firewheel_tpu_torch.mixer import add_mixer
    from firewheel_tpu_torch.nodes import BeepTestNode, DelayCompNode, SumNode

    cfg = ft.StreamConfig(buffer_frames=STREAM_BUFFER, block_frames=STREAM_BLOCK)

    def ctx():
        cx = ft.FirewheelCtx(device="cuda")
        add_mixer(cx.graph_mut(), 19, "pallas")
        sink = ft.ArraySink()
        cx.activate(cfg, sink=sink)
        return cx, sink

    def pump(cx, n):
        for _ in range(n):
            cx.update(max_pump_buffers=0)
            cx.stream.pump(1)
        cx.stream.flush()

    root = scratch_dir("stream_ckpt_")
    try:
        cx, sink = ctx()
        pump(cx, CKPT_STREAM_AT)
        cx.save_checkpoint(root)
        pump(cx, CKPT_STREAM_END - CKPT_STREAM_AT)
        cx.deactivate()
        want = sink.audio(2)[:, CKPT_STREAM_AT * STREAM_BUFFER:]
        cx, sink = ctx()
        meta = cx.load_checkpoint(root)
        pump(cx, CKPT_STREAM_END - CKPT_STREAM_AT)
        cx.deactivate()
        got = sink.audio(2)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if meta["frames_rendered"] != CKPT_STREAM_AT * STREAM_BUFFER:
        raise AssertionError(f"checkpoint at frame {meta['frames_rendered']}")
    if got.shape != want.shape or not np.array_equal(got, want) or \
            not np.abs(got).max() > 0.01:
        raise AssertionError(f"stream resumed from the checkpoint differs: "
                             f"{got.shape} vs {want.shape}")

    # latency compensation: beep → {delay 240, direct} → sum, compensated
    cx = ft.FirewheelCtx(device="cuda")
    g = cx.graph_mut()
    beep = g.add_node(0, 2, BeepTestNode(440.0, -12.0, True))
    slow = g.add_node(2, 2, DelayCompNode(delay_secs=0.005))
    mix = g.add_node(4, 2, SumNode())
    for ch in range(2):
        g.connect(beep, ch, slow, ch)
        g.connect(slow, ch, mix, ch)
        g.connect(beep, ch, mix, 2 + ch)
        g.connect(mix, ch, g.graph_out_node(), ch)
    inserted = g.compensate_latency(48000).insertions
    sink = ft.ArraySink()
    cx.activate(cfg, sink=sink)
    latency = cx.output_latency_frames()
    cx.render_offline(0.05)
    cx.deactivate()
    audio = sink.audio(2)
    peak = float(np.abs(audio).max())
    if (latency != 240 or len(inserted) != 1 or np.abs(audio[:, :240]).max() != 0.0
            or abs(peak - 2 * 0.2512) > 2e-3):
        raise AssertionError(f"latency: {latency} frames, {len(inserted)} insertions, "
                             f"peak {peak}")
    log(f"serving 10(e), stream checkpoint on {card}: the mixer saved at buffer "
        f"{CKPT_STREAM_AT}, a fresh FirewheelCtx resumed buffers "
        f"{CKPT_STREAM_AT}..{CKPT_STREAM_END} bit for bit; compensate_latency "
        f"spliced one {inserted[0].frames}-frame delay, output_latency_frames() = "
        f"{latency}, the aligned render peaks at {peak:.6f} after {latency} "
        f"silent frames")


ADPCM_CHUNKS = 3      # chunks through render_fetched, then flush
ADPCM_HOST_CHECK = 16  # instances held against the host codec


def serve_adpcm(ft, seq_iir, adpcm_device, card: str):
    """10(f): the mixer fleet of 10(a) with ``output_format="adpcm4"``
    (capacity 8192, K=32, 1024 sessions, eager with K1), beside the same
    fleet in pcm16: the shipped rows against K4's plain version on the
    card applied to the pcm16 fleet's chunk, and against the host codec for
    the first instances; ``render_stream``; both fleets' shipped realtime
    factor in turns.  Returns K4's launches on the main path."""
    from firewheel_tpu_torch.utils.adpcm import encode_ima

    cap, k = SERVE_CAPACITY, SERVE_K
    s = k * 128
    fleets = {}
    for fmt in ("adpcm4", "pcm16"):
        prog, handles = mixer_template(ft, "cuda")
        srv = ft.SessionServer(prog, cap, chunk_blocks=k, device="cuda",
                               output_format=fmt)
        for i in range(SERVE_SESSIONS):
            srv.connect(mixer_session(handles, i))
        fleets[fmt] = srv
    srv, pcm = fleets["adpcm4"], fleets["pcm16"]

    # the main path, counts set to 0 just before it
    adpcm_device.encode_ima_chunk.launches = seq_iir.biquad_seq.launches = 0
    rows = [srv.render_fetched() for _ in range(ADPCM_CHUNKS)][1:] + [srv.flush()]
    k4, k1 = adpcm_device.encode_ima_chunk.launches, seq_iir.biquad_seq.launches
    if k4 != ADPCM_CHUNKS or k1 != k * ADPCM_CHUNKS:
        raise AssertionError(f"adpcm4 fleet: K4 {k4} launches, K1 {k1} in "
                             f"{ADPCM_CHUNKS} chunks of K={k}")
    wires = [pcm.render_fetched() for _ in range(ADPCM_CHUNKS)][1:] + [pcm.flush()]
    ba = adpcm_device.chunk_block_align(2, s)
    for c, (r, w) in enumerate(zip(rows, wires, strict=True)):
        if r.dtype != np.uint8 or r.shape != (cap, ba):
            raise AssertionError(f"adpcm4 chunk {c}: {r.dtype}{r.shape}")
        if r.nbytes != w.nbytes // 4 + cap * 2 * 4:
            raise AssertionError(f"adpcm4 chunk {c}: {r.nbytes} bytes for "
                                 f"{w.nbytes} of pcm16")
    for b in range(ADPCM_HOST_CHECK):
        payload, _ = encode_ima(wires[0][b].reshape(s, 2).T, ba)
        if not np.array_equal(rows[0][b], np.frombuffer(payload, np.uint8)):
            raise AssertionError(f"adpcm4 chunk 0, slot {b}: not the host codec's bytes")
    wire = torch.from_numpy(wires[0]).to("cuda").reshape(cap, s, 2)
    plain = adpcm_device.encode_ima_chunk_reference(wire).cpu().numpy()
    if not np.array_equal(rows[0], plain):
        raise AssertionError(f"adpcm4 chunk 0: {int((rows[0] != plain).sum())} bytes "
                             "differ from K4's plain version on the pcm16 fleet's chunk")
    loud = int(np.abs(wires[-1][:SERVE_SESSIONS].astype(np.int32)).max())

    # render_stream: the rows equal render_chunk + .cpu(), chunk by chunk
    br = srv._br
    params, state0, s0 = srv._params, srv._state, srv.sample
    ref, st, at = [], state0, s0
    for _ in range(2):
        out, _, st = br.render_chunk(params, st, start_sample=at, num_blocks=k)
        ref.append(out.cpu().numpy())
        at += s
    seen = []

    def check(x):
        if x.shape != (cap, ba) or not np.array_equal(x, ref[len(seen)]):
            raise AssertionError(f"adpcm4 render_stream chunk {len(seen)} differs")
        seen.append(x.nbytes)

    br.render_stream(params, state0, num_chunks=2, num_blocks=k, start_sample=s0,
                     on_chunk=check)
    if len(seen) != 2:
        raise AssertionError(f"adpcm4 render_stream delivered {len(seen)} chunks")

    # the shipped realtime factor of both fleets, in turns (pcm16, adpcm4,
    # adpcm4, pcm16), ADPCM_CHUNKS chunks through render_fetched each
    walls = {"pcm16": [], "adpcm4": []}
    for fmt in ("pcm16", "adpcm4", "adpcm4", "pcm16"):
        f = fleets[fmt]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ADPCM_CHUNKS):
            f.render_fetched()
        f.flush()
        walls[fmt].append((time.perf_counter() - t0) / ADPCM_CHUNKS)
    audio_secs = cap * s / 48000
    rtf = {fmt: audio_secs / (sum(w) / len(w)) for fmt, w in walls.items()}
    log(f"serving 10(f), the mixer fleet in adpcm4 on {card}: capacity {cap}, K={k}, "
        f"{SERVE_SESSIONS} sessions; {len(rows)} chunks shipped through "
        f"render_fetched/flush, each a quarter of the pcm16 fleet's bytes plus "
        f"the headers; chunk 0 bit-equal to K4's plain version on the card "
        f"applied to the pcm16 fleet's chunk, and to the host codec "
        f"(utils/adpcm.encode_ima) for slots 0..{ADPCM_HOST_CHECK - 1} "
        f"(pcm16 peak {loud} LSB); render_stream equal to render_chunk + .cpu() "
        f"for 2 chunks; K4 {k4} launches (1 a chunk), K1 {k1}")
    log(f"serving 10(f): {rows[0].nbytes / 1e6:.3f} MB a chunk shipped as adpcm4 "
        f"against {wires[0].nbytes / 1e6:.3f} MB as pcm16 (a quarter plus "
        f"{cap * 2 * 4} header bytes); wall per chunk through render_fetched "
        f"adpcm4 {' and '.join(f'{w * 1e3:.3f}' for w in walls['adpcm4'])} ms, "
        f"pcm16 {' and '.join(f'{w * 1e3:.3f}' for w in walls['pcm16'])} ms (run "
        f"pcm16, adpcm4, adpcm4, pcm16); realtime factor of the shipped audio "
        f"adpcm4 {rtf['adpcm4']:.1f}, pcm16 {rtf['pcm16']:.1f}")
    del fleets, srv, pcm, br, params, state0
    torch.cuda.empty_cache()
    return k4


def check_serving(ft, seq_iir, em, eh, adpcm_device, card: str, phase):
    """Phase 10: the serving fleet on the card → the launches of K1 in the
    mixer fleet, of K3 in the hybrid fleet and of K4 in the adpcm4
    fleet."""
    srv, k1, _ = serve_mixer(ft, seq_iir, em, eh, card)
    phase("10(a), the mixer fleet")
    serve_egress(srv, card)
    phase("10(b), render_stream")
    serve_checkpoint(ft, srv, card)
    del srv
    torch.cuda.empty_cache()
    phase("10(c), fleet checkpoints")
    k3, _ = serve_hybrid(ft, seq_iir, em, eh, card)
    phase("10(d), the hybrid fleet")
    stream_checkpoint(ft, card)
    phase("10(e), the stream checkpoint and latency")
    k4 = serve_adpcm(ft, seq_iir, adpcm_device, card)
    phase("10(f), the mixer fleet in adpcm4")
    return k1, k3, k4


# phase 11: the spatial scene (BASELINE config 5, examples/spatial_scene.py)
SPATIAL_SECS = 1.5           # the example's render and orbit
SPATIAL_CHUNK_BUFFERS = 8    # buffers a stream dispatch
SPATIAL_TURN_AT = 4          # pump before which the listener turns 30°
SPATIAL_PROFILED = (2, 3)    # pumps [2, 3) under torch.profiler, one buffer each
SPATIAL_REPS = 3             # K2 launches a device-time measurement (~1 s each)
SPATIAL_SPILLED = (1024, 8)  # B, K of the scene in blocks of 256 frames (arena spilled)
SPATIAL_HYBRID = (1024, 8)   # B, K of the doppler-mixed scene on the hybrid
DOPPLER_EVERY = 4            # every 4th emitter doppler (32 of 128)
BINAURAL = (1024, 8)         # B, K of the headphone variant


def spatial_stream(ft, device, profile=False):
    """The 266-node scene streamed offline through ``FirewheelCtx`` as the
    example streams it (48 kHz, 1024-frame buffers of 128-frame blocks,
    8 buffers a pump, 1.5 s, every 4th emitter orbiting 90°), every emitter
    in a ``SpatialScene`` whose listener turns 30° before pump
    SPATIAL_TURN_AT.  With ``profile``, ``torch.profiler`` traces pumps
    SPATIAL_PROFILED, one buffer each, and the stream ends there.  Returns a dict of the
    audio, the final state on the CPU, the meter's reading, each pump's
    wall, the executor's pooled groups and the profile."""
    from firewheel_tpu_torch.convert import tree_map
    from firewheel_tpu_torch.examples import spatial_scene
    from firewheel_tpu_torch.nodes import DbMeterNode
    from firewheel_tpu_torch.ops import iir

    cx = ft.FirewheelCtx(device=device)
    g = cx.graph_mut()
    meter, spats, orbiting = spatial_scene.build_scene(cx)
    scene = ft.SpatialScene()
    for spat, _, _ in spats:
        scene.add(spat, g.node(spat), g.node(spat).position())
    sink = ft.ArraySink()
    cfg = ft.StreamConfig(buffer_frames=STREAM_BUFFER, block_frames=STREAM_BLOCK,
                          chunk_buffers=SPATIAL_CHUNK_BUFFERS)
    cx.activate(cfg, sink=sink)
    stream, proc = cx.stream, cx.stream._processor
    frames = int(SPATIAL_SECS * 48000)
    out = {"walls": [], "orbiting": orbiting, "nodes": len(list(g.nodes()))}
    trace = PumpTrace()
    iir.one_pole_scan.launches = 0
    t_start = time.perf_counter()
    i = 0
    while stream.frames_rendered < frames and not (profile and i == SPATIAL_PROFILED[1]):
        if i == SPATIAL_TURN_AT:
            scene.set_listener(forward=(0.5, 0.0, -np.sqrt(0.75)))
        if profile and i == SPATIAL_PROFILED[0]:
            trace.start()
        # a profiled pump renders one buffer: reading a profile costs
        # seconds a thousand kernels
        trace.pump(cx, 1 if trace.on else cfg.chunk_buffers, out["walls"])
        i += 1
        if trace.on and i == SPATIAL_PROFILED[1]:
            out["profile"], out["profile_wall"] = trace.stop(stream)
    stream.flush()
    if device != "cpu":
        torch.cuda.synchronize()
    out["wall"] = time.perf_counter() - t_start
    out["k7"] = iir.one_pole_scan.launches
    out["reading"] = DbMeterNode.read(cx.node_state(meter))
    out["state"] = tree_map(lambda t: t.cpu(), proc.state_dict())
    out["groups"] = [(kind, len(m), type(proc._program._procs[ft.node_key(m[0].id)]).__name__)
                     for kind, m in proc._program._plan]
    out["audio"] = sink.audio(2)
    cx.deactivate()
    return out


def spatial_stream_check(ft, cpu_result, card: str):
    """11(a): the scene streamed on the card against the same stream on the
    CPU (the first worker's): audio, the meter's reading and every state
    leaf within 1e-5."""
    t0 = time.perf_counter()
    run = spatial_stream(ft, "cuda")
    t1 = time.perf_counter()
    cpu = cpu_result.get()["spatial"]
    t2 = time.perf_counter()
    e = float(np.abs(run["audio"] - cpu["audio"]).max())
    state_e = tree_err(run["state"], cpu["state"])
    meter_e = max(float(np.abs(run["reading"][k] - cpu["reading"][k]).max())
                  for k in ("peak_db", "rms_db"))
    if run["nodes"] != 266 or run["orbiting"] != 32:
        raise AssertionError(f"scene: {run['nodes']} nodes, {run['orbiting']} orbiting")
    if not max(e, state_e) <= STREAM_TOL or not meter_e <= 1e-3:
        raise AssertionError(f"spatial stream vs CPU: audio {e}, state {state_e}, "
                             f"meter {meter_e} dB")
    peak = float(np.abs(run["audio"]).max())
    if not np.isfinite(run["audio"]).all() or not 0.01 < peak <= 1.0:
        raise AssertionError(f"spatial stream peak {peak}")
    prof = spatial_stream(ft, "cuda", profile=True)
    t3 = time.perf_counter()
    pumps = SPATIAL_PROFILED[1] - SPATIAL_PROFILED[0]
    blocks = pumps * STREAM_BUFFER // STREAM_BLOCK
    per_block, calls, busy = profile_busy(prof["profile"], blocks)
    if not per_block:
        # the card's work is held by the comparison with the CPU's stream
        # above; only this profile's numbers are lost (see ``device_ms``)
        log("spatial 11(a): torch.profiler saw no kernel on the card; its kernels, "
            "launch calls and busy share below are not measured (0)")
    audio_secs = run["audio"].shape[1] / 48000
    walls = np.asarray(run["walls"][1:]) * 1e3 / SPATIAL_CHUNK_BUFFERS
    groups = [g for g in run["groups"] if g[2] in ("BeepTestProcessor",
                                                    "Spatializer3DProcessor")]
    log(f"spatial 11(a), the scene streamed on {card}: {run['nodes']} nodes, "
        f"{run['orbiting']} emitters orbiting, listener turned before pump "
        f"{SPATIAL_TURN_AT}; {run['audio'].shape[1]} frames vs the CPU's stream: "
        f"audio {e:.3e}, state {state_e:.3e}, meter {meter_e:.3e} dB (peak "
        f"{np.round(run['reading']['peak_db'], 2).tolist()} dB, rms "
        f"{np.round(run['reading']['rms_db'], 2).tolist()} dB)")
    log(f"spatial 11(a): the executor pools the 128 beeps and the 128 "
        f"spatializers into {groups} (kind, members, processor); K7 (the "
        f"spatializers' one-pole) {run['k7']} launches in "
        f"{run['audio'].shape[1] // STREAM_BLOCK} blocks")
    log(f"spatial 11(a): realtime factor {audio_secs / run['wall']:.3f} "
        f"({audio_secs:.3f} s of audio in {run['wall']:.3f} s); wall a 1024-frame "
        f"buffer (a pump of {SPATIAL_CHUNK_BUFFERS} / {SPATIAL_CHUNK_BUFFERS}) p50 "
        f"{np.percentile(walls, 50):.3f} ms, p99 {np.percentile(walls, 99):.3f} ms "
        f"(budget 21.333 ms); CPU stream realtime factor "
        f"{audio_secs / cpu['wall']:.3f}")
    log(f"spatial 11(a), torch.profiler over {pumps} one-buffer pump(s) ({blocks} "
        f"blocks) on {card}: {per_block:.1f} kernels a block on the device ({calls:.1f} launch "
        f"calls a block on the host), device busy {busy / 1e3:.3f} ms of "
        f"{prof['profile_wall'] * 1e3:.3f} ms "
        f"({100 * busy / 1e6 / prof['profile_wall']:.1f}%)")
    log(f"spatial 11(a): seconds of the phase, set-up included: the card's stream "
        f"{t1 - t0:.1f}, waiting for the CPU's (the worker's) {t2 - t1:.1f}, the "
        f"profiled stream {t3 - t2:.1f}, "
        f"its profile read {time.perf_counter() - t3:.1f}")
    return max(e, state_e)


def spatial_eager(ft, card: str):
    """11(b): the scene batched eagerly at B=8192, K=32, every instance with
    its own emitters, the first instances against a CPU render."""
    from firewheel_tpu_torch.convert import tree_map
    from firewheel_tpu_torch.mixer import vary_spatial_params
    from firewheel_tpu_torch.ops import iir

    prog = ft.spatial_scene_graph(device="cuda")
    br = ft.BatchRenderer(prog, B, device="cuda")
    params = vary_spatial_params(prog, br.stack_params(), 11)
    state = br.init_state()
    cpu_br = ft.BatchRenderer(ft.spatial_scene_graph(device="cpu"), CHECK_INSTANCES,
                              device="cpu")
    cpu_params = tree_map(lambda t: t[:CHECK_INSTANCES].cpu(), params)
    cpu_state = tree_map(lambda t: t[:CHECK_INSTANCES].cpu(), state)
    worst, sample, walls = 0.0, 0, []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iir.one_pole_scan.launches = 0
    for c in range(TIMED_CHUNKS + 1):  # the first chunk warms up, checked too
        t0 = time.perf_counter()
        out, om, state = br.render_chunk(params, state, start_sample=sample,
                                         num_blocks=K)
        torch.cuda.synchronize()
        if c:
            walls.append(time.perf_counter() - t0)
        c_out, c_om, cpu_state = cpu_br.render_chunk(cpu_params, cpu_state,
                                                     start_sample=sample, num_blocks=K)
        e = float((out[:CHECK_INSTANCES].cpu() - c_out).abs().max())
        if not e <= SLICE_TOL or not torch.equal(om[:CHECK_INSTANCES].cpu(), c_om):
            raise AssertionError(f"spatial eager chunk {c}: card vs CPU {e}, or masks")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError("spatial eager: non-finite output")
        worst = max(worst, e)
        sample += K * 128
    e = tree_err(tree_map(lambda t: t[:CHECK_INSTANCES].cpu(), state), cpu_state)
    if not e <= SLICE_TOL:
        raise AssertionError(f"spatial eager final state vs CPU: {e}")
    peak = float(out.abs().max())
    if not 0.01 < peak <= 1.0:
        raise AssertionError(f"spatial eager peak {peak}")
    # the 128 spatializers pool into one group: one one-pole launch a block
    if iir.one_pole_scan.launches != K * (TIMED_CHUNKS + 1):
        raise AssertionError(f"spatial eager: K7 launched {iir.one_pole_scan.launches} "
                             f"times in {TIMED_CHUNKS + 1} chunks of K={K}")
    wall = float(np.mean(walls))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    audio_secs = B * K * 128 / 48000
    log(f"spatial 11(b), the scene eager on {card}: B={B}, K={K}, per-instance "
        f"positions, volumes and occlusion; first {CHECK_INSTANCES} instances vs the "
        f"CPU over {TIMED_CHUNKS + 1} chunks and the final state: "
        f"max_abs_err={max(worst, e):.3e}; wall per chunk {wall * 1e3:.3f} ms "
        f"(realtime factor {audio_secs / wall:.1f}), peak device memory "
        f"{peak_gb:.3f} GB; K7 (the spatializers' one-pole) "
        f"{iir.one_pole_scan.launches / (TIMED_CHUNKS + 1):.0f} launches a chunk")
    return wall, max(worst, e)


def spatial_mega(ft, seq_iir, em, card: str):
    """11(c): K2 on the scene at B=8192, K=32, tile 1: at rest and with every
    4th spatializer moving, against the eager render on the card and the
    first instances against the plain version on the card; one launch a
    chunk.  Then in blocks of 256 frames at B=1024, K=8, where the arena
    fits no CTA and spills to device memory: the same checks.  Returns the
    kernels line's tuples for both."""
    from firewheel_tpu_torch.convert import tree_map
    from firewheel_tpu_torch.mixer import vary_spatial_params

    prog = ft.spatial_scene_graph(device="cuda")
    mega = em.MegaRenderer(prog, B, K, tile=1, device="cuda")
    eager = ft.BatchRenderer(prog, B, device="cuda")
    lw = mega.lowered
    smem = em.shared_bytes(lw, 1)
    kernel_smem = em.LIBRARY.load().fw_mega_shared_bytes(*em.shared_sizes(lw, 1))
    if kernel_smem != smem or prog.schedule.num_buffers != 258:
        raise AssertionError(f"spatial K2: the wrapper counts {smem} B of shared "
                             f"memory, the kernel {kernel_smem} B; "
                             f"{prog.schedule.num_buffers} buffers")
    log(f"spatial 11(c): {len(lw.keys)} rows, {lw.num_buffers} buffers, "
        f"{lw.num_words} leaf words; {smem} B of shared memory per CTA at tile 1 "
        f"(the kernel's count too; at most {em.MAX_SHARED_BYTES})")
    worst = 0.0

    def agree(tag, m, e):
        nonlocal worst
        out_e, state_e = float((m[0] - e[0]).abs().max()), tree_err(m[2], e[2])
        if not torch.equal(m[1], e[1]) or not max(out_e, state_e) <= MEGA_TOL:
            raise AssertionError(f"spatial K2 vs eager, {tag}: outputs {out_e}, state "
                                 f"{state_e}, masks equal {torch.equal(m[1], e[1])}")
        worst = max(worst, out_e, state_e)
        return out_e, state_e

    rest = mega.stack_params()
    state0 = mega.init_state()
    m = mega.render_chunk(rest, state0, 0)  # warm-up, at rest
    e = eager.render_chunk(rest, state0, start_sample=0, num_blocks=K)
    torch.cuda.synchronize()
    rest_err = agree("at rest", m, e)
    rest_ms = device_ms(lambda: mega.render_chunk(rest, state0, 0), "mega_kernel",
                        SPATIAL_REPS)

    # the main path: every 4th spatializer moves each chunk, counts set to 0
    moves = [vary_spatial_params(prog, tree_map(torch.clone, rest), 100 + c,
                                 moving_every=4) for c in range(TIMED_CHUNKS)]
    starts = [(c + 1) * K * 128 for c in range(TIMED_CHUNKS)]
    em.MegaRenderer.launches = 0
    seq_iir.biquad_seq.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m_runs, ms = [], m[2]
    for p, start in zip(moves, starts):
        out, masks, ms = mega.render_chunk(p, ms, start)
        m_runs.append((out, masks, ms))
    torch.cuda.synchronize()
    mega_wall = (time.perf_counter() - t0) / TIMED_CHUNKS
    launches, k1 = em.MegaRenderer.launches, seq_iir.biquad_seq.launches
    if launches != TIMED_CHUNKS or k1:
        raise AssertionError(f"spatial K2: {launches} launches in {TIMED_CHUNKS} "
                             f"chunks, K1 {k1}")
    t0 = time.perf_counter()
    e_runs, es = [], e[2]
    for p, start in zip(moves, starts):
        out, masks, es = eager.render_chunk(p, es, start_sample=start, num_blocks=K)
        e_runs.append((out, masks, es))
    torch.cuda.synchronize()
    eager_wall = (time.perf_counter() - t0) / TIMED_CHUNKS
    for c, (mr, er) in enumerate(zip(m_runs, e_runs)):
        move_err = agree(f"moving, chunk {c}", mr, er)
    # spatializers whose gain target moves at chunk 0: their smoothers ramp
    ramping = sum(int((moves[0][key]["gain"] != v["gain"]["target"]).sum())
                  for key, v in m[2].items() if key.startswith("spatializer"))
    if not ramping:
        raise AssertionError("spatial K2: no spatializer smoother ramps")
    peak = float(m_runs[-1][0].abs().max())
    if not bool(torch.isfinite(m_runs[-1][0]).all()) or not 0.01 < peak <= 1.0:
        raise AssertionError(f"spatial K2 peak {peak}")
    move_ms = device_ms(lambda: mega.render_chunk(moves[-1], m_runs[-2][2], starts[-1]),
                        "mega_kernel", SPATIAL_REPS)
    call_ms = cuda_ms(lambda: mega.render_chunk(moves[-1], m_runs[-2][2], starts[-1]), 1)
    work = kernel_work(em, prog, lw, moves[-1], m_runs[-2][2], B, K,
                       m_runs[-1][0].nbytes + m_runs[-1][1].nbytes)

    # the first instances against the plain version on the card
    head = lambda t: t[:CHECK_INSTANCES].contiguous()  # noqa: E731
    ro, rm, rs = em.mega_chunk_reference(prog, lw, tree_map(head, moves[-1]),
                                         tree_map(head, m_runs[-2][2]), starts[-1],
                                         K, CHECK_INSTANCES)
    torch.cuda.synchronize()
    plain_err = max(float((m_runs[-1][0][:CHECK_INSTANCES] - ro).abs().max()),
                    tree_err(tree_map(head, m_runs[-1][2]), rs))
    if not torch.equal(m_runs[-1][1][:CHECK_INSTANCES], rm) or not plain_err <= MEGA_TOL:
        raise AssertionError(f"spatial K2 vs its plain version: {plain_err}")

    spilled = spatial_spilled(ft, em, agree)
    audio_secs = B * K * 128 / 48000
    bound_ms, bound_by = bound(*work)
    log(f"spatial 11(c), K2 vs eager on the card (outputs, masks, every state "
        f"leaf): at rest {rest_err[0]:.3e}/{rest_err[1]:.3e}, moving (last chunk) "
        f"{move_err[0]:.3e}/{move_err[1]:.3e}, worst {worst:.3e}; {ramping} "
        f"spatializer gain smoothers ramping from chunk 0's start; the first "
        f"{CHECK_INSTANCES} instances vs the plain version on the card: "
        f"max_abs_err={plain_err:.3e}, masks equal")
    log(f"spatial 11(c): K2 launches {launches} in {TIMED_CHUNKS} chunks, K1 {k1}; "
        f"K2 {rest_ms:.3f} ms on the device at rest, {move_ms:.3f} ms moving "
        f"({SPATIAL_REPS} launches each, timed as logged above), {call_ms:.3f} ms a "
        f"call (CUDA events); bound {bound_ms:.4f} ms by {bound_by} ({work[0] / 1e9:.3f} "
        f"GB, {work[1] / 1e9:.2f} G f32 operations), {100 * bound_ms / move_ms:.2f}% "
        f"of it")
    log(f"spatial 11(c), the scene B={B} K={K} on {card}: K2 wall per chunk "
        f"{mega_wall * 1e3:.3f} ms (realtime factor {audio_secs / mega_wall:.1f}); "
        f"eager {eager_wall * 1e3:.3f} ms (realtime factor "
        f"{audio_secs / eager_wall:.1f})")
    # plain_ms: the eager render's wall a chunk (the plain version at B=8192
    # would take minutes)
    return (launches, max(worst, plain_err), move_ms, call_ms, eager_wall * 1e3,
            work), spilled


def spatial_spilled(ft, em, agree):
    """11(c) in blocks of 256 frames at B=1024, K=8: the 258 buffers of the
    arena fit no CTA, so K2 keeps them in device memory (``spills``); one
    launch a chunk, against eager on the card (``agree``) and the first
    instances against the plain version on the card, timed.  Returns the
    kernels line's tuple."""
    from firewheel_tpu_torch.convert import tree_map
    from firewheel_tpu_torch.mixer import add_spatial_scene, vary_spatial_params

    b, k = SPATIAL_SPILLED
    g = ft.AudioGraph(ft.AudioGraphConfig(0, 2))
    add_spatial_scene(g)
    pkg = g.compile(48000, 256)
    big = ft.ScheduleProgram(pkg.schedule, dict(pkg.new_node_processors), 48000,
                             device="cuda")
    mega = em.MegaRenderer(big, b, k, device="cuda")
    eager = ft.BatchRenderer(big, b, device="cuda")
    lw = mega.lowered
    smem = em.shared_bytes(lw, 1)
    kernel_smem = em.LIBRARY.load().fw_mega_shared_bytes(*em.shared_sizes(lw, 1))
    if not em.spills(lw) or kernel_smem != smem:
        raise AssertionError(f"spatial K2 at F=256: spills {em.spills(lw)}, the wrapper "
                             f"counts {smem} B of shared memory, the kernel {kernel_smem}")
    params = vary_spatial_params(big, mega.stack_params(), 7, moving_every=4)
    state0 = mega.init_state()
    mega.render_chunk(params, state0, 0)  # warm-up
    # the main path: one chunk, counts set to 0 just before
    em.MegaRenderer.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = mega.render_chunk(params, state0, 0)
    torch.cuda.synchronize()
    mega_wall = time.perf_counter() - t0
    launches = em.MegaRenderer.launches
    t0 = time.perf_counter()
    e = eager.render_chunk(params, state0, start_sample=0, num_blocks=k)
    torch.cuda.synchronize()
    eager_wall = time.perf_counter() - t0
    if launches != 1:
        raise AssertionError(f"spatial K2 at F=256: {launches} launches in a chunk")
    err = agree("F=256, the arena spilled", m, e)
    peak = float(m[0].abs().max())
    if not bool(torch.isfinite(m[0]).all()) or not 0.01 < peak <= 1.0:
        raise AssertionError(f"spatial K2 at F=256: peak {peak}")
    head = lambda t: t[:CHECK_INSTANCES].contiguous()  # noqa: E731
    ro, rm, rs = em.mega_chunk_reference(big, lw, tree_map(head, params),
                                         tree_map(head, state0), 0, k, CHECK_INSTANCES)
    torch.cuda.synchronize()
    plain_err = max(float((m[0][:CHECK_INSTANCES] - ro).abs().max()),
                    tree_err(tree_map(head, m[2]), rs))
    if not torch.equal(m[1][:CHECK_INSTANCES], rm) or not plain_err <= MEGA_TOL:
        raise AssertionError(f"spatial K2 at F=256 vs its plain version: {plain_err}")
    launch = lambda: mega.render_chunk(params, state0, 0)  # noqa: E731
    ms = device_ms(launch, "mega_kernel", SPATIAL_REPS)
    call_ms = cuda_ms(launch, 1)
    work = kernel_work(em, big, lw, params, state0, b, k, m[0].nbytes + m[1].nbytes)
    bound_ms, bound_by = bound(*work)
    arena = b * lw.num_buffers * 256 * 4
    log(f"spatial 11(c), F=256 at B={b}, K={k}: the arena ({lw.num_buffers} buffers, "
        f"{arena / 1e6:.1f} MB in all) spills to device memory, {smem} B of shared "
        f"memory a CTA (the kernel's count too); K2 vs eager on the card (outputs, "
        f"masks, every state leaf) {err[0]:.3e}/{err[1]:.3e}, the first "
        f"{CHECK_INSTANCES} instances vs the plain version {plain_err:.3e}; "
        f"{launches} launch a chunk")
    log(f"spatial 11(c), F=256: K2 {ms:.3f} ms on the device, {call_ms:.3f} ms a call; "
        f"bound {bound_ms:.4f} ms by {bound_by} ({work[0] / 1e9:.3f} GB, "
        f"{work[1] / 1e9:.2f} G f32 operations), {100 * bound_ms / ms:.2f}% of it; "
        f"wall a chunk K2 {mega_wall * 1e3:.3f} ms, eager {eager_wall * 1e3:.3f} ms")
    # plain_ms: the eager render's wall a chunk, as for the scene at F=128
    return launches, max(err[0], err[1], plain_err), ms, call_ms, eager_wall * 1e3, work


def spatial_hybrid(ft, seq_iir, em, eh, card: str):
    """11(d): the scene with every 4th emitter doppler on the hybrid at
    B=1024, K=8: against eager on the card and the CPU plain hybrid; K3
    once an island a chunk; K3 timed on the beeps' island."""
    from firewheel_tpu_torch.convert import tree_map
    from firewheel_tpu_torch.mixer import vary_spatial_params

    b, k = SPATIAL_HYBRID
    prog = ft.spatial_scene_graph(doppler_every=DOPPLER_EVERY, device="cuda")
    hybrid = ft.BatchRenderer(prog, b, device="cuda", lowering="hybrid")
    eager = ft.BatchRenderer(prog, b, device="cuda")
    params = vary_spatial_params(prog, hybrid.stack_params(), 21)
    state0 = hybrid.init_state()
    h = hybrid.render_chunk(params, state0, start_sample=0, num_blocks=k)  # warm-up
    e = eager.render_chunk(params, state0, start_sample=0, num_blocks=k)
    hy = hybrid._chunk_cache[("hybrid", k)]
    islands = len(hy.islands)
    kinds = [kind for kind, _ in hy.segments]
    if kinds != ["mega", "xla"] * 32 + ["mega"]:
        raise AssertionError(f"doppler scene segments {kinds}")
    starts = [(c + 1) * k * 128 for c in range(TIMED_CHUNKS)]
    eh.HybridMegaRenderer.launches = em.MegaRenderer.launches = 0
    seq_iir.biquad_seq.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h_runs, hs = [h], h[2]
    for start in starts:
        h_runs.append(hybrid.render_chunk(params, hs, start_sample=start, num_blocks=k))
        hs = h_runs[-1][2]
    torch.cuda.synchronize()
    h_wall = (time.perf_counter() - t0) / TIMED_CHUNKS
    launches = eh.HybridMegaRenderer.launches
    if (launches != islands * TIMED_CHUNKS or em.MegaRenderer.launches
            or seq_iir.biquad_seq.launches):
        raise AssertionError(f"doppler scene: K3 {launches} launches for {islands} "
                             f"islands x {TIMED_CHUNKS} chunks, K2 "
                             f"{em.MegaRenderer.launches}, K1 {seq_iir.biquad_seq.launches}")
    t0 = time.perf_counter()
    e_runs, es = [e], e[2]
    for start in starts:
        e_runs.append(eager.render_chunk(params, es, start_sample=start, num_blocks=k))
        es = e_runs[-1][2]
    torch.cuda.synchronize()
    e_wall = (time.perf_counter() - t0) / TIMED_CHUNKS
    worst = 0.0
    for c, (hr, er) in enumerate(zip(h_runs, e_runs)):
        out_e, state_e = float((hr[0] - er[0]).abs().max()), tree_err(hr[2], er[2])
        if not torch.equal(hr[1], er[1]) or not max(out_e, state_e) <= HYBRID_TOL:
            raise AssertionError(f"doppler scene chunk {c}: hybrid vs eager {out_e}, "
                                 f"state {state_e}")
        worst = max(worst, out_e, state_e)
    peak = float(h_runs[-1][0].abs().max())
    if not bool(torch.isfinite(h_runs[-1][0]).all()) or not 0.01 < peak <= 1.0:
        raise AssertionError(f"doppler scene peak {peak}")
    cpu = ft.BatchRenderer(ft.spatial_scene_graph(doppler_every=DOPPLER_EVERY,
                                                  device="cpu"),
                           CHECK_INSTANCES, device="cpu", lowering="hybrid")
    cpu_state = tree_map(lambda t: t[:CHECK_INSTANCES].cpu(), state0)
    cpu_params = tree_map(lambda t: t[:CHECK_INSTANCES].cpu(), params)
    cpu_worst = 0.0
    for start, hr in zip([0] + starts, h_runs):
        c_out, c_mask, cpu_state = cpu.render_chunk(cpu_params, cpu_state,
                                                    start_sample=start, num_blocks=k)
        err = float((hr[0][:CHECK_INSTANCES].cpu() - c_out).abs().max())
        if not err <= SLICE_TOL or not torch.equal(hr[1][:CHECK_INSTANCES].cpu(), c_mask):
            raise AssertionError(f"doppler scene vs CPU plain hybrid at {start}: {err}")
        cpu_worst = max(cpu_worst, err)

    # K3 on the first island (the 128 beeps: no live-ins) against its plain
    # version at the same operands
    i = 0
    lw = hy.islands[i]
    pseg = {key: params[key] for key in hy._keys[i]}
    sseg = {key: h_runs[-2][2][key] for key in hy._keys[i]}
    env = torch.zeros((b, k, 0, 128), device="cuda")
    env_flags = torch.zeros((b, k, 0), dtype=torch.bool, device="cuda")
    ko, kf, ks = hy._launch(i, pseg, sseg, env, env_flags)
    ro, rf, rs = em.island_chunk_reference(prog, lw, pseg, sseg, env, env_flags,
                                           starts[-1], k, b)
    torch.cuda.synchronize()
    k3_err = max(float((ko - ro).abs().max()), tree_err(ks, rs))
    if not torch.equal(kf, rf) or not k3_err <= HYBRID_TOL:
        raise AssertionError(f"doppler scene: K3 vs its plain version {k3_err}")

    def launch():
        return hy._launch(i, pseg, sseg, env, env_flags)

    k3_ms = device_ms(launch, "island_kernel", KERNEL_REPS)
    k3_call = cuda_ms(launch, KERNEL_REPS)
    plain_ms = cuda_ms(lambda: em.island_chunk_reference(
        prog, lw, pseg, sseg, env, env_flags, starts[-1], k, b), 2)
    work = kernel_work(em, prog, lw, pseg, sseg, b, k, ko.nbytes + kf.nbytes)
    bound_ms, bound_by = bound(*work)
    audio_secs = b * k * 128 / 48000
    log(f"spatial 11(d), the scene with every {DOPPLER_EVERY}th emitter doppler on "
        f"the hybrid on {card}: B={b}, K={k}, {islands} islands between "
        f"{kinds.count('xla')} torch stages; K3 launches {launches} in "
        f"{TIMED_CHUNKS} chunks ({islands} a chunk), K2 and K1 none")
    log(f"spatial 11(d): hybrid vs eager on the card ({TIMED_CHUNKS + 1} chunks, "
        f"outputs, masks, every state leaf) max_abs_err={worst:.3e}; the first "
        f"{CHECK_INSTANCES} instances vs the CPU plain hybrid {cpu_worst:.3e}; K3 on "
        f"the beeps' island ({len(lw.keys)} rows) vs its plain version "
        f"{k3_err:.3e}")
    log(f"spatial 11(d): K3 on the beeps' island {k3_ms:.4f} ms on the device "
        f"({k3_call:.4f} ms a call, CUDA events), plain {plain_ms:.3f} ms; bound "
        f"{bound_ms:.4f} ms by {bound_by}; hybrid wall per chunk {h_wall * 1e3:.3f} "
        f"ms (realtime factor {audio_secs / h_wall:.1f}), eager {e_wall * 1e3:.3f} "
        f"ms (realtime factor {audio_secs / e_wall:.1f})")
    return launches, max(worst, cpu_worst, k3_err), k3_ms, k3_call, plain_ms, work


def spatial_binaural(ft, card: str):
    """11(e): the headphone variant (binaural spatializers) eager at
    B=1024, K=8, each instance at its own volume, against a CPU render."""
    from firewheel_tpu_torch.convert import tree_map

    from firewheel_tpu_torch.ops import iir

    b, k = BINAURAL
    prog = ft.spatial_scene_graph(binaural=True, device="cuda")
    br = ft.BatchRenderer(prog, b, device="cuda")
    params = br.stack_params()
    gen = torch.Generator(device="cpu").manual_seed(31)
    for key, p in params.items():
        if key.startswith("binaural"):
            p["gain"].mul_((0.25 + 1.25 * torch.rand((b,), generator=gen)).to("cuda"))
    state = br.init_state()
    cpu = ft.BatchRenderer(ft.spatial_scene_graph(binaural=True, device="cpu"),
                           CHECK_INSTANCES, device="cpu")
    cpu_params = tree_map(lambda t: t[:CHECK_INSTANCES].cpu(), params)
    cpu_state = tree_map(lambda t: t[:CHECK_INSTANCES].cpu(), state)
    worst, walls = 0.0, []
    iir.one_pole_scan.launches = 0
    for c in range(TIMED_CHUNKS + 1):
        t0 = time.perf_counter()
        out, om, state = br.render_chunk(params, state, start_sample=c * k * 128,
                                         num_blocks=k)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        c_out, c_om, cpu_state = cpu.render_chunk(cpu_params, cpu_state,
                                                  start_sample=c * k * 128, num_blocks=k)
        err = float((out[:CHECK_INSTANCES].cpu() - c_out).abs().max())
        if not err <= SLICE_TOL or not torch.equal(om[:CHECK_INSTANCES].cpu(), c_om):
            raise AssertionError(f"binaural scene chunk {c} vs CPU: {err}")
        worst = max(worst, err)
    err = tree_err(tree_map(lambda t: t[:CHECK_INSTANCES].cpu(), state), cpu_state)
    peak = float(out.abs().max())
    if not err <= SLICE_TOL or not 0.01 < peak <= 1.0:
        raise AssertionError(f"binaural scene: state {err}, peak {peak}")
    wall = float(np.mean(walls[1:]))
    log(f"spatial 11(e), the binaural scene eager on {card}: B={b}, K={k}, first "
        f"{CHECK_INSTANCES} instances vs the CPU over {TIMED_CHUNKS + 1} chunks and "
        f"the final state: max_abs_err={max(worst, err):.3e}; wall per chunk "
        f"{wall * 1e3:.3f} ms (realtime factor {b * k * 128 / 48000 / wall:.1f}); K7 "
        f"(the air and head-shadow one-poles) "
        f"{iir.one_pole_scan.launches / (TIMED_CHUNKS + 1):.0f} launches a chunk")
    return max(worst, err)


def check_spatial(ft, seq_iir, em, eh, cpu_result, card: str, phase):
    """Phase 11: the spatial scene → K2's and K3's numbers on it."""
    spatial_stream_check(ft, cpu_result, card)
    phase("11(a), the scene streamed")
    spatial_eager(ft, card)
    torch.cuda.empty_cache()
    phase("11(b), the scene eager at B=8192, K=32")
    k2, k2_spilled = spatial_mega(ft, seq_iir, em, card)
    torch.cuda.empty_cache()
    phase("11(c), the scene on K2, at 128 frames and spilled at 256")
    k3 = spatial_hybrid(ft, seq_iir, em, eh, card)
    torch.cuda.empty_cache()
    phase("11(d), the doppler scene on the hybrid")
    spatial_binaural(ft, card)
    phase("11(e), the binaural scene")
    return k2, k3, k2_spilled


# phase 12: the mastering bus (examples/mastering_bus.py)
MASTER_SECS = 4.0            # the example's stream
MASTER_BUFFER = 256          # frames a buffer and a block, as the example streams
MASTER_PROFILED = (300, 4)   # buffers 300..303 under torch.profiler (dialogue on)
MASTER_CHUNKS = 3            # 12(b): chunks at B=8192, K=32
MASTER_CHECK = 2             # 12(b): instances re-rendered on the CPU
MASTER_COMPARED = 2          # 12(b): chunks compared with the CPU render
MASTER_HYBRID = ((1024, 8), (8192, 32))  # 12(c): B, K
MASTER_LOWERED_CHUNKS = 3    # 12(c): chunks a configuration, the first a warm-up
# 12(c): the loudness meter's ring, hybrid vs eager, relative: K3 sums each
# hop's powers (up to F of them a block) in another order than torch's
# reduction, which moves a float32 sum of n non-negative terms by at most
# (n - 1) * 2^-24 relative, 7.6e-6 at F=128
RING_TOL = 1e-5
WITNESS = (1024, 8)          # 12(d): B, K
LU_TOL = 1e-3                # card vs CPU loudness readings, in LU


def mastering_stream(device: str, profile: bool = False) -> dict:
    """The mastering bus streamed offline through ``FirewheelCtx`` on
    ``device`` as ``examples/mastering_bus.py`` streams it: 48 kHz stereo,
    256-frame buffers and blocks, 4 s, the dialogue on from 1.0 s to 2.5 s
    (``examples.mastering_bus.dialogue_on``), the loudness meter read every
    100 ms into ``IntegratedLoudness``.  With ``profile``,
    ``torch.profiler`` traces buffers MASTER_PROFILED.
    Returns a dict of numpy results: the audio, each reading, the
    integrated loudness, the final state, the walls, K5's and K6's
    launches and the profile's counts.  The CPU's run goes on in a worker
    process (:class:`CpuStream`) while the card runs the earlier phases."""
    ft = _port()
    from firewheel_tpu_torch.convert import state_to_numpy
    from firewheel_tpu_torch.examples import mastering_bus
    from firewheel_tpu_torch.mixer import add_mastering_bus
    from firewheel_tpu_torch.nodes import IntegratedLoudness, LoudnessMeterNode
    from firewheel_tpu_torch.ops import dynamics, iir, noise

    cx = ft.FirewheelCtx(device=device)
    g = cx.graph_mut()
    ids = add_mastering_bus(g)
    voice = g.node(ids["voice"])
    sink = ft.ArraySink()
    frames = int(MASTER_SECS * 48000)
    cx.activate(ft.StreamConfig(48000, 2, buffer_frames=MASTER_BUFFER), sink=sink,
                duration_secs=MASTER_SECS)
    stream = cx.stream
    integ = IntegratedLoudness()
    out = {"walls": [], "reads": []}
    first, n_prof = MASTER_PROFILED
    trace = PumpTrace()
    dynamics.scan_lanes.launches = noise.noise_uniform.launches = 0
    iir.biquad_cascade.launches = 0
    t_start = time.perf_counter()
    i = 0
    while stream.frames_rendered < frames:
        sec = stream.frames_rendered / 48000
        voice.set_enabled(mastering_bus.dialogue_on(sec))
        if profile and i == first:
            trace.start()
        trace.pump(cx, 1, out["walls"])
        i += 1
        if trace.on and i == first + n_prof:
            prof, out["profile_wall"] = trace.stop(stream)
            out["profile"] = profile_busy(prof, n_prof)
        if len(out["reads"]) < int(stream.frames_rendered / 48000 * 10):
            r = LoudnessMeterNode.read(cx.node_state(ids["meter"]))
            integ.push(r["gating_block_lufs"])
            out["reads"].append([r["momentary_lufs"], r["short_term_lufs"],
                                 r["gating_block_lufs"]])
    stream.flush()
    if device != "cpu":
        torch.cuda.synchronize()
    out["wall"] = time.perf_counter() - t_start
    out["buffers"] = i
    out["k5"], out["k6"] = dynamics.scan_lanes.launches, noise.noise_uniform.launches
    out["k7"] = iir.biquad_cascade.launches
    out["integrated"] = integ.value()
    out["reads"] = np.asarray(out["reads"])
    out["state"] = state_to_numpy(stream._processor.state_dict())
    out["meter_key"] = ft.node_key(ids["meter"])
    out["audio"] = sink.audio(2)
    cx.deactivate()
    if out["audio"].shape != (2, frames):
        raise AssertionError(f"the bus streamed {out['audio'].shape}, expected "
                             f"{(2, frames)}")
    return out


def _cpu_stream_worker(conn) -> None:
    """The CPU's streams of 11(a), 12(a), 13(a), 14(a), 15(a) and 15(b) and
    19(d)'s examples in a worker process, on one thread; sends ``("ok",
    name, result)`` for each as it finishes (``"spatial"``,
    ``"mastering"``, ``"palette"``, ``"music"``, ``"pool"``, ``"jukebox"``,
    ``"examples"``), or ``("error", traceback)``, to the parent."""
    import traceback

    try:
        torch.set_num_threads(1)
        for name, run in (("spatial", lambda: spatial_stream(_port(), "cpu")),
                          ("mastering", lambda: mastering_stream("cpu")),
                          ("palette", lambda: palette_stream("cpu")),
                          ("music", music_reference),
                          ("pool", lambda: voice_pool_session("cpu")),
                          ("jukebox", lambda: jukebox_session("cpu")),
                          ("examples", lambda: nine_examples(
                              "cpu", scratch_dir("fw_nine_cpu_")))):
            conn.send(("ok", name, run()))
    except Exception:  # the worker's boundary: the parent raises it
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


class CpuStream:
    """The CPU streams of 11(a), 12(a), 13(a), 14(a), 15(a) and 15(b), started in a spawned worker
    process at once (or what another worker ``target`` sends: 18(a)'s CPU
    oracle).  ``get()[name]`` waits for that stream's result
    (raising what the worker raised, or if it died without one); :meth:`stop`
    ends the worker."""

    def __init__(self, target=None):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self._conn, child = ctx.Pipe(duplex=False)
        self._proc = ctx.Process(target=target or _cpu_stream_worker, args=(child,),
                                 daemon=True)
        self._proc.start()
        child.close()
        self._results: dict = {}

    def get(self) -> "CpuStream":
        return self

    def __getitem__(self, name: str) -> dict:
        while name not in self._results:
            while not self._conn.poll(1.0):
                if not self._proc.is_alive():
                    raise RuntimeError(f"the CPU stream's worker exited "
                                       f"({self._proc.exitcode}) without {name!r}")
            status, *value = self._conn.recv()
            if status != "ok":
                raise RuntimeError(f"the CPU stream failed in its worker:\n{value[0]}")
            self._results[value[0]] = value[1]
        return self._results[name]

    def stop(self) -> None:
        if self._proc.is_alive():
            self._proc.terminate()
        self._proc.join()
        self._conn.close()


#: the meter's leaves held by its readings: the K-weighting's 38 Hz
#: high-pass, a pole next to 1, amplifies an ulp of its input into its state,
#: and each 100 ms hop's energy is a sum of 4800 powers taken in another
#: order on each device (ops/iir.py, nodes/loudness.py)
METER_HELD_BY_READINGS = ("shelf_z", "hp_z", "ring")


def bus_state_err(a: dict, b: dict, meter_key: str):
    """``(largest abs difference of the float leaves but the meter's
    filter states and ring, {meter leaf: its largest abs difference, the
    ring's relative})`` of two bus states (numpy trees); integer and bool
    leaves must be equal."""
    err, meter = 0.0, {}
    for key in b:
        for leaf, y in b[key].items():
            x = a[key][leaf]
            if x.shape != y.shape or x.dtype != y.dtype:
                raise AssertionError(f"{key}/{leaf}: {x.dtype}{x.shape} vs "
                                     f"{y.dtype}{y.shape}")
            if x.dtype.kind != "f":
                if not np.array_equal(x, y):
                    raise AssertionError(f"{key}/{leaf} differs: {x} vs {y}")
            elif key == meter_key and leaf in METER_HELD_BY_READINGS:
                d = np.abs(x - y)
                if leaf == "ring":
                    d = d / np.maximum(np.abs(y), 1e-30)
                meter[leaf] = float(d.max())
            elif x.size:
                err = max(err, float(np.abs(x - y).max()))
    return err, meter


def master_stream_check(ft, cpu_result, card: str):
    """12(a): the bus streamed on the card against the CPU's stream (from
    the worker): the audio and every state leaf within 1e-5, but the
    meter's filter states and ring, which are held by its readings (every
    reading and the integrated loudness within 1e-3 LU) and printed."""
    from firewheel_tpu_torch.examples.mastering_bus import DIALOGUE

    out = mastering_stream("cuda", profile=True)
    cpu = cpu_result.get()["mastering"]
    audio_err = float(np.abs(out["audio"] - cpu["audio"]).max())
    state_err, meter_err = bus_state_err(out["state"], cpu["state"], out["meter_key"])
    finite = np.isfinite(cpu["reads"])
    reads_err = float(np.abs(np.where(finite, out["reads"] - cpu["reads"], 0.0)).max())
    if not (np.isfinite(out["audio"]).all() and audio_err <= SLICE_TOL
            and state_err <= SLICE_TOL and reads_err <= LU_TOL
            and np.array_equal(np.isfinite(out["reads"]), finite)
            and abs(out["integrated"] - cpu["integrated"]) <= LU_TOL):
        raise AssertionError(f"12(a): card vs CPU audio {audio_err}, state {state_err}, "
                             f"meter {meter_err}, readings {reads_err} LU, integrated "
                             f"{out['integrated']} vs {cpu['integrated']}")
    buffers = out["buffers"]
    if (out["k5"] != 4 * buffers or out["k6"] != buffers or out["k7"] != buffers
            or cpu["k5"] or cpu["k6"] or cpu["k7"]):
        raise AssertionError(f"12(a): K5 {out['k5']}, K6 {out['k6']}, K7 {out['k7']} "
                             f"launches in {buffers} blocks (CPU {cpu['k5']}, "
                             f"{cpu['k6']}, {cpu['k7']})")
    peak = float(np.abs(out["audio"]).max())
    if not 0.3 < peak <= 1.0:
        raise AssertionError(f"12(a): the bus peaks at {peak}")
    secs = MASTER_SECS
    walls = np.asarray(out["walls"]) * 1e3
    log(f"12(a), the mastering bus streamed on {card}: {buffers} buffers of "
        f"{MASTER_BUFFER} frames ({secs} s, dialogue {DIALOGUE[0]}–{DIALOGUE[1]} s), "
        f"{len(out['reads'])} meter readings; card vs CPU: audio max_abs_err="
        f"{audio_err:.3e}, state {state_err:.3e} (but the meter's), readings "
        f"{reads_err:.3e} LU; the meter's shelf state {meter_err['shelf_z']:.3e}, "
        f"high-pass state {meter_err['hp_z']:.3e}, ring {meter_err['ring']:.3e} "
        f"relative; peak {peak:.4f}")
    log(f"12(a): integrated loudness (R128 gate) card {out['integrated']:.4f} LUFS, "
        f"CPU {cpu['integrated']:.4f} LUFS; final short-term card "
        f"{out['reads'][-1][1]:.4f}, CPU {cpu['reads'][-1][1]:.4f} LUFS")
    k_block, calls, busy = out.get("profile", (0.0, 0.0, 0.0))
    busy_share = busy / 1e6 / out.get("profile_wall", float("inf"))
    n_prof = MASTER_PROFILED[1]
    log(f"12(a): stream realtime factor card {secs / out['wall']:.3f} ({out['wall']:.3f} "
        f"s), CPU {secs / cpu['wall']:.3f} ({cpu['wall']:.3f} s, the worker process); "
        f"wall a buffer p50 {np.percentile(walls, 50):.3f} ms, p99 "
        f"{np.percentile(walls, 99):.3f} ms (budget {MASTER_BUFFER / 48:.3f} ms); "
        f"K5 {out['k5'] / buffers:.0f}, K6 {out['k6'] / buffers:.0f} and K7 "
        f"{out['k7'] / buffers:.0f} (the meter's K-weighting) launches a "
        f"block; over {n_prof} profiled buffers {k_block:.1f} kernels a block on "
        f"the device for {calls:.1f} launch calls, device busy {busy:.0f} us, "
        f"{100 * busy_share:.2f}% of their wall (0 when the profile saw no "
        f"device activity)")
    return audio_err, out["k5"], out["k6"], out["k7"]


def master_batched(ft, seq_iir, dynamics, noise, card: str):
    """12(b): the bus eager at B=8192, K=32, per-instance params
    (``vary_mastering_params``); the first instances against a CPU render
    of the same instances.  Returns the error and K5's and K6's
    launches."""
    from firewheel_tpu_torch.convert import tree_map
    from firewheel_tpu_torch.mixer import vary_mastering_params
    from firewheel_tpu_torch.ops import iir

    prog = ft.mastering_bus_graph(device="cuda")
    br = ft.BatchRenderer(prog, B, device="cuda")
    params = vary_mastering_params(prog, br.stack_params(), seed=12)
    state = br.init_state()
    cprog = ft.mastering_bus_graph(device="cpu")
    cbr = ft.BatchRenderer(cprog, MASTER_CHECK, device="cpu")
    cparams = tree_map(lambda t: t[:MASTER_CHECK].cpu().clone(), params)
    cstate = cbr.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path, counts set to 0 just before it
    dynamics.scan_lanes.launches = noise.noise_uniform.launches = 0
    seq_iir.biquad_seq.launches = iir.biquad_cascade.launches = 0
    walls, firsts = [], []
    for c in range(MASTER_CHUNKS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, om, state = br.render_chunk(params, state, start_sample=c * K * 128,
                                         num_blocks=K)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if not torch.isfinite(out).all():
            raise AssertionError(f"12(b): chunk {c} is not finite")
        firsts.append((out[:MASTER_CHECK].cpu(), om[:MASTER_CHECK].cpu()))
    k5, k6, k1 = dynamics.scan_lanes.launches, noise.noise_uniform.launches, \
        seq_iir.biquad_seq.launches
    k7 = iir.biquad_cascade.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if (k5 != 4 * K * MASTER_CHUNKS or k6 != K * MASTER_CHUNKS or k1
            or k7 != K * MASTER_CHUNKS):
        raise AssertionError(f"12(b): K5 {k5}, K6 {k6}, K1 {k1}, K7 {k7} launches in "
                             f"{MASTER_CHUNKS} chunks of K={K}")
    err = 0.0
    for c in range(MASTER_COMPARED):
        cout, cmask, cstate = cbr.render_chunk(cparams, cstate, start_sample=c * K * 128,
                                               num_blocks=K)
        if not torch.equal(cmask, firsts[c][1]):
            raise AssertionError(f"12(b): chunk {c}'s masks differ from the CPU's")
        err = max(err, float((cout - firsts[c][0]).abs().max()))
    loud = float(firsts[-1][0].abs().max())
    if not err <= SLICE_TOL or loud < 0.05:
        raise AssertionError(f"12(b): first instances vs the CPU {err}, peak {loud}")
    wall = sum(walls[1:]) / (MASTER_CHUNKS - 1)
    audio_secs = B * K * 128 / 48000
    log(f"12(b), the mastering bus eager on {card}: B={B}, K={K}, per-instance "
        f"seeds, thresholds, duck depth, makeup and dialogue; instances "
        f"0..{MASTER_CHECK - 1} vs the CPU over {MASTER_COMPARED} chunks: "
        f"max_abs_err={err:.3e}; wall per chunk "
        f"{' / '.join(f'{w * 1e3:.3f}' for w in walls)} ms (the first a warm-up), "
        f"{wall * 1e3:.3f} ms after it, realtime factor {audio_secs / wall:.1f}; "
        f"peak memory {peak_gb:.3f} GB; K5 {k5 // MASTER_CHUNKS}, K6 "
        f"{k6 // MASTER_CHUNKS} and K7 {k7 // MASTER_CHUNKS} launches a chunk, K1 none")
    return err, k5, k6


def island_times(em, prog, split, render, compare, start: int, tag: str):
    """K3 on each island of ``split`` (a ``HybridMegaRenderer``) at the
    operands of the chunk at ``start`` that ``render()`` renders: against
    its plain version at the same operands (``compare(i, kernel's (out,
    flags, state), plain's)``), then its device time, a call's, the plain
    version's and its work, each logged → their sums over the islands,
    ``(ms, call_ms, plain_ms, (bytes, ops))``."""
    b, k = split.batch, split.num_blocks
    calls = {}
    launch_island = split._launch

    def record(i, *args):
        calls[i] = args
        return launch_island(i, *args)

    split._launch = record
    render()
    del split._launch
    ms_sum = call_sum = plain_sum = 0.0
    bytes_sum = ops_sum = 0
    for i, (pseg, sseg, env, env_flags) in sorted(calls.items()):
        lw = split.islands[i]
        got = launch_island(i, pseg, sseg, env, env_flags)
        want = em.island_chunk_reference(prog, lw, pseg, sseg, env, env_flags, start, k, b)
        torch.cuda.synchronize()
        compare(i, got, want)
        island = lambda: launch_island(i, pseg, sseg, env, env_flags)  # noqa: E731
        ms = device_ms(island, "island_kernel", KERNEL_REPS)
        call = cuda_ms(island, KERNEL_REPS)
        plain = cuda_ms(lambda: em.island_chunk_reference(
            prog, lw, pseg, sseg, env, env_flags, start, k, b), 1)
        nbytes, ops = kernel_work(em, prog, lw, pseg, sseg, b, k, got[0].nbytes
                                  + got[1].nbytes + env.nbytes + env_flags.nbytes)
        log(f"{tag}: K3 on island {i} ({len(lw.keys)} rows, {lw.in_bufs.size} live-ins, "
            f"{em.shared_bytes(lw, split.tile)} B of shared memory a CTA) vs its plain "
            f"version as checked above; {ms:.4f} ms on the device, {call:.4f} ms a call "
            f"(CUDA events), plain {plain:.3f} ms; bound {bound(nbytes, ops)[0]:.4f} ms by "
            f"{bound(nbytes, ops)[1]}")
        ms_sum, call_sum, plain_sum = ms_sum + ms, call_sum + call, plain_sum + plain
        bytes_sum, ops_sum = bytes_sum + nbytes, ops_sum + ops
    return ms_sum, call_sum, plain_sum, (bytes_sum, ops_sum)


def ring_err(a: dict, b: dict, meter_key: str) -> float:
    """The loudness meter's ring's relative difference between two bus
    states on the card (trees of tensors), every other leaf equal: the
    lowerings sum each hop's powers in another order (``RING_TOL``)."""
    numpy = lambda t: {key: {leaf: v.cpu().numpy() for leaf, v in st.items()}  # noqa: E731
                       for key, st in t.items() if isinstance(st, dict)}
    err, meter = bus_state_err(numpy(a), numpy(b), meter_key)
    if err != 0.0 or meter.get("shelf_z", 0.0) or meter.get("hp_z", 0.0):
        raise AssertionError(f"bus states differ: {err}, the meter's {meter}")
    if not meter.get("ring", 0.0) <= RING_TOL:
        raise AssertionError(f"the meter's ring {meter['ring']} relative "
                             f"(limit {RING_TOL})")
    return meter.get("ring", 0.0)


def master_lowerings(ft, em, eh, dynamics, noise, card: str):
    """12(c): ``MegaRenderer`` refuses the bus (the noise and the FIR have no
    row, as in the JAX package); the hybrid at B=1024, K=8 and B=8192, K=32
    splits it as the JAX package does, [noise] torch | [beep, ducker, sum,
    compressor] K3 | [FIR] torch | [limiter, loudness meter] K3: two K3
    launches a chunk, K5 and K6 once a block (the pink noise), no K7.
    Against eager on the card: outputs, masks and every state leaf bit for
    bit, but the meter's ring within ``RING_TOL`` relative.  At B=8192, K=32
    each island is held against its plain version at the same operands and
    timed.  Returns ``(err, the kernels line's tuple for K3 on the bus)``."""
    from firewheel_tpu_torch.mixer import vary_mastering_params
    from firewheel_tpu_torch.ops import iir

    prog = ft.mastering_bus_graph(device="cuda")
    meter_key = next(key for key in prog._procs if key.startswith("loudness_meter"))
    em.MegaRenderer.launches = 0
    try:
        em.MegaRenderer(prog, 1, 1, device="cuda")
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("12(c): MegaRenderer accepted the mastering bus")
    if em.MegaRenderer.launches:
        raise AssertionError("12(c): K2 launched")

    def counts():
        return (eh.HybridMegaRenderer.launches, dynamics.scan_lanes.launches,
                noise.noise_uniform.launches, iir.biquad_cascade.launches)

    ring = 0.0
    for b, k in MASTER_HYBRID:
        hy = ft.BatchRenderer(prog, b, device="cuda", lowering="hybrid")
        eg = ft.BatchRenderer(prog, b, device="cuda")
        params = vary_mastering_params(prog, eg.stack_params(), seed=13)
        states = {"hybrid": hy.init_state(), "eager": eg.init_state()}
        walls = {"hybrid": [], "eager": []}
        got = {}
        for c in range(MASTER_LOWERED_CHUNKS):
            res = {}
            for name, r in (("hybrid", hy), ("eager", eg)):
                # the main path: counts set to 0 just before each chunk
                eh.HybridMegaRenderer.launches = dynamics.scan_lanes.launches = 0
                noise.noise_uniform.launches = iir.biquad_cascade.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out, om, states[name] = r.render_chunk(params, states[name],
                                                       start_sample=c * k * 128,
                                                       num_blocks=k)
                torch.cuda.synchronize()
                walls[name].append(time.perf_counter() - t0)
                got[name] = counts()
                res[name] = (out, om)
            if got["hybrid"] != (2, k, k, 0):
                raise AssertionError(f"12(c): B={b} K={k}, launches (K3, K5, K6, K7) "
                                     f"{got['hybrid']} in a chunk")
            if not (torch.equal(res["hybrid"][0], res["eager"][0])
                    and torch.equal(res["hybrid"][1], res["eager"][1])):
                e = float((res["hybrid"][0] - res["eager"][0]).abs().max())
                raise AssertionError(f"12(c): B={b} K={k} chunk {c}: hybrid vs eager "
                                     f"{e}, or masks")
            if not bool(torch.isfinite(res["hybrid"][0]).all()):
                raise AssertionError(f"12(c): B={b} K={k}: non-finite output")
        ring = max(ring, ring_err(states["hybrid"], states["eager"], meter_key))
        split = hy._chunk_cache[("hybrid", k)]
        segments = [(kind, [type(prog._procs[ft.node_key(sn.id)]).__name__
                            for sn in nodes]) for kind, nodes in split.segments]
        if [kind for kind, _ in segments] != ["xla", "mega", "xla", "mega"]:
            raise AssertionError(f"12(c): segments {segments}")
        h_wall = sum(walls["hybrid"][1:]) / (MASTER_LOWERED_CHUNKS - 1)
        e_wall = sum(walls["eager"][1:]) / (MASTER_LOWERED_CHUNKS - 1)
        audio_secs = b * k * 128 / 48000
        log(f"12(c), the bus's hybrid at B={b}, K={k} on {card}: {segments}; against "
            f"eager over {MASTER_LOWERED_CHUNKS} chunks outputs, masks and every state "
            f"leaf bit for bit but the meter's ring ({ring:.3e} relative, limit "
            f"{RING_TOL:g}); a chunk launches K3 {got['hybrid'][0]}, K5 "
            f"{got['hybrid'][1]}, K6 {got['hybrid'][2]}, K7 {got['hybrid'][3]} times "
            f"(eager: {got['eager'][1:]}); wall a chunk after the first: hybrid "
            f"{h_wall * 1e3:.3f} ms (realtime factor {audio_secs / h_wall:.1f}), eager "
            f"{e_wall * 1e3:.3f} ms (realtime factor {audio_secs / e_wall:.1f})")
    h_launches = 2 * MASTER_LOWERED_CHUNKS  # the last configuration's, counted above

    # each island of the last configuration against its plain version at the
    # same operands, and timed
    def agree(i, got, want):
        nonlocal ring
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"12(c): island {i}: K3 vs its plain version "
                                 f"{float((got[0] - want[0]).abs().max())}, or flags")
        ring = max(ring, ring_err(got[2], want[2], meter_key))

    k3_ms, k3_call, k3_plain, (k3_bytes, k3_ops) = island_times(
        em, prog, split, lambda: hy.render_chunk(params, states["hybrid"], start_sample=0,
                                                 num_blocks=k),
        agree, 0, "12(c)")
    log(f"12(c): MegaRenderer refuses the bus (ValueError: {refused[:60]}...); K3 on "
        f"both islands at B={b}, K={k}: {k3_ms:.4f} ms on the device, bound "
        f"{bound(k3_bytes, k3_ops)[0]:.4f} ms")
    return ring, (h_launches, ring, k3_ms, k3_call, k3_plain, (k3_bytes, k3_ops))


def witness_graph(ft, frames: int):
    """The rows the bus lacks in one graph: a beep through a limiter and dry
    into a sum, with an LFO; the latency pass splices a delay compensator
    into the dry edges and the LFO's; the sum into a 0-output meter and the
    output.  Every node has a row, so K2 renders it whole."""
    from firewheel_tpu_torch import nodes as n

    g = ft.AudioGraph(ft.AudioGraphConfig(0, 2))
    beep = g.add_node(0, 2, n.BeepTestNode(440.0, -6.0, True))
    lim = g.add_node(2, 2, n.LimiterNode(ceiling_db=-9.0, lookahead_secs=0.003))
    lfo = g.add_node(0, 2, n.LFONode(n.LFOShape.TRIANGLE, 3.0, 0.1, 0.0))
    mix = g.add_node(6, 2, n.SumNode())
    meter = g.add_node(2, 0, n.DbMeterNode())
    for c in range(2):
        g.connect(beep, c, lim, c)
        g.connect(lim, c, mix, c)
        g.connect(beep, c, mix, 2 + c)
        g.connect(lfo, c, mix, 4 + c)
        g.connect(mix, c, meter, c)
        g.connect(mix, c, g.graph_out_node(), c)
    g.compensate_latency(48000)
    pkg = g.compile(48000, frames)
    return ft.ScheduleProgram(pkg.schedule, dict(pkg.new_node_processors), 48000,
                              device="cuda")


def master_witness(ft, em, eh, card: str):
    """12(d): the witness graph through K2 and through the hybrid (one K3
    island) against eager on the card at B=1024, K=8, in blocks of 128 and
    of 127 frames, over three chunks with each beep off in a different
    third of the instances and each LFO instance its own wave: outputs and
    masks bit for bit, every state leaf within ``MEGA_TOL`` (the sink
    meter's mean square sums in another order at 127 frames); one launch a
    chunk each; K2 against its plain version for the first instances."""
    from firewheel_tpu_torch.convert import tree_map

    b, k = WITNESS
    worst = 0.0
    for frames in (128, 127):
        prog = witness_graph(ft, frames)
        kinds = sorted({type(p).__name__ for p in prog._procs.values()})
        mega = em.MegaRenderer(prog, b, k, device="cuda")
        hy = ft.BatchRenderer(prog, b, device="cuda", lowering="hybrid")
        eg = ft.BatchRenderer(prog, b, device="cuda")
        states = {"K2": mega.init_state(), "hybrid": hy.init_state(),
                  "eager": eg.init_state()}
        for c in range(3):
            params = eg.stack_params()
            for key, proc in prog._procs.items():
                name = type(proc).__name__
                if name == "BeepTestProcessor":
                    params[key]["enabled"] = (torch.arange(b, device="cuda") + c) % 3 != 0
                elif name == "LFOProcessor":
                    params[key]["shape"] = torch.arange(b, device="cuda") % 4
            res = {}
            before = states["K2"]
            em.MegaRenderer.launches = eh.HybridMegaRenderer.launches = 0
            res["K2"] = mega.render_chunk(params, before, c * k * frames)
            res["hybrid"] = hy.render_chunk(params, states["hybrid"],
                                            start_sample=c * k * frames, num_blocks=k)
            torch.cuda.synchronize()
            if (em.MegaRenderer.launches, eh.HybridMegaRenderer.launches) != (1, 1):
                raise AssertionError(f"12(d): F={frames}: K2 {em.MegaRenderer.launches}, "
                                     f"K3 {eh.HybridMegaRenderer.launches} launches")
            res["eager"] = eg.render_chunk(params, states["eager"],
                                           start_sample=c * k * frames, num_blocks=k)
            torch.cuda.synchronize()
            for name in ("K2", "hybrid"):
                o, m, states[name] = res[name]
                if not (torch.equal(o, res["eager"][0]) and torch.equal(m, res["eager"][1])):
                    raise AssertionError(f"12(d): {name} at F={frames} chunk {c}: vs eager "
                                         f"{float((o - res['eager'][0]).abs().max())}, "
                                         f"or masks")
            states["eager"] = res["eager"][2]
        # the last chunk's first instances again by the plain version
        head = lambda t: t[:CHECK_INSTANCES].contiguous()  # noqa: E731
        ro, rm, _ = em.mega_chunk_reference(prog, mega.lowered, tree_map(head, params),
                                            tree_map(head, before), 2 * k * frames, k,
                                            CHECK_INSTANCES)
        if not (torch.equal(ro, res["K2"][0][:CHECK_INSTANCES])
                and torch.equal(rm, res["K2"][1][:CHECK_INSTANCES])):
            raise AssertionError(f"12(d): K2 at F={frames} vs its plain version")
        errs = [tree_err(states[name], states["eager"]) for name in ("K2", "hybrid")]
        peak = float(res["eager"][0].abs().max())
        if not max(errs) <= MEGA_TOL or not 0.05 < peak:
            raise AssertionError(f"12(d): F={frames}: state {errs}, peak {peak}")
        worst = max(worst, *errs)
        log(f"12(d), the witness graph ({kinds}) at F={frames}, B={b}, K={k} on {card}: "
            f"K2 and the hybrid ({[kind for kind, _ in hy._chunk_cache[('hybrid', k)].segments]}"
            f") against eager over 3 chunks, outputs and masks bit for bit, state "
            f"{errs[0]:.3e} and {errs[1]:.3e}; one launch a chunk each; K2 vs its plain "
            f"version for the first {CHECK_INSTANCES} instances bit for bit")
    return worst


def check_mastering(ft, seq_iir, em, eh, dynamics, noise, cpu_result, card: str, phase):
    """Phase 12: the mastering bus on the card → ``(err, K5 and K6 launches
    on the batched path, K5, K6 and K7 in the stream, K3's tuple on the
    bus)``."""
    s_err, s_k5, s_k6, s_k7 = master_stream_check(ft, cpu_result, card)
    phase("12(a), the bus streamed")
    b_err, k5, k6 = master_batched(ft, seq_iir, dynamics, noise, card)
    torch.cuda.empty_cache()
    phase("12(b), the bus eager at B=8192, K=32")
    h_err, k3 = master_lowerings(ft, em, eh, dynamics, noise, card)
    torch.cuda.empty_cache()
    phase("12(c), the bus's lowerings")
    w_err = master_witness(ft, em, eh, card)
    phase("12(d), the witness graph on K2 and the hybrid")
    return max(s_err, b_err, w_err), k5, k6, s_k5, s_k6, s_k7, k3


# phase 13: the FX palette (examples/interactive_graph.py)
PALETTE_PUMP_BUFFERS = 8     # 1024-frame buffers a pump, of 128-frame blocks
#: pump before which the master insert changes
PALETTE_SWITCHES = {2: "eq", 4: "chorus", 6: "flanger", 8: "tremolo",
                    10: "waveshaper", 12: "gate", 14: None}
PALETTE_EDITS_AT = 15        # pump before which a volume, a pan and a frequency change
PALETTE_REMOVE_AT, PALETTE_ADD_AT = 16, 17   # pumps before which a voice goes, one comes
PALETTE_PUMPS = 18           # 18 x 8 x 1024 frames, 3.07 s
PALETTE_PROFILED = (1, 3, 5, 7, 9, 11, 13)   # the second pump of each kind, profiled
PALETTE_EQ_BANDS = 3
PALETTE_CHUNKS = 3           # 13(b): chunks at B=8192, K=32
PALETTE_COMPARED = 2         # 13(b): chunks compared with the CPU render
PALETTE_HYBRID = (1024, 8)   # 13(c): B, K
PALETTE_MEGA_FRAMES = (128, 127)  # 13(c): K2's block sizes (127: F read at run time)
# 13(b): the card vs the CPU.  The EQ's 150 Hz low shelf, run as JAX's
# associative scan in float32, turns an ulp of its input into up to ~2.4e-5
# of output (on the CPU alone, nudging 10% of the beeps' samples by one ulp
# moves the EQ's output by 2.37e-5 and the graph's by 2.89e-5), and the
# card's sin, cos and exp differ from the CPU's by an ulp; K7 itself is held
# bit for bit against the plain scans on the card in the same phase, and the
# same instances with every EQ band bypassed are held to SLICE_TOL (1e-5)
PALETTE_SLICE_TOL = 1e-4


def palette_stream(device: str, profile: bool = False) -> dict:
    """The example's engine (``mixer.add_fx_engine``: two voices → sum →
    clip → meter) streamed offline through ``FirewheelCtx`` on ``device``:
    1024-frame buffers of 128-frame blocks, 8 a pump, PALETTE_PUMPS pumps; the
    master insert switched through every kind of the palette and back to
    none (``mixer.set_fx``, topology edits hot-swapped with state
    migration), then a volume, a pan and a frequency change, a voice removed
    and one added.  With ``profile``, ``torch.profiler`` traces pumps
    PALETTE_PROFILED, one buffer each.  Returns a dict of numpy results: the
    audio, the final state, the walls, K7's launches and, profiled, the
    kernels a block of each kind."""
    ft = _port()
    from firewheel_tpu_torch.convert import state_to_numpy
    from firewheel_tpu_torch.mixer import add_fx_engine, add_fx_voice, set_fx
    from firewheel_tpu_torch.ops import iir

    cx = ft.FirewheelCtx(device=device)
    g = cx.graph_mut()
    ids = add_fx_engine(g)
    sink = ft.ArraySink()
    cfg = ft.StreamConfig(buffer_frames=STREAM_BUFFER, block_frames=STREAM_BLOCK,
                          chunk_buffers=PALETTE_PUMP_BUFFERS)
    cx.activate(cfg, sink=sink)
    stream = cx.stream
    out = {"walls": [], "kernels": {}}
    trace = PumpTrace()
    kind = "none"
    iir.biquad_cascade.launches = iir.one_pole_scan.launches = 0
    buffers = 0
    t_start = time.perf_counter()
    for i in range(PALETTE_PUMPS):
        if i in PALETTE_SWITCHES:
            kind = PALETTE_SWITCHES[i] or "none"
            set_fx(g, ids, PALETTE_SWITCHES[i])
        if i == PALETTE_EDITS_AT:
            beep, vol, pan = ids["voices"][0]
            g.node(vol).set_percent_volume(50.0)
            g.node(pan).set_pan(0.5)
            g.node(beep).set_frequency(550.0)
        if i == PALETTE_REMOVE_AT:
            for nid in ids["voices"].pop():
                g.remove_node(nid)
        if i == PALETTE_ADD_AT:
            ids["voices"].append(add_fx_voice(g, ids["sum"], len(ids["voices"]), 330.0))
        if profile and i in PALETTE_PROFILED:
            trace.start()
        # a profiled pump renders one buffer: its 8 blocks are enough to
        # count, and reading a profile costs seconds a thousand kernels
        n = 1 if trace.on else PALETTE_PUMP_BUFFERS
        trace.pump(cx, n, out["walls"])
        buffers += n
        if trace.on:
            prof, _ = trace.stop(stream)
            out["kernels"][kind] = profile_busy(prof, STREAM_BUFFER // STREAM_BLOCK)[0]
    stream.flush()
    if device != "cpu":
        torch.cuda.synchronize()
    out["wall"] = time.perf_counter() - t_start
    out["k7"] = (iir.biquad_cascade.launches, iir.one_pole_scan.launches)
    out["state"] = state_to_numpy(stream._processor.state_dict())
    out["audio"] = sink.audio(2)
    cx.deactivate()
    frames = buffers * STREAM_BUFFER
    if out["audio"].shape != (2, frames):
        raise AssertionError(f"the FX stream rendered {out['audio'].shape}, expected "
                             f"{(2, frames)}")
    return out


def palette_stream_check(ft, iir, cpu_result, card: str):
    """13(a): the FX engine streamed on the card against the CPU's stream
    (from the worker): audio and every state leaf within 1e-5; K7 one
    launch a block (the EQ's bands, one cascade) while the EQ is in; walls, realtime
    factor and, profiled, the kernels a block of each kind."""
    from firewheel_tpu_torch.convert import tree_map

    run = palette_stream("cuda")
    cpu = cpu_result.get()["palette"]
    prof = palette_stream("cuda", profile=True)
    err = float(np.abs(run["audio"] - cpu["audio"]).max())
    state_err = tree_err(*(tree_map(torch.from_numpy, r["state"]) for r in (run, cpu)))
    if not max(err, state_err) <= STREAM_TOL or not np.isfinite(run["audio"]).all():
        raise AssertionError(f"13(a): the FX stream vs the CPU's: audio {err}, state "
                             f"{state_err}")
    # a switch is staged and installs after the pump it precedes, with one
    # throwaway block (``GraphProcessor.advance_pending``): the EQ renders
    # two pumps of blocks and that block
    eq_blocks = 2 * PALETTE_PUMP_BUFFERS * STREAM_BUFFER // STREAM_BLOCK + 1
    if run["k7"] != (eq_blocks, 0) or cpu["k7"] != (0, 0):
        raise AssertionError(f"13(a): K7 launches {run['k7']} (biquad, one-pole) for "
                             f"{eq_blocks} blocks with the EQ; CPU {cpu['k7']}")
    peak = float(np.abs(run["audio"]).max())
    if not 0.05 < peak <= 1.0:
        raise AssertionError(f"13(a): the FX stream peaks at {peak}")
    audio_secs = run["audio"].shape[1] / 48000
    walls = np.asarray(run["walls"][1:]) * 1e3 / PALETTE_PUMP_BUFFERS
    kinds = [k or "none" for k in PALETTE_SWITCHES.values()]
    log(f"13(a), the FX engine streamed on {card}: {PALETTE_PUMPS} pumps of "
        f"{PALETTE_PUMP_BUFFERS} buffers ({audio_secs:.3f} s), the master insert "
        f"through {kinds}, then a volume, a pan and a frequency change, a voice "
        f"removed and one added; card vs CPU: audio "
        f"max_abs_err={err:.3e}, state {state_err:.3e}; peak {peak:.4f}; K7 "
        f"{run['k7'][0]} biquad launches (one a block, the EQ's {PALETTE_EQ_BANDS} "
        f"bands in one cascade, over {eq_blocks} blocks with the EQ, its throwaway "
        f"block included), {run['k7'][1]} one-pole")
    log(f"13(a): realtime factor card {audio_secs / run['wall']:.3f} ({run['wall']:.3f} "
        f"s), CPU {audio_secs / cpu['wall']:.3f} (the worker process); wall a "
        f"1024-frame buffer (a pump / {PALETTE_PUMP_BUFFERS}) p50 "
        f"{np.percentile(walls, 50):.3f} ms, p99 {np.percentile(walls, 99):.3f} ms "
        f"(budget 21.333 ms)")
    log("13(a), torch.profiler, one buffer of each kind: kernels a block on the device "
        + ", ".join(f"{k} {v:.1f}" for k, v in prof["kernels"].items())
        + " (0 when the profile saw no device activity)")
    return err, run["k7"]


def plain_scans(fn):
    """``fn()`` with the FX nodes' scans (the EQ's bands, the waveshaper's DC
    blocker) swapped for K7's plain versions, on the card."""
    from firewheel_tpu_torch.nodes import eq, waveshaper
    from firewheel_tpu_torch.ops import iir

    saved = eq.biquad_cascade, waveshaper.one_pole_scan
    eq.biquad_cascade = iir.biquad_cascade_reference
    waveshaper.one_pole_scan = iir.one_pole_scan_reference
    try:
        return fn()
    finally:
        eq.biquad_cascade, waveshaper.one_pole_scan = saved


def palette_batched(ft, iir, card: str):
    """13(b): ``fx_palette_graph`` eager at B=8192, K=32 with per-instance
    params (``vary_fx_params``); its first chunk again with the plain scans
    in K7's place, bit for bit; the first instances against a CPU render.
    Returns the error against the CPU and K7's launches (biquad,
    one-pole)."""
    from firewheel_tpu_torch.convert import tree_map
    from firewheel_tpu_torch.mixer import vary_fx_params

    prog = ft.fx_palette_graph(device="cuda")
    br = ft.BatchRenderer(prog, B, device="cuda")
    params = vary_fx_params(prog, br.stack_params(), seed=13)
    state = state0 = br.init_state()
    cbr = ft.BatchRenderer(ft.fx_palette_graph(device="cpu"), CHECK_INSTANCES,
                           device="cpu")
    cparams = tree_map(lambda t: t[:CHECK_INSTANCES].cpu().clone(), params)
    cstate = cbr.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path, counts set to 0 just before it
    iir.biquad_cascade.launches = iir.one_pole_scan.launches = 0
    walls, firsts = [], []
    for c in range(PALETTE_CHUNKS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, om, state = br.render_chunk(params, state, start_sample=c * K * 128,
                                         num_blocks=K)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if not torch.isfinite(out).all():
            raise AssertionError(f"13(b): chunk {c} is not finite")
        firsts.append((out[:CHECK_INSTANCES].cpu(), om[:CHECK_INSTANCES].cpu()))
        if c == 0:
            chunk0 = (out, om, state)
    k7 = (iir.biquad_cascade.launches, iir.one_pole_scan.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the EQ's bands one cascade a block, the fold's DC blocker one one-pole
    if k7 != (K * PALETTE_CHUNKS, K * PALETTE_CHUNKS):
        raise AssertionError(f"13(b): K7 launches {k7} (biquad, one-pole) in "
                             f"{PALETTE_CHUNKS} chunks of K={K}")
    # K7 in place: the first chunk with the plain scans, on the card
    po, pm, ps = plain_scans(lambda: br.render_chunk(params, state0, start_sample=0,
                                                     num_blocks=K))
    torch.cuda.synchronize()
    plain_err = max(float((po - chunk0[0]).abs().max()), tree_err(ps, chunk0[2]))
    if plain_err != 0.0 or not torch.equal(pm, chunk0[1]):
        raise AssertionError(f"13(b): K7 vs the plain scans in the graph: {plain_err}, "
                             f"masks equal {torch.equal(pm, chunk0[1])}")
    del po, pm, ps, chunk0
    err = 0.0
    for c in range(PALETTE_COMPARED):
        cout, cmask, cstate = cbr.render_chunk(cparams, cstate, start_sample=c * K * 128,
                                               num_blocks=K)
        if not torch.equal(cmask, firsts[c][1]):
            raise AssertionError(f"13(b): chunk {c}'s masks differ from the CPU's")
        err = max(err, float((cout - firsts[c][0]).abs().max()))
    loud = float(firsts[-1][0].abs().max())
    if not err <= PALETTE_SLICE_TOL or loud < 0.05:
        raise AssertionError(f"13(b): first instances vs the CPU {err}, peak {loud}")
    # the witness for PALETTE_SLICE_TOL: the same instances with every EQ band
    # the identity section, the card against the CPU, within SLICE_TOL
    bypass = tree_map(lambda t: t[:CHECK_INSTANCES].clone(), params)
    for key, proc in prog._procs.items():
        if type(proc).__name__ == "ParametricEQProcessor":
            for band in bypass[key]["bands"].values():
                for name, t in band.items():
                    t.fill_(1.0 if name == "b0" else 0.0)
    small = ft.BatchRenderer(prog, CHECK_INSTANCES, device="cuda")
    bo, bm, _ = small.render_chunk(bypass, small.init_state(), start_sample=0,
                                   num_blocks=K)
    co, cm, _ = cbr.render_chunk(tree_map(lambda t: t.cpu(), bypass), cbr.init_state(),
                                 start_sample=0, num_blocks=K)
    bypass_err = float((bo.cpu() - co).abs().max())
    if not bypass_err <= SLICE_TOL or not torch.equal(bm.cpu(), cm):
        raise AssertionError(f"13(b): with the EQ bypassed, the card vs the CPU "
                             f"{bypass_err} (limit {SLICE_TOL})")
    wall = sum(walls[1:]) / (PALETTE_CHUNKS - 1)
    audio_secs = B * K * 128 / 48000
    log(f"13(b), the FX palette eager on {card}: {len(prog.schedule.schedule)} nodes, "
        f"B={B}, K={K}, per-instance voices, EQ gains, chorus rate, drives, width and "
        f"pitch; the first chunk with the plain scans in K7's place: bit for bit "
        f"(outputs, masks, every state leaf); instances 0..{CHECK_INSTANCES - 1} vs "
        f"the CPU over {PALETTE_COMPARED} chunks: max_abs_err={err:.3e} (limit "
        f"{PALETTE_SLICE_TOL:g}: the EQ's low shelf amplifies the devices' ulps; with "
        f"every EQ band bypassed, one chunk: {bypass_err:.3e}, limit {SLICE_TOL:g}); "
        f"wall per chunk "
        f"{' / '.join(f'{w * 1e3:.3f}' for w in walls)} ms (the first a warm-up), "
        f"{wall * 1e3:.3f} ms after it, realtime factor {audio_secs / wall:.1f}; peak "
        f"memory {peak_gb:.3f} GB; K7 {k7[0] // PALETTE_CHUNKS} biquad and "
        f"{k7[1] // PALETTE_CHUNKS} one-pole launches a chunk")
    return err, k7


def palette_lowerings(ft, em, eh, iir, card: str):
    """13(c): ``MegaRenderer`` refuses the FX palette (the flanger's feedback
    program has no row); without the flanger K2 renders it at B=1024, K=8,
    equal to eager on the card (outputs and masks bit for bit, state to
    MEGA_TOL: the meter's mean square sums in another order at 127 frames)
    in blocks of 128 and of 127 frames.  The hybrid at B=1024, K=8 splits
    the palette as the JAX package does: the voices, sum, clip, EQ and
    chorus one K3 island, the flanger a torch stage, the rest a second
    island; it equals eager bit for bit.  K2
    and each island are held against their plain versions at the same
    operands and timed.  Returns ``(err, K2's tuple, K3's tuple)``, each
    tuple (launches, err, ms, call_ms, plain_ms, work) for the kernels
    line."""
    from firewheel_tpu_torch.mixer import FX_KINDS, vary_fx_params

    b, k = PALETTE_HYBRID
    prog = ft.fx_palette_graph(device="cuda")
    em.MegaRenderer.launches = 0
    try:
        em.MegaRenderer(prog, b, k, device="cuda")
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("13(c): MegaRenderer accepted the FX palette")

    def k7():
        return iir.biquad_cascade.launches, iir.one_pole_scan.launches

    # K2 on the palette without the flanger, against eager
    kinds = tuple(kind for kind in FX_KINDS if kind != "flanger")
    m_errs = {}
    for frames in PALETTE_MEGA_FRAMES:
        p2 = ft.fx_palette_graph(device="cuda", kinds=kinds, block_frames=frames)
        mega = em.MegaRenderer(p2, b, k, device="cuda")
        eg = ft.BatchRenderer(p2, b, device="cuda")
        params = vary_fx_params(p2, eg.stack_params(), seed=15)
        states = [mega.init_state(), eg.init_state()]
        em.MegaRenderer.launches = 0
        iir.biquad_cascade.launches = iir.one_pole_scan.launches = 0
        for c in range(2):
            start = c * k * frames
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mo, mm, states[0] = mega.render_chunk(params, states[0], start_sample=start)
            torch.cuda.synchronize()
            m_wall = time.perf_counter() - t0  # the second chunk's is kept
            if c == 0:
                m_counts = (em.MegaRenderer.launches, *k7())
            eo, om, states[1] = eg.render_chunk(params, states[1], start_sample=start,
                                                num_blocks=k)
            torch.cuda.synchronize()
            if not (torch.equal(mo, eo) and torch.equal(mm, om)):
                raise AssertionError(f"13(c): K2 at F={frames}, chunk {c}: vs eager "
                                     f"{float((mo - eo).abs().max())}, or masks")
        # the meter's mean square sums in another order at F % 4 != 0
        m_errs[frames] = tree_err(*states)
        if (not m_errs[frames] <= MEGA_TOL or m_counts != (1, 0, 0)
                or em.MegaRenderer.launches != 2):
            raise AssertionError(f"13(c): K2 at F={frames}: state {m_errs[frames]}, "
                                 f"launches (K2, K7 biquad, K7 one-pole) {m_counts}")
        if frames == 128:
            mega128 = (p2, mega, params, states[0], mo.nbytes + mm.nbytes)
            walls = {"K2": m_wall}
    log(f"13(c), the FX palette's lowerings on {card}: MegaRenderer refuses it "
        f"(ValueError: {refused[:60]}...); without the flanger K2 renders it at "
        f"B={b}, K={k}, against eager over 2 chunks: outputs and masks bit for bit, "
        f"every state leaf "
        + ", ".join(f"{e:.3e} at F={f}" for f, e in m_errs.items())
        + f" (limit {MEGA_TOL:g}: the meter's mean square); one K2 launch a chunk "
        f"and no K7")

    # the hybrid on the whole palette, against eager
    hy = ft.BatchRenderer(prog, b, device="cuda", lowering="hybrid")
    eg = ft.BatchRenderer(prog, b, device="cuda")
    params = vary_fx_params(prog, eg.stack_params(), seed=14)
    states = {"hybrid": hy.init_state(), "eager": eg.init_state()}
    counts = {}
    h_launches = 0
    for c in range(2):
        res = {}
        for name, r in (("hybrid", hy), ("eager", eg)):
            eh.HybridMegaRenderer.launches = 0
            iir.biquad_cascade.launches = iir.one_pole_scan.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, om, states[name] = r.render_chunk(params, states[name],
                                                   start_sample=c * k * 128,
                                                   num_blocks=k)
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0  # the second chunk's is kept
            counts[name] = (eh.HybridMegaRenderer.launches, *k7())
            res[name] = (out, om)
        h_launches += counts["hybrid"][0]
        if not (torch.equal(res["hybrid"][0], res["eager"][0])
                and torch.equal(res["hybrid"][1], res["eager"][1])):
            e = float((res["hybrid"][0] - res["eager"][0]).abs().max())
            raise AssertionError(f"13(c): chunk {c}: hybrid vs eager {e}, or masks")
    state_err = tree_err(states["hybrid"], states["eager"])
    split = hy._chunk_cache[("hybrid", k)]
    segments = [kind for kind, _ in split.segments]
    if (state_err != 0.0 or segments != ["mega", "xla", "mega"]
            or counts["hybrid"] != (2, 0, 0)):
        raise AssertionError(f"13(c): state {state_err}, segments {segments}, "
                             f"launches (K3, K7 biquad, K7 one-pole) {counts['hybrid']}")
    log(f"13(c): the hybrid at B={b}, K={k} is {segments} (the voices, sum, clip, "
        f"EQ and chorus one K3 island, the flanger a torch stage, tremolo to meter a "
        f"second island: the JAX package's partition); against eager over 2 chunks "
        f"bit for bit (outputs, masks, every state leaf); a chunk launches K3 "
        f"{counts['hybrid'][0]} times and K7 none (eager: K7 {counts['eager'][1]} "
        f"biquad and {counts['eager'][2]} one-pole)")
    audio_secs = b * k * 128 / 48000
    log("13(c): wall of the second chunk (B=%d, K=%d): %s" % (b, k, ", ".join(
        f"{name} {w * 1e3:.3f} ms (realtime factor {audio_secs / w:.1f})"
        for name, w in (("K2 without the flanger", walls["K2"]),
                        ("hybrid", walls["hybrid"]), ("eager", walls["eager"])))))

    # K2 and each island against their plain versions at the same operands,
    # and timed
    p2, mega, m_params, m_state, m_io = mega128
    ko, kf, ks = mega.render_chunk(m_params, m_state, start_sample=2 * k * 128)
    ro, rf, rs = em.mega_chunk_reference(p2, mega.lowered, m_params, m_state,
                                         2 * k * 128, k, b)
    torch.cuda.synchronize()
    k2_err = max(float((ko - ro).abs().max()), tree_err(ks, rs))
    if k2_err != 0.0 or not torch.equal(kf, rf):
        raise AssertionError(f"13(c): K2 vs its plain version {k2_err}, or masks")
    launch = lambda: mega.render_chunk(m_params, m_state, start_sample=0)  # noqa: E731
    k2 = (2, k2_err, device_ms(launch, "mega_kernel", KERNEL_REPS),
          cuda_ms(launch, KERNEL_REPS),
          cuda_ms(lambda: em.mega_chunk_reference(p2, mega.lowered, m_params, m_state,
                                                  0, k, b), 1),
          kernel_work(em, p2, mega.lowered, m_params, m_state, b, k, m_io))

    def agree(i, got, want):
        e = max(float((got[0] - want[0]).abs().max()), tree_err(got[2], want[2]))
        if e != 0.0 or not torch.equal(got[1], want[1]):
            raise AssertionError(f"13(c): island {i}: K3 vs its plain version {e}")

    k3_ms, k3_call, k3_plain, (k3_bytes, k3_ops) = island_times(
        em, prog, split, lambda: hy.render_chunk(params, states["hybrid"],
                                                 start_sample=2 * k * 128, num_blocks=k),
        agree, 2 * k * 128, "13(c)")
    log(f"13(c): K2 (without the flanger, {len(mega.lowered.keys)} rows, "
        f"{em.shared_bytes(mega.lowered, mega.tile)} B of shared memory a CTA) vs its "
        f"plain version 0; {k2[2]:.4f} ms on the device, {k2[3]:.4f} ms a call, plain "
        f"{k2[4]:.3f} ms; bound {bound(*k2[5])[0]:.4f} ms by {bound(*k2[5])[1]}")
    m_err = max(m_errs.values())
    return m_err, (2, max(k2[1], m_err), *k2[2:]), (h_launches, 0.0, k3_ms, k3_call,
                                                     k3_plain, (k3_bytes, k3_ops))


def check_palette(ft, em, eh, iir, cpu_result, card: str, phase):
    """Phase 13: the FX palette on the card → ``(err, K7 launches on the
    batched path, K7 launches in the stream, K2's and K3's tuples for the
    kernels line)``."""
    s_err, s_k7 = palette_stream_check(ft, iir, cpu_result, card)
    phase("13(a), the FX engine streamed")
    b_err, k7 = palette_batched(ft, iir, card)
    torch.cuda.empty_cache()
    phase("13(b), the FX palette eager at B=8192, K=32")
    h_err, k2, k3 = palette_lowerings(ft, em, eh, iir, card)
    phase("13(c), the FX palette's lowerings")
    return max(s_err, b_err, h_err), k7, s_k7, k2, k3


# -- phase 14: the sampler and formats slice ---------------------------------

MUSIC_BUFFER = 512           # frames a buffer (the example's); 128-frame blocks
#: the bed: 2.7 s (cut from 9.7 s, PERF.md §4), 1012.5 blocks, so its loop
#: seam falls inside a block; longer than the decks' 2 s window
MUSIC_BED_FRAMES = 129600
MUSIC_TRACK_SECS = 2.0       # the intro and the outro (cut from 8 s: PERF.md §4)
#: the session, in buffers of 512 frames: the intro plays and the bed is
#: queued with a 0.5 s crossfade at 0 (the bed starts at 1.5 s); the bed
#: re-played looped at MUSIC_LOOP_AT (2.47 s; its seam at 5.17 s); a 0.5 s
#: crossfade to the outro at MUSIC_XFADE_AT (5.42 s); a 0.3 s faded stop
#: at MUSIC_STOP_AT (6.40 s); the end at MUSIC_END (6.91 s)
MUSIC_LOOP_AT, MUSIC_XFADE_AT, MUSIC_STOP_AT, MUSIC_END = 232, 508, 600, 648
MUSIC_POLL_EVERY = 32        # buffers between the player's update and poll
MUSIC_PROFILED = (400, 8)    # buffers [400, 408) under torch.profiler
GRAN_CLIP_SECS = 20.0        # 14(b)'s clip, a tone sequence
GRAN_BUFFERS = 282           # 3 s of 512-frame buffers (cut from 6 s: PERF.md §4)
#: 14(b)'s controls by buffer: tempo 0.75 at +3 st and play; tempo 1.25
#: at -5 st; a pause; a resume; a seek to 12 s
GRAN_CONTROLS = {0: (("set_tempo", 0.75), ("set_pitch_semitones", 3.0), ("play",)),
                 70: (("set_tempo", 1.25), ("set_pitch_semitones", -5.0)),
                 140: (("pause",),), 165: (("play",),), 210: (("set_playhead", 12.0),)}
GRAN_PROFILED = (100, 8)     # 14(b)'s buffers under torch.profiler
GRAN_B, GRAN_K, GRAN_CHUNKS = 8192, 32, 3   # 14(c)
GRAN_BATCH_CLIP_SECS = 2.0
GRAN_CHECK = (0, 1, 1170, 2341, 4096, 5851, 7022, 8191)  # 14(c)'s rows held on the CPU
LAG_REL = 1e-5               # the lag rule: the best two scores this close
SLICE_EXACT = ("src_int", "src_frac", "ages", "ring_int", "ring_frac", "slot", "phase",
               "ended", "finish_count")


def music_tracks(ft, root: str):
    """The session's tracks, the arpeggios of ``examples.music_player``'s
    ``write_track`` (16-bit stereo WAVs at 48 kHz): an intro and an outro of
    MUSIC_TRACK_SECS, and a bed of MUSIC_BED_FRAMES re-encoded as FLAC
    (``encode_flac``), as the example re-encodes its bed."""
    from firewheel_tpu_torch.core.formats import load_audio
    from firewheel_tpu_torch.examples.music_player import write_track
    from firewheel_tpu_torch.utils.flac_encode import encode_flac

    intro, bed_wav, outro, bed = (os.path.join(root, name) for name in (
        "intro.wav", "bed.wav", "outro.wav", "bed.flac"))
    write_track(intro, [220, 277, 330], MUSIC_TRACK_SECS)
    write_track(bed_wav, [110, 165, 220, 277], MUSIC_BED_FRAMES / 48000)
    write_track(outro, [330, 277, 220, 165], MUSIC_TRACK_SECS)
    encode_flac(load_audio(bed_wav, device=False)[0].host_data, 48000, path=bed)
    os.remove(bed_wav)
    return [intro, bed, outro]


def music_session(ft, device: str, tracks, chunk_buffers: int = 1,
                  profile: bool = False) -> dict:
    """14(a): ``examples/music_player.py``'s session through the port's
    ``FirewheelCtx`` on ``device``: intro, the bed queued with a crossfade,
    looped past its seam, a crossfade to the outro, a faded stop.  Returns
    the audio, the finished tracks in poll order, the walls a buffer, the
    decks' refills and (``profile``) the profile's counts."""
    from firewheel_tpu_torch.examples.music_player import track_name

    intro, bed, outro = tracks
    cx = ft.FirewheelCtx(device=device)
    player = ft.MusicPlayer(cx.graph_mut(), clock=lambda: cx.stream.frames_rendered)
    sink = ft.ArraySink()
    cx.activate(ft.StreamConfig(48000, 2, buffer_frames=MUSIC_BUFFER, block_frames=128,
                                chunk_buffers=chunk_buffers), sink=sink)
    stream = cx.stream
    out = {"walls": [], "finished": []}
    trace = PumpTrace()
    controls = {0: lambda: (player.play(intro), player.queue(bed, crossfade_secs=0.5)),
                MUSIC_LOOP_AT: lambda: player.play(bed, loop=True),
                MUSIC_XFADE_AT: lambda: player.crossfade_to(outro, 0.5),
                MUSIC_STOP_AT: lambda: player.stop(fade_secs=0.3)}
    t_start = time.perf_counter()
    b = 0
    while b < MUSIC_END:
        if b in controls:
            controls[b]()
        if profile and b == MUSIC_PROFILED[0]:
            trace.start()
        walls = []
        PumpTrace.pump(cx, chunk_buffers, walls)
        out["walls"] += [walls[0] / chunk_buffers] * chunk_buffers
        b += chunk_buffers
        if trace.on and b == sum(MUSIC_PROFILED):
            prof, out["profile_wall"] = trace.stop(stream)
            out["profile"] = profile_busy(prof, MUSIC_PROFILED[1] * MUSIC_BUFFER // 128)
        if b % MUSIC_POLL_EVERY == 0:
            player.update()
            out["finished"] += [track_name(r) for _, r in player.poll(cx.poll_events())]
    stream.flush()
    if device != "cpu":
        torch.cuda.synchronize()
    out["wall"] = time.perf_counter() - t_start
    out["finished"] += [track_name(r) for _, r in player.poll(cx.poll_events())]
    out["refills"] = sum(p.refill_count for p in stream._processor._processors.values()
                         if hasattr(p, "refill_count"))
    out["audio"] = sink.audio(2)
    cx.deactivate()
    return out


def stream_stats(out: dict, frames: int) -> str:
    walls = np.asarray(out["walls"]) * 1e3
    return (f"RTF {frames / 48000 / out['wall']:.3f}, wall a buffer p50 "
            f"{np.percentile(walls, 50):.3f} ms, p99 {np.percentile(walls, 99):.3f} ms")


def music_reference() -> dict:
    """14(a)'s tracks, written once, and the session on the CPU (in the
    worker process: :class:`CpuStream`)."""
    ft = _port()
    tracks = music_tracks(ft, scratch_dir("music-"))
    return {"tracks": tracks, **music_session(ft, "cpu", tracks)}


def _music_card_worker(conn, tracks) -> None:
    """14(a)'s four-buffer session on the card, in a worker process beside
    the one-buffer session (both are host-bound: each takes a core);
    sends ``("ok", result)`` or ``("error", traceback)``."""
    import traceback

    try:
        ft = _port()
        conn.send(("ok", music_session(ft, "cuda", tracks, 4)))
    except Exception:  # the worker's boundary: the parent raises it
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


def check_music(ft, cpu_result, card: str) -> float:
    """14(a): the music session on the card, in one-buffer dispatches here
    and four-buffer dispatches in a worker process at the same time, each
    against the same session on the CPU (from the CPU worker)."""
    import multiprocessing

    want = cpu_result.get()["music"]
    tracks = want["tracks"]
    ctx = multiprocessing.get_context("spawn")
    conn, child = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=_music_card_worker, args=(child, tracks), daemon=True)
    proc.start()
    child.close()
    try:
        runs = {1: music_session(ft, "cuda", tracks, 1, profile=True)}
        while not conn.poll(1.0):
            if not proc.is_alive():
                raise RuntimeError(f"14(a)'s worker exited ({proc.exitcode}) without "
                                   "a result")
        status, value = conn.recv()
        if status != "ok":
            raise RuntimeError(f"14(a)'s four-buffer session failed in its worker:\n{value}")
        runs[4] = value
    finally:
        proc.join(60)
        if proc.is_alive():
            proc.terminate()
            proc.join()
        conn.close()
    err = 0.0
    for chunk_buffers, got in runs.items():
        if got["audio"].shape != want["audio"].shape or not np.isfinite(got["audio"]).all():
            raise AssertionError(f"14(a): the session rendered {got['audio'].shape}, "
                                 f"the CPU {want['audio'].shape}")
        e = float(np.abs(got["audio"] - want["audio"]).max())
        if e > SLICE_TOL:
            raise AssertionError(f"14(a): the card vs the CPU, chunk_buffers="
                                 f"{chunk_buffers}: max_abs_err={e:.3e}")
        if got["finished"] != want["finished"]:
            raise AssertionError(f"14(a): finish events {got['finished']}, the CPU's "
                                 f"{want['finished']}")
        err = max(err, e)
        line = (f"phase 14(a), the music session, {chunk_buffers} buffer(s) a dispatch "
                f"({'here' if chunk_buffers == 1 else 'in a worker process, meanwhile'}, "
                f"{card}): {stream_stats(got, got['audio'].shape[1])}, refills "
                f"{got['refills']}, max_abs_err vs the CPU {e:.3e}, finish events "
                f"{got['finished']}")
        if "profile" in got:
            per_block, calls, busy = got["profile"]
            line += (f"; {per_block:.1f} kernels a 128-frame block ({calls:.1f} launch "
                     f"calls), device busy {100 * busy / 1e6 / got['profile_wall']:.2f}% "
                     f"of {MUSIC_PROFILED[1]} profiled buffers")
        log(line)
    peak = float(np.abs(want["audio"]).max())
    if peak < 0.1 or want["finished"] != ["intro.wav", "FlacStreamReader"]:
        raise AssertionError(f"14(a): peak {peak}, finish events {want['finished']}")
    return err


def gran_clip(seconds: float, seed: int) -> np.ndarray:
    """A stereo tone sequence, a new frequency every 0.1 s, from ``seed``."""
    n = int(seconds * 48000)
    rng = np.random.default_rng(seed)
    f = rng.uniform(110.0, 880.0, size=n // 4800 + 1)[np.arange(n) // 4800]
    ph = np.cumsum(2 * np.pi * f / 48000)
    return np.stack([0.4 * np.sin(ph), 0.3 * np.sin(ph + 0.5)]).astype(np.float32)


def gran_params(proc, device):
    """A granular processor's params as tensors on ``device``."""
    from firewheel_tpu_torch.convert import params_from_jax

    p = proc.collect_params()
    sample = p.pop("sample")
    p = params_from_jax(p, device)
    p["sample"] = sample.to(device)
    return p


def near_tie(proc, params, state, blocks: int) -> bool:
    """Whether a spawn of the next ``blocks`` blocks from ``state`` (one
    instance or a batch; CPU tensors) has its best two SOLA scores within
    LAG_REL relative: where two devices may pick different lags.  Renders
    the blocks with the processor's kernel on the CPU."""
    from firewheel_tpu_torch.core.node import BlockInfo

    frames = proc.max_block_frames
    empty = torch.zeros(state["src_int"].shape + (0, frames))
    emask = torch.zeros(state["src_int"].shape + (0,), dtype=torch.bool)
    tie = torch.zeros(state["src_int"].shape, dtype=torch.bool)
    for _ in range(blocks):
        for use, scores in proc.sola_scores(params, state, frames):
            top = torch.topk(scores, 2, dim=-1).values
            gap = (top[..., 0] - top[..., 1]) <= LAG_REL * top[..., 0].abs()
            tie |= use & gap
        _, state, _ = proc.kernel(params, state, empty, emask, BlockInfo.make())
    return tie


def granular_stream(ft, device: str, clip, record: bool = False, profile: bool = False):
    """14(b): one ``GranularSamplerNode`` at its defaults through
    ``FirewheelCtx`` on ``device``, 512-frame buffers of 128-frame blocks,
    GRAN_CONTROLS applied.  Returns the audio, the walls a buffer and
    (``record``) the state tree after every buffer, cloned on the device
    during the run and fetched after it (no synchronisation in the run)."""
    from firewheel_tpu_torch.convert import state_to_numpy, tree_map

    cx = ft.FirewheelCtx(device=device)
    g = cx.graph_mut()
    node = ft.GranularSamplerNode()
    nid = g.add_node(0, 2, node)
    g.connect(nid, 0, g.graph_out_node(), 0)
    g.connect(nid, 1, g.graph_out_node(), 1)
    node.set_sample(ft.SampleResource(clip, sample_rate=48000.0))
    sink = ft.ArraySink()
    cx.activate(ft.StreamConfig(48000, 2, buffer_frames=MUSIC_BUFFER, block_frames=128),
                sink=sink)
    out = {"walls": [], "states": [], "key": ft.node_key(nid)}
    trace = PumpTrace()
    t_start = time.perf_counter()
    for b in range(GRAN_BUFFERS):
        for call in GRAN_CONTROLS.get(b, ()):
            getattr(node, call[0])(*call[1:])
        if profile and b == GRAN_PROFILED[0]:
            trace.start()
        PumpTrace.pump(cx, 1, out["walls"])
        if trace.on and b + 1 == sum(GRAN_PROFILED):
            prof, out["profile_wall"] = trace.stop(cx.stream)
            out["profile"] = profile_busy(prof, GRAN_PROFILED[1] * MUSIC_BUFFER // 128)
        if record:
            out["states"].append(tree_map(torch.clone, cx.stream._processor.state_dict()))
    cx.stream.flush()
    if device != "cpu":
        torch.cuda.synchronize()
    out["wall"] = time.perf_counter() - t_start
    out["states"] = [state_to_numpy(st) for st in out["states"]]
    out["audio"] = sink.audio(2)
    cx.deactivate()
    return out


def exact_diff(a: dict, b: dict) -> list:
    """The granular state leaves that differ between two numpy trees."""
    return [k for k in SLICE_EXACT if not np.array_equal(a[k], b[k])]


def check_granular_stream(ft, card: str):
    """14(b): the card's stream against the CPU's, run in lockstep through
    the card's recorded states: where a buffer's state differs, the CPU
    replays that buffer's blocks; a spawn whose best two scores lie within
    LAG_REL accepts the difference (counted; the CPU adopts the card's
    state and that buffer's audio is not compared), anything else fails."""
    from firewheel_tpu_torch.convert import state_from_jax, state_to_numpy

    clip = gran_clip(GRAN_CLIP_SECS, 14)
    card_run = granular_stream(ft, "cuda", clip, record=True, profile=True)
    key = card_run["key"]

    cx = ft.FirewheelCtx(device="cpu")
    g = cx.graph_mut()
    node = ft.GranularSamplerNode()
    nid = g.add_node(0, 2, node)
    g.connect(nid, 0, g.graph_out_node(), 0)
    g.connect(nid, 1, g.graph_out_node(), 1)
    node.set_sample(ft.SampleResource(clip, sample_rate=48000.0))
    sink = ft.ArraySink()
    cx.activate(ft.StreamConfig(48000, 2, buffer_frames=MUSIC_BUFFER, block_frames=128),
                sink=sink)
    proc = cx.stream._processor
    gproc = proc._processors[nid]
    accepted = []
    for b in range(GRAN_BUFFERS):
        for call in GRAN_CONTROLS.get(b, ()):
            getattr(node, call[0])(*call[1:])
        before = state_from_jax(state_to_numpy(proc.state_dict())[key], "cpu")
        cx.update(max_pump_buffers=0)
        cx.stream.pump(1)
        mine = state_to_numpy(proc.state_dict())
        theirs = card_run["states"][b]
        differ = exact_diff(mine[key], theirs[key])
        if differ:
            # the params of this buffer, as the pump collected them
            if not near_tie(gproc, gran_params(gproc, "cpu"), before,
                            MUSIC_BUFFER // 128):
                raise AssertionError(f"14(b): buffer {b}: {differ} differ from the "
                                     "card's and no spawn's best two scores lie within "
                                     f"{LAG_REL} relative")
            accepted.append(b)
            proc.set_state_dict(theirs)
    cx.stream.flush()
    want = sink.audio(2)
    cx.deactivate()
    got = card_run["audio"]
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"14(b): {got.shape} against the CPU's {want.shape}")
    keep = np.ones(got.shape[1], bool)
    for b in accepted:
        keep[b * MUSIC_BUFFER:(b + 1) * MUSIC_BUFFER] = False
    err = float(np.abs(got - want)[:, keep].max())
    if err > SLICE_TOL or float(np.abs(got).max()) < 0.1:
        raise AssertionError(f"14(b): the card vs the CPU max_abs_err={err:.3e}")
    per_block, calls, busy = card_run["profile"]
    log(f"phase 14(b), the granular stream ({card}): "
        f"{stream_stats(card_run, got.shape[1])}, {per_block:.1f} kernels a block "
        f"({calls:.1f} launch calls), device busy "
        f"{100 * busy / 1e6 / card_run['profile_wall']:.2f}% of {GRAN_PROFILED[1]} "
        f"profiled buffers; max_abs_err vs the CPU {err:.3e}; lag rule: "
        f"{len(accepted)} of {GRAN_BUFFERS} buffers accepted a different lag "
        f"(buffers {accepted})")
    return err


def granular_program(ft, device: str, clip):
    g = ft.AudioGraph(ft.AudioGraphConfig(0, 2))
    node = ft.GranularSamplerNode()
    node.set_sample(ft.SampleResource(clip, sample_rate=48000.0))
    node.play()
    nid = g.add_node(0, 2, node)
    g.connect(nid, 0, g.graph_out_node(), 0)
    g.connect(nid, 1, g.graph_out_node(), 1)
    sched = g.compile(48000, 128)
    prog = ft.ScheduleProgram(sched.schedule, dict(sched.new_node_processors), 48000,
                              device=device)
    return prog, ft.node_key(nid)


def granular_instances(b: int, clip_frames: int):
    """Per-instance tempo (0.5-2.0), pitch (±12 st) and start playhead; one
    instance in sixteen starts within 0.2 s of the clip's end."""
    i = np.arange(b)
    tempo = (0.5 + 1.5 * i / max(b - 1, 1)).astype(np.float32)
    semis = -12.0 + 24.0 * ((i * 7919) % b) / max(b - 1, 1)
    pitch = (2.0 ** (semis / 12.0)).astype(np.float32)
    rng = np.random.default_rng(16)
    start = rng.integers(0, clip_frames - 24000, b)
    near = i % 16 == 0
    # the near-end ones end inside the run: 0.1 s of output at most
    start[near] = clip_frames - (rng.uniform(0.0, 0.1, near.sum()) * 48000
                                 * tempo[near]).astype(np.int64) - 1
    return tempo, pitch, start.astype(np.uint32)


def check_granular_batched(ft, card: str):
    """14(c): ``BatchRenderer`` (eager) at B=8192, K=32 with per-instance
    tempo, pitch and start; GRAN_CHECK's rows held against a CPU render of
    the same instances, chunk by chunk from the card's state, under the lag
    rule."""
    from firewheel_tpu_torch.convert import state_from_jax, state_to_numpy

    clip = gran_clip(GRAN_BATCH_CLIP_SECS, 17)
    prog, key = granular_program(ft, "cuda", clip)
    br = ft.BatchRenderer(prog, GRAN_B, device="cuda")
    params = br.stack_params()
    tempo, pitch, start = granular_instances(GRAN_B, clip.shape[1])
    p = params[key]
    p["tempo"] = torch.from_numpy(tempo).cuda()
    p["pitch"] = torch.from_numpy(pitch).cuda()
    p["seek_pos"] = torch.from_numpy(start.astype(np.int64)).cuda()
    state = br.init_state()
    rows = torch.tensor(GRAN_CHECK)
    cprog, ckey = granular_program(ft, "cpu", clip)
    cproc = cprog._procs[ckey]
    cparams = {k: (v[rows].cpu() if k != "sample" else
                   torch.from_numpy(clip)[None].expand(len(GRAN_CHECK), *clip.shape))
               for k, v in p.items()}
    info = ft.BlockInfo.make()
    torch.cuda.reset_peak_memory_stats()
    accepted, walls, err = [], [], 0.0
    finish = np.zeros(len(GRAN_CHECK), np.int64)
    for c in range(GRAN_CHUNKS):
        before = state_from_jax(_rows(state[key], rows), "cpu")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _, state = br.render_chunk(params, state, num_blocks=GRAN_K)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        got = out[rows.cuda()].cpu().numpy()  # [8, K, 2, F]
        theirs = _rows(state[key], rows)
        # the CPU: the same instances, block by block from the same state
        st = before
        empty = torch.zeros((len(GRAN_CHECK), 0, 128))
        emask = torch.zeros((len(GRAN_CHECK), 0), dtype=torch.bool)
        want = []
        for _ in range(GRAN_K):
            o, st, _ = cproc.kernel(cparams, st, empty, emask, info)
            want.append(o.numpy())
        want = np.stack(want, axis=1)
        mine = state_to_numpy(st)
        for j, r in enumerate(GRAN_CHECK):
            diff = [k for k in SLICE_EXACT if not np.array_equal(mine[k][j], theirs[k][j])]
            e = float(np.abs(got[j] - want[j]).max())
            if not diff and e <= SLICE_TOL:
                err = max(err, e)
                continue
            one = {k: (v[j:j + 1] if not isinstance(v, dict) else
                       {kk: vv[j:j + 1] for kk, vv in v.items()}) for k, v in before.items()}
            pj = {k: v[j:j + 1] for k, v in cparams.items()}
            if not bool(near_tie(cproc, pj, one, GRAN_K)[0]):
                raise AssertionError(f"14(c): instance {r}, chunk {c}: {diff} differ, "
                                     f"audio by {e:.3e}, and no spawn's best two scores "
                                     f"lie within {LAG_REL} relative")
            accepted.append((c, r))
        finish = theirs["finish_count"].astype(np.int64)
        if not np.array_equal(theirs["finish_count"], mine["finish_count"]):
            raise AssertionError("14(c): finish counts differ from the CPU's")
        if not np.isfinite(got).all():
            raise AssertionError("14(c): non-finite output")
    peak = torch.cuda.max_memory_allocated()
    fired = sum(e.count for e in br.poll_events(state) if e.name == "finished")
    near = int((np.arange(GRAN_B) % 16 == 0).sum())
    near_rows = [i for i, r in enumerate(GRAN_CHECK) if r % 16 == 0]
    if fired != near or not (finish[near_rows] == 1).all():
        raise AssertionError(f"14(c): {fired} finish events, {near} instances start "
                             "near the end")
    # kernels a block and the device's busy share over one more chunk
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        br.render_chunk(params, state, num_blocks=GRAN_K)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    per_block, calls, busy = profile_busy(prof, GRAN_K)
    wall = float(np.median(walls[1:]))
    log(f"phase 14(c), granular B={GRAN_B} K={GRAN_K} eager ({card}): wall a chunk "
        f"{[round(w * 1e3, 3) for w in walls]} ms, RTF "
        f"{GRAN_B * GRAN_K * 128 / 48000 / wall:.1f}, {per_block:.1f} kernels a block "
        f"({calls:.1f} launch calls), device busy {100 * busy / 1e6 / prof_wall:.2f}% "
        f"of a profiled chunk ({prof_wall * 1e3:.1f} ms), peak memory "
        f"{peak / 2**30:.3f} GiB; {fired} finish events ({near} instances start near "
        f"the end); rows {list(GRAN_CHECK)} vs the CPU max_abs_err={err:.3e}; lag "
        f"rule: {len(accepted)} (chunk, instance) differences accepted {accepted}")
    del params, state, br
    torch.cuda.empty_cache()
    return err


def _rows(tree, rows):
    """The numpy rows ``rows`` of a state tree of batched tensors."""
    from firewheel_tpu_torch.convert import state_to_numpy

    idx = rows.to(next(iter(_leaves(tree))).device)
    return state_to_numpy({k: (v[idx] if not isinstance(v, dict) else
                               {kk: vv[idx] for kk, vv in v.items()})
                           for k, v in tree.items()})


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def scene_graph(ft, wav: str):
    """14(d)'s scene: a granular voice, a looped cubic sampler, a streaming
    deck on a WAV file and a beep, summed through volume, pan, echo and a
    clip; clips from seed 18."""
    rng = np.random.default_rng(18)
    n = ft.nodes
    g = ft.AudioGraph(ft.AudioGraphConfig(0, 2))
    gran = n.GranularSamplerNode(grain_frames=1024)
    gran.set_sample(ft.SampleResource(gran_clip(0.5, 18), sample_rate=44100.0))
    gran.set_tempo(0.8)
    gran.set_pitch_semitones(3.0)
    smp = n.SamplerNode(80.0, quality="cubic")
    smp.set_sample(ft.SampleResource(
        (0.3 * rng.standard_normal((2, 6000))).astype(np.float32)))
    smp.set_loop_range(n.LoopRange.FULL)
    smp.set_playback_rate(1.1)
    deck = n.StreamingSamplerNode(ft.utils.wav.WavStreamReader(wav), percent_volume=70.0,
                                  window_secs=0.25)
    sources = [g.add_node(0, 2, x) for x in (gran, smp, deck,
                                              n.BeepTestNode(440.0, -18.0))]
    mix = g.add_node(8, 2, n.SumNode())
    chain = [g.add_node(2, 2, x) for x in (
        n.VolumeNode(80.0), n.StereoPanNode(-0.2),
        n.EchoNode(delay_secs=0.05, feedback=0.3, wet=0.3), n.HardClipNode(-1.0))]
    for c in range(2):
        for i, s in enumerate(sources):
            g.connect(s, c, mix, 2 * i + c)
        prev = mix
        for nid in chain:
            g.connect(prev, c, nid, c)
            prev = nid
        g.connect(prev, c, g.graph_out_node(), c)
    return g


SCENE_BLOCKS = (8, 3)        # 14(d): K a chunk, chunks


def render_scene(ft, g, device: str) -> np.ndarray:
    for e in g.nodes():
        if hasattr(e.weight.node, "play"):
            e.weight.node.play()
    sched = g.compile(48000, 128)
    prog = ft.ScheduleProgram(sched.schedule, dict(sched.new_node_processors), 48000,
                              device=device)
    k, chunks = SCENE_BLOCKS
    gi = torch.zeros((k, 0, 128), device=device)
    im = torch.zeros((k, 0), dtype=torch.bool, device=device)
    state = prog.init_state()
    outs = []
    for c in range(chunks):
        out, _, state = prog.render_chunk(prog.collect_params(), state, gi, im, c * k * 128)
        outs.append(out.cpu().numpy())
    return np.concatenate(outs)


def check_scene(ft, card: str) -> float:
    """14(d): a scene saved by ``save_graph`` on the host, loaded by
    ``load_graph`` and rendered on the card, against the same graph built
    directly (bit for bit) and the loaded scene on the CPU (1e-5)."""
    from firewheel_tpu_torch.utils.wav import write_wav

    root = scratch_dir("scene-")
    wav = os.path.join(root, "deck.wav")
    write_wav(wav, (0.2 * np.random.default_rng(19).standard_normal((2, 48000))).astype(
        np.float32), 48000)
    path = os.path.join(root, "scene.npz")
    ft.save_graph(scene_graph(ft, wav), path)
    loaded = render_scene(ft, ft.load_graph(path)[0], "cuda")
    direct = render_scene(ft, scene_graph(ft, wav), "cuda")
    cpu = render_scene(ft, ft.load_graph(path)[0], "cpu")
    if not np.array_equal(loaded, direct):
        raise AssertionError("14(d): the loaded scene renders apart from the direct graph")
    err = float(np.abs(loaded - cpu).max())
    if err > SLICE_TOL or float(np.abs(loaded).max()) < 0.05:
        raise AssertionError(f"14(d): the card vs the CPU max_abs_err={err:.3e}")
    log(f"phase 14(d), a scene file on the card ({card}): loaded == built bit for bit "
        f"over {SCENE_BLOCKS[0] * SCENE_BLOCKS[1]} blocks, vs the CPU max_abs_err={err:.3e}")
    return err


def check_slice(ft, seq_iir, em, eh, adpcm_device, dynamics, iir, noise, cpu_result,
                card: str, phase) -> float:
    """Phase 14: the granular sampler, the streaming sampler with the stream
    formats, the music player and scene files on the card.  No kernel of
    the port's lies on these paths: K1-K7 must launch no time."""
    counters = (seq_iir.biquad_seq, em.MegaRenderer, eh.HybridMegaRenderer,
                adpcm_device.encode_ima_chunk, dynamics.scan_lanes,
                noise.noise_uniform, iir.biquad_cascade, iir.one_pole_scan)
    for c in counters:
        c.launches = 0
    err = check_music(ft, cpu_result, card)
    phase("14(a), the music session streamed")
    err = max(err, check_granular_stream(ft, card))
    phase("14(b), the granular stream")
    err = max(err, check_granular_batched(ft, card))
    phase("14(c), granular at B=8192, K=32")
    err = max(err, check_scene(ft, card))
    launched = {c.__name__: c.launches for c in counters}
    if any(launched.values()):
        raise AssertionError(f"phase 14 launched kernels of the port's: {launched}")
    log(f"phase 14: launches of K1-K7 on these paths {launched}")
    phase("14(d), a scene file")
    return err


# -- phase 15: the voice pool, MIDI playback, HTTP streaming, the validator --

POOL_BUFFER = 1024           # frames a buffer (cpal's default), of 128-frame blocks
POOL_BUFFERS = 141           # 15(a): 3.0 s (the example renders 6 s: PERF.md §4)
POOL_TICK = 8                # buffers a game tick, 171 ms (the example's is 330 ms)
POOL_LEAD = 2400             # samples a shot is scheduled ahead of the render head
#: 15(a)'s game, by tick: the hum looped at tick 0; a footstep each tick in
#: POOL_STEPS and a laser 0.1 s after it on 55% of them; at POOL_VOLLEY seven
#: lasers (priority 3) and a footstep that finds every voice outranking it;
#: at POOL_BOOM the explosion (priority 5) steals a volley laser and the hum
#: ducks; at POOL_HUSH the hum's handle stops it
POOL_STEPS, POOL_VOLLEY, POOL_BOOM, POOL_HUSH = range(1, 15), 5, 8, 12
POOL_PROFILED = (64, 4)      # 15(a)'s buffers under torch.profiler
JUKE_BUFFERS = 141           # 15(b): 3.0 s of the song (it is 13.7 s: PERF.md §4)
JUKE_UPDATE = 4              # buffers between the sequencer's updates (85 ms)
JUKE_PROFILED = (64, 2)      # 15(b)'s buffers under torch.profiler
HTTP_SECS = 2.0              # 15(c)'s WAV
HTTP_BUFFER = 512


def pool_groups(cx) -> list:
    """The sizes of the pooled groups of samplers in the stream's schedule
    (a lone sampler counts as a group of 1)."""
    from firewheel_tpu_torch.executor import node_key

    program = cx.stream._processor._program
    return [len(members) for _, members in program._plan
            if type(program._procs[node_key(members[0].id)]).__name__ == "SamplerProcessor"]


def stream_session(cx, buffers: int, control, profile=None) -> dict:
    """Pump ``buffers`` one at a time, calling ``control(b)`` before buffer
    ``b``; ``profile = (first, n)`` traces buffers [first, first + n).
    Returns the walls a buffer, the wall (the profiler's own start and stop
    left out, ``profiler_s``) and the profile's counts."""
    out = {"walls": [], "profiler_s": 0.0}
    trace = PumpTrace()
    t_start = time.perf_counter()
    for b in range(buffers):
        control(b)
        if profile and b == profile[0]:
            t0 = time.perf_counter()
            trace.start()
            out["profiler_s"] += time.perf_counter() - t0
        PumpTrace.pump(cx, 1, out["walls"])
        if trace.on and b + 1 == sum(profile):
            prof, out["profile_wall"] = trace.stop(cx.stream)
            t0 = time.perf_counter()
            out["profile"] = profile_busy(prof, profile[1] * POOL_BUFFER // 128)
            del prof
            out["profiler_s"] += time.perf_counter() - t0
    cx.stream.flush()
    if cx.device.type == "cuda":
        torch.cuda.synchronize()
    out["wall"] = time.perf_counter() - t_start - out["profiler_s"]
    return out


def voice_pool_session(device: str, profile: bool = False) -> dict:
    """15(a): ``examples/voice_pool_game.py``'s battle on an 8-voice
    ``VoicePool`` through ``FirewheelCtx`` on ``device``: overlapping shots
    scheduled inside blocks, a volley that leaves a footstep dropped, an
    explosion that steals a voice, the looping hum ducked and stopped by its
    handle, finished handles polled each tick.  Returns the audio, the
    handles, the dropped shots, the steals, the finished handles, the
    pooled groups, the walls and (``profile``) the profile's counts."""
    ft = _port()
    from firewheel_tpu_torch.examples.voice_pool_game import synth_clip

    cx = ft.FirewheelCtx(device=device)
    pool = ft.VoicePool(cx.graph_mut(), num_voices=8, max_clip_frames=1 << 15,
                        declick_secs=0.003, clock=lambda: cx.stream.frames_rendered)
    clips = {k: synth_clip(k) for k in ("footstep", "laser", "explosion", "engine")}
    pool.preload(*clips.values())
    sink = ft.ArraySink()
    cx.activate(ft.StreamConfig(48000, 2, buffer_frames=POOL_BUFFER, block_frames=128),
                sink=sink)
    rng = np.random.default_rng(7)
    rec = {"handles": [], "dropped": [], "steals": 0, "finished": []}
    hum = []

    def shot(tick, clip, now, **kw):
        busy = pool.active_voices(now=now) == pool.num_voices
        h = pool.play(clips[clip], now=now, **kw)
        rec["handles"].append(None if h is None else (h._index, h._gen))
        if h is None:
            rec["dropped"].append((tick, clip))
        rec["steals"] += int(busy and h is not None)
        return h

    def control(b):
        if b % POOL_TICK:
            return
        tick, now = b // POOL_TICK, cx.stream.frames_rendered
        rec["finished"] += [(tick, h._index, h._gen)
                            for h in pool.finished_handles(cx.poll_events())]
        when = now + POOL_LEAD
        if tick == 0:
            hum.append(shot(tick, "engine", now, loop=True, gain_db=-18.0, priority=10,
                            when=128))
        elif tick == POOL_VOLLEY:
            for i in range(7):
                shot(tick, "laser", now, gain_db=-12.0, pan=i / 3.0 - 1.0, priority=3,
                     rate=0.9 + 0.05 * i, when=when + 37 * i)
            shot(tick, "footstep", now, gain_db=-8.0, when=when)
        elif tick in POOL_STEPS:
            shot(tick, "footstep", now, gain_db=-8.0 - rng.uniform(0, 3),
                 pan=rng.uniform(-0.4, 0.4), rate=rng.uniform(0.92, 1.08), when=when)
            if rng.random() < 0.55:
                shot(tick, "laser", now, gain_db=-10.0, pan=rng.uniform(-1, 1),
                     rate=rng.uniform(0.8, 1.3), when=when + 4800)
        if tick == POOL_BOOM:
            shot(tick, "explosion", now, gain_db=-9.0, priority=5, when=when)
            hum[0].set_gain_db(-24.0)  # duck the hum under the blast
        if tick == POOL_HUSH:
            hum[0].stop(at_sample=when)
        if b == POOL_TICK:  # the schedule compiled, the clips set
            rec["groups"] = pool_groups(cx)

    out = stream_session(cx, POOL_BUFFERS, control, POOL_PROFILED if profile else None)
    rec["finished"] += [(POOL_BUFFERS // POOL_TICK + 1, h._index, h._gen)
                        for h in pool.finished_handles(cx.poll_events())]
    rec["hum_alive"] = hum[0].alive
    rec["audio"] = sink.audio(2)
    cx.deactivate()
    return {**rec, **out}


def demo_song(control=()) -> bytes:
    """``examples.midi_jukebox.demo_song`` (two bars of lead, bass and
    kick/snare at 140 bpm, looped 4x) with a track of ``control``'s
    (delta, event) pairs added after its three."""
    from firewheel_tpu_torch.examples import midi_jukebox

    song = midi_jukebox.demo_song()
    if not control:
        return song
    tracks = int.from_bytes(song[10:12], "big") + 1
    return (song[:10] + tracks.to_bytes(2, "big") + song[12:]
            + midi_jukebox._track(list(control)))


def _cc(ch, num, val) -> bytes:
    return bytes([0xB0 | ch, num, val])


def _bend(ch, value14) -> bytes:
    return bytes([0xE0 | ch, value14 & 0x7F, (value14 >> 7) & 0x7F])


#: 15(b)'s control track on the bass's channel: RPN 0,0 sets a 7-semitone
#: bend range, an NRPN select and its data entry follow (the port's parser
#: keeps the range; the reference's moved it to 64), then bends of +1/4 and
#: -1/2 of the range, back to centre, and the channel volume to 100
JUKE_CONTROL = ((0, _cc(1, 101, 0)), (0, _cc(1, 100, 0)), (0, _cc(1, 6, 7)),
                (0, _cc(1, 99, 2)), (0, _cc(1, 98, 9)), (0, _cc(1, 6, 64)),
                (960, _bend(1, 8192 + 2048)), (480, _cc(1, 7, 100)),
                (480, _bend(1, 8192 - 4096)), (960, _bend(1, 8192)))


def jukebox_session(device: str, profile: bool = False) -> dict:
    """15(b): ``examples/midi_jukebox.py`` on the port: ``demo_song`` with
    :data:`JUKE_CONTROL` parsed by ``parse_midi`` and driven by
    ``MidiSequencer`` onto a 24-voice ``VoicePool`` through ``FirewheelCtx``
    on ``device``, ``update()`` every JUKE_UPDATE buffers."""
    ft = _port()
    from firewheel_tpu_torch.examples.midi_jukebox import instruments
    from firewheel_tpu_torch.utils.midi import MidiSequencer, parse_midi

    cx = ft.FirewheelCtx(device=device)
    pool = ft.VoicePool(cx.graph_mut(), num_voices=24, max_clip_frames=1 << 16,
                        clock=lambda: cx.stream.frames_rendered)
    sink = ft.ArraySink()
    cx.activate(ft.StreamConfig(48000, 2, buffer_frames=POOL_BUFFER, block_frames=128),
                sink=sink)
    song = parse_midi(demo_song(control=JUKE_CONTROL))
    seq = MidiSequencer(pool, song, instruments(), horizon_secs=0.5)
    seq.start()

    def control(b):
        if b % JUKE_UPDATE == 0:
            seq.update()
        if b == 1:
            out["groups"] = pool_groups(cx)

    out = {}
    out.update(stream_session(cx, JUKE_BUFFERS, control, JUKE_PROFILED if profile else None))
    out.update(audio=sink.audio(2), skipped=seq.skipped_notes, dropped=seq.dropped_notes,
               scheduled=seq._next, bends=song.bend_changes)
    cx.deactivate()
    return out


def _pool_stats(got: dict, card: str, what: str, profiled: int) -> str:
    line = f"{what} ({card}): {stream_stats(got, got['audio'].shape[1])}"
    if "profile" in got:
        per_block, calls, busy = got["profile"]
        line += (f"; {per_block:.1f} kernels a 128-frame block ({calls:.1f} launch calls"
                 f"), device busy {100 * busy / 1e6 / got['profile_wall']:.2f}% of "
                 f"{profiled} profiled buffers (the profiler's start and stop "
                 f"{got['profiler_s']:.1f} s, left out of the RTF)")
        if per_block == 0:
            line += " (the profile saw no device activity: read the launch calls)"
    return line


def check_pool(cpu_result, card: str) -> float:
    """15(a): the voice-pool battle on the card against the same session on
    the CPU (the worker of 12(a))."""
    want = cpu_result.get()["pool"]
    got = voice_pool_session("cuda", profile=True)
    if got["audio"].shape != want["audio"].shape or not np.isfinite(got["audio"]).all():
        raise AssertionError(f"15(a): the session rendered {got['audio'].shape}, the CPU "
                             f"{want['audio'].shape}")
    err = float(np.abs(got["audio"] - want["audio"]).max())
    if err > SLICE_TOL:
        raise AssertionError(f"15(a): the card vs the CPU max_abs_err={err:.3e}")
    for key in ("handles", "dropped", "steals", "finished", "groups", "hum_alive"):
        if got[key] != want[key]:
            raise AssertionError(f"15(a): {key} {got[key]}, the CPU's {want[key]}")
    if got["groups"] != [8]:
        raise AssertionError(f"15(a): the pool's samplers ran in groups {got['groups']}, "
                             "not one pooled group of 8")
    if (not got["dropped"] or got["steals"] < 1 or got["hum_alive"]
            or len(got["finished"]) < 3 or float(np.abs(got["audio"]).max()) < 0.05):
        raise AssertionError(f"15(a): dropped {got['dropped']}, steals {got['steals']}, "
                             f"hum alive {got['hum_alive']}, finished {got['finished']}")
    stats = _pool_stats(got, card, "the voice-pool battle, 8 voices", POOL_PROFILED[1])
    log(f"phase 15(a), {stats}; "
        f"pooled sampler groups {got['groups']}, {len(got['handles'])} shots, "
        f"{got['steals']} steals, dropped {got['dropped']}, "
        f"{len(got['finished'])} finished handles; max_abs_err vs the CPU {err:.3e}")
    return err


def check_jukebox(cpu_result, card: str) -> float:
    """15(b): the MIDI jukebox on the card against the same session on the
    CPU (the worker of 12(a))."""
    want = cpu_result.get()["jukebox"]
    got = jukebox_session("cuda", profile=True)
    if got["audio"].shape != want["audio"].shape or not np.isfinite(got["audio"]).all():
        raise AssertionError(f"15(b): the session rendered {got['audio'].shape}, the CPU "
                             f"{want['audio'].shape}")
    err = float(np.abs(got["audio"] - want["audio"]).max())
    if err > SLICE_TOL:
        raise AssertionError(f"15(b): the card vs the CPU max_abs_err={err:.3e}")
    for key in ("skipped", "dropped", "scheduled", "groups"):
        if got[key] != want[key]:
            raise AssertionError(f"15(b): {key} {got[key]}, the CPU's {want[key]}")
    # the NRPN data entry left the 7-semitone range: +1/4 of it is +1.75 st
    bends = [round(s, 6) for _, ch, s in got["bends"] if ch == 1]
    if bends != [1.75, -3.5, 0.0] or got["groups"] != [24]:
        raise AssertionError(f"15(b): the bass's bends {bends}, groups {got['groups']}")
    if float(np.abs(got["audio"]).max()) < 0.05 or got["scheduled"] < 20:
        raise AssertionError(f"15(b): peak {np.abs(got['audio']).max()}, "
                             f"{got['scheduled']} notes scheduled")
    stats = _pool_stats(got, card, "the MIDI jukebox, 24 voices", JUKE_PROFILED[1])
    log(f"phase 15(b), {stats}; {got['scheduled']} notes "
        f"scheduled, skipped {got['skipped']}, dropped {got['dropped']}, the bass's bends "
        f"{bends} st; max_abs_err vs the CPU {err:.3e}")
    return err


def _range_server(files: dict):
    """A localhost ``ThreadingHTTPServer`` serving ``files`` (path → bytes)
    with byte ranges, as ``tests/test_net_stream.py`` serves them; returns
    the server and its base URL."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            body = files.get(self.path)
            if body is None:
                self.send_error(404)
                return
            lo_s, hi_s = self.headers.get("Range", "bytes=0-").split("=", 1)[1].split("-")
            lo, hi = int(lo_s), min(int(hi_s) if hi_s else len(body) - 1, len(body) - 1)
            self.send_response(206)
            self.send_header("Content-Range", f"bytes {lo}-{hi}/{len(body)}")
            self.send_header("Content-Length", str(hi + 1 - lo))
            self.end_headers()
            self.wfile.write(body[lo:hi + 1])

        def log_message(self, *args):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def check_http(ft, card: str) -> float:
    """15(c): a seeded 2 s 48 kHz stereo pcm16 WAV served over localhost
    HTTP, streamed by a ``StreamingSamplerNode`` through
    ``HttpWavStreamReader`` on the card: bit for bit against the same node
    reading the file from disk on the card, and within 1e-5 of the CPU."""
    from firewheel_tpu_torch.utils.net_stream import HttpWavStreamReader
    from firewheel_tpu_torch.utils.wav import WavStreamReader, write_wav

    path = os.path.join(scratch_dir("http-"), "clip.wav")
    t = np.arange(int(HTTP_SECS * 48000)) / 48000
    audio = (0.3 * np.stack([np.sin(2 * np.pi * 330 * t), np.sin(2 * np.pi * 495 * t)])
             + 0.05 * np.random.default_rng(21).standard_normal((2, len(t))))
    write_wav(path, audio.astype(np.float32), 48000, dtype="i16")
    with open(path, "rb") as f:
        srv, base = _range_server({"/clip.wav": f.read()})
    try:
        def render(reader, device):
            cx = ft.FirewheelCtx(device=device)
            g = cx.graph_mut()
            deck = g.add_node(0, 2, ft.StreamingSamplerNode(reader, window_secs=0.25))
            for c in range(2):
                g.connect(deck, c, g.graph_out_node(), c)
            sink = ft.ArraySink()
            cx.activate(ft.StreamConfig(48000, 2, buffer_frames=HTTP_BUFFER,
                                        block_frames=128), sink=sink)
            g.node(deck).play()
            t0 = time.perf_counter()
            cx.render_offline(HTTP_SECS + 0.1)
            wall = time.perf_counter() - t0
            cx.deactivate()
            return sink.audio(2), wall

        net_reader = HttpWavStreamReader(base + "/clip.wav", segment_bytes=65536)
        net, wall = render(net_reader, "cuda")
        disk, _ = render(WavStreamReader(path), "cuda")
        cpu, _ = render(HttpWavStreamReader(base + "/clip.wav", segment_bytes=65536), "cpu")
    finally:
        srv.shutdown()
        srv.server_close()
    if not np.array_equal(net, disk):
        raise AssertionError("15(c): the HTTP stream renders apart from the disk's: "
                             f"max {float(np.abs(net - disk).max()):.3e}")
    err = float(np.abs(net - cpu).max())
    if err > SLICE_TOL or float(np.abs(net).max()) < 0.1:
        raise AssertionError(f"15(c): the card vs the CPU max_abs_err={err:.3e}, peak "
                             f"{np.abs(net).max()}")
    log(f"phase 15(c), a WAV over localhost HTTP on the card ({card}): HTTP == disk bit "
        f"for bit over {net.shape[1]} frames, {net_reader.source.request_count} requests, "
        f"RTF {net.shape[1] / 48000 / wall:.3f}; vs the CPU max_abs_err={err:.3e}")
    return err


def check_validator(ft, seq_iir, dynamics, noise, iir) -> dict:
    """15(d): the port's ``validate_node`` on the card for the nodes whose
    kernels the port wrote by hand; every check must pass and each kernel
    must launch.  Returns the launches by wrapper."""
    from firewheel_tpu_torch import nodes as n
    from firewheel_tpu_torch.testing import validate_node

    counters = (seq_iir.biquad_seq, dynamics.scan_lanes, noise.noise_uniform,
                iir.biquad_cascade, iir.one_pole_scan)
    for c in counters:
        c.launches = 0
    for name, node, n_in, wants in (
            ("FilterNode(backend='pallas')",
             n.FilterNode(n.FilterType.LOWPASS, 2000.0, backend="pallas"), 2, ("biquad_seq",)),
            ("CompressorNode", n.CompressorNode(), 2, ("scan_lanes",)),
            ("NoiseNode('pink')", n.NoiseNode("pink"), 0, ("noise_uniform", "scan_lanes")),
            ("ParametricEQNode", n.ParametricEQNode(), 2, ("biquad_cascade",))):
        before = {c.__name__: c.launches for c in counters}
        report = validate_node(node, n_in, 2, device="cuda")
        launched = {c.__name__: c.launches - before[c.__name__] for c in counters}
        failed = {k: v for k, v in report.items() if k != "supports_megakernel" and v != "ok"}
        if failed or len(report) < 8 or not all(launched[w] for w in wants):
            raise AssertionError(f"15(d): {name}: {report}, launches {launched}")
        log(f"phase 15(d), validate_node({name}, device='cuda'): "
            f"{', '.join(k for k in report if report[k] == 'ok')} ok; launches "
            f"{ {k: v for k, v in launched.items() if v} }")
    return {c.__name__: c.launches for c in counters}


def check_pool_slice(ft, seq_iir, em, eh, adpcm_device, dynamics, iir, noise, cpu_result,
                     card: str, phase):
    """Phase 15: the voice pool, MIDI playback, HTTP streaming and the node
    validator on the card.  No kernel of the port's lies on 15(a)-(c): K1-K7
    must launch no time there; 15(d) must launch K1, K5, K6 and K7.
    Returns 15(d)'s launches by wrapper."""
    counters = (seq_iir.biquad_seq, em.MegaRenderer, eh.HybridMegaRenderer,
                adpcm_device.encode_ima_chunk, dynamics.scan_lanes,
                noise.noise_uniform, iir.biquad_cascade, iir.one_pole_scan)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    err = check_pool(cpu_result, card)
    phase("15(a), the voice pool")
    err = max(err, check_jukebox(cpu_result, card))
    phase("15(b), the MIDI jukebox")
    err = max(err, check_http(ft, card))
    launched = {c.__name__: c.launches for c in counters}
    if any(launched.values()):
        raise AssertionError(f"15(a)-(c) launched kernels of the port's: {launched}")
    log(f"phase 15(a)-(c): launches of K1-K7 on these paths {launched}")
    phase("15(c), a WAV over HTTP")
    validator = check_validator(ft, seq_iir, dynamics, noise, iir)
    phase("15(d), the validator on the card")
    log(f"phase 15: {time.perf_counter() - t0:.1f} s; the card vs the CPU, "
        f"max_abs_err={err:.3e}")
    return validator


MESH_RANKS = 2             # 16(b), 16(c): processes sharing the one card (gloo)
MESH_TOL = 1e-6            # 16(b): a rank's rows vs the unsharded render on the card
MESH_SPLICED = (3, 6000)   # 16(b): instances spliced loud, one on each rank
MESH_RESET = 4099          # 16(b): the instance reset (rank 1's)
MESH_CHUNKS = 6            # 16(b): 3 timed, a splice and a poll, a checkpoint, 2 more
MIX_VOICES = 64            # 16(c): the mixer's voices over "vp"
MIX_CHUNKS = 3             # 16(c): chunks of K blocks carrying state
MIX_TOL = 1e-5             # 16(c): meshed vs unmeshed and card vs CPU
RANK_TIMEOUT = 240.0       # seconds a rank of 16(b) may take, its set-up included


def loud_splice(prog) -> dict:
    """One instance's params of the mixer with every voice's volume at
    200 %: spliced into an instance, it clips (16(b)'s events)."""
    tree = prog.collect_params()
    for key, p in tree.items():
        if isinstance(p, dict) and "raw_gain" in p:
            tree[key] = dict(p, raw_gain=np.float32(2.0))
    return tree


def mesh_events(renderer, state) -> list:
    """``renderer.poll_events(state)`` as sorted (instance, node, event,
    count, total, lane) lists."""
    return sorted([e.instance, repr(e.node_id), e.name, e.count, e.total,
                   -1 if e.lane is None else e.lane]
                  for e in renderer.poll_events(state))


def _leaves(tree) -> list:
    return [x for v in tree.values() for x in _leaves(v)] if isinstance(tree, dict) \
        else [tree]


def owner_only(renderer, tree, index: int, fn) -> None:
    """Run ``fn()`` (an in-place splice of ``tree`` at global ``index``)
    and check that it changed ``index``'s row where this process owns it
    and nothing else, bit for bit."""
    before = [t.clone() for t in _leaves(tree)]
    fn()
    local = index - renderer.local_rows.start
    owner = 0 <= local < renderer.local_rows.stop - renderer.local_rows.start
    changed = False
    for b, a in zip(before, _leaves(tree)):
        if owner:
            changed |= not torch.equal(b[local], a[local])
            b, a = torch.cat([b[:local], b[local + 1:]]), torch.cat([a[:local], a[local + 1:]])
        if not torch.equal(b, a):
            raise AssertionError(f"a splice at instance {index} wrote other rows")
    if owner and not changed:
        raise AssertionError(f"a splice at instance {index} left its row as it was")


class _CollectiveTimer:
    """Times each ``torch.distributed.all_reduce`` while active: the card
    synchronised before the call starts its clock, and again when it ends."""

    def __init__(self):
        self.ms: list = []

    def __enter__(self):
        import torch.distributed as dist

        self._dist, self._orig = dist, dist.all_reduce

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            work = self._orig(*args, **kwargs)
            torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t0) * 1e3)
            return work

        dist.all_reduce = timed
        return self

    def __exit__(self, *exc):
        self._dist.all_reduce = self._orig


def read_trace(path: str):
    """``(annotated, K1 kernels, kernels)`` of a Chrome trace: whether it
    holds the "render-chunk" region, and its kernel events."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    annotated = any(e.get("name") == "render-chunk" for e in events)
    return annotated, sum("biquad_seq_kernel" in n for n in kernels), len(kernels)


def traced_chunk(renderer, params, state, c: int, logdir: str):
    """One chunk under ``utils.profiler.trace`` with ``annotate(
    "render-chunk")`` → (the trace's path, :func:`read_trace` of it,
    seconds with the export)."""
    from firewheel_tpu_torch.utils import annotate, trace

    t0 = time.perf_counter()
    with trace(logdir):
        with annotate("render-chunk"):
            renderer.render_chunk(params, state, start_sample=c * K * 128, num_blocks=K)
    seconds = time.perf_counter() - t0
    path = max((os.path.join(logdir, f) for f in os.listdir(logdir)), key=os.path.getmtime)
    return path, read_trace(path), seconds


def mix_run(mixer, params, state):
    """16(c): MIX_CHUNKS chunks of K blocks → (outputs [chunks, K, 2, F] on
    the host, final state, walls a chunk in ms)."""
    outs, walls = [], []
    cuda = mixer.device.type == "cuda"
    for c in range(MIX_CHUNKS):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _, state = mixer.render_chunk(params, state, start_sample=c * K * 128,
                                           num_blocks=K)
        if cuda:
            torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        outs.append(out.cpu())
    return torch.stack(outs), state, walls


def mesh_rank(argv) -> int:
    """One rank of 16(b) and 16(c), started by :func:`check_scale_out`:
    ``chip_smoke.py --mesh-rank RANK PORT WORK``.  Joins a gloo group of
    MESH_RANKS on ``cuda:0``, builds its half of the dp=2 fleet and of the
    vp=2 mixer, waits for ``WORK/go``, renders, and writes its rows and
    numbers into ``WORK``."""
    rank, port, work = int(argv[0]), argv[1], argv[2]
    ft = _port()
    from firewheel_tpu_torch.convert import tree_map
    from firewheel_tpu_torch.mixer import voice_mix_programs, voice_snapshots
    from firewheel_tpu_torch.ops import seq_iir
    from firewheel_tpu_torch.parallel import (
        BatchRenderer, VoiceParallelMixer, initialize_multihost, make_mesh,
    )

    torch.cuda.set_device(0)
    initialize_multihost(f"localhost:{port}", MESH_RANKS, rank, backend="gloo")
    dp = make_mesh({"dp": MESH_RANKS})
    prog = ft.mixer_graph(filter_backend="pallas", device="cuda")
    br = BatchRenderer(prog, B, device="cuda", mesh=dp)
    params, state = mixer_params(br, br.local_rows), br.init_state()
    vprog, mprog, voice = voice_mix_programs("pallas", "cuda")
    mixer = VoiceParallelMixer(vprog, MIX_VOICES, mprog, mesh=make_mesh({"vp": MESH_RANKS}),
                               axis="vp")
    mparams = mixer.stack_voice_params(voice_snapshots(vprog, voice, MIX_VOICES))
    if "jax" in sys.modules or "firewheel_tpu" in sys.modules:
        raise RuntimeError("a rank imported JAX")
    open(os.path.join(work, f"ready{rank}"), "w").close()
    mix_run(mixer, mparams, mixer.init_state())  # warm-up: the vp group's first collective
    deadline = time.time() + RANK_TIMEOUT
    go = os.path.join(work, "go")
    while not os.path.exists(go):
        if time.time() > deadline:
            raise TimeoutError("no go from the parent")
        time.sleep(0.02)
    torch.distributed.barrier()

    got = {"rank": rank, "rows": [br.local_rows.start, br.local_rows.stop]}
    outs, walls, window = [], [], [time.time()]
    seq_iir.biquad_seq.launches = 0
    for c in range(MESH_CHUNKS):
        if c == 3:
            got["events"] = [mesh_events(br, state)]
            for index in MESH_SPLICED:
                owner_only(br, params, index,
                           lambda: br.update_instance(params, index, loud_splice(prog)))
            owner_only(br, state, MESH_RESET, lambda: br.reset_instance(state, MESH_RESET))
        if c == 4:
            got["events"].append(mesh_events(br, state))
            t0 = time.perf_counter()
            got["ckpt_bytes"] = br.save_checkpoint(os.path.join(work, "ck"), state)
            got["ckpt_s"] = time.perf_counter() - t0
            at_save = tree_map(lambda t: t.clone(), state)
        t0 = time.perf_counter()
        out, _, state = br.render_chunk(params, state, start_sample=c * K * 128,
                                        num_blocks=K)
        torch.cuda.synchronize()
        if c < 3:
            walls.append((time.perf_counter() - t0) * 1e3)
            if c == 2:
                window.append(time.time())
                got["k1"] = seq_iir.biquad_seq.launches
        outs.append(out)
    got.update(walls=walls, window=window)
    # a fresh 2-rank fleet restored from the checkpoint: the next two chunks
    fresh = BatchRenderer(prog, B, device="cuda", mesh=dp)
    t0 = time.perf_counter()
    restored, meta = fresh.restore_checkpoint(os.path.join(work, "ck"))
    torch.cuda.synchronize()
    got["restore_s"] = time.perf_counter() - t0
    if meta["process_count"] != MESH_RANKS or tree_err(restored, at_save) != 0.0:
        raise AssertionError("the restored rows differ from the saved ones")
    for c in (4, 5):
        out, _, restored = fresh.render_chunk(params, restored, start_sample=c * K * 128,
                                              num_blocks=K)
        if not torch.equal(out, outs[c]):
            raise AssertionError(f"chunk {c} of the restored 2-rank fleet differs")
    for c, out in enumerate(outs):
        np.save(os.path.join(work, f"rank{rank}_c{c}.npy"), out.cpu().numpy())
    del outs, fresh, restored, at_save

    # 16(c): the mixer's 64 voices at vp=2
    seq_iir.biquad_seq.launches = 0
    collectives = mixer.collectives
    with _CollectiveTimer() as timer:
        mouts, mstate, mwalls = mix_run(mixer, mparams, mixer.init_state())
    got.update(mix_walls=mwalls, mix_k1=seq_iir.biquad_seq.launches,
               collectives=mixer.collectives - collectives, collective_ms=timer.ms,
               voices=[mixer.local_voices.start, mixer.local_voices.stop])
    torch.save({"out": mouts, "master": tree_map(lambda t: t.cpu(), mstate["master"])},
               os.path.join(work, f"mix{rank}.pt"))
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(got, f)
    torch.distributed.destroy_process_group()
    return 0


def start_mesh_ranks(work: str) -> list:
    """Start 16(b)'s ranks: this script with ``--mesh-rank``, one process
    each, their output in ``WORK/rank<r>.log``."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    here = os.path.abspath(__file__)
    return [subprocess.Popen([sys.executable, here, "--mesh-rank", str(r), str(port), work],
                             stdout=open(os.path.join(work, f"rank{r}.log"), "w"),
                             stderr=subprocess.STDOUT)
            for r in range(MESH_RANKS)]


def wait_mesh_ranks(procs, work: str, deadline: float) -> None:
    """Wait for every rank to exit 0 by ``deadline`` (time.time()); a rank
    that fails or outlives it fails the phase with its log's tail."""
    for r, p in enumerate(procs):
        try:
            rc = p.wait(timeout=max(deadline - time.time(), 1.0))
        except subprocess.TimeoutExpired:
            rc = None
        if rc != 0:
            with open(os.path.join(work, f"rank{r}.log")) as f:
                tail = f.read()[-3000:]
            raise AssertionError(f"16(b) rank {r} {'timed out' if rc is None else f'exited {rc}'}:"
                                 f"\n{tail}")


def check_scale_out(ft, seq_iir, card: str, phase, phase4_wall: float) -> dict:
    """Phase 16: scale-out over torch.distributed → K1's launches in it."""
    import shutil
    import socket

    import torch.distributed as dist

    from firewheel_tpu_torch.convert import tree_map
    from firewheel_tpu_torch.mixer import voice_mix_programs, voice_snapshots
    from firewheel_tpu_torch.parallel import (
        BatchRenderer, VoiceParallelMixer, initialize_multihost, make_mesh,
    )
    work = scratch_dir("mesh_")
    procs = start_mesh_ranks(work)
    launches = {}
    try:
        # 16(a): one process, NCCL, a world of 1
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        initialize_multihost(f"localhost:{port}", 1, 0)
        if dist.get_backend() != "nccl":
            raise AssertionError(f"the default backend is {dist.get_backend()}")
        prog = ft.mixer_graph(filter_backend="pallas", device="cuda")
        br0 = BatchRenderer(prog, B, device="cuda")
        brm = BatchRenderer(prog, B, device="cuda", mesh=make_mesh({"dp": 1}))
        p0, s0 = mixer_params(br0), br0.init_state()
        pm, sm = mixer_params(brm, brm.local_rows), brm.init_state()
        ref, k1 = [], []
        for c in range(3):
            out0, _, s0 = br0.render_chunk(p0, s0, start_sample=c * K * 128, num_blocks=K)
            seq_iir.biquad_seq.launches = 0
            outm, _, sm = brm.render_chunk(pm, sm, start_sample=c * K * 128, num_blocks=K)
            torch.cuda.synchronize()
            k1.append(seq_iir.biquad_seq.launches)
            if not torch.equal(out0, outm):
                raise AssertionError(f"16(a): chunk {c} of the dp=1 renderer differs")
            ref.append(out0)
        if k1 != [K] * 3 or tree_err(s0, sm) != 0.0:
            raise AssertionError(f"16(a): K1 launches {k1}, state {tree_err(s0, sm)}")
        launches["16(a) dp=1"] = sum(k1)
        log(f"phase 16(a), BatchRenderer over make_mesh({{'dp': 1}}) on NCCL, a world of "
            f"1 ({card}): the mixer at B={B}, K={K}, 3 chunks bit for bit the unmeshed "
            f"renderer's, outputs and state; K1 launches {k1}")

        # 16(d): the profiler around one chunk of the meshed renderer
        seq_iir.biquad_seq.launches = 0
        path, (annotated, k1_events, kernels), trace_s = traced_chunk(
            brm, pm, sm, 3, os.path.join(work, "trace"))
        if not annotated or not k1_events:
            raise AssertionError(f"16(d): the trace holds the annotation {annotated}, "
                                 f"{k1_events} K1 kernels of {kernels}")
        launches["16(d) profiled chunk"] = seq_iir.biquad_seq.launches
        log(f"phase 16(d), utils.profiler.trace around one chunk: "
            f"{os.path.getsize(path) / 1e6:.1f} MB, the 'render-chunk' annotation, "
            f"{k1_events} biquad_seq_kernel launches of {kernels} kernels; "
            f"{trace_s:.1f} s with the export")
        del brm, pm, sm

        # 16(c) at vp=1, the unmeshed mixer on the card, and the CPU's
        vprog, mprog, voice = voice_mix_programs("pallas", "cuda")
        snaps = voice_snapshots(vprog, voice, MIX_VOICES)
        m1 = VoiceParallelMixer(vprog, MIX_VOICES, mprog, mesh=make_mesh({"vp": 1}),
                                axis="vp")
        m0 = VoiceParallelMixer(vprog, MIX_VOICES, mprog)
        for m in (m0, m1):  # warm-up: the kernels, NCCL's communicator
            mix_run(m, m.stack_voice_params(snaps), m.init_state())
        seq_iir.biquad_seq.launches = 0
        collectives = m1.collectives
        with _CollectiveTimer() as timer:
            mix1, st1, walls1 = mix_run(m1, m1.stack_voice_params(snaps), m1.init_state())
        launches["16(c) vp=1"] = seq_iir.biquad_seq.launches
        collectives = m1.collectives - collectives
        mix0, st0, walls0 = mix_run(m0, m0.stack_voice_params(snaps), m0.init_state())
        cvprog, cmprog, cvoice = voice_mix_programs("pallas", "cpu")
        mc = VoiceParallelMixer(cvprog, MIX_VOICES, cmprog)
        mixc, stc, _ = mix_run(mc, mc.stack_voice_params(
            voice_snapshots(cvprog, cvoice, MIX_VOICES)), mc.init_state())
        e10 = max(float((mix1 - mix0).abs().max()), tree_err(st1["master"], st0["master"]))
        e1c = max(float((mix1 - mixc).abs().max()), tree_err(st1["master"], stc["master"]))
        peak = float(mixc.abs().max())
        if not (e10 <= MIX_TOL and e1c <= MIX_TOL and 0.01 < peak <= 1.0):
            raise AssertionError(f"16(c) vp=1: vs unmeshed {e10}, vs CPU {e1c}, peak {peak}")
        if launches["16(c) vp=1"] != K * MIX_CHUNKS or collectives != MIX_CHUNKS:
            raise AssertionError(f"16(c) vp=1: K1 {launches['16(c) vp=1']}, "
                                 f"collectives {collectives}")
        log(f"phase 16(c), VoiceParallelMixer, {MIX_VOICES} voices at vp=1 on NCCL ({card}):"
            f" K={K}, {MIX_CHUNKS} chunks, wall a chunk {[round(w, 3) for w in walls1]} ms "
            f"(unmeshed {[round(w, 3) for w in walls0]} ms); {collectives} all_reduce "
            f"(NCCL), "
            f"{[round(t, 3) for t in timer.ms]} ms each; K1 launches "
            f"{launches['16(c) vp=1']}; vs unmeshed max_abs_err={e10:.3e}, vs the CPU "
            f"{e1c:.3e}, master state included")

        # 16(b)'s reference: the unsharded fleet through the ranks' calls
        ref_events = []
        for c in range(3, MESH_CHUNKS):
            if c == 3:
                ref_events.append(mesh_events(br0, s0))
                for index in MESH_SPLICED:
                    br0.update_instance(p0, index, loud_splice(prog))
                br0.reset_instance(s0, MESH_RESET)
            if c == 4:
                ref_events.append(mesh_events(br0, s0))
            out0, _, s0 = br0.render_chunk(p0, s0, start_sample=c * K * 128, num_blocks=K)
            ref.append(out0)
        torch.cuda.synchronize()
        phase("16(a), (c) at vp=1 and (d), and 16(b)'s unsharded reference")

        # 16(b): two ranks share the card over gloo, 16(c) at vp=2
        deadline = time.time() + RANK_TIMEOUT
        while not all(os.path.exists(os.path.join(work, f"ready{r}"))
                      for r in range(MESH_RANKS)):
            if time.time() > deadline or any(p.poll() is not None for p in procs):
                wait_mesh_ranks(procs, work, time.time())
            time.sleep(0.05)
        open(os.path.join(work, "go"), "w").close()
        wait_mesh_ranks(procs, work, deadline)
        ranks = []
        for r in range(MESH_RANKS):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        err, bit = 0.0, True
        for got in ranks:
            rows = slice(*got["rows"])
            for c in range(MESH_CHUNKS):
                mine = torch.from_numpy(np.load(os.path.join(
                    work, f"rank{got['rank']}_c{c}.npy"))).cuda()
                err = max(err, float((mine - ref[c][rows]).abs().max()))
                bit &= torch.equal(mine, ref[c][rows])
                if c >= 4:
                    ref[c][rows] = mine  # the uninterrupted 2-rank fleet's chunk
        if not err <= MESH_TOL:
            raise AssertionError(f"16(b): a rank's rows vs the unsharded render {err}")
        for p in range(2):
            union = sorted(e for got in ranks for e in got["events"][p])
            if union != ref_events[p]:
                raise AssertionError(f"16(b): poll {p}: the ranks' events differ from the "
                                     f"unsharded fleet's")
        spliced = {e[0] for e in ref_events[1]}
        if not set(MESH_SPLICED) <= spliced:
            raise AssertionError("16(b): no clip events from the spliced instances")

        # the checkpoint restored in this process (2 → 1), bit for bit
        brr = BatchRenderer(prog, B, device="cuda")
        restored, meta = brr.restore_checkpoint(os.path.join(work, "ck"))
        if meta["rank_offsets"] != [0, B // 2]:
            raise AssertionError(f"16(b): rank_offsets {meta['rank_offsets']}")
        cpu_prog = ft.mixer_graph(filter_backend="pallas", device="cpu")
        cpu_br = ft.BatchRenderer(cpu_prog, CHECK_INSTANCES, device="cpu")
        rows = slice(0, CHECK_INSTANCES)
        cpu_params = tree_map(lambda t: t[rows].cpu(), p0)
        cpu_state = tree_map(lambda t: t[rows].cpu(), restored)
        cpu_err = 0.0
        for c in (4, 5):
            out, _, restored = brr.render_chunk(p0, restored, start_sample=c * K * 128,
                                                num_blocks=K)
            if not torch.equal(out, ref[c]):
                raise AssertionError(f"16(b): chunk {c} restored 2 → 1 differs")
            cpu_out, _, cpu_state = cpu_br.render_chunk(
                cpu_params, cpu_state, start_sample=c * K * 128, num_blocks=K)
            cpu_err = max(cpu_err, float((out[rows].cpu() - cpu_out).abs().max()))
        if not cpu_err <= SLICE_TOL:
            raise AssertionError(f"16(b): the restored fleet vs the CPU {cpu_err}")
        launches["16(b) dp=2 ranks"] = [got["k1"] for got in ranks]
        if launches["16(b) dp=2 ranks"] != [K * 3] * MESH_RANKS:
            raise AssertionError(f"16(b): K1 launches {launches['16(b) dp=2 ranks']}")
        audio = B * K * 128 / 48000
        rank_walls = [float(np.mean(got["walls"][1:])) for got in ranks]
        window = max(g["window"][1] for g in ranks) - min(g["window"][0] for g in ranks)
        log(f"phase 16(b), BatchRenderer over make_mesh({{'dp': {MESH_RANKS}}}) on gloo, "
            f"{MESH_RANKS} processes sharing one card (a stand-in for {MESH_RANKS} cards: "
            f"NCCL refuses two ranks on one device) ({card}): the mixer at B={B}, K={K}, "
            f"{B // MESH_RANKS} rows a rank; each rank's rows vs the unsharded render on "
            f"the card over {MESH_CHUNKS} chunks max_abs_err={err:.3e} "
            f"({'bit for bit' if bit else 'not bit for bit'}); splices at {MESH_SPLICED} and "
            f"the reset at {MESH_RESET} on their owners only; the ranks' clip events "
            f"(global instances, {len(ref_events[0])} and {len(ref_events[1])}) equal the "
            f"unsharded poll; the checkpoint ({[g['ckpt_bytes'] / 1e9 for g in ranks]} GB in "
            f"{[round(g['ckpt_s'], 3) for g in ranks]} s) restored by a fresh 2-rank fleet "
            f"({[round(g['restore_s'], 3) for g in ranks]} s) and in one process (2 → 1): "
            f"the next 2 chunks bit for bit; restored rows vs the CPU "
            f"max_abs_err={cpu_err:.3e}; K1 launches {launches['16(b) dp=2 ranks']}")
        log(f"phase 16(b), measured, nothing claimed: wall a chunk per rank "
            f"{[[round(w, 3) for w in g['walls']] for g in ranks]} ms (the first chunk "
            f"a fresh process's first), mean of chunks 2-3 {[round(w, 3) for w in rank_walls]} "
            f"ms; the fleet's 3 chunks in {window * 1e3:.3f} ms from the first rank's start "
            f"to the last rank's end, {3 * B / window:.0f} instances a second, RTF "
            f"{3 * audio / window:.1f}; beside it one process at B={B}, phase 4: "
            f"{phase4_wall * 1e3:.3f} ms a chunk, {B / phase4_wall:.0f} instances a "
            f"second, RTF {audio / phase4_wall:.1f}")

        # 16(c) at vp=2: each rank's mix against the unmeshed card's and the CPU's
        launches["16(c) vp=2 ranks"] = [got["mix_k1"] for got in ranks]
        e2 = 0.0
        for got in ranks:
            mix = torch.load(os.path.join(work, f"mix{got['rank']}.pt"))
            e2 = max(e2, *(float((mix["out"] - m).abs().max()) for m in (mixc, mix0, mix1)),
                     tree_err(mix["master"], stc["master"]),
                     tree_err(mix["master"], st0["master"]))
        if not e2 <= MIX_TOL or launches["16(c) vp=2 ranks"] != [K * MIX_CHUNKS] * MESH_RANKS \
                or any(g["collectives"] != MIX_CHUNKS for g in ranks):
            raise AssertionError(f"16(c) vp=2: err {e2}, K1 {launches['16(c) vp=2 ranks']}, "
                                 f"collectives {[g['collectives'] for g in ranks]}")
        log(f"phase 16(c), VoiceParallelMixer at vp={MESH_RANKS} on gloo, CUDA tensors, "
            f"two processes on one card ({card}): voices {[g['voices'] for g in ranks]}; "
            f"wall a chunk {[[round(w, 3) for w in g['mix_walls']] for g in ranks]} ms; "
            f"{ranks[0]['collectives']} all_reduce of f32[{K}, 2, 128] a rank, one a chunk, "
            f"{[[round(t, 3) for t in g['collective_ms']] for g in ranks]} ms each; vs the "
            f"CPU and vp=1 max_abs_err={e2:.3e}, master state included; K1 launches "
            f"{launches['16(c) vp=2 ranks']}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(work, ignore_errors=True)
    return launches


# -- phase 17: differentiable rendering (K8, K9) --------------------------------
#: (kind, rows, frames, sections) where 17(a) holds K8 against its plain
#: backward: 3(c)'s operands at the eager filter's and the batched EQ's
#: rows (one section, the EQ's three; two and eight, the most a launch
#: takes), the one-pole there and at the spatializers' pooled rows, the
#: streams' rows, long rows, a ragged warp whose first stage run backwards
#: is ragged (33 rows of 127 frames) or is not (4096), and nine sections
#: (two launches each way, through autograd)
K8_CASES = (("biquad", 2 * B, 128, 1), ("cascade", 2 * B, 128, 3),
            ("cascade", 2 * B, 128, 2), ("cascade", 2 * B, 128, 8),
            ("one_pole", 2 * B, 128, 1), ("one_pole", *POOLED_ONE_POLE, 1),
            ("biquad", 2, 128, 1), ("one_pole", 2, 128, 1), ("biquad", 2, 256, 1),
            ("one_pole", 2, 256, 1), ("cascade", 2, 128, 3), ("biquad", 33, 4096, 1),
            ("one_pole", 33, 4096, 1), ("cascade", 33, 127, 3), ("cascade", 33, 4096, 3),
            ("cascade", 1000, 127, 3), ("cascade", 2, 128, 9))
#: where 17(a) times K8
K8_TIMED = (("cascade", 2 * B, 128, 3), ("biquad", 2 * B, 128, 1),
            ("cascade", 2 * B, 128, 2), ("cascade", 2 * B, 128, 8),
            ("one_pole", 2 * B, 128, 1), ("one_pole", *POOLED_ONE_POLE, 1),
            ("biquad", 2, 128, 1))
#: K8's and K9's kernels by name in a profile
K8_KERNEL = {"biquad": "biquad_bwd_kernel", "cascade": "biquad_bwd_kernel",
             "one_pole": "one_pole_bwd_kernel"}
K9_KERNEL = "sample_scan_bwd_kernel"
#: f32 operations a frame of each K9 kind (its adjoint; the gate's latch
#: recomputed forward besides)
K9_OPS = {"envelope": 8, "limiter": 11, "gate": 26, "pink": 14}
#: 17(b)'s gate beside K5_SHAPES: [1000, 127] (ragged last stages), and at
#: these shapes also levels mostly below its close threshold with a burst
#: above its open one every ~40 frames (the "sparse" form), so that its
#: 48-frame hold counts down across stage boundaries and the gate closes
K9_GATE_SHAPES = ((1, 256), (2, 256), (33, 4096), (1000, 127))
#: K8 and K9 vs their plain backwards on the card, relative to each
#: gradient's largest magnitude: the same float32 operations in the same
#: order (built with --fmad=false), bit for bit when nothing else differs
BWD_TOL = 1e-5
GRAD_B, GRAD_K, GRAD_STEPS = 1024, 8, 5   # 17(c): instances, blocks a chunk, SGD steps
#: 17(c) and 17(e): the card's gradients vs the CPU's for the same
#: instances, relative to each leaf's largest magnitude (K8 runs the
#: adjoint frame by frame, the CPU autograd over the scan's tree)
GRAD_TOL = 1e-4
#: 17(c)'s learning rate for each kind of leaf
GRAD_LR = {"raw_gain": 8.0, "pan": 8.0, "freq": 1.0e8, "q": 10.0}
BUS_GRAD = (256, 16)                  # 17(e): B, K on the card
BUS_LEAVES = (("compressor", "threshold_db"), ("compressor", "makeup"),
              ("limiter", "ceiling"))
EQ_GATE_GRAD = (8192, 8)              # 17(h): B, K (16 384 EQ rows, 8192 gate lanes)
EQ_GATE_LR = {"gain": 20.0, "floor": 0.5}  # 17(h)'s SGD step, by kind of leaf
EQ_GATE_STEPS = 3                     # 17(h): steps timed (the first warms up)


def _rel_err(got, want) -> float:
    """max |got − want| over the largest |want|."""
    scale = float(want.abs().max()) if want.numel() else 0.0
    return float((got - want).abs().max()) / scale if scale else float((got - want).abs().max())


def _flat(t):
    return [t] if isinstance(t, torch.Tensor) else [u for v in t for u in _flat(v)]


def k8_work(kind: str, rows: int, n: int, sections: int = 1):
    """``(bytes, f32 ops)`` K8 must do over ``rows`` rows of ``n`` frames:
    x, y and g_y read and g_x written; per row each section's
    coefficients, state in and state-out gradient read and their
    gradients written.  A section's adjoint is 19 operations a frame, each
    earlier section's input recomputed 9; the one-pole's adjoint 7."""
    if kind == "one_pole":
        return 4 * rows * (4 * n + 4 + 3), 7 * rows * n
    return (4 * rows * (4 * n + sections * (9 + 7)),
            rows * n * (19 * sections + 9 * (sections - 1)))


def k9_work(x, carry, coefs, kind: str):
    """``(bytes, f32 ops)`` K9 must do: the arrays its adjoint reads, x, y
    and g_y (the pink's, which is linear, g_y alone), and g_x written; the
    carry in (not the pink's), the carry-out gradient and the carry's
    gradient; the per-lane coefficients and their gradients."""
    lanes = x.numel() // x.shape[-1]
    n_carry = carry.shape[-1] if isinstance(carry, torch.Tensor) else len(carry)
    per_lane = sum(isinstance(c, torch.Tensor) and c.numel() > 1 for c in coefs)
    arrays, carries = (2, 2) if kind == "pink" else (4, 3)
    return (4 * (arrays * x.numel() + lanes * (carries * n_carry + 2 * per_lane)),
            K9_OPS[kind] * x.numel())


def k8_case(iir, kind: str, rows: int, n: int, s: int, gen):
    """K8's call and its plain backward on one case of ``K8_CASES`` →
    ``(fn, ref)``; nine sections go through autograd of ``biquad_cascade``
    (two launches each way), held against the plain backward of each
    launch's sections."""
    dev = torch.device("cuda")
    _, _, args = k7_operands(iir, kind, rows, n, gen, s)
    rnd = lambda shape: torch.randn(shape, generator=gen).to(dev)  # noqa: E731
    if kind == "one_pole":
        x, y0, a, b = args
        y, _ = iir.one_pole_scan(x, y0, a, b)
        g_y, g_last = rnd((rows, n)), rnd((rows,))
        call = (x, y, y0, a, b, g_y, g_last)
        return (lambda: iir.one_pole_scan_backward(*call),
                lambda: iir.one_pole_scan_backward_reference(*call))
    x, zs, cs = (args[0], (args[1],), (args[2],)) if kind == "biquad" else args
    y, _ = iir.biquad_cascade(x, zs, cs)
    g_y = rnd((rows, n))
    g_z = tuple((rnd((rows,)), rnd((rows,))) for _ in cs)
    call = (x, y, zs, cs, g_y, g_z)
    if s <= iir.MAX_SECTIONS:
        return (lambda: iir.biquad_cascade_backward(*call),
                lambda: iir.biquad_cascade_backward_reference(*call))

    def ref():
        # the plain backward of each launch's sections, last launch first,
        # each from the input and output that launch had
        m = iir.MAX_SECTIONS
        mid, _ = iir.biquad_cascade(x, zs[:m], cs[:m])
        g_mid, gz2, gc2 = iir.biquad_cascade_backward_reference(mid, y, zs[m:], cs[m:], g_y,
                                                                g_z[m:])
        g_x, gz1, gc1 = iir.biquad_cascade_backward_reference(x, mid, zs[:m], cs[:m], g_mid,
                                                              g_z[:m])
        return g_x, gz1 + gz2, gc1 + gc2

    def through_autograd():
        leaves = [x] + [v for z in zs for v in z] + [v for c in cs for v in c]
        leaves = [t.detach().requires_grad_() for t in leaves]
        lx, it = leaves[0], iter(leaves[1:])
        lz = [(next(it), next(it)) for _ in zs]
        lc = [iir.BiquadCoeffs(*(next(it) for _ in range(5))) for _ in cs]
        out, zo = iir.biquad_cascade(lx, lz, lc)
        loss = (out * g_y).sum() + sum((z * g).sum() for zz, gg in zip(zo, g_z)
                                       for z, g in zip(zz, gg))
        g = torch.autograd.grad(loss, leaves)
        k = 1 + 2 * len(zs)
        return (g[0], tuple((g[1 + 2 * i], g[2 + 2 * i]) for i in range(len(zs))),
                tuple(iir.BiquadCoeffs(*g[k + 5 * i:k + 5 * i + 5]) for i in range(len(cs))))

    return through_autograd, ref


def check_k8(iir) -> dict:
    """17(a): K8 (``biquad_cascade_backward``, ``one_pole_scan_backward``)
    against its plain backward on the card at ``K8_CASES`` → ``{label: (err,
    ms, call_ms, plain_ms, work)}`` at ``K8_TIMED`` (``err`` the largest
    absolute difference; every case within ``BWD_TOL`` of its gradient's
    largest magnitude)."""
    gen = torch.Generator(device="cpu").manual_seed(1717)
    res, worst_rel, worst_abs = {}, 0.0, 0.0
    for kind, rows, n, s in K8_CASES:
        label = k7_label(kind, rows, n, s)
        fn, ref = k8_case(iir, kind, rows, n, s, gen)
        before = iir.biquad_cascade_backward.launches + iir.one_pole_scan_backward.launches
        got = _flat(fn())
        torch.cuda.synchronize()
        launched = (iir.biquad_cascade_backward.launches
                    + iir.one_pole_scan_backward.launches - before)
        want = _flat(ref())
        rel = max(_rel_err(a, b) for a, b in zip(got, want))
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        if not (len(got) == len(want) and rel <= BWD_TOL):
            raise AssertionError(f"K8 {label} disagrees with its plain backward: {rel}")
        if launched != -(-s // iir.MAX_SECTIONS):
            raise AssertionError(f"K8 {label}: {launched} launches")
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, err)
        if (kind, rows, n, s) in K8_TIMED:
            ms = device_ms(fn, K8_KERNEL[kind], KERNEL_REPS)
            call_ms = cuda_ms(fn, 50)
            plain_ms = cuda_ms(ref, 1)
            work = k8_work(kind, rows, n, s)
            res[label] = (err, ms, call_ms, plain_ms, work)
            b_ms, b_by = bound(*work)
            log(f"K8 {label}: kernel {ms:.4f} ms on the device, {call_ms:.4f} ms a call, "
                f"plain backward {plain_ms:.3f} ms; bound {b_ms:.4f} ms by {b_by} "
                f"({work[0] / 1e6:.2f} MB, {work[1] / 1e6:.1f} M f32 operations), "
                f"{100 * b_ms / ms:.1f}% of it")
        del fn, ref, got, want
        torch.cuda.empty_cache()
    log(f"K8 vs its plain backward: {len(K8_CASES)} cases {[k7_label(*c) for c in K8_CASES]}, "
        f"largest difference {worst_abs:.3e}, {worst_rel:.3e} of its gradient's largest "
        f"magnitude (tolerance {BWD_TOL})")
    return res


def check_k9(dynamics) -> dict:
    """17(b): K9 (``scan_lanes_backward``) against its plain backward on the
    card, each kind at 3(b)'s shapes (``K5_SHAPES``, the pink's poles also
    stacked), the carry-out gradients non-zero → ``{label: (err, ms,
    call_ms, plain_ms, work)}`` at ``K5_TIMED``."""
    gen = torch.Generator(device="cpu").manual_seed(1718)
    rnd = lambda t: torch.randn(t.shape, generator=gen).to(t.device)  # noqa: E731
    res, worst_rel, worst_abs, cases = {}, 0.0, 0.0, 0
    for kind in K5_KINDS:
        for lanes, n in K5_SHAPES + (K9_GATE_SHAPES[-1:] if kind == "gate" else ()):
            if lanes in (B, 2 * B) and lanes != k5_lanes(kind, B):
                continue
            forms = (("lane", "stacked") if kind == "pink" and lanes >= B else
                     ("lane", "sparse") if kind == "gate" and (lanes, n) in K9_GATE_SHAPES
                     else ("lane",))
            for form in forms:
                code, x, carry, coefs = scan_operands(dynamics, kind, lanes, gen, n,
                                                      "lane" if form == "sparse" else form)
                if form == "sparse":
                    x = torch.where(torch.rand((lanes, n), generator=gen) < 1 / 40, 0.08,
                                    0.001).to(x.device)
                out, y = dynamics.scan_lanes(code, x, carry, coefs)
                g_y = rnd(y)
                g_out = rnd(out) if isinstance(out, torch.Tensor) else tuple(map(rnd, out))
                call = (code, x, carry, coefs, y, g_y, g_out)
                before = dynamics.scan_lanes_backward.launches
                got = _flat(dynamics.scan_lanes_backward(*call))
                torch.cuda.synchronize()
                want = _flat(dynamics.scan_lanes_backward_reference(*call))
                rel = max(_rel_err(a, b) for a, b in zip(got, want))
                err = max(float((a - b).abs().max()) for a, b in zip(got, want))
                label = f"{kind} f32[{lanes}, {n}], {form}"
                if not (len(got) == len(want) and rel <= BWD_TOL
                        and dynamics.scan_lanes_backward.launches == before + 1):
                    raise AssertionError(f"K9 {label} disagrees with its plain backward: "
                                         f"{rel}")
                worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, err)
                cases += 1
                if (lanes, n) in [(k5_lanes(kind, lb), nb) for lb, nb in K5_TIMED] \
                        and form == "lane":
                    fn = lambda: dynamics.scan_lanes_backward(*call)  # noqa: E731
                    ms = device_ms(fn, K9_KERNEL, KERNEL_REPS)
                    call_ms = cuda_ms(fn, 50)
                    plain_ms = cuda_ms(lambda: dynamics.scan_lanes_backward_reference(*call), 1)
                    work = k9_work(x, carry, coefs, kind)
                    res[f"{kind} f32[{lanes}, {n}]"] = (err, ms, call_ms, plain_ms, work)
                    b_ms = bound(*work)[0]
                    log(f"K9 {kind} at f32[{lanes}, {n}]: kernel {ms:.4f} ms on the device, "
                        f"{call_ms:.4f} ms a call, plain backward {plain_ms:.2f} ms; bound "
                        f"{b_ms:.4f} ms by bytes ({work[0] / 1e6:.3f} MB), "
                        f"{100 * b_ms / ms:.1f}% of it")
    log(f"K9 vs its plain backward: {cases} cases, each kind at "
        f"{[list(sh) for sh in K5_SHAPES]} (the pink at {2 * B} lanes, the others at {B}), "
        f"the gate also at {list(K9_GATE_SHAPES[-1])} and with sparse bursts at "
        f"{[list(sh) for sh in K9_GATE_SHAPES]}, "
        f"largest difference {worst_abs:.3e}, {worst_rel:.3e} of its gradient's largest "
        f"magnitude (tolerance {BWD_TOL})")
    return res


def kernel_counts(seq_iir, em, eh, adpcm_device, dynamics, iir, noise) -> dict:
    """Every kernel wrapper's launch count, by kernel."""
    return {"K1": seq_iir.biquad_seq.launches, "K2": em.MegaRenderer.launches,
            "K3": eh.HybridMegaRenderer.launches,
            "K4": adpcm_device.encode_ima_chunk.launches,
            "K5": dynamics.scan_lanes.launches, "K6": noise.noise_uniform.launches,
            "K7": iir.biquad_cascade.launches + iir.one_pole_scan.launches,
            "K8": iir.biquad_cascade_backward.launches + iir.one_pole_scan_backward.launches,
            "K9": dynamics.scan_lanes_backward.launches}


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def mixer_grad_leaves(prog, b: int, seed: int, device) -> dict:
    """``{(node key, param): f32[b]}``: each instance's 19 voices' gains and
    pans and the lowpass's frequency and Q, from ``seed``."""
    rng = np.random.default_rng(seed)
    leaves = {}
    for key, proc in prog._procs.items():
        name = type(proc).__name__
        if name == "VolumeProcessor":
            leaves[(key, "raw_gain")] = rng.uniform(0.3, 1.0, b)
        elif name == "StereoPanProcessor":
            leaves[(key, "pan")] = rng.uniform(-0.8, 0.8, b)
        elif name == "FilterProcessor":
            leaves[(key, "freq")] = rng.uniform(4000.0, 12000.0, b)
            leaves[(key, "q")] = rng.uniform(0.5, 1.2, b)
    return {k: torch.tensor(v, dtype=torch.float32, device=device) for k, v in leaves.items()}


def with_leaves(params: dict, leaves: dict) -> dict:
    p = {key: dict(v) for key, v in params.items()}
    for (key, name), t in leaves.items():
        p[key][name] = t
    return p


def chunk_energy(prog, params, state, b: int, k: int):
    """Each instance's mean square over a chunk of ``k`` blocks, by channel
    → f32[b, 2]."""
    dev = prog.device
    out, _, _ = prog.chunk_fn(k)(
        params, state, torch.zeros((b, k, 0, prog.max_block_frames), device=dev),
        torch.zeros((b, k, 0), dtype=torch.bool, device=dev), 0, 0)
    return (out ** 2).mean(dim=(1, 3))


def mixer_grads(prog, params, state, leaves, target, k: int):
    """The loss (each instance's channel energies against ``target``,
    squared and summed) and its gradients with respect to ``leaves``."""
    b = target.shape[0]
    req = {n: t.detach().requires_grad_() for n, t in leaves.items()}
    energy = chunk_energy(prog, with_leaves(params, req), state, b, k)
    loss = ((energy - target) ** 2).sum()
    grads = torch.autograd.grad(loss, list(req.values()))
    return loss.detach(), dict(zip(req, grads))


def profile_step(step, names=()):
    """``(kernels, device_ms, {name: device_ms})`` of one call of ``step`` by
    ``torch.profiler``: the kernels it ran, their device time, and the
    device time of the kernels whose name contains each of ``names``;
    ``(None, None, {})`` when the profile saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0]
    if not dev:
        return None, None, {}
    return (sum(e.count for e in dev), sum(e.device_time_total for e in dev) / 1e3,
            {n: sum(e.device_time_total for e in dev if n in e.key) / 1e3 for n in names})


def train_mixer(ft, counts, iir, card: str) -> dict:
    """17(c): the 64-node mixer (``filter_backend="auto"``) trained on the
    card at B=GRAD_B, K=GRAD_K through ``chunk_fn``: each instance's
    voices' gains and pans and the filter's frequency and Q are leaves
    ``[B]``; the loss is each instance's channel energies against a target
    rendered from other params; GRAD_STEPS of SGD, the loss falling at each.
    The first step's gradients of CHECK_INSTANCES instances against the CPU's;
    K8 once a block a backward, K1–K7 and K9 none in it."""
    prog = ft.mixer_graph(19, "auto", device="cuda")
    br = ft.BatchRenderer(prog, GRAD_B, device="cuda")
    params, state = br.stack_params(), br.init_state()
    leaves = mixer_grad_leaves(prog, GRAD_B, 17, "cuda")
    with torch.no_grad():
        target = chunk_energy(prog, with_leaves(params, mixer_grad_leaves(prog, GRAD_B, 71,
                                                                           "cuda")),
                              state, GRAD_B, GRAD_K)
    losses, walls, fwd, bwd = [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    first = None
    for step in range(GRAD_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c0 = counts()
        req = {n: t.detach().requires_grad_() for n, t in leaves.items()}
        energy = chunk_energy(prog, with_leaves(params, req), state, GRAD_B, GRAD_K)
        loss = ((energy - target) ** 2).sum()
        c1 = counts()
        if step == GRAD_STEPS:  # the loss after the last step
            losses.append(float(loss.detach()))
            break
        grads = dict(zip(req, torch.autograd.grad(loss, list(req.values()))))
        c2 = counts()
        with torch.no_grad():
            leaves = {n: t - GRAD_LR[n[1]] * grads[n] for n, t in leaves.items()}
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss.detach()))
        fwd.append(_delta(c1, c0))
        bwd.append(_delta(c2, c1))
        if first is None:
            first = ({n: t.detach().clone() for n, t in req.items()}, grads)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(b < a for a, b in zip(losses, losses[1:])) or not np.isfinite(losses).all():
        raise AssertionError(f"17(c): the loss did not fall at every step: {losses}")
    for f, b in zip(fwd, bwd):
        if f["K7"] != GRAD_K or b["K8"] != GRAD_K or any(
                v for k, v in b.items() if k != "K8") or any(
                v for k, v in f.items() if k != "K7"):
            raise AssertionError(f"17(c): launches in a forward {f}, in a backward {b}")

    # the first step's gradients of the first instances, on the CPU
    from firewheel_tpu_torch.convert import tree_map

    start, grads = first
    rows = slice(0, CHECK_INSTANCES)
    cpu_prog = ft.mixer_graph(19, "auto", device="cpu")
    _, cpu_grads = mixer_grads(
        cpu_prog, tree_map(lambda t: t[rows].cpu(), params),
        tree_map(lambda t: t[rows].cpu(), state),
        {n: t[rows].cpu() for n, t in start.items()}, target[rows].cpu(), GRAD_K)
    errs = {}
    for kind in GRAD_LR:
        names = [n for n in grads if n[1] == kind]
        card_g = torch.stack([grads[n][rows].cpu() for n in names])
        cpu_g = torch.stack([cpu_grads[n] for n in names])
        errs[kind] = _rel_err(card_g, cpu_g)
        if not (errs[kind] <= GRAD_TOL and bool(cpu_g.abs().max() > 0)):
            raise AssertionError(f"17(c): {kind} gradients, card vs CPU {errs[kind]}")
    worst = max(errs.values())
    kernels, dev_ms, _ = profile_step(lambda: mixer_grads(prog, params, state, leaves, target,
                                                          GRAD_K))
    wall = float(np.median(walls[1:]))
    busy = (f"{kernels} kernels, {dev_ms:.3f} ms of device time, "
            f"{100 * (1 - dev_ms / wall):.1f}% of the median step's wall idle"
            if kernels else "not measured (the profile saw no device activity)")
    log(f"phase 17(c), the 64-node mixer (filter 'auto') trained on the card ({card}): "
        f"B={GRAD_B}, K={GRAD_K}, {4 * 19 // 2 + 2} leaves [B] (19 gains, 19 pans, the "
        f"lowpass's frequency and Q); loss {[f'{v:.6e}' for v in losses]} over "
        f"{GRAD_STEPS} SGD steps, falling at each; wall a step (forward and backward) "
        f"{[round(w, 3) for w in walls]} ms, median of steps 2-{GRAD_STEPS} {wall:.3f} ms; "
        f"peak device memory {peak_gb:.3f} GB; launches a forward {fwd[0]}, a backward "
        f"{bwd[0]}; a profiled step: {busy}; the first step's gradients of instances "
        f"0-{CHECK_INSTANCES - 1} vs the CPU's, by leaf kind, of its largest magnitude "
        f"{ {k: f'{v:.3e}' for k, v in errs.items()} }")
    return {"launches": sum(b["K8"] for b in bwd), "wall_ms": wall, "peak_gb": peak_gb,
            "kernels": kernels, "device_ms": dev_ms, "err": worst}


def autotune(ft, card: str) -> dict:
    """17(d): ``examples/autotune_mix.py`` on the card through the port's
    ``examples.autotune_mix``: three voices' gains fitted to each voice's
    RMS (rendered alone) over ``BLOCKS`` blocks of ``F`` frames, the last
    block measured; ``STEPS`` of gradient descent at ``RATE``, clipped to
    [0, 4].  The three probes (each voice alone) are three instances of one
    batch (``voice_probe``).  Must reach loss < 1e-6."""
    from firewheel_tpu_torch.examples import autotune_mix as at

    prog, keys = at.build_mix("cuda")
    probe = at.voice_probe(prog, keys, "cuda")
    gains = torch.full((3,), 0.5, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(at.STEPS):
        g = gains.detach().requires_grad_()
        (grad,) = torch.autograd.grad(probe(g)[0], g)
        gains = (gains - at.RATE * grad).clamp(0.0, 4.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with torch.no_grad():
        loss, rms = probe(gains)
    if not float(loss) < 1e-6:
        raise AssertionError(f"17(d): autotune did not converge: loss {float(loss)}, "
                             f"gains {gains.tolist()}")
    log(f"phase 17(d), examples/autotune_mix.py's configuration on the card ({card}): "
        f"{at.STEPS} steps at rate {at.RATE}, {at.BLOCKS} blocks of {at.F} "
        f"frames, the three probes as instances of one batch: loss {float(loss):.3e} "
        f"(< 1e-6), gains {[round(v, 4) for v in gains.tolist()]}, per-voice RMS "
        f"{[round(v, 4) for v in rms.tolist()]} (target {list(at.TARGET)}); "
        f"{wall:.2f} s, {wall / at.STEPS * 1e3:.1f} ms a step")
    return {"wall_s": wall, "loss": float(loss)}


def bus_grads(ft, device, b: int, rows=None, params=None):
    """The mastering bus's gradients of each instance's mean square over
    BUS_GRAD[1] blocks with respect to the compressor's threshold and makeup
    and the limiter's ceiling → ``(grads {(kind, name): f32[b]}, params)``;
    ``params`` (the card's, varied per instance) cut to ``rows`` for the
    CPU."""
    from firewheel_tpu_torch import mixer
    from firewheel_tpu_torch.convert import tree_map

    prog = ft.mastering_bus_graph(device=device)
    br = ft.BatchRenderer(prog, b, device=device)
    if params is None:
        params = mixer.vary_mastering_params(prog, br.stack_params(), 17)
        # ceilings the bus reaches (−1 dB is above its peaks): the limiter
        # acts, and its release scan is differentiated
        lim = next(k for k, p in prog._procs.items() if type(p).__name__ == "LimiterProcessor")
        params[lim]["ceiling"] = torch.from_numpy(np.random.default_rng(17).uniform(
            0.15, 0.35, b).astype(np.float32)).to(device)
    else:
        params = tree_map(lambda t: t[rows].to(device), params)
    keys = {type(p).__name__.replace("Processor", "").lower(): k
            for k, p in prog._procs.items()}
    leaves = {(kind, name): params[keys[kind]][name].detach().clone().requires_grad_()
              for kind, name in BUS_LEAVES}
    p = with_leaves(params, {(keys[kind], name): t for (kind, name), t in leaves.items()})
    k = BUS_GRAD[1]
    out, _, _ = prog.chunk_fn(k)(
        p, br.init_state(), torch.zeros((b, k, 0, prog.max_block_frames), device=device),
        torch.zeros((b, k, 0), dtype=torch.bool, device=device), 0, 0)
    loss = (out ** 2).mean(dim=(1, 2, 3)).sum()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return dict(zip(leaves, grads)), params


def bus_dynamics(ft, counts, card: str) -> dict:
    """17(e): the mastering bus's dynamics differentiated on the card
    (B, K = BUS_GRAD): the compressor's threshold and makeup and the
    limiter's ceiling per instance, against the CPU for CHECK_INSTANCES; K9
    launches in the backward (the limiter's release, once a block)."""
    c0 = counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grads, params = bus_grads(ft, "cuda", BUS_GRAD[0])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = _delta(counts(), c0)
    cpu, _ = bus_grads(ft, "cpu", CHECK_INSTANCES, slice(0, CHECK_INSTANCES), params)
    worst = 0.0
    for n in grads:
        e = _rel_err(grads[n][:CHECK_INSTANCES].cpu(), cpu[n])
        if not (e <= GRAD_TOL and bool(cpu[n].abs().max() > 0)):
            raise AssertionError(f"17(e): {n} gradients, card vs CPU {e}")
        worst = max(worst, e)
    if launched["K9"] < BUS_GRAD[1] or launched["K1"] or launched["K2"] or launched["K3"]:
        raise AssertionError(f"17(e): launches {launched}")
    log(f"phase 17(e), the mastering bus's dynamics differentiated on the card ({card}): "
        f"B={BUS_GRAD[0]}, K={BUS_GRAD[1]}, gradients of {[n for n in grads]} per instance "
        f"vs the CPU's for instances 0-{CHECK_INSTANCES - 1}: {worst:.3e} of each leaf's "
        f"largest; forward and backward {wall:.3f} s; launches {launched}")
    return {"launches": launched["K9"], "err": worst}


def plain_kernels(fn):
    """``fn()`` with the EQ's cascade and the dynamics nodes' scans run as
    the kernels' autograd nodes (``iir._CascadeFn``, ``dynamics._ScanFn``)
    with the kernels' plain versions in their place, forward (K7's, K5's)
    and backward (K8's, K9's), on the tensors' own device: the kernels'
    arithmetic in their order, on the card without them, and on the CPU
    beside autograd's own order."""
    from firewheel_tpu_torch.nodes import dynamics as node_dynamics, eq
    from firewheel_tpu_torch.ops import dynamics, iir

    def cascade_launch(x, states, sections):
        y, zs = iir.biquad_cascade_reference(x, states, sections)
        return y, torch.stack([z.broadcast_to(x.shape[:-1]) for pair in zs for z in pair])

    def scan_launch(kind, x, leaves, coefs, stacked):
        out, y = dynamics.scan_reference(kind, x, tuple(leaves), coefs)
        return y, torch.stack([o.broadcast_to(x.shape[:-1]) for o in out],
                              dim=-1 if stacked else 0)

    def cascade(x, states, sections):
        flat = [v for c, z in zip(sections, states) for v in (*c, *z)]
        y, z_out = iir._CascadeFn.apply(x, *flat)
        zs = z_out.unbind(0)
        return y, tuple(zip(zs[0::2], zs[1::2]))

    def scan(kind, x, carry, coefs):
        leaves, stacked = dynamics._check(kind, x, carry, coefs)
        y, out = dynamics._ScanFn.apply(kind, stacked, x, *leaves, *coefs)
        return (out if stacked else out.unbind(0)), y

    swaps = ((iir, "_cascade_launch", cascade_launch),
             (iir, "biquad_cascade_backward", iir.biquad_cascade_backward_reference),
             (dynamics, "_scan_launch", scan_launch),
             (dynamics, "scan_lanes_backward", dynamics.scan_lanes_backward_reference),
             (eq, "biquad_cascade", cascade), (node_dynamics, "scan_lanes", scan))
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    for m, n, v in swaps:
        setattr(m, n, v)
    try:
        return fn()
    finally:
        for m, n, v in saved:
            setattr(m, n, v)


def _proc_key(prog, name: str) -> str:
    (key,) = [k for k, p in prog._procs.items() if type(p).__name__ == name]
    return key


def eq_gate_loss(prog, params, state, leaves: dict, k: int):
    """Σ over instances of the mean square of a chunk of ``k`` blocks of
    ``mixer.eq_gate_graph`` with ``leaves`` in ``params``: each EQ band's
    gain in dB (``("gain", i)``, f32[b] on the host: the band's
    coefficients are designed there from it by the filter node's design,
    inside the gradient, and copied to the program's device) and the gate's
    floor (``("floor",)``)."""
    from firewheel_tpu_torch import mixer
    from firewheel_tpu_torch.nodes.filter import _DESIGNS

    dev = prog.device
    eq, gate = _proc_key(prog, "ParametricEQProcessor"), _proc_key(prog, "GateProcessor")
    bands = dict(params[eq]["bands"])
    designed = [_DESIGNS[band.band_type](band.frequency_hz, band.q, leaves[("gain", i)],
                                         mixer.SR)
                for i, band in enumerate(prog._procs[eq]._node._bands)]
    # every coefficient crosses to the device in one copy, so that their
    # gradients come back in one piece and the host sums a band's five in
    # one order: with a copy each, the host's autograd thread began on some
    # while the device's still returned others, and the sums' last bits
    # varied from run to run (PERF.md §6)
    moved = torch.stack([v for c in designed for v in c]).to(dev).unbind(0)
    for i, c in enumerate(designed):
        bands[str(i)] = dict(zip(c._fields, moved[5 * i:5 * i + 5]))
    p = {**params, eq: {"bands": bands},
         gate: {**params[gate], "floor": leaves[("floor",)].to(dev)}}
    b = leaves[("floor",)].shape[0]
    out, _, _ = prog.chunk_fn(k)(
        p, state, torch.zeros((b, k, 0, prog.max_block_frames), device=dev),
        torch.zeros((b, k, 0), dtype=torch.bool, device=dev), 0, 0)
    return (out ** 2).mean(dim=(1, 2, 3)).sum()


def eq_gate_step(prog, params, state, leaves: dict, k: int, counts=None):
    """The loss (:func:`eq_gate_loss`) and its gradients with respect to
    ``leaves`` → ``(loss, grads, launches in the forward, in the
    backward)`` (the launches empty without ``counts``)."""
    req = {n: t.detach().clone().requires_grad_() for n, t in leaves.items()}
    c0 = counts() if counts else {}
    loss = eq_gate_loss(prog, params, state, req, k)
    c1 = counts() if counts else {}
    grads = dict(zip(req, torch.autograd.grad(loss, list(req.values()))))
    c2 = counts() if counts else {}
    return loss.detach(), grads, _delta(c1, c0), _delta(c2, c1)


def eq_gate_grad(ft, counts, card: str) -> dict:
    """17(h): one SGD step of the FX palette's voices → its three-band EQ →
    a gate that opens and closes within the chunk in every instance
    (``mixer.eq_gate_graph``) on the card at B, K = EQ_GATE_GRAD, each
    instance's voices and EQ gains from ``vary_fx_params``: the gradients of
    Σ over instances of the mean square with respect to each band's gain
    and the gate's floor, per instance.  K7 and K5 once a block forward, K8
    (the EQ's three sections) and K9 (the gate) once a block backward and
    nothing else; the gradients equal to the same step's with the kernels'
    plain versions in their place (:func:`plain_kernels`) on the card
    (within BWD_TOL, bit for bit expected); the first instances' within
    GRAD_TOL of the CPU's by the same arithmetic, by kind of leaf as 17(c)
    holds them (the three gains together), and the CPU's autograd through
    the plain scans beside them, logged; the floor's gradient non-zero in
    every instance; the loss lower after the step.  Reports the step's wall, a profiled step's kernels,
    idle share and K8's and K9's device ms, and peak memory."""
    from firewheel_tpu_torch import mixer
    from firewheel_tpu_torch.convert import tree_map

    b, k = EQ_GATE_GRAD
    prog = mixer.eq_gate_graph(device="cuda")
    br = ft.BatchRenderer(prog, b, device="cuda")
    gains = {}
    params = mixer.vary_fx_params(prog, br.stack_params(), 19, gains)
    state = br.init_state()
    eq = _proc_key(prog, "ParametricEQProcessor")
    leaves = {("gain", i): torch.from_numpy(gains[(eq, i)]) for i in range(len(
        prog._procs[eq]._node._bands))}
    leaves[("floor",)] = torch.from_numpy(
        np.random.default_rng(19).uniform(0.05, 0.3, b).astype(np.float32))

    walls = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(EQ_GATE_STEPS):
        t0 = time.perf_counter()
        loss, grads, fwd, bwd = eq_gate_step(prog, params, state, leaves, k, counts)
        with torch.no_grad():
            stepped = {n: t - EQ_GATE_LR[n[0]] * grads[n] for n, t in leaves.items()}
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        want_f = {"K5": k, "K7": k}
        want_b = {"K8": k, "K9": k}
        if any(v != want_f.get(n, 0) for n, v in fwd.items()) or any(
                v != want_b.get(n, 0) for n, v in bwd.items()):
            raise AssertionError(f"17(h): launches in a forward {fwd}, in a backward {bwd}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with torch.no_grad():
        after = float(eq_gate_loss(prog, params, state, stepped, k))
    if not (np.isfinite(after) and after < float(loss)):
        raise AssertionError(f"17(h): the loss did not fall: {float(loss)} -> {after}")
    floor_g = grads[("floor",)]
    if not bool((floor_g != 0).all()):
        raise AssertionError(f"17(h): the floor's gradient is 0 in "
                             f"{int((floor_g == 0).sum())} instances: the gate never closed")

    # the same step with the kernels' plain versions in their place, on the
    # card: the kernels' bits
    _, plain, _, _ = plain_kernels(lambda: eq_gate_step(prog, params, state, leaves, k))
    plain_err = max(float((grads[n] - plain[n]).abs().max()) for n in grads)
    if max(_rel_err(grads[n], plain[n]) for n in grads) > BWD_TOL:
        raise AssertionError(f"17(h): the kernels vs their plain versions on the card "
                             f"{plain_err}")
    # the first instances on the CPU, by the same arithmetic (the plain
    # versions, the backwards' frame by frame), and by autograd through the
    # plain scans, the order 17(c) holds the card to: the EQ's 150 Hz low
    # shelf parts the two float32 orders of the gains' derivative by more
    # than GRAD_TOL (logged)
    rows = slice(0, CHECK_INSTANCES)
    cpu_step = functools.partial(
        eq_gate_step, mixer.eq_gate_graph(device="cpu"),
        tree_map(lambda t: t[rows].cpu(), params), tree_map(lambda t: t[rows].cpu(), state),
        {n: t[rows] for n, t in leaves.items()}, k)
    _, cpu_grads, _, _ = plain_kernels(cpu_step)
    _, auto_grads, _, _ = cpu_step()

    def by_kind(got, want, check):
        errs = {}
        for kind in EQ_GATE_LR:
            names = [n for n in got if n[0] == kind]
            g = torch.stack([got[n][rows].cpu() for n in names])
            w = torch.stack([want[n] for n in names])
            errs[kind] = _rel_err(g, w)
            if check and not (errs[kind] <= GRAD_TOL and bool((w != 0).all())):
                raise AssertionError(f"17(h): {kind} gradients, card vs CPU {errs[kind]}")
        return errs

    errs = by_kind(grads, cpu_grads, True)
    orders = by_kind(cpu_grads, auto_grads, False)

    kernels, dev_ms, by = profile_step(
        lambda: eq_gate_step(prog, params, state, leaves, k),
        (K8_KERNEL["cascade"], K9_KERNEL))
    wall = float(np.median(walls[1:]))
    busy = (f"{kernels} kernels, {dev_ms:.3f} ms of device time, "
            f"{100 * (1 - dev_ms / wall):.1f}% of the median step's wall idle; K8 "
            f"{by[K8_KERNEL['cascade']]:.4f} ms and K9 {by[K9_KERNEL]:.4f} ms of it "
            f"({k} launches each)"
            if kernels else "not measured (the profile saw no device activity)")
    log(f"phase 17(h), the EQ -> gate gradient on the card ({card}): B={b}, K={k}, "
        f"{len(leaves)} leaves [B] (the EQ's three gains, the gate's floor); loss "
        f"{float(loss):.6e}, {after:.6e} after one SGD step; wall a step (forward, backward "
        f"and update) {[round(w, 3) for w in walls]} ms, median of steps 2-"
        f"{EQ_GATE_STEPS} {wall:.3f} ms; peak device memory {peak_gb:.3f} GB; launches a "
        f"forward {fwd}, a backward {bwd}; a profiled step: {busy}; vs the kernels' plain "
        f"versions on the card max_abs_err={plain_err:.3e}; gradients of instances "
        f"0-{CHECK_INSTANCES - 1} vs the CPU's by the same arithmetic, of the largest "
        f"magnitude of each kind of leaf { {k: f'{e:.3e}' for k, e in errs.items()} }; on "
        f"the CPU, autograd through the plain scans vs that arithmetic "
        f"{ {k: f'{e:.3e}' for k, e in orders.items()} }")
    return {"launches": {"K8": bwd["K8"], "K9": bwd["K9"]}, "wall_ms": wall,
            "peak_gb": peak_gb, "kernels": kernels, "device_ms": dev_ms,
            "k8_ms": by.get(K8_KERNEL["cascade"]), "k9_ms": by.get(K9_KERNEL),
            "err": max(errs.values()), "plain_err": plain_err}


def check_refusals(ft, seq_iir, em, eh, card: str) -> None:
    """17(f): K1, K2 and K3 refuse a gradient (``NotImplementedError``, as
    ``jax.grad`` through the JAX package's ``pallas_call`` raises) where an
    operand requires one under grad mode, and under ``torch.no_grad`` run as
    before, bit for bit and counted."""
    from firewheel_tpu_torch.ops.iir import BiquadCoeffs

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(1719)
    x = torch.randn((64, 128), generator=gen).to(dev)
    c = BiquadCoeffs(*(torch.full((64,), v, device=dev) for v in (0.2, 0.3, 0.1, -0.5, 0.2)))
    z = (torch.zeros(64, device=dev), torch.zeros(64, device=dev))

    def refused(fn):
        try:
            fn()
        except NotImplementedError:
            return True
        return False

    def leaf(params, name):
        params = {k: dict(v) for k, v in params.items()}
        key = next(k for k, v in params.items() if name in v)
        params[key][name] = params[key][name].clone().requires_grad_()
        return params

    want = seq_iir.biquad_seq(x, z, c)[0]
    n = seq_iir.biquad_seq.launches
    ok = {"K1": refused(lambda: seq_iir.biquad_seq(x.clone().requires_grad_(), z, c))}
    with torch.no_grad():
        ok["K1 no_grad"] = torch.equal(seq_iir.biquad_seq(x.clone().requires_grad_(), z, c)[0],
                                       want) and seq_iir.biquad_seq.launches == n + 1
    mega = em.MegaRenderer(ft.mixer_graph(filter_backend="pallas", device="cuda"), 64, 2,
                           device="cuda")
    p, s = mega.stack_params(), mega.init_state()
    want = mega.render_chunk(p, s)[0]
    n = em.MegaRenderer.launches
    ok["K2"] = refused(lambda: mega.render_chunk(leaf(p, "q"), s))
    with torch.no_grad():
        ok["K2 no_grad"] = torch.equal(mega.render_chunk(leaf(p, "q"), s)[0], want) \
            and em.MegaRenderer.launches == n + 1
    hybrid = eh.HybridMegaRenderer(ft.effects_chain_graph(device="cuda"), 64, 2,
                                   device="cuda")
    p, s = hybrid.stack_params(), hybrid.init_state()
    want = hybrid.render_chunk(p, s)[0]
    n = eh.HybridMegaRenderer.launches
    ok["K3"] = refused(lambda: hybrid.render_chunk(leaf(p, "freq"), s))
    with torch.no_grad():
        ok["K3 no_grad"] = torch.equal(hybrid.render_chunk(leaf(p, "freq"), s)[0], want) \
            and eh.HybridMegaRenderer.launches > n
    torch.cuda.synchronize()
    if not all(ok.values()):
        raise AssertionError(f"17(f): {ok}")
    log(f"phase 17(f), the kernels with no backward ({card}): K1 (biquad_seq), K2 "
        f"(MegaRenderer) and K3 (HybridMegaRenderer) raise NotImplementedError where an "
        f"operand requires a gradient under grad mode, and under torch.no_grad render bit "
        f"for bit as without the gradient, each launched")


def check_other_device(iir, dynamics) -> None:
    """17(g): K5, K7, K8 and K9 on tensors of cuda:0 while another device is
    current.  Each wrapper makes its tensor's device current for the launch
    (CUDA refuses a launch onto another device's stream): the results equal
    the same calls made with cuda:0 current, bit for bit.  Needs two
    devices; with one, the log says it was not run."""
    if torch.cuda.device_count() < 2:
        log("17(g): one device: K5, K7, K8 and K9 with another device current not run")
        return
    gen = torch.Generator(device="cpu").manual_seed(1719)
    with torch.cuda.device(0):
        _, _, (x, y0, a, b) = k7_operands(iir, "one_pole", 64, 128, gen)
        _, _, (xb, zb, cb) = k7_operands(iir, "biquad", 64, 128, gen)
        code, xs, carry, coefs = scan_operands(dynamics, "limiter", 64, gen)
        g = torch.randn((64, 128), generator=gen).to(x.device)
        g_last = torch.randn((64,), generator=gen).to(x.device)
    out = lambda: iir.one_pole_scan(x, y0, a, b)[0]  # noqa: E731
    calls = {
        "K7 one_pole_scan": lambda: iir.one_pole_scan(x, y0, a, b),
        "K7 biquad_scan": lambda: iir.biquad_scan(xb, zb, cb),
        "K5 scan_lanes": lambda: dynamics.scan_lanes(code, xs, carry, coefs),
        "K8 one_pole_scan_backward": lambda: iir.one_pole_scan_backward(
            x, out(), y0, a, b, g, g_last),
        "K9 scan_lanes_backward": lambda: dynamics.scan_lanes_backward(
            code, xs, carry, coefs, dynamics.scan_lanes(code, xs, carry, coefs)[1], g,
            (g_last,)),
    }
    other = torch.cuda.device_count() - 1
    for name, fn in calls.items():
        with torch.cuda.device(0):
            want = _flat(fn())
            torch.cuda.synchronize()
        with torch.cuda.device(other):
            got = _flat(fn())
            torch.cuda.synchronize(x.device)
        if not (len(got) == len(want) and all(u.device == x.device and torch.equal(u, v)
                                              for u, v in zip(got, want))):
            raise AssertionError(f"17(g): {name} with cuda:{other} current differs")
    log(f"17(g): {', '.join(calls)} on cuda:0 with cuda:{other} current: bit for bit "
        "the launches with cuda:0 current")


def check_gradients(ft, seq_iir, em, eh, adpcm_device, dynamics, iir, noise, card: str,
                    phase, res: dict) -> dict:
    """Phase 17 (c)-(h): differentiable rendering on the card → ``res``
    (17(a)'s and 17(b)'s numbers) with 17(c)'s, 17(e)'s and 17(h)'s, for
    the kernels line."""
    counts = lambda: kernel_counts(seq_iir, em, eh, adpcm_device, dynamics,  # noqa: E731
                                   iir, noise)
    res = dict(res)
    res["train"] = train_mixer(ft, counts, iir, card)
    phase("17(c), the mixer trained")
    res["tune"] = autotune(ft, card)
    phase("17(d), autotune_mix")
    res["bus"] = bus_dynamics(ft, counts, card)
    phase("17(e), the bus's dynamics")
    check_refusals(ft, seq_iir, em, eh, card)
    phase("17(f), K1-K3 refuse a gradient")
    check_other_device(iir, dynamics)
    phase("17(g), launches with another device current")
    res["eq_gate"] = eq_gate_grad(ft, counts, card)
    phase("17(h), the EQ -> gate gradient")
    return res


# phase 18: the differential fuzzers on the card
FUZZ_SEEDS = tuple(range(25))  # the CPU tests' 0-11, the next 12, and 24 (a 6th K2 seed)
FUZZ_POOLING_SEED = 1234       # the pooling-heavy graph's draws (the JAX test's rng seed)
FUZZ_B, FUZZ_K, FUZZ_CHUNKS = 8192, 32, 2
FUZZ_VARIED = 8                # rows 0..7 take their own params
FUZZ_ROWS = (0, 3, 7, FUZZ_B - 1)  # rows held against the CPU's naive renderer
FUZZ_PATTERNS = 8              # stream-input patterns: row b takes pattern b % 8
FUZZ_K2_MIN = 6                # K2-eligible graphs 18(a) must hold
# the card against the CPU's interpreter: 18(a)'s rows and 18(b) at the JAX
# fuzzers' 1e-5, 18(c) at the chunked fuzzer's 2e-5; a graph that holds the
# EQ at PALETTE_SLICE_TOL, as in phase 13 (its 120 Hz shelf amplifies an ulp
# of the card's sin, cos or exp ~250 times)
FUZZ_TOL = 1e-5
CHUNKED_TOL = 2e-5
EDIT_SEEDS = range(4)
CHUNKED_SEEDS = range(1000, 1004)
CLOCK_CAPACITY = 8192
#: kernel names in a torch.profiler trace, by kernel
FUZZ_PROFILED = {"K1": ("biquad_seq_kernel",), "K2": ("mega_kernel",),
                 "K3": ("island_kernel",), "K5": ("sample_scan_kernel",),
                 "K6": ("noise_uniform_kernel",),
                 "K7": ("biquad_scan_kernel", "one_pole_scan_kernel")}


def fuzz_graphs():
    """18(a)'s graphs: the seeds, then the pooling-heavy graph."""
    return FUZZ_SEEDS + ("pooling",)


def fuzz_build(seed):
    """``(graph, created, edges, draw_seed)`` of an 18(a) graph."""
    from firewheel_tpu_torch import mixer

    if seed == "pooling":
        return (*mixer.fuzz_pooling_graph(), FUZZ_POOLING_SEED)
    return (*mixer.fuzz_graph(np.random.default_rng(seed)), seed)


def fuzz_inputs(draw_seed: int, ni: int):
    """The stream-input patterns ``(f32[P, chunks, K, ni, F], bool[P,
    chunks, K, ni])``, silent channels zero."""
    rng = np.random.default_rng((draw_seed, 18))
    shape = (FUZZ_PATTERNS, FUZZ_CHUNKS, FUZZ_K, ni)
    gi = (rng.standard_normal(shape + (128,)) * 0.3).astype(np.float32)
    im = rng.random(shape) < 0.25
    gi[im] = 0.0
    return gi, im


def fuzz_oracle(seed) -> dict:
    """The CPU's naive renderer (``testing.NaiveGraphRenderer``) on an 18(a)
    graph for each of ``FUZZ_ROWS``: ``{row: (out f32[chunks·K, 2, F],
    masks bool[chunks·K, 2])}``."""
    _port()
    from firewheel_tpu_torch import mixer, testing

    result = {}
    for row in FUZZ_ROWS:
        g, created, _, draw = fuzz_build(seed)  # a fresh graph: the pokes stay
        ref = testing.NaiveGraphRenderer(g, 48000, 128, device="cpu")
        if row < FUZZ_VARIED:
            mixer.fuzz_instance_params(ref, g, created, draw, row)
        gi, im = fuzz_inputs(draw, ref.num_graph_inputs)
        outs, masks = [], []
        for c in range(FUZZ_CHUNKS):
            for k in range(FUZZ_K):
                p = row % FUZZ_PATTERNS
                out, mask = ref.render_block(torch.from_numpy(gi[p, c, k]),
                                             torch.from_numpy(im[p, c, k]))
                outs.append(out.numpy())
                masks.append(mask)
        result[row] = (np.stack(outs), np.stack(masks))
    return result


def _cpu_fuzz_worker(conn) -> None:
    """18(a)'s CPU oracle and then 19(a)'s and 19(c)'s CPU references in a
    worker process, on one thread: sends ``("ok", "fuzz", {graph:
    fuzz_oracle(graph)})``, ``("ok", "vm64", vm64_stream("cpu"))`` and
    ``("ok", "examples", example_results("cpu", ...))``, or ``("error",
    traceback)``."""
    import tempfile
    import traceback

    try:
        torch.set_num_threads(1)
        os.nice(19)  # the host-bound phases it runs beside come first
        conn.send(("ok", "fuzz", {seed: fuzz_oracle(seed) for seed in fuzz_graphs()}))
        conn.send(("ok", "vm64", vm64_stream("cpu")))
        conn.send(("ok", "examples",
                   example_results("cpu", tempfile.mkdtemp(prefix="fw_examples_"))))
    except Exception:  # the worker's boundary: the parent raises it
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


def fuzz_entry_launches(proc) -> dict:
    """K1 and K5-K7 launches one eager call of ``proc``'s kernel makes (a
    single node or a pooled group)."""
    from firewheel_tpu_torch.nodes.eq import ParametricEQProcessor
    from firewheel_tpu_torch.nodes.filter import FilterProcessor
    from firewheel_tpu_torch.nodes.generators import NoiseProcessor
    from firewheel_tpu_torch.nodes.waveshaper import WaveshaperProcessor

    if isinstance(proc, NoiseProcessor):
        return {"K6": 1, "K5": int(proc._node._color == "pink")}
    if isinstance(proc, ParametricEQProcessor):
        return {"K7": 1}
    if isinstance(proc, FilterProcessor):
        return {"K1": 1} if proc._backend == "pallas" else {"K7": 1}
    if isinstance(proc, WaveshaperProcessor) and proc._node._dc_block:
        return {"K7": 1}
    return {}


def fuzz_expected(prog, hybrid, k: int) -> dict:
    """``{lowering: {kernel: launches a chunk}}`` that the compiled schedule
    implies: eager runs each entry of its plan (a node or a pooled group)
    once a block; the hybrid each node of its torch stages once a block and
    each island once a chunk (K3); K2 once a chunk."""
    from firewheel_tpu_torch.executor import node_key

    def add(into, proc, times):
        for name, n in fuzz_entry_launches(proc).items():
            into[name] = into.get(name, 0) + n * times

    eager: dict = {}
    for _, members in prog._plan:
        add(eager, prog._procs[node_key(members[0].id)], k)
    hyb = {"K3": len(hybrid.islands)}
    for kind, nodes in hybrid.segments:
        if kind != "mega":
            for sn in nodes:
                add(hyb, prog._procs[node_key(sn.id)], k)
    return {"eager": eager, "hybrid": hyb, "mega": {"K2": 1}}


def profiled_counts(fn) -> dict | None:
    """Launches of each kernel of ``FUZZ_PROFILED`` that ``torch.profiler``
    records while ``fn()`` runs, or None when it saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    if not any(e.device_type == torch.autograd.DeviceType.CUDA for e in events):
        return None
    return {name: sum(e.count for e in events if any(s in e.key for s in subs))
            for name, subs in FUZZ_PROFILED.items()}


def fuzz_lowerings(ft, em, eh, counts, oracle, card: str) -> dict:
    """18(a): each graph at B x K on the card through eager, K2 (where
    eligible) and the hybrid from the same params and state; K2 and K3
    against eager, rows against the CPU oracle; launches against the
    schedule, by the wrappers' counts and by ``torch.profiler``."""
    from firewheel_tpu_torch import mixer
    from firewheel_tpu_torch.nodes.eq import ParametricEQProcessor

    b, k, f = FUZZ_B, FUZZ_K, 128
    taken = {"eager": [], "mega": [], "hybrid": []}
    launches = {"eager": {}, "mega": {}, "hybrid": {}}
    walls = {"eager": [], "mega": [], "hybrid": []}
    worst = {"mega": 0.0, "hybrid": 0.0, "oracle": 0.0}
    k2_bound = {}
    # seconds of the phase by part: set-up, the profiled chunk, the timed
    # chunk, the checks
    split = {"set-up": 0.0, "profiled chunk": 0.0, "timed chunk": 0.0, "checks": 0.0}
    unprofiled, missed = [], {}
    for seed in fuzz_graphs():
        t_part = time.perf_counter()

        def part(name):
            nonlocal t_part
            torch.cuda.synchronize()
            now = time.perf_counter()
            split[name] += now - t_part
            t_part = now

        g, created, _, draw = fuzz_build(seed)
        pkg = g.compile(48000, f)
        prog = ft.ScheduleProgram(pkg.schedule, dict(pkg.new_node_processors), 48000,
                                  device="cuda")
        renderers = {"eager": ft.BatchRenderer(prog, b, device="cuda"),
                     "hybrid": ft.BatchRenderer(prog, b, device="cuda", lowering="hybrid")}
        if em.supports_megakernel(prog):
            renderers["mega"] = em.MegaRenderer(prog, b, k, device="cuda")
        eager = renderers["eager"]
        params, state0 = eager.stack_params(), eager.init_state()
        for row in range(FUZZ_VARIED):
            eager.update_instance(params, row, mixer.fuzz_instance_params(
                prog, g, created, draw, row))
        eq = any(isinstance(p, ParametricEQProcessor) for p in prog._procs.values())
        row_tol = PALETTE_SLICE_TOL if eq else FUZZ_TOL
        ni = prog.num_graph_inputs
        gi_all, im_all = (torch.from_numpy(a).cuda() for a in fuzz_inputs(draw, ni))
        pattern = torch.arange(b, device="cuda") % FUZZ_PATTERNS
        states = {name: state0 for name in renderers}
        expected = None
        for c in range(FUZZ_CHUNKS):
            gi, im = gi_all[pattern, c], im_all[pattern, c]
            start = c * k * f

            def render_all(sts, record):
                outs = {}
                for name, r in renderers.items():
                    base = counts()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    if name == "mega":
                        out = r.render_chunk(params, sts[name], start)
                    else:
                        out = r.render_chunk(params, sts[name], gi, im, start_sample=start,
                                             num_blocks=k)
                    torch.cuda.synchronize()
                    if record:
                        walls[name].append(time.perf_counter() - t0)
                    outs[name] = (out, _delta(counts(), base))
                return outs

            part("set-up" if c == 0 else "checks")
            if c == 0:
                # the launch count pass: the wrappers' counts and the profile's
                outs = {}
                seen = profiled_counts(lambda: outs.update(render_all(states, False)))
                part("profiled chunk")
            else:
                outs = render_all(states, True)
                part("timed chunk")
            hy = renderers["hybrid"]._chunk_cache[("hybrid", k)]
            expected = fuzz_expected(prog, hy, k)
            total = {}
            for name, (_, delta) in outs.items():
                want = {kn: expected[name].get(kn, 0)
                        for kn in ("K1", "K2", "K3", "K5", "K6", "K7")}
                got = {kn: delta[kn] for kn in want}
                if got != want:
                    raise AssertionError(f"fuzz graph {seed}, {name}, chunk {c}: "
                                         f"launches {got}, the schedule implies {want}")
                for kn, n in delta.items():
                    launches[name][kn] = launches[name].get(kn, 0) + n
                    total[kn] = total.get(kn, 0) + n
            if c == 0:
                profiled = {kn: total.get(kn, 0) for kn in FUZZ_PROFILED}
                if seen is not None and seen != profiled:
                    # a profile may miss launches (PERF.md §7): take it once
                    # more, over the same chunk from the same state
                    seen = profiled_counts(lambda: render_all(states, False))
                if seen is None:
                    unprofiled.append(seed)
                elif seen != profiled:
                    if any(seen[kn] > profiled[kn] for kn in seen):
                        raise AssertionError(
                            f"fuzz graph {seed}: torch.profiler saw {seen}, more than "
                            f"the wrappers counted, {profiled}")
                    missed[seed] = {kn: profiled[kn] - seen[kn] for kn in seen
                                    if seen[kn] != profiled[kn]}
            eo, emk, es = outs["eager"][0]
            for name in ("mega", "hybrid"):
                if name not in outs:
                    continue
                o, m, s = outs[name][0]
                out_e, state_e = float((o - eo).abs().max()), device_tree_err(s, es)
                tol = MEGA_TOL if name == "mega" else HYBRID_TOL
                if not torch.equal(m, emk) or not max(out_e, state_e) <= tol:
                    raise AssertionError(
                        f"fuzz graph {seed}, chunk {c}: {name} vs eager outputs "
                        f"{out_e}, state {state_e}, masks equal {torch.equal(m, emk)}")
                worst[name] = max(worst[name], out_e, state_e)
                if name == "mega" and c == FUZZ_CHUNKS - 1:
                    # K2's bound: the last chunk's leaves, outputs and masks
                    k2_bound[seed] = bound(*kernel_work(
                        em, prog, renderers["mega"].lowered, params, states["mega"], b,
                        k, o.nbytes + m.nbytes))
                states[name] = s
            states["eager"] = es
            if not bool(torch.isfinite(eo).all()):
                raise AssertionError(f"fuzz graph {seed}: non-finite eager output")
            for row in FUZZ_ROWS:
                ref_out, ref_mask = oracle[seed][row]
                got = eo[row].cpu().numpy()
                want = ref_out[c * k:(c + 1) * k]
                e = float(np.abs(got - want).max())
                if not e <= row_tol or not np.array_equal(emk[row].cpu().numpy(),
                                                          ref_mask[c * k:(c + 1) * k]):
                    raise AssertionError(
                        f"fuzz graph {seed}, chunk {c}, row {row}: card vs CPU "
                        f"interpreter {e} (tolerance {row_tol}) or masks differ")
                worst["oracle"] = max(worst["oracle"], e)
        part("checks")
        for name in renderers:
            taken[name].append(seed)
        kinds = sorted({type(p).__name__.replace("Processor", "")
                        for p in prog._procs.values()} - {"Dummy"})
        log(f"fuzz graph {seed}: {len(prog._procs) - 2} nodes {kinds}, {ni} stream "
            f"inputs, lowerings {sorted(renderers)}, hybrid segments "
            f"{[kind for kind, _ in hy.segments]}, launches a chunk {expected}; "
            f"rows {FUZZ_ROWS} vs the CPU within {row_tol}")
        del renderers, outs, states, params, state0, gi_all, im_all
        torch.cuda.empty_cache()
    if len(taken["mega"]) < FUZZ_K2_MIN:
        raise AssertionError(f"only {len(taken['mega'])} K2-eligible graphs: "
                             f"{taken['mega']}")
    log(f"18(a): torch.profiler saw every launch of the first chunk on "
        f"{len(fuzz_graphs()) - len(unprofiled) - len(missed)} of {len(fuzz_graphs())} "
        f"graphs, no device activity on {unprofiled}, and missed launches on "
        f"{missed} (graph: launches by kernel) in two profiles each; the "
        f"wrappers' counts hold the schedule's on every graph")
    per_graph = {name: 1e3 * sum(w) / len(w) for name, w in walls.items() if w}
    log(f"18(a) on {card}, B={b} K={k}: graphs by lowering: eager "
        f"{len(taken['eager'])}, K2 {len(taken['mega'])} {taken['mega']}, hybrid "
        f"{len(taken['hybrid'])}; wall a chunk per graph (mean, chunk 1): "
        + ", ".join(f"{name} {ms:.2f} ms" for name, ms in per_graph.items()))
    mega_ms = {seed: 1e3 * w for seed, w in zip(taken["mega"], walls["mega"])}
    log("18(a): K2's wall a chunk (chunk 1) against its bound (kernel_work: the "
        "leaves, outputs and masks; ops by row), by graph: " + ", ".join(
            f"{seed} {mega_ms[seed]:.2f} ms vs {k2_bound[seed][0]:.4f} ms by "
            f"{k2_bound[seed][1]}" for seed in taken["mega"]))
    log(f"18(a): K2 vs eager max_abs_err={worst['mega']:.3e}, hybrid vs eager "
        f"{worst['hybrid']:.3e}, rows vs the CPU {worst['oracle']:.3e}; launches "
        f"{launches}; seconds by part "
        + ", ".join(f"{name} {sec:.1f}" for name, sec in split.items()))
    return {"launches": launches, "walls_ms": per_graph, "taken": taken,
            "worst": worst, "unprofiled": unprofiled, "missed": missed}


def fuzz_streams(counts) -> dict:
    """18(b) and 18(c): the live-edit and the chunked fuzzers' streams on
    the card against the CPU interpreter."""
    from firewheel_tpu_torch import testing

    worst = {"edits": 0.0, "chunked": 0.0}
    base = counts()
    for seed in EDIT_SEEDS:
        blocks = testing.edit_fuzz(seed, device="cuda", oracle_device="cpu")
        for tag, out, ref, kinds in blocks:
            e = float(np.abs(out - ref).max())
            tol = PALETTE_SLICE_TOL if "ParametricEQNode" in kinds else FUZZ_TOL
            if not e <= tol:
                raise AssertionError(f"18(b) seed {seed} {tag}: stream vs the CPU "
                                     f"interpreter {e} (tolerance {tol}, {kinds})")
            worst["edits"] = max(worst["edits"], e)
        log(f"18(b) seed {seed}: {len(blocks)} blocks, max_abs_err "
            f"{max(float(np.abs(b[1] - b[2]).max()) for b in blocks):.3e}, peak "
            f"{max(float(np.abs(b[1]).max()) for b in blocks):.3f}, nodes "
            f"{sorted({k for b in blocks for k in b[3]})}")
    edits = _delta(counts(), base)
    base = counts()
    for seed in CHUNKED_SEEDS:
        buffers, kinds = testing.chunked_fuzz(seed, device="cuda", oracle_device="cpu")
        e = max(float(np.abs(got - ref).max()) for got, ref in buffers)
        tol = PALETTE_SLICE_TOL if "ParametricEQProcessor" in kinds else CHUNKED_TOL
        if not e <= tol:
            raise AssertionError(f"18(c) seed {seed}: chunked stream vs the CPU "
                                 f"interpreter {e} (tolerance {tol})")
        worst["chunked"] = max(worst["chunked"], e)
        log(f"18(c) seed {seed}: {len(buffers)} buffers, max_abs_err {e:.3e}, {kinds}")
    chunked = _delta(counts(), base)
    log(f"18(b) launches {edits}; 18(c) launches {chunked}")
    return worst


def clock_program(ft, device: str):
    """beep -> volume, plus a one-shot sampler, summed to graph_out (the
    JAX package's ``tests/test_clock_wrap.py`` graph) → ``(program,
    volume, sampler)``."""
    from firewheel_tpu_torch import nodes

    g = ft.AudioGraph(ft.AudioGraphConfig(0, 2))
    vol, sfx = nodes.VolumeNode(100.0), nodes.SamplerNode(100.0)
    clip = (np.random.default_rng(7).standard_normal((2, 200)) * 0.2).astype(np.float32)
    sfx.set_sample(ft.SampleResource(clip, device=False))
    tid = g.add_node(0, 2, nodes.BeepTestNode(440.0, -12.0, True))
    vid, sid = g.add_node(2, 2, vol), g.add_node(0, 2, sfx)
    mix = g.add_node(4, 2, nodes.SumNode())
    for ch in range(2):
        g.connect(tid, ch, vid, ch)
        g.connect(vid, ch, mix, ch)
        g.connect(sid, ch, mix, 2 + ch)
        g.connect(mix, ch, g.graph_out_node(), ch)
    pkg = g.compile(48000, 128)
    prog = ft.ScheduleProgram(pkg.schedule, dict(pkg.new_node_processors), 48000,
                              device=device)
    return prog, vol, sfx


def check_clock(ft, card: str) -> None:
    """18(d): a fleet of 8192 parked one chunk before 2^32 renders two
    chunks; the scheduled-commands window across 2^32 is the small epoch's,
    bit for bit."""
    wrap, f = 1 << 32, 128

    def window(epoch, k=8):
        prog, vol, sfx = clock_program(ft, "cuda")
        vol.set_percent_volume(25.0, at_sample=epoch + 3 * f)
        sfx.play(at_sample=epoch + 5 * f)
        params = prog.collect_params(blocks=k, start_sample=epoch)
        out, _, _ = prog.render_chunk(
            params, prog.init_state(), torch.zeros((k, 0, f), device="cuda"),
            torch.ones((k, 0), dtype=torch.bool, device="cuda"), epoch)
        return out

    big, small = window(wrap - 4 * f), window(64 * f)
    if not torch.equal(big, small) or torch.equal(big[2], big[3]):
        raise AssertionError("18(d): the window across 2^32 is not the small "
                             "epoch's, or its volume set did not land at block 3")
    prog, vol, _ = clock_program(ft, "cuda")
    srv = ft.SessionServer(prog, capacity=CLOCK_CAPACITY, chunk_blocks=FUZZ_K,
                           device="cuda")
    h = srv.connect(lambda: vol.set_percent_volume(100.0))
    srv.sample = wrap - FUZZ_K * f
    t0 = time.perf_counter()
    a = srv.render()
    b = srv.render()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 2
    if srv.sample != wrap + FUZZ_K * f:
        raise AssertionError(f"18(d): the fleet's clock is {srv.sample}")
    step = abs(float(b[h.slot, 0, 0, 0]) - float(a[h.slot, -1, 0, -1]))
    peaks = [float(x[h.slot].abs().max()) for x in (a, b)]
    if (not all(bool(torch.isfinite(x).all()) for x in (a, b)) or min(peaks) <= 0.05
            or not step < 0.05):
        raise AssertionError(f"18(d): across 2^32 the session's peaks {peaks}, "
                             f"step {step}")
    log(f"18(d) on {card}: the window across 2^32 equals the small epoch's bit for "
        f"bit; a fleet of {CLOCK_CAPACITY} crossed it, peaks {peaks}, step at the "
        f"boundary {step:.4f}, {wall * 1e3:.1f} ms a chunk")


def check_fuzz(ft, em, eh, counts, oracle, card: str, phase) -> dict:
    """Phase 18: the differential fuzzers on the card."""
    base = counts()
    res = fuzz_lowerings(ft, em, eh, counts, oracle.get()["fuzz"], card)
    phase("18(a), the fuzz at B=8192, K=32 through eager, K2 and the hybrid")
    res["worst"].update(fuzz_streams(counts))
    phase("18(b), (c), live edits and chunked dispatch")
    check_clock(ft, card)
    phase("18(d), the clock across 2^32")
    k1 = _delta(counts(), base)["K1"]
    if k1:
        raise AssertionError(f"phase 18: K1 launched {k1} times")
    return res


# phase 19: BASELINE config 3 (examples/voice_mixer_64.py) and the examples
VM64_SECS = 2.0              # 19(a): the example's stream
VM64_BUFFER = 1024           # its buffers and blocks, 8 a dispatch
VM64_PROFILED = 1            # 19(a): buffers profiled after the timed stream
VM64_BATCH = (8192, 32)      # 19(b): B, K
VM64_CHUNKS = 3              # 19(b): chunks carrying state, a lowering
VM64_ROWS = (0, 1, 4097, 8191)  # 19(b): rows held against the CPU's render
VM64_SEED = 21               # 19(b): vary_voice_mixer_params
EDITOR_WAIT = 90.0           # 19(c): seconds the editor may take to show an edit


def vm64_stream(device: str, profile: bool = False) -> dict:
    """BASELINE config 3 streamed offline through ``FirewheelCtx`` on
    ``device`` as ``examples/voice_mixer_64.py`` streams it: the port's
    example's graph and stream (``examples.voice_mixer_64.stream_config``:
    1024-frame buffers and blocks, 8 a dispatch), VM64_SECS of buffers into
    an ``ArraySink``.  With ``profile``, ``torch.profiler`` traces
    VM64_PROFILED more buffers after the timed ones (not in the audio).
    Returns the audio, the final state, the walls a dispatch, the stream's
    stats and, profiled, the kernels a block."""
    ft = _port()
    from firewheel_tpu_torch.convert import state_to_numpy
    from firewheel_tpu_torch.examples import voice_mixer_64 as vm
    from firewheel_tpu_torch.mixer import add_voice_mixer_64

    cx = ft.FirewheelCtx(device=device)
    add_voice_mixer_64(cx.graph_mut(), vm.NUM_VOICES)
    sink = ft.ArraySink()
    cfg = vm.stream_config()
    cx.activate(cfg, sink=sink)
    stream = cx.stream
    buffers = -(-int(VM64_SECS * 48000) // VM64_BUFFER)
    out = {"walls": [], "sizes": []}
    t_start = time.perf_counter()
    done = 0
    while done < buffers:
        n = min(cfg.chunk_buffers, buffers - done)
        PumpTrace.pump(cx, n, out["walls"])
        out["sizes"].append(n)
        done += n
    stream.flush()
    if device != "cpu":
        torch.cuda.synchronize()
    out["wall"] = time.perf_counter() - t_start
    out["stats"] = stream.stats()
    out["state"] = state_to_numpy(stream._processor.state_dict())
    out["audio"] = sink.audio(2)
    out["buffers"] = buffers
    if profile:
        trace = PumpTrace()
        trace.start()
        trace.pump(cx, VM64_PROFILED, [])
        prof, _ = trace.stop(stream)
        out["profile"] = profile_busy(prof, VM64_PROFILED)
    cx.deactivate()
    if out["audio"].shape[1] < buffers * VM64_BUFFER:
        raise AssertionError(f"the config-3 stream rendered {out['audio'].shape}, "
                             f"expected {buffers * VM64_BUFFER} frames")
    out["audio"] = out["audio"][:, :buffers * VM64_BUFFER]
    return out


def example_results(device: str, root: str) -> dict:
    """The port's examples that 19(c) holds the card to, run on ``device``
    with their files under ``root``: ``game_server`` (its finish events and
    RMS), ``input_effects`` (the audio of its 2 s two-tone) and
    ``visual_node_graph`` (the DOT, the schedule's table and the audio)."""
    import contextlib
    import io

    _port()
    from firewheel_tpu_torch.core.formats import load_audio
    from firewheel_tpu_torch.examples import game_server, input_effects, visual_node_graph

    printed = io.StringIO()
    out = {}
    with contextlib.redirect_stdout(printed):
        out["game_server"] = game_server.main(device=device)
        wav = input_effects.main(os.path.join(root, f"input_effects_{device}.wav"),
                                 device=device)
        out["input_effects"] = load_audio(wav, device=False)[0].host_data
        vis = visual_node_graph.main(os.path.join(root, f"visual_{device}.html"),
                                     device=device)
        out["visual_node_graph"] = vis
    out["printed"] = printed.getvalue()
    return out


def vm64_stream_check(ft, counts, cpu: dict, card: str) -> float:
    """19(a): config 3 streamed on the card against the CPU's stream (the
    second worker): audio and state within 1e-5; no kernel of the port's
    launched; the realtime factor, wall a buffer (p50, p99) and kernels a
    block."""
    from firewheel_tpu_torch.convert import tree_map

    base = counts()
    run = vm64_stream("cuda", profile=True)
    launched = {k: v for k, v in _delta(counts(), base).items() if v}
    err = float(np.abs(run["audio"] - cpu["audio"]).max())
    state_err = tree_err(*(tree_map(torch.from_numpy, r["state"]) for r in (run, cpu)))
    if not max(err, state_err) <= STREAM_TOL or not np.isfinite(run["audio"]).all():
        raise AssertionError(f"19(a): the config-3 stream vs the CPU's: audio {err}, "
                             f"state {state_err}")
    if launched:
        raise AssertionError(f"19(a): the config-3 stream launched {launched}")
    peak = float(np.abs(run["audio"]).max())
    if not 0.01 < peak <= 1.0:
        raise AssertionError(f"19(a): the config-3 stream peaks at {peak}")
    secs = run["audio"].shape[1] / 48000
    walls = np.asarray([w / n for w, n in zip(run["walls"], run["sizes"])]) * 1e3
    stats = run["stats"]
    kernels, calls, busy = run["profile"]
    log(f"19(a), BASELINE config 3 (64 voices) streamed on {card} as the example "
        f"streams it ({run['buffers']} buffers of {VM64_BUFFER} frames, 8 a dispatch, "
        f"{secs:.3f} s): card vs CPU audio max_abs_err={err:.3e}, state "
        f"{state_err:.3e}; peak {peak:.4f}; K1-K9 launches 0 (asserted)")
    log(f"19(a): realtime factor card {secs / run['wall']:.3f} ({run['wall']:.3f} s), "
        f"CPU {secs / cpu['wall']:.3f} (the worker process); wall a buffer (a "
        f"dispatch / its buffers) p50 {np.percentile(walls, 50):.3f} ms, p99 "
        f"{np.percentile(walls, 99):.3f} ms (budget 21.333 ms); the stream's own "
        f"render/buffer p50 {stats['render_ms_p50']:.3f} ms, p99 "
        f"{stats['render_ms_p99']:.3f} ms; torch.profiler, {VM64_PROFILED} buffer: "
        f"{kernels:.1f} kernels a block on the device, {calls:.1f} launch calls, "
        f"{busy:.1f} us busy (0 when the profile saw no device activity)")
    return err


def config3_batched(ft, em, eh, counts, card: str):
    """19(b): config 3 at B x K, VM64_CHUNKS chunks carrying state, every
    instance its own rates, playheads, bus volume and pan, through eager and
    the hybrid (the 64 pooled samplers a torch stage, the sums and the bus
    one K3 island): K3 once a chunk, 0.0 from eager on outputs, masks and
    state; rows VM64_ROWS within 1e-5 of the CPU's render; K3 timed against
    its plain version at the last chunk's operands.  Returns ``(launches,
    max_abs_err, ms, call_ms, plain_ms, work)`` for the kernels line."""
    from firewheel_tpu_torch.convert import tree_map
    from firewheel_tpu_torch.mixer import vary_voice_mixer_params, voice_mixer_64_graph

    b, k = VM64_BATCH
    tag = f"19(b), config 3 B={b} K={k}"
    torch.cuda.empty_cache()  # the earlier phases' cached blocks
    prog = voice_mixer_64_graph(device="cuda")
    eager = ft.BatchRenderer(prog, b, device="cuda")
    hybrid = ft.BatchRenderer(prog, b, device="cuda", lowering="hybrid")
    params = vary_voice_mixer_params(prog, eager.stack_params(), VM64_SEED)
    state0 = eager.init_state()
    starts = [c * k * prog.max_block_frames for c in range(VM64_CHUNKS)]
    rows = list(VM64_ROWS)
    cpu_params = tree_map(lambda t: t[rows].cpu(), params)
    cpu_state0 = tree_map(lambda t: t[rows].cpu(), state0)
    torch.cuda.synchronize()
    log(f"{tag}: params {sum(t.nbytes for t in _leaves(params)) / 1e9:.3f} GB on the "
        f"card (each voice's clip f32[{b}, 1, 12000])")

    def run(renderer, before_last=lambda: None):
        outs, walls, st = [], [], state0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for start in starts:
            if start == starts[-1]:
                before_last()
            t0 = time.perf_counter()
            o, m, st = renderer.render_chunk(params, st, start_sample=start, num_blocks=k)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            outs.append((o, m, st))
        return outs, walls, torch.cuda.max_memory_allocated() / 1e9

    e_runs, e_walls, e_peak = run(eager)
    log(f"{tag}: eager wall a chunk {[round(w * 1e3, 3) for w in e_walls]} ms, peak "
        f"{e_peak:.3f} GB")
    torch.cuda.empty_cache()
    hy_seen = {}
    # the hybrid renderer is built at its first chunk; record the island's
    # operands at the last chunk's launch (its live-ins, 17.2 GB, are kept
    # for timing K3 afterwards)
    from firewheel_tpu_torch.executor_hybrid import HybridMegaRenderer

    launch = HybridMegaRenderer._launch

    def recording(self, i, p, s, env, env_flags):
        if hy_seen.get("last"):
            hy_seen.update(i=i, p=p, s=s, env=env, env_flags=env_flags)
        return launch(self, i, p, s, env, env_flags)

    base = counts()
    HybridMegaRenderer._launch = recording
    try:
        h_runs, h_walls, h_peak = run(hybrid, lambda: hy_seen.update(last=True))
    finally:
        HybridMegaRenderer._launch = launch
    launched = _delta(counts(), base)
    hy = hybrid._chunk_cache[("hybrid", k)]
    segs = [(kind, len(nodes)) for kind, nodes in hy.segments]
    if segs != [("xla", 64), ("mega", 8)]:
        raise AssertionError(f"{tag}: partition {segs}")
    if launched["K3"] != VM64_CHUNKS or any(v for n, v in launched.items() if n != "K3"):
        raise AssertionError(f"{tag}: launches {launched} in {VM64_CHUNKS} hybrid chunks "
                             f"(K3 once a chunk, nothing else)")
    worst = 0.0
    for c, ((ho, hm, hs), (eo, emk, es)) in enumerate(zip(h_runs, e_runs)):
        e = max(float((ho - eo).abs().max()), device_tree_err(hs, es))
        if not torch.equal(hm, emk) or e != 0.0:
            raise AssertionError(f"{tag}, chunk {c}: hybrid vs eager {e}, masks equal "
                                 f"{torch.equal(hm, emk)}")
        if not bool(torch.isfinite(ho).all()):
            raise AssertionError(f"{tag}, chunk {c}: non-finite output")
        worst = max(worst, e)
    peak = float(h_runs[-1][0].abs().max())
    if not 0.01 < peak <= 1.0:
        raise AssertionError(f"{tag}: output peak {peak}")
    # the rows on the CPU by the eager path, from the same params and state
    cpu = ft.BatchRenderer(voice_mixer_64_graph(device="cpu"), len(rows), device="cpu")
    cpu_err, cpu_state = 0.0, cpu_state0
    for start, (o, m, _) in zip(starts, h_runs):
        c_out, c_mask, cpu_state = cpu.render_chunk(cpu_params, cpu_state,
                                                    start_sample=start, num_blocks=k)
        if not torch.equal(m[rows].cpu(), c_mask):
            raise AssertionError(f"{tag}: masks differ from the CPU's at {start}")
        cpu_err = max(cpu_err, float((o[rows].cpu() - c_out).abs().max()))
    cpu_err = max(cpu_err, tree_err(tree_map(lambda t: t[rows], h_runs[-1][2]), cpu_state))
    if not cpu_err <= SLICE_TOL:
        raise AssertionError(f"{tag}: rows {rows} vs the CPU's render {cpu_err}")
    del e_runs, h_runs

    # K3 at the last chunk's operands: against its plain version, timed
    i, lw = hy_seen["i"], hy.islands[hy_seen["i"]]
    pseg, sseg, env, env_flags = (hy_seen[n] for n in ("p", "s", "env", "env_flags"))
    ko, kf, ks = hy._launch(i, pseg, sseg, env, env_flags)
    ro, rf, rs = em.island_chunk_reference(prog, lw, pseg, sseg, env, env_flags,
                                           starts[-1], k, b)
    torch.cuda.synchronize()
    k3_err = max(float((ko - ro).abs().max()), device_tree_err(ks, rs))
    if not torch.equal(kf, rf) or not k3_err <= HYBRID_TOL:
        raise AssertionError(f"{tag}: K3 vs its plain version {k3_err}, flags equal "
                             f"{torch.equal(kf, rf)}")
    ko_tile = hy.tile  # the tile KernelOperands takes: the renderer's

    def launch_k3():
        return hy._launch(i, pseg, sseg, env, env_flags)

    k3_ms = device_ms(launch_k3, "island_kernel", KERNEL_REPS)
    k3_call_ms = cuda_ms(launch_k3, KERNEL_REPS)
    plain_ms = cuda_ms(lambda: em.island_chunk_reference(
        prog, lw, pseg, sseg, env, env_flags, starts[-1], k, b), 1)
    work = kernel_work(em, prog, lw, pseg, sseg, b, k, env.nbytes + env_flags.nbytes
                       + ko.nbytes + kf.nbytes)
    bound_ms, bound_by = bound(*work)
    audio_secs = b * k * prog.max_block_frames / prog.sample_rate
    log(f"{tag}: segments {segs}; island {len(lw.keys)} rows, {lw.in_bufs.size} "
        f"live-ins, {lw.num_buffers} arena buffers ({lw.num_buffers * 4 * lw.frames} B "
        f"an instance), {em.shared_bytes(lw, ko_tile)} B "
        f"shared memory a CTA at tile {ko_tile} (arena spilled: {em.spills(lw)}), "
        f"live-ins {env_flags.float().mean():.3f} silent")
    log(f"{tag}: hybrid vs eager on the card ({VM64_CHUNKS} chunks, outputs, masks, "
        f"every state leaf): max_abs_err={worst:.3e}; rows {rows} vs the CPU "
        f"({VM64_CHUNKS} chunks and final state) {cpu_err:.3e}; launches {launched}")
    log(f"{tag} on {card}: eager wall a chunk {[round(w * 1e3, 3) for w in e_walls]} ms "
        f"(realtime factor {audio_secs / np.mean(e_walls[1:]):.1f} after the first), "
        f"peak {e_peak:.3f} GB; hybrid {[round(w * 1e3, 3) for w in h_walls]} ms "
        f"(realtime factor {audio_secs / np.mean(h_walls[1:]):.1f}), peak {h_peak:.3f} GB")
    log(f"{tag}: K3 vs its plain version at the last chunk's operands "
        f"max_abs_err={k3_err:.3e}; K3 {k3_ms:.4f} ms on the device ({k3_ms.how}), "
        f"{k3_call_ms:.4f} ms a call (CUDA events), plain {plain_ms:.4f} ms; bound "
        f"{bound_ms:.4f} ms by {bound_by} ({work[0] / 1e9:.4f} GB, {work[1] / 1e9:.3f} G "
        f"f32 operations), {100 * bound_ms / k3_ms:.1f}% of the bound")
    return launched["K3"], max(worst, k3_err), k3_ms, k3_call_ms, plain_ms, work


def editor_session(ft, iir, card: str) -> dict:
    """19(c): ``examples/interactive_graph.py``'s editor on the card: the
    example's HTTP server on an ephemeral localhost port, its engine thread
    streaming in realtime; an added voice (POST) grows the live graph by
    three nodes, an EQ insert (POST) lands; ``GET /state`` shows a finite
    meter in dB and stream stats that advance.  K7 launches while the EQ is
    in.  The app and the server stop before it returns."""
    import threading
    import urllib.request

    from firewheel_tpu_torch.examples import interactive_graph as ig

    app = ig.EngineApp(device="cuda")
    server = ig.ThreadingHTTPServer(("127.0.0.1", 0), ig.make_handler(app))
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    engine_error = []

    def engine():
        try:
            app.run(duration_secs=EDITOR_WAIT * 3)
        except BaseException as e:  # the engine thread's boundary: raised below
            engine_error.append(e)

    et = threading.Thread(target=engine)
    et.start()

    def state():
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/state", timeout=5.0) as r:
            return json.loads(r.read().decode())

    def post(path):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", method="POST",
                                     data=b"")
        with urllib.request.urlopen(req, timeout=5.0) as r:
            return r.read()

    def wait_for(pred, what):
        deadline = time.monotonic() + EDITOR_WAIT
        while time.monotonic() < deadline:
            if engine_error:
                raise engine_error[0]
            s = state()
            if pred(s):
                return s
            time.sleep(0.1)
        raise AssertionError(f"19(c), the editor: {what} not seen in {EDITOR_WAIT} s; "
                             f"log {s.get('log')}")

    def live(s):
        md = s.get("meter_db")
        return md is not None and all(-100.0 <= float(v) <= 0.0 for v in md)

    t0 = time.perf_counter()
    try:
        s1 = wait_for(lambda s: live(s) and s.get("stream", {}).get(
            "frames_rendered", 0) > 4096, "a finite meter after 4096 frames")
        n0 = len(s1["nodes"])
        post("/cmd?op=add_voice&freq=880")
        wait_for(lambda s: len(s.get("nodes", [])) == n0 + 3, "the added voice")
        k7 = iir.biquad_cascade.launches
        post("/cmd?op=set_fx&v=eq")
        s2 = wait_for(lambda s: s.get("fx") == "eq" and any(
            n["name"] == "parametric_eq" for n in s["nodes"]), "the EQ insert")
        f2 = s2["stream"]["frames_rendered"]
        s3 = wait_for(lambda s: live(s) and s["stream"]["frames_rendered"] > f2 + 4096,
                      "stats advancing with the EQ in")
        k7 = iir.biquad_cascade.launches - k7
        if k7 <= 0:
            raise AssertionError(f"19(c), the editor: K7 launched {k7} times with the "
                                 f"EQ in")
    finally:
        app.stop()
        et.join(timeout=60.0)
        server.shutdown()
    if et.is_alive():
        raise AssertionError("19(c), the editor's engine thread did not stop")
    if engine_error:
        raise engine_error[0]
    log(f"19(c), the interactive editor on {card} over HTTP (127.0.0.1:{port}): "
        f"{n0} → {len(s3['nodes'])} nodes (a voice added, the EQ inserted), meter "
        f"{s3['meter_db']} dB, {s3['stream']['frames_rendered']} frames rendered, "
        f"K7 {k7} launches with the EQ in; {time.perf_counter() - t0:.1f} s")
    return {"k7": k7}


def examples_check(ft, iir, counts, cpu: dict, card: str) -> dict:
    """19(c): the game server, the live-input chain and the visual node graph
    on the card against the same examples on the CPU (the second worker),
    then the interactive editor."""
    base, k7 = counts(), iir.biquad_cascade.launches
    got = example_results("cuda", scratch_dir("fw_examples_"))
    launched = _delta(counts(), base)
    k7 = iir.biquad_cascade.launches - k7
    gs, gs_cpu = got["game_server"], cpu["game_server"]
    rms_err = float(np.abs(gs["rms"] - gs_cpu["rms"]).max())
    if gs["finished"] != gs_cpu["finished"] or not rms_err <= SLICE_TOL:
        raise AssertionError(f"19(c), game_server: finished {gs['finished']} vs the "
                             f"CPU's {gs_cpu['finished']}, rms {rms_err}")
    fx, fx_cpu = got["input_effects"], cpu["input_effects"]
    fx_err = float(np.abs(fx - fx_cpu).max()) if fx.shape == fx_cpu.shape else float("inf")
    # one 1024-frame block a buffer, and the activation's throwaway render of
    # one block (``GraphProcessor.warmup``)
    blocks = fx.shape[1] // 1024 + 1
    spec = np.abs(np.fft.rfft(fx[0, -48000:]))
    if not fx_err <= STREAM_TOL or not spec[500] > 30 * spec[9000] or k7 != blocks:
        raise AssertionError(f"19(c), input_effects: vs the CPU {fx_err}, 500 Hz / "
                             f"9 kHz {spec[500] / spec[9000]:.1f}, K7 {k7} launches for "
                             f"{blocks} blocks (the warm-up's included)")
    vis, vis_cpu = got["visual_node_graph"], cpu["visual_node_graph"]
    vis_err = float(np.abs(vis["audio"] - vis_cpu["audio"]).max())
    if (not vis["cycle_rejected"] or vis["dot"] != vis_cpu["dot"]
            or vis["schedule"] != vis_cpu["schedule"] or not vis_err <= STREAM_TOL):
        raise AssertionError(f"19(c), visual_node_graph: cycle rejected "
                             f"{vis['cycle_rejected']}, DOT equal "
                             f"{vis['dot'] == vis_cpu['dot']}, schedule equal "
                             f"{vis['schedule'] == vis_cpu['schedule']}, audio {vis_err}")
    others = {n: v for n, v in launched.items() if v and n != "K7"}
    if others:
        raise AssertionError(f"19(c): the examples launched {others}")
    log(f"19(c), game_server on {card}: SFX finished in {gs['finished']}, each "
        f"instance's RMS vs the CPU's max_abs_err={rms_err:.3e}, instance 7 muted "
        f"({gs['rms'][7]:.2e}); input_effects: {fx.shape[1]} frames vs the CPU "
        f"{fx_err:.3e}, 500 Hz {20 * np.log10(spec[500] / spec[9000]):.1f} dB over "
        f"9 kHz, K7 {k7} launches for {blocks} blocks (the warm-up's included); "
        f"visual_node_graph: the cycle rejected, DOT and schedule equal to the "
        f"CPU's, audio {vis_err:.3e}")
    editor = editor_session(ft, iir, card)
    return {"input_effects_k7": k7, "editor_k7": editor["k7"]}


# 19(d): the nine examples of examples/ ported last, each module's main
# end to end at the example's own settings
NINE_EXAMPLES = ("beep_test", "session_server", "effects_chain", "mastering_bus",
                 "spatial_scene", "music_player", "voice_pool_game", "midi_jukebox",
                 "autotune_mix")
PCM_LSB = 1                  # 19(d): the session server's pcm16, card vs CPU
#: 19(d): the kernels each example launches a block of its stream, and the
#: frames of a block (the examples stream in blocks of a buffer); the
#: activation's throwaway render adds one dispatch of ``chunk_buffers``
#: blocks.  The other examples launch no kernel of the port's.
NINE_KERNELS = {"effects_chain": ({"K7_biquad": 1}, 1024, 1),
                "mastering_bus": ({"K5": 4, "K6": 1, "K7_biquad": 1}, 256, 1),
                "spatial_scene": ({"K7_one_pole": 1}, 1024, 8)}


def nine_examples(device: str, root: str, counts=None) -> dict:
    """19(d): the nine example modules' ``main`` on ``device``, each at the
    example's own settings (``session_server`` with ``output_format=
    "pcm16"``), their files under ``root``, their printed lines captured.
    Returns, by example, what its ``main`` returned (the WAV it wrote read
    back as ``audio``), its wall, what it printed and, with ``counts`` (the
    kernel wrappers' counts), the launches it made: numpy and numbers only,
    so that the CPU's worker can send them."""
    import contextlib
    import importlib
    import io

    _port()
    from firewheel_tpu_torch.core.formats import load_audio

    def wav(name):
        return os.path.join(root, f"{name}_{device}.wav")

    music_dir = os.path.join(root, f"music_{device}")
    os.makedirs(music_dir, exist_ok=True)
    runs = {
        "beep_test": lambda m: m.main(wav("beep_test"), device=device),
        "session_server": lambda m: m.main("pcm16", device=device),
        "effects_chain": lambda m: m.main(wav("effects_chain"), device=device),
        "mastering_bus": lambda m: m.main(wav("mastering_bus"), device=device),
        "spatial_scene": lambda m: {"path": wav("spatial_scene"),
                                    **m.main(wav("spatial_scene"), device=device)},
        "music_player": lambda m: m.main(music_dir, device=device),
        "voice_pool_game": lambda m: m.main(wav("voice_pool_game"), device=device),
        "midi_jukebox": lambda m: m.main(None, wav("midi_jukebox"), device=device),
        "autotune_mix": lambda m: m.main(device=device),
    }
    if device == "cpu":
        torch.set_num_threads(1)
    out = {}
    for name in NINE_EXAMPLES:
        mod = importlib.import_module(f"firewheel_tpu_torch.examples.{name}")
        printed = io.StringIO()
        before = counts() if counts else None
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            got = runs[name](mod)
        if device != "cpu":
            torch.cuda.synchronize()
        res = {k: v for k, v in (got or {}).items() if k != "path"}
        res["wall"] = time.perf_counter() - t0
        res["printed"] = printed.getvalue()
        if "path" in got:
            res["audio"] = load_audio(got["path"], device=False)[0].host_data
        if counts:
            res["launches"] = {k: v for k, v in _delta(counts(), before).items() if v}
        out[name] = res
    return out


def nine_examples_check(counts, cpu_result, card: str) -> dict:
    """19(d): the nine example modules on the card against the same modules
    on the CPU (the first worker): the WAVs within 1e-5 (the beep's over
    the frames both rendered: its wall-clock poll may stop short of 4 s),
    the events, finish counts and notes equal, the loudness readings within
    1e-3 LU, the session server's pcm16 within 1 LSB, the fitted gains
    within GRAD_TOL of the largest; K5, K6 and K7 launched as NINE_KERNELS
    says, nothing else.  Returns the launches by example."""
    cpu = cpu_result.get()["examples"]
    got = nine_examples("cuda", scratch_dir("fw_nine_"), counts)
    report = {}
    for name in NINE_EXAMPLES:
        g, c = got[name], cpu[name]
        fail = []
        line = ""
        if "audio" in g:
            a, b = g["audio"], c["audio"]
            if name == "beep_test":
                n = min(a.shape[1], b.shape[1])
                a, b = a[:, :n], b[:, :n]
                spec = np.abs(np.fft.rfft(a[0, :48000]))
                if n < 48000 or np.argmax(spec) != 440 or abs(
                        np.abs(a).max() - 10 ** (-12 / 20)) > 1e-4:
                    fail.append(f"tone: {n} frames, peak bin {np.argmax(spec)}")
            err = float(np.abs(a - b).max()) if a.shape == b.shape else float("inf")
            if not (err <= STREAM_TOL and np.isfinite(a).all()):
                fail.append(f"audio {a.shape} vs the CPU's {b.shape}: {err}")
            line += f"{a.shape[1]} frames, vs the CPU max_abs_err={err:.3e}"
        if name == "session_server":
            a, b = g["last_chunk"], c["last_chunk"]
            lsb = int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max()) \
                if a.shape == b.shape else PCM_LSB + 1
            if lsb > PCM_LSB or g["fired"] != c["fired"] or a.dtype != np.int16:
                fail.append(f"pcm16 {lsb} LSB, fired {g['fired']} vs {c['fired']}")
            line += (f"the last pcm16 chunk {a.shape} within {lsb} LSB of the CPU's, SFX "
                     f"finished in {g['fired']}")
        if name == "mastering_bus":
            ga, ca = np.asarray(g["reads"]), np.asarray(c["reads"])
            finite = np.isfinite(ca)
            lu = max(float(np.abs(np.where(finite, ga - ca, 0.0)).max()),
                     abs(g["integrated"] - c["integrated"]),
                     abs(g["short_term"] - c["short_term"]))
            if ga.shape != ca.shape or not np.array_equal(np.isfinite(ga), finite) \
                    or not lu <= LU_TOL:
                fail.append(f"readings {ga.shape} vs {ca.shape}, {lu} LU")
            line += (f"; {len(ga)} readings and the integrated loudness "
                     f"{g['integrated']:.3f} LUFS vs the CPU's within {lu:.2e} LU")
        if name == "spatial_scene" and g["nodes"] != 266:
            fail.append(f"{g['nodes']} nodes")
        for key in ("finished", "outro", "shots", "active", "dropped", "skipped"):
            if key in g and g[key] != c[key]:
                fail.append(f"{key} {g[key]} vs the CPU's {c[key]}")
        if name == "music_player":
            line += f"; finish events {g['finished']}, outro {g['outro']}"
        if name == "voice_pool_game":
            line += f"; {len(g['shots'])} shots as the CPU's, {g['active']} looping"
        if name == "midi_jukebox":
            line += f"; dropped {g['dropped']}, skipped {g['skipped']}"
        if name == "autotune_mix":
            err = float(np.abs(g["gains"] - c["gains"]).max())
            if not (err <= GRAD_TOL * float(np.abs(c["gains"]).max())
                    and g["loss"] < 1e-6):
                fail.append(f"gains {g['gains']} vs {c['gains']}, loss {g['loss']}")
            line += (f"gains {np.round(g['gains'], 4).tolist()} vs the CPU's "
                     f"max_abs_err={err:.3e}, loss {g['loss']:.3e}")
        per_block, frames, warm = NINE_KERNELS.get(name, ({}, 1, 0))
        blocks = -(-g["audio"].shape[1] // frames) + warm if per_block else 0
        want = {k: n * blocks for k, n in per_block.items()}
        launched = {k: v for k, v in g["launches"].items() if k != "K7"}
        if launched != want or c.get("launches"):
            fail.append(f"launches {launched}, expected {want}")
        if fail:
            raise AssertionError(f"19(d), {name}: " + "; ".join(fail))
        secs = g["audio"].shape[1] / 48000 if "audio" in g else 0.0
        rtf = f", RTF {secs / g['wall']:.3f}" if secs else ""
        log(f"19(d), {name} on {card}: {g['wall']:.2f} s (CPU {c['wall']:.2f} s){rtf}; "
            f"{line}; launches {launched or 'none'}")
        report[name] = launched
    return report


def check_config3(ft, em, eh, iir, counts, cpu, card: str, phase) -> tuple:
    """Phase 19: BASELINE config 3 and the ported examples on the card."""
    ref = cpu.get()
    vm64_stream_check(ft, counts, ref["vm64"], card)
    phase("19(a), config 3 streamed")
    k3 = config3_batched(ft, em, eh, counts, card)
    phase("19(b), config 3 batched through eager and the hybrid")
    ex = examples_check(ft, iir, counts, ref["examples"], card)
    phase("19(c), the game server, live input, visual graph and HTTP editor")
    return k3, ex


# -- phase 20: the port's entry point (firewheel_tpu_torch/entry.py) ----------
#
# 20(a): entry()'s chunk (the 64-node mixer, K=4, B=2, the "auto" filter:
# K7 once a block) on the card against entry(device="cpu"), and the same with
# strip_masks (audio and state: the masks carry no meaning) and state_light;
# 20(b): dryrun_multichip(1) in place in a world of one on NCCL; 20(c):
# dryrun_multichip(4), four started ranks sharing the card over gloo with
# CUDA tensors, dp=2 x vp=2, each rank's rows against the unsharded step at
# entry.STEP_TOL (1e-5); K7's launches in each rank's sharded step (the
# master's lowpass, once a block)

ENTRY_GRAPHS = (("mixer", {}), ("strip_masks", {"strip_masks": True}),
                ("state_light", {"state_light": True}))
ENTRY_TIMED = 20   # chunks timed a graph


def entry_chunks(iir, card: str) -> dict:
    """20(a) → ``{graph: {"k7", "err", "ms"}}``."""
    from firewheel_tpu_torch import entry as te

    def step(device, kw):
        # entry() itself for the mixer; its step on the ablations' graphs
        if not kw:
            return te.entry(device=device)
        return te.chunk_step(te._mixer_graph(device=device, **kw))

    got = {}
    for name, kw in ENTRY_GRAPHS:
        fn, args = step("cuda", kw)
        cfn, cargs = step("cpu", kw)
        k7 = iir.biquad_cascade.launches
        out, mask, state = fn(*args)
        torch.cuda.synchronize()
        k7 = iir.biquad_cascade.launches - k7
        cout, cmask, cstate = cfn(*cargs)
        err = max(float((out.cpu() - cout).abs().max()), tree_err(state, cstate))
        masks = not mask.any() if kw.get("strip_masks") else torch.equal(mask.cpu(), cmask)
        fn(*args)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ENTRY_TIMED):
            fn(*args)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / ENTRY_TIMED
        if not (err <= SLICE_TOL and masks and k7 == te.BLOCKS
                and torch.isfinite(out).all() and float(cout.abs().max()) > 0.01):
            raise AssertionError(f"20(a), {name}: vs the CPU {err}, masks {masks}, "
                                 f"K7 launches {k7}")
        got[name] = {"k7": k7, "err": err, "ms": ms}
        log(f"phase 20(a), {'entry()' if not kw else f'the mixer with {name}'} on {card}: "
            f"out {tuple(out.shape)}, vs the CPU max_abs_err={err:.3e} (state included), "
            f"masks {'all not silent' if kw.get('strip_masks') else 'equal'}; K7 launches {k7}; "
            f"wall a chunk {ms:.3f} ms")
    return got


def dryrun_check(got: list, n: int, backend: str, card: str) -> dict:
    """20(b), (c): each rank's numbers from ``dryrun_multichip(n)`` →
    K7's launches by rank."""
    from firewheel_tpu_torch import entry as te

    for r in got:
        if not (r["backend"] == backend and r["device"].startswith("cuda")
                and r["step_err"] <= te.STEP_TOL and r["batch_err"] <= te.BATCH_TOL
                and r["mix_err"] <= te.STEP_TOL and r["step_k7"] == te.DRYRUN_BLOCKS):
            raise AssertionError(f"dryrun_multichip({n}), rank {r['rank']}: {r}")
        log(f"phase 20, dryrun_multichip({n}) rank {r['rank']} ({r['backend']}, "
            f"{r['device']}, {card}): rows {r['rows']}, voices {r['voices']}, vs the "
            f"unsharded step max_abs_err={r['step_err']:.3e}; BatchRenderer "
            f"{r['batch_err']:.3e}, VoiceParallelMixer {r['mix_err']:.3e}; K7 launches "
            f"in the sharded step {r['step_k7']}")
    if [r["rank"] for r in got] != list(range(n)):
        raise AssertionError(f"dryrun_multichip({n}): ranks {[r['rank'] for r in got]}")
    return {f"rank {r['rank']}": r["step_k7"] for r in got}


def check_entry(iir, card: str, phase) -> dict:
    """Phase 20 → K7's launches in it, by part."""
    import socket

    import torch.distributed as dist

    from firewheel_tpu_torch import entry as te
    from firewheel_tpu_torch.parallel import initialize_multihost

    chunks = entry_chunks(iir, card)
    launches = {f"20(a) {name}": c["k7"] for name, c in chunks.items()}
    phase("20(a), entry() on the card")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    initialize_multihost(f"localhost:{port}", 1, 0)
    try:
        one = te.dryrun_multichip(1)
    finally:
        dist.destroy_process_group()
    launches.update({f"20(b) {k}": v for k, v in dryrun_check(one, 1, "nccl", card).items()})
    phase("20(b), dryrun_multichip(1) on NCCL")
    four = te.dryrun_multichip(4)
    launches.update({f"20(c) {k}": v for k, v in dryrun_check(four, 4, "gloo", card).items()})
    phase("20(c), dryrun_multichip(4), four gloo ranks on the card")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import firewheel_tpu_torch as ft
    from firewheel_tpu_torch import executor_hybrid as eh
    from firewheel_tpu_torch import executor_mega as em
    from firewheel_tpu_torch.ops import (
        adpcm_device, cuda_build, dynamics, iir, noise, seq_iir,
    )

    if not os.path.abspath(ft.__file__).startswith(here + os.sep):
        raise RuntimeError(f"firewheel_tpu_torch imported from {ft.__file__}")
    if "jax" in sys.modules or "firewheel_tpu" in sys.modules:
        raise RuntimeError("the port imported JAX")
    # 11(a)'s and 12(a)'s CPU streams run in a worker process while the
    # card runs phases 2..11; they are read in phases 11 and 12
    cpu_stream = CpuStream()
    # 18(a)'s CPU oracle, in a second worker
    fuzz_oracle = CpuStream(_cpu_fuzz_worker)
    try:
        return run_phases(ft, eh, em, adpcm_device, cuda_build, dynamics, iir,
                          noise, seq_iir, cpu_stream, fuzz_oracle)
    finally:
        cpu_stream.stop()
        fuzz_oracle.stop()


def run_phases(ft, eh, em, adpcm_device, cuda_build, dynamics, iir, noise, seq_iir,
               cpu_stream, fuzz_oracle) -> int:
    """Phases 1..20 and the result lines."""
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    t_start = t0 = time.perf_counter()

    def phase(name):
        nonlocal t0
        now = time.perf_counter()
        log(f"phase {name}: {now - t0:.1f} s (total {now - t_start:.1f} s)")
        t0 = now

    new_libraries = (adpcm_device.LIBRARY, dynamics.LIBRARY, noise.LIBRARY, iir.LIBRARY,
                     iir.BWD_LIBRARY, dynamics.BWD_LIBRARY)
    cuda_build.build_all([seq_iir.LIBRARY, em.LIBRARY, *new_libraries], verbose=True)
    if seq_iir.LIBRARY.log:
        # two instantiations: 16-byte copies, and 4-byte copies
        for name, report in ptxas_report(seq_iir.LIBRARY.log,
                                         "biquad_seq_kernel").items():
            copies = "16-byte" if "ILb1E" in name else "4-byte"
            log(f"ptxas, biquad_seq_kernel ({copies} copies): {report}")
    else:
        log("ptxas: the K1 library was built before this run")
    if em.LIBRARY.log:
        for kernel in ("mega_kernel", "island_kernel"):
            # five of each: blocks of 128 frames fixed, and of any length,
            # each with the rows beyond the mixer's compiled in (the bool
            # template argument) and without; and the arena spilled to
            # device memory (any length, every row)
            for name, report in ptxas_report(em.LIBRARY.log, kernel).items():
                frames = ("F=128" if "Args128" in name else
                          "the arena spilled" if "ArgsSpill" in name else "any F")
                rows = "rows beyond the mixer's" if "Lb1E" in name else "the mixer's rows"
                log(f"ptxas, {kernel} ({frames}, {rows}): {report}")
    else:
        log("ptxas: the megakernel library was built before this run")
    for lib, kernel in zip(new_libraries, ("adpcm_encode_kernel", "sample_scan_kernel",
                                           "noise_uniform_kernel", "scan_kernel",
                                           "bwd_kernel", "sample_scan_bwd_kernel")):
        if lib.log:
            for name, report in ptxas_report(lib.log, kernel).items():
                log(f"ptxas, {name}: {report}")
        else:
            log(f"ptxas: {lib.name} was built before this run")
    phase("2, K1, the megakernel (K2, K3) and K4-K9 built")

    err, ms, call_ms, plain_ms = check_kernel(seq_iir, iir)
    phase("3, K1 vs plain")
    new_kernels = check_new_kernels(adpcm_device, dynamics, noise)
    phase("3(b), K4-K6 vs plain")
    k7 = check_assoc_scan(iir)
    phase("3(c), K7 vs plain")
    # K8 and K9 beside K7 and K5, while a profile still sees the card
    bwd = {"k8": check_k8(iir)}
    phase("17(a), K8 vs its plain backward")
    bwd["k9"] = check_k9(dynamics)
    phase("17(b), K9 vs its plain backward")
    launches, mixer_wall = render_mixer(ft, seq_iir, card)
    phase("4, mixer eager")
    m_launches, m_err, m_ms, m_call_ms, m_plain_ms, m_work = render_mega(
        ft, seq_iir, em, card)
    phase("5, mixer megakernel")
    r_err = check_random_graphs(ft, em)
    phase("6, random graphs")
    h_launches, h_err = 0, 0.0
    for b, k in HYBRID_CONFIGS:
        # the kernels line keeps the last configuration's times (B=8192, K=32)
        n, e, h_ms, h_call_ms, h_plain_ms, h_work = render_hybrid(
            ft, seq_iir, em, eh, card, b, k)
        h_launches += n
        h_err = max(h_err, e)
        phase(f"7, effects chain hybrid B={b} K={k}")
    h_err = max(h_err, check_hybrid_graphs(ft, em, eh))
    phase("8, hybrid on three more graphs")
    s_err, s_launches, k1_stream = check_stream(ft, seq_iir, em, eh, card)
    phase("9, the streaming engine")
    log(f"phase 9: the stream on the card vs the CPU, max_abs_err={s_err:.3e}")
    serve_k1, serve_k3, serve_k4 = check_serving(ft, seq_iir, em, eh, adpcm_device,
                                                 card, phase)
    spatial_k2, spatial_k3, spatial_k2_spilled = check_spatial(ft, seq_iir, em, eh,
                                                               cpu_stream, card, phase)
    bus_err, bus_k5, bus_k6, stream_k5, stream_k6, bus_stream_k7, bus_k3 = \
        check_mastering(ft, seq_iir, em, eh, dynamics, noise, cpu_stream, card, phase)
    fx_err, fx_k7, fx_stream_k7, fx_k2, fx_k3 = check_palette(ft, em, eh, iir,
                                                              cpu_stream, card, phase)
    log(f"phase 13: the FX palette on the card vs the CPU and eager, "
        f"max_abs_err={fx_err:.3e}")
    slice_err = check_slice(ft, seq_iir, em, eh, adpcm_device, dynamics, iir, noise,
                            cpu_stream, card, phase)
    log(f"phase 14: the sampler and formats slice on the card vs the CPU, "
        f"max_abs_err={slice_err:.3e}")
    validator = check_pool_slice(ft, seq_iir, em, eh, adpcm_device, dynamics, iir, noise,
                                 cpu_stream, card, phase)
    mesh_k1 = check_scale_out(ft, seq_iir, card, phase, mixer_wall)
    phase("16(b) and (c) at vp=2, two ranks on the card")
    grads = check_gradients(ft, seq_iir, em, eh, adpcm_device, dynamics, iir, noise, card,
                            phase, bwd)
    # after phase 17, so that phases 1-17 run as they did before it (PERF.md §6)
    fuzz = check_fuzz(ft, em, eh, lambda: {
        **kernel_counts(seq_iir, em, eh, adpcm_device, dynamics, iir, noise),
        "K7_biquad": iir.biquad_cascade.launches, "K7_one_pole": iir.one_pole_scan.launches,
    }, fuzz_oracle, card, phase)
    vm64_k3, examples = check_config3(
        ft, em, eh, iir,
        lambda: kernel_counts(seq_iir, em, eh, adpcm_device, dynamics, iir, noise),
        fuzz_oracle, card, phase)
    nine = nine_examples_check(lambda: {
        **kernel_counts(seq_iir, em, eh, adpcm_device, dynamics, iir, noise),
        "K7_biquad": iir.biquad_cascade.launches, "K7_one_pole": iir.one_pole_scan.launches,
    }, cpu_stream, card)
    phase("19(d), the nine examples' modules end to end")
    entry_k7 = check_entry(iir, card, phase)
    if "jax" in sys.modules:
        raise RuntimeError("the port imported JAX")

    lanes = 2 * B  # K1 at the main path's shape: x, y [lanes, 128], coef, z in and out
    k1_work = (4 * lanes * (2 * 128 + 5 + 2 * 2), 9 * lanes * 128)
    kernels = []
    # ms: device time by torch.profiler; call_ms: a call with the wrapper's
    # host work, by CUDA events
    for name, source, replaces, n, e, t, call, plain, work in (
        ("biquad_seq", "firewheel_tpu_torch/csrc/biquad.cu",
         "firewheel_tpu/ops/pallas_iir.py:50", launches, err, ms, call_ms,
         plain_ms, k1_work),
        ("megakernel", "firewheel_tpu_torch/csrc/megakernel.cu",
         "firewheel_tpu/executor_pallas.py:218", m_launches, max(m_err, r_err),
         m_ms, m_call_ms, m_plain_ms, m_work),
        ("hybrid_island", "firewheel_tpu_torch/csrc/megakernel.cu",
         "firewheel_tpu/executor_pallas.py:617", h_launches, h_err, h_ms,
         h_call_ms, h_plain_ms, h_work),
        # phase 11: K2 on the spatial scene (B=8192, K=32, every 4th emitter
        # moving) and K3 on the doppler scene's beeps island (B=1024, K=8)
        ("megakernel_spatial_scene", "firewheel_tpu_torch/csrc/megakernel.cu",
         "firewheel_tpu/executor_pallas.py:218", *spatial_k2),
        ("hybrid_island_spatial_scene", "firewheel_tpu_torch/csrc/megakernel.cu",
         "firewheel_tpu/executor_pallas.py:617", *spatial_k3),
        # phase 11(c): K2 on the scene in blocks of 256 frames, its arena
        # spilled to device memory (B=1024, K=8; plain_ms: eager's wall)
        ("megakernel_spatial_scene_spilled", "firewheel_tpu_torch/csrc/megakernel.cu",
         "firewheel_tpu/executor_pallas.py:218", *spatial_k2_spilled),
        # phase 12(c): K3 on the mastering bus's two islands (ms, call and
        # plain: both islands a chunk), B=8192, K=32
        ("hybrid_island_mastering_bus", "firewheel_tpu_torch/csrc/megakernel.cu",
         "firewheel_tpu/executor_pallas.py:617", *bus_k3),
        # phase 13(c): K2 on the FX palette without the flanger and K3 on the
        # palette's two islands (ms, call and plain: both islands a chunk),
        # B=1024, K=8
        ("megakernel_fx_palette", "firewheel_tpu_torch/csrc/megakernel.cu",
         "firewheel_tpu/executor_pallas.py:218", *fx_k2),
        ("hybrid_island_fx_palette", "firewheel_tpu_torch/csrc/megakernel.cu",
         "firewheel_tpu/executor_pallas.py:617", *fx_k3),
        # phase 19(b): K3 on BASELINE config 3's island (the sums and the
        # bus after the 64 samplers' torch stage), B=8192, K=32
        ("hybrid_island_voice_mixer_64", "firewheel_tpu_torch/csrc/megakernel.cu",
         "firewheel_tpu/executor_pallas.py:617", *vm64_k3),
        # phase 3(b)'s checks and times at the main paths' shapes; launches
        # in 10(f)'s adpcm4 fleet (K4) and 12(b)'s batched bus (K5, K6)
        ("adpcm_encode", "firewheel_tpu_torch/csrc/adpcm.cu",
         "firewheel_tpu/ops/adpcm_device.py:82", serve_k4,
         *new_kernels["adpcm_encode"]),
        ("sample_scan", "firewheel_tpu_torch/csrc/sample_scan.cu",
         "firewheel_tpu/ops/dynamics.py:30", bus_k5, *new_kernels["sample_scan"]),
        ("noise_uniform", "firewheel_tpu_torch/csrc/noise.cu",
         "firewheel_tpu/nodes/generators.py:85", bus_k6,
         *new_kernels["noise_uniform"]),
        # phase 3(c)'s checks and times, launches in 13(b)'s batched FX
        # palette: K7's biquad kernel (its wrapper biquad_cascade, biquad_scan
        # the one-section call) at the EQ's three bands over f32[16384, 128],
        # the one-pole (the fold's DC blocker) at f32[16384, 128]; each one's
        # other shapes under "at"
        ("biquad_scan", "firewheel_tpu_torch/csrc/assoc_scan.cu",
         "firewheel_tpu/ops/iir.py:260", fx_k7[0],
         *k7[k7_label("cascade", 2 * B, 128, 3)]),
        ("one_pole_scan", "firewheel_tpu_torch/csrc/assoc_scan.cu",
         "firewheel_tpu/ops/iir.py:132", fx_k7[1], *k7[k7_label("one_pole", 2 * B, 128)]),
        # phase 17: K8, K7's backwards (the autodiff of the JAX package's
        # associative scans; launches in 17(c)'s training steps, times at
        # the EQ's cascade from 17(a), its other shapes under "at"), and
        # K9, K5's (launches in 17(e)'s bus, all of them the limiter's;
        # times at the limiter's f32[8192, 128] from 17(b))
        ("assoc_scan_backward", "firewheel_tpu_torch/csrc/assoc_scan_bwd.cu",
         "firewheel_tpu/ops/iir.py:260", grads["train"]["launches"],
         *grads["k8"][k7_label("cascade", 2 * B, 128, 3)]),
        ("sample_scan_backward", "firewheel_tpu_torch/csrc/sample_scan_bwd.cu",
         "firewheel_tpu/ops/dynamics.py:30", grads["bus"]["launches"],
         *grads["k9"][f"limiter f32[{B}, 128]"]),
    ):
        bound_ms, bound_by = bound(*work)
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": n,
            "stream_launches": {
                "biquad_seq": s_launches, "sample_scan": stream_k5,
                "noise_uniform": stream_k6,
                # 13(a)'s FX engine and 12(a)'s mastering bus
                "biquad_scan": {"stream_fx": fx_stream_k7[0],
                                "stream_mastering": bus_stream_k7},
                "one_pole_scan": {"stream_fx": fx_stream_k7[1],
                                  "stream_mastering": 0},
            }.get(name, 0),
            # 19(c): the live-input example's filter and the editor's EQ;
            # 19(d): the effects chain's filter, the mastering bus's
            # dynamics, noise and meter, the spatial scene's one-poles
            "example_launches": {
                **({"input_effects": examples["input_effects_k7"],
                    "interactive_graph": examples["editor_k7"]}
                   if name == "biquad_scan" else {}),
                **{ex: n[kernel] for ex, n in nine.items() for kernel in n
                   if {"biquad_scan": "K7_biquad", "one_pole_scan": "K7_one_pole",
                       "sample_scan": "K5", "noise_uniform": "K6"}.get(name) == kernel},
            },
            "serve_launches": {"biquad_seq": serve_k1, "hybrid_island": serve_k3,
                               "adpcm_encode": serve_k4}.get(name, 0),
            # 15(d): validate_node on the card (the EQ's cascade is K7's biquad)
            # phase 16: the dp=1 and dp=2 fleets, the vp=1 and vp=2 mixers
            # (each rank's count), the profiled chunk
            "mesh_launches": mesh_k1 if name == "biquad_seq" else {},
            "validator_launches": {"biquad_seq": validator["biquad_seq"],
                                   "sample_scan": validator["scan_lanes"],
                                   "noise_uniform": validator["noise_uniform"],
                                   "biquad_scan": validator["biquad_cascade"],
                                   "one_pole_scan": validator["one_pole_scan"]}.get(name, 0),
            # phase 20: entry()'s chunks and each dry-run rank's sharded step
            "entry_launches": entry_k7 if name == "biquad_scan" else {},
            # 17(h): K8 (the EQ's cascade) and K9 (the gate) in its backward
            "eq_gate_launches": grads["eq_gate"]["launches"].get(
                {"assoc_scan_backward": "K8", "sample_scan_backward": "K9"}.get(name), 0),
            "max_abs_err": e, "ms": t, "ms_by": t.how, "call_ms": call,
            "plain_ms": plain, "bound_ms": bound_ms, "bound_by": bound_by,
            "share": bound_ms / t,
            "library_ms": None,  # no one PyTorch call computes any of them
        })
        fuzz_kernel = {"megakernel": "K2", "hybrid_island": "K3", "sample_scan": "K5",
                       "noise_uniform": "K6", "biquad_scan": "K7_biquad",
                       "one_pole_scan": "K7_one_pole"}.get(name)
        if fuzz_kernel:  # 18(a)'s graphs, by lowering
            kernels[-1]["fuzz_launches"] = {lw: n.get(fuzz_kernel, 0)
                                            for lw, n in fuzz["launches"].items()}
        if name == "biquad_seq":  # at the stream's width, 2 lanes
            kernels[-1].update(zip(("stream_ms", "stream_call_ms", "stream_plain_ms",
                                    "stream_bound_ms"), k1_stream))
        if name in ("sample_scan", "noise_uniform"):  # every kind and shape 3(b) timed
            kernels[-1]["at"] = {
                label: {"ms": k_ms, "ms_by": k_ms.how, "call_ms": k_call, "plain_ms": k_plain,
                        "bound_ms": bound(*k_work)[0], "share": bound(*k_work)[0] / k_ms}
                for label, (_, k_ms, k_call, k_plain, k_work)
                in new_kernels[f"{name}_at"].items()}
        if name in ("assoc_scan_backward", "sample_scan_backward"):  # every shape timed
            kernels[-1]["timed_at"] = (k7_label("cascade", 2 * B, 128, 3)
                                       if name == "assoc_scan_backward"
                                       else f"limiter f32[{B}, 128]")
            kernels[-1]["at"] = {
                label: {"ms": k_ms, "ms_by": k_ms.how, "call_ms": k_call, "plain_ms": k_plain,
                        "bound_ms": bound(*k_work)[0], "share": bound(*k_work)[0] / k_ms,
                        "max_abs_err": k_err}
                for label, (k_err, k_ms, k_call, k_plain, k_work)
                in grads["k8" if name == "assoc_scan_backward" else "k9"].items()}
        if name in ("biquad_scan", "one_pole_scan"):  # every shape 3(c) timed
            kinds = ("biquad ", "cascade ") if name == "biquad_scan" else ("one_pole ",)
            kernels[-1]["at"] = {
                label: {"ms": k_ms, "ms_by": k_ms.how, "call_ms": k_call, "plain_ms": k_plain,
                        "bound_ms": bound(*k_work)[0], "share": bound(*k_work)[0] / k_ms}
                for label, (_, k_ms, k_call, k_plain, k_work) in k7.items()
                if label.startswith(kinds)}
        f64 = f", {work[2] / 1e9:.3f} G at the f64 rate" if len(work) > 2 else ""
        log(f"{name}: {t:.4f} ms on the card, bound {bound_ms:.4f} ms by "
            f"{bound_by} ({work[0] / 1e9:.4f} GB, {work[1] / 1e9:.3f} G "
            f"operations at the f32 rate{f64}), {100 * bound_ms / t:.1f}% of the bound")
    log(f"chip_smoke: phases 1-20 in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(mesh_rank(sys.argv[2:]) if sys.argv[1:2] == ["--mesh-rank"] else main())
