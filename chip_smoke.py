"""Drive the PyTorch port (tinycarlo_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each of which exits non-zero on
any failed check:

1. device: requires CUDA; prints the card's name and power limit and the
   TF32 settings (both off).
2. build: compiles the port's CUDA kernels from tinycarlo_torch/ops/csrc
   with nvcc (one process per source, started together) and prints the
   build time and ptxas' report.
3. kernels: every rasterizer kernel against its plain PyTorch version on
   the card.
   The masks and rank kernels on random compaction bundles (t = 1, 2, 3;
   w = 48, 150, 160 and 640; h = 30, 100, 128 and 480; an env with nothing to draw;
   an oversubscribed budget) and on real bundles of the bench config's
   states, masks in uint8, float32 and bfloat16, rank also against
   rank_from_masks of the masks kernel. The exact kernel on random exact
   bundles (t = 2, 3, 5; 48x96, 128x160, 480x640; deep-clipped segments,
   the pinned swapped-edge segment, horizontal and vertical ties, an empty
   env, an oversubscribed budget) and on real bundles, uint8, float32 and
   bfloat16 (0/1).
   The frame, env and segment kernels (the older `compact_soa`,
   `compact_env_soa` and `compact_env_seg` layouts) on random bundles
   (t = 1, 2, 3; gran 8 and 16; 1, 2, 3 and 5 lane blocks; 30x200 to
   480x640; split and unsplit; odd and oversubscribed budgets; an empty
   env) and on edge bundles (every live slot in one layer, a budget
   counts[0] reaches, slots over 3-5 lane blocks at w = 300 and 640; the
   frame kernel on the same segments per (env, layer) frame).
   Bit-equality is required: the kernels are built with -fmad=false.
   3b. the front kernel (ops/csrc/front.cu): its bundle against the torch
   composition it replaces (`rasterize_kernels.front_plain`), all 8
   tensors bit for bit, on the benchmark's two configurations (4096
   simple_layout and 512 knuffingen spawn-table states), then each timed
   in a replayed CUDA graph (the kernel also eagerly, back to back)
   beside its bytes bound. Every later phase that counts render launches
   holds the front kernel's to one a fast-stroke render: as many as the
   masks and rank kernels' together (`check_front`).
   3c. the car kernel (ops/csrc/car.cu): every output of `env.step`'s
   per-car work against the torch composition it replaces
   (`env._car_work_plain`), bit for bit, on the same two configurations
   at the same batches: the spawn-table states and 40 steps from them
   (Stanley's steering plus noise past the action clamp, maneuvers
   cycling so that cars enter u-turns every step, wrapped on odd steps,
   finished cars respawned), then each timed in a replayed CUDA graph
   (the kernel also eagerly, back to back) beside its bound. Phases 7, 8
   and 9 hold its launches to their env.step calls (`check_car`).
4. probe kernels: the output-floor probes of benchmarks/exp_r2.py (K8
   ovl, K9 fill, K10 skip) against their plain versions, bit for bit, on
   outputs pre-filled with a sentinel: N = 1, 7 and 4096 envs; KK = 0, 1,
   64, 512 (values whose int32 -> uint8 cast wraps, values the chain
   carries past an integer, one only an unfused multiply and add leave
   below it); the flat (N, 800, 128)
   and (N, 5, 128, 160) uint8 and the float32 outputs at g = 1, 4, 16;
   odd-sized and misaligned outputs; live masks with an empty, a full
   and ragged layers.
5. rasterizer benchmark: tinycarlo_torch.benchmarks.rasterize_bench at
   full size, every layout mode once (each kernel mode launching its
   kernel once a render and each compaction mode none, every layout's
   masks with the same checksum, nothing dropped); then on each kernel
   mode's 4096-env bundle the kernel against its plain version, both
   timed, and its bound; the frame (`full`), env (`env`, `cur`) and
   segment (`seg`) kernels alone in back-to-back calls beside K9's fill
   and `fill_` of an output of their size (the store floor), as phase 7
   times the masks kernel.
6. probe modes: the same benchmark's probe modes ovl0 ovl64 ovl512
   dmaflat dmaflat16 dmaf32 dma dma4 dskip dskipall at 4096 envs: one
   launch an iteration, each checksum equal to the one its values give
   (ovl's values i + 0.9999 cross i + 1 only through the chain), ovl's
   time growing with KK and ovl512's no faster than its operations bound
   (its 16384 multiply-add chains per env are not folded; a multiply and
   an add rounded apart are two instructions, bounded at the float32
   instruction rate); per mode the
   kernel's and its library call's time (back-to-back calls), its plain
   version's and its bound (the benchmark's); dskip's live share.
7. main path (classes): bench.py's workload through the port's entry
   points -- make_env_params, vector.reset(4096), the segment-overflow
   guard, then the bench body of tinycarlo_torch.benchmarks.bench
   (vector.step with Stanley actions and max_episode_steps=1000, the
   observation rendered every step and consumed by a checksum), eagerly.
   The masks kernel's launch count, and the front kernel's, must equal
   the renders, and the car kernel's the env.step calls. Reports env-steps/s (median of repeats, with spread) and
   per-stage ms (the front kernel, which runs the projection and the
   compaction, beside its plain version, the torch composition), the
   kernel alone also in back-to-back calls beside K9's fill and `fill_`
   of an output of its size (the store floor); then the last
   observation against the plain version on the same states and a small
   rollout against the port on the CPU.
8. bench (CUDA graph): tinycarlo_torch.benchmarks.bench at 4096 envs, its
   step captured once and replayed BENCH_CHUNK (400) times a repeat: its
   JSON line (bench.py's keys and `device`) and every repeat's rate in
   the order the repeats ran, each with the card's SM clock, memory
   clock, power draw and temperature read after it, the front, masks and
   car kernels launched once each during capture, a profiler trace of
   TRACED (20) replays holding one front, one masks and one car kernel
   record a step and no sort kernel (and the device's idle share),
   then once the host's ms per replay call (replays enqueued while a spin
   kernel holds the card), and 8
   replayed steps equal bit for bit to 8 eager steps from the same state
   and generator seed, with respawns every 3 steps (the replays draw the
   eager steps' rows and advance the generator as far).
9. exact classes: the same workload with camera.stroke: exact (cv2's
   ThickLine stroke, the exact kernel): env-steps/s, per-stage ms, the
   device idle share and peak memory; the exact kernel alone and in
   back-to-back calls beside its float32 output and the store floor,
   as phase 7 times the masks kernel; exact-kernel launches equal to the
   renders, car-kernel launches to the steps, and no masks-kernel launch; a small rollout against the CPU
   port (frames equal wherever the two devices' exact bundles are); and a
   sample of the card's exact frames against the port's
   pure-Python cv2 oracle (`thick_stroke_mask_ref`), segment by segment.
10. serving (rgb): the bundled pretrained combo (models.load_pretrained)
   through the port's `train.evaluate` on examples/config_simple_layout.yaml,
   whose rgb frames come from the rank kernel; evaluate's rollout replays
   a captured CUDA graph of its step, so launches count the eager steps
   and captures (the replays apart), and an eager run's rate is printed
   beside the graph's:
   a. the example's protocol (examples/benchmark_tinycar_net.py:92-98):
      maneuvers 0, 1, 2, 5 episodes of 1000 steps, seed 10, one worker
      process per maneuver; each cte_avg must be finite and below 0.02 m
      (steps are cut, and the cut printed, if a maneuver would take over
      ~30 s);
   b. 4096 episodes of 100 steps, repeated: env-steps/s with the policy,
      per-stage ms, the device idle share and the peak memory; the rank
      kernel's launch count must equal the renders; the rank kernel alone
      and in back-to-back calls beside K9's fill and `fill_` of its
      output's size (the store floor);
   c. 8 envs x 20 combo-driven steps on the card and on the CPU port.
11. exact serving: the same config with camera.stroke: exact, frames from
   the exact kernel's masks (the rank kernel is not launched):
   a. benchmarks/policy_parity.py's protocol through its port's
      `our_eval` (tinycarlo_torch.benchmarks.policy_parity): maneuvers 0,
      1, 2, 4 sequential episodes of 500 steps, one worker process per
      maneuver (cut, and the cut printed, if a maneuver would take over
      ~90 s); each cte_avg below 0.02 m;
   b. 4096 episodes of 100 steps, 3 repeats: env-steps/s, launches equal
      to the renders, the device idle share;
   c. 8 envs x 20 combo-driven steps on the card and on the CPU port
      (frames equal wherever the two devices' exact bundles are).
12. 480x640: the masks, rank and exact kernels (the exact kernel also in
   float32) on random 512-env bundles at BASELINE config 3's frame size
   and batch, each equal to its plain version and alone (CUDA events,
   median of 20) beside its bound and the store floor.
13. gym shim: the Gymnasium entry point (gym_env.TinyCarloEnv, B = 1) on
   tinycarlo_torch.benchmarks.gym_bench's configs (BASELINE config 1,
   64x64 classes; examples/config_simple_layout.yaml, rgb 128x160) and
   config 1 under `camera.stroke: exact`: the masks, rank or exact kernel
   held bit for bit against its plain version on the bundles of the
   shim's own states after 6 steps, each step's observation equal to the
   plain frame; 200 steps of random actions through the replayed CUDA
   graph, eagerly on the card and on the CPU (the exact stroke: 50
   through the graph), each with its steps/s and ms a step, the
   wrappers' launch counts equal to the eager renders plus the capture
   (a replay passes no wrapper); a trace of 20 replayed steps with one
   render-kernel record a step (kernel records and device time a step,
   idle share); 20 replayed steps equal bit for bit to 20 eager steps;
   30 steps on the card against the CPU shim (positions within 1e-4,
   under 0.5% of pixels); the five-wrapper stack and
   NoiseObservationWrapper for 100 steps.
14. TD3 (BASELINE config 4, the trainer's fused chunk as replayed CUDA
   graphs; train/td3_loop.py):
   b. tinycarlo_torch.benchmarks.td3_bench at 1024 and 64 envs in
      bfloat16 and at 1024 in float32 (200-step chunks, the protocol cut
      to 1 warm, 2 timed and 2 pipelined chunks and a traced 20-step
      chunk): each JSON line; the masks kernel launched once per eager
      step and capture (the replays counted apart) and recorded once a
      step in the trace; finite, nonzero losses; the buffer's fill; the
      actor moved;
   a. on the 1024-env chunk's own bundles and on random bundles at w = 48,
      150 and 640, the masks kernel in uint8, float32 and bfloat16 and the
      exact kernel in the same three, bit-equal to their plain versions;
      the bfloat16 masks kernel alone and back to back beside K9's fill
      and fill_ of its 209.7 MB output, and its bound;
   c. with deterministic algorithms on (td3_replays' docstring): a
      replayed collect-only step and two steady policy_delay units equal
      bit for bit to the same steps run eagerly;
   e. a checkpoint restored into a fresh loop gives the same next chunk
      bit for bit;
   f. evaluate through the rollout graph equal to the eager rollout, 8
      envs x 20 steps;
   d. 8 envs x 12 steps of the chunk on the card against the CPU port
      with the same injected draws: positions within 1e-4 m, losses
      within a relative 1e-3.
15. imitation learning (train/il.py at the IL example's full width:
   examples/config_simple_layout.yaml, rgb 128x160, 16 envs, 128-step
   chunks, skip_steps 2, batch 32, the combo at 3x128x160, camera DR on):
   a. three collection chunks (maneuvers 0, 1, 2) through the collector's
      replayed graph and one eagerly, each with its samples/s, and one
      classes chunk (bench.py's config) through the graph; rank- and
      masks-kernel launches equal to the eager renders plus the captures
      (the replays counted apart); a replayed unit's device time and idle
      share from a trace; the rank kernel bit-equal to its plain version
      on the chunk's own bundles;
   b. train_chunk of 500 steps, twice, on the collected data with
      maneuver-balanced batches: steps/s and each chunk's mean loss,
      finite and falling; the device time of a replayed step and its top
      kernels from a trace;
   c. with deterministic algorithms on, 4 replayed train steps equal bit
      for bit to 4 eager steps from the same state and indices,
      parameters, BatchNorm buffers and Adam state included;
   d. one DAgger chunk at 16 envs: samples/s, rank launches, labels
      finite and not constant;
   e. save_variables_npz -> load_variables_npz -> a fresh combo whose eval
      outputs on a batch are equal bit for bit;
   f. 4 envs x 16 collection steps on the card against the CPU port with
      the same injected draws: positions within 1e-4 m, labels within
      1e-4, under 0.5% of pixels differing;
   g. the trained combo through `evaluate`, maneuver 0, 200 steps: a
      finite cte_avg.
16. the LanelineGrid (MapConfig.query_grid): on knuffingen (ppm 150) and
   simple_layout, `car.car_info` through the grid equal to the full scan
   bit for bit at 4096 float32 positions fuzzed over the grid's domain
   (an eighth on cell corners); both branches timed at 4096 envs (CUDA
   events, median of 7) with the cell count and the candidates a cell;
   one classes bench step at 4096 envs equal with the grid on and off.
17. scale-out (parallel/): 4 ranks share the one card (NCCL takes one
   rank per card, so the backend is asked for explicitly: gloo, which
   carries CUDA tensors through the host), spawned processes joined
   through a FileStore on a (data 2 x model 2) mesh; the backend and
   world size printed first:
   a. the SP renderer (`parallel.sp.render_observation_batch_sp`,
      data-sharded) on bench.py's classes states, the example yaml's rgb
      frames as the rank map, and config 1 under the exact stroke, 4096
      envs: each rank's K1, K3 or K4 launch on its edge shard's bundle
      equal to the plain version, each composed frame equal to the
      unsharded render, each render's seconds;
   b. the DP x TP x SP TD3 chunk (BASELINE config 5's composition) of
      config 4's yaml and nets at 1024 envs, 20 eager steps, the replay
      cut to 8192 slots: the first step's frames equal to the
      single-process chunk's on the same card (hashes by data rows), the
      outputs within SCALE_TOL of it, env-steps/s and each rank's peak
      memory (functional numbers: ranks on one card, collectives through
      the host; not a scaling result).
   The kernels' launches on (a) and (b), summed over the ranks, go into
   their entries as `launches_sp`; the front kernel's launches on the
   fast stroke's shards.
18. host tools (the digital twin, real_world.TinyCarloRealWorldEnv, on
   the loopback backend; viz; the examples):
   a. the twin on examples/config_simple_layout.yaml (rgb 128x160) and on
      bench.py's classes config: the rank or masks kernel bit-equal to its
      plain version on the twin's own B = 1 bundles of 3 steps, each
      step's observation the plain frame; on the rgb config 300
      Stanley-steered steps (examples/stanley_control.py's k = 4, speed
      0.4) through the replayed CUDA graph and eagerly, each with its
      steps/s, the rank launches equal to the eager renders plus the
      capture, and a trace of TRACED replays with one rank-kernel record a
      step; on both configs 50 steps on the card against the CPU port
      with the same actions: positions equal, cte within 1e-5, under 0.5%
      of the pixels differing;
   b. an AutosysCar stranded 8 cm off the lanepath with no history, its
      transport and tracker faked, driving back on the guidance of the
      twin's state on the card: iterations and seconds, within 0.02 m of
      cte and 20 degrees at the end;
   c. viz.render_overview of the twin's state on the card equal bit for
      bit to the same pose drawn through the CPU port;
   d. the examples' main() in this process: train_td3 at 64 envs (2
      chunks of 100 steps, its env-steps/s, a 5 x 200-step evaluation of
      one maneuver), stanley_control --batch 4096 for 20 steps,
      benchmark_tinycar_net for one maneuver of 100 steps (cte_avg below
      0.02 m), render_map to a temporary PNG.
   The front, masks and rank kernels' launches on these paths (each
   count set to 0 before a path and read after it; the plain checks
   apart) go into their entries as `launches_host`.
19. measurement scripts (tinycarlo_torch.benchmarks):
   a. BASELINE config 3 uncut (`baseline_configs.measure3`: knuffingen,
      480x640, 512 envs, maneuver (i + env) % 4, 100-step chunks, a warm
      chunk and 5 timed), classes (K1) and rank (K3): the JSON line, the
      overflow count as measured, the render kernel launched once a warm-up
      step and once at capture, the kernel bit-equal to its plain version
      on the run's bundles after its chunks and timed alone, a trace of
      TRACED replays with one render-kernel record a step (device ms, idle
      share), the parts' ms (render, vector.step, the u-turn re-snap's
      scan), 8 replayed steps equal bit for bit to 8 eager steps with
      u-turn entries and respawns, and 8 envs x 10 steps at 480x640 on
      the card against the CPU port (positions within 1e-4 m, under 0.5%
      of pixels differing);
   b. at their full size: step_decomp (all seven modes), profile_step
      (4096 envs, one masks record a step or it raises), profile_td3 (64
      envs, uint8; the kernels, the device rate and the stages of an
      eager chunk), exp_r4_rgb (all eight probes) and exp_r3c (unroll:
      1-, 2- and 4-step graphs, each recording as many masks launches;
      fill), each printed with its seconds.
20. training to a policy, through the examples' main() (the JAX
   package's documented runs, docs/TRAINING.md):
   a. the round-5 IL run uncut (train_stanley_il --samples 30000 --steps
      15000 --chunk-steps 512 --balance --m2x 2 --no-dr; the yaml, rgb
      128x160, 16 envs), its dataset and model in a temporary directory:
      the per-maneuver split equal to the JAX run's [8192, 8192, 13616],
      samples/s, train steps/s, and the 3 x 5 x 1000-step evaluation
      beside the JAX run's; each cte_avg below 0.02 m;
   b. the 1024-env TD3 time-to-policy command (train_td3 --envs 1024
      --steps 100 --updates 4 --episodes 60) over (a)'s combo, cut to
      TRAIN_CHUNKS chunks: the IL-trained combo loaded, the replay full
      (100 000) after the first chunk, finite critic and actor losses,
      every env's sigma equal to 0.4 * max(0, 1 - e / 60) at its episode
      count e, each chunk's env-steps/s, the graphs by kind with their
      replays, and a 5 x 200-step evaluation of maneuver 0 (printed).
   The rank and front kernels' launches on (a) and (b) (their counts set
   to 0 before each and read after) go into their entries as
   `launches_train`.
21. results: the `kernels` JSON line (K1-K10 and the front kernel, whose
   entry gives phase 7's launches and phase 3b's times on simple_layout;
   the car kernel, whose entry gives phase 7's launches, phase 3c's times
   on simple_layout and phase 8's and 9's launches, `launches_graph` and
   `launches_exact`;
   the masks, rank and front kernels' entries also give their launches
   on the IL phase's paths, `launches_il`, on phase 18's,
   `launches_host`, and on config 3's (19a), `launches_b3`, the rank and
   front kernels' on phase 20's, `launches_train`, and the masks, rank,
   exact and front kernels' on phase 17's, `launches_sp`), the card line
   and, last, the `ok` JSON line.

Every phase prints its seconds.

Every time is measured on the card in this run (CUDA events, or host
clocks around work that ends in torch.cuda.synchronize()).
"""
import dataclasses
import json
import math
import multiprocessing
import os
import queue
import statistics
import sys
import time

# bit-repeatable cuBLAS products across streams (phase 14 compares replayed
# graphs with eager steps under deterministic algorithms); read at cuBLAS's
# first call, so set before torch starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

# the card's line and the bounds' peaks and rule, shared with the port's
# benchmarks (an ImportError here: run from the root of a checkout)
from tinycarlo_torch.utils.helper import (PEAK_F32_INSTR_PER_S,
                                          PEAK_F32_PER_S, PEAK_I32_PER_S,
                                          bound, card_line)

REPO = os.path.dirname(os.path.abspath(__file__))

# bench.py's CONFIG (bench.py:31-59): simple_layout, classes masks at
# 128x160, line_thickness 2.
CONFIG = {
    "sim": {"fps": 30, "observation_space_format": "classes"},
    "car": {
        "wheelbase": 0.0487,
        "track_width": 0.027,
        "max_velocity": 0.15,
        "max_steering_angle": 30,
        "steering_speed": 30,
        "max_acceleration": 0.1,
        "max_deceleration": 1.0,
    },
    "camera": {
        "position": [0.0, -0.005, 0.04],
        "orientation": [22, 0, 0],
        "resolution": [128, 160],
        "fov": 80,
        "max_range": 0.5,
        "line_thickness": 2,
    },
    "map": {
        "json_path": os.path.join(REPO, "examples/maps/simple_layout.json"),
        "pixel_per_meter": 450,
    },
}
N_ENVS = 4096
CHUNK = 100  # steps per timed repeat
# the repeats of each eager path, cut (exact classes from 5 in PR 12) so
# that the whole run fits its time
FAST_REPEATS = 3
WARMUP = 10
# replays of the bench's graph in its profiler trace
TRACED = 20
SPEED, K = 0.5, 5.0  # bench.py:64

# the serving path: the example's config and protocol
# (examples/benchmark_tinycar_net.py:53-98) and the batched run
SERVE_CONFIG = os.path.join(REPO, "examples/config_simple_layout.yaml")
SERVE_STEPS, SERVE_EPISODES, SERVE_SEED = 1000, 5, 10
# a maneuver's time before the protocol's steps are cut (the maneuvers
# run in parallel processes)
SERVE_BUDGET_S = 30.0
# the exact serving protocol (benchmarks/policy_parity.py:131-133, run
# with --stroke exact): sequential episodes, as the reference's evaluate
EXACT_SERVE_STEPS, EXACT_SERVE_EPISODES = 500, 4
# at B = 1 the exact step is host-bound (~34 ms on the H100 machine's
# host): 4 x 500 steps take ~70 s a maneuver
EXACT_SERVE_BUDGET_S = 90.0
# cte_avg of the bundled combo: 0.0064 / 0.0092 / 0.0096 m in the JAX
# package's records, untrained inits 0.026-0.035 m (docs/TRAINING.md)
CTE_LIMIT = 0.02
# card against CPU port, 8 envs x 20 closed-loop steps: on equal frames the
# float32 combo forwards (TF32 off) agree to rounding; where a frame differs
# in a stroke-boundary pixel, the steering may move by up to ~4e-3
STEER_ATOL = 1e-5
STEER_ATOL_MOVED = 2e-2
# envs of the exact main path's last frames held against the cv2 oracle
ORACLE_ENVS = 16

# float32 operations the masks kernel spends per evaluated pixel
# (masks.cu window_hit). Split stroke: apx, apy, tu 4, clip 2, dx 2, dy 2,
# d2 3, the tu range test 2, the d2 compare 1. Bresenham (t=1): apx, apy,
# |aby|, sign, major test, max, min, step 2, num 4, floor quotient 2,
# residual 3, its corrections 4, probe, target 2, range and match tests 3,
# the point test 1.
OPS_PER_PIXEL = {"split": 18, "bres": 29}
# int32 operations of the exact stamp (exact.cu `ExactCopies::stamp`) that
# the function needs, each counted where it must be done: once per box row
# if it depends on the row, once per box column if on the column, once per
# copy if only on the copy's flags (see exact_bytes_and_ops). A lit pixel
# of the fill span, a cap, a y-major edge or a far dot follows from its
# row's values and costs only its store (the bytes); a pixel of an x-major
# edge from its column's.
# Per row: the fill span's ya, each chain's row test, offset and
# multiply-add (4), min, max, two rounding adds and shifts, the ymin/ystop
# tests and their and (20); each cap's |yi - cy| (2), table bound and read,
# the span's two ends (6); each accepted edge's far-dot row compare (1)
# and, y-major, its k, multiply, add, shift, two range tests and and (7).
EXACT_ROW_OPS = {"fill": 20, "cap": 6, "far": 1, "x_major": 0,
                 "y_major": 7}
# Per column: each accepted x-major edge's k, multiply, add, shift, two
# range tests, two row compares and their ands (10).
EXACT_COLUMN_OPS = {"fill": 0, "cap": 0, "far": 0, "x_major": 10,
                    "y_major": 0}
# Per copy: the fill flag test, each edge's accept and major bits (shift,
# and each).
EXACT_COPY_OPS = 1 + 4 * 4


class CheckFailed(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def cuda_ms(fn, repeats=7, warmup=2):
    """Median milliseconds of fn() on the current stream, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def back_to_back_ms(fns, calls=30, rounds=6):
    """{name: median ms per call} of each fn over `rounds` runs of `calls`
    back-to-back calls between two CUDA events, the fns taken in turns
    (forward, then backward), so that the card runs each as a stream of
    launches and in the same conditions as the others."""
    import torch

    times = {name: [] for name in fns}
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            fns[name]()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fns[name]()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / calls)
    return {name: statistics.median(v) for name, v in times.items()}


def graph_ms(fn, calls=30, replays=5):
    """Median ms per call of fn() in a replayed CUDA graph of `calls`
    calls (`graphs.warm_up`, then `graphs.capture`), CUDA events around
    each replay: the device's time without the host's launch path."""
    import torch

    from tinycarlo_torch.utils import graphs

    graphs.warm_up(fn)
    graph = graphs.capture(lambda: [fn() for _ in range(calls)])
    graph.replay()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


class PhaseClock:
    """Prints each phase's seconds as it ends."""

    def __init__(self):
        self.start = time.perf_counter()

    def done(self, name):
        now = time.perf_counter()
        print(f"{name}: {now - self.start:.1f} s")
        self.start = now


def with_stroke(params, stroke):
    """The same EnvParams with camera.stroke replaced."""
    cfg = params.cfg
    return dataclasses.replace(params, cfg=dataclasses.replace(
        cfg, camera=dataclasses.replace(cfg.camera, stroke=stroke)))


def segments(seed, b, e, h, w, dev, n_layers=5, deep=False):
    """Numpy-seeded segments on `dev`; env 0 draws nothing. With `deep`,
    half of them are deep-clipped (~400 px off frame), the first edge of
    every env is the pinned segment (150, -151) -> (-378, 406) whose
    direction-swapped clipped outline edge needs its far dot, and edges
    1-3 and 4-6 are horizontal and vertical (ties of the quad's top
    vertex)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    u0 = rng.uniform(-40, w + 40, (b, e))
    v0 = rng.uniform(-40, h + 40, (b, e))
    u1 = u0 + rng.uniform(-90, 90, (b, e))
    v1 = v0 + rng.uniform(-60, 60, (b, e))
    draw = rng.random((b, e)) < 0.7
    if deep:
        far = rng.random((b, e)) < 0.5
        u0, v0, u1, v1 = (np.where(far, rng.uniform(-400, s + 400, (b, e)), x)
                          for s, x in zip((w, h, w, h), (u0, v0, u1, v1)))
        v1[:, 1:4] = v0[:, 1:4]
        u1[:, 4:7] = u0[:, 4:7]
        u0[:, 0], v0[:, 0], u1[:, 0], v1[:, 0] = 150.0, -151.0, -378.0, 406.0
        draw[:, :7] = True
    draw[0] = False
    lay = np.sort(rng.integers(0, n_layers, e)).astype(np.int32)
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa
    return (f(u0), f(v0), f(u1), f(v1), torch.tensor(draw, device=dev),
            torch.tensor(lay, device=dev))


def random_bundle(rk, seed, b, e, h, w, t, k_per_block, dev, n_layers=5,
                  exact=False):
    """The fast (or with `exact` the exact) compaction bundle on `dev` of
    `segments`."""
    u0, v0, u1, v1, draw, lay = segments(seed, b, e, h, w, dev, n_layers,
                                         deep=exact)
    compact = rk.compact_env_exact_soa if exact else rk.compact_env_idx_soa
    return compact(
        u0, v0, u1, v1, draw, k_per_block * rk._n_xblocks(w), h, t,
        edge_layer=lay, n_layers=n_layers, w=w,
    )


def kernel_pair(rk, params):
    """(compaction, kernel, plain version, kernel symbol) of the classes
    render under the params' stroke."""
    from tinycarlo_torch.ops import rasterize as ras

    cam = params.cfg.camera
    if ras._exact(cam.line_thickness, cam.stroke):
        return (rk.compact_env_exact_soa, rk.exact_kernel,
                rk.rasterize_masks_exact_env_plain, "exact_kernel")
    return (rk.compact_env_idx_soa, rk.masks_kernel,
            rk.rasterize_masks_env_plain, "masks_kernel")


def kernel_vs_plain(kernel, plain, bundle, n_layers, res, t):
    """Max |kernel - plain| over uint8, float32 and bfloat16 outputs (0
    expected); a float output must read exactly 0/1."""
    import torch

    err = 0.0
    for dt in (torch.uint8, torch.float32, torch.bfloat16):
        got = kernel(bundle, n_layers, res, t, out_dtype=dt)
        want = plain(bundle, n_layers, res, t, out_dtype=dt)
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"kernel output {got.shape} {got.dtype} != {want.shape}")
        e = (got.float() - want.float()).abs().max().item()
        check(e == 0.0, f"{kernel.NAME} kernel differs from its plain "
              f"version by {e} at t={t}, {res}, {dt}")
        if dt != torch.uint8:
            check(bool(((got == 0) | (got == 1)).all()),
                  f"{kernel.NAME} kernel's {dt} output is not 0/1")
        err = max(err, e)
    return err


def live_copies(rk, idx, bw, counts, res):
    """(env, copy, nb, frame, b0, xb) of the bundle's live slots."""
    import torch

    n_bands, hp, win, nxb, wb = rk._frame_geometry(res)
    k = idx.shape[1] - 7
    live = torch.arange(k, device=idx.device)[None] < counts[0][:, None]
    env, slot = torch.nonzero(live, as_tuple=True)
    e = idx[env, slot].long()
    word = bw[env, e]
    rowband = word >> 9
    frame = rowband // n_bands
    return env, e, word & 511, frame, rowband - frame * n_bands, frame % nxb


def box_extent(rk, res, x0, y0, x1, y1, r, nb, b0, xb, gran=16, split=True):
    """(columns, rows) of each live copy's segment bounding box, padded by
    the stroke radius r and clipped to the copy's stamped bands (of `gran`
    rows) and to the frame or its lane block (0 for a copy with no band):
    the only pixels the copy can light. The masks kernel's own box
    (`rk.copy_box` at `rk.box_pad(t)`) adds a one-pixel margin."""
    xlo, xhi, ylo, yhi = rk.copy_box(x0, y0, x1, y1, r, nb, b0, xb, res,
                                     gran, split)
    live = (nb > 0).double()
    return (xhi - xlo).double() * live, (yhi - ylo).double() * live


def bundle_bytes_and_ops(rk, bundle, res, t, out_bytes):
    """The least work of the masks or rank kernel over this bundle: the
    bytes it must move (the counts rows, the live slots' idx entries and
    their copies' six SoA entries read once, the output written once) and
    the float32 operations of the stamp over `box_extent`'s pixels. Pixels
    outside those boxes cannot be lit, so a kernel need not evaluate them
    (the masks kernel tests each box with a one-pixel margin; the rank
    kernel evaluates the whole window)."""
    idx, ax, ay, abx, aby, inv, bw, counts = bundle
    _, hp, _, _, _ = rk._frame_geometry(res)
    env, e, nb, frame, b0, xb = live_copies(rk, idx, bw, counts, res)
    stroke = rk._stroke_params(t)
    r = 0.0 if stroke[0] == "bres" else max(stroke[1], stroke[2]) ** 0.5
    x0, y0 = ax[env, e], ay[env, e] - (frame * hp).float()
    cols, rows = box_extent(rk, res, x0, y0, x0 + abx[env, e],
                            y0 + aby[env, e], r, nb, b0, xb)
    pixels = int((cols * rows).sum().item())
    n_in = counts.numel() * 4 + int(env.numel()) * (4 + 6 * 4)
    return n_in + out_bytes, pixels * OPS_PER_PIXEL[stroke[0]]


def exact_bytes_and_ops(rk, bundle, res, t, out_bytes):
    """The least work of the exact kernel over this bundle: bytes of the
    counts rows, the live slots' idx entries and their copies' 30 int32
    fields read once and the output written once; int32 operations of the
    exact stamp over `box_extent`, the boxes spanning the clipped integer
    endpoints (the cap fields) padded by the stroke's extent -- per box
    row, per box column and per copy as EXACT_ROW_OPS, EXACT_COLUMN_OPS and
    EXACT_COPY_OPS count them, for the parts each copy's flags switch on
    (the fill span, each accepted ring edge as x- or y-major; both caps)."""
    import torch

    from tinycarlo_torch.ops.cv2_stroke import stroke_y_extent

    idx, fields, counts = bundle
    _, hp, _, _, _ = rk._frame_geometry(res)
    env, e, nb, frame, b0, xb = live_copies(rk, idx, fields[-1], counts, res)
    ends = []
    for c in (22, 23):
        cx, cy = rk._unpack16(fields[c][env, e])
        ends += [cx.float(), (cy - frame * hp).float()]
    cols, rows = box_extent(rk, res, *ends, stroke_y_extent(t), nb, b0, xb)
    flags = fields[28][env, e].long()

    def per_copy(ops):
        n = (flags & 1) * ops["fill"] + 2 * ops["cap"]
        for i in range(4):
            accepted = (flags >> (1 + i)) & 1
            x_major = (flags >> (5 + i)) & 1
            n = n + accepted * (ops["far"] + torch.where(
                x_major == 1, ops["x_major"], ops["y_major"]))
        return n.double()

    n_ops = (cols * per_copy(EXACT_COLUMN_OPS)
             + rows * per_copy(EXACT_ROW_OPS)
             + (rows > 0) * EXACT_COPY_OPS).sum().item()
    n_in = counts.numel() * 4 + int(env.numel()) * (4 + rk.EXACT_FIELDS * 4)
    return n_in + out_bytes, int(n_ops)


def soa_bytes_and_ops(rk, mode, soa, res, t, gran, split, out_bytes):
    """The least work of the frame, env or segment kernel (`mode` "full",
    "env"/"cur" or "seg" of the rasterizer benchmark) over its bundle, as
    bundle_bytes_and_ops counts it: bytes of the counts, the live slots'
    SoA entries (and idx entries) read once and the output written once;
    float32 operations of the stamp over each live stamp's `box_extent`
    (one per touched lane block of a segment slot)."""
    import torch

    n_bands, hp, win, nxb, wb = rk._frame_geometry(res, gran, split)
    stroke = rk._stroke_params(t)
    r = 0.0 if stroke[0] == "bres" else max(stroke[1], stroke[2]) ** 0.5
    if mode == "seg":
        idx, ax, ay, abx, aby, inv, bw, counts = soa
        k = idx.shape[1] - 7
        env, s = torch.nonzero(torch.arange(k, device=idx.device)[None]
                               < counts[0][:, None], as_tuple=True)
        e = idx[env, s].long()
        word = bw[env, e]
        nb = (word >> nxb) & 511
        enc = (word >> nxb) >> 9
        lay = enc // (nxb * n_bands)
        blocks = torch.arange(nxb, device=idx.device)
        c, xb = torch.nonzero((((word[:, None] >> blocks) & 1) == 1)
                              & (nb[:, None] > 0), as_tuple=True)
        env, e, nb, lay = env[c], e[c], nb[c], lay[c]
        b0 = enc[c] - lay * nxb * n_bands
        x0 = ax[env, e] - (xb * rk._XB).float()
        y0 = ay[env, e] - (lay * nxb * hp).float()
        n_in = counts.numel() * 4 + int(s.numel()) * (4 + 6 * 4)
    else:
        *arrays, counts = soa
        # (B*L, k) frames of compact_soa, (B, k) envs of compact_env_soa
        ax, ay, abx, aby, inv, bw = (x.reshape(-1, x.shape[-1])
                                     for x in arrays)
        k = ax.shape[1]
        f, s = torch.nonzero(
            (torch.arange(k, device=ax.device)[None] < counts[0][:, None])
            & ((bw & 511) > 0), as_tuple=True)
        word = bw[f, s]
        nb = word & 511
        frame = (word >> 9) // n_bands
        b0 = (word >> 9) - frame * n_bands
        xb = frame % nxb
        env, e = f, s
        x0 = ax[f, s]
        y0 = ay[f, s] - (frame * hp).float()
        n_in = counts.numel() * 4 + int(f.numel()) * 6 * 4
    cols, rows = box_extent(rk, res, x0, y0, x0 + abx[env, e],
                            y0 + aby[env, e], r, nb, b0, xb, gran, split)
    pixels = int((cols * rows).sum().item())
    return n_in + out_bytes, pixels * OPS_PER_PIXEL[stroke[0]]


def main():
    import torch

    # ---- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's path runs on a GPU",
              file=sys.stderr)
        return 1
    start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    from tinycarlo_torch import env as fenv
    from tinycarlo_torch import vector
    from tinycarlo_torch.ops import probe_kernels as pk
    from tinycarlo_torch.ops import rasterize as ras
    from tinycarlo_torch.ops import rasterize_kernels as rk
    from tinycarlo_torch.ops._build import libraries
    from tinycarlo_torch.train.stanley import stanley_steering

    clock = PhaseClock()

    # ---- 2. build ----------------------------------------------------------
    libraries.build()
    print(f"build: {libraries.build_seconds:.2f} s "
          f"({', '.join(sorted(libraries.build_log)) or 'cached'})")
    for src, log in sorted(libraries.build_log.items()):
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")
    clock.done("build")

    # ---- 3. kernels against their plain versions ---------------------------
    params = fenv.make_env_params(CONFIG)
    params_exact = with_stroke(params, "exact")
    max_err, rank_err = check_kernels(rk, ras, fenv, vector, params, "cuda")
    exact_err = check_exact_kernels(rk, fenv, vector, params_exact, "cuda")
    soa_errs = check_soa_kernels(rk, "cuda")
    clock.done("kernels")
    front_times = front_phase(card, rk, fenv)
    clock.done("front kernel")
    car_times = car_phase(card, fenv, stanley_steering)
    clock.done("car kernel")

    # ---- 4. probe kernels against their plain versions ---------------------
    probe_errs = check_probe_kernels(pk, "cuda")
    clock.done("probe kernels")

    # ---- 5. rasterizer benchmark --------------------------------------------
    from tinycarlo_torch.benchmarks import rasterize_bench as rb

    inputs = rb.Inputs("cuda")
    soa_entries = rasterizer_bench(card, rk, soa_errs, inputs)
    clock.done("rasterizer benchmark")

    # ---- 6. probe modes -------------------------------------------------------
    probe_entries = probe_modes(card, pk, inputs, probe_errs)
    del inputs
    clock.done("probe modes")

    # ---- 7. main path --------------------------------------------------------
    kernels = [classes_path(card, rk, fenv, vector, stanley_steering, params,
                            max_err, FAST_REPEATS)]
    main_run = kernels[0].pop("run")
    front = front_entry(front_times, main_run["front_launches"])
    car = car_entry(car_times, main_run["car_launches"])
    clock.done("main path")

    # ---- 8. bench, replayed as a CUDA graph ----------------------------------
    car["launches_graph"] = graph_bench(card, rk)
    clock.done("bench (CUDA graph)")

    # ---- 9. exact classes ----------------------------------------------------
    exact_entry = classes_path(card, rk, fenv, vector, stanley_steering,
                               params_exact, exact_err, FAST_REPEATS)
    exact_run = exact_entry.pop("run")
    car["launches_exact"] = exact_run["car_launches"]
    check_exact_oracle(fenv, rk, params_exact, exact_run)
    clock.done("exact classes")

    # ---- 10, 11. serving, fast and exact -------------------------------------
    # the protocols' three maneuvers run at once, one worker process each:
    # at B = 1 or 5 a step is host-bound
    with multiprocessing.get_context("spawn").Pool(
            3, initializer=protocol_worker_init) as pool:
        kernels.append(serve(card, rank_err, pool))
        clock.done("serving")
        kernels.append(exact_entry)
        serve_exact(card, pool)
        clock.done("exact serving")
    kernels += [front, car] + soa_entries + probe_entries

    # ---- 12. the masks, rank and exact kernels at 480x640 -------------------
    kernels_480x640(card, rk)
    clock.done("480x640 kernels")

    # ---- 13. the Gymnasium shim ----------------------------------------------
    gym_shim(card, rk)
    clock.done("gym shim")

    # ---- 14. TD3 ---------------------------------------------------------------
    td3_phase(card, rk)
    clock.done("td3")

    # ---- 15. imitation learning -------------------------------------------------
    il_launches = il_phase(card, rk, ras)
    for entry in kernels:
        if entry["name"] in il_launches:
            entry["launches_il"] = il_launches[entry["name"]]
    clock.done("imitation learning")

    # ---- 16. the LanelineGrid query -------------------------------------------
    grid_phase(card)
    clock.done("grid")

    # ---- 17. scale-out: ranks on the one card ----------------------------------
    sp_launches = scaleout_phase(card)
    for entry in kernels:
        if entry["name"] in sp_launches:
            entry["launches_sp"] = sp_launches[entry["name"]]
    for kernel_name in ("masks", "rank", "exact", "front"):
        check(sp_launches.get(kernel_name, 0) > 0,
              f"scale-out: the {kernel_name} kernel was not launched")
    clock.done("scale-out")

    # ---- 18. the host tools: the twin, the overview, the examples --------------
    host_launches = host_tools_phase(card, rk, ras)
    for entry in kernels:
        if entry["name"] in ("masks", "rank", "front"):
            entry["launches_host"] = host_launches[entry["name"]]
    clock.done("host tools")

    # ---- 19. the measurement scripts: BASELINE config 3, the profiles -------
    b3_launches, b3_ms = measurement_scripts(card, rk, ras)
    for entry in kernels:
        if entry["name"] in ("masks", "rank", "front"):
            entry["launches_b3"] = b3_launches.get(entry["name"], 0)
    for kernel_name in ("masks", "rank", "front"):
        check(b3_launches.get(kernel_name, 0) > 0, f"config 3: the "
              f"{kernel_name} kernel was not launched")
    print("config 3 kernels at 480x640 on the run's bundles (ms alone, ms "
          "device in the replayed step): " + json.dumps(b3_ms))
    clock.done("measurement scripts")

    # ---- 20. training to a policy: the IL run, the TD3 command cut ---------
    train_launches = training_phase(card, rk)
    for entry in kernels:
        if entry["name"] in ("rank", "front"):
            entry["launches_train"] = train_launches[entry["name"]]
    check(train_launches["rank"] > 0, "training: the rank kernel was not "
          "launched")
    clock.done("training to a policy")

    # ---- 21. results --------------------------------------------------------
    print(f"chip_smoke: {time.perf_counter() - start:.1f} s after the "
          f"device check")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


# the benchmark's configurations and their rollout cells' batches
FRONT_CELLS = (("simple_layout-128x160", 4096), ("knuffingen-480x640", 512))


def front_args(fenv, rk, params, states):
    """The front kernel's arguments for these states as the main path's
    render gives them (env._render): `rk.front_kernel(*args)`, or its
    plain version `rk.front_plain(*args)`."""
    md = params.map_data
    cam = params.cfg.camera
    return (md.packed_nodes, md.packed_edges, md.packed_edge_mask,
            md.packed_edge_layer, fenv._camera_pose(params, states),
            params.camera.K, md.n_layers, tuple(cam.resolution),
            cam.line_thickness, cam.max_range,
            rk._budget(md.packed_edges.shape[1], cam.resolution[1],
                       cam.max_visible_segments),
            md.packed_layer_bounds)


def check_front(launches, what):
    """The front kernel runs in front of every masks or rank launch of a
    render (the fast stroke) and of no other: in {kernel name: launches}
    counted over renders alone, its count is theirs together."""
    want = launches.get("masks", 0) + launches.get("rank", 0)
    check(launches.get("front", 0) == want, f"{what}: the front kernel "
          f"launched {launches.get('front', 0)} times beside {want} masks "
          f"and rank launches ({launches})")


def front_phase(card, rk, fenv):
    """Phase 3b: the front kernel against `front_plain` on each of
    FRONT_CELLS' spawn-table states, bit for bit, then both timed in
    replayed CUDA graphs of 30 calls (device time, as in the rollout's
    graph; `eager_ms`: the kernel's eager back-to-back calls, which the
    host's launch path bounds) beside the kernel's bound: the bundle
    written once (idx, 5 float32 and 1 int32 payload arrays, counts) and
    the poses and the map read once. Returns {config: its times}."""
    import torch

    times = {}
    for name, n in FRONT_CELLS:
        path = os.path.join(REPO, "portbench", "configs", f"{name}.json")
        with open(path) as f:
            cfg = json.load(f)["config"]
        cfg["map"]["json_path"] = os.path.join(os.path.dirname(path),
                                               cfg["map"]["json_path"])
        params = fenv.make_env_params(cfg)
        rows = torch.arange(n, device="cuda") % params.map_data.spawns.count
        state, _, _ = fenv.reset(params, n, spawn_row=rows, render=False)
        args = front_args(fenv, rk, params, state)
        got = rk.front_kernel(*args)
        want = rk.front_plain(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            check(g.shape == w.shape and torch.equal(
                g.view(torch.int32), w.view(torch.int32)),
                f"front kernel: {name}'s bundle differs from front_plain")
        ms = {name: graph_ms(fn) for name, fn in (
            ("kernel", lambda: rk.front_kernel(*args)),
            ("plain", lambda: rk.front_plain(*args)))}
        eager = back_to_back_ms({"kernel": lambda: rk.front_kernel(*args)})
        n_bytes = sum(t.numel() * t.element_size() for t in got) + sum(
            t.numel() * t.element_size() for t in args[:6])
        least, kind, _, _ = bound(n_bytes, 0)
        times[name] = {"ms": ms["kernel"], "plain_ms": ms["plain"],
                       "bound_ms": least, "bound_by": kind}
        print("front kernel: " + json.dumps({
            "config": name, "envs": n, "copies": got[1].shape[1],
            "live": int(got[-1][0].sum()), "ms": round(ms["kernel"], 4),
            "bound_ms": round(least, 4), "bound": kind, "bytes": n_bytes,
            "plain_ms": round(ms["plain"], 4),
            "eager_ms": round(eager["kernel"], 4), "card": card}))
    return times


def front_entry(times, launches):
    """The front kernel's entry of the `kernels` line: the main path's
    (phase 7) launches, and phase 3b's times on simple_layout, the main
    path's map, beside its plain version."""
    t = times["simple_layout-128x160"]
    return {
        "name": "front",
        "route": "cuda",
        "source": "tinycarlo_torch/ops/csrc/front.cu",
        "replaces": "tinycarlo_tpu/env.py:189 (_project_packed_batch_soa),"
                    " tinycarlo_tpu/ops/rasterize_pallas.py:886 "
                    "(compact_env_idx_soa)",
        "launches": launches,
        # its bundle is held bit-equal to the plain version's (phase 3b)
        "max_abs_err": 0,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        # no single PyTorch call projects and compacts segments into the
        # masks kernel's bundle, so there is no library yardstick
        "library_ms": None,
    }


# phase 3c: steps from the spawn table, and the kernel's operations a
# packed edge a car (and a lanepath edge a u-turn entry): its two
# distances (2 subtractions, 2 products, a sum and a root each), their sum
# and its absolute value
CAR_STEPS = 40
CAR_FLOPS_PER_EDGE = 14


def car_outputs(out):
    """The outputs of `env._car_work` (or its plain version) as one tuple
    of tensors in a fixed order, float32 viewed as int32 bits."""
    import torch

    car, truncated, info, reward, terminated = out
    ts = (car.position, car.position_front, car.rotation, car.steering_angle,
          car.radius, car.velocity, car.local_path, car.local_path_len,
          car.last_maneuver, truncated, info["cte"], info["heading_error"],
          info["laneline_distances"], info["local_path"],
          info["local_path_len"], info["velocity"], reward, terminated)
    return tuple(t.view(torch.int32) if t.is_floating_point() else t
                 for t in ts)


def car_phase(card, fenv, stanley_steering):
    """Phase 3c: the car kernel (`ck.car_kernel`, as `env._car_work`
    launches it) against its plain version `env._car_work_plain`, every
    output bit for bit, on each of FRONT_CELLS' configurations at its
    batch: the spawn-table states, then CAR_STEPS steps from them, each
    compared, driven by Stanley's steering plus noise past the action
    clamp with the maneuvers cycling ((step + env) % 4: u-turn entries on
    every step), wrapped on odd steps, truncated or terminated cars
    respawned. Then both timed in replayed CUDA graphs of 30 calls on the
    last state under the cell's maneuvers (simple_layout 0, knuffingen
    env % 4), the kernel also eagerly back to back, beside its bound: the
    state, the action and the map read once and the outputs written once;
    CAR_FLOPS_PER_EDGE a packed edge a car and a lanepath edge a u-turn
    entry, at the float32 instruction rate (built with -fmad=false).
    Returns {config: its times}."""
    import numpy as np
    import torch

    from tinycarlo_torch import car as car_mod
    from tinycarlo_torch import vector
    from tinycarlo_torch.ops import car_kernel as ck

    times = {}
    for name, n in FRONT_CELLS:
        path = os.path.join(REPO, "portbench", "configs", f"{name}.json")
        with open(path) as f:
            cfg = json.load(f)["config"]
        cfg["map"]["json_path"] = os.path.join(os.path.dirname(path),
                                               cfg["map"]["json_path"])
        params = fenv.make_env_params(cfg)
        md, car_cfg = params.map_data, params.cfg.car
        rows = torch.arange(n, device="cuda") % md.spawns.count
        car = car_mod.car_reset(md, car_cfg, rows)
        info = car_mod.car_info(md, car_cfg, car)
        env_ids = torch.arange(n, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(n)
        bad = torch.zeros(18, dtype=torch.int64, device="cuda")
        events = torch.zeros(3, dtype=torch.int64, device="cuda")
        launches = ck.car_kernel.launches
        for step in range(CAR_STEPS + 1):
            steer = stanley_steering(info["cte"], info["heading_error"], 0.5,
                                     1.0, car_cfg.max_steering_angle)
            noise = torch.rand((n, 2), device="cuda", generator=gen)
            control = torch.stack([0.3 + noise[:, 0], steer.float()
                                   + 0.6 * (noise[:, 1] - 0.5)], dim=-1)
            man = ((step + env_ids) % 4).to(torch.int32)
            action = {"car_control": control, "maneuver": man}
            wrapped = step % 2 == 1
            got = fenv._car_work(params, car, action, wrapped)
            want = fenv._car_work_plain(params, car, action, wrapped)
            for i, (g, w) in enumerate(zip(car_outputs(got),
                                           car_outputs(want))):
                check(g.dtype == w.dtype and g.shape == w.shape,
                      f"car kernel: {name} output {i} is {g.dtype} "
                      f"{tuple(g.shape)}, its plain version's {w.dtype} "
                      f"{tuple(w.shape)}")
                bad[i] += (g != w).sum()
            new, truncated, info, _, terminated = got
            events += torch.stack([
                truncated.sum(), (truncated & (new.last_maneuver != man)).sum(),
                ((man == 2) & (car.last_maneuver != 2)).sum()])
            done = truncated | (info["cte"].abs() > 10 * car_cfg.track_width)
            fresh = car_mod.car_reset(md, car_cfg,
                                      (rows + step + 1) % md.spawns.count)
            car = vector._select(done, fresh, new)
            info = car_mod.car_info(md, car_cfg, car)
        torch.cuda.synchronize()
        check(ck.car_kernel.launches - launches == CAR_STEPS + 1,
              f"car kernel: {ck.car_kernel.launches - launches} launches "
              f"for {CAR_STEPS + 1} steps of {name}")
        check(bad.tolist() == [0] * 18, f"car kernel: {name}'s outputs "
              f"differ from its plain version's (elements a field: "
              f"{bad.tolist()})")
        n_trunc, n_kept, n_uturn = events.tolist()

        man = (env_ids % 4 if name.startswith("knuffingen")
               else env_ids * 0).to(torch.int32)
        control = torch.stack([torch.full((n,), 0.5, device="cuda"),
                               stanley_steering(info["cte"],
                                                info["heading_error"], 0.5,
                                                1.0,
                                                car_cfg.max_steering_angle
                                                ).float()], dim=-1)
        action = {"car_control": control, "maneuver": man}
        ms = {key: graph_ms(fn) for key, fn in (
            ("kernel", lambda: fenv._car_work(params, car, action, False)),
            ("plain", lambda: fenv._car_work_plain(params, car, action,
                                                   False)))}
        eager = back_to_back_ms({"kernel": lambda: fenv._car_work(
            params, car, action, False)})
        out = fenv._car_work(params, car, action, False)
        lp = md.lanepath
        read = [getattr(car, f.name) for f in dataclasses.fields(car)] + [
            control, man, lp.nodes, lp.edges, lp.edge_mask, lp.next_table,
            lp.next_count, lp.prev_table, lp.prev_count,
            md.packed_nodes[0], md.packed_edges[0]]
        n_bytes = sum(t.numel() * t.element_size()
                      for t in read + list(car_outputs(out)))
        entries = int(((man == 2) & (car.last_maneuver != 2)).sum())
        n_ops = CAR_FLOPS_PER_EDGE * (
            n * md.packed_layer_bounds[-1]
            + entries * int(lp.edge_mask.sum()))
        least, kind, _, _ = bound(n_bytes, n_ops, PEAK_F32_INSTR_PER_S)
        times[name] = {"ms": ms["kernel"], "plain_ms": ms["plain"],
                       "bound_ms": least, "bound_by": kind}
        print("car kernel: " + json.dumps({
            "config": name, "envs": n, "steps_equal": CAR_STEPS + 1,
            "truncations": n_trunc, "failed_first_hops": n_kept,
            "uturn_entries": n_uturn, "timed_uturn_entries": entries,
            "ms": round(ms["kernel"], 4), "bound_ms": round(least, 5),
            "bound": kind, "bytes": n_bytes, "ops": n_ops,
            "plain_ms": round(ms["plain"], 4),
            "eager_ms": round(eager["kernel"], 4), "card": card}))
    return times


def check_car(launches, steps, what):
    """The car kernel takes every `env.step` of a CUDA float32 state
    without a LanelineGrid once: its launches, counted from 0 over a run,
    are the run's env.step calls (eager steps and captures; a replay
    passes no wrapper)."""
    check(launches == steps, f"{what}: the car kernel launched {launches} "
          f"times for {steps} env.step calls")


def car_entry(times, launches):
    """The car kernel's entry of the `kernels` line: the main path's
    (phase 7) launches, and phase 3c's times on simple_layout, the main
    path's map, beside its plain version."""
    t = times["simple_layout-128x160"]
    return {
        "name": "car",
        "route": "cuda",
        "source": "tinycarlo_torch/ops/csrc/car.cu",
        "replaces": "tinycarlo_tpu/car.py:85 (car_step), "
                    "tinycarlo_tpu/car.py:171 (find_local_path), "
                    "tinycarlo_tpu/car.py:282 (car_info), "
                    "tinycarlo_tpu/env.py:330 (default_reward), "
                    "tinycarlo_tpu/env.py:338 (default_termination)",
        "launches": launches,
        # every output is held bit-equal to the plain version's (phase 3c)
        "max_abs_err": 0,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        # no single PyTorch call steps the car and walks its path
        "library_ms": None,
    }


def classes_path(card, rk, fenv, vector, stanley_steering, params, err,
                 repeats):
    """Phases 7 and 9: the bench workload on the params' stroke, its
    checks and stage times. Returns the kernel's entry of the `kernels`
    line, with the run under "run"."""
    import torch

    compact, kernel, plain, symbol = kernel_pair(rk, params)
    exact = kernel is rk.exact_kernel
    what = "exact classes" if exact else "main path"
    from tinycarlo_torch.ops import car_kernel as ck

    for k in (rk.masks_kernel, rk.rank_kernel, rk.exact_kernel,
              rk.front_kernel, ck.car_kernel):
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    run = run_main_path(fenv, vector, params, N_ENVS, CHUNK, repeats)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = kernel.launches
    renders = run["steps"]
    check(launches == renders,
          f"{kernel.NAME} kernel launched {launches} times for {renders} "
          "renders")
    # each step of the bench body is one vector.step, one env.step
    run["car_launches"] = ck.car_kernel.launches
    check_car(run["car_launches"], run["steps"], what)
    run["front_launches"] = rk.front_kernel.launches
    check(run["front_launches"] == (0 if exact else renders),
          f"the front kernel launched {run['front_launches']} times for "
          f"{renders} {what} renders")
    others = [k.NAME for k in (rk.masks_kernel, rk.rank_kernel,
                               rk.exact_kernel)
              if k is not kernel and k.launches]
    check(not others, f"the {what} ran the {others} kernel")
    check(run["checksum"] > 0, "observations were not rendered")
    rates = sorted(run["rates"])
    print(f"{what}: {N_ENVS} envs x {renders} steps, {launches} "
          f"{kernel.NAME} kernel launches, {run['front_launches']} front "
          f"kernel launches, {run['car_launches']} car kernel launches, "
          f"checksum {run['checksum']}")
    print(f"{what} env-steps/s: median {statistics.median(rates):.1f} "
          f"(min {rates[0]:.1f}, max {rates[-1]:.1f}, {repeats} repeats of "
          f"{CHUNK} steps) on {card}; peak memory {peak_gb:.2f} GB")

    check_outputs(fenv, rk, params, run)
    compare_with_cpu(fenv, vector, stanley_steering, params)
    times = stage_times(fenv, vector, rk, params, run["vstate"])
    wall_ms = 1e3 * N_ENVS / statistics.median(rates)
    busy_ms, top, by_name, _ = device_profile(lambda: run["body"](
        run["vstate"], run["info"], torch.zeros((), dtype=torch.int64,
                                                device="cuda")))
    times["kernel_device"] = kernel_device_ms(by_name, symbol)
    fmt = lambda x: "not measured" if x is None else f"{x:.4f} ms"  # noqa
    print(f"{what} per step at {N_ENVS} envs on {card}, event ms / "
          "device-busy ms:")
    for key in times["stages"]:
        print(f"  {key}: {times[key]:.4f} ms / {fmt(times[key + '_device'])}")
    if "front_plain" in times:
        print(f"  plain version of the front kernel (the projection and "
              f"compaction as torch ops): {times['front_plain']:.4f} ms")
    print(f"  plain version of the {kernel.NAME} kernel: "
          f"{times['plain']:.4f} ms")
    b2b = times["back_to_back"]
    print(f"  {kernel.NAME} kernel alone in back-to-back calls: "
          f"{b2b['kernel']:.4f} ms; store floor, an output of its size "
          f"filled: K9's fill {b2b['fill']:.4f} ms, fill_ {b2b['fill_']:.4f} "
          f"ms (kernel / K9 fill {b2b['kernel'] / b2b['fill']:.2f})")
    if "float32" in b2b:
        print(f"  its float32 output {b2b['float32']:.4f} ms back to back "
              f"({b2b['float32'] / b2b['kernel']:.2f} x uint8)")
    if busy_ms is None:
        print(f"{what} step: device busy share not measured (the "
              "profiler trace holds no device time)")
    else:
        print(f"{what} step: wall {wall_ms:.3f} ms, device busy "
              f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
        for key, ms, count in top:
            print(f"  {ms:.4f} ms/step x{count}: {key}")
    md = params.map_data
    res = tuple(params.cfg.camera.resolution)
    t = params.cfg.camera.line_thickness
    out_bytes = N_ENVS * md.n_layers * res[0] * res[1]
    if exact:
        n_bytes, n_ops = exact_bytes_and_ops(rk, times["bundle"], res, t,
                                             out_bytes)
        bound_ms, by, t_bytes, t_ops = bound(n_bytes, n_ops, PEAK_I32_PER_S)
        kind = "int32"
    else:
        n_bytes, n_ops = bundle_bytes_and_ops(rk, times["bundle"], res, t,
                                              out_bytes)
        bound_ms, by, t_bytes, t_ops = bound(n_bytes, n_ops, PEAK_F32_PER_S)
        kind = "float32"
    print(f"{kernel.NAME} kernel bound on {card}: {n_bytes / 1e6:.1f} MB -> "
          f"{t_bytes:.4f} ms, {n_ops / 1e9:.2f} GOP {kind} -> {t_ops:.4f} ms:"
          f" {by} bind")
    replaces = {
        "masks": "tinycarlo_tpu/ops/rasterize_pallas.py:1931 "
                 "(_kernel_env_idx), "
                 "tinycarlo_tpu/ops/rasterize_pallas.py:2107 "
                 "(_kernel_env_dma)",
        "exact": "tinycarlo_tpu/ops/rasterize_pallas.py:2904 "
                 "(_kernel_env_exact)",
    }[kernel.NAME]
    return {
        "name": kernel.NAME,
        "route": "cuda",
        "source": f"tinycarlo_torch/ops/csrc/{kernel.NAME}.cu",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": err,
        "ms": times["kernel"],
        "plain_ms": times["plain"],
        "bound_ms": bound_ms,
        "bound_by": by,
        # no single PyTorch call rasterizes compacted segment stamps into
        # per-layer masks, so there is no library yardstick
        "library_ms": None,
        "run": run,
    }


def bench_bundle(fenv, rk, params, states, projection=None):
    """The production compaction bundle of these states (bench budget),
    of the params' stroke."""
    md = params.map_data
    res = tuple(params.cfg.camera.resolution)
    nxb = rk._n_xblocks(res[1])
    k = min(params.cfg.camera.max_visible_segments * nxb,
            md.packed_edges.shape[1] * nxb)
    u0, v0, u1, v1, draw = (
        projection or fenv._project_packed_batch_soa(params, states)
    )
    return kernel_pair(rk, params)[0](
        u0, v0, u1, v1, draw, k, res[0], params.cfg.camera.line_thickness,
        edge_layer=md.packed_edge_layer, n_layers=md.n_layers, w=res[1],
        layer_bounds=md.packed_layer_bounds,
    )


def rank_vs_plain(rk, ras, bundle, n_layers, res, t):
    """Max |rank kernel - plain| and |rank kernel - rank_from_masks(masks
    kernel)| on one bundle (0 expected)."""
    import torch

    got = rk.rank_kernel(bundle, n_layers, res, t)
    want = rk.rasterize_rank_env_plain(bundle, n_layers, res, t)
    via_masks = ras.rank_from_masks(rk.masks_kernel(bundle, n_layers, res, t))
    check(got.shape == want.shape == via_masks.shape
          and got.dtype == want.dtype == torch.uint8,
          f"rank kernel output {got.shape} {got.dtype} != {want.shape}")
    err = max((got.float() - want.float()).abs().max().item(),
              (got.float() - via_masks.float()).abs().max().item())
    check(err == 0.0, f"rank kernel differs from its plain version or the "
          f"masks kernel's ranks by {err} at t={t}, {res}")
    return err


def check_kernels(rk, ras, fenv, vector, params, dev):
    """The masks and rank kernels against their plain versions (and the
    rank kernel against the masks kernel's ranks); returns the max |error|
    of each."""
    masks_err = rank_err = 0.0
    cases = [
        # (seed, B, E, h, w, t, k per block)
        (1, 64, 120, 128, 160, 1, 120),
        (2, 64, 120, 30, 48, 2, 120),
        (3, 64, 120, 128, 160, 3, 8),   # oversubscribed budget
        (4, 32, 200, 64, 160, 2, 200),
        (5, 32, 80, 30, 160, 1, 80),
        # 480x640 (knuffingen's high-res shape): a 61 KB strip, above the
        # 48 KB default shared-memory limit; the masks kernel's 48-row
        # chunks
        (6, 16, 200, 480, 640, 2, 200),
        # a width that is not a multiple of 4 (two lane blocks)
        (7, 16, 200, 100, 150, 3, 200),
    ]
    for seed, b, e, h, w, t, kb in cases:
        bundle = random_bundle(rk, seed, b, e, h, w, t, kb, dev)
        check(int(bundle[-1][0, 0]) == 0, "env 0 should have no live slot")
        if kb < e:
            check(int(bundle[-1][3].sum()) > 0, "budget not oversubscribed")
        masks_err = max(masks_err, kernel_vs_plain(
            rk.masks_kernel, rk.rasterize_masks_env_plain, bundle, 5, (h, w),
            t))
        rank_err = max(rank_err, rank_vs_plain(rk, ras, bundle, 5, (h, w), t))
    real, _ = vector.reset(params, 384, seed=1, render=False)
    real_bundle = bench_bundle(fenv, rk, params, real.env)
    geometry = (params.map_data.n_layers, tuple(params.cfg.camera.resolution),
                params.cfg.camera.line_thickness)
    masks_err = max(masks_err, kernel_vs_plain(
        rk.masks_kernel, rk.rasterize_masks_env_plain, real_bundle,
        *geometry))
    rank_err = max(rank_err, rank_vs_plain(rk, ras, real_bundle, *geometry))
    print(f"kernels: masks kernel equal to its plain version on "
          f"{len(cases)} random bundles and 384 real envs, uint8, float32 "
          f"and bfloat16; rank kernel equal to its plain version and to "
          f"rank_from_masks of the masks kernel on the same bundles")
    return masks_err, rank_err


def check_exact_kernels(rk, fenv, vector, params_exact, dev):
    """The exact kernel against its plain version, bit for bit, on random
    exact bundles and on real bundles of the bench states; returns the max
    |error|."""
    err = 0.0
    cases = [
        # (seed, B, E, h, w, t, k per block)
        (11, 64, 120, 48, 96, 2, 120),
        (12, 64, 120, 128, 160, 3, 120),
        (13, 64, 120, 128, 160, 5, 8),   # oversubscribed budget
        (14, 32, 160, 128, 160, 2, 160),
        (15, 16, 200, 480, 640, 3, 200),
        (16, 16, 200, 480, 640, 5, 200),
    ]
    for seed, b, e, h, w, t, kb in cases:
        bundle = random_bundle(rk, seed, b, e, h, w, t, kb, dev, exact=True)
        counts = bundle[-1]
        check(int(counts[0, 0]) == 0, "env 0 should have no live slot")
        check(int(counts[0, 1:].min()) > 0, "an env has no live slot")
        if kb < e:
            check(int(counts[3].sum()) > 0, "budget not oversubscribed")
        err = max(err, kernel_vs_plain(
            rk.exact_kernel, rk.rasterize_masks_exact_env_plain, bundle, 5,
            (h, w), t))
    real, _ = vector.reset(params_exact, 384, seed=1, render=False)
    bundle = bench_bundle(fenv, rk, params_exact, real.env)
    geometry = (params_exact.map_data.n_layers,
                tuple(params_exact.cfg.camera.resolution),
                params_exact.cfg.camera.line_thickness)
    err = max(err, kernel_vs_plain(
        rk.exact_kernel, rk.rasterize_masks_exact_env_plain, bundle,
        *geometry))

    print(f"kernels: exact kernel equal to its plain version on "
          f"{len(cases)} random exact bundles (t = 2, 3, 5; 48x96, "
          f"128x160, 480x640) and 384 real envs, uint8, float32 and "
          f"bfloat16 (0/1)")
    return err


def soa_segments(seed, b, nl, e, h, w, dev):
    """Numpy-seeded per-layer segments on `dev`: p0, p1 (b, nl, e, 2) and
    draw (b, nl, e), short, tall, off-frame and block-crossing; env 0
    draws nothing."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    p0 = np.stack([rng.uniform(-40, w + 40, (b, nl, e)),
                   rng.uniform(-40, h + 40, (b, nl, e))], -1)
    p1 = p0 + np.stack([rng.uniform(-90, 90, (b, nl, e)),
                        rng.uniform(-70, 70, (b, nl, e))], -1)
    draw = rng.random((b, nl, e)) < 0.7
    draw[0] = False
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa
    return f(p0), f(p1), torch.tensor(draw, device=dev)


# (seed, B, L, E, h, w, t, gran, k per layer): the bench's 128x160 (nxb 2),
# t = 1 at nxb 1 and 2, nxb 3 and 5, h not a multiple of the band, odd and
# oversubscribed budgets, and 480x640, whose whole frame (307 KB of uint8)
# exceeds a block's shared memory, so the frame, env and segment kernels
# drain it in 48-row chunks
SOA_CASES = [
    (31, 32, 3, 40, 128, 160, 2, 8, 40),
    (32, 32, 3, 40, 64, 48, 1, 16, 40),
    (33, 32, 3, 40, 30, 200, 3, 8, 7),
    (34, 16, 3, 60, 100, 300, 2, 16, 60),
    (35, 8, 5, 80, 480, 640, 2, 8, 80),
    (36, 8, 5, 80, 480, 640, 3, 16, 33),
    (37, 32, 3, 40, 128, 256, 1, 8, 40),
]
# (kind, seed, B, L, E, h, w, gran, k per env) of the env and segment
# kernels at t = 2: every live slot of an env in one layer (the others
# zeros), a budget that counts[0] reaches in every drawing env, and long
# segments whose slots touch three or more lane blocks (w = 300 and 640);
# the frame kernel takes the same segments with k per (env, layer) frame
SOA_EDGE_CASES = [
    ("one_layer", 51, 16, 3, 40, 128, 160, 16, 120),
    ("budget", 52, 16, 3, 40, 128, 160, 8, 10),
    ("long", 53, 16, 3, 40, 100, 300, 16, 120),
    ("long", 54, 8, 5, 40, 480, 640, 8, 200),
]


def soa_kernel_vs_plain(kernel, plain, soa, args):
    """Max |kernel - plain| of one of the older layouts' kernels on one
    bundle (0 required)."""
    got = kernel(soa, *args)
    want = plain(soa, *args)
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{kernel.NAME} kernel output {got.shape} {got.dtype} != "
          f"{want.shape} {want.dtype}")
    err = (got.float() - want.float()).abs().max().item()
    check(err == 0.0, f"{kernel.NAME} kernel differs from its plain version "
          f"by {err} ({args})")
    return err


def check_soa_kernels(rk, dev):
    """The frame, env and segment kernels against their plain versions,
    bit for bit, on SOA_CASES' random bundles: the frame kernel on
    `compact_soa`, the env kernel on `compact_env_soa` lane-split and (t >=
    2, no w) unsplit, the segment kernel on `compact_env_seg` split (or one
    block) and (t >= 2) unsplit; the env and segment kernels also on
    SOA_EDGE_CASES' bundles, split and unsplit, and the frame kernel on
    their segments' `compact_soa` bundle. Returns {kernel name: max
    |error|}."""
    err = {"frame_soa": 0.0, "env_soa": 0.0, "env_seg": 0.0}
    for seed, b, nl, e, h, w, t, gran, kl in SOA_CASES:
        p0, p1, draw = soa_segments(seed, b, nl, e, h, w, dev)
        nxb = rk._n_xblocks(w)
        res = (h, w)
        soa = rk.compact_soa(p0, p1, draw, kl, gran, h, t, w=w)
        check(int(soa[-1][0, :nl].max()) == 0, "env 0 should be empty")
        check(int(soa[-1][0, nl:].min()) > 0, "a frame has no live slot")
        if kl < e:
            check(int(soa[-1][2].sum()) > 0, "budget not oversubscribed")
        err["frame_soa"] = max(err["frame_soa"], soa_kernel_vs_plain(
            rk.frame_soa_kernel, rk.rasterize_compact_soa_plain, soa,
            (res, t, gran)))
        for split in (True, False):
            if not split and t <= 1:
                continue  # the t=1 clip needs w, which splits the lanes
            soa = rk.compact_env_soa(p0, p1, draw, kl * nl * nxb, gran, h, t,
                                     w=w if split else None)
            err["env_soa"] = max(err["env_soa"], soa_kernel_vs_plain(
                rk.env_soa_kernel, rk.rasterize_compact_env_soa_plain, soa,
                (nl, res, t, gran, split)))
            soa = rk.compact_env_seg(
                p0[..., 0], p0[..., 1], p1[..., 0], p1[..., 1], draw,
                kl * nl, gran, h, t, w=w if split else None)
            check(int(soa[-1][0, 0]) == 0, "env 0 should be empty")
            err["env_seg"] = max(err["env_seg"], soa_kernel_vs_plain(
                rk.env_seg_kernel, rk.rasterize_env_seg_plain, soa,
                (nl, res, t, gran, split and nxb > 1)))
    for kind, seed, b, nl, e, h, w, gran, k in SOA_EDGE_CASES:
        p0, p1, draw = soa_edge_segments(kind, seed, b, nl, e, h, w, dev)
        frame = rk.compact_soa(p0, p1, draw, k, gran, h, 2, w=w)
        frame_edge_check(kind, frame, k, b, nl)
        err["frame_soa"] = max(err["frame_soa"], soa_kernel_vs_plain(
            rk.frame_soa_kernel, rk.rasterize_compact_soa_plain, frame,
            ((h, w), 2, gran)))
        for split in (True, False):
            soa = rk.compact_env_soa(p0, p1, draw, k * rk._n_xblocks(w), gran,
                                     h, 2, w=w if split else None)
            seg = rk.compact_env_seg(
                p0[..., 0], p0[..., 1], p1[..., 0], p1[..., 1], draw, k,
                gran, h, 2, w=w if split else None)
            soa_edge_check(rk, kind, soa, seg, k * rk._n_xblocks(w), k, w,
                           split)
            err["env_soa"] = max(err["env_soa"], soa_kernel_vs_plain(
                rk.env_soa_kernel, rk.rasterize_compact_env_soa_plain, soa,
                (nl, (h, w), 2, gran, split)))
            err["env_seg"] = max(err["env_seg"], soa_kernel_vs_plain(
                rk.env_seg_kernel, rk.rasterize_env_seg_plain, seg,
                (nl, (h, w), 2, gran, split and w > 128)))
    print(f"kernels: frame, env and segment kernels equal to their plain "
          f"versions on {len(SOA_CASES)} random bundles each (t = 1, 2, 3; "
          "gran 8 and 16; nxb 1, 2, 3, 5; 30x200 to 480x640; split and "
          "unsplit; oversubscribed) and on "
          f"{len(SOA_EDGE_CASES)} edge bundles each (one layer, a full "
          "budget, slots over 3-5 lane blocks)")
    return err


def soa_edge_segments(kind, seed, b, nl, e, h, w, dev):
    """`soa_segments` for SOA_EDGE_CASES: `one_layer` draws in layer 1
    only; `long` makes every third segment a near-horizontal one across
    the frame, -50 to w + 50."""
    import numpy as np
    import torch

    p0, p1, draw = soa_segments(seed, b, nl, e, h, w, dev)
    if kind == "one_layer":
        draw[:, [l for l in range(nl) if l != 1]] = False
    if kind == "long":
        rng = np.random.default_rng(seed + 1)
        y = rng.uniform(0, h, (b, nl, e // 3))
        x0 = rng.uniform(-50, 40, (b, nl, e // 3))
        x1 = rng.uniform(w - 40, w + 50, (b, nl, e // 3))
        dy = rng.uniform(-8, 8, (b, nl, e // 3))
        f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa
        p0[:, :, ::3][..., :e // 3, :] = torch.stack([f(x0), f(y)], -1)
        p1[:, :, ::3][..., :e // 3, :] = torch.stack([f(x1), f(y + dy)], -1)
    return p0, p1, draw


def frame_edge_check(kind, frame, k, b, nl):
    """That an edge case's frame bundle (`compact_soa`, budget k a frame)
    is what the case is named for."""
    live = frame[-1][0].view(b, nl)
    if kind == "one_layer":
        others = [l for l in range(nl) if l != 1]
        check(int(live[:, others].abs().sum()) == 0
              and int(live[1:, 1].min()) > 0, "live frames outside layer 1")
    if kind == "budget":
        check(int(live[1:].min()) == k == int(live.max())
              and int(frame[-1][2].sum()) > 0,
              f"the frame budget {k} is not reached: {live.tolist()}")


def soa_edge_check(rk, kind, soa, seg, k_soa, k_seg, w, split):
    """That an edge case's env (`soa`, budget k_soa) and segment (`seg`,
    k_seg) bundles are what the case is named for."""
    import torch

    if kind == "one_layer":
        per_layer = seg[-1][4:]
        check(int(per_layer[1].sum()) > 0 and int(per_layer.sum())
              == int(per_layer[1].sum()), "live slots outside layer 1")
    if kind == "budget":
        # the dropped row: 2 of compact_env_soa's counts, 3 of the segments'
        for counts, k, drop in ((soa[-1], k_soa, 2), (seg[-1], k_seg, 3)):
            check(int(counts[0][1:].min()) == k == int(counts[0].max())
                  and int(counts[drop].sum()) > 0,
                  f"the budget {k} is not reached: {counts[0].tolist()}")
    if kind == "long" and split:
        nxb = rk._n_xblocks(w)
        idx, bw = seg[0], seg[-2]
        word = torch.gather(bw, 1, idx[:, :idx.shape[1] - 7].long())
        bits = sum((word >> j) & 1 for j in range(nxb))
        check(int(bits.max()) >= 3, "no slot touches three lane blocks")


def rasterizer_bench(card, rk, errs, inputs):
    """The port's rasterizer benchmark (tinycarlo_torch.benchmarks.
    rasterize_bench) at full size on `inputs`: every layout mode once, its kernels' launch
    counts from that run, every kernel mode rendering the same masks
    (equal checksums, nothing dropped); then, on each kernel mode's
    4096-env bundle, the kernel against its plain version, both timed, and
    its bound; and the frame (`full`), env (`env`, `cur`) and segment
    (`seg`) kernels alone in back-to-back calls beside K9's fill and
    `fill_` of their output's size (the store floor), in turns. Returns
    the `kernels` entries of the frame, env and segment kernels."""
    import torch

    from tinycarlo_torch.benchmarks import rasterize_bench as rb
    from tinycarlo_torch.ops import probe_kernels as pk

    for k in rb.KERNELS:
        k.launches = 0
    results = rb.run(rb.MODES, "cuda", inputs=inputs)
    launches = {k.NAME: k.launches for k in rb.KERNELS}
    # each kernel mode renders once an iteration, in the warm-up, the
    # repeats and its kernel alone; a compaction mode never
    want = {k.NAME: 0 for k in rb.KERNELS}
    for mode, kernel in rb.KERNEL_OF.items():
        want[kernel.NAME] += (rb.REPEATS + 2) * rb.ITERS
    check(launches == want, f"the benchmark's kernel launches {launches}, "
          f"not one a render {want}")
    for mode in rb.MODES:
        per_iter = results[mode]["launches"]
        check(per_iter == (1 if mode in rb.KERNEL_OF else 0),
              f"{mode} launched {per_iter} kernels an iteration")
    sums = {m: results[m]["checksum"] for m in rb.KERNEL_OF}
    for mode in rb.KERNEL_OF:
        check(results[mode]["dropped"] == 0, f"{mode} dropped slots")
    # the per-layer and the packed projections round float32 differently
    # (matrix products against elementwise), so only the layouts of one
    # projection must render the same masks
    for group in (("full", "env"), ("cur", "seg", "idx")):
        check(len({sums[m] for m in group}) == 1 and sums[group[0]] > 0,
              f"the layouts render different masks: checksums {sums}")
    print(f"rasterizer benchmark: {launches} kernel launches; the masks' "
          f"checksums {sums}")

    entries = {}
    res = (rb.H, rb.W)
    out_bytes = rb.N_ENVS * inputs.n_layers * rb.H * rb.W
    replaces = {
        "full": "tinycarlo_tpu/ops/rasterize_pallas.py:357 (_kernel)",
        "env": "tinycarlo_tpu/ops/rasterize_pallas.py:689 (_kernel_env)",
        "cur": "tinycarlo_tpu/ops/rasterize_pallas.py:689 (_kernel_env)",
        "seg": "tinycarlo_tpu/ops/rasterize_pallas.py:1345 "
               "(_kernel_env_seg)",
    }
    plains = {"full": rk.rasterize_compact_soa_plain,
              "env": rk.rasterize_compact_env_soa_plain,
              "cur": rk.rasterize_compact_env_soa_plain,
              "seg": rk.rasterize_env_seg_plain}
    calls = {}
    for mode in ("full", "env", "cur", "seg"):
        start = inputs.layer[0] if mode in ("full", "env") else inputs.packed[0]
        soa, _ = rb.bundle(mode, inputs, start, 0)
        gran = rb.GRAN if mode in ("full", "env") else rb.GRAN_PACKED
        split = mode in ("cur", "seg")
        args = ((res, rb.THICK, gran) if mode == "full" else
                (inputs.n_layers, res, rb.THICK, gran, split))
        kernel = rb.KERNEL_OF[mode]
        name = kernel.NAME
        errs[name] = max(errs[name], soa_kernel_vs_plain(
            kernel, plains[mode], soa, args))
        calls[mode] = lambda soa=soa, args=args, kernel=kernel: kernel(
            soa, *args)
        ms = cuda_ms(calls[mode], repeats=20)
        plain_ms = cuda_ms(lambda: plains[mode](soa, *args), repeats=5,
                           warmup=1)
        n_bytes, n_ops = soa_bytes_and_ops(rk, mode, soa, res, rb.THICK, gran,
                                           split, out_bytes)
        bound_ms, by, t_bytes, t_ops = bound(n_bytes, n_ops, PEAK_F32_PER_S)
        print(f"{name} kernel ({mode}, gran {gran}{', split' if split else ''})"
              f" on {card}: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{n_bytes / 1e6:.1f} MB -> {t_bytes:.4f} ms, {n_ops / 1e9:.2f} "
              f"GOP f32 -> {t_ops:.4f} ms: {by} bind; "
              f"{results[mode]['median']:.4f} ms/iter with its compaction")
        if mode == "full":
            out = kernel(soa, *args)
            print(f"the benchmark's checksum of one output (an int64 sum of "
                  f"{out.numel() / 1e6:.1f} MB of uint8): "
                  f"{cuda_ms(lambda: out.sum(dtype=torch.int64)):.4f} ms")
        if mode == "cur":
            continue  # env_soa's entry is its `env` layout's, with `cur`'s
        entries[name] = {
            "name": name,
            "route": "cuda",
            "source": f"tinycarlo_torch/ops/csrc/{name}.cu",
            "replaces": replaces[mode],
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": by,
            # no single PyTorch call rasterizes compacted segment stamps
            # into per-layer masks, so there is no library yardstick
            "library_ms": None,
        }
    # the frame, env and segment kernels alone, back to back, beside the
    # store floor of their output, timed in turns in this call
    floor = torch.empty((rb.N_ENVS, inputs.n_layers, rb.H, rb.W),
                        dtype=torch.uint8, device="cuda")
    b2b = back_to_back_ms({
        "full": calls["full"], "env": calls["env"], "cur": calls["cur"],
        "seg": calls["seg"],
        "fill": lambda: pk.fill_kernel(floor, 0),
        "fill_": lambda: floor.fill_(0),
    })
    del floor
    for mode in ("full", "env", "cur", "seg"):
        print(f"{rb.KERNEL_OF[mode].NAME} kernel ({mode}) alone in "
              f"back-to-back calls on {card}: {b2b[mode]:.4f} ms; store "
              f"floor, an output of its size filled: K9's fill "
              f"{b2b['fill']:.4f} ms, fill_ {b2b['fill_']:.4f} ms (kernel / "
              f"K9 fill {b2b[mode] / b2b['fill']:.2f})")
    entries["frame_soa"]["back_to_back_ms"] = b2b["full"]
    entries["env_soa"]["back_to_back_ms"] = b2b["env"]
    entries["env_soa"]["back_to_back_ms_cur"] = b2b["cur"]
    entries["env_seg"]["back_to_back_ms"] = b2b["seg"]
    return [entries["frame_soa"], entries["env_soa"], entries["env_seg"]]


# K8-K10 cases: batch sizes, and (KK, start value) of the ovl kernel.
# 29.0 stays in uint8; 300.5 and -3.7 wrap in the int32 -> uint8 cast.
# The chain decides the integer in the others: 0.9999 reaches 1.000001
# in one round, 254.99 reaches 255 in round 29 of 64, 99.93 reaches 100
# in round 367 of 512; 16.9998836517334 gives 16.999998 with the multiply
# and the add rounded apart but 17 fused (fma), so it needs -fmad=false.
PROBE_NS = (1, 7, 4096)
OVL_CASES = ((0, 29.0), (1, 300.5), (64, -3.7), (1, 0.9999),
             (1, 16.9998836517334), (64, 254.99), (512, 99.93))
# the probe modes phase 6 runs (tinycarlo_torch.benchmarks.rasterize_bench)
# and the mode whose kernel time stands in each kernel's `kernels` entry
PROBE_ENTRY_MODES = {"probe_ovl": "ovl64", "probe_fill": "dma",
                     "probe_skip": "dskip"}
PROBE_REPLACES = {
    "probe_ovl": "benchmarks/exp_r2.py:156 (okernel, ovl<KK>)",
    "probe_fill": "benchmarks/exp_r2.py:224 (zkernel, dma[g]); :192 "
                  "(dmaflat[g]); :206 (dmaf32)",
    "probe_skip": "benchmarks/exp_r2.py:261 (dkernel, dskip, dskipall)",
}


def probe_pair(kernel, plain, shape, dtype, args, dev, offset=False):
    """Max |kernel - plain| of one probe kernel on outputs of `shape`
    pre-filled with a sentinel (0 required); with `offset` the kernel's
    output starts one env past its allocation's start (misaligned)."""
    import torch

    sentinel = 171 if dtype == torch.uint8 else -7.0
    full = torch.full((shape[0] + 1,) + tuple(shape[1:]), sentinel,
                      dtype=dtype, device=dev)
    got = kernel(full[1:] if offset else full[:-1], *args)
    want = plain(torch.full(shape, sentinel, dtype=dtype, device=dev), *args)
    err = (got.float() - want.float()).abs().max().item() if got.numel() else 0
    check(err == 0.0, f"{kernel.NAME} kernel differs from its plain version "
          f"by {err} ({shape}, {dtype}, {args[1:]})")
    return err


def probe_live(n, seed, dev):
    """(5, n) int32 live frames: layer 0 empty, layer 1 full, layers 2-4
    ragged (numpy-seeded)."""
    import numpy as np
    import torch

    live = (np.random.default_rng(seed).random((5, n)) < 0.5).astype(np.int32)
    live[0] = 0
    live[1] = 1
    return torch.tensor(live, device=dev)


def check_probe_kernels(pk, dev):
    """Phase 4: K8-K10 against their plain versions on the card, bit for
    bit, on outputs pre-filled with a sentinel. Returns {kernel name: max
    |error|}."""
    import torch

    err = {k.NAME: 0.0 for k in pk.KERNELS}
    u8, f32 = torch.uint8, torch.float32
    frame = (5, 128, 160)
    fill = lambda o, x, _: pk.fill_plain(o, x)  # noqa: E731
    for n in PROBE_NS:
        for kk, v in OVL_CASES:
            err["probe_ovl"] = max(err["probe_ovl"], probe_pair(
                pk.ovl_kernel, pk.ovl_plain, (n,) + frame, u8, (v, kk), dev))
        for shape, dtype, value in (((n, 800, 128), u8, 200),
                                    ((n,) + frame, u8, 29),
                                    ((n,) + frame, f32, -1.5),
                                    ((n, 3, 7, 5), u8, 77),
                                    ((n, 3, 7, 5), f32, 3.25)):
            for g in (1, 4, 16):
                err["probe_fill"] = max(err["probe_fill"], probe_pair(
                    pk.fill_kernel, fill, shape, dtype, (value, g), dev,
                    offset=shape[1] == 3))
        live = probe_live(n, n, dev)
        for shape in ((n * 5, 128, 256), (n * 5, 3, 37)):
            err["probe_skip"] = max(err["probe_skip"], probe_pair(
                pk.skip_kernel, pk.skip_plain, shape, u8, (live, 99), dev,
                offset=shape[1] == 3))
    sync(dev)
    print(f"probe kernels: ovl, fill and skip kernels equal to their plain "
          f"versions for N = {PROBE_NS} (KK, v = {OVL_CASES}; g = 1, 4, 16; "
          "uint8 and float32; odd-sized and misaligned outputs; empty, full "
          "and ragged layers)")
    return err


def probe_checksum(pk, rb, mode, inputs):
    """The checksum a probe mode's ITERS iterations must give, from the
    values they fill with."""
    import torch

    kind, kk = rb.parse_probe(mode)
    n, nl = inputs.packed[2].shape[0], inputs.n_layers
    values = range(rb.ITERS)
    if kind == "ovl":
        values = [int(pk.ovl_plain(torch.empty(1, dtype=torch.uint8),
                                   i + rb.OVL_FRACTION, kk)[0])
                  for i in values]
    if kind == "dmaf32":
        return 4 * sum(values)
    if kind in ("dskip", "dskipall"):
        live = int((rb.probe_live(mode, inputs) > 0).sum())
        return sum(values) * live * 4 * rb.FRAME_W
    return sum(values) * n * nl * rb.H * rb.W


def probe_modes(card, pk, inputs, errs):
    """Phase 6: the probe modes of the rasterizer benchmark at full size:
    one launch an iteration, each checksum what its values give, ovl's
    time growing with KK and ovl512 no faster than its operations bound;
    per mode the kernel and its library call alone (the benchmark's
    back-to-back calls), its plain version and the benchmark's bound.
    Phase 4 held each kernel against its plain version at this size;
    `errs` are its errors. Returns the `kernels` entries of K8, K9 and
    K10."""
    from tinycarlo_torch.benchmarks import rasterize_bench as rb

    for k in pk.KERNELS:
        k.launches = 0
    results = rb.run(rb.PROBES, "cuda", inputs=inputs)
    launches = {k.NAME: k.launches for k in pk.KERNELS}
    want = {k.NAME: 0 for k in pk.KERNELS}
    for mode in rb.PROBES:
        r = results[mode]
        check(r["launches"] == 1, f"{mode} launched {r['launches']} "
              "kernels an iteration")
        expected = probe_checksum(pk, rb, mode, inputs)
        check(r["checksum"] == expected, f"{mode} checksum {r['checksum']}, "
              f"its values give {expected}")
    print(f"probe modes: {launches} kernel launches, one an iteration; "
          "every checksum what its values give")

    entries, ovl_ms = {}, {}
    for mode in rb.PROBES:
        r = results[mode]
        kernel, out, _, _, _, live = rb.probe_setup(mode, inputs)
        want[kernel.NAME] += (rb.REPEATS + 2) * rb.ITERS
        _, param = rb.parse_probe(mode)
        # the plain version of iteration 1's fill, on the mode's output
        plain = {"probe_ovl": lambda: pk.ovl_plain(
                     out, 1 + rb.OVL_FRACTION, param),
                 "probe_fill": lambda: pk.fill_plain(out, 1),
                 "probe_skip": lambda: pk.skip_plain(out, live, 1)}[
            kernel.NAME]
        plain_ms = rb.ms_per_call(plain, 5, out.device)
        del out
        # the kernel and its library call alone as the benchmark timed
        # them: ITERS back-to-back calls, so a ~0.03 ms launch from Python
        # hides behind the kernel before it
        ms, library_ms = r["kernel_ms"], r["library_ms"]
        bound_ms, by = r["bound_ms"], r["bound_by"]
        t_bytes, t_ops = r["bytes_ms"], r["ops_ms"]
        lib = "null" if library_ms is None else f"{library_ms:.4f} ms"
        share = ("" if live is None else
                 f"; live share {r['live_share']:.4f}")
        print(f"{kernel.NAME} kernel ({mode}) on {card}: {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library {lib}, bound "
              f"{r['bytes'] / 1e6:.1f} MB -> {t_bytes:.4f} ms, "
              f"{r['ops'] / 1e9:.2f} GOP f32 -> {t_ops:.4f} ms: {by} bind"
              + share)
        if kernel is pk.ovl_kernel:
            ovl_ms[param] = ms
        if mode == "ovl512":
            check(ms >= t_ops, f"ovl512 took {ms:.4f} ms, under its "
                  f"{t_ops:.4f} ms operations bound: the chains were folded")
        if PROBE_ENTRY_MODES[kernel.NAME] == mode:
            entries[kernel.NAME] = {
                "name": kernel.NAME,
                "route": "cuda",
                "source": f"tinycarlo_torch/ops/csrc/{kernel.NAME}.cu",
                "replaces": PROBE_REPLACES[kernel.NAME],
                "launches": launches[kernel.NAME],
                "max_abs_err": errs[kernel.NAME],
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": by,
                # ovl: no single PyTorch call runs the multiply-add chain
                # and the fill; ovl0 is the fill's
                "library_ms": library_ms,
            }
    check(launches == want, f"the probe modes' kernel launches {launches}, "
          f"not one an iteration {want}")
    check(ovl_ms[0] < ovl_ms[64] < ovl_ms[512], f"the ovl kernel's time does "
          f"not grow with KK: {ovl_ms}")
    return [entries[name] for name in ("probe_ovl", "probe_fill",
                                       "probe_skip")]


def graph_bench(card, rk):
    """Phase 8: tinycarlo_torch.benchmarks.bench at 4096 envs, the step
    replayed as a CUDA graph: its JSON line with bench.py's keys and
    `device`; the masks, front and car kernels launched once each during
    capture (after the warm-up's launches) and recorded once a step in a
    profiler trace of a replayed chunk; the device's idle share; 8
    replayed steps equal bit for bit to 8 eager steps from one state and
    generator seed, with respawns (max_episode_steps 3), the generator
    advanced as far. Returns the car kernel's launches (warm-up and
    capture)."""
    from tinycarlo_torch.benchmarks import bench as pbench
    from tinycarlo_torch.ops import car_kernel as ck

    kernels = (rk.masks_kernel, rk.rank_kernel, rk.exact_kernel,
               rk.front_kernel, ck.car_kernel)
    for k in kernels:
        k.launches = 0
    result = pbench.measure("cuda")
    launched = {k.NAME: k.launches for k in kernels}
    check(launched == {"masks": pbench.WARMUP + 1, "rank": 0, "exact": 0,
                       "front": pbench.WARMUP + 1, "car": pbench.WARMUP + 1},
          f"bench launches {launched}: not {pbench.WARMUP} warm-up steps and "
          "one captured step of the front, masks and car kernels")
    check_car(launched["car"], pbench.WARMUP + 1, "bench")
    line = pbench.result_line(result, pbench.N_ENVS, pbench.REPEATS, card)
    keys = {"metric", "value", "unit", "vs_baseline",
            "baseline_reference_steps_per_s", "baseline_measured_live",
            "spread_min", "spread_max", "repeats", "n_envs", "device"}
    check(set(line) == keys, f"bench line keys {sorted(line)}")
    check(result["checksum"] > 0, "bench observations were not rendered")
    print("bench: " + json.dumps(line))
    print(f"bench: {pbench.N_ENVS} envs x {pbench.CHUNK} replays a repeat, "
          f"checksum {result['checksum']}; repeats in the order they ran "
          "(env-steps/s; then the SM clock, memory clock, power draw, "
          "temperature):")
    check(len(result["clocks"]) == len(result["rates"]),
          "a repeat without its clock reading")
    for rate, clocks in zip(result["rates"], result["clocks"]):
        print(f"  {rate:.1f}; {clocks}")

    graph = result["graph"]
    # the idle share is read from the traced replays' own wall: untraced
    # replays run at another pace than traced ones
    # traces of 100 replays (~95k kernel records) have come back with 2-5%
    # of every kernel's records missing (ROADMAP F2): TRACED replays keep
    # the trace small
    busy_ms, top, by_name, traced_ms = device_profile(graph.replay,
                                                      calls=TRACED)
    masks_ms = kernel_device_ms(by_name, "masks_kernel")
    front_ms = kernel_device_ms(by_name, "front_kernel")
    car_ms = kernel_device_ms(by_name, "car_kernel")
    sorts = [key[:60] for key in by_name if "sort" in key.lower()
             or "topk" in key.lower()]
    check(not sorts, f"bench: the replayed step sorts: {sorts}")
    check(front_ms is not None, f"bench: a trace of {TRACED} replays does "
          "not hold one front kernel record a step")
    check(car_ms is not None, f"bench: a trace of {TRACED} replays does "
          "not hold one car kernel record a step")
    if busy_ms is None or masks_ms is None:
        held = {key[:60]: count for key, (_, count) in by_name.items()
                if "masks" in key}
        print(f"bench: the trace of {TRACED} replays: device busy {busy_ms} "
              f"ms, masks kernel records a step {held}, "
              f"{sum(c for _, c in by_name.values()):g} records a step")
    check(busy_ms is not None and masks_ms is not None, "a trace of "
          f"{TRACED} replays does not hold one masks kernel record a step")
    wall_ms = 1e3 * pbench.N_ENVS / result["median"]
    print(f"bench step (graph replay) on {card}: wall {wall_ms:.4f} ms; "
          f"traced: wall {traced_ms:.4f} ms, device busy {busy_ms:.4f} ms, "
          f"idle share {1 - busy_ms / traced_ms:.4f}, "
          f"{sum(c for _, c in by_name.values()):g} kernel records a step; "
          f"masks kernel {masks_ms:.4f} ms device, front kernel "
          f"{front_ms:.4f} ms device, car kernel {car_ms:.4f} ms device, "
          f"one record each a step over {TRACED} traced replays, no sort "
          "kernel")
    for key, ms, count in top:
        print(f"  {ms:.4f} ms/step x{count}: {key}")
    # once, after the timed repeats and the trace: what enqueuing one
    # replay costs the host while the card is held busy
    print(f"bench: the host's own ms per graph.replay() call, the card "
          f"held busy: {pbench.host_replay_ms(graph.replay):.4f} ms")
    del result, graph

    same = pbench.graph_matches_eager(
        pbench.fenv.make_env_params(pbench.CONFIG), pbench.N_ENVS, steps=8,
        max_episode_steps=3)
    check(same["equal"], "8 replayed steps differ from 8 eager steps")
    eager_offset, graph_offset = same["offsets"]
    check(same["respawns"] > 0 and eager_offset == graph_offset > 0,
          f"respawns {same['respawns']}, generator offsets {same['offsets']}")
    print(f"bench graph: 8 replayed steps equal to 8 eager steps bit for bit "
          f"({same['respawns']} respawns; generator offset {graph_offset} "
          "after both)")
    return launched["car"]


def run_main_path(fenv, vector, params, n_envs, chunk, repeats):
    """bench.py's loop (bench.py:78-111) through the port's entry points:
    the bench body of tinycarlo_torch.benchmarks.bench, run eagerly."""
    import torch

    from tinycarlo_torch.benchmarks.bench import make_body

    dev = params.device
    vstate, _ = vector.reset(params, n_envs, seed=0, render=False)
    overflow = int(fenv.check_segment_overflow(params, vstate.env).sum())
    check(overflow == 0, f"{overflow} rasterizer slot copies dropped -- "
          "raise CameraConfig.max_visible_segments")
    info = fenv._info(params, vstate.env)
    checksum = torch.zeros((), dtype=torch.int64, device=dev)
    body = make_body(params, n_envs)

    for _ in range(WARMUP):
        vstate, info, checksum, obs, rew = body(vstate, info, checksum)
    sync(dev)
    rates = []
    for _ in range(repeats):
        start = time.perf_counter()
        for _ in range(chunk):
            rendered = vstate.env
            vstate, info, checksum, obs, rew = body(vstate, info, checksum)
        sync(dev)
        rates.append(n_envs * chunk / (time.perf_counter() - start))
    return {"body": body, "vstate": vstate, "info": info, "obs": obs,
            "rew": rew,
            "rendered": rendered, "checksum": int(checksum), "rates": rates,
            "n_envs": n_envs, "steps": WARMUP + repeats * chunk}


def sync(dev):
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def check_outputs(fenv, rk, params, run):
    """Shapes, values and finiteness of the classes path's outputs, and its
    last observation against the plain version on the same states."""
    import torch

    md = params.map_data
    res = tuple(params.cfg.camera.resolution)
    obs = run["obs"]
    check(tuple(obs.shape) == (run["n_envs"], md.n_layers) + res
          and obs.dtype == torch.uint8,
          f"observation {tuple(obs.shape)} {obs.dtype}")
    check(bool(((obs == 0) | (obs == 255)).all()), "masks not 0/255")
    check(bool(torch.isfinite(run["rew"]).all()), "non-finite reward")
    for key, val in run["info"].items():
        check(bool(torch.isfinite(val.float()).all()), f"non-finite {key}")
    plain = kernel_pair(rk, params)[2](
        bench_bundle(fenv, rk, params, run["rendered"]), md.n_layers, res,
        params.cfg.camera.line_thickness,
    )
    check(torch.equal(obs, plain),
          "classes observation differs from the plain version")


def check_exact_oracle(fenv, rk, params, run):
    """The exact frames of ORACLE_ENVS envs of the exact path's last render
    against the port's pure-Python cv2 oracle, segment by segment on the
    int32-truncated endpoints: the card's frames rendered from the same
    endpoints in float64 must equal it bit for bit (cv2 equality on a
    machine without cv2); the float32 frames of the run may differ from
    them only where float32 rounds the stroke's clips and quad (the JAX
    package's documented float32 drift), on under 0.5% of the pixels."""
    import numpy as np
    import torch

    from tinycarlo_torch.ops.cv2_stroke import thick_stroke_mask_ref
    from tinycarlo_torch.ops.rasterize import _int_endpoints

    md = params.map_data
    res = tuple(params.cfg.camera.resolution)
    t = params.cfg.camera.line_thickness
    n = ORACLE_ENVS
    env = dataclasses.replace(
        run["rendered"], car=type(run["rendered"].car)(**{
            f.name: getattr(run["rendered"].car, f.name)[:n]
            for f in dataclasses.fields(run["rendered"].car)}))
    u0, v0, u1, v1, draw = fenv._project_packed_batch_soa(params, env)
    f64 = rk.rasterize_masks_packed_soa(
        u0.double(), v0.double(), u1.double(), v1.double(), draw,
        md.packed_edge_layer, md.n_layers, res, t,
        max_visible=params.cfg.camera.max_visible_segments,
        layer_bounds=md.packed_layer_bounds, stroke="exact",
    ).cpu().numpy()
    f32 = run["obs"][:n].cpu().numpy()
    a, b = _int_endpoints(torch.stack([u0, v0], -1), torch.stack([u1, v1], -1),
                          torch.float64)
    a, b = a.long().cpu().numpy(), b.long().cpu().numpy()
    draw = draw.cpu().numpy()
    lay = md.packed_edge_layer.cpu().numpy()
    segs = 0
    for i in range(n):
        for l in range(md.n_layers):
            want = np.zeros(res, bool)
            for e in np.flatnonzero(draw[i] & (lay == l)):
                want |= thick_stroke_mask_ref(a[i, e], b[i, e], t, res)
                segs += 1
            got = f64[i, l] > 0
            check(np.array_equal(got, want),
                  f"exact frame of env {i}, layer {l} differs from the cv2 "
                  f"oracle on {int((got != want).sum())} pixels")
    drift = float((f32 != f64).mean())
    check(drift < 0.005, f"float32 exact frames differ from float64 on "
          f"{drift:.4%} of pixels")
    print(f"cv2 oracle: {n} envs x {md.n_layers} layers ({segs} segments) "
          f"of exact frames equal to thick_stroke_mask_ref bit for bit "
          f"(float64 bundle); the float32 frames differ from them on "
          f"{drift:.4%} of pixels")


def device_profile(fn, calls=5):
    """(device-busy ms per call, top kernels, {kernel name: (ms per call,
    records per call)}, wall ms per traced call) of fn() from a
    torch.profiler trace: the sum of the CUDA kernels' device time over
    `calls` calls; (None, [], {}, wall) if the trace holds no device time.
    The traced wall includes the profiler's host cost of every eager op;
    a replayed graph has none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) / calls * 1e3
    # profiler ranges (vector.step's "vector.render") are no kernels: on
    # the device timeline a range spans its kernels and the gaps between
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        return None, [], {}, wall_ms
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    by_name = {e.key: (e.self_device_time_total / 1e3 / calls,
                       e.count / calls) for e in kernels}
    return busy_us / 1e3 / calls, [
        (e.key[:70], e.self_device_time_total / 1e3 / calls, e.count // calls)
        for e in top
    ], by_name, wall_ms


def kernel_device_ms(by_name, symbol):
    """Device ms per step of the port's kernel `symbol` in a step's trace
    (device_profile's by_name), or None unless the trace holds exactly one
    record of it per step.

    A kernel's device time is read from the whole step's trace, not from a
    trace of the kernel alone: late in this script (after the serving
    protocol), traces of the rank or the masks kernel alone held their
    cudaLaunchKernel calls but no kernel record, also with a library
    linked against the shared CUDA runtime, while the serving step's
    traces held one record per launch. The cause is not known; the
    record count is checked here."""
    hits = [v for key, v in by_name.items() if symbol in key]
    if len(hits) != 1 or hits[0][1] != 1:
        return None
    return hits[0][0]


def render_front_stages(fenv, rk, params, states):
    """The stages in front of the render kernel, as the main path runs
    them, by name: under the fast stroke the front kernel (the projection
    and the compaction in one launch), under the exact stroke the
    projection and `compact_env_exact_soa`."""
    if fenv.render_kernel(params) is not rk.exact_kernel:
        return {"front kernel": lambda: rk.front_kernel(
            *front_args(fenv, rk, params, states))}
    proj = fenv._project_packed_batch_soa(params, states)
    return {
        "projection": lambda: fenv._project_packed_batch_soa(params, states),
        "compaction": lambda: bench_bundle(fenv, rk, params, None,
                                           projection=proj),
    }


def front_plain_ms(fenv, rk, params, states):
    """{"front_plain": ms} of the front kernel's plain version (the torch
    composition) on these states under the fast stroke, else {}."""
    if fenv.render_kernel(params) is rk.exact_kernel:
        return {}
    return {"front_plain": cuda_ms(lambda: rk.front_plain(
        *front_args(fenv, rk, params, states)))}


def stage_times(fenv, vector, rk, params, vstate):
    """Per-stage ms of one render and one step at the classes path's batch
    (`render_front_stages`, the kernel, the step; their names in order
    under "stages"): stream time between CUDA events ("ms", which
    includes the gaps while the host enqueues eager kernels) and
    device-busy time from a profiler trace ("device_ms"; the kernel's
    comes from the whole step's trace, see kernel_device_ms)."""
    import torch

    md = params.map_data
    res = tuple(params.cfg.camera.resolution)
    t = params.cfg.camera.line_thickness
    _, kernel, plain, _ = kernel_pair(rk, params)
    n = vstate.episode_step.shape[0]
    bundle = bench_bundle(fenv, rk, params, vstate.env)
    action = {"car_control": torch.full((n, 2), SPEED, device="cuda"),
              "maneuver": torch.zeros(n, dtype=torch.int32, device="cuda")}
    stages = {
        **render_front_stages(fenv, rk, params, vstate.env),
        "kernel": lambda: kernel(bundle, md.n_layers, res, t),
        "step": lambda: vector.step(params, vstate, action, render=False,
                                    max_episode_steps=1000),
    }
    out = {"bundle": bundle, "stages": list(stages),
           **front_plain_ms(fenv, rk, params, vstate.env)}
    for key, fn in stages.items():
        out[key] = cuda_ms(fn, repeats=20 if key == "kernel" else 7)
        if key != "kernel":  # its device ms: see kernel_device_ms
            out[key + "_device"] = device_profile(fn)[0]
    out["plain"] = cuda_ms(lambda: plain(bundle, md.n_layers, res, t),
                           repeats=5, warmup=1)
    # the kernel alone in back-to-back calls, beside K9's fill and fill_ of
    # an output of its size: the store floor, timed in turns in this call
    from tinycarlo_torch.ops import probe_kernels as pk

    floor = torch.empty((n, md.n_layers) + res, dtype=torch.uint8,
                        device="cuda")
    fns = {
        "kernel": lambda: kernel(bundle, md.n_layers, res, t),
        "fill": lambda: pk.fill_kernel(floor, 0),
        "fill_": lambda: floor.fill_(0),
    }
    if kernel is rk.exact_kernel:  # beside its float32 output
        fns["float32"] = lambda: kernel(bundle, md.n_layers, res, t,
                                        out_dtype=torch.float32)
    out["back_to_back"] = back_to_back_ms(fns)
    return out


def exact_bundle_rows(bundle):
    """(B, ...) int32 rows of an exact compaction bundle on the CPU, one
    per env: its counts column, then each slot's copy index and 30 fields,
    zero for a dead slot -- what the kernel reads. (The compaction also
    fills the fields of copies no slot reads, among them undrawn segments
    projected to ~1e9 px, where float32 differs between the devices.)"""
    import torch

    idx, fields, counts = bundle
    live = (torch.arange(idx.shape[1], device=idx.device)[None]
            < counts[0][:, None])
    stacked = torch.stack(fields, -1)  # (B, LE, 30)
    slots = stacked.gather(1, idx.long()[..., None].expand(
        -1, -1, stacked.shape[-1]))
    rows = torch.cat([idx[..., None], slots], -1) * live[..., None]
    return torch.cat([counts.T, rows.flatten(1)], 1).cpu()


def exact_frames_follow_bundles(frames, bundles):
    """Under the exact stroke a frame is a function of its env's bundle
    (integer fields; the kernel is bit-equal to its plain version). Checks
    that every card frame whose env has the CPU port's bundle equals the
    CPU port's frame; returns the number of frames whose bundles differ.
    `frames` and `bundles` hold the card's and the CPU's, each (N, ...)
    with N frames."""
    same = (bundles[0] == bundles[1]).flatten(1).all(1)
    differ = (frames[0] != frames[1]).flatten(1).any(1)
    check(not bool((same & differ).any()), "exact frames "
          f"{(same & differ).nonzero().flatten().tolist()} differ between "
          "the card and the CPU port although their bundles are equal")
    return int((~same).sum())


def compare_with_cpu(fenv, vector, stanley_steering, params_gpu):
    """8 envs, 20 steps of Stanley control on the card and on the CPU port
    (same spawn and respawn rows): car states within 1e-4 (float32 libm and
    matmul rounding differ between the two devices) and observations
    differing on under 0.5% of pixels (an endpoint that truncates to the
    other integer moves a stroke). Under the exact stroke the last frames
    must be equal in every env whose exact bundle is equal on both
    devices."""
    import torch

    from tinycarlo_torch.ops import rasterize_kernels as rk

    params_cpu = fenv.make_env_params(params_gpu.cfg, device="cpu")
    exact = kernel_pair(rk, params_cpu)[1] is rk.exact_kernel
    n, steps = 8, 20
    rows = torch.arange(n) % params_cpu.map_data.spawns.count
    states, obs, bundles = [], [], []
    for params in (params_gpu, params_cpu):
        dev = params.device
        vstate, o = vector.reset(params, n, spawn_rows=rows.to(dev))
        info = fenv._info(params, vstate.env)
        for _ in range(steps):
            steer = torch.clamp(stanley_steering(
                info["cte"], info["heading_error"], SPEED, K,
                params.cfg.car.max_steering_angle), -1.0, 1.0)
            action = {"car_control": torch.stack(
                [torch.full_like(steer, SPEED), steer], -1),
                "maneuver": torch.zeros(n, dtype=torch.int32, device=dev)}
            vstate, o, _, _, _, info = vector.step(
                params, vstate, action, max_episode_steps=12,
                respawn_rows=rows.to(dev),
            )
        states.append(vstate.env.car.position.cpu())
        obs.append(o.cpu())
        if exact:
            bundles.append(exact_bundle_rows(bench_bundle(
                fenv, rk, params, vstate.env)))
    err = (states[0] - states[1]).abs().max().item()
    check(err < 1e-4, f"GPU and CPU car positions differ by {err}")
    frac = (obs[0] != obs[1]).float().mean().item()
    check(frac < 0.005, f"GPU and CPU observations differ on {frac:.4%}")
    moved = ""
    if exact:
        moved = (f"; {exact_frames_follow_bundles(obs, bundles)} of {n} "
                 "envs' exact bundles differ, every other frame is equal")
    print(f"cpu check ({params_gpu.cfg.camera.stroke} stroke): 8 envs x 20 "
          f"steps, positions within {err:.2e}, observations differ on "
          f"{frac:.4%} of pixels{moved}")


def serving_setup(stroke):
    """(params, combo policy, combo) of the example's config with
    `stroke`."""
    from tinycarlo_torch import env as fenv
    from tinycarlo_torch.models.tinycar_net import load_pretrained
    from tinycarlo_torch.train.evaluate import combo_policy

    params = with_stroke(fenv.make_env_params(SERVE_CONFIG), stroke)
    check(params.cfg.sim.observation_space_format == "rgb",
          "the example's config should render rgb")
    model = load_pretrained(fenv.observation_shape(params))
    check(model is not None, "no bundled combo for the example's frames")
    return params, combo_policy(model), model


def protocol_worker_init():
    """A protocol worker's float32 settings: the parent's (TF32 off)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


_WORKER_SETUP = {}


def protocol_maneuver(stroke, maneuver, steps, episodes, sequential):
    """One maneuver of a serving protocol, in a worker process: evaluate's
    metrics (without the positions) and, under "launches", each render
    kernel's launch count in this call. The example's protocol runs at
    SERVE_SEED; the sequential one is policy_parity's, through its
    module's `our_eval` (evaluate's default seed, as the script's)."""
    from tinycarlo_torch.benchmarks import policy_parity
    from tinycarlo_torch.ops import rasterize_kernels as rk
    from tinycarlo_torch.train.evaluate import evaluate

    if stroke not in _WORKER_SETUP:
        _WORKER_SETUP[stroke] = serving_setup(stroke)
    params, act, model = _WORKER_SETUP[stroke]
    kernels = (rk.masks_kernel, rk.rank_kernel, rk.exact_kernel,
               rk.front_kernel)
    for k in kernels:
        k.launches = 0
    stats = {}
    if sequential:
        r = policy_parity.our_eval(model, maneuver, steps, episodes,
                                   stroke, stats=stats)
    else:
        r = evaluate(act, params, maneuver, None, seed=SERVE_SEED,
                     steps=steps, episodes=episodes, stats=stats)
        del r["positions"]
    r["launches"] = {k.NAME: k.launches for k in kernels}
    r["graph"] = {"replays": 0, "captures": 0, **stats}
    return r


def serving_protocol(pool, params, act, kernel, steps, episodes, budget_s,
                     sequential):
    """Maneuvers 0, 1, 2 through `evaluate` (`protocol_maneuver`: seed 10,
    or policy_parity's `our_eval` when sequential), one per process of
    `pool` at the same time (each evaluate call seeds its own generator,
    so the metrics are those of three calls in a row): each cte_avg finite
    and below CTE_LIMIT, `kernel` launched once per eager render and
    capture (evaluate's rollout replays a captured graph for the rest) and
    no other render kernel. Steps are cut (and the cut printed) if one
    maneuver would take over `budget_s` at the per-step time of an eager
    probe in this process, which is printed beside the graph's rates."""
    import numpy as np

    from tinycarlo_torch.train.evaluate import evaluate

    # timed after a warm-up: the first forward initialises cuDNN
    evaluate(act, params, 0, None, seed=SERVE_SEED, steps=5, episodes=episodes,
             sequential=sequential, graph=False)
    probe = 20
    start = time.perf_counter()
    evaluate(act, params, 0, None, seed=SERVE_SEED, steps=probe,
             episodes=episodes, sequential=sequential, graph=False)
    per_step = (time.perf_counter() - start) / probe
    if sequential:
        per_step /= episodes  # a sequential call steps episodes * steps times
    print(f"{kernel.NAME} serving protocol, eager probe: "
          f"{per_step * 1e3:.2f} ms per step, {episodes if not sequential else 1}"
          f" env-steps each ({(1 if sequential else episodes) / per_step:.2f}"
          f" env-steps/s)")
    runs = episodes if sequential else 1
    full = steps
    if steps * runs * per_step > budget_s:
        steps = max(100, int(budget_s / (runs * per_step)) // 100 * 100)
        print(f"{kernel.NAME} serving protocol: steps cut from {full} to "
              f"{steps} ({per_step * 1e3:.2f} ms per step)")
    renders = steps * episodes if sequential else steps
    start = time.perf_counter()
    results = pool.starmap(protocol_maneuver, [
        (params.cfg.camera.stroke, maneuver, steps, episodes, sequential)
        for maneuver in range(3)])
    for maneuver, r in enumerate(results):
        launches = r["launches"]
        g = r["graph"]
        check(launches[kernel.NAME] == renders - g["replays"] + g["captures"],
              f"{kernel.NAME} kernel launched {launches[kernel.NAME]} times "
              f"for {renders} renders, {g['replays']} of them replayed and "
              f"{g['captures']} captures")
        others = [name for name, count in launches.items()
                  if name not in (kernel.NAME, "front") and count]
        check(not others, f"the rgb path ran the {others} kernel")
        check_front(launches, f"serving maneuver {maneuver}")
        print(
            f"Maneuver {maneuver} -> Total reward: {r['total_reward']:.2f} | "
            f"CTE: {r['cte_avg']:.4f} m/step var: {r['cte_var']:.4f} | "
            f"Heading Error: {r['heading_error_avg']:.4f} rad/step var "
            f"{r['heading_error_var']:.4f} | Terminations: "
            f"{r['terminations']:3d} | perf: {r['steps_per_s']:.2f} steps/s"
        )
        check(np.isfinite(r["cte_avg"]) and r["cte_avg"] < CTE_LIMIT,
              f"maneuver {maneuver}: cte_avg {r['cte_avg']} is not below "
              f"{CTE_LIMIT} m")
    print(f"{kernel.NAME} serving protocol: 3 maneuvers x {episodes} "
          f"{'sequential ' if sequential else ''}episodes x {steps} steps in "
          f"{time.perf_counter() - start:.1f} s (one process per maneuver)")


def serving_batch(card, params, act, kernel, repeats):
    """4096 episodes of CHUNK steps, `repeats` times, after a warm-up:
    env-steps/s with the policy and `kernel` launched once per render.
    Returns the median rate and the peak memory in GB."""
    import warnings

    import numpy as np
    import torch

    from tinycarlo_torch.ops import rasterize_kernels as rk
    from tinycarlo_torch.train.evaluate import evaluate

    kernels = (rk.masks_kernel, rk.rank_kernel, rk.exact_kernel,
               rk.front_kernel)
    for k in kernels:
        k.launches = 0
    stats = {"replays": 0, "captures": 0}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        evaluate(act, params, 0, None, seed=0, steps=WARMUP,
                 episodes=N_ENVS, stats=stats)
        torch.cuda.reset_peak_memory_stats()
        rates = []
        for rep in range(repeats):
            r = evaluate(act, params, 0, None, seed=1 + rep, steps=CHUNK,
                         episodes=N_ENVS, stats=stats)
            check(np.isfinite(r["cte_avg"]) and np.isfinite(r["positions"])
                  .all(), "non-finite serving metrics")
            rates.append(r["steps_per_s"])
        # one eager repeat, the rate before the rollout graph
        eager = evaluate(act, params, 0, None, seed=1, steps=CHUNK,
                         episodes=N_ENVS, graph=False)
    dropped = [str(w.message) for w in caught if "dropped" in str(w.message)]
    check(not dropped, f"segment overflow while serving: {dropped}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = kernel.launches
    renders = WARMUP + (repeats + 1) * CHUNK
    check(launches == renders - stats["replays"] + stats["captures"],
          f"{kernel.NAME} kernel launched {launches} times for {renders} "
          f"renders, {stats['replays']} of them replayed and "
          f"{stats['captures']} captures")
    others = [k.NAME for k in kernels
              if k not in (kernel, rk.front_kernel) and k.launches]
    check(not others, f"the rgb path ran the {others} kernel")
    check_front({k.NAME: k.launches for k in kernels},
                f"{kernel.NAME} serving")
    rates.sort()
    print(f"{kernel.NAME} serving: {N_ENVS} envs x {renders} steps, "
          f"{launches} {kernel.NAME} kernel launches")
    print(f"{kernel.NAME} serving env-steps/s (policy included), "
          f"through the rollout graph: median "
          f"{statistics.median(rates):.1f} (min {rates[0]:.1f}, max "
          f"{rates[-1]:.1f}, {repeats} repeats of {CHUNK} steps); eager "
          f"{eager['steps_per_s']:.1f} (one repeat) on {card}; "
          f"peak memory {peak_gb:.2f} GB")
    return statistics.median(rates), peak_gb


def serving_step_fn(params, act):
    """(vstate, one iteration of evaluate's loop at 4096 envs)."""
    import torch

    from tinycarlo_torch import env as fenv
    from tinycarlo_torch import vector
    from tinycarlo_torch.train.evaluate import standard_stack

    stack = standard_stack()
    vstate, _ = vector.reset(params, N_ENVS, seed=0, stack=stack,
                             render=False)
    m = torch.zeros(N_ENVS, dtype=torch.int32, device=params.device)

    def serving_step(vstate):
        obs = fenv.render_observation_batch(params, vstate.env)
        steering, _ = act(obs, m, None)
        action = {"car_control": torch.stack(
            [torch.full_like(steering, 0.35), steering], dim=-1),
            "maneuver": m}
        return vector.step(params, vstate, action, stack=stack,
                           render=False)[0]

    return vstate, stack, m, serving_step


def serve(card, rank_err, pool):
    """Phase 10: the bundled combo served on rgb frames through the port's
    evaluate, the protocol's maneuvers in `pool`'s processes. Returns the
    rank kernel's entry of the `kernels` line."""
    from tinycarlo_torch import env as fenv
    from tinycarlo_torch import vector
    from tinycarlo_torch.ops import rasterize as ras
    from tinycarlo_torch.ops import rasterize_kernels as rk

    params, act, _ = serving_setup("fast")
    serving_protocol(pool, params, act, rk.rank_kernel, SERVE_STEPS,
                     SERVE_EPISODES, SERVE_BUDGET_S, sequential=False)
    rate, peak_gb = serving_batch(card, params, act, rk.rank_kernel,
                                  FAST_REPEATS)
    launches = rk.rank_kernel.launches

    vstate, stack, m, serving_step = serving_step_fn(params, act)
    times = serving_stage_times(fenv, vector, rk, ras, params, vstate, act,
                                stack, m)
    wall_ms = 1e3 * N_ENVS / rate
    busy_ms, top, by_name, _ = device_profile(lambda: serving_step(vstate))
    times["rank kernel_device"] = kernel_device_ms(by_name, "rank_kernel")
    fmt = lambda x: "not measured" if x is None else f"{x:.4f} ms"  # noqa
    print(f"serving per step at {N_ENVS} envs on {card}, event ms / "
          f"device-busy ms:")
    for key in times["stages"]:
        print(f"  {key}: {times[key]:.4f} ms / {fmt(times[key + '_device'])}")
    print(f"  plain version of the front kernel (the projection and "
          f"compaction as torch ops): {times['front_plain']:.4f} ms")
    print(f"  plain version of the rank kernel: {times['plain']:.4f} ms")
    b2b = times["back_to_back"]
    print(f"  rank kernel alone in back-to-back calls: {b2b['kernel']:.4f} "
          f"ms; store floor, an output of its size filled: K9's fill "
          f"{b2b['fill']:.4f} ms, fill_ {b2b['fill_']:.4f} ms (kernel / K9 "
          f"fill {b2b['kernel'] / b2b['fill']:.2f})")
    if busy_ms is None:
        print("serving step: device busy share not measured (the profiler "
              "trace holds no device time)")
    else:
        print(f"serving step: wall {wall_ms:.3f} ms, device busy "
              f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}, "
              f"peak memory {peak_gb:.2f} GB")
        for key, ms, count in top:
            print(f"  {ms:.4f} ms/step x{count}: {key}")

    compare_serving_with_cpu(fenv, vector, params, act)

    res = tuple(params.cfg.camera.resolution)
    t = params.cfg.camera.line_thickness
    n_bytes, n_ops = bundle_bytes_and_ops(rk, times["bundle"], res, t,
                                          N_ENVS * res[0] * res[1])
    bound_ms, by, t_bytes, t_ops = bound(n_bytes, n_ops, PEAK_F32_PER_S)
    print(f"rank kernel bound on {card}: {n_bytes / 1e6:.1f} MB -> "
          f"{t_bytes:.4f} ms, {n_ops / 1e9:.2f} GOP f32 -> {t_ops:.4f} ms")
    return {
        "name": "rank",
        "route": "cuda",
        "source": "tinycarlo_torch/ops/csrc/rank.cu",
        "replaces": "tinycarlo_tpu/ops/rasterize_pallas.py:1493 "
                    "(_kernel_env_rank)",
        "launches": launches,
        "max_abs_err": rank_err,
        "ms": times["rank kernel"],
        "plain_ms": times["plain"],
        "bound_ms": bound_ms,
        "bound_by": by,
        # no single PyTorch call rasterizes compacted segment stamps into
        # a layer-rank map, so there is no library yardstick
        "library_ms": None,
    }


def serve_exact(card, pool):
    """Phase 11: the bundled combo on the exact stroke's rgb frames (the
    exact kernel's masks, decoded): policy_parity.py's protocol (its
    maneuvers in `pool`'s processes), 4096 envs, and the card against the
    CPU port."""
    from tinycarlo_torch import env as fenv
    from tinycarlo_torch import vector
    from tinycarlo_torch.ops import rasterize_kernels as rk

    params, act, _ = serving_setup("exact")
    serving_protocol(pool, params, act, rk.exact_kernel, EXACT_SERVE_STEPS,
                     EXACT_SERVE_EPISODES, EXACT_SERVE_BUDGET_S,
                     sequential=True)
    rate, peak_gb = serving_batch(card, params, act, rk.exact_kernel,
                                  FAST_REPEATS)
    vstate, _, _, serving_step = serving_step_fn(params, act)
    busy_ms, top, by_name, _ = device_profile(lambda: serving_step(vstate))
    wall_ms = 1e3 * N_ENVS / rate
    kernel_ms = kernel_device_ms(by_name, "exact_kernel")
    if busy_ms is None:
        print("exact serving step: device busy share not measured (the "
              "profiler trace holds no device time)")
    else:
        kernel_ms = "not measured" if kernel_ms is None else f"{kernel_ms:.4f}"
        print(f"exact serving step: wall {wall_ms:.3f} ms, device busy "
              f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}, "
              f"exact kernel {kernel_ms} ms device, peak memory "
              f"{peak_gb:.2f} GB")
        for key, ms, count in top:
            print(f"  {ms:.4f} ms/step x{count}: {key}")
    compare_serving_with_cpu(fenv, vector, params, act)


def serving_stage_times(fenv, vector, rk, ras, params, vstate, act, stack,
                        m):
    """Per-stage ms of one serving step at 4096 envs: event ms and profiler
    device ms (see stage_times; the rank kernel's device ms comes from the
    whole step's trace), and the front and rank kernels' plain
    versions."""
    import torch

    md = params.map_data
    res = tuple(params.cfg.camera.resolution)
    t = params.cfg.camera.line_thickness
    n = m.shape[0]
    bundle = bench_bundle(fenv, rk, params, vstate.env)
    rank = rk.rank_kernel(bundle, md.n_layers, res, t)
    obs = ras.rgb_from_rank(rank, md.laneline_colors)
    action = {"car_control": torch.full((n, 2), 0.35, device=m.device),
              "maneuver": m}
    stages = {
        **render_front_stages(fenv, rk, params, vstate.env),
        "rank kernel": lambda: rk.rank_kernel(bundle, md.n_layers, res, t),
        "rgb composite": lambda: ras.rgb_from_rank(rank, md.laneline_colors),
        "policy": lambda: act(obs, m, None),
        "step": lambda: vector.step(params, vstate, action, stack=stack,
                                    render=False),
    }
    out = {"bundle": bundle, "stages": list(stages),
           **front_plain_ms(fenv, rk, params, vstate.env)}
    for key, fn in stages.items():
        out[key] = cuda_ms(fn, repeats=20 if key == "rank kernel" else 7)
        if key != "rank kernel":  # its device ms: see kernel_device_ms
            out[key + "_device"] = device_profile(fn)[0]
    out["plain"] = cuda_ms(lambda: rk.rasterize_rank_env_plain(
        bundle, md.n_layers, res, t), repeats=5, warmup=1)
    # the kernel alone in back-to-back calls, beside K9's fill and fill_ of
    # an output of its size (the store floor), as stage_times does
    from tinycarlo_torch.ops import probe_kernels as pk

    out["back_to_back"] = back_to_back_ms({
        "kernel": lambda: rk.rank_kernel(bundle, md.n_layers, res, t),
        "fill": lambda: pk.fill_kernel(rank, 0),
        "fill_": lambda: rank.fill_(0),
    })
    return out


def compare_serving_with_cpu(fenv, vector, params_gpu, act_gpu):
    """8 envs, 20 combo-driven steps of the serving path on the card and on
    the CPU port (same spawn and respawn rows, each device's own combo and
    frames): steering within STEER_ATOL at every (step, env) whose frames
    are equal, within STEER_ATOL_MOVED where they differ, and rgb frames
    that differ on under 0.5% of pixels. Under the exact stroke every
    frame whose env has the same exact bundle on both devices must be
    equal."""
    import torch

    from tinycarlo_torch.models.tinycar_net import load_pretrained
    from tinycarlo_torch.ops import rasterize_kernels as rk
    from tinycarlo_torch.train.evaluate import combo_policy, standard_stack

    params_cpu = fenv.make_env_params(params_gpu.cfg, base_path=SERVE_CONFIG,
                                      device="cpu")
    exact = kernel_pair(rk, params_cpu)[1] is rk.exact_kernel
    act_cpu = combo_policy(load_pretrained(
        fenv.observation_shape(params_cpu), device="cpu"))
    n, steps = 8, 20
    rows = torch.arange(n) % params_cpu.map_data.spawns.count
    m = torch.arange(n, dtype=torch.int32) % 3
    steer, frames, bundles = [], [], []
    for params, act in ((params_gpu, act_gpu), (params_cpu, act_cpu)):
        dev = params.device
        stack = standard_stack()
        vstate, _ = vector.reset(params, n, stack=stack, render=False,
                                 spawn_rows=rows.to(dev))
        s_run, f_run, b_run = [], [], []
        for _ in range(steps):
            obs = fenv.render_observation_batch(params, vstate.env)
            s, _ = act(obs, m.to(dev), None)
            s_run.append(s.cpu())
            f_run.append(obs.cpu())
            if exact:
                b_run.append(exact_bundle_rows(bench_bundle(
                    fenv, rk, params, vstate.env)))
            action = {"car_control": torch.stack(
                [torch.full_like(s, 0.35), s], dim=-1),
                "maneuver": torch.where(m != 2, m, 3).to(dev)}
            vstate = vector.step(params, vstate, action, stack=stack,
                                 render=False, max_episode_steps=12,
                                 respawn_rows=rows.to(dev))[0]
        steer.append(torch.stack(s_run))
        frames.append(torch.stack(f_run))
        if exact:
            bundles.append(torch.cat(b_run))
    diff = (frames[0] != frames[1]).any(-1)  # (steps, n, H, W)
    moved = diff.flatten(2).any(-1)  # (steps, n): the frames differ
    err = (steer[0] - steer[1]).abs()
    err_equal = err[~moved].max().item() if (~moved).any() else 0.0
    err_moved = err[moved].max().item() if moved.any() else 0.0
    check(err_equal < STEER_ATOL, f"GPU and CPU steering differ by "
          f"{err_equal} on equal frames")
    check(err_moved < STEER_ATOL_MOVED, f"GPU and CPU steering differ by "
          f"{err_moved} where the frames differ")
    frac = diff.float().mean().item()
    check(frac < 0.005, f"GPU and CPU rgb frames differ on {frac:.4%}")
    bundle_note = ""
    if exact:
        n_moved = exact_frames_follow_bundles(
            [f.flatten(0, 1) for f in frames], bundles)
        bundle_note = (f"; {n_moved} frames' exact bundles differ, every "
                       "other frame is equal")
    print(f"serving cpu check ({params_gpu.cfg.camera.stroke} stroke): 8 envs"
          f" x 20 combo-driven steps, steering within {err_equal:.2e} on "
          f"{int((~moved).sum())} equal frames and {err_moved:.2e} on "
          f"{int(moved.sum())} differing ones; rgb frames differ on "
          f"{frac:.4%} of pixels{bundle_note}")


# BASELINE config 3's frame and batch (benchmarks/baseline_configs.py:
# 84-163): 480x640 at 512 envs; random segments (`segments`) stand in for
# knuffingen's, whose path is not ported yet
BIG_ENVS, BIG_EDGES, BIG_RES = 512, 200, (480, 640)


def kernels_480x640(card, rk):
    """Phase 12: the masks, rank and exact kernels alone (CUDA events,
    median of 20) at 480x640 on random 512-env bundles (t = 2; 48-row
    chunks), the exact kernel in uint8 and float32, each beside its bound
    and the store floor (`fill_` of its output), each output equal to its
    plain version's on the same bundle."""
    import torch

    t, (h, w) = 2, BIG_RES
    L = 5
    fast = random_bundle(rk, 41, BIG_ENVS, BIG_EDGES, h, w, t, BIG_EDGES,
                         "cuda")
    exact = random_bundle(rk, 42, BIG_ENVS, BIG_EDGES, h, w, t, BIG_EDGES,
                          "cuda", exact=True)
    runs = [
        ("masks", lambda: rk.masks_kernel(fast, L, BIG_RES, t),
         lambda: rk.rasterize_masks_env_plain(fast, L, BIG_RES, t),
         lambda n: bundle_bytes_and_ops(rk, fast, BIG_RES, t, n),
         PEAK_F32_PER_S),
        ("rank", lambda: rk.rank_kernel(fast, L, BIG_RES, t),
         lambda: rk.rasterize_rank_env_plain(fast, L, BIG_RES, t),
         lambda n: bundle_bytes_and_ops(rk, fast, BIG_RES, t, n),
         PEAK_F32_PER_S),
    ]
    for dt in (torch.uint8, torch.float32):
        runs.append((
            f"exact {str(dt).split('.')[-1]}",
            lambda dt=dt: rk.exact_kernel(exact, L, BIG_RES, t, out_dtype=dt),
            lambda dt=dt: rk.rasterize_masks_exact_env_plain(
                exact, L, BIG_RES, t, out_dtype=dt),
            lambda n: exact_bytes_and_ops(rk, exact, BIG_RES, t, n),
            PEAK_I32_PER_S))
    for name, fn, plain, work, peak in runs:
        out = fn()
        check(torch.equal(out, plain()) and bool(out.any()),
              f"{name} kernel at 480x640 differs from its plain version or "
              "draws nothing")
        n_bytes, n_ops = work(out.numel() * out.element_size())
        bound_ms, by, t_bytes, t_ops = bound(n_bytes, n_ops, peak)
        ms = cuda_ms(fn, repeats=20)
        floor_ms = cuda_ms(lambda: out.fill_(0), repeats=20)
        print(f"{name} kernel at 480x640, {BIG_ENVS} envs, t={t} on {card}: "
              f"{ms:.4f} ms; store floor (fill_ of its "
              f"{out.numel() * out.element_size() / 1e6:.1f} MB) "
              f"{floor_ms:.4f} ms; bound {n_bytes / 1e6:.1f} MB -> "
              f"{t_bytes:.4f} ms, {n_ops / 1e9:.2f} GOP -> {t_ops:.4f} ms: "
              f"{by} bind")


def shim_kernel_vs_plain(rk, ras, fenv, env, actions, seed):
    """The render kernel of a shim on the card against its plain version
    on the bundle of the shim's own state after each of these steps (B =
    1, the config's frame and stroke), bit for bit, and the step's
    observation equal to the plain version's frame. Returns (kernel, max
    |error|, steps)."""
    import numpy as np

    params = env.params
    md = params.map_data
    kernel = fenv.render_kernel(params)
    geometry = (md.n_layers, tuple(params.cfg.camera.resolution),
                params.cfg.camera.line_thickness)
    check(env.observation_space_format in (
        ("classes", "rgb") if kernel is rk.rank_kernel else ("classes",)),
        f"no plain frame for {env.observation_space_format} here")
    err = 0.0
    env.reset(seed=seed)
    for action in actions:
        obs, _, terminated, truncated, _ = env.step(action)
        bundle = bench_bundle(fenv, rk, params, env.state)
        check(bundle[0].shape[0] == 1, "a shim's bundle holds one env")
        if kernel is rk.rank_kernel:
            err = max(err, rank_vs_plain(rk, ras, bundle, *geometry))
            rank = rk.rasterize_rank_env_plain(bundle, *geometry)
            frame = ras.rgb_from_rank(rank, md.laneline_colors)
        else:
            plain = (rk.rasterize_masks_exact_env_plain
                     if kernel is rk.exact_kernel
                     else rk.rasterize_masks_env_plain)
            err = max(err, kernel_vs_plain(kernel, plain, bundle, *geometry))
            frame = plain(bundle, *geometry)
        check(np.array_equal(obs, frame[0].cpu().numpy()), f"a shim step's "
              f"observation differs from the plain {kernel.NAME} frame")
        if terminated or truncated:
            env.reset()
    return kernel, err, len(actions)


def replay_trace(card, name, env, kernel, gb):
    """The kernel records, device-busy ms, idle share and render-kernel
    device ms of a replayed step of `env` (a trace of TRACED replays of
    one action), which must hold one record of the render kernel a
    replay; the replays leave the wrappers' counts as they were."""
    env.reset(seed=gb.SEED)
    action = gb.actions(1)[0]
    before = kernel.launches
    busy_ms, top, by_name, wall_ms = device_profile(
        lambda: env.step(action), calls=TRACED)
    check(kernel.launches == before, f"{name}: replays counted launches")
    records = sum(c for _, c in by_name.values())
    kernel_ms = kernel_device_ms(by_name, f"{kernel.NAME}_kernel")
    check(busy_ms is not None and kernel_ms is not None,
          f"{name}: a trace of {TRACED} replayed steps does not hold "
          f"one {kernel.NAME} kernel record a step")
    print(f"{name} replayed step, traced ({TRACED} steps) on {card}: "
          f"wall {wall_ms:.4f} ms, device busy {busy_ms:.4f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.4f}, {records:g} kernel records a "
          f"step, {kernel.NAME} kernel {kernel_ms:.4f} ms device")
    for key, ms, count in top[:3]:
        print(f"  {ms:.4f} ms/step x{count}: {key}")


def gym_shim(card, rk):
    """Phase 13: the Gymnasium shim (gym_env.TinyCarloEnv) at B = 1 on
    tinycarlo_torch.benchmarks.gym_bench's two configs and config 1 under
    the exact stroke: the render kernel against its plain version on the
    shim's own bundles; steps/s through the replayed graph, eagerly on the
    card and on the CPU (200 steps each), the wrappers' launch counts
    equal to the eager renders and captures; one render-kernel record a
    replayed step in a trace of TRACED replays, and its kernel records,
    device time and idle share; 20 replayed steps equal to 20 eager steps
    bit for bit; a 30-step rollout on the card against the CPU shim; the
    wrapper stack and NoiseObservationWrapper for 100 steps on the card.
    Prints the seconds of each part."""
    import numpy as np

    from tinycarlo_torch import env as fenv
    from tinycarlo_torch import wrapper as pw
    from tinycarlo_torch.benchmarks import gym_bench as gb
    from tinycarlo_torch.ops import rasterize as ras

    clock = PhaseClock()
    configs = dict(gb.CONFIGS, config1_exact=gb.CONFIG1_EXACT)
    for name, config in configs.items():
        env = gb.make_env(config, "graph")
        kernel, err, n = shim_kernel_vs_plain(
            rk, ras, fenv, env, gb.actions(6, seed=6), gb.SEED)
        print(f"gym {name}: the {kernel.NAME} kernel equal to its plain "
              f"version on the shim's B = 1 bundles of {n} steps (max "
              f"|error| {err:g}), each step's observation equal to the "
              "plain frame")
        clock.done(f"  gym {name} plain check")
        exact = name not in gb.CONFIGS
        for mode in ("graph",) if exact else gb.MODES:
            r = gb.measure(name, mode, steps=50 if exact else gb.STEPS,
                           config=config)
            check(r["launches"] == r["want_launches"], f"gym {name} {mode}: "
                  f"launches {r['launches']}, not {r['want_launches']} "
                  f"({r['renders']} renders, {r['replays']} replays, "
                  f"{r['captures']} capture)")
            check(mode != "graph" or r["replays"] == r["steps"],
                  f"gym {name}: {r['replays']} replays of {r['steps']} steps")
            print(f"gym {name} ({r['format']}) {mode}: {r['steps']} steps, "
                  f"{r['steps_per_s']:.1f} steps/s, {r['ms_step']:.4f} ms a "
                  f"step (first step {r['first_ms']:.1f} ms), {r['resets']} "
                  f"resets, {r['renders']} renders, {r['replays']} replays, "
                  f"wrapper launches {r['launches']}, on {card}")
        clock.done(f"  gym {name} runs")
        # a replay's launch passes no wrapper: the trace counts them
        replay_trace(card, f"gym {name}", env, kernel, gb)
        env.close()
        equal = gb.graph_matches_eager(config, steps=20)
        check(equal == 20, f"gym {name}: {20 - equal} of 20 replayed steps "
              "differ from eager steps")
        print(f"gym {name}: 20 replayed steps equal to 20 eager steps bit "
              "for bit")
        clock.done(f"  gym {name} traces and replays")

    # the card against the CPU shim: config 1, 30 steps, same actions
    envs = [gb.make_env(gb.CONFIG1, mode) for mode in ("graph", "cpu")]
    for env in envs:
        env.reset(seed=gb.SEED)
    err, frac = 0.0, 0.0
    for action in gb.actions(30):
        outs = [env.step(action) for env in envs]
        (obs_g, _, te_g, tr_g, info_g), (obs_c, _, te_c, tr_c, info_c) = outs
        check((te_g, tr_g) == (te_c, tr_c), "gym: the card's and the CPU's "
              "terminations differ")
        err = max(err, float(np.abs(info_g["position"]
                                     - info_c["position"]).max()))
        frac = max(frac, float((obs_g != obs_c).mean()))
        if te_g or tr_g:
            for env in envs:
                env.reset()
    check(err < 1e-4 and frac < 0.005, f"gym: card and CPU shims differ: "
          f"positions by {err}, {frac:.4%} of pixels")
    print(f"gym cpu check: config1, 30 steps, positions within {err:.2e}, "
          f"observations differ on at most {frac:.4%} of pixels")
    clock.done("  gym cpu check")

    # the wrapper stack (the reference TD3 stack and laneline shaping) and
    # blob noise on the card
    env = gb.make_env(gb.CONFIG1, "graph")
    np.random.seed(0)
    wrapped = pw.NoiseObservationWrapper(env, blob_max_radius=20, n_blobs=5)
    wrapped = pw.CTELinearRewardWrapper(wrapped, min_cte=0.03,
                                        max_reward=1.0, min_reward=-1.0)
    wrapped = pw.LanelineSparseRewardWrapper(wrapped, {"outer": -2.0})
    wrapped = pw.CTETerminationWrapper(wrapped, max_cte=0.1,
                                       number_of_steps=5)
    wrapped = pw.LanelineCrossingTerminationWrapper(wrapped, ["outer"])
    wrapped = pw.CrashTerminationWrapper(wrapped, number_of_steps=10)
    wrapped.reset(seed=gb.SEED)
    ends, total = 0, 0.0
    for action in gb.actions(100, seed=4):
        obs, reward, terminated, truncated, _ = wrapped.step(action)
        check(obs.shape == env.observation_space.shape
              and set(np.unique(obs)) <= {0, 255}, "gym: a noised "
              "observation of another shape or values")
        total += reward
        if terminated or truncated:
            ends += 1
            wrapped.reset()
    check(np.isfinite(total) and env.wrapped, "gym: wrapped rewards")
    print(f"gym wrappers: the five-wrapper stack and blob noise, 100 steps "
          f"on the card: {ends} episodes ended, reward sum {total:.4f}")
    clock.done("  gym wrappers")


# ---- 14. TD3 (BASELINE config 4) -------------------------------------------
# td3_bench's runs in this phase: (envs, observation and encoder dtype,
# traced), cut to fit the phase's time: 100-step chunks (not 200), 1 warm
# (not 2), 2 timed (not 5) and 1 x 2 pipelined chunks (not 3 x 5), a
# traced 20-step chunk in the first run only (the full protocol: `python
# -m tinycarlo_torch.benchmarks.td3_bench`)
TD3_RUNS = ((1024, "bfloat16", True), (64, "bfloat16", False),
            (1024, "float32", False))
TD3_PROTOCOL = {"chunk_steps": 100, "warm": 1, "repeats": 2,
                "pipe_chunks": 2, "pipe_rounds": 1, "profile_steps": 20}
# (seed, B, E, h, w, t, k per block) of the bfloat16 checks' random bundles
TD3_RANDOM = ((21, 32, 120, 30, 48, 2, 120), (22, 16, 200, 100, 150, 3, 200),
              (23, 8, 200, 480, 640, 2, 200))
# card against CPU port: 8 envs x 12 steps from one state with injected
# draws. The two devices' float32 projections differ in the last bits, so
# a stroke-boundary pixel, and so a feature, may differ; positions within
# 1e-4 m; losses within a relative 1e-3: the card's and the CPU's float32
# sums differ in order, and Adam's first steps move a weight by about lr
# wherever a gradient near zero changes sign
TD3_CPU_ENVS, TD3_CPU_STEPS = 8, 12
TD3_POS_ATOL, TD3_LOSS_RTOL = 1e-4, 1e-3


def td3_config4(**kw):
    """(TD3Config, LoopConfig, stack) of BASELINE config 4
    (baseline_configs.py:166-262), LoopConfig fields overridden by `kw`."""
    import torch

    from tinycarlo_torch.train import td3
    from tinycarlo_torch.train.evaluate import standard_stack
    from tinycarlo_torch.train.td3_loop import LoopConfig

    loop_kw = {"speed": 0.4, "replay_size": 100_000,
               "max_episode_steps": 1000, "obs_dtype": torch.bfloat16}
    loop_kw.update(kw)
    return td3.TD3Config(), LoopConfig(**loop_kw), standard_stack()


def td3_bench_runs(card, rk):
    """(b): td3_bench at TD3_RUNS: each run's line, its checks (the masks
    kernel launched once per eager step and capture, replays the rest; one
    masks-kernel record a step in the traced chunk; finite, nonzero
    losses; the buffer's fill; the actor moved). Returns the 1024-env
    bfloat16 run's (state, params)."""
    from tinycarlo_torch.benchmarks import td3_bench

    kept = None
    for n, dtype, traced in TD3_RUNS:
        start = time.perf_counter()
        r = td3_bench.run(n_envs=n, obs_dtype=dtype, profile=traced,
                          **TD3_PROTOCOL)
        state, params = r.pop("state"), r.pop("params")
        check(r["launches"] == r["renders"] - r["replays"] + r["captures"],
              f"td3 {n} {dtype}: {r['launches']} masks-kernel launches for "
              f"{r['renders']} renders, {r['replays']} replayed and "
              f"{r['captures']} captures")
        check_front({"masks": r["launches"], "front": r["front_launches"]},
                    f"td3 {n} {dtype}")
        check(not traced or r["render_kernel_records_per_step"] == 1,
              f"td3 {n} {dtype}: {r['render_kernel_records_per_step']} "
              "masks-kernel records a step in a traced chunk")
        check(r["losses_finite"] and r["last_losses"]["critic1_loss"] != 0
              and r["last_losses"]["critic2_loss"] != 0,
              f"td3 {n} {dtype}: losses {r['last_losses']}")
        check(r["buffer_filled"] == min(100_000, r["renders"] * n),
              f"td3 {n} {dtype}: buffer_filled {r['buffer_filled']}")
        check(r["actor_moved"], f"td3 {n} {dtype}: the actor did not move")
        check(r["max_visible_overflow_at_reset"] == 0,
              f"td3 {n} {dtype}: segment overflow at reset")
        print(json.dumps(r))
        print(f"td3 {n} envs {dtype}: {r['value']} env-steps/s synced "
              f"(spread {r['spread']}), pipelined {r['pipelined_value']}; "
              f"{r['busy_ms_per_step']} ms busy a step, idle "
              f"{r['idle_share']}, masks kernel "
              f"{r['render_kernel_ms_per_step']} ms a step; "
              f"{time.perf_counter() - start:.1f} s on {card}")
        if (n, dtype) == (1024, "bfloat16"):
            kept = (state, params)
        del state
    return kept


def td3_kernels(card, rk, state, params):
    """(a): K1 in bfloat16 and float32 and K4 in bfloat16 bit-equal to
    their plain versions on the chunk's own 1024-env bundles and on random
    bundles at w = 48, 150 and 640; then the bfloat16 K1 alone and back to
    back beside the store floor (K9's fill, fill_) of its output."""
    import torch

    from tinycarlo_torch import env as fenv
    from tinycarlo_torch.ops import probe_kernels as pk

    md = params.map_data
    res = tuple(params.cfg.camera.resolution)
    t = params.cfg.camera.line_thickness
    bundle = bench_bundle(fenv, rk, params, state.vstate.env)
    err = kernel_vs_plain(rk.masks_kernel, rk.rasterize_masks_env_plain,
                          bundle, md.n_layers, res, t)
    params_exact = with_stroke(params, "exact")
    exact = bench_bundle(fenv, rk, params_exact, state.vstate.env)
    err = max(err, kernel_vs_plain(
        rk.exact_kernel, rk.rasterize_masks_exact_env_plain, exact,
        md.n_layers, res, t))
    for seed, b, e, h, w, tt, kb in TD3_RANDOM:
        for exact_stroke, kernel, plain in (
                (False, rk.masks_kernel, rk.rasterize_masks_env_plain),
                (True, rk.exact_kernel, rk.rasterize_masks_exact_env_plain)):
            rb = random_bundle(rk, seed, b, e, h, w, tt, kb, "cuda",
                               exact=exact_stroke)
            err = max(err, kernel_vs_plain(kernel, plain, rb, 5, (h, w), tt))
    print(f"td3 kernels: masks kernel (uint8, float32, bfloat16) and exact "
          f"kernel (the same) equal to their plain versions on the chunk's "
          f"{bundle[1].shape[0]}-env bundles and random bundles at w = 48, "
          f"150, 640; max |error| {err}")
    n = bundle[1].shape[0]
    bf16 = torch.bfloat16
    out_bytes = n * md.n_layers * res[0] * res[1] * 2
    one_ms = cuda_ms(lambda: rk.masks_kernel(bundle, md.n_layers, res, t,
                                             out_dtype=bf16), repeats=20)
    plain_ms = cuda_ms(lambda: rk.rasterize_masks_env_plain(
        bundle, md.n_layers, res, t, out_dtype=bf16), repeats=3, warmup=1)
    floor = torch.empty(out_bytes, dtype=torch.uint8, device="cuda")
    b2b = back_to_back_ms({
        "kernel": lambda: rk.masks_kernel(bundle, md.n_layers, res, t,
                                          out_dtype=bf16),
        "fill": lambda: pk.fill_kernel(floor, 0),
        "fill_": lambda: floor.fill_(0),
    })
    # the exact kernel in bfloat16 on the same states (the exact stroke's
    # encoder feed), beside the same floor
    exact_one = cuda_ms(lambda: rk.exact_kernel(exact, md.n_layers, res, t,
                                                out_dtype=bf16), repeats=20)
    exact_b2b = back_to_back_ms({
        "kernel": lambda: rk.exact_kernel(exact, md.n_layers, res, t,
                                          out_dtype=bf16),
        "fill": lambda: pk.fill_kernel(floor, 0),
    })
    exact_plain = cuda_ms(lambda: rk.rasterize_masks_exact_env_plain(
        exact, md.n_layers, res, t, out_dtype=bf16), repeats=3, warmup=1)
    e_bytes, e_ops = exact_bytes_and_ops(rk, exact, res, t, out_bytes)
    e_bound, e_by, _, _ = bound(e_bytes, e_ops, PEAK_I32_PER_S)
    print(f"exact kernel, bfloat16, {n} envs: {exact_one:.4f} ms alone, "
          f"{exact_b2b['kernel']:.4f} ms back to back (K9's fill "
          f"{exact_b2b['fill']:.4f} ms); plain {exact_plain:.4f} ms; bound "
          f"{e_bound:.4f} ms ({e_by}) on {card}")
    n_bytes, n_ops = bundle_bytes_and_ops(rk, bundle, res, t, out_bytes)
    bound_ms, by, t_bytes, t_ops = bound(n_bytes, n_ops, PEAK_F32_PER_S)
    print(f"masks kernel, bfloat16, {n} envs: {one_ms:.4f} ms alone, "
          f"{b2b['kernel']:.4f} ms back to back; store floor of its "
          f"{out_bytes / 1e6:.1f} MB output: K9's fill {b2b['fill']:.4f} "
          f"ms, fill_ {b2b['fill_']:.4f} ms; plain {plain_ms:.4f} ms; "
          f"bound {bound_ms:.4f} ms ({by}: {n_bytes / 1e6:.1f} MB -> "
          f"{t_bytes:.4f} ms, {n_ops / 1e9:.2f} GOP -> {t_ops:.4f} ms) "
          f"on {card}")


def td3_loop_states(params, n, seed, cfg=None, **kw):
    """A config-4 loop of `n` envs (bfloat16 frames and encoder unless
    `kw` says otherwise; `cfg` replacing the TD3Config) and its chunk
    arguments."""
    import torch

    from tinycarlo_torch.benchmarks import td3_bench
    from tinycarlo_torch.models.tinycar_net import encoder_apply_fn
    from tinycarlo_torch.train.td3_loop import init_loop

    default, loop_cfg, stack = td3_config4(**kw)
    cfg = cfg or default
    enc = encoder_apply_fn(td3_bench.make_encoder(
        params, loop_cfg.obs_dtype or torch.float32))
    state = init_loop(params, cfg, loop_cfg, n, seed=seed, stack=stack)
    return state, (params, cfg, loop_cfg, enc)


def states_equal(a, b):
    """Every tensor of two states equal bit for bit (NaN-free)."""
    import torch

    from tinycarlo_torch.utils import graphs

    ta, tb = graphs.tensors(a), graphs.tensors(b)
    return len(ta) == len(tb) and all(torch.equal(x, y)
                                      for x, y in zip(ta, tb))


def td3_replays(params):
    """(c) and (e), with torch's deterministic algorithms on
    (`torch.use_deterministic_algorithms`, cuDNN deterministic and not
    benchmarked; CUBLAS_WORKSPACE_CONFIG set at the top of this script):
    (c) 9 steps of a 64-env loop from a fresh state through the graphs --
    3 collect-only steps (the first eager, then captured; 2 replays), then
    4 update steps alternating critic-only and critic + actor (the first of
    each kind eager, then captured; two steady policy_delay units
    replayed) -- against the same 9 steps run eagerly from a second loop
    of the same seed: every state tensor and output equal bit for bit. The
    buffer (100 000 slots) has not started evicting. (e) A checkpoint of
    the first loop after those steps, restored into a fresh loop of
    another seed: the next 6-step chunk of both equal bit for bit."""
    import tempfile

    import torch

    from tinycarlo_torch.train.td3_loop import chunk
    from tinycarlo_torch.utils import checkpoint, graphs

    graphs.deterministic(True)
    try:
        a, args = td3_loop_states(params, 64, seed=3)
        b, _ = td3_loop_states(params, 64, seed=3)
        stack = td3_config4()[2]
        a, out_a = chunk(a, *args, 9, stack=stack)
        b, out_b = chunk(b, *args, 9, stack=stack, graph=False)
        rt = a.runtime.step_graphs
        check(rt.replays == 6 and rt.captures == 3,
              f"td3 graphs: {rt.replays} replays of {rt.captures} "
              "graphs, not 6 of 3")
        check(a.generator.get_offset() == b.generator.get_offset(),
              "td3 graphs: the generators' offsets differ")
        same = states_equal(a, b) and all(
            torch.equal(out_a[k], out_b[k]) for k in out_a)
        check(same, "td3: the replayed steps differ from the eager steps")
        check(bool((out_a["critic1_loss"][3:] != 0).all()),
              "td3 graphs: no update in the steady steps")
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "loop.pt")
            checkpoint.save(path, a)
            c, _ = td3_loop_states(params, 64, seed=7)
            checkpoint.restore(path, c)
        a, out_a = chunk(a, *args, 6, stack=stack)
        c, out_c = chunk(c, *args, 6, stack=stack)
        same = states_equal(a, c) and all(
            torch.equal(out_a[k], out_c[k]) for k in out_a)
        check(same, "td3: the chunk after a restored checkpoint differs")
    finally:
        graphs.deterministic(False)
    print("td3 graphs: a replayed collect-only step (2 replays) and two "
          "steady policy_delay units, 64 envs, equal bit for bit to eager "
          "steps; a checkpoint restored into a fresh loop gives the same "
          "next chunk bit for bit")


def td3_card_vs_cpu(params_gpu):
    """(d): TD3_CPU_STEPS steps of TD3_CPU_ENVS envs on the card (through
    the graphs) and on the CPU port from one state (made on the CPU,
    copied to the card) with the same injected draws; config 4's widths
    at float32, batch 16 and 1000 replay slots so that updates run."""
    import numpy as np
    import torch

    from tinycarlo_torch.benchmarks import td3_bench
    from tinycarlo_torch.utils import graphs
    from tinycarlo_torch.train.td3_loop import chunk

    n, steps = TD3_CPU_ENVS, TD3_CPU_STEPS
    params_cpu = td3_bench.make_params("cpu")
    cfg = dataclasses.replace(td3_config4()[0], batch_size=16)
    kw = {"cfg": cfg, "replay_size": 1000, "obs_dtype": torch.float32}
    cpu, cpu_args = td3_loop_states(params_cpu, n, seed=5, **kw)
    gpu, gpu_args = td3_loop_states(params_gpu, n, seed=5, **kw)
    graphs.copy_into(gpu, cpu)
    gpu.filled_host, gpu.steps_host = cpu.filled_host, cpu.steps_host
    rng = np.random.default_rng(5)
    filled = np.minimum(n * np.arange(1, steps + 1), 1000)
    draws = {
        "ou": torch.tensor(rng.standard_normal((steps, n, 1)),
                           dtype=torch.float32),
        "evict": torch.tensor(rng.integers(0, 1000, (steps, n))),
        "sample": torch.tensor(np.stack([
            rng.integers(0, f, (1, cfg.batch_size)) for f in filled])),
        "maneuver": torch.tensor(rng.integers(0, 3, (steps, n))),
        "respawn": torch.tensor(rng.integers(
            0, params_cpu.map_data.spawns.count, (steps, n))),
    }
    stack = td3_config4()[2]
    cpu, out_c = chunk(cpu, *cpu_args, steps, stack=stack, draws=draws)
    gpu, out_g = chunk(gpu, *gpu_args, steps, stack=stack, draws=draws)
    pos = (gpu.vstate.env.car.position.cpu()
           - cpu.vstate.env.car.position).abs().max().item()
    check(pos <= TD3_POS_ATOL, f"td3 card vs CPU: positions differ by {pos}")
    worst = 0.0
    for k in ("critic1_loss", "critic2_loss", "actor_loss"):
        want, got = out_c[k], out_g[k].cpu()
        check(bool(((want == 0) == (got == 0)).all()),
              f"td3 card vs CPU: {k} skipped on one device only")
        rel = ((got - want).abs() / want.abs().clamp_min(1e-12)).max().item()
        worst = max(worst, rel)
    check(worst <= TD3_LOSS_RTOL,
          f"td3 card vs CPU: losses differ by a relative {worst}")
    check(bool((out_c["critic1_loss"][1:] != 0).all()),
          "td3 card vs CPU: no update ran")
    print(f"td3 card vs CPU: {n} envs x {steps} steps, positions within "
          f"{pos:.3g} m, losses within a relative {worst:.3g}")


def td3_evaluate(params):
    """(f): `evaluate` of the bundled combo through the rollout graph
    against the eager rollout, 8 envs x 20 steps, deterministic algorithms
    on: the metrics and positions equal bit for bit."""
    import numpy as np

    from tinycarlo_torch.train.evaluate import evaluate
    from tinycarlo_torch.utils import graphs

    params_s, act, _ = serving_setup("fast")
    stats_g, stats_e = {}, {}
    graphs.deterministic(True)
    try:
        g = evaluate(act, params_s, 1, None, seed=4, steps=20, episodes=8,
                     stats=stats_g)
        e = evaluate(act, params_s, 1, None, seed=4, steps=20, episodes=8,
                     graph=False, stats=stats_e)
    finally:
        graphs.deterministic(False)
    check(stats_g == {"replays": 17, "captures": 1} and not stats_e,
          f"evaluate: {stats_g} through the graph, {stats_e} eagerly")
    check(np.array_equal(g["positions"], e["positions"])
          and all(g[k] == e[k] for k in ("cte_avg", "heading_error_avg",
                                         "total_reward", "terminations")),
          "evaluate through the rollout graph differs from the eager "
          "rollout")
    print("evaluate: 8 envs x 20 steps through the rollout graph (17 "
          "replays) equal bit for bit to the eager rollout")


def td3_phase(card, rk):
    """Phase 14: the TD3 trainer (BASELINE config 4) on the card. Prints
    the seconds of each part."""
    clock = PhaseClock()
    state, params = td3_bench_runs(card, rk)
    clock.done("  td3 bench")
    td3_kernels(card, rk, state, params)
    del state
    clock.done("  td3 kernels")
    td3_replays(params)
    td3_evaluate(params)
    clock.done("  td3 graphs, checkpoint, evaluate")
    td3_card_vs_cpu(params)
    clock.done("  td3 card vs CPU")


# the IL example's collection and training (examples/train_stanley_il.py:
# 16 envs, 128-step chunks; batch 32 and 500-step train chunks)
IL_ENVS, IL_CHUNK_STEPS, IL_TRAIN_STEPS = 16, 128, 500
# card against CPU port, 4 envs x 16 steps from injected draws: positions
# and labels within 1e-4 (the two devices' float32 libm differ in the last
# bits), frames under 0.5% of the pixels apart (stroke-boundary pixels)
IL_CPU_ENVS, IL_CPU_STEPS, IL_ATOL, IL_PIXELS = 4, 16, 1e-4, 5e-3


def il_collect(card, rk, ras, params, cfg):
    """(a): three graph chunks, one eager chunk and a classes chunk; the
    launch counts; the rank kernel on the chunk's bundles. Returns the
    collected (X, M, Y) on the card and the launches by kernel."""
    import torch

    from tinycarlo_torch import env as fenv
    from tinycarlo_torch.train import il

    for k in (rk.masks_kernel, rk.rank_kernel, rk.exact_kernel,
              rk.front_kernel):
        k.launches = 0
    g = torch.Generator(device="cuda").manual_seed(0)
    coll = il.Collector(params, cfg, IL_ENVS, IL_CHUNK_STEPS)
    xs, ms, ys = [], [], []
    for m in (0, 1, 2):
        torch.cuda.synchronize()
        start = time.perf_counter()
        traj = coll.chunk(m, g)
        keep = traj["keep"]
        x = traj["obs"][keep].flatten(0, 1)
        torch.cuda.synchronize()
        secs = time.perf_counter() - start
        graph_secs = secs
        xs.append(x)
        ys.append(traj["steering"][keep].reshape(-1, 1).float())
        ms.append(torch.full((x.shape[0],), m, device="cuda"))
        print(f"il collection, maneuver {m} (graph{', capture' if m == 0 else ''}"
              f"): {x.shape[0]} samples in {secs * 1e3:.1f} ms, "
              f"{x.shape[0] / secs:.1f} samples/s on {card}")
    eager = il.Collector(params, cfg, IL_ENVS, IL_CHUNK_STEPS, graph=False)
    torch.cuda.synchronize()
    start = time.perf_counter()
    traj = eager.chunk(0, g)
    torch.cuda.synchronize()
    secs = time.perf_counter() - start
    n = int(traj["keep"].sum()) * IL_ENVS
    print(f"il collection, eager: {n} samples in {secs * 1e3:.1f} ms, "
          f"{n / secs:.1f} samples/s on {card}")
    st, se = coll.stats, eager.stats
    launches = rk.rank_kernel.launches
    # a trace of replayed units (two collection steps, one render each)
    unit = next(iter(coll.step_graphs.entries.values()))[0]

    def replay():
        coll.t.zero_()
        unit.replay()

    busy, top, _, wall = device_profile(replay, calls=5)
    if busy is None:
        print("il collection unit: device busy not measured (the trace "
              "holds no device time)")
    else:
        unit_ms = 1e3 * graph_secs * cfg.skip_steps / IL_CHUNK_STEPS
        print(f"il collection unit (replayed, {cfg.skip_steps} steps): "
              f"{busy:.4f} ms device busy, {wall:.4f} ms wall a traced "
              f"unit; {unit_ms:.4f} ms a unit in the last chunk, idle share "
              f"{1 - busy / unit_ms:.3f}")
        for key, key_ms, count in top:
            print(f"  {key_ms:.4f} ms/unit x{count}: {key}")
    check(launches == st["renders"] + st["captures"] + se["renders"],
          f"il collection: {launches} rank-kernel launches for "
          f"{st['renders']} + {se['renders']} eager renders and "
          f"{st['captures']} captures")
    check(st["replays"] == 3 * IL_CHUNK_STEPS // cfg.skip_steps - 1,
          f"il collection: {st['replays']} replays")
    check(rk.masks_kernel.launches == 0 and rk.exact_kernel.launches == 0,
          "il collection (rgb) launched the masks or exact kernel")
    front = rk.front_kernel.launches
    check_front({"rank": launches, "front": front}, "il collection")
    # the rank kernel on the last graph chunk's final states, through the
    # collector's randomized camera
    p = coll.params
    res = tuple(p.cfg.camera.resolution)
    err = rank_vs_plain(rk, ras, bench_bundle(fenv, rk, p, coll.vstate.env),
                        p.map_data.n_layers, res, p.cfg.camera.line_thickness)
    # a classes chunk (bench.py's config) through the graph: the masks
    # kernel (the rank check above launched it once, not counted)
    classes = il.Collector(fenv.make_env_params(CONFIG), cfg, IL_ENVS,
                           IL_CHUNK_STEPS)
    rk.masks_kernel.launches = rk.front_kernel.launches = 0
    traj = classes.chunk(1, g)
    sc = classes.stats
    check(rk.masks_kernel.launches == sc["renders"] + sc["captures"]
          and bool(traj["obs"].any()),
          f"il classes chunk: {rk.masks_kernel.launches} masks-kernel "
          f"launches for {sc}")
    check_front({"masks": rk.masks_kernel.launches,
                 "front": rk.front_kernel.launches}, "il classes chunk")
    front += rk.front_kernel.launches
    print(f"il collection: rank kernel {launches} launches ({st['renders']} "
          f"+ {se['renders']} eager renders, {st['captures']} capture; "
          f"{st['replays']} replays apart), bit-equal to its plain version "
          f"on the chunk's bundles (max |error| {err}); classes chunk: masks "
          f"kernel {rk.masks_kernel.launches} launches, {sc['replays']} "
          "replays")
    data = (torch.cat(xs), torch.cat(ms), torch.cat(ys))
    return data, {"rank": launches, "masks": rk.masks_kernel.launches,
                  "front": front}


def il_data(X, M, Y):
    """The device dataset with the example's maneuver-balanced pools."""
    import torch

    pools, pool_n = [], []
    counts = [int((M == m).sum()) for m in range(3)]
    for m in range(3):
        ids = torch.nonzero(M == m)[:, 0]
        pool_n.append(len(ids))
        pools.append(ids.repeat(max(counts) // max(len(ids), 1) + 1)[
            :max(counts)])
    return {"x": X, "m": M.long(), "y": Y,
            "pools": torch.stack(pools).to(torch.int32),
            "pool_n": torch.tensor(pool_n, dtype=torch.int32, device="cuda")}


def il_train(card, state, cfg, data):
    """(b): two 500-step chunks; their rates and mean losses; a trace of
    replayed steps."""
    import torch

    from tinycarlo_torch.train import il

    means = []
    for i in range(2):
        torch.cuda.synchronize()
        start = time.perf_counter()
        state, losses = il.train_chunk(state, cfg, data, IL_TRAIN_STEPS)
        mean = losses.mean().item()
        secs = time.perf_counter() - start
        means.append(mean)
        print(f"il train chunk {i + 1} ({'capture, ' if i == 0 else ''}"
              f"{IL_TRAIN_STEPS} steps, batch {cfg.batch_size}): "
              f"{IL_TRAIN_STEPS / secs:.1f} steps/s, mean loss {mean:.6f} "
              f"on {card}")
    check(all(math.isfinite(m) for m in means) and means[1] < means[0],
          f"il train: mean losses {means} not finite and falling")
    rt = state.runtime

    def replay():
        rt.t.zero_()
        rt.step_graphs.replay(None)

    busy, top, _, wall = device_profile(replay, calls=5)
    if busy is None:
        print("il train step: device busy not measured (the trace holds "
              "no device time)")
    else:
        print(f"il train step (replayed): {busy:.4f} ms device busy, "
              f"{wall:.4f} ms wall a traced step")
        for key, ms, count in top:
            print(f"  {ms:.4f} ms/step x{count}: {key}")
    return state


def il_replays(params, cfg, data):
    """(c): 4 replayed train steps against 4 eager steps, deterministic
    algorithms on."""
    import numpy as np
    import torch

    from tinycarlo_torch import env as fenv
    from tinycarlo_torch.train import il
    from tinycarlo_torch.utils import graphs

    rng = np.random.default_rng(3)
    n = data["x"].shape[0]
    draws = [torch.tensor(rng.integers(0, n, (4, cfg.batch_size)))
             for _ in range(2)]
    shape = fenv.observation_shape(params)
    graphs.deterministic(True)
    try:
        a = il.create(shape, cfg, seed=5)
        b = il.create(shape, cfg, seed=5)
        for d in draws:  # the first chunk captures, the second replays
            a, la = il.train_chunk(a, cfg, data, 4, draws=d)
            b, lb = il.train_chunk(b, cfg, data, 4, draws=d, graph=False)
            same = torch.equal(la, lb) and states_equal(
                (a.model, a.opt), (b.model, b.opt))
            check(same, "il: the replayed train steps differ from the "
                        "eager steps")
    finally:
        graphs.deterministic(False)
    rt = a.runtime.step_graphs
    check(rt.replays == 7 and rt.eager == 1,
          f"il: {rt.replays} replays, {rt.eager} eager")
    print("il train graph: 4 replayed steps (after a capturing chunk) equal "
          "bit for bit to 4 eager steps, parameters, BatchNorm buffers and "
          "Adam state included")


def il_dagger(card, rk, params, cfg, model):
    """(d): one DAgger chunk through the graph. Returns its launches by
    kernel."""
    import torch

    from tinycarlo_torch.train import il

    rk.rank_kernel.launches = rk.front_kernel.launches = 0
    coll = il.Collector(params, cfg, IL_ENVS, IL_CHUNK_STEPS, model=model)
    torch.cuda.synchronize()
    start = time.perf_counter()
    traj = coll.chunk(2, torch.Generator(device="cuda").manual_seed(3))
    y = traj["steering"][traj["keep"]]
    torch.cuda.synchronize()
    secs = time.perf_counter() - start
    st = coll.stats
    check(rk.rank_kernel.launches == st["renders"] + st["captures"],
          f"il dagger: {rk.rank_kernel.launches} launches for {st}")
    launches = {"rank": rk.rank_kernel.launches,
                "front": rk.front_kernel.launches}
    check_front(launches, "il dagger")
    check(bool(torch.isfinite(y).all()) and y.std().item() > 0,
          "il dagger: labels not finite or constant")
    print(f"il dagger chunk (capture): {y.numel()} samples in "
          f"{secs * 1e3:.1f} ms, {y.numel() / secs:.1f} samples/s on {card};"
          f" rank kernel {rk.rank_kernel.launches} launches, "
          f"{st['replays']} replays")
    return launches


def il_checkpoint(state, data):
    """(e): the npz round trip into a fresh combo."""
    import tempfile

    import torch

    from tinycarlo_torch.convert import combo_state_dict_from_flax
    from tinycarlo_torch.models.tinycar_net import TinycarCombo, one_hot, pre_obs
    from tinycarlo_torch.train import il

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "combo.npz")
        il.save_variables_npz(path, state)
        sd = combo_state_dict_from_flax(il.load_variables_npz(path))
    fresh = TinycarCombo(flat_features=sd["encoder.fc1.weight"].shape[1])
    fresh.load_state_dict(sd)
    fresh = fresh.cuda().eval()
    x = pre_obs(data["x"][:64])
    m = one_hot(data["m"][:64], 3)
    with torch.no_grad():
        same = torch.equal(fresh(x, m), state.model(x, m))
    check(same, "il: the combo read back from its npz differs")
    print("il checkpoint: save_variables_npz -> load_variables_npz -> a "
          "fresh combo, eval outputs equal bit for bit")


def il_card_vs_cpu(params_gpu, cfg):
    """(f): 4 envs x 16 collection steps on the card (through the graph)
    and on the CPU port with the same injected draws."""
    import numpy as np
    import torch

    from tinycarlo_torch import env as fenv
    from tinycarlo_torch.train import il

    params_cpu = fenv.make_env_params(SERVE_CONFIG, device="cpu")
    n, steps = IL_CPU_ENVS, IL_CPU_STEPS
    rng = np.random.default_rng(7)
    count = params_cpu.map_data.spawns.count
    draws = {"pitch": 14, "fov": 111,
             "reset": torch.tensor(rng.integers(0, count, n)),
             "ou": torch.tensor(rng.standard_normal((steps, n, 1)),
                                dtype=torch.float32),
             "respawn": torch.tensor(rng.integers(0, count, (steps, n)))}
    tight = dataclasses.replace(cfg, collect_max_cte=0.02)
    out = {}
    for name, p in (("cpu", params_cpu), ("gpu", params_gpu)):
        coll = il.Collector(p, tight, n, steps)
        out[name] = {k: v.cpu() for k, v in coll.chunk(
            1, None, draws=draws, trace=True).items()}
    c, g = out["cpu"], out["gpu"]
    pos = (g["position"] - c["position"]).abs().max().item()
    lab = (g["steering"] - c["steering"]).abs().max().item()
    pix = (g["obs"] != c["obs"]).float().mean().item()
    check(torch.equal(g["done"], c["done"]) and pos <= IL_ATOL
          and lab <= IL_ATOL and pix < IL_PIXELS,
          f"il card vs CPU: positions {pos}, labels {lab}, pixels {pix}, "
          f"resets {int(g['done'].sum())} / {int(c['done'].sum())}")
    print(f"il card vs CPU: {n} envs x {steps} steps, positions within "
          f"{pos:.3g} m, labels within {lab:.3g}, {pix:.2e} of pixels "
          f"apart, {int(c['done'].sum())} resets on both")


def il_phase(card, rk, ras):
    """Phase 15: imitation learning at the IL example's full width. Prints
    the seconds of each part; returns the IL paths' launches by kernel."""
    from tinycarlo_torch import env as fenv
    from tinycarlo_torch.train import il
    from tinycarlo_torch.train.evaluate import combo_policy, evaluate

    clock = PhaseClock()
    params = fenv.make_env_params(SERVE_CONFIG)
    cfg = il.ILConfig()
    (X, M, Y), launches = il_collect(card, rk, ras, params, cfg)
    clock.done("  il collection")
    data = il_data(X, M, Y)
    state = il_train(card, il.create(fenv.observation_shape(params), cfg,
                                     seed=1), cfg, data)
    clock.done("  il training")
    il_replays(params, cfg, data)
    add_launches(launches, il_dagger(card, rk, params, cfg, state.model))
    il_checkpoint(state, data)
    clock.done("  il graphs, dagger, checkpoint")
    il_card_vs_cpu(params, cfg)
    r = evaluate(combo_policy(state.model), params, 0, None, steps=200)
    check(math.isfinite(r["cte_avg"]), f"il evaluate: cte_avg {r['cte_avg']}")
    print(f"il evaluate (maneuver 0, 5 episodes x 200 steps, the trained "
          f"combo): cte_avg {r['cte_avg']:.4f} m, {r['terminations']} "
          f"terminations")
    clock.done("  il card vs CPU, evaluate")
    return launches


# phase 16: the LanelineGrid query (map, ppm) and the fuzzed positions
GRID_MAPS = {"knuffingen": ("examples/maps/knuffingen.json", 150),
             "simple_layout": ("examples/maps/simple_layout.json", 450)}
GRID_POSITIONS = 4096


def grid_positions(grid, n, seed):
    """(n, 2) float64 positions uniform over the grid's domain, the first
    n // 8 on cell corners (tests/test_query_grid.py:54-64)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    o = grid.origin.double().cpu().numpy()
    cell = 1.0 / float(grid.inv_cell)
    pos = rng.uniform(o, o + np.asarray([grid.nx * cell, grid.ny * cell]),
                      size=(n, 2))
    pos[: n // 8] = o + np.round((pos[: n // 8] - o) / cell) * cell
    return pos


def grid_states(car_mod, md, pos):
    """Car states at `pos` on the card (float32), headings spread over
    [-3, 3], every path on the lanepath's first edge."""
    import torch

    n = pos.shape[0]
    position = torch.tensor(pos, dtype=torch.float32, device="cuda")
    rot = torch.linspace(-3.0, 3.0, n, device="cuda")
    front = position + 0.0487 * torch.stack([torch.cos(rot),
                                             torch.sin(rot)], dim=-1)
    zeros = torch.zeros(n, device="cuda")
    return car_mod.CarState(
        position=position, position_front=front, rotation=rot,
        steering_angle=zeros, radius=zeros.clone(),
        velocity=torch.full((n,), 0.1, device="cuda"),
        local_path=md.lanepath.edges[0].expand(
            n, car_mod.PATH_LEN, 2).contiguous(),
        local_path_len=torch.full((n,), 2, dtype=torch.int32,
                                  device="cuda"),
        last_maneuver=torch.zeros(n, dtype=torch.int32, device="cuda"))


def grid_phase(card):
    """Phase 16: car_info through the LanelineGrid against the full scan
    on the card, bit for bit, at GRID_POSITIONS fuzzed float32 positions
    on knuffingen and simple_layout; both branches timed (CUDA events,
    median of 7); one classes bench step with the grid on against it off."""
    import torch

    from tinycarlo_torch import car as car_mod
    from tinycarlo_torch import env as fenv
    from tinycarlo_torch import vector
    from tinycarlo_torch.config import CarConfig, MapConfig
    from tinycarlo_torch.map_compiler import compile_map

    for name, (path, ppm) in GRID_MAPS.items():
        kw = dict(json_path=os.path.join(REPO, path), pixel_per_meter=ppm)
        md_g = compile_map(MapConfig(query_grid=True, **kw))
        md_f = compile_map(MapConfig(**kw))
        g = md_g.laneline_grid
        check(g is not None, f"grid {name}: no grid built")
        st = grid_states(car_mod, md_g,
                         grid_positions(g, GRID_POSITIONS, seed=1))
        cfg = CarConfig()
        got = car_mod.car_info(md_g, cfg, st)
        want = car_mod.car_info(md_f, cfg, st)
        for k in want:
            check(torch.equal(got[k], want[k]),
                  f"grid {name}: car_info {k} differs from the full scan")
        ms_g = cuda_ms(lambda: car_mod.car_info(md_g, cfg, st))
        ms_f = cuda_ms(lambda: car_mod.car_info(md_f, cfg, st))
        print(f"grid {name}: {md_f.packed_layer_bounds[-1]} laneline "
              f"edges, {g.nx}x{g.ny} = {g.nx * g.ny} cells, K = "
              f"{g.cand_idx.shape[1]} candidates a cell (layer bounds "
              f"{g.layer_bounds}); car_info at {GRID_POSITIONS} envs equal "
              f"to the full scan bit for bit; grid {ms_g:.4f} ms, full "
              f"scan {ms_f:.4f} ms (CUDA events, median of 7; {card})")

    cfg_grid = {**CONFIG, "map": {**CONFIG["map"], "query_grid": True}}
    out = []
    for c in (CONFIG, cfg_grid):
        params = fenv.make_env_params(c)
        vstate, _ = vector.reset(params, N_ENVS, seed=3, render=False)
        action = {"car_control": torch.tensor(
            [[SPEED, 0.1]], device="cuda").expand(N_ENVS, 2),
            "maneuver": torch.zeros(N_ENVS, dtype=torch.int32,
                                    device="cuda")}
        out.append(vector.step(params, vstate, action,
                               respawn_rows=torch.zeros(
                                   N_ENVS, dtype=torch.long,
                                   device="cuda"))[1:])
    check(out[1][0] is not None and params.map_data.laneline_grid
          is not None, "grid step: the grid map has no grid")
    for a, b in zip(out[0][:4], out[1][:4]):
        check(torch.equal(a, b), "grid step: an output differs with the "
              "grid on")
    for k in out[0][4]:
        check(torch.equal(out[0][4][k], out[1][4][k]),
              f"grid step: info {k} differs with the grid on")
    print(f"grid step: one vector.step of bench.py's classes config at "
          f"{N_ENVS} envs equal with the grid on and off (obs, reward, "
          f"terminated, truncated, info)")


# phase 17: ranks sharing the one card, their backend asked for explicitly
# (NCCL takes one rank per card); a (data 2 x model 2) mesh
SCALE_BACKEND, SCALE_WORLD, SCALE_MODEL = "gloo", 4, 2
# the DP x TP x SP chunk: BASELINE config 4's yaml and nets, 1024 envs in
# all, 20 eager steps, the replay cut from 100 000 slots to 8192
SCALE_CHUNK_ENVS, SCALE_CHUNK_STEPS, SCALE_REPLAY = 1024, 20, 8192
SCALE_DEADLINE_S = 300
# the sharded chunk against the single-process chunk on the card: cuDNN
# and cuBLAS may take other algorithms at 512 rows than at 1024, and TP
# sums its row-parallel products in another order, so per-env outputs move
# (measured on an H100 80GB HBM3 at 700 W: reward 2.5e-4, cte 7.6e-6,
# the batch-mean laneline distances 1.2e-7, no episode end moved, losses
# 3.5e-5 relative)
SCALE_TOL = {"reward": 1e-3, "cte": 1e-4, "laneline_distances": 1e-5,
             "sigma": 0.0, "done_mismatches": 0, "critic1_loss_rel": 1e-3,
             "critic2_loss_rel": 1e-3, "actor_loss_rel": 1e-3}


def sp_cases():
    """The SP cases: (name, params, fmt), each rendered at N_ENVS."""
    from tinycarlo_torch import env as fenv
    from tinycarlo_torch.benchmarks import gym_bench as gb

    return [("classes", fenv.make_env_params(CONFIG), "classes"),
            ("rank", fenv.make_env_params(SERVE_CONFIG), "rank"),
            ("exact", fenv.make_env_params(gb.CONFIG1_EXACT), "classes")]


def sp_shard_kernel(rk, ras, fenv, sp, params, states, mesh, fmt):
    """This rank's shard of the SP render: its compaction bundle through
    the kernel the SP path launches (K1 masks, K3 rank or K4 exact)
    against the plain version. Returns (kernel name, live copies)."""
    import torch

    md, cam = params.map_data, params.cfg.camera
    res, t = tuple(cam.resolution), cam.line_thickness
    u0, v0, u1, v1, draw = fenv._project_packed_batch_soa(
        params, states, edges=sp._model_shard(md.packed_edges, 1, mesh),
        edge_mask=sp._model_shard(md.packed_edge_mask, 1, mesh,
                                  value=False))
    elayer = sp._model_shard(md.packed_edge_layer, 0, mesh)
    exact = ras._exact(t, cam.stroke)
    compact = rk.compact_env_exact_soa if exact else rk.compact_env_idx_soa
    _, bundle = rk._packed_bundle(compact, u0, v0, u1, v1, draw, elayer,
                                  md.n_layers, res, t,
                                  cam.max_visible_segments, None)
    if exact:
        kernel, plain = rk.exact_kernel, rk.rasterize_masks_exact_env_plain
    elif fmt == "rank":
        kernel, plain = rk.rank_kernel, rk.rasterize_rank_env_plain
    else:
        kernel, plain = rk.masks_kernel, rk.rasterize_masks_env_plain
    got = kernel(bundle, md.n_layers, res, t)
    want = plain(bundle, md.n_layers, res, t)
    check(torch.equal(got, want), f"SP shard: the {kernel.NAME} kernel "
          "differs from its plain version")
    return kernel.NAME, int(bundle[-1].sum())


def scaleout_chunk(mesh, first_obs):
    """The DP x TP x SP chunk over `mesh` (None: the single-process
    chunk), BASELINE config 4 at SCALE_CHUNK_ENVS. `first_obs` (a list)
    receives the first step's rendered observations. Returns (outputs,
    seconds)."""
    import torch

    from tinycarlo_torch import env as fenv
    from tinycarlo_torch.benchmarks import td3_bench
    from tinycarlo_torch.models.tinycar_net import encoder_apply_fn
    from tinycarlo_torch.parallel import mesh as pmesh
    from tinycarlo_torch.parallel import tp as ptp
    from tinycarlo_torch.parallel.sp import render_observation_batch_sp
    from tinycarlo_torch.train.td3_loop import chunk, init_loop

    params = td3_bench.make_params("cuda")
    enc = encoder_apply_fn(td3_bench.make_encoder(params, torch.bfloat16))
    cfg, loop_cfg, stack = td3_config4(replay_size=SCALE_REPLAY)
    state = init_loop(params, cfg, loop_cfg, SCALE_CHUNK_ENVS, seed=0,
                      stack=stack)
    if mesh is None:
        def render(p, s, out_dtype):
            obs = fenv.render_observation_batch(p, s, out_dtype=out_dtype)
            if not first_obs:
                first_obs.append(obs.clone())
            return obs
        kw = {}
    else:
        for f in ("vstate", "queue", "noise", "maneuver", "sigma",
                  "ep_count"):
            setattr(state, f, pmesh.shard_batch(getattr(state, f), mesh))
        state.buf = pmesh.replicate(state.buf, mesh)
        ts = state.td3_state
        for net in ("actor", "critic1", "critic2"):
            o = getattr(ts, "opt_" + net)
            o.mu = ptp.shard_state_dict(getattr(ts, net), o.mu, mesh)
            o.nu = ptp.shard_state_dict(getattr(ts, net), o.nu, mesh)
            for name in (net, net + "_target"):
                ptp.shard_params(getattr(ts, name), mesh)

        def render(p, s, out_dtype):
            obs = render_observation_batch_sp(p, s, mesh,
                                              out_dtype=out_dtype)
            if not first_obs:
                first_obs.append(obs.clone())
            return obs
        kw = {"mesh": mesh}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, out = chunk(state, params, cfg, loop_cfg, enc,
                       SCALE_CHUNK_STEPS, stack=stack, graph=False,
                       obs_render_fn=render, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def scaleout_work(rank, world, init_file):
    """One rank of phase 17 (SCALE_WORLD ranks on the one card)."""
    import hashlib

    import torch
    import torch.distributed as dist

    from tinycarlo_torch import env as fenv
    from tinycarlo_torch import vector
    from tinycarlo_torch.ops import rasterize as ras
    from tinycarlo_torch.ops import rasterize_kernels as rk
    from tinycarlo_torch.parallel import mesh as pmesh
    from tinycarlo_torch.parallel import multihost, sp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)  # every rank on the one card
    multihost.initialize(init_method="file://" + init_file,
                         world_size=world, rank=rank, backend=SCALE_BACKEND)
    mesh = pmesh.make_mesh(model=SCALE_MODEL, device_type="cuda")
    rows = pmesh.data_rows(N_ENVS, mesh)
    torch.cuda.reset_peak_memory_stats()
    res = {"backend": dist.get_backend(), "world": dist.get_world_size(),
           "coord": (pmesh.axis_index(mesh, "data"),
                     pmesh.axis_index(mesh, "model")),
           "shards": {}, "sp": {}}

    # (a) each case's shard kernel against its plain version, and the
    # unsharded single-process render of the same states
    cases = []
    for name, params, fmt in sp_cases():
        states = vector.reset(params, N_ENVS, seed=5, render=False)[0].env
        mine = pmesh.shard_batch(states, mesh)
        res["shards"][name] = sp_shard_kernel(rk, ras, fenv, sp, params,
                                              mine, mesh, fmt)
        ref = fenv.render_observation_batch(params, states, fmt=fmt)[rows]
        cases.append((name, params, fmt, states, ref))
    # the main path: the counts from 0
    kernels = (rk.masks_kernel, rk.rank_kernel, rk.exact_kernel,
               rk.front_kernel)
    for k in kernels:
        k.launches = 0
    for name, params, fmt, states, ref in cases:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame = sp.render_observation_batch_sp(params, states, mesh,
                                               data_sharded=True, fmt=fmt)
        torch.cuda.synchronize()
        res["sp"][name] = {"s": time.perf_counter() - t0,
                           "equal": bool(torch.equal(frame, ref)),
                           "lit": int((frame > 0).sum())}
    first = []
    out, seconds = scaleout_chunk(mesh, first)
    res["launches"] = {k.NAME: k.launches for k in kernels}
    res["chunk_s"] = seconds
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9

    def sha(x):
        return hashlib.sha256(x.contiguous().view(torch.uint8).cpu()
                              .numpy().tobytes()).hexdigest()

    res["obs_sha"] = sha(first[0])
    if rank == 0:
        # the single-process chunk on the same card, its first frames'
        # hash by data rows, and the sharded outputs' distance from it
        single_first = []
        single, res["single_s"] = scaleout_chunk(None, single_first)
        per = SCALE_CHUNK_ENVS // pmesh.axis_size(mesh, "data")
        res["single_obs_sha"] = [
            sha(single_first[0][i * per:(i + 1) * per])
            for i in range(pmesh.axis_size(mesh, "data"))]
        res["vs_single"] = chunk_deviation(out, single)
    dist.destroy_process_group()
    return res


def chunk_deviation(out, want):
    """{output: the largest |out - want| (and for the losses the largest
    relative one)}, and the count of differing episode ends."""
    dev = {}
    for k, v in want.items():
        if k == "done":
            dev["done_mismatches"] = int((out[k] != v).sum())
            continue
        d = (out[k].double() - v.double()).abs()
        dev[k] = float(d.max())
        if k.endswith("_loss"):
            dev[k + "_rel"] = float((d / v.double().abs().clamp(
                min=1e-30)).max())
    return dev


def scaleout_rank(rank, world, init_file, results):
    """A phase-17 process: scaleout_work's result, or its traceback, on
    the results queue; exits non-zero on a failure."""
    import traceback

    try:
        results.put((rank, scaleout_work(rank, world, init_file)))
    except BaseException:
        results.put((rank, traceback.format_exc()))
        sys.exit(1)


def scaleout_phase(card):
    """Phase 17: SCALE_WORLD ranks on the one card over the
    SCALE_BACKEND backend, a (data 2 x model 2) mesh: (a) the SP renderer
    on bench.py's classes states, the example yaml's rgb (rank) frames and
    config 1 under the exact stroke, N_ENVS envs, each rank's K1 / K3 / K4
    launch on its shard bit-equal to the plain version and each composed
    frame to the unsharded render; (b) the DP x TP x SP TD3 chunk of
    BASELINE config 4's yaml and nets at SCALE_CHUNK_ENVS envs,
    SCALE_CHUNK_STEPS eager steps, its first frames bit-equal to the
    single-process chunk's and its outputs beside the single-process
    chunk's. Returns the main path's launches by kernel, summed over the
    ranks."""
    import tempfile

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init_file = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_"),
                             "store")
    procs = [ctx.Process(target=scaleout_rank,
                         args=(r, SCALE_WORLD, init_file, results))
             for r in range(SCALE_WORLD)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + SCALE_DEADLINE_S
    try:
        while len(got) < SCALE_WORLD:
            check(time.monotonic() < deadline, "scale-out: the ranks took "
                  f"over {SCALE_DEADLINE_S} s")
            try:
                rank, res = results.get(timeout=5.0)
            except queue.Empty:
                # a rank that died before reporting fails the phase now
                dead = [p.exitcode for p in procs if p.exitcode]
                check(not dead, f"scale-out: ranks exited {dead}")
                continue
            check(isinstance(res, dict), f"scale-out rank {rank} failed:\n"
                  f"{res}")
            got[rank] = res
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    check([p.exitcode for p in procs] == [0] * SCALE_WORLD,
          f"scale-out ranks exited {[p.exitcode for p in procs]}")
    r0 = got[0]
    print(f"scale-out: backend {r0['backend']}, world size {r0['world']}, "
          f"a (data {SCALE_WORLD // SCALE_MODEL} x model {SCALE_MODEL}) "
          f"mesh, every rank on the one card ({card})")
    launches = {}
    for rank in range(SCALE_WORLD):
        res = got[rank]
        d = res["coord"][0]
        for name, sp_res in res["sp"].items():
            check(sp_res["equal"], f"SP {name}: rank {rank}'s composed "
                  "frame differs from the unsharded render")
        check(res["obs_sha"] == r0["single_obs_sha"][d],
              f"scale-out chunk: rank {rank}'s first-step frames differ "
              "from the single-process chunk's")
        check_front(res["launches"], f"scale-out rank {rank}")
        add_launches(launches, res["launches"])
        shards = ", ".join(f"{n}: {k} kernel on {c} live copies equal to "
                           f"its plain version" for n, (k, c)
                           in res["shards"].items())
        sps = ", ".join(f"{n} {v['s'] * 1e3:.1f} ms" for n, v
                        in res["sp"].items())
        print(f"  rank {rank} (data {d}, model {res['coord'][1]}): {shards}; "
              f"SP renders of its {N_ENVS // 2} rows (composed frames equal "
              f"to the unsharded render): {sps}; chunk "
              f"{res['chunk_s']:.2f} s, first-step frames equal to the "
              f"single-process chunk's; peak memory "
              f"{res['peak_gb']:.2f} GB; launches {res['launches']}")
    rate = SCALE_CHUNK_ENVS * SCALE_CHUNK_STEPS / max(
        got[r]["chunk_s"] for r in got)
    single = SCALE_CHUNK_ENVS * SCALE_CHUNK_STEPS / r0["single_s"]
    print(f"scale-out chunk (functional numbers: {SCALE_WORLD} ranks on one "
          f"card, collectives through the host; not a scaling result): "
          f"{SCALE_CHUNK_ENVS} envs x {SCALE_CHUNK_STEPS} eager steps, "
          f"{rate:.0f} env-steps/s (the slowest rank's wall); the "
          f"single-process eager chunk on the same card {single:.0f} "
          f"env-steps/s; peak memory per rank "
          f"{max(got[r]['peak_gb'] for r in got):.2f} GB")
    print(f"scale-out chunk against the single-process chunk: "
          f"{json.dumps(r0['vs_single'])} (limits {json.dumps(SCALE_TOL)})")
    for k, limit in SCALE_TOL.items():
        check(r0["vs_single"][k] <= limit, f"scale-out chunk: {k} "
              f"{r0['vs_single'][k]} over {limit} from the single-process "
              "chunk's")
    return launches


# ---- 18. the host tools -----------------------------------------------------
# the twin's runs: Stanley-steered steps through the graph and eagerly, and
# card against CPU
TWIN_STEPS = 300
TWIN_CPU_STEPS = 50
# the examples' sizes in this phase: train_td3 at its own width, 2 chunks
TD3_EXAMPLE = ["--envs", "64", "--chunks", "2", "--steps", "100",
               "--eval-steps", "200", "--eval-episodes", "5",
               "--eval-maneuvers", "1"]


def counted(rk, fn):
    """fn()'s result and the render kernels' launches in it
    (`rasterize_kernels.RENDER_KERNELS`): each count set to 0 just before
    and read just after; fn() renders, so the front kernel's count must be the
    masks and rank kernels' together (`check_front`)."""
    from tinycarlo_torch.ops.rasterize_kernels import RENDER_KERNELS

    for k in RENDER_KERNELS:
        k.launches = 0
    out = fn()
    launches = {k.NAME: k.launches for k in RENDER_KERNELS}
    check_front(launches, "a counted run")
    return out, launches


def render_launches(fenv, params, n):
    """{kernel name: launches} of n renders of `params` on the card: n of
    each kernel a render launches (`env.render_kernels`), 0 of the
    others."""
    from tinycarlo_torch.ops.rasterize_kernels import RENDER_KERNELS

    want = {k.NAME: 0 for k in RENDER_KERNELS}
    want.update((k.NAME, n) for k in fenv.render_kernels(params))
    return want


def add_launches(total, launches):
    for name, n in launches.items():
        total[name] = total.get(name, 0) + n


def twin_runs(card, rk, tb, gb, name, launches):
    """The twin of config `name` through the graph and eagerly, TWIN_STEPS
    Stanley steps each: steps/s, the wrappers' launches equal to the eager
    renders and captures, a trace of TRACED replays holding one
    render-kernel record a step."""
    from tinycarlo_torch import env as fenv

    for mode in ("graph", "eager"):
        env = tb.make_twin(tb.CONFIGS[name], mode)
        kernel = fenv.render_kernel(env.params)
        r, got = counted(rk, lambda: tb.run(env, TWIN_STEPS))
        add_launches(launches, got)
        captures = env.step_graphs.captures
        replays = env.step_graphs.replays
        want = r["renders"] - replays + captures
        check(got == render_launches(fenv, env.params, want),
              f"twin {name} {mode}: launches {got}, not {want} of "
              f"{kernel.NAME} and front ({r['renders']} renders, "
              f"{replays} replays, {captures} captures)")
        check(mode != "graph" or replays == TWIN_STEPS,
              f"twin {name}: {replays} replays of {TWIN_STEPS} steps")
        print(f"twin {name} ({env.observation_space_format}) {mode}: "
              f"{TWIN_STEPS} Stanley steps, {r['steps_per_s']:.1f} steps/s, "
              f"{r['ms_step']:.4f} ms a step (first step "
              f"{r['first_ms']:.1f} ms), {r['resets']} resets, "
              f"{r['renders']} renders, {replays} replays, "
              f"{kernel.NAME} launches {got[kernel.NAME]}, on {card}")
        if mode == "graph":
            # a replay's launch passes no wrapper: the trace counts them
            _, got = counted(rk, lambda: replay_trace(
                card, f"twin {name}", env, kernel, gb))
            add_launches(launches, got)
        env.close()


def twin_card_vs_cpu(card, tb, name, launches, rk):
    """TWIN_CPU_STEPS steps of the twin on the card (graph) and on the CPU,
    the same Stanley actions (from the card's info) to both: positions
    equal (the loopback car is numpy), cte within 1e-5, under 0.5% of
    the pixels differing. Returns the card's twin."""
    import numpy as np

    card_env = tb.make_twin(tb.CONFIGS[name], "graph")
    cpu_env = tb.make_twin(tb.CONFIGS[name], "cpu")

    def run():
        (obs_g, info_g), (obs_c, info_c) = (card_env.reset(seed=tb.SEED),
                                            cpu_env.reset(seed=tb.SEED))
        err, frac = 0.0, float((obs_g != obs_c).mean())
        for _ in range(TWIN_CPU_STEPS):
            action = tb.stanley(card_env, info_g)
            obs_g, _, te_g, tr_g, info_g = card_env.step(action)
            obs_c, _, te_c, tr_c, info_c = cpu_env.step(action)
            check((te_g, tr_g) == (te_c, tr_c), f"twin {name}: the card's "
                  "and the CPU's terminations differ")
            check(np.array_equal(info_g["position"], info_c["position"]),
                  f"twin {name}: the card's and the CPU's positions differ")
            err = max(err, abs(info_g["cte"] - info_c["cte"]))
            frac = max(frac, float((obs_g != obs_c).mean()))
            if te_g or tr_g:
                (_, info_g), _ = card_env.reset(), cpu_env.reset()
        return err, frac

    (err, frac), got = counted(rk, run)
    add_launches(launches, got)
    check(err <= 1e-5 and frac < 0.005, f"twin {name}: card and CPU differ:"
          f" cte by {err}, {frac:.4%} of pixels")
    print(f"twin {name} card vs CPU: {TWIN_CPU_STEPS} steps, positions "
          f"equal, cte within {err:.2e}, observations differ on at most "
          f"{frac:.4%} of pixels")
    cpu_env.close()
    return card_env


def autosys_driveback(card, env):
    """An AutosysCar stranded 8 cm off the lanepath with no history, its
    hardware a LoopbackRig, drives back on the guidance of the twin's
    state on the card; it must end within the reference's 0.02 m of cte
    and 20 degrees."""
    import numpy as np

    from tinycarlo_torch.real_world.base import (make_guidance,
                                                 snap_to_lanepath)
    from tinycarlo_torch.real_world.environments.env_autosys import (
        AutosysCar,
    )
    from tinycarlo_torch.real_world.environments.env_loopback import (
        LoopbackRig,
    )

    params = env.params
    target, trot, _ = snap_to_lanepath(params, np.asarray([0.9, 1.2]), 0.0)
    off = np.asarray([-math.sin(trot), math.cos(trot)]) * 0.08
    rig = LoopbackRig((float(target[0] + off[0]), float(target[1] + off[1]),
                       trot))
    car = AutosysCar(pixel_per_meter=450)
    car.transport = car.tracker = rig
    car.pose()
    guide = make_guidance(params, env.state)
    calls = [0]

    def guidance(*args):
        calls[0] += 1
        return guide(*args)

    cte0 = guidance(car._position, car._rotation, 0)[0]
    start = time.perf_counter()
    car.reposition(target, trot, guidance=guidance)
    seconds = time.perf_counter() - start
    cte, heading, _, _, final_rot = guide(car._position, car._rotation, 0)
    d = final_rot - car._rotation
    check(abs(cte0) > 0.05 and abs(cte) < 0.02
          and abs(math.atan2(math.sin(d), math.cos(d))) < math.radians(20),
          f"autosys drive-back: cte {cte0} -> {cte}, heading off by {d}")
    print(f"autosys drive-back on the card's guidance: {rig.moves} "
          f"iterations, {calls[0]} guidance calls, {seconds:.2f} s, cte "
          f"{cte0:.4f} -> {cte:.4f} m, on {card}")


def overview_vs_cpu(env):
    """viz.render_overview of the twin's state on the card against the
    same pose through the port on the CPU, bit for bit."""
    import numpy as np

    from tinycarlo_torch import env as fenv
    from tinycarlo_torch import viz

    params_cpu = fenv.make_env_params(env.config_path or env.config,
                                      device="cpu")
    state_cpu = fenv.EnvState(car=type(env.state.car)(**{
        k: v.cpu() for k, v in vars(env.state.car).items()}))
    ppm = env.overview_pixel_per_meter
    got, _ = viz.render_overview(env.params, env.state, ppm)
    want, _ = viz.render_overview(params_cpu, state_cpu, ppm)
    check(np.array_equal(got, want), "overview: the card's state draws "
          "another frame than the same pose on the CPU")
    print(f"overview: render_overview of the twin's state on the card "
          f"equal to the CPU port's, {got.shape[1]}x{got.shape[0]}, "
          f"{int((got != 0).any(-1).sum())} lit pixels")


def examples_in_process(card, rk, launches):
    """The examples' main() in this process: train_td3 at its own width
    (64 envs, 2 chunks of 100 steps, one 5 x 200-step maneuver of
    evaluation), stanley_control --batch 4096 for 20 steps,
    benchmark_tinycar_net for one maneuver of 100 steps, render_map to a
    temporary PNG."""
    import tempfile

    import cv2

    from tinycarlo_torch.examples import (benchmark_tinycar_net,
                                          render_map, stanley_control,
                                          train_td3)

    with tempfile.TemporaryDirectory() as tmp:
        saved = os.environ.get("IL_MODEL")
        os.environ["IL_MODEL"] = os.path.join(tmp, "absent.npz")
        try:
            r, got = counted(rk, lambda: train_td3.main(
                TD3_EXAMPLE + ["--out", tmp]))
        finally:
            if saved is None:
                os.environ.pop("IL_MODEL")
            else:
                os.environ["IL_MODEL"] = saved
        add_launches(launches, got)
        check(got["rank"] > 0 and math.isfinite(r["eval"][0]["cte_avg"]),
              f"train_td3: launches {got}, eval {r['eval'][0]['cte_avg']}")
        print(f"example train_td3 (64 envs, rgb 128x160, 2 chunks of 100 "
              f"steps): "
              f"{', '.join(f'{x:.1f}' for x in r['env_steps_per_s'])} "
              f"env-steps/s a chunk (the first captures its graphs); "
              f"evaluation cte_avg {r['eval'][0]['cte_avg']:.4f} m; rank "
              f"launches {got['rank']}; plot "
              f"{'written' if r['plot'] else 'skipped'}; on {card}")
        r, got = counted(rk, lambda: stanley_control.main(
            ["--batch", "4096", "--steps", "20"]))
        add_launches(launches, got)
        check(math.isfinite(r["mean_abs_cte"]), "stanley_control --batch")
        print(f"example stanley_control --batch 4096, 20 steps: "
              f"{r['env_steps_per_s']:.1f} env-steps/s, mean |cte| "
              f"{r['mean_abs_cte']:.4f} m, on {card}")
        r, got = counted(rk, lambda: benchmark_tinycar_net.main(
            ["--maneuvers", "1", "--steps", "100", "--traces", tmp]))
        add_launches(launches, got)
        e = r["eval"][0]
        check(got["rank"] > 0 and e["cte_avg"] < CTE_LIMIT,
              f"benchmark_tinycar_net: launches {got}, cte_avg "
              f"{e['cte_avg']}")
        print(f"example benchmark_tinycar_net (maneuver 0, 5 x 100 steps): "
              f"cte_avg {e['cte_avg']:.4f} m, {e['steps_per_s']:.1f} "
              f"steps/s, rank launches {got['rank']}, on {card}")
        png = os.path.join(tmp, "map.png")
        r = render_map.main(["--out", png, "--traces", tmp])
        image = cv2.imread(png)
        check(image is not None and image.shape == r["shape"]
              and image.any(), "render_map: no PNG")
        print(f"example render_map: {png} {image.shape[1]}x"
              f"{image.shape[0]} with maneuver 0's trace")


def host_tools_phase(card, rk, ras):
    """Phase 18: the digital twin, the overview and the examples on the
    card. Prints the seconds of each part; returns the phase's launches
    by kernel."""
    from tinycarlo_torch import env as fenv
    from tinycarlo_torch.benchmarks import gym_bench as gb
    from tinycarlo_torch.benchmarks import twin_bench as tb

    clock = PhaseClock()
    launches = {}
    for name in tb.CONFIGS:
        env = tb.make_twin(tb.CONFIGS[name], "graph")
        kernel, err, n = shim_kernel_vs_plain(
            rk, ras, fenv, env, gb.actions(3, seed=6), tb.SEED)
        env.close()
        print(f"twin {name}: the {kernel.NAME} kernel equal to its plain "
              f"version on the twin's B = 1 bundles of {n} steps (max "
              f"|error| {err:g}), each step's observation equal to the "
              "plain frame")
    clock.done("  host twin plain checks")
    twin_runs(card, rk, tb, gb, "simple_layout", launches)
    clock.done("  host twin runs")
    env = twin_card_vs_cpu(card, tb, "simple_layout", launches, rk)
    twin_card_vs_cpu(card, tb, "classes", launches, rk).close()
    clock.done("  host twin card vs CPU")
    autosys_driveback(card, env)
    overview_vs_cpu(env)
    env.close()
    clock.done("  host drive-back and overview")
    examples_in_process(card, rk, launches)
    clock.done("  host examples")
    for name in ("masks", "rank"):
        check(launches.get(name, 0) > 0, f"host tools: the {name} kernel "
              "was not launched")
    return launches


# ---- 19. the measurement scripts ----------------------------------------------
# config 3's checks: replays against eager steps (respawns every 3 steps),
# and the card against the CPU port, at the full frame
B3_SAME_STEPS, B3_SAME_EPISODE = 8, 3
B3_CPU_ENVS, B3_CPU_STEPS, B3_CPU_EPISODE = 8, 10, 4


def config3_card_vs_cpu(bc, fmt):
    """B3_CPU_ENVS envs x B3_CPU_STEPS steps of config 3's body at 480x640
    on the card and on the CPU port, with the same spawn and respawn rows
    (episodes of B3_CPU_EPISODE steps): positions within 1e-4 m, under
    0.5% of the last frames' pixels differing. Returns (max position
    error, share of pixels differing)."""
    import torch

    n = B3_CPU_ENVS
    out = []
    for dev in ("cuda", "cpu"):
        params = bc.make_params3(dev, fmt)
        rows = (torch.arange(n) % params.map_data.spawns.count).to(dev)
        body = bc.make_body3(params, n, B3_CPU_EPISODE)
        state = bc.start3(params, n, spawn_rows=rows)
        for _ in range(B3_CPU_STEPS):
            *state, obs = body(*state, respawn_rows=rows)
        out.append((state[0].env.car.position.cpu(), obs.cpu()))
    err = (out[0][0] - out[1][0]).abs().max().item()
    frac = (out[0][1] != out[1][1]).float().mean().item()
    check(err < 1e-4, f"config 3 {fmt}: card and CPU positions differ by "
          f"{err}")
    check(frac < 0.005, f"config 3 {fmt}: card and CPU frames differ on "
          f"{frac:.4%} of pixels")
    return err, frac


def config3_phase(card, rk, ras, fmt, launches):
    """Phase 19a for one observation format: BASELINE config 3 uncut
    through tinycarlo_torch.benchmarks.baseline_configs. Returns the
    render kernel's alone and in-trace device ms."""
    from tinycarlo_torch import env as fenv
    from tinycarlo_torch.benchmarks import baseline_configs as bc

    clock = PhaseClock()
    result, got = counted(rk, lambda: bc.measure3(fmt=fmt))
    add_launches(launches, got)
    params = result["params"]
    kernel = fenv.render_kernel(params)
    want = bc.WARMUP + 1
    check(got == render_launches(fenv, params, want),
          f"config 3 {fmt}: launches {got}, not {bc.WARMUP} eager steps and "
          f"one capture of the front and {kernel.NAME} kernels")
    print("config 3: " + json.dumps(bc.line3(result, bc.N_ENVS3, fmt, card)))
    print(f"config 3 {fmt}: {bc.N_ENVS3} envs x {bc.CHUNK3} replays a chunk, "
          f"chunks in order (env-steps/s): "
          + " ".join(f"{r:.1f}" for r in result["rates"])
          + f"; max_visible_overflow_at_reset {result['overflow']} (as "
          f"measured); {kernel.NAME} launches {got[kernel.NAME]} "
          f"({bc.WARMUP} eager steps + the capture)")
    clock.done(f"  config 3 {fmt} run")

    # the kernel on the run's own bundles, after its chunks
    md = params.map_data
    res = tuple(params.cfg.camera.resolution)
    t = params.cfg.camera.line_thickness
    vstate = result["state"][0]
    bundle = bench_bundle(fenv, rk, params, vstate.env)
    if kernel is rk.rank_kernel:
        err = rank_vs_plain(rk, ras, bundle, md.n_layers, res, t)
    else:
        err = kernel_vs_plain(rk.masks_kernel, rk.rasterize_masks_env_plain,
                              bundle, md.n_layers, res, t)
    out = kernel(bundle, md.n_layers, res, t)
    alone = cuda_ms(lambda: kernel(bundle, md.n_layers, res, t), repeats=20)
    floor_ms = cuda_ms(lambda: out.fill_(0), repeats=20)
    n_bytes, n_ops = bundle_bytes_and_ops(rk, bundle, res, t, out.numel())
    bound_ms, by, _, _ = bound(n_bytes, n_ops, PEAK_F32_PER_S)
    print(f"config 3 {fmt}: the {kernel.NAME} kernel equal to its plain "
          f"version on the run's {bc.N_ENVS3}-env 480x640 bundle (max "
          f"|error| {err:g}); alone {alone:.4f} ms (CUDA events, median of "
          f"20); store floor (fill_ of its {out.numel() / 1e6:.1f} MB) "
          f"{floor_ms:.4f} ms; bound {n_bytes / 1e6:.1f} MB, "
          f"{n_ops / 1e9:.2f} GOP -> {bound_ms:.4f} ms ({by}) on {card}")
    del out

    # a trace of TRACED replays
    busy_ms, top, by_name, traced_ms = device_profile(result["graph"].replay,
                                                      calls=TRACED)
    kernel_ms = kernel_device_ms(by_name, f"{kernel.NAME}_kernel")
    check(busy_ms is not None and kernel_ms is not None,
          f"config 3 {fmt}: a trace of {TRACED} replays does not hold one "
          f"{kernel.NAME} kernel record a step")
    print(f"config 3 {fmt} replayed step, traced ({TRACED} steps) on {card}: "
          f"wall {traced_ms:.4f} ms, device busy {busy_ms:.4f} ms, idle "
          f"share {1 - busy_ms / traced_ms:.4f}, "
          f"{sum(c for _, c in by_name.values()):g} kernel records a step, "
          f"{kernel.NAME} kernel {kernel_ms:.4f} ms device")
    for key, ms, count in top[:4]:
        print(f"  {ms:.4f} ms/step x{count}: {key}")
    parts = bc.stage_ms3(params, vstate)
    print(f"config 3 {fmt} parts at {bc.N_ENVS3} envs (replayed graphs, "
          f"CUDA events): render {parts['render']:.4f} ms, vector.step "
          f"without render {parts['step']:.4f} ms, of it the u-turn "
          f"re-snap scan {parts['uturn_resnap']:.4f} ms")
    del result, bundle
    clock.done(f"  config 3 {fmt} checks and trace")

    same, got = counted(rk, lambda: bc.graph_matches_eager3(
        bc.make_params3("cuda", fmt), bc.N_ENVS3, B3_SAME_STEPS,
        B3_SAME_EPISODE))
    add_launches(launches, got)
    check(same["equal"], f"config 3 {fmt}: {B3_SAME_STEPS} replayed steps "
          "differ from eager steps")
    check(same["uturn_entries"] > 0 and same["respawns"] > 0
          and same["offsets"][0] == same["offsets"][1] > 0,
          f"config 3 {fmt}: u-turn entries {same['uturn_entries']}, respawns "
          f"{same['respawns']}, generator offsets {same['offsets']}")
    print(f"config 3 {fmt}: {B3_SAME_STEPS} replayed steps equal to "
          f"{B3_SAME_STEPS} eager steps bit for bit ({same['uturn_entries']} "
          f"u-turn entries, {same['respawns']} respawns, generator offset "
          f"{same['offsets'][1]} after both)")
    (err, frac), got = counted(rk, lambda: config3_card_vs_cpu(bc, fmt))
    add_launches(launches, got)
    print(f"config 3 {fmt} cpu check: {B3_CPU_ENVS} envs x {B3_CPU_STEPS} "
          f"steps at 480x640, positions within {err:.2e}, frames differ on "
          f"{frac:.4%} of pixels")
    clock.done(f"  config 3 {fmt} replays and card vs CPU")
    return alone, kernel_ms


def measurement_scripts(card, rk, ras):
    """Phase 19: BASELINE config 3 in both formats (19a), then the other
    measurement scripts at their full size (19b). Returns the render
    kernels' launches on config 3's paths (each count set to 0 just
    before a path and read just after; the plain checks and the parts'
    timings apart) and K1's and K3's ms at 480x640 on the run's
    bundles."""
    from tinycarlo_torch.benchmarks import exp_r3c, exp_r4_rgb
    from tinycarlo_torch.benchmarks import profile_step, profile_td3
    from tinycarlo_torch.benchmarks import step_decomp

    clock = PhaseClock()
    launches, ms = {}, {}
    for fmt in ("classes", "rank"):
        ms[fmt] = config3_phase(card, rk, ras, fmt, launches)
    clock.done("  config 3")

    result = step_decomp.run(modes=step_decomp.MODES)
    for r in result["modes"]:
        print(f"step_decomp {r['mode']}: med {r['ms']:.4f} ms/step  (all: "
              + " ".join(f"{t:.4f}" for t in r["all"]) + ")")
    print("step_decomp: " + json.dumps(result))
    clock.done("  step_decomp")

    result = profile_step.run()
    profile_step.print_profile(result)
    print(f"profile_step: {result['records_per_step']:g} kernel records a "
          f"step, {result['render_kernel']} records a step "
          f"{result['render_kernel_records_per_step']:g}, idle share "
          f"{result['idle_share']:.4f} (wall {result['wall_ms_per_step']:.4f}"
          f" ms a traced step) on {card}")
    print("profile_step: " + json.dumps(result))
    clock.done("  profile_step")

    result = profile_td3.run(n_envs=64, obs_dtype="uint8")
    profile_step.print_profile(result, unit="loop step")
    print(f"profile_td3: {result['env_steps_per_s_device']:.1f} env-steps/s "
          f"from the device total, {result['records_per_step']:g} kernel "
          f"records a step, idle share {result['idle_share']:.4f}; stages "
          f"(device ms a step, an eager chunk): "
          + json.dumps(result["stages_ms_eager"])
          + f"; the eager chunk {result['eager_busy_ms_per_step']:.4f} ms "
          f"busy, {result['eager_records_per_step']:g} records a step")
    print("profile_td3: " + json.dumps(result))
    clock.done("  profile_td3")

    result = exp_r4_rgb.run()
    for r in result["probes"]:
        print(f"exp_r4_rgb {r['name']:<11}: {r['ms']:.4f} ms/step = "
              f"{r['gb_s']:,.1f} GB/s (checksum {r['checksum']})")
    print("exp_r4_rgb: " + json.dumps(result))
    clock.done("  exp_r4_rgb")

    result = exp_r3c.run()
    for r in result["unroll"]:
        check(r["launches"] == r["unroll"], f"exp_r3c: a {r['unroll']}-step "
              f"graph recorded {r['launches']} masks launches")
        print(f"exp_r3c unroll={r['unroll']}: {r['ms_step']:.4f} ms/step = "
              f"{r['env_steps_per_s']:,.1f} env-steps/s")
    for r in result["fill"]:
        print(f"exp_r3c {r['name']}: {r['ms_write']:.4f} ms/write = "
              f"{r['gb_s']:,.1f} GB/s")
    print("exp_r3c: " + json.dumps(result))
    clock.done("  exp_r3c")
    return launches, ms


# ---- 20. training to a policy ------------------------------------------------
# the JAX package's round-5 IL run (docs/training_artifacts/il_r5_nodr_run.log),
# uncut, and its split and evaluation (total reward, cte_avg, terminations)
IL_ROUND5 = ["--samples", "30000", "--steps", "15000", "--chunk-steps", "512",
             "--balance", "--m2x", "2", "--no-dr"]
IL_ROUND5_SPLIT = [8192, 8192, 13616]
IL_ROUND5_JAX = {0: (3926.19, 0.0064, 0), 1: (3472.32, 0.0092, 0),
                 2: (3403.78, 0.0096, 0)}
# the JAX package's 1024-env TD3 time-to-policy command (docs/TRAINING.md:
# 251-264), cut in depth to TRAIN_CHUNKS chunks of 100 steps
TRAIN_CHUNKS = 10
TD3_POLICY = ["--envs", "1024", "--chunks", str(TRAIN_CHUNKS), "--steps",
              "100", "--updates", "4", "--episodes", "60",
              "--eval-steps", "200", "--eval-episodes", "5",
              "--eval-maneuvers", "1"]
TD3_POLICY_EPISODES, TD3_REPLAY = 60, 100_000


def with_env(values, fn):
    """fn() with the environment variables `values` set, restored after."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        return fn()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def il_round5(card, rk, tmp, launches):
    """Phase 20a: the round-5 IL run uncut through the example's main().
    Returns the model's path."""
    from tinycarlo_torch.examples import train_stanley_il

    model = os.path.join(tmp, "combo.npz")
    r, got = counted(rk, lambda: with_env(
        {"IL_DATA": os.path.join(tmp, "data.npz"), "IL_MODEL": model},
        lambda: train_stanley_il.main(IL_ROUND5)))
    add_launches(launches, got)
    check(r["split"] == IL_ROUND5_SPLIT, f"il round 5: split {r['split']}, "
          f"the JAX run's {IL_ROUND5_SPLIT}")
    print(f"il round 5 uncut: {r['samples']} samples (split {r['split']}, "
          f"the JAX run's {IL_ROUND5_SPLIT}) at "
          f"{r['collect_samples_per_s']:.1f} samples/s, "
          f"{len(r['losses'])} train steps at {r['train_steps_per_s']:.1f} "
          f"steps/s, last 500 steps' loss "
          f"{statistics.fmean(r['losses'][-500:]):.6f}, peak device memory "
          f"{r.get('peak_memory_gb', math.nan):.2f} GB; rank launches "
          f"{got['rank']}; on "
          f"{card}")
    for m, e in r["eval"].items():
        reward, cte, terms = IL_ROUND5_JAX[m]
        print(f"il round 5 maneuver {m}: total reward "
              f"{e['total_reward']:.2f} (JAX {reward}), cte_avg "
              f"{e['cte_avg']:.4f} m (JAX {cte}), terminations "
              f"{e['terminations']} (JAX {terms})")
        check(e["cte_avg"] < CTE_LIMIT, f"il round 5 maneuver {m}: cte_avg "
              f"{e['cte_avg']} >= {CTE_LIMIT}")
    return model


def td3_policy(card, rk, model, tmp, launches):
    """Phase 20b: the 1024-env TD3 command over `model`, cut to
    TRAIN_CHUNKS chunks, through the example's main()."""
    import torch

    from tinycarlo_torch.examples import train_td3
    from tinycarlo_torch.train.td3_loop import SIGMA0

    r, got = counted(rk, lambda: with_env(
        {"IL_MODEL": model},
        lambda: train_td3.main(TD3_POLICY + ["--out", tmp])))
    add_launches(launches, got)
    check(r["encoder"] == model, f"td3 policy: the encoder came from "
          f"{r['encoder']}, not the IL run's {model}")
    print(f"td3 policy: loaded IL-trained combo from {r['encoder']}")
    check(r["filled"][0] == TD3_REPLAY, f"td3 policy: replay "
          f"{r['filled'][0]} after the first chunk, not {TD3_REPLAY}")
    losses = r["losses"]
    check(len(losses["actor"]) > 0 and all(
        math.isfinite(x) for v in losses.values() for x in v),
        "td3 policy: a loss is not finite, or no actor update ran")
    state = r["state"]
    ep = state.ep_count
    want = SIGMA0 * torch.clamp(
        1.0 - ep.to(torch.float32) / TD3_POLICY_EPISODES, min=0.0)
    check(torch.equal(state.sigma, want), "td3 policy: an env's sigma is "
          "not 0.4 * max(0, 1 - e / 60) at its episode count")
    print(f"td3 policy: replay {r['filled'][0]} after chunk 1; critic "
          f"losses {losses['critic1'][-1]:.5f} / {losses['critic2'][-1]:.5f}"
          f", actor {losses['actor'][-1]:.5f} (last), all finite; episodes "
          f"a env {int(ep.min())}-{int(ep.max())}, sigma "
          f"{float(state.sigma.min()):.4f}-{float(state.sigma.max()):.4f}, "
          f"each the formula's")
    print("td3 policy (1024 envs, rgb 128x160, 4 updates a step): "
          + ", ".join(f"{x:.1f}" for x in r["env_steps_per_s"])
          + f" env-steps/s a chunk (the first captures its graphs); rewards "
          "a episode " + ", ".join(f"{x:.2f}" for x in r["rewards"])
          + "; graphs: " + "; ".join(
              f"{train_td3.kind_name(k)}, {n} replays"
              for k, n in r["graphs"].items())
          + f"; rank launches {got['rank']}; peak memory: the process's "
          f"host {r['peak_memory']['end']['host_gb']:.2f} GB, the run's "
          f"device {r['peak_memory']['end']['device_gb']:.2f} GB; on {card}")
    e = r["eval"][0]
    print(f"td3 policy evaluation (maneuver 0, 5 x 200 steps, not gated): "
          f"total reward {e['total_reward']:.2f}, cte_avg "
          f"{e['cte_avg']:.4f} m, {e['terminations']} terminations")


def training_phase(card, rk):
    """Phase 20: the round-5 IL run uncut, then the time-to-policy TD3
    command over its combo, cut in depth. Prints the seconds of each
    part; returns the render kernels' launches on both."""
    import tempfile

    import torch

    clock = PhaseClock()
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        # the runs' peak device memory, not the earlier phases'
        torch.cuda.reset_peak_memory_stats()
        model = il_round5(card, rk, tmp, launches)
        clock.done("  training: il round 5")
        torch.cuda.reset_peak_memory_stats()
        td3_policy(card, rk, model, tmp, launches)
        clock.done("  training: td3 policy")
    return launches


if __name__ == "__main__":
    sys.exit(main())
