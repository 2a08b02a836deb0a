"""TD3 training on the port: the fused rollout + replay + update chunks of
`train.td3_loop`, replayed CUDA graphs on the card.

The port of examples/train_td3.py (reference: examples/train_td3.py),
with the host loop reduced to chunk orchestration and logging: the
wrapper stack (CTELinearReward + CTETermination + CrashTermination,
train_td3.py:60-62), a frozen encoder (:66-67), temporal actor and
critics over a seq_len-10 feature queue (:164), OU exploration with the
sigma level lowered per chunk or decayed per episode (:143,179), the
optional steering shift (:37,146-147), CSV and plot artifacts, and the
per-maneuver evaluation (:239-244).

The frozen encoder, in order of preference: the combo of the IL example
($IL_MODEL, by default tinycar_combo_torch.npz in the temporary
directory, the file `train_stanley_il` writes), the bundled pretrained
combo (`load_pretrained`), a fresh flax-style init (seed 1). On classes
configs the masks kernel renders bfloat16 masks straight for it.

Chunks are enqueued back to back: right behind chunk i's work its
outputs and the nets' weights are copied to pinned host memory (on the
card without blocking) and an event recorded; chunk i + 1 is enqueued,
and then the host waits for that event only and logs chunk i while chunk
i + 1 runs. --sync logs each chunk before enqueuing the next. Each
chunk's env-steps/s is its stream time on the card, between a CUDA event
recorded before it was enqueued and the one behind its copies (host
gaps and, in the first chunk, the graphs' capture included); on the CPU
the host's time. (The host's clock between two waits would not do: the
card's launch queue holds the host back while it enqueues a chunk, so
most of chunk i + 1 may have run before chunk i's wait returns.) The loss plot needs matplotlib;
without it the example says so and goes on.

It prints the peak host and device memory after the set-up and at the
end, the captured graphs with their replays once, and the time to
policy: the summed chunk seconds up to the first chunk whose reward per
episode reaches POLICY_REWARD (docs/TRAINING.md's criterion), beside the
wall clock since main() began.

Usage: python -m tinycarlo_torch.examples.train_td3 [--envs 64]
  [--chunks 40] [--steps 100] [--shift] [--episodes N] [--updates 1]
  [--sync] and, beyond the JAX example's flags: [--replay 100000]
  [--out DIR] [--eval-steps 1000] [--eval-episodes 5]
  [--eval-maneuvers 3] [--config PATH] [--device cuda|cpu]
($TD3_OUT names the output directory, by default td3_run in the
temporary directory.)
"""
import copy
import os
import resource
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tinycarlo_torch import env as fenv
from tinycarlo_torch.convert import combo_state_dict_from_flax
from tinycarlo_torch.examples._common import arg, default_config, print_eval
from tinycarlo_torch.models.tinycar_net import (
    TinycarCombo,
    TinycarEncoder,
    encoder_apply_fn,
    encoder_flat_features,
    flax_init_,
    load_pretrained,
    load_variables_npz,
)
from tinycarlo_torch.train import evaluate as evaluate_mod
from tinycarlo_torch.train import logging as tlog
from tinycarlo_torch.train import td3
from tinycarlo_torch.train.evaluate import standard_stack, temporal_policy
from tinycarlo_torch.train.td3_loop import (
    LoopConfig,
    chunk,
    init_loop,
    set_sigma_target,
)

SEQ_LEN = 10
SPEED = 0.4
STEERING_SHIFT = -0.01
NETS = ("actor", "critic1", "critic2")
# training reward per episode that counts as a policy (docs/TRAINING.md's
# time-to-policy criterion)
POLICY_REWARD = 300.0


def frozen_encoder(params) -> Tuple[torch.nn.Module, str]:
    """The encoder of the module docstring's preference order, frozen in
    eval mode on the params' device, and where it came from: the IL
    model's path, "pretrained" or "init"."""
    obs_shape = fenv.observation_shape(params)
    h, w = params.cfg.camera.resolution
    channels = obs_shape[-1] if obs_shape[-1] in (1, 3) else obs_shape[0]
    encoder = None
    il_model = os.environ.get(
        "IL_MODEL", os.path.join(tempfile.gettempdir(),
                                 "tinycar_combo_torch.npz"))
    if os.path.exists(il_model):
        state = combo_state_dict_from_flax(load_variables_npz(il_model))
        combo = TinycarCombo(
            channels, flat_features=state["encoder.fc1.weight"].shape[1])
        combo.load_state_dict(state)
        encoder, source = combo.encoder, il_model
        print(f"loaded IL-trained combo from {il_model}")
    if encoder is None:
        combo = load_pretrained(obs_shape, device=params.device)
        if combo is not None:
            encoder, source = combo.encoder, "pretrained"
            print("loaded pretrained encoder")
    if encoder is None:
        encoder = flax_init_(
            TinycarEncoder(channels, flat_features=encoder_flat_features(h, w)),
            torch.Generator().manual_seed(1))
        source = "init"
        print("no IL model nor pretrained combo: a fresh encoder (seed 1)")
    return encoder.to(params.device).eval().requires_grad_(False), source


def peak_memory(device: torch.device) -> Dict[str, Optional[float]]:
    """The process's peak resident host memory and the peak device memory
    allocated (None off the card), in GB."""
    host = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9
    dev = (torch.cuda.max_memory_allocated(device) / 1e9
           if device.type == "cuda" else None)
    print(f"peak memory: host {host:.2f} GB, device "
          + ("-" if dev is None else f"{dev:.2f} GB"))
    return {"host_gb": host, "device_gb": dev}


def kind_name(kind) -> str:
    """A step kind of `td3_loop.step_kinds` in words."""
    if kind is None:
        return "collect only"
    actor = [i + 1 for i, a in enumerate(kind) if a]
    return (f"{len(kind)} critic updates, actor at "
            f"{', '.join(map(str, actor)) or 'none'}")


def time_to_policy(rewards: List[float], seconds: List[float]):
    """(chunk number from 1, summed chunk seconds up to and including it)
    of the first chunk whose reward per episode reaches POLICY_REWARD, or
    (None, None)."""
    for i, r in enumerate(rewards):
        if r >= POLICY_REWARD:
            return i + 1, float(sum(seconds[:i + 1]))
    return None, None


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of `t`, enqueued behind the work before it: pinned and
    without blocking on the card."""
    if t.device.type != "cuda":
        return t.detach().clone()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return host.copy_(t.detach(), non_blocking=True)


def _mark(device: torch.device):
    """A point in the run: a CUDA event recorded on the stream, or the
    host's clock off the card."""
    if device.type != "cuda":
        return time.perf_counter()
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


def _seconds(start, end) -> float:
    if isinstance(start, float):
        return end - start
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def main(argv=None) -> Dict:
    """Run the example with `argv` (default sys.argv[1:]). Returns each
    chunk's env-steps/s, seconds, reward per episode and replay fill,
    the losses, where the encoder came from, the time to policy, the wall
    clock, the peak memory, the graphs' replays by kind, the final loop
    state, the output directory, whether the plot was written, and the
    evaluation (per maneuver)."""
    wall0 = time.perf_counter()
    argv = sys.argv[1:] if argv is None else list(argv)
    n_envs = arg(argv, "--envs", 64)
    n_chunks = arg(argv, "--chunks", 40)
    chunk_steps = arg(argv, "--steps", 100)
    include_shift = "--shift" in argv
    out_dir = arg(argv, "--out", os.environ.get(
        "TD3_OUT", os.path.join(tempfile.gettempdir(), "td3_run")), str)

    config = os.path.abspath(arg(argv, "--config", default_config(), str))
    params = fenv.make_env_params(config,
                                  device=arg(argv, "--device", "cuda", str))
    # float32 nets in float32, as benchmarks/td3_bench.py's main: with
    # cuDNN's TF32 default the temporal nets' Conv1d weight gradient took
    # a 3 ms-a-step TF32 kernel (PERF.md §6, the TD3 trainer)
    torch.backends.cudnn.allow_tf32 = False
    cfg = td3.TD3Config(seq_len=SEQ_LEN)
    # float obs feed (classes format only): the masks kernel writes 0/1
    # masks straight for the frozen encoder
    classes = params.cfg.sim.observation_space_format == "classes"
    # --episodes N plans N episodes per env and runs the reference's
    # per-episode sigma decay in the step (train_td3.py:143,179); without
    # it the host lowers the level once per chunk (below)
    total_eps = arg(argv, "--episodes", 0) or None
    loop_cfg = LoopConfig(
        speed=SPEED,
        steering_shift=STEERING_SHIFT if include_shift else 0.0,
        replay_size=arg(argv, "--replay", 100_000),
        max_episode_steps=1000,
        updates_per_step=arg(argv, "--updates", 1),
        obs_dtype=torch.bfloat16 if classes else None,
        total_episodes=total_eps,
    )
    stack = standard_stack()  # same shaping as train_td3.py:60-62
    encoder, source = frozen_encoder(params)
    encoder_apply = encoder_apply_fn(encoder)
    state = init_loop(params, cfg, loop_cfg, n_envs, seed=0, stack=stack)
    memory = {"start": peak_memory(params.device)}

    c1_hist, c2_hist, a_hist, rew_hist = [], [], [], []
    cte_hist, dist_hist, rates, secs, filled_hist = [], [], [], [], []
    # per-net weight snapshots every chunk: the batched analogue of the
    # reference's every-200-steps tracking (train_td3.py:151-158)
    w_hist = {net: {} for net in NETS}

    nets = {net: getattr(state.td3_state, net) for net in NETS}
    # host modules the snapshots are read from
    host_nets = {net: copy.deepcopy(m).cpu() for net, m in nets.items()}
    for net, module in host_nets.items():
        tlog.snapshot_params(module, 0, w_hist[net])
    pipelined = "--sync" not in argv

    def stage(i, out, start):
        """Chunk i's outputs and weights on their way to the host, and
        the mark of their arrival."""
        weights = {net: {k: _to_host(p) for k, p in m.named_parameters()}
                   for net, m in nets.items()}
        host = {k: _to_host(v) for k, v in out.items()}
        return (i, host, weights, state.filled_host, start,
                _mark(params.device))

    def consume(pending):
        """Wait for one chunk's copies and log it."""
        i, out, weights, filled, start, done = pending
        secs.append(_seconds(start, done))
        rates.append(chunk_steps * n_envs / secs[-1])
        filled_hist.append(filled)
        out = {k: v.float().numpy() for k, v in out.items()}
        c1_hist.extend(out["critic1_loss"].tolist())
        c2_hist.extend(out["critic2_loss"].tolist())
        a_hist.extend(float(x) for x in out["actor_loss"] if x != 0.0)
        rew_hist.append(float(out["reward"].sum()
                              / max(1, out["done"].sum())))
        cte_hist.extend(out["cte"].mean(axis=-1).tolist())
        dist_hist.extend(out["laneline_distances"])
        for net, module in host_nets.items():
            with torch.no_grad():
                for k, p in module.named_parameters():
                    p.copy_(weights[net][k])
            tlog.snapshot_params(module, (i + 1) * chunk_steps, w_hist[net])
        print(
            f"chunk {i + 1}/{n_chunks} | {rates[-1]:,.0f} env-steps/s | "
            f"c1 {tlog.avg_w(c1_hist):.3f} | rew/ep {rew_hist[-1]:.2f} | "
            f"buffer {filled}"
        )

    pending = None
    for i in range(n_chunks):
        if total_eps is None:
            # linear decay of the OU sigma level across the run; each env
            # adopts it at its own episode boundary, so sigma stays
            # constant within episodes like the reference
            # (train_td3.py:179)
            set_sigma_target(state, 0.4 * (1 - i / n_chunks))
        start = _mark(params.device)
        state, out = chunk(state, params, cfg, loop_cfg, encoder_apply,
                           chunk_steps, stack=stack)
        staged = stage(i, out, start)  # behind this chunk, ahead of the next
        if pending is not None:
            consume(pending)  # overlaps this chunk's device work
        pending = staged
        if not pipelined:
            consume(pending)
            pending = None
    if pending is not None:
        consume(pending)
    step_graphs = state.runtime.step_graphs
    for kind, _ in step_graphs.entries:
        print(f"graph of {kind_name(kind)}: captured once, replayed "
              f"{step_graphs.replays_by_key.get(kind, 0)} times")
    print(f"{step_graphs.eager} steps ran eagerly, {step_graphs.replays} "
          "replayed")
    first, to_policy = time_to_policy(rew_hist, secs)
    train_wall = time.perf_counter() - wall0
    print(f"{sum(secs):.2f} s of chunks on the {params.device.type}, "
          f"{train_wall:.2f} s of wall clock since the start; first chunk "
          f"with reward per episode >= {POLICY_REWARD:g}: "
          + ("none" if first is None else
             f"{first} after {to_policy:.2f} s of chunks"))

    sfx = "with_shift" if include_shift else "without_shift"
    tlog.save_losses(out_dir, c1_hist, c2_hist, a_hist, sfx)
    tlog.save_rewards(out_dir, rew_hist, sfx)
    tlog.save_series(out_dir, "cte", cte_hist, sfx)
    if dist_hist:
        dist = np.asarray(dist_hist)  # (steps, L)
        for li, lname in enumerate(params.map_data.laneline_names):
            tlog.save_series(out_dir, lname, dist[:, li], sfx)
    for net in NETS:
        tlog.save_weight_changes(
            out_dir, net, tlog.weight_changes(w_hist[net]),
            step_interval=chunk_steps, suffix=sfx,
        )
    plot = os.path.join(out_dir, "critic_loss.png")
    try:
        tlog.plot_series(plot, {"critic1": c1_hist, "critic2": c2_hist})
    except ImportError:
        plot = None
        print("matplotlib is not installed: skipped the plot "
              "critic_loss.png")
    print(f"artifacts in {out_dir}")

    print("Evaluating:")
    episodes = arg(argv, "--eval-episodes", 5)
    pol = temporal_policy(encoder, state.td3_state.actor, SEQ_LEN)
    results = {}
    for maneuver in range(arg(argv, "--eval-maneuvers", 3)):
        results[maneuver] = r = evaluate_mod.evaluate(
            pol, params, maneuver=maneuver,
            carry_init=torch.zeros((episodes, SEQ_LEN, 256),
                                   device=params.device),
            steps=arg(argv, "--eval-steps", 1000), episodes=episodes,
        )
        print_eval(maneuver, r)
    memory["end"] = peak_memory(params.device)
    wall = time.perf_counter() - wall0
    print(f"wall clock: {wall:.2f} s")
    return {"env_steps_per_s": rates, "chunk_seconds": secs,
            "rewards": rew_hist, "filled": filled_hist,
            "losses": {"critic1": c1_hist, "critic2": c2_hist,
                       "actor": a_hist},
            "encoder": source, "first_policy_chunk": first,
            "seconds_to_policy": to_policy, "train_wall_s": train_wall,
            "wall_s": wall, "peak_memory": memory,
            "graphs": {kind: step_graphs.replays_by_key.get(kind, 0)
                       for kind, _ in step_graphs.entries},
            "state": state, "out_dir": out_dir, "plot": plot,
            "eval": results}


if __name__ == "__main__":
    main()
