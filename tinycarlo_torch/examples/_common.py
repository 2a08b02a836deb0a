"""Shared example plumbing: the config the examples run by default, and
the generated-map bootstrap (examples/_common.py's, through the port's own
mapgen)."""
import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
EXAMPLES = os.path.join(REPO, "examples")


def default_config() -> str:
    """The vendored simple_layout config, examples/config_simple_layout.yaml
    (rgb 128x160; its maps ship with the repo, examples/maps/README.md)."""
    return os.path.join(EXAMPLES, "config_simple_layout.yaml")


def loop_track_config() -> str:
    """examples/config_loop_track.yaml, whose generated map
    (examples/maps/loop_track.json) is written by `mapgen` on first use if
    it is missing."""
    maps = os.path.join(EXAMPLES, "maps")
    if not os.path.exists(os.path.join(maps, "loop_track.json")):
        from tinycarlo_torch.mapgen import generate_examples

        generate_examples(maps)
    return os.path.join(EXAMPLES, "config_loop_track.yaml")


def arg(argv, flag: str, default, cast=int):
    """The value after `flag` in `argv`, cast, or `default`."""
    return cast(argv[argv.index(flag) + 1]) if flag in argv else default


def positional(argv, valued=()):
    """`argv`'s arguments that are neither flags nor the values of the
    flags in `valued`."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a.startswith("--"):
            skip = a in valued
        else:
            out.append(a)
    return out


def print_eval(maneuver: int, r) -> None:
    """The examples' metric line of one evaluated maneuver
    (examples/benchmark_tinycar_net.py:99-105)."""
    print(
        f"Maneuver {maneuver} -> Total reward: {r['total_reward']:.2f} | "
        f"CTE: {r['cte_avg']:.4f} m/step var: {r['cte_var']:.4f} | "
        f"Heading Error: {r['heading_error_avg']:.4f} rad/step var "
        f"{r['heading_error_var']:.4f} | Terminations: "
        f"{r['terminations']:3d} | perf: {r['steps_per_s']:.2f} steps/s"
    )
