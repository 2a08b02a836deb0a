"""replay_gap_us.rollout: median device us from one replayed rollout step's
end mark to the next one's begin mark: the card's wait between two
replays. From the program's tracer (`portbench/spans.py`); None without
its spans."""
from portbench import spans


def read(ctx):
    return spans.read(ctx, spans.replay_gap_us)
