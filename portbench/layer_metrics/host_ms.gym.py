"""host_ms.gym: host ms of a gym step less its wait for the card (spans
`gym.step` less `gym.wait`, per step): staging, the launch, unpacking
and `_convert_info`. From the program's tracer (`portbench/spans.py`);
None without its spans."""
from portbench import spans


def read(ctx):
    return spans.read(ctx, spans.gym_host_ms)
