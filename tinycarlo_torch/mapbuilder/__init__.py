"""Map authoring GUI (offline cv2 tooling).

Console entry: `python -m tinycarlo_torch.mapbuilder [background.png]
[existing_map.json]`, the workflow of `python -m tinycarlo_tpu.mapbuilder`
(reference: mapbuilder/mapbuilder.py, setup.py:27-31): left-click adds
nodes/edges, click near an existing node closes a loop, right-click
selects, drag moves; `q` saves+quits, `n` starts a new layer, `u` undoes,
`r` resets the layer. Writes `map.json` in pixel units for
`tinycarlo_torch.map_compiler`. Host tooling: it needs a display, not the
GPU.
"""
from tinycarlo_torch.mapbuilder.layer_builder import LayerBuilder  # noqa: F401
