"""Interactive map-builder GUI (tinycarlo_tpu/mapbuilder/__main__.py). See
the package docstring for the controls."""
from __future__ import annotations

import json
import sys
from typing import Any, Dict, List, Optional

import numpy as np

from tinycarlo_torch.mapbuilder.layer_builder import LayerBuilder

COLORS = {
    "red": (0, 0, 255),
    "green": (0, 255, 0),
    "blue": (255, 0, 0),
    "yellow": (0, 255, 255),
    "magenta": (255, 0, 255),
    "cyan": (255, 255, 0),
    "white": (255, 255, 255),
    "purple": (128, 0, 128),
    "orange": (0, 165, 255),
    "pink": (147, 20, 255),
    "brown": (42, 42, 165),
    "gray": (128, 128, 128),
}

MANUAL = """\
============== Map Builder ==============
Left click: add node (edge from selected) | click near a node: loop closure
Right click: select node | right-drag: move node
q: save map.json + quit | n: new layer | u: undo | r: reset layer
========================================="""


def save_map(builders: List[LayerBuilder], image: np.ndarray, path: str = "map.json"):
    out: Dict[str, Any] = {
        "width": image.shape[1],
        "height": image.shape[0],
        "lanelines": {},
        "lanepath": {},
    }
    for lb in builders:
        name, d = lb.to_dict()
        if lb.is_lanepath:
            out["lanepath"] = d
        else:
            out["lanelines"][name] = d
    with open(path, "w") as f:
        json.dump(out, f)
    print(f"saved {path}")


def main(argv: Optional[List[str]] = None) -> None:
    """The GUI on `argv` (default sys.argv[1:]): [background.png]
    [existing_map.json]."""
    import cv2

    argv = sys.argv[1:] if argv is None else list(argv)
    image = (
        cv2.imread(argv[0])
        if len(argv) >= 1
        else np.zeros((512, 512, 3), np.uint8)
    )
    builders: List[LayerBuilder] = []
    if len(argv) == 2:  # continue an existing map
        with open(argv[1]) as f:
            existing = json.load(f)
        for name, d in existing["lanelines"].items():
            lb = LayerBuilder(name, d["layer_color"], False, image)
            lb.nodes = [tuple(n) for n in d["nodes"]]
            lb.edges = [tuple(e) for e in d["edges"]]
            builders.append(lb)
            image = lb.render_final()
        if existing.get("lanepath"):
            d = existing["lanepath"]
            lb = LayerBuilder("lanepath", d["layer_color"], True, image)
            lb.nodes = [tuple(n) for n in d["nodes"]]
            lb.edges = [tuple(e) for e in d["edges"]]
            builders.append(lb)
            image = lb.render_final()

    dragging = [False]

    def on_mouse(event, x, y, flags, _params):
        if not builders:
            return
        lb = builders[-1]
        if event == cv2.EVENT_LBUTTONUP:
            near = lb.nearest_node(x, y)
            if near is not None:
                lb.close_loop(near)
                lb.deselect()
            else:
                lb.add_node(x, y)
        elif event == cv2.EVENT_RBUTTONDOWN:
            near = lb.nearest_node(x, y)
            if near is not None and near == lb.selected:
                lb.deselect()
                return
            lb.select(x, y)
            dragging[0] = True
        elif event == cv2.EVENT_RBUTTONUP:
            dragging[0] = False
        elif event == cv2.EVENT_MOUSEMOVE and dragging[0]:
            lb.move_selected(x, y)

    cv2.namedWindow("Map Builder", cv2.WINDOW_GUI_NORMAL)
    cv2.setMouseCallback("Map Builder", on_mouse)
    cv2.imshow("Map Builder", image)
    cv2.waitKey(1)
    print(MANUAL)

    running = True
    while running:
        is_path = input("Is this the lanepath ? (y/n): ").lower() == "y"
        if not is_path:
            name = input("Enter layer name (blank to finish): ")
            if not name:
                break
            color = COLORS[
                input(f"Enter layer color ({', '.join(COLORS)}): ").lower()
            ]
        else:
            name, color = "lanepath", COLORS["gray"]
        print(f"building layer: {name}")
        builders.append(LayerBuilder(name, color, is_path, image))
        while True:
            cv2.imshow("Map Builder", builders[-1].render())
            key = cv2.waitKey(1) & 0xFF
            if key == ord("q"):
                running = False
                break
            if key == ord("n"):
                image = builders[-1].render_final()
                save_map(builders, image)  # autosave progress
                break
            if key == ord("u"):
                builders[-1].undo()
            if key == ord("r"):
                builders[-1].reset()

    cv2.destroyAllWindows()
    save_map(builders, image)


if __name__ == "__main__":
    main()
