"""Editable polyline-graph layer for the map authoring GUI.

The port's own copy of tinycarlo_tpu/mapbuilder/layer_builder.py (numpy,
and cv2 where it draws), equivalent in capability to the reference's
mapbuilder LayerBuilder (reference: mapbuilder/layer_builder.py): a
node/edge list with selection, dragging, loop closure, undo, and rendering
-- writing the same map.json schema the map compiler consumes.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

Node = Tuple[int, int]
Edge = Tuple[int, int]

SELECT_THRESHOLD_PX = 10


class LayerBuilder:
    """One editable layer: plain lines for lanelines, arrowed directed
    edges for the lanepath."""

    def __init__(
        self,
        name: str,
        color: Tuple[int, int, int],
        is_lanepath: bool,
        background: np.ndarray,
    ):
        self.name = name
        self.color = tuple(int(c) for c in color)
        self.is_lanepath = is_lanepath
        self.background = background
        self.nodes: List[Node] = []
        self.edges: List[Edge] = []
        self.selected: Optional[int] = None
        # undo log of (op, payload) so node moves are also undoable, which
        # the reference's pop-pop undo cannot do
        self._log: List[Tuple[str, Any]] = []

    # -- editing ----------------------------------------------------------

    def nearest_node(self, x: int, y: int) -> Optional[int]:
        if not self.nodes:
            return None
        d = np.linalg.norm(np.asarray(self.nodes) - np.asarray([x, y]), axis=1)
        i = int(np.argmin(d))
        return i if d[i] < SELECT_THRESHOLD_PX else None

    def add_node(self, x: int, y: int) -> None:
        """New node; connects from the selected node when one is active,
        then selection moves to the new node."""
        self.nodes.append((int(x), int(y)))
        added_edge = False
        if self.selected is not None:
            self.edges.append((self.selected, len(self.nodes) - 1))
            added_edge = True
        self._log.append(("add", added_edge))
        self.selected = len(self.nodes) - 1

    def close_loop(self, target: int) -> None:
        """Edge from the selected node to an existing node."""
        if self.selected is not None and target is not None:
            self.edges.append((self.selected, int(target)))
            self._log.append(("edge", None))

    def select(self, x: int, y: int) -> None:
        i = self.nearest_node(x, y)
        if i is not None:
            self.selected = i

    def deselect(self) -> None:
        self.selected = None

    def move_selected(self, x: int, y: int) -> None:
        if self.selected is not None:
            old = self.nodes[self.selected]
            self.nodes[self.selected] = (int(x), int(y))
            if self._log and self._log[-1][0] == "move" and self._log[-1][1][0] == self.selected:
                return  # coalesce drags into one undo entry
            self._log.append(("move", (self.selected, old)))

    def undo(self) -> None:
        if not self._log:
            return
        op, payload = self._log.pop()
        if op == "add":
            self.nodes.pop()
            if payload:
                self.edges.pop()
            self.selected = len(self.nodes) - 1 if self.nodes else None
        elif op == "edge":
            self.edges.pop()
        elif op == "move":
            idx, old = payload
            self.nodes[idx] = old

    def reset(self) -> None:
        self.nodes, self.edges, self.selected, self._log = [], [], None, []

    # -- output -----------------------------------------------------------

    def to_dict(self) -> Tuple[str, Dict[str, Any]]:
        return self.name, {
            "layer_color": list(self.color),
            "nodes": [list(n) for n in self.nodes],
            "edges": [list(e) for e in self.edges],
        }

    def render(self, final: bool = False) -> np.ndarray:
        import cv2

        img = self.background.copy()
        for a, b in self.edges:
            n1, n2 = self.nodes[a], self.nodes[b]
            if self.is_lanepath:
                cv2.arrowedLine(img, n1, n2, (0, 0, 0), 4)
            else:
                cv2.line(img, n1, n2, self.color, 2)
        if not final:
            for i, n in enumerate(self.nodes):
                mark = (
                    (cv2.MARKER_TILTED_CROSS, (255, 0, 0))
                    if i == self.selected
                    else (cv2.MARKER_CROSS, (0, 0, 255))
                )
                cv2.drawMarker(img, n, mark[1], markerType=mark[0], markerSize=10, thickness=2)
        return img

    def render_final(self) -> np.ndarray:
        self.selected = None
        return self.render(final=True)
