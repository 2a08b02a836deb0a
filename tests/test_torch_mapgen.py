"""The port's map tools -- `tinycarlo_torch.mapgen` and
`tinycarlo_torch.mapbuilder` -- against the JAX package's copies
(tinycarlo_tpu.mapgen, tinycarlo_tpu.mapbuilder): generated maps and
saved files equal byte for byte, LayerBuilder edits giving equal dicts
and equal frames, and the GUI's main loop, driven through stubbed cv2
windows and scripted input, writing the same map.json.
"""
import json
import os

import numpy as np
import pytest

from tinycarlo_torch import mapgen as pmapgen
from tinycarlo_torch.mapbuilder import __main__ as pmain
from tinycarlo_torch.mapbuilder.layer_builder import LayerBuilder as PortLB
from tinycarlo_tpu import mapgen as jmapgen
from tinycarlo_tpu.mapbuilder import __main__ as jmain
from tinycarlo_tpu.mapbuilder.layer_builder import LayerBuilder as JaxLB


@pytest.mark.parametrize("name", ["loop_track", "figure_eight"])
def test_generators_match_jax(name, tmp_path):
    got, want = getattr(pmapgen, name)(), getattr(jmapgen, name)()
    assert got == want
    pmapgen.save_map(got, str(tmp_path / "a.json"))
    with open(tmp_path / "a.json") as f:
        assert json.load(f) == json.loads(json.dumps(want))


def test_generate_examples_byte_equal(tmp_path):
    got = pmapgen.generate_examples(str(tmp_path / "port"))
    want = jmapgen.generate_examples(str(tmp_path / "jax"))
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want] == ["loop_track.json",
                                               "figure_eight.json"]
    for a, b in zip(got, want):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


def test_loop_track_config_compiles():
    """The examples' generated-map config: its map is the generated loop
    track, and it compiles."""
    from tinycarlo_torch import env as penv
    from tinycarlo_torch.examples._common import loop_track_config

    path = loop_track_config()
    assert path.endswith("config_loop_track.yaml")
    with open(os.path.join(os.path.dirname(path), "maps",
                           "loop_track.json")) as f:
        assert json.load(f) == json.loads(json.dumps(pmapgen.loop_track()))
    params = penv.make_env_params(path, device="cpu")
    assert params.map_data.n_layers == 3


# LayerBuilder edit sequences: (is_lanepath, [(op, args), ...])
EDITS = {
    "polyline": (False, [("add_node", (10, 10)), ("add_node", (40, 12)),
                         ("add_node", (50, 40))]),
    "loop": (True, [("add_node", (8, 8)), ("add_node", (50, 8)),
                    ("add_node", (50, 50)), ("close_loop", (0,)),
                    ("deselect", ())]),
    "select_move": (False, [("add_node", (10, 10)), ("add_node", (40, 40)),
                            ("deselect", ()), ("select", (11, 9)),
                            ("move_selected", (20, 30)),
                            ("move_selected", (22, 33)),
                            ("add_node", (55, 5))]),
    "undo": (True, [("add_node", (5, 5)), ("add_node", (30, 5)),
                    ("close_loop", (0,)), ("move_selected", (33, 9)),
                    ("undo", ()), ("undo", ()), ("add_node", (30, 40)),
                    ("undo", ())]),
    "reset": (False, [("add_node", (5, 5)), ("add_node", (30, 5)),
                      ("reset", ()), ("add_node", (12, 50))]),
}


@pytest.mark.parametrize("case", sorted(EDITS))
def test_layer_builder_matches_jax(case):
    """The same edits give an equal to_dict, selection, render and final
    render."""
    is_path, ops = EDITS[case]
    background = np.full((64, 64, 3), 40, np.uint8)
    builders = [cls("layer", (0, 255, 255), is_path, background)
                for cls in (PortLB, JaxLB)]
    for op, args in ops:
        for lb in builders:
            getattr(lb, op)(*args)
        port, ref = builders
        assert port.to_dict() == ref.to_dict(), (case, op)
        assert port.selected == ref.selected, (case, op)
        np.testing.assert_array_equal(port.render(), ref.render())
    np.testing.assert_array_equal(port.render_final(), ref.render_final())


def test_save_map_matches_jax(tmp_path):
    image = np.zeros((80, 120, 3), np.uint8)
    files = []
    for cls, save, name in ((PortLB, pmain.save_map, "port.json"),
                            (JaxLB, jmain.save_map, "jax.json")):
        lines = cls("outer", (255, 255, 255), False, image)
        path = cls("lanepath", (128, 128, 128), True, image)
        for lb in (lines, path):
            for x, y in ((10, 10), (60, 15), (100, 70)):
                lb.add_node(x, y)
        save([lines, path], image, str(tmp_path / name))
        with open(tmp_path / name, "rb") as f:
            files.append(f.read())
    assert files[0] == files[1]
    assert json.loads(files[0])["lanepath"]["nodes"][2] == [100, 70]


def test_mapbuilder_main_matches_jax(tmp_path, monkeypatch):
    """Both GUIs' main loops with cv2's windows stubbed: one laneline layer
    named at the prompts, three clicks and a loop-closing click from the
    mouse callback, then `n`; the lanepath layer, two clicks, then `q`.
    Each writes map.json in its working directory; the files are equal."""
    import builtins
    import sys

    import cv2

    outputs = []
    for name, main in (("port", lambda: pmain.main([])),
                       ("jax", jmain.main)):
        work = tmp_path / name
        work.mkdir()
        monkeypatch.chdir(work)
        monkeypatch.setattr(sys, "argv", ["mapbuilder"])
        answers = iter(["n", "outer", "white", "y"])
        monkeypatch.setattr(builtins, "input", lambda prompt="": next(answers))
        state = {"callback": None, "frame": 0}
        clicks = iter([[(10, 10), (60, 10), (60, 50), (11, 11)],
                       [(20, 30), (90, 30)]])

        def wait_key(ms):
            state["frame"] += 1
            if state["frame"] == 1:
                return -1  # the window's first show
            for x, y in next(clicks):
                state["callback"](cv2.EVENT_LBUTTONUP, x, y, 0, None)
            return ord("n") if state["frame"] == 2 else ord("q")

        monkeypatch.setattr(cv2, "namedWindow", lambda *a: None)
        monkeypatch.setattr(cv2, "imshow", lambda *a: None)
        monkeypatch.setattr(cv2, "destroyAllWindows", lambda: None)
        monkeypatch.setattr(cv2, "waitKey", wait_key)
        monkeypatch.setattr(
            cv2, "setMouseCallback",
            lambda window, fn: state.__setitem__("callback", fn))
        main()
        with open(work / "map.json", "rb") as f:
            outputs.append(f.read())
    assert outputs[0] == outputs[1]
    saved = json.loads(outputs[0])
    assert saved["lanelines"]["outer"]["edges"] == [[0, 1], [1, 2], [2, 0]]
    assert saved["lanepath"]["nodes"] == [[20, 30], [90, 30]]
