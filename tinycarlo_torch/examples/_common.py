"""Shared example plumbing: the config the examples run by default."""
import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def default_config() -> str:
    """The vendored simple_layout config, examples/config_simple_layout.yaml
    (rgb 128x160; its maps ship with the repo, examples/maps/README.md)."""
    return os.path.join(REPO, "examples", "config_simple_layout.yaml")
