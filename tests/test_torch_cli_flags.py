"""The long flags of the port's `serve`, `profile`, `doctor` and
`capacity` against the JAX CLI's: each takes every long flag of JAX's
with JAX's default, and adds only its own `--device`."""

import argparse

import pytest

from tpu_tree_search import cli as jcli
from tpu_tree_search_torch import cli as tcli


def long_flags(parser: argparse.ArgumentParser) -> dict:
    """{long flag: default} of a (sub)parser."""
    return {o: a.default for a in parser._actions
            for o in a.option_strings if o.startswith("--")}


def subparser(ap: argparse.ArgumentParser, name: str):
    (sub,) = [a for a in ap._actions
              if isinstance(a, argparse._SubParsersAction)]
    return sub.choices[name]


JAX_PARSERS = {"serve": "_serve_parser", "profile": "_profile_parser",
               "doctor": "_doctor_parser", "capacity": "_capacity_parser"}


@pytest.mark.parametrize("cmd", sorted(JAX_PARSERS))
def test_long_flags_and_defaults_match_jax(cmd):
    """Every long flag of JAX's `serve`, `profile`, `doctor` and
    `capacity` is the port's, with JAX's default; the port adds only its
    own `--device` (`--aot-cache` is there too, refused, naming A9d)."""
    ap = argparse.ArgumentParser()
    getattr(jcli, JAX_PARSERS[cmd])(ap.add_subparsers(dest="cmd"))
    want = long_flags(subparser(ap, cmd))
    got = long_flags(subparser(tcli.build_parser(), cmd))
    assert {k: got.get(k, "missing") for k in want} == want
    assert set(got) - set(want) <= {"--device"}
    if cmd == "serve":
        assert "--aot-cache" in got
