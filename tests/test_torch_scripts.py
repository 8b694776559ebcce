"""The port's shell drivers (scripts/torch/*.sh) against the JAX package's
(scripts/*.sh): one for each, running `python -m vegs_torch.<module>` where
the JAX one runs `python -m vegs_tpu.<module>`, with the same flags and
defaults -- every line but the comments equal once the package is renamed.
Each names a `vegs_torch` module that exists, and that module's parser
takes every flag the script passes (the flags are parsed, nothing runs:
each script's command line, its shell variables given values, goes
through the module's own parsing, which is stopped right after)."""

import argparse
import importlib
import importlib.util
import re
import shlex
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_SCRIPTS = sorted((ROOT / "scripts").glob("*.sh"))
NAMES = [p.name for p in JAX_SCRIPTS]
# values for the scripts' shell variables and positional arguments
VALUES = {"KITTI_ROOT": "/data/KITTI-360", "SEQ": "2013_05_28_drive_0009_sync",
          "START": "3972", "END": "4258", "OUT": "output/m", "CKPT": "ckpt",
          "SEGMENTS": "segments.txt", "SEED": "1337", "1": "3972",
          "2": "4258", "@": ""}


def body(path: Path) -> list:
    """The script's lines without comments and blank lines."""
    return [ln for ln in path.read_text().splitlines()
            if ln.strip() and not ln.lstrip().startswith("#")]


# what a user passes as "$@": the sequences to estimate normals for; extra
# flags to the others (none here)
EXTRA = {"normal_preprocess_kitti360.sh": "2013_05_28_drive_0009_sync"}


def command(path: Path):
    """(module, argv) of the script's `python -m` command, its shell
    variables substituted."""
    text = " ".join(body(path)).replace("\\", " ")
    m = re.search(r"python -m (\S+)(.*)$", text)
    values = {**VALUES, "@": EXTRA.get(path.name, "")}
    args = re.sub(r"\$\{?(\w+|@)\}?",
                  lambda v: values.get(v.group(1), "x"), m.group(2))
    return m.group(1), [a for a in shlex.split(args) if a]


class Parsed(Exception):
    pass


def parsed_flags(module: str, argv: list, monkeypatch) -> set:
    """The option strings of every parser `module`'s entry point builds
    while parsing `argv`; raises if a parser rejects a flag. The parsing
    stops at the first `parse_args` (the run would start after it);
    `parse_known_args`'s leftovers must be taken by a later parser."""
    seen, rest = set(), {"left": None}
    known = argparse.ArgumentParser.parse_known_args

    def parse_known_args(self, args=None, namespace=None):
        ns, left = known(self, args, namespace)
        seen.update(self._option_string_actions)
        rest["left"] = left
        return ns, left

    def parse_args(self, args=None, namespace=None):
        ns, left = known(self, args, namespace)
        if left:
            self.error(f"unrecognized arguments: {left}")
        seen.update(self._option_string_actions)
        raise Parsed(ns)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_known_args",
                        parse_known_args)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_args)
    mod = importlib.import_module(module)
    if module in KNOWN_ARGS_ONLY:
        KNOWN_ARGS_ONLY[module](argv)
        assert not rest["left"], rest["left"]
    else:
        with pytest.raises(Parsed):
            mod.main(argv)
    return seen


def _config_args(argv):
    from vegs_torch.config import parse_config

    parse_config(argv)


def _train_args(argv):
    from vegs_torch.train import _cli_args

    _cli_args(argv)


# entry points whose `main` parses with parse_known_args alone, then runs:
# their parsing, called directly
KNOWN_ARGS_ONLY = {"vegs_torch.train": _train_args,  # its flags, the config's
                   "vegs_torch.render_video": _config_args}


def test_every_jax_driver_has_a_counterpart():
    ported = sorted(p.name for p in (ROOT / "scripts" / "torch").glob("*.sh"))
    assert ported == NAMES and len(NAMES) == 6


@pytest.mark.parametrize("name", NAMES)
def test_driver_matches_jax_flag_for_flag(name):
    jax_lines = body(ROOT / "scripts" / name)
    port = ROOT / "scripts" / "torch" / name
    port_lines = body(port)
    assert port_lines == [ln.replace("python -m vegs_tpu.",
                                     "python -m vegs_torch.")
                          for ln in jax_lines]
    assert port.stat().st_mode & 0o111, "not executable"
    header = port.read_text()
    assert "card" in header  # says whether it needs the card


@pytest.mark.parametrize("name", NAMES)
def test_driver_module_exists_and_parses_its_flags(name, monkeypatch):
    module, argv = command(ROOT / "scripts" / "torch" / name)
    assert module.startswith("vegs_torch.")
    assert importlib.util.find_spec(module) is not None
    flags = [a for a in argv if a.startswith("--")]
    assert flags, name
    seen = parsed_flags(module, argv, monkeypatch)
    missing = [f for f in flags if f not in seen]
    assert not missing, (name, missing)
