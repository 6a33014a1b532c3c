"""The port's top-level names against the reference package's: every public
name that ``symphonia_tpu`` defines or re-exports exists in
``symphonia_tpu_torch`` and is the port's own object, looked up in a fresh
interpreter that refuses the reference package and JAX."""

import json
import os
import subprocess
import sys
import textwrap
import types

import pytest

import symphonia_tpu as ref
from test_torch_guards import _REFUSE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _public_names():
    """The reference's public top-level names that are neither modules nor
    names of another library (``typing.Optional``, ``annotations``)."""
    out = []
    for name in sorted(dir(ref)):
        obj = getattr(ref, name)
        if name.startswith("_") or isinstance(obj, types.ModuleType):
            continue
        mod = getattr(obj, "__module__", None) or ""
        if mod.split(".")[0] == "symphonia_tpu":
            out.append(name)
    return out


NAMES = _public_names()


@pytest.fixture(scope="module")
def port_names():
    """{name: (module, qualname) or None} of the port, from an interpreter
    that refuses the reference package and JAX; and a SeekTo built there."""
    code = _REFUSE + textwrap.dedent("""
        import json
        sys.path.insert(0, sys.argv[1])
        import symphonia_tpu_torch as sym
        out = {}
        for name in json.loads(sys.argv[2]):
            obj = getattr(sym, name, None)
            out[name] = (None if obj is None else
                         [obj.__module__, getattr(obj, "__qualname__", "")])
        seek = sym.SeekTo(ts=0)
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("symphonia_tpu", "jax", "jaxlib")]
        print(json.dumps({"names": out, "seek": [type(seek).__module__,
                                                  seek.ts], "bad": bad}))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code, ROOT,
                           json.dumps(NAMES)], capture_output=True,
                          text=True, timeout=120, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_reference_names_are_the_facade():
    # The 26 re-exports of the reference's facade and its two functions.
    assert len(NAMES) >= 28
    for name in ("SeekTo", "DecodeError", "Unsupported", "Time",
                 "MediaSourceStream", "get_probe", "get_codecs"):
        assert name in NAMES


@pytest.mark.parametrize("name", NAMES)
def test_name_is_the_ports_own(port_names, name):
    assert not port_names["bad"], port_names["bad"]
    got = port_names["names"][name]
    assert got is not None, f"symphonia_tpu_torch.{name} is missing"
    module, qualname = got
    want = getattr(ref, name)
    if want.__module__ == "symphonia_tpu":
        # Defined in the facade itself (get_probe, get_codecs).
        assert module == "symphonia_tpu_torch"
    else:
        assert module.startswith("symphonia_tpu_torch."), module
        # The same class or function, from the port's module of the same
        # name.
        assert module == "symphonia_tpu_torch" + want.__module__[len(
            "symphonia_tpu"):]
    assert qualname == want.__qualname__


def test_seek_to_constructs(port_names):
    assert port_names["seek"] == ["symphonia_tpu_torch.core.formats", 0]
