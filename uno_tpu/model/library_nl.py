"""Register the AMPL `.nl` fixtures as first-class benchmark problems.

The reference consumes its whole benchmark corpus through ASL `.nl` files
(bindings/AMPL/AMPLModel.cpp); registering the in-repo fixtures puts real
benchmark load on the ASL-replacement path (io/nlread.cpp text+binary
parser + io/nl.py JAX replayer) instead of exercising it only in unit
tests.

Fixtures that mirror an analytic library family inherit its certified
optimum, so the sweep checks the `.nl` pipeline end-to-end against the
same f* as the analytic twin.
"""

from __future__ import annotations

import glob
import os
import re

from uno_tpu.model import library_cutest
from uno_tpu.model.library import _REGISTRY, register

_FIXDIR = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "..", "tests", "fixtures", "nl"))


def _fixture_f_star(stem: str):
    if stem in _REGISTRY:
        return _REGISTRY[stem][1]
    m = re.match(r"(.+)_n(\d+)$", stem)
    if m and m.group(1) in library_cutest._FAMILIES:
        fs = library_cutest._FAMILIES[m.group(1)][1]
        return fs(int(m.group(2))) if callable(fs) else fs
    return None


def _register_fixtures():
    for path in sorted(glob.glob(os.path.join(_FIXDIR, "*.nl"))):
        base = os.path.basename(path)
        if base.endswith(".bin.nl"):
            continue
        stem = base[:-3]

        def build(path=path, stem=stem):
            from uno_tpu.io.nl import read_nl
            return read_nl(path, name=f"nl_{stem}")

        register(f"nl_{stem}", f_star=_fixture_f_star(stem))(build)


if os.path.isdir(_FIXDIR):
    _register_fixtures()
