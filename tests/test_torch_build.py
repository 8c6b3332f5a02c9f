"""The kernel library's C interface (``ops/_build.py``) against the CUDA
sources it is built from: every entry point the loader binds is defined
in exactly one source, with as many parameters as its argument types.
(Only the card's build links the sources; this catches a moved or
re-declared entry point here.)"""

import re

import pytest

from gnnadvisor_osdi21_tpu_torch.ops import _build


def _definitions() -> dict[str, list[tuple[str, int]]]:
    """C entry point -> [(source, parameter count)] over ``csrc/*.cu``."""
    found: dict[str, list[tuple[str, int]]] = {}
    for path in _build._sources():
        with open(path) as fp:
            text = fp.read()
        for m in re.finditer(
                r'^(?:extern "C" )?int (gnna_\w+)\(([^)]*)\)\s*\{', text,
                re.MULTILINE):
            found.setdefault(m.group(1), []).append(
                (path, m.group(2).count(",") + 1))
    return found


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_entry_point_is_defined_once_with_its_arity(name):
    defs = _definitions().get(name, [])
    assert len(defs) == 1, defs
    assert defs[0][1] == len(_build.SIGNATURES[name]), defs


def test_every_defined_entry_point_is_bound():
    assert set(_definitions()) == set(_build.SIGNATURES)
