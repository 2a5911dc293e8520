"""The C interface of the kernel library, on the CPU: every entry the loader
binds (ops/build.py::SIGNATURES) is defined once as an `extern "C"` function
in the sources and headers it compiles, with as many parameters as the
loader passes. A name or a count that disagrees would show only on the card,
when ctypes looks the symbol up or the call reads a missing argument."""
import re

import pytest

from exllamav3_tpu_torch.ops import build

_DEF = re.compile(r'extern "C"\s+(?:__attribute__\(\(\w+\)\)\s+)?int\s+(\w+)\s*\(([^)]*)\)\s*\{')


def _definitions() -> dict:
    """{name: [parameter count of each definition]} over the compiled files;
    a weak definition in a header counts once."""
    found: dict = {}
    for name in build.SOURCES + build.HEADERS:
        for fn, params in _DEF.findall((build.CSRC_DIR / name).read_text()):
            params = params.strip()
            n = 0 if params in ("", "void") else params.count(",") + 1
            found.setdefault(fn, set()).add(n)
    return found


@pytest.mark.parametrize("entry", sorted(build.SIGNATURES))
def test_entry_is_defined_with_its_parameters(entry):
    assert _definitions().get(entry) == {len(build.SIGNATURES[entry])}

