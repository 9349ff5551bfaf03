"""The kernel libraries' C entry points against their ctypes declarations.

``_build.load`` declares every name of ``_build.SIGNATURES[source]`` on the
library built from ``csrc/<source>.cu``, so a declared name that the source
does not define makes every kernel of that library fail to load, and only on
the card.  Here, on the CPU, each source's ``extern "C"`` definitions (its own
and those of the local headers it includes) are held equal to the declared
names and ``trialign_error_string``, which ``load`` declares on every library.
"""

import os
import re

import pytest

from trialign_torch import _build

INCLUDE = re.compile(r'^\s*#include\s+"([^"]+)"', re.M)
EXTERN_C = re.compile(r'extern\s+"C"\s*')
CALLED = re.compile(r"([A-Za-z_]\w*)\s*\(")


def without_comments(text: str) -> str:
    return re.sub(r"//[^\n]*", "", re.sub(r"/\*.*?\*/", " ", text,
                                          flags=re.S))


def source_text(name: str, seen=None) -> str:
    """``csrc/<name>`` followed by each local header it includes, once."""
    seen = set() if seen is None else seen
    seen.add(name)
    with open(os.path.join(_build.CSRC, name)) as f:
        text = without_comments(f.read())
    return text + "".join(source_text(h, seen) for h in INCLUDE.findall(text)
                          if h not in seen)


def extern_c_names(text: str) -> set:
    """Names of the functions declared or defined with C linkage: at the top
    level of an ``extern "C" { ... }`` block, or after ``extern "C"``."""
    names = set()
    for m in EXTERN_C.finditer(text):
        rest = text[m.end():]
        if not rest.startswith("{"):
            names.update(CALLED.findall(rest[:re.search(r"[{;]", rest)
                                             .start()]))
            continue
        depth, top = 0, []
        for ch in rest:
            if ch == "{":
                depth += 1
            elif ch == "}":
                depth -= 1
                if not depth:
                    break
            elif depth == 1:
                top.append(ch)
        names.update(CALLED.findall("".join(top)))
    return names


def test_the_parser_reads_both_forms():
    text = without_comments(
        'extern "C" const char* f(int c) { return g(c); }\n'
        'extern "C" {\n// h(\nint a(int* x, void* s) {\n  return b(x);\n}\n'
        '/* c( */ int d(trialign::StepScoring s);\n}  // extern "C"\n'
        'int e(int x) { return x; }\n')
    assert extern_c_names(text) == {"f", "a", "d"}


@pytest.mark.parametrize("source", _build.SOURCES)
def test_signatures_are_the_entry_points_of_each_source(source):
    defined = extern_c_names(source_text(f"{source}.cu"))
    assert defined == set(_build.SIGNATURES[source]) | {
        "trialign_error_string"}


def test_build_times_each_compiler_by_its_own_end(tmp_path, monkeypatch):
    """``build`` starts every compiler together and records each source's
    own end: a source listed after a slower one is not charged its time."""
    fake = tmp_path / "nvcc"
    # Sleeps 1.5 s for the first source, 0.1 s for the others; writes -o.
    fake.write_text(
        "#!/bin/sh\n"
        'out=""; prev=""\n'
        'for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done\n'
        'case "$a" in *wavefront.cu) sleep 1.5;; *) sleep 0.1;; esac\n'
        'echo "ptxas info: $a"; : > "$out"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "nvcc_seconds", {})
    names = ("wavefront", "walk", "vpu")
    paths = _build.build(names)
    assert all(os.path.exists(paths[n]) for n in names)
    with open(paths["walk"] + ".log") as f:
        assert "walk.cu" in f.read()
    secs = _build.nvcc_seconds
    assert set(secs) == set(names)
    assert secs["wavefront"] >= 1.4
    assert secs["walk"] < 1.0 and secs["vpu"] < 1.0
