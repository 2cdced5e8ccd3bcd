"""``app/sass_diff.py`` on the CPU, with cuobjdump's output faked: the
parse (anonymous namespaces normalised, runs of blanks collapsed, the
next object's ``Fatbin`` header in no function) and the summary, which
counts OLD's functions only (a ``new`` function leaves a build
identical, a ``gone`` or ``DIFF`` one makes it different)."""

import subprocess

import pytest

from vulkan_pathtracer_tpu_torch.app import sass_diff

DUMP = """
Fatbin elf code:
================
\tcode for sm_90a
\t\tFunction : _ZN49_GLOBAL__N__1a2b3c4d_12_stack_traverse_cu_0f0f0f0f6kernelEv
        /*0000*/                   MOV R1, c[0x0][0x28] ;       /* 0x00000a0000017a02 */
        /*0010*/                   EXIT ;                       /* 0x000000000000794d */
Fatbin ptx code:
================
\t\tFunction : other
        /*0000*/  EXIT ;  /* 0x000000000000794d */
"""


def _fake_dump(monkeypatch, dumps):
    monkeypatch.setattr(sass_diff, "_cuobjdump", lambda: "cuobjdump")
    monkeypatch.setattr(subprocess, "run", lambda cmd, **kw:
                        subprocess.CompletedProcess(cmd, 0, dumps[cmd[-1]]))


def test_functions_parse(monkeypatch):
    # The same code at another path and another column width.
    wide = DUMP.replace("1a2b3c4d_12", "99999999_12").replace(
        "0f0f0f0f", "12345678").replace("MOV R1,", "MOV     R1,")
    _fake_dump(monkeypatch, {"a.so": DUMP, "b.so": wide})
    a, b = sass_diff.functions("a.so"), sass_diff.functions("b.so")
    assert a == b
    assert list(a) == ["_ZN49ANON_stack_traverse_cukernelEv", "other"]
    assert a["_ZN49ANON_stack_traverse_cukernelEv"] == [
        "/*0000*/ MOV R1, c[0x0][0x28] ; /* 0x00000a0000017a02 */",
        "/*0010*/ EXIT ; /* 0x000000000000794d */"]
    assert a["other"] == ["/*0000*/ EXIT ; /* 0x000000000000794d */"]


K, E = ["MOV R1"], ["EXIT"]


@pytest.mark.parametrize("old, new, words, summary", [
    ({"k": K}, {"k": K, "n": E}, ["same 1 1 k", "new 0 1 n"],
     "ALL_IDENTICAL"),
    ({"k": K, "z": E}, {"k": K}, ["same 1 1 k", "gone 1 0 z"],
     "DIFFERENT 1"),
    ({"k": K}, {"k": K + E}, ["DIFF 1 2 k"], "DIFFERENT 1"),
])
def test_summary_over_old_functions(monkeypatch, capsys, old, new, words,
                                    summary):
    monkeypatch.setattr(sass_diff, "functions",
                        lambda lib: {"old": old, "new": new}[lib])
    assert sass_diff.main(["old", "new"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"functions: {len(old)} / {len(new)}"
    assert lines[1:-1] == words
    assert lines[-1] == summary
