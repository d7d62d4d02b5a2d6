"""Port parity -- the example twins (``repro_torch.examples``) against the
reference's examples, each run in-process at tests/test_examples.py's
reduced arguments (the twin with ``--device cpu``): the printed lines are
equal once times and rates are masked, and the backend's name, and in
``serve_demo`` the sampled tokens (``Model.init``'s draws are not
``jax.random``'s).  Each twin asserts its reference's invariants itself;
here the reference's expected ledger lines are checked on the twin's
output too."""
import pathlib
import re
import runpy
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent

MASKS = [
    (re.compile(r"\d+\.\d+s\b"), "<t>s"),                 # wall seconds
    (re.compile(r"\d+(\.\d+)? MB/s"), "<rate> MB/s"),      # rates
    (re.compile(r"backend=\S+"), "backend=<name>"),
    (re.compile(r"(req \d+: prompt\[-4:\]=\[[^\]]*\]) -> .*"),
     r"\1 -> <tokens>"),
]

CASES = {
    "quickstart": (["--k", "2", "--mb", "0.25"], [
        "regenerated BIT-EXACTLY in one fused matmul",
        "decode-inverse cache: 1 hit / 1 miss"]),
    "serve_demo": (["--batch", "2", "--new-tokens", "4"], [
        "BIT-EXACTLY", "[repair] rebuilt", "availability=1.0"]),
    "store_demo": (["--objects", "4", "--object-kb", "24"], [
        "[degraded]", "BIT-EXACT", "[healed]",
        "scheduler repairs at-risk stripes first", "ratio",
        "[scheduler] drained", "/ 0 failed"]),
}


def masked(text: str) -> list:
    lines = []
    for line in text.splitlines():
        for pat, rep in MASKS:
            line = pat.sub(rep, line)
        lines.append(line)
    return lines


def run(capsys, argv: list, target: str, module: bool) -> str:
    old = sys.argv
    sys.argv = argv
    try:
        if module:
            runpy.run_module(target, run_name="__main__", alter_sys=False)
        else:
            runpy.run_path(target, run_name="__main__")
    finally:
        sys.argv = old
    return capsys.readouterr().out


@pytest.mark.parametrize("name", list(CASES))
def test_twin_prints_the_reference_lines(capsys, name):
    args, expect = CASES[name]
    capsys.readouterr()
    ref = run(capsys, [f"{name}.py", *args],
              str(REPO / "examples" / f"{name}.py"), module=False)
    port = run(capsys, [name, *args, "--device", "cpu"],
               f"repro_torch.examples.{name}", module=True)
    for want in expect:
        assert want in port, want
    assert masked(port) == masked(ref)
