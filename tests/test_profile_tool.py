"""tools/profile_gn_step.py's reading of optimized HLO, on hand-written text.

The tool itself refuses to run without a GPU; its parser is checked here.
"""

import os
import sys

import pytest

sys.path.insert(
    0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools")
)

from profile_gn_step import reduce_fusions  # noqa: E402

MODULE = """HloModule m
%fused_reduce (p0: f32[64,96], p1: f32[64,96]) -> (f32[], f32[]) {
  %p0 = f32[64,96]{1,0} parameter(0)
  %p1 = f32[64,96]{1,0} parameter(1)
  %r0 = f32[] reduce(%p0, %c), dimensions={0,1}, to_apply=%add
  ROOT %r1 = f32[] reduce(%p1, %c), dimensions={0,1}, to_apply=%add
}
%fused_scale (q0: f32[64,96]) -> f32[64,96] {
  %q0 = f32[64,96]{1,0} parameter(0)
  ROOT %m = f32[64,96]{1,0} multiply(%q0, %q0)
}
ENTRY %main (a: f32[64,96], b: bf16[64,96]) -> (f32[], f32[]) {
  %a = f32[64,96]{1,0} parameter(0)
  %b = bf16[64,96]{1,0} parameter(1)
  %s = f32[64,96]{1,0} fusion(%a), kind=kLoop, calls=%fused_scale
  ROOT %f = (f32[], f32[]) fusion(%s, %b), kind=kInput, calls=%fused_reduce
}
"""


def test_counts_reducing_fusions_and_their_reads():
    launches, read = reduce_fusions(MODULE)
    assert launches == 1  # the elementwise fusion is not a reduction
    assert read == 64 * 96 * (4 + 2)  # f32 and bf16 operands


@pytest.mark.parametrize("drop", ["reduce", "fusion"])
def test_nothing_to_count(drop):
    text = (MODULE.replace("reduce(", "add(") if drop == "reduce"
            else MODULE.replace(" fusion(%s, %b)", " add(%s, %b)"))
    assert reduce_fusions(text) == (0, 0)
