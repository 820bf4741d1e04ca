"""``fused_score``'s share of its roofline in the traced stretch, %: its
calls' least time (``costs/fused_score``) over their device time, by name
in the trace. A call scores a flush's bucket of rows at the wire's width."""

from portbench.metrics._trace import kernel_roofline, least

_ELEM = {"float32": 4, "bfloat16": 2, "int8": 1}


def read(run):
    d = run.cfg["data"]["d"]
    elem = _ELEM[run.cfg["serve"]["wire"]]
    cost = run.cost("fused_score").cost
    return kernel_roofline(run, "fused_score_", "fused_score_",
                           lambda b, pk: least(cost(n=b, d=d, elem_bytes=elem), pk))
