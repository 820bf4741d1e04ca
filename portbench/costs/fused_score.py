"""``sigmoid(x · coef + b)`` over n rows of d: a multiply-add an element,
then the bias, exp, add and divide a row; x read once at ``elem_bytes``
an element, coef and intercept read once, one f32 score written (the
port's ``telemetry/roofline.fused_score_cost``)."""


def cost(n: int, d: int, elem_bytes: int = 4) -> tuple[int, int]:
    return 2 * n * d + 4 * n, elem_bytes * n * d + 4 * d + 4 + 4 * n
