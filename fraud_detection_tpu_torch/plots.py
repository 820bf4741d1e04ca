"""matplotlib for the offline tools' plots, imported only when a tool is
asked for plots: the machine with the card has no matplotlib, and there the
tools run with ``plots_dir=None`` (CLI ``--no-plots``)."""

from __future__ import annotations


def pyplot(tool: str):
    """``matplotlib.pyplot`` on the Agg backend. Raises ``ImportError``
    naming matplotlib when it is absent, so a tool asked for plots stops
    before it does any work rather than skipping them unasked."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            f"{tool}: plots need matplotlib, which is not installed; pass "
            "plots_dir=None (CLI --no-plots) to run without them"
        ) from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt
