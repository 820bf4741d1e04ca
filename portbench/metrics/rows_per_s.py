"""Rows scored and explained over the window: every row the client got
back by the window's end, over the window's seconds. Host clock, on the
client's side."""


def read(run):
    counts = run.window.get("counts")
    if not counts:
        return None
    return counts["rows_in_window"] / counts["seconds"]
