"""Fault injection for drills (``faults``)."""
