"""Shared plan-tree rendering: one renderer for logical and physical trees
(counterpart of ``spark_rapids_tpu/utils/trees.py``; the 2-space
indentation is the format the profiling tools read back)."""

from __future__ import annotations

from typing import List

INDENT = "  "


def render_tree(node) -> str:
    """Indent-by-depth rendering of any node with .describe() and
    .children."""
    lines: List[str] = []

    def rec(n, depth):
        lines.append(INDENT * depth + n.describe())
        for c in n.children:
            rec(c, depth + 1)
    rec(node, 0)
    return "\n".join(lines)
