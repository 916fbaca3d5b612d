"""A1111-style prompt editing: per-step prompt schedules.

Grammar (re-derived from the A1111 feature documentation; the reference
repo has no equivalent — this is beyond-reference surface):

* ``[from:to:when]`` — the prompt reads ``from`` for the first ``when``
  steps and ``to`` afterwards. ``when`` < 1 is a fraction of the total
  step count (truncated); ``when`` >= 1 is an absolute 1-indexed step.
* ``[to:when]`` — nothing, then ``to`` after ``when`` steps.
* ``[from::when]`` — ``from``, then nothing after ``when`` steps.
* ``[a|b|c]`` — alternates every step: step 1 -> ``a``, step 2 -> ``b``,
  step 3 -> ``c``, step 4 -> ``a``, ...
* Constructs nest; a bracket group with no top-level ``|`` and no
  trailing ``:<number>`` is left verbatim (it may be A1111 attention
  syntax, handled downstream by ``prompt_weighting``).

A copy of :mod:`pww_tpu.conditioning.prompt_editing` (pure Python). Its
consumer is :meth:`PwwPipeline.generate(prompt_editing=True)
<pww_tpu_torch.pipeline.pipeline.PwwPipeline.generate>`: each distinct
rendered prompt is encoded once (the encode cache dedupes across segments
and calls), and the denoise loop switches conditioning at the switch
points with the scheduler state carried through, so every scheduler works
(multistep histories persist across a switch, as in A1111). Switch points
are in SAMPLER-STEP units; the pipeline maps them to loop visits through
``Schedule.visit_of_step``, because pndm and heun visit some steps twice.
"""
from __future__ import annotations

import re
from typing import List, Tuple, Union

_NUMBER_RE = re.compile(r"^\s*[+-]?(\d+(\.\d*)?|\.\d+)\s*$")


class _Scheduled:
    """``[before:after:when]`` node. ``when`` resolved against ``steps``."""

    def __init__(self, before, after, when: float):
        self.before = before
        self.after = after
        self.when = when

    def boundary(self, steps: int) -> int:
        w = self.when
        return int(w * steps) if w < 1 else int(w)


class _Alternate:
    """``[a|b|...]`` node; cycles per step (1-indexed)."""

    def __init__(self, options):
        self.options = options


_Node = Union[str, _Scheduled, _Alternate, list]


def _find_matching(text: str, start: int) -> int:
    """Index of the ']' matching the '[' at ``start`` (or -1)."""
    depth = 0
    for i in range(start, len(text)):
        if text[i] == "[":
            depth += 1
        elif text[i] == "]":
            depth -= 1
            if depth == 0:
                return i
    return -1


def _split_top_level(body: str, sep: str) -> List[str]:
    """Split on ``sep`` outside brackets AND parens — ``[(a:2):3]`` must
    keep the attention group ``(a:2)`` atomic, like A1111's grammar."""
    parts, depth, paren, cur = [], 0, 0, []
    for ch in body:
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        elif ch == "(":
            paren += 1
        elif ch == ")":
            paren = max(paren - 1, 0)  # stray ')' is plain text
        if ch == sep and depth == 0 and paren == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return parts


def _parse(text: str) -> List[_Node]:
    """Parse ``text`` into a node list (plain strings + constructs)."""
    nodes: List[_Node] = []
    i = 0
    plain_start = 0
    while i < len(text):
        if text[i] != "[":
            i += 1
            continue
        end = _find_matching(text, i)
        if end < 0:
            i += 1
            continue
        body = text[i + 1 : end]
        node = _parse_bracket(body)
        if node is None:
            # Not an editing construct itself (likely A1111 de-emphasis) —
            # but A1111's grammar is recursive, so schedules INSIDE it must
            # still fire: ``[flowers [day:night:0.5]]`` switches at half the
            # steps. Re-parse the interior and re-wrap with the literal
            # brackets; a fully plain group stays verbatim.
            inner = _parse(body)
            if all(isinstance(n, str) for n in inner):
                i = end + 1
                continue
            if plain_start < i:
                nodes.append(text[plain_start:i])
            nodes.append("[")
            nodes.extend(inner)
            nodes.append("]")
            i = end + 1
            plain_start = i
            continue
        if plain_start < i:
            nodes.append(text[plain_start:i])
        nodes.append(node)
        i = end + 1
        plain_start = i
    if plain_start < len(text):
        nodes.append(text[plain_start:])
    return nodes


def _parse_bracket(body: str):
    """Classify one bracket body; None = plain (non-editing) bracket."""
    pipes = _split_top_level(body, "|")
    if len(pipes) > 1:
        return _Alternate([_parse(p) for p in pipes])
    cols = _split_top_level(body, ":")
    if len(cols) >= 2 and _NUMBER_RE.match(cols[-1]):
        when = float(cols[-1])
        if len(cols) == 2:  # [to:when]
            before, after = "", cols[0]
        else:  # [from:...:to?:when] — A1111 takes first vs rest
            before = cols[0]
            after = ":".join(cols[1:-1])
        return _Scheduled(_parse(before), _parse(after), when)
    return None


def _render(nodes: List[_Node], step: int, steps: int) -> str:
    """Prompt text at 1-indexed ``step``."""
    out = []
    for nd in nodes:
        if isinstance(nd, str):
            out.append(nd)
        elif isinstance(nd, _Scheduled):
            branch = nd.before if step <= nd.boundary(steps) else nd.after
            out.append(_render(branch, step, steps))
        elif isinstance(nd, _Alternate):
            opt = nd.options[(step - 1) % len(nd.options)]
            out.append(_render(opt, step, steps))
        else:
            out.append(_render(nd, step, steps))
    return "".join(out)


def has_editing(text: str) -> bool:
    """True if ``text`` contains any editing/alternation construct."""
    nodes = _parse(text)
    return any(not isinstance(n, str) for n in nodes)


def schedule_prompts(text: str, steps: int) -> List[Tuple[int, str]]:
    """``[(end_step, prompt), ...]`` — prompt applies through 1-indexed
    ``end_step`` inclusive; the last entry always ends at ``steps``.

    Mirrors A1111's ``get_prompt_schedule``: ``schedule_prompts("a [b:.5]
    c", 10)`` -> ``[(5, "a  c"), (10, "a b c")]``.
    """
    nodes = _parse(text)
    sched: List[Tuple[int, str]] = []
    prev = None
    for step in range(1, max(steps, 1) + 1):
        cur = _render(nodes, step, steps)
        if prev is not None and cur == prev:
            sched[-1] = (step, cur)
        else:
            sched.append((step, cur))
            prev = cur
    return sched


def combined_schedule(
    prompt: str, negative: str, steps: int
) -> List[Tuple[int, str, str]]:
    """Merge positive and negative schedules into ``[(end_step, prompt,
    negative), ...]`` with boundaries at the union of switch points."""
    pos = schedule_prompts(prompt, steps)
    neg = schedule_prompts(negative, steps)
    out: List[Tuple[int, str, str]] = []
    pi = ni = 0
    start = 1
    while start <= steps:
        end = min(pos[pi][0], neg[ni][0])
        out.append((end, pos[pi][1], neg[ni][1]))
        if pos[pi][0] == end:
            pi += 1
        if neg[ni][0] == end:
            ni += 1
        start = end + 1
    return out
