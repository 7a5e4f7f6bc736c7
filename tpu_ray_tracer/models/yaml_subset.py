"""Parser for the YAML subset the scene files use.

Block mappings and sequences (indentation-structured), single-line flow
mappings ``{k: v, ...}`` and sequences ``[a, b, ...]``, plain and quoted
scalars, and ``#`` comments — the subset ``native/scene_loader.cpp``
specifies. ``compose`` returns a node tree like PyYAML's ``compose``: every
node carries a 0-based ``start_mark`` (line, column), so loader errors can
cite ``line: L column: C`` as the reference's yaml-cpp loader does
(reference: src/scene.cpp:24-39). Scalars stay strings; the loader
converts them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple


class YAMLError(ValueError):
    """Malformed input for this subset."""


class Mark(NamedTuple):
    line: int    # 0-based
    column: int  # 0-based


@dataclasses.dataclass
class ScalarNode:
    value: str
    start_mark: Mark


@dataclasses.dataclass
class SequenceNode:
    value: list
    start_mark: Mark


@dataclasses.dataclass
class MappingNode:
    value: list  # [(ScalarNode key, node)]
    start_mark: Mark


class _Line(NamedTuple):
    number: int   # 0-based source line
    indent: int
    text: str     # content after the indent, comment and trailing space removed


def _strip_comment(raw: str) -> str:
    """Drop a ``#`` comment (at line start or after whitespace, outside
    quotes) and trailing whitespace."""
    quote = None
    for i, c in enumerate(raw):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"":
            quote = c
        elif c == "#" and (i == 0 or raw[i - 1] in " \t"):
            return raw[:i].rstrip()
    return raw.rstrip()


def _lines(text: str) -> list[_Line]:
    out = []
    for number, raw in enumerate(text.splitlines()):
        body = _strip_comment(raw)
        if not body.strip():
            continue
        indent = len(body) - len(body.lstrip(" "))
        if body[indent] == "\t":
            raise YAMLError(f"tab in indentation at line {number + 1}")
        out.append(_Line(number, indent, body[indent:]))
    return out


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _key_split(text: str):
    """``key: rest`` -> (key, column of rest) when ``text`` is a block
    mapping entry, else None. The colon must be outside quotes and flow
    brackets and followed by a space or the end of the line."""
    if text[:1] in "[{":
        return None
    quote = None
    for i, c in enumerate(text):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"":
            quote = c
        elif c == ":" and (i + 1 == len(text) or text[i + 1] == " "):
            key = text[:i].strip()
            if len(key) >= 2 and key[0] == key[-1] and key[0] in "'\"":
                key = key[1:-1]
            rest = i + 1
            while rest < len(text) and text[rest] == " ":
                rest += 1
            return key, rest
    return None


class _Flow:
    """Flow node parser over one line: [..], {..}, quoted or plain scalars."""

    def __init__(self, text: str, line: int, column: int):
        self.s, self.i, self.line, self.col0 = text, 0, line, column

    def error(self, what: str) -> YAMLError:
        return YAMLError(f"{what}, line: {self.line + 1} "
                         f"column: {self.col0 + self.i + 1}")

    def mark(self) -> Mark:
        return Mark(self.line, self.col0 + self.i)

    def skip(self):
        while self.i < len(self.s) and self.s[self.i] == " ":
            self.i += 1

    def node(self, in_flow: bool, key: bool = False):
        self.skip()
        mark = self.mark()
        c = self.s[self.i] if self.i < len(self.s) else ""
        if c == "[":
            return self.collection("]", mark)
        if c == "{":
            return self.collection("}", mark)
        if c in "'\"":
            return ScalarNode(self.quoted(c), mark)
        stops = (",[]{}" + (":" if key else "")) if in_flow else ""
        start = self.i
        while self.i < len(self.s) and self.s[self.i] not in stops:
            self.i += 1
        return ScalarNode(self.s[start:self.i].strip(), mark)

    def quoted(self, q: str) -> str:
        self.i += 1
        out = []
        while self.i < len(self.s):
            c = self.s[self.i]
            if c == q:
                if q == "'" and self.s[self.i + 1:self.i + 2] == "'":
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return "".join(out)
            if c == "\\" and q == '"' and self.i + 1 < len(self.s):
                nxt = self.s[self.i + 1]
                out.append({"n": "\n", "t": "\t"}.get(nxt, nxt))
                self.i += 2
                continue
            out.append(c)
            self.i += 1
        raise self.error("unterminated quoted scalar")

    def collection(self, close: str, mark: Mark):
        self.i += 1
        items = []
        while True:
            self.skip()
            if self.i >= len(self.s):
                raise self.error("unterminated flow collection")
            if self.s[self.i] == close:
                self.i += 1
                break
            if close == "]":
                items.append(self.node(in_flow=True))
            else:
                k = self.node(in_flow=True, key=True)
                self.skip()
                if self.s[self.i:self.i + 1] != ":":
                    raise self.error("expected ':' in flow mapping")
                self.i += 1
                items.append((k, self.node(in_flow=True)))
            self.skip()
            if self.s[self.i:self.i + 1] == ",":
                self.i += 1
            elif self.s[self.i:self.i + 1] != close:
                raise self.error(f"expected ',' or '{close}'")
        if close == "]":
            return SequenceNode(items, mark)
        return MappingNode(items, mark)


class _Block:
    def __init__(self, lines: list[_Line]):
        self.lines = lines
        self.pos = 0

    def peek(self):
        return self.lines[self.pos] if self.pos < len(self.lines) else None

    def node(self):
        """The node whose first line is at ``self.pos``."""
        ln = self.peek()
        if _is_item(ln.text):
            return self.sequence(ln.indent)
        if _key_split(ln.text) is not None:
            return self.mapping(ln.indent)
        self.pos += 1
        return self.flow(ln.text, ln.number, ln.indent)

    def flow(self, text: str, line: int, column: int):
        parser = _Flow(text, line, column)
        node = parser.node(in_flow=False)
        parser.skip()
        if parser.i != len(text):
            raise parser.error("unexpected text after value")
        return node

    def value_after(self, line: _Line, indent: int, rest: str, col: int):
        """Value of an entry whose inline text is ``rest``: inline, or the
        deeper-indented block that follows, or empty (null)."""
        if rest:
            return self.flow(rest, line.number, col)
        nxt = self.peek()
        if nxt is not None and nxt.indent > indent:
            return self.node()
        if nxt is not None and nxt.indent == indent and _is_item(nxt.text):
            return self.sequence(indent)  # "key:" then "- a" at key indent
        return ScalarNode("", Mark(line.number, col))

    def sequence(self, indent: int):
        first = self.peek()
        items = []
        while (ln := self.peek()) is not None and ln.indent == indent \
                and _is_item(ln.text):
            rest = ln.text[1:].lstrip(" ")
            col = indent + len(ln.text) - len(rest)
            if rest:
                # the item's content starts at ``col``: re-read the line from
                # there, so "- key: v" continues as a mapping at that column
                self.lines[self.pos] = _Line(ln.number, col, rest)
                items.append(self.node())
            else:
                self.pos += 1
                items.append(self.value_after(ln, indent, "", col))
        self.check_dedent(indent)
        return SequenceNode(items, Mark(first.number, first.indent))

    def mapping(self, indent: int):
        first = self.peek()
        entries = []
        while (ln := self.peek()) is not None and ln.indent == indent \
                and not _is_item(ln.text):
            split = _key_split(ln.text)
            if split is None:
                raise YAMLError(f"expected 'key: value', line: {ln.number + 1} "
                                f"column: {indent + 1}")
            key, col = split
            self.pos += 1
            value = self.value_after(ln, indent, ln.text[col:], indent + col)
            entries.append((ScalarNode(key, Mark(ln.number, indent)), value))
        self.check_dedent(indent)
        return MappingNode(entries, Mark(first.number, first.indent))

    def check_dedent(self, indent: int):
        ln = self.peek()
        if ln is not None and ln.indent > indent:
            raise YAMLError(f"bad indentation, line: {ln.number + 1} "
                            f"column: {ln.indent + 1}")


def compose(text: str):
    """Parse ``text`` into a node tree; None for an empty document."""
    lines = _lines(text)
    if not lines:
        return None
    block = _Block(lines)
    root = block.node()
    if block.peek() is not None:
        ln = block.peek()
        raise YAMLError(f"unexpected content, line: {ln.number + 1} "
                        f"column: {ln.indent + 1}")
    return root
