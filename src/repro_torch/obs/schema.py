"""Event-record validation against the committed ``schema.json``.

Counterpart of ``repro/obs/schema.py``; ``schema.json`` beside it is a
byte-for-byte copy of the reference's, so the port's event streams keep
the reference's contract on a host without JAX.  A small interpreter
over the JSON-Schema subset the schema uses (type, including type
lists, required, properties, additionalProperties, items, enum), with
no dependency.

``schema.json`` has two parts: ``common`` (every record: monotonic
``t``, a known ``type``) and ``events`` (one sub-schema per event
type, dispatched on ``type``).  Unknown extra keys are allowed unless a
sub-schema constrains them via ``additionalProperties`` — events may
grow fields without breaking old readers, but never lose required ones.
"""

from __future__ import annotations

import functools
import json
from pathlib import Path

_TYPES = {
    "object": dict,
    "array": list,
    "string": str,
    "boolean": bool,
    "integer": int,
    "number": (int, float),
    "null": type(None),
}


@functools.lru_cache(maxsize=1)
def load_schema() -> dict:
    return json.loads((Path(__file__).parent / "schema.json").read_text())


def _type_ok(node, want: str) -> bool:
    py = _TYPES[want]
    if isinstance(node, bool):
        # bool is an int subclass; "number"/"integer" must not accept it
        return want == "boolean"
    return isinstance(node, py)


def _check(node, schema: dict, path: str, errors: list[str]) -> None:
    want = schema.get("type")
    if want is not None:
        wants = want if isinstance(want, list) else [want]
        if not any(_type_ok(node, w) for w in wants):
            errors.append(f"{path}: expected {'|'.join(wants)}, got "
                          f"{type(node).__name__}")
            return
    enum = schema.get("enum")
    if enum is not None and node not in enum:
        errors.append(f"{path}: {node!r} not in {enum}")
    if isinstance(node, dict):
        for key in schema.get("required", []):
            if key not in node:
                errors.append(f"{path}: missing required key {key!r}")
        props = schema.get("properties", {})
        extra = schema.get("additionalProperties")
        for key, val in node.items():
            sub = props.get(key, extra if isinstance(extra, dict) else None)
            if sub is not None:
                _check(val, sub, f"{path}.{key}", errors)
    elif isinstance(node, list) and "items" in schema:
        for i, val in enumerate(node):
            _check(val, schema["items"], f"{path}[{i}]", errors)


def validate_record(record) -> list[str]:
    """Validate one event record; returns a list of errors (empty = ok)."""
    schema = load_schema()
    errors: list[str] = []
    _check(record, schema["common"], "$", errors)
    if errors:
        return errors
    sub = schema["events"].get(record["type"])
    if sub is None:   # enum check above already flagged unknown types
        return errors
    _check(record, sub, f"$[{record['type']}]", errors)
    return errors


def validate_stream(path: str) -> list[str]:
    """Validate every line of a JSONL event file."""
    errors: list[str] = []
    try:
        lines = Path(path).read_text().splitlines()
    except OSError as e:
        return [f"{path}: unreadable ({e})"]
    if not any(line.strip() for line in lines):
        return [f"{path}: empty event stream"]
    for lineno, line in enumerate(lines, 1):
        if not line.strip():
            continue
        try:
            record = json.loads(line)
        except json.JSONDecodeError as e:
            errors.append(f"line {lineno}: not JSON ({e})")
            continue
        errors.extend(f"line {lineno}: {e}"
                      for e in validate_record(record))
    return errors


__all__ = ["load_schema", "validate_record", "validate_stream"]
