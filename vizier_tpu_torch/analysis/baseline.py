"""Baseline handling: intentional violations are explicit, new ones fail.

The port's copy of the JAX package's ``analysis/baseline.py``, with one
addition: an entry whose ``key`` is ``"*"`` accepts every finding of its
``rule`` (a rule that stays off until the code it audits exists).

``baseline.toml`` is a checked-in list of findings (by stable key) that
are *accepted with a reason* — e.g. the per-study designer serialization
that deliberately holds one study's entry lock across device compute.
The suite subtracts baselined findings from each pass's output; anything
left fails the build, and baseline entries that no longer match anything
are reported as stale so the file cannot rot.

Python 3.10 has no ``tomllib``, and the analysis suite is stdlib-only by
contract, so this module carries a small reader for the TOML subset the
baseline and the ``[tool.vizier_analysis]`` pyproject section actually
use: top-level keys, ``[table]`` headers, ``[[array-of-table]]`` headers,
and string / integer / float / boolean / string-array values. Anything
fancier is a parse error, not a silent skip.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from vizier_tpu_torch.analysis import common

# A baseline key that accepts every finding of the entry's rule.
RULE_WILDCARD = "*"

_KEY_RE = re.compile(r"^[A-Za-z0-9_.-]+$")


class TomlSubsetError(ValueError):
    pass


def _parse_scalar(text: str, where: str) -> Any:
    text = text.strip()
    if text.startswith('"') and text.endswith('"') and len(text) >= 2:
        body = text[1:-1]
        return body.replace('\\"', '"').replace("\\\\", "\\")
    if text in ("true", "false"):
        return text == "true"
    if re.fullmatch(r"[+-]?\d+", text):
        return int(text)
    if re.fullmatch(r"[+-]?\d*\.\d+([eE][+-]?\d+)?", text):
        return float(text)
    raise TomlSubsetError(f"Unsupported TOML value {text!r} at {where}.")


def _split_array_items(body: str, where: str) -> List[str]:
    items: List[str] = []
    depth = 0
    in_str = False
    current = ""
    i = 0
    while i < len(body):
        ch = body[i]
        if in_str:
            current += ch
            if ch == '"' and (i == 0 or body[i - 1] != "\\"):
                in_str = False
        elif ch == '"':
            in_str = True
            current += ch
        elif ch == "[":
            depth += 1
            current += ch
        elif ch == "]":
            depth -= 1
            current += ch
        elif ch == "," and depth == 0:
            if current.strip():
                items.append(current.strip())
            current = ""
        else:
            current += ch
        i += 1
    if in_str:
        raise TomlSubsetError(f"Unterminated string in array at {where}.")
    if current.strip():
        items.append(current.strip())
    return items


def parse_toml_subset(text: str, source: str = "<toml>") -> Dict[str, Any]:
    """Parses the TOML subset documented in the module docstring.

    Array-of-table sections come back as lists of dicts; dotted table
    headers (``[tool.vizier_analysis]``) become nested dicts.
    """
    root: Dict[str, Any] = {}
    current: Dict[str, Any] = root
    pending: Optional[Tuple[str, str]] = None  # (key, accumulated) multiline

    def target_for(path: List[str], make_list_leaf: bool) -> Dict[str, Any]:
        node = root
        for part in path[:-1]:
            node = node.setdefault(part, {})
            if isinstance(node, list):
                node = node[-1]
            if not isinstance(node, dict):
                raise TomlSubsetError(
                    f"Conflicting table path {'.'.join(path)} in {source}."
                )
        leaf = path[-1]
        if make_list_leaf:
            arr = node.setdefault(leaf, [])
            if not isinstance(arr, list):
                raise TomlSubsetError(
                    f"{'.'.join(path)} is both a table and an array in {source}."
                )
            arr.append({})
            return arr[-1]
        sub = node.setdefault(leaf, {})
        if isinstance(sub, list):
            return sub[-1]
        if not isinstance(sub, dict):
            raise TomlSubsetError(
                f"Conflicting table path {'.'.join(path)} in {source}."
            )
        return sub

    for lineno, raw in enumerate(text.splitlines(), 1):
        where = f"{source}:{lineno}"
        line = raw.strip()
        if pending is not None:
            key, acc = pending
            acc += " " + line
            if acc.count("[") == acc.count("]") and not acc.rstrip().endswith(","):
                pending = None
                current[key] = _finish_value(acc, where)
            else:
                pending = (key, acc)
            continue
        if not line or line.startswith("#"):
            continue
        if line.startswith("[[") and line.endswith("]]"):
            path = [p.strip() for p in line[2:-2].split(".")]
            current = target_for(path, make_list_leaf=True)
            continue
        if line.startswith("[") and line.endswith("]"):
            path = [p.strip() for p in line[1:-1].split(".")]
            current = target_for(path, make_list_leaf=False)
            continue
        if "=" not in line:
            raise TomlSubsetError(f"Unparseable line at {where}: {raw!r}")
        key, _, value = line.partition("=")
        key = key.strip().strip('"')
        if not _KEY_RE.match(key):
            raise TomlSubsetError(f"Unsupported key {key!r} at {where}.")
        value = value.strip()
        # Strip trailing comments outside strings.
        value = _strip_comment(value)
        if value.startswith("[") and value.count("[") != value.count("]"):
            pending = (key, value)
            continue
        current[key] = _finish_value(value, where)
    if pending is not None:
        raise TomlSubsetError(f"Unterminated array for {pending[0]} in {source}.")
    return root


def _strip_comment(value: str) -> str:
    out = ""
    in_str = False
    for i, ch in enumerate(value):
        if ch == '"' and (i == 0 or value[i - 1] != "\\"):
            in_str = not in_str
        if ch == "#" and not in_str:
            break
        out += ch
    return out.strip()


def _finish_value(value: str, where: str) -> Any:
    value = value.strip()
    if value.startswith("[") and value.endswith("]"):
        return [
            _parse_scalar(item, where)
            for item in _split_array_items(value[1:-1], where)
        ]
    return _parse_scalar(value, where)


@dataclasses.dataclass(frozen=True)
class BaselineEntry:
    pass_name: str
    rule: str
    key: str
    reason: str


@dataclasses.dataclass
class Baseline:
    entries: List[BaselineEntry]
    source: str = ""

    def __post_init__(self):
        self._by_key = {(e.pass_name, e.key): e for e in self.entries}
        self._by_rule = {
            (e.pass_name, e.rule): e for e in self.entries if e.key == RULE_WILDCARD
        }

    def match(self, finding: common.Finding) -> Optional[BaselineEntry]:
        entry = self._by_key.get((finding.pass_name, finding.key))
        if entry is None:
            entry = self._by_rule.get((finding.pass_name, finding.rule))
        return entry

    def apply(
        self, findings: Sequence[common.Finding]
    ) -> Tuple[List[common.Finding], List[common.Finding], List[BaselineEntry]]:
        """(new, accepted, stale_entries) for one suite run's findings."""
        new: List[common.Finding] = []
        accepted: List[common.Finding] = []
        matched: Set[Tuple[str, str]] = set()
        for f in findings:
            entry = self.match(f)
            if entry is None:
                new.append(f)
            else:
                accepted.append(f)
                matched.add((entry.pass_name, entry.key))
        stale = [
            e for e in self.entries if (e.pass_name, e.key) not in matched
        ]
        return new, accepted, stale


def load_baseline(path: str) -> Baseline:
    try:
        with open(path, "r", encoding="utf-8") as f:
            text = f.read()
    except OSError:
        return Baseline(entries=[], source=path)
    data = parse_toml_subset(text, source=path)
    entries: List[BaselineEntry] = []
    for raw in data.get("finding", []):
        missing = {"pass", "key", "reason"} - set(raw)
        if missing:
            raise TomlSubsetError(
                f"Baseline entry in {path} is missing {sorted(missing)}: {raw}"
            )
        if raw["key"] == RULE_WILDCARD and not str(raw.get("rule", "")).strip():
            raise TomlSubsetError(
                f"Baseline entry in {path} accepts a whole rule but names none: {raw}"
            )
        if not str(raw["reason"]).strip():
            raise TomlSubsetError(
                f"Baseline entry {raw['key']!r} in {path} has an empty "
                "reason; intentional exceptions must say why."
            )
        entries.append(
            BaselineEntry(
                pass_name=str(raw["pass"]),
                rule=str(raw.get("rule", "")),
                key=str(raw["key"]),
                reason=str(raw["reason"]),
            )
        )
    return Baseline(entries=entries, source=path)
