"""PETSc-style options database (twin of `saddle_point_petsc_tpu.utils.options`).

All runtime behaviour comes in through the options database, as PETSc's
does: argv is absorbed once and read by the CLI, the KSP and the viewers.

- flags are `-name value` or bare `-name` (boolean true)
- hierarchical prefix scoping (`-fieldsplit_0_pc_type ilu` read by a
  database scoped to prefix "fieldsplit_0_")
- typed getters with defaults
- used/unused tracking (PETSc's -options_left)

Standard library only. The port keeps its own copy so that it imports
nothing of the JAX package; `tests/test_torch_utils.py` holds the two
modules to the same results.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

_TRUE = {"true", "yes", "on", "1"}
_FALSE = {"false", "no", "off", "0"}


def parse_argv(argv: Iterable[str]) -> Dict[str, str]:
    """Parse PETSc-style argv into an option dict.

    `-flag value` pairs; a `-flag` followed by another flag (or end) is a
    boolean true. Numbers with leading '-' are treated as values.
    """
    out: Dict[str, str] = {}
    args = list(argv)
    i = 0

    def is_flag(tok: str) -> bool:
        if not tok.startswith("-") or len(tok) < 2:
            return False
        # "-1.5" / "-3" are values, not flags
        c = tok[1]
        return not (c.isdigit() or c == ".")

    while i < len(args):
        tok = args[i]
        if not is_flag(tok):
            i += 1
            continue
        name = tok.lstrip("-")
        if i + 1 < len(args) and not is_flag(args[i + 1]):
            out[name] = args[i + 1]
            i += 2
        else:
            out[name] = ""
            i += 1
    return out


class Options:
    """Hierarchical, typed option database with prefix scoping."""

    def __init__(
        self,
        source: Optional[Any] = None,
        prefix: str = "",
        _store: Optional[Dict[str, str]] = None,
        _used: Optional[set] = None,
    ):
        if _store is not None:
            self._store = _store
            self._used = _used if _used is not None else set()
        elif source is None:
            self._store, self._used = {}, set()
        elif isinstance(source, dict):
            self._store = {
                k.lstrip("-"): ("" if v is None else str(v))
                for k, v in source.items()
            }
            self._used = set()
        else:  # argv list
            self._store = parse_argv(source)
            self._used = set()
        self.prefix = prefix

    # -- scoping ------------------------------------------------------------
    def scoped(self, prefix: str) -> "Options":
        """Database view with an additional name prefix (shares storage)."""
        return Options(
            prefix=self.prefix + prefix, _store=self._store, _used=self._used
        )

    def _key(self, name: str) -> str:
        return self.prefix + name.lstrip("-")

    # -- queries ------------------------------------------------------------
    def has(self, name: str) -> bool:
        return self._key(name) in self._store

    def _raw(self, name: str):
        k = self._key(name)
        if k in self._store:
            self._used.add(k)
            return self._store[k]
        return None

    def get_str(self, name: str, default: Optional[str] = None):
        v = self._raw(name)
        return default if v is None else v

    def get_int(self, name: str, default: Optional[int] = None):
        v = self._raw(name)
        return default if v in (None, "") else int(v)

    def get_float(self, name: str, default: Optional[float] = None):
        v = self._raw(name)
        return default if v in (None, "") else float(v)

    def get_bool(self, name: str, default: bool = False) -> bool:
        v = self._raw(name)
        if v is None:
            return default
        if v == "":
            return True
        lv = v.lower()
        if lv in _TRUE:
            return True
        if lv in _FALSE:
            return False
        raise ValueError(f"option -{self._key(name)}: bad bool {v!r}")

    # -- mutation -----------------------------------------------------------
    def set(self, name: str, value: Any = "") -> None:
        self._store[self._key(name)] = "" if value is None else str(value)

    # -- diagnostics --------------------------------------------------------
    def unused(self):
        """Options never queried (PETSc -options_left)."""
        return sorted(set(self._store) - self._used)

    def items(self):
        return self._store.items()

    def __repr__(self):
        inner = " ".join(
            f"-{k} {v}".rstrip() for k, v in sorted(self._store.items())
        )
        return f"Options({inner!r}, prefix={self.prefix!r})"
