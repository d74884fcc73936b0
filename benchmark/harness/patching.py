"""Wrap a module attribute for a while: `"package.module:Name.attr"` names
it. The benchmark's ranges and hooks wrap the program's entry points from
the benchmark's own files; the program is not changed."""

from __future__ import annotations

import contextlib
import importlib
from typing import Callable, Iterator, List, Tuple


def resolve(target: str) -> Tuple[object, str]:
    """"pkg.mod:A.b" -> (pkg.mod.A, "b")."""
    mod_name, _, attr_path = target.partition(":")
    owner = importlib.import_module(mod_name)
    parts = attr_path.split(".")
    for p in parts[:-1]:
        owner = getattr(owner, p)
    if not hasattr(owner, parts[-1]):
        raise AttributeError(f"{target}: no such attribute")
    return owner, parts[-1]


class Patches:
    """Installed wrappers, undone in reverse order by `undo`."""

    def __init__(self) -> None:
        self._undo: List[Tuple[object, str, object]] = []

    def wrap(self, target: str, make: Callable[[Callable], Callable]) -> None:
        owner, attr = resolve(target)
        orig = owner.__dict__[attr] if isinstance(owner, type) else getattr(owner, attr)
        fn = orig.__func__ if isinstance(orig, (staticmethod, classmethod)) else orig
        wrapped = make(fn)
        if isinstance(orig, staticmethod):
            wrapped = staticmethod(wrapped)
        setattr(owner, attr, wrapped)
        self._undo.append((owner, attr, orig))

    def undo(self) -> None:
        while self._undo:
            owner, attr, orig = self._undo.pop()
            setattr(owner, attr, orig)


@contextlib.contextmanager
def wrapped(items: List[Tuple[str, Callable[[Callable], Callable]]]) -> Iterator[None]:
    p = Patches()
    try:
        for target, make in items:
            p.wrap(target, make)
        yield
    finally:
        p.undo()
