"""Program functions replaced by wrappers for the length of a run, and put
back: how the harness keeps what a call made, times a call, or records its
arguments, without editing the program."""

from __future__ import annotations

__all__ = ["Patches"]


class Patches:
    """Replacements of module attributes, undone by :meth:`close`."""

    def __init__(self):
        self._saved = []

    def replace(self, module, name: str, make):
        """Set ``module.name`` to ``make(real)``; returns the real one."""
        real = getattr(module, name)
        setattr(module, name, make(real))
        self._saved.append((module, name, real))
        return real

    def after(self, module, name: str, note) -> None:
        """Call ``note(args, kwargs, result)`` after each call of
        ``module.name``."""

        def make(real):
            def call(*args, **kwargs):
                out = real(*args, **kwargs)
                note(args, kwargs, out)
                return out

            return call

        self.replace(module, name, make)

    def close(self) -> None:
        for module, name, real in reversed(self._saved):
            setattr(module, name, real)
        self._saved = []
