from .registry import ArchEntry, get, names, register

__all__ = ["ArchEntry", "get", "names", "register"]
