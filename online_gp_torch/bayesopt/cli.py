"""``key=value`` command-line arguments for the drivers' ``main()``s (the
port's own copy of ``parse_cli_kwargs`` in
``online_gp_tpu/experiments/config.py``, until the experiment layer is
ported)."""

from __future__ import annotations

from typing import Any, Dict, List


def parse_cli_kwargs(argv: List[str]) -> Dict[str, Any]:
    """``key=value`` arguments -> kwargs, with int/float/bool/None coercion."""
    kwargs: Dict[str, Any] = {}
    for arg in argv:
        if "=" not in arg:
            raise ValueError(f"argument {arg!r} must be key=value")
        k, v = arg.split("=", 1)
        kwargs[k] = _parse_value(v)
    return kwargs


def _parse_value(v: str) -> Any:
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    if v.lower() in ("null", "none"):
        return None
    return v
