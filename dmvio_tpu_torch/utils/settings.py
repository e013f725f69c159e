"""Typed settings registry: defaults < YAML < command line.

Copy of dmvio_tpu/utils/settings.py (pure Python). Equivalent of DM-VIO's
SettingsUtil
(src/util/SettingsUtil.h:109-172): every knob registers a name and typed
default; values can be overridden by a YAML settings file and then by
`key=value` command-line arguments (that precedence order is enforced in
the reference at SettingsUtil.h:112-119). `print_all` mirrors the
usedSettings dump (main_dmvio_dataset.cpp:390-394).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional


def _parse_bool(v: str) -> bool:
    return v.lower() in ("1", "true", "yes", "on")


class SettingsUtil:
    def __init__(self):
        self._values: Dict[str, Any] = {}
        self._types: Dict[str, type] = {}
        self._from: Dict[str, str] = {}

    def register(self, name: str, default: Any) -> None:
        if name in self._values:
            raise KeyError(f"duplicate setting {name}")
        self._values[name] = default
        self._types[name] = type(default)
        self._from[name] = "default"

    def register_from(self, obj: Any, prefix: str = "") -> None:
        """Register every public attribute of a dataclass-like object."""
        for k, v in vars(obj).items():
            if not k.startswith("_") and isinstance(v, (int, float, str, bool)):
                self.register(prefix + k, v)

    def get(self, name: str) -> Any:
        return self._values[name]

    def __getitem__(self, name: str) -> Any:
        return self._values[name]

    def _coerce(self, name: str, raw: str) -> Any:
        ty = self._types[name]
        if ty is bool:
            return _parse_bool(str(raw))
        return ty(raw)

    def try_read_yaml(self, path: str) -> None:
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f) or {}
        for k, v in data.items():
            if k in self._values:
                # Command line wins over YAML (reference precedence).
                if self._from.get(k) != "cmdline":
                    ty = self._types[k]
                    self._values[k] = (
                        _parse_bool(str(v)) if ty is bool else ty(v))
                    self._from[k] = "yaml"

    def parse_arg(self, arg: str) -> bool:
        """Handle one `key=value` token; returns True if consumed."""
        if "=" not in arg:
            return False
        k, v = arg.split("=", 1)
        if k in self._values:
            self._values[k] = self._coerce(k, v)
            self._from[k] = "cmdline"
            return True
        return False

    def apply_to(self, obj: Any, prefix: str = "",
                 only_overridden: bool = False) -> None:
        """Write registered values back onto an object's attributes.

        only_overridden: skip values still at their registered default —
        used when a preset has modified the object in between (preset <
        yaml < cmdline, settingsDefault + parseArguments ordering in the
        reference's MainSettings.cpp:63-65)."""
        for k in vars(obj):
            name = prefix + k
            if name in self._values:
                if only_overridden and self._from.get(name) == "default":
                    continue
                setattr(obj, k, self._values[name])

    def print_all(self, out: Optional[Callable[[str], None]] = None) -> str:
        lines = []
        for k in sorted(self._values):
            lines.append(f"{k}={self._values[k]}   [{self._from[k]}]")
        text = "\n".join(lines)
        if out:
            out(text)
        return text
