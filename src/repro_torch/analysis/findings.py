"""The one shared finding record both analysis layers emit."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violation: AST lint findings carry a source location, trace-level
    findings (dispatch_check) carry line 0 and the traced target as ``path``."""

    rule: str          # rule / check name, e.g. "precision-accumulate"
    path: str          # repo-relative file path (or trace target name)
    line: int          # 1-based source line (0 for trace-level findings)
    message: str       # what is wrong and what the fix convention is
    line_content: str  # stripped source line — the stable baseline match key

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        out = f"{loc}: [{self.rule}] {self.message}"
        if self.line_content:
            out += f"\n    {self.line_content}"
        return out
