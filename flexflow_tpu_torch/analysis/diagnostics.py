"""Typed diagnostic model for the port's static checks.

The PyTorch counterpart of flexflow_tpu/analysis/diagnostics.py: the
structure pass (analysis/structure.py) and the substitution-rule lint
(analysis/substitution_lint.py) report findings as `Diagnostic` records
collected into an `AnalysisReport`. A diagnostic names the offending op
(guid) and carries a stable code (the JAX package's docs/analysis.md
catalogs them), so tests key off codes instead of message text.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Iterator, List, Optional


class Severity(enum.IntEnum):
    """Ordered so max(severities) is the report's worst finding."""

    INFO = 0
    WARNING = 1
    ERROR = 2


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding from a static-analysis pass.

    code: stable identifier ("FFA202"); see docs/analysis.md.
    op_guid: guid of the PCGOp the finding anchors to (None = whole
        graph / rule-level finding).
    op_name: human-readable op (or rule) name for messages.
    fix_hint: one actionable sentence, or None.
    """

    severity: Severity
    code: str
    message: str
    op_guid: Optional[int] = None
    op_name: str = ""
    fix_hint: Optional[str] = None

    def format(self) -> str:
        where = f" [{self.op_name}]" if self.op_name else ""
        hint = f" (fix: {self.fix_hint})" if self.fix_hint else ""
        return f"{self.severity.name.lower()}: {self.code}{where}: " \
               f"{self.message}{hint}"

    def to_dict(self) -> dict:
        """JSON-ready record (the CLI's --json report and CI tooling)."""
        return {
            "severity": self.severity.name.lower(),
            "code": self.code,
            "message": self.message,
            "op_guid": self.op_guid,
            "op_name": self.op_name,
            "fix_hint": self.fix_hint,
        }


class AnalysisReport:
    """Ordered collection of diagnostics from one analyzer run."""

    def __init__(self, diagnostics: Optional[List[Diagnostic]] = None):
        self.diagnostics: List[Diagnostic] = list(diagnostics or [])

    def add(self, severity: Severity, code: str, message: str, *,
            op=None, fix_hint: Optional[str] = None) -> Diagnostic:
        d = Diagnostic(
            severity=severity,
            code=code,
            message=message,
            op_guid=getattr(op, "guid", None) if op is not None else None,
            op_name=getattr(op, "name", "") if op is not None else "",
            fix_hint=fix_hint,
        )
        self.diagnostics.append(d)
        return d

    def extend(self, other: "AnalysisReport") -> None:
        self.diagnostics.extend(other.diagnostics)

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity is Severity.ERROR]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity is Severity.WARNING]

    @property
    def ok(self) -> bool:
        return not self.errors

    def by_code(self, code: str) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.code == code]

    def codes(self) -> List[str]:
        return [d.code for d in self.diagnostics]

    def summary(self) -> str:
        if not self.diagnostics:
            return "static analysis: clean (0 diagnostics)"
        head = (f"static analysis: {len(self.errors)} error(s), "
                f"{len(self.warnings)} warning(s)")
        return "\n".join([head] + [d.format() for d in self.diagnostics])

    def __iter__(self) -> Iterator[Diagnostic]:
        return iter(self.diagnostics)

    def __len__(self) -> int:
        return len(self.diagnostics)

    def __repr__(self):
        return (f"AnalysisReport(errors={len(self.errors)}, "
                f"warnings={len(self.warnings)}, "
                f"total={len(self.diagnostics)})")


class StaticAnalysisError(ValueError):
    """An ERROR-severity finding raised as an exception. Carries the
    full report."""

    def __init__(self, report: AnalysisReport):
        self.report = report
        super().__init__(report.summary())
