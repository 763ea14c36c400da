"""repro_torch.data — tensor audits (``validate``)."""

from .validate import (AuditResult, all_finite, audit_array, audit_pytree,
                       tokens_in_range)

__all__ = ["AuditResult", "audit_array", "all_finite", "tokens_in_range",
           "audit_pytree"]
