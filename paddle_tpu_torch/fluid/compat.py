"""Program compatibility checks: a loaded ProgramDesc is checked against
the running package before it runs (the port's copy of
``paddle_tpu/fluid/compat.py`` and of the load gate's errors in
``paddle_tpu/fluid/core/proto_io.py``).

"Compatible" means (a) the serialized program's version is one this
package reads, and (b) every op type in it has a lowering rule in the
port's own registry (``fluid/registry.py``), the counterpart of the
reference's kernel-availability check."""

from .registry import registry as _op_registry

__all__ = ["PROGRAM_VERSION", "is_program_version_supported",
           "check_program_compatible", "CompatibleInfo",
           "ProgramCompatError", "ProgramVersionError"]

# Serialized-program versions this package reads. Version 1 is the only
# format so far (core/framework.proto ``version``).
PROGRAM_VERSION = 1
_SUPPORTED_VERSIONS = (1,)


def is_program_version_supported(version):
    return version in _SUPPORTED_VERSIONS


class ProgramCompatError(RuntimeError):
    """Load-gate failure; ``status`` is the CompatibleInfo status
    (``unsupported_version`` or ``undefined_op``), so callers can offer
    the right remedy without matching strings."""

    def __init__(self, message, status=""):
        super().__init__(message)
        self.status = status


class ProgramVersionError(ProgramCompatError):
    pass


class CompatibleInfo:
    """Result of a compatibility scan."""

    COMPATIBLE = "compatible"
    UNSUPPORTED_VERSION = "unsupported_version"
    UNDEFINED_OP = "undefined_op"

    def __init__(self, status, detail=""):
        self.status = status
        self.detail = detail

    def __bool__(self):
        return self.status == self.COMPATIBLE

    def __repr__(self):
        return "CompatibleInfo(%s%s)" % (
            self.status, ": " + self.detail if self.detail else "")


# Op types the executor consumes itself rather than through a lowering
# rule. (The reference's host serving loops, listen_and_serv and
# fl_listen_and_serv, and py_func have no port yet, so they are unknown
# here.)
_STRUCTURAL_OPS = frozenset({"feed", "fetch", "autodiff"})


def check_program_compatible(program, version=None):
    """Scan ``program`` (a Program or a desc dict from proto_io) and
    return a CompatibleInfo; raises nothing, callers decide."""
    if version is None and isinstance(program, dict):
        version = program.get("version", PROGRAM_VERSION)
    if version is not None and not is_program_version_supported(version):
        return CompatibleInfo(CompatibleInfo.UNSUPPORTED_VERSION,
                              "program version %s (supported: %s)"
                              % (version, list(_SUPPORTED_VERSIONS)))
    from . import ops  # noqa: F401  (registers every lowering rule)

    def unknown(t):
        # *_grad op types are replayed by autodiff, not lowered per op; a
        # missing or malformed type is unknown
        return not isinstance(t, str) or (
            not _op_registry.has(t) and t not in _STRUCTURAL_OPS
            and not t.endswith("_grad"))

    if isinstance(program, dict):
        types = (op.get("type") for blk in program.get("blocks", [])
                 for op in blk.get("ops", []))
    else:
        types = (op.type for blk in program.blocks for op in blk.ops)
    missing = {t if isinstance(t, str) else "<missing type>"
               for t in types if unknown(t)}
    if missing:
        return CompatibleInfo(CompatibleInfo.UNDEFINED_OP,
                              "no lowering for: %s" % ", ".join(sorted(missing)))
    return CompatibleInfo(CompatibleInfo.COMPATIBLE)
