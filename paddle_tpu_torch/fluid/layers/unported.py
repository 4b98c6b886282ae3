"""Layer functions that are not ported yet: each raises
NotImplementedError, naming the ROADMAP item that will bring it."""


def unported(name, why):
    """A stand-in for ``layers.<name>`` that raises ``why``."""
    def refuse(*args, **kwargs):
        raise NotImplementedError("layers.%s %s" % (name, why))

    refuse.__name__ = name
    return refuse
