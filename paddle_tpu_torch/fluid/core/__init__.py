"""The Program IR's on-disk formats: the ``ProgramDesc`` wire codec
(``proto_io``, schema in ``framework.proto``) and the PTC1 combined
tensor file (``tensor_io``); and ``EOFException``, under the reference's
name (``fluid.core.EOFException``)."""


class EOFException(Exception):
    """A py_reader's queue is drained: the loop is ``reader.start();
    while True: exe.run(...)`` until this raises, then ``reader.reset()``
    for the next pass."""
