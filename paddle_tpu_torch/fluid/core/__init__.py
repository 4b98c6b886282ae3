"""The Program IR's on-disk formats: the ``ProgramDesc`` wire codec
(``proto_io``, schema in ``framework.proto``) and the PTC1 combined
tensor file (``tensor_io``)."""
