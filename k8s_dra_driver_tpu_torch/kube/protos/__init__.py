"""The kubelet's gRPC messages without ``protobuf``: a hand-written
proto3 codec (:mod:`.wire`) and the DRA and plugin-registration messages
on it, at the twin paths of the reference's generated ``*_pb2`` modules
(``dra_v1alpha4_pb2`` -> :mod:`.dra_v1alpha4`,
``pluginregistration_v1_pb2`` -> :mod:`.pluginregistration_v1`)."""
