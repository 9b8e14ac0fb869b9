"""The wire protos of the gRPC transport: ``prediction_pb2`` is a
byte-for-byte copy of the JAX package's generated module. It registers
``prediction.proto`` in protobuf's default pool, where two identical copies
coexist (a copy that differed would collide), so it is never regenerated or
edited here."""
