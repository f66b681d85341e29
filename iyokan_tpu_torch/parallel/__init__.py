from .mesh import make_mesh, shard_batch, replicated  # noqa: F401
