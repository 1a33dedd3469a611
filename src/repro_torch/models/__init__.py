"""Model layer of the port: configuration, block math, the paged KV cache
and the parameter conversion from the JAX package's trees."""
