"""Host-side codec layer of the port: the golden coder, table search and
the signed/unsigned views (ports of ``repro/core``)."""
