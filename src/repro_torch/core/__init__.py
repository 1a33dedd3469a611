"""Host-side codec layer of the port (ports of ``repro/core``): the golden
coder, table search, the container format, float byte planes, the
quantizers and signed/unsigned views, the paper's baseline compressors and
its synthetic value distributions."""
