"""The benchmark's own counts of a layer's least work, from an instance's
shapes alone, whatever implements the layer.  Each module defines
count(shapes, itemsize) -> (flops, bytes): bytes count each input read
once and each output written once."""
