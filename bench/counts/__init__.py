"""What the work needs, counted from the trees' shapes: model FLOPs per
iteration (``flops``) and the bytes ``gather_rows`` must move
(``gather_bytes``). Neither reads a kernel's launch arguments or the
engine's padding, so a roofline reads the same work whatever implements
it."""
