"""The work a step or a pose needs, counted from the cell's shapes: model
FLOPs, and the bytes and operations of kernels G and K5. Each counts per
unit of work (a step, a pose, an encode), never per launch, so a change
that fuses, splits, removes or recomputes a launch leaves it unchanged."""
