"""Operations and bytes of each kernel and step, counted from the input
shapes: the same count whatever implements the work. One module a kernel
or step, each with ``cost(**shape) -> (operations, bytes)``; the
harness finds a module by its name."""
