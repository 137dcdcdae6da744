"""The yardstick of the kernels' roofline shares: each kernel's bytes from
its contract (each input read once, each output written once), sized from
the input and the configuration alone, and the card's published peaks."""
