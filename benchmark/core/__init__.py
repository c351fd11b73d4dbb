"""The harness: names to files (spec), seeded inputs and weights (synth),
the port's objects built from them (program), the window and its sample
(window), the trace (trace), peaks, and one run (session)."""
