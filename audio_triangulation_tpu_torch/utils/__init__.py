"""Helpers: synthetic scenes, the shoebox room simulator (numpy, and
``room.simulate_batch`` in torch), reference-parameter and state
conversion, and the golden model of the firmware's integer arithmetic."""
