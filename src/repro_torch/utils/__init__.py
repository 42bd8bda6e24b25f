"""Small shared helpers: the bit-exact threefry PRNG and device choice."""
