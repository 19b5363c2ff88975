"""Traffic: one seeded generator and a parameter file a mix."""
