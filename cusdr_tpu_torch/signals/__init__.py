"""Signal definitions and spreading-code library."""
