"""Plain float64 references, one per model kind; they import nothing of the port."""
