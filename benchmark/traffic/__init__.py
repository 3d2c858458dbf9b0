"""Traffic files and the one generator that reads them."""
