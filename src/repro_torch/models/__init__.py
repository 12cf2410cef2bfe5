"""Dense decoder model: parameters, layers, attention, transformer, model API."""
