"""Physics drivers: volume fraction and flow-through tortuosity."""
