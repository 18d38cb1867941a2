"""The Davidson loop and its numerical building blocks."""
