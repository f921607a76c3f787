"""The port's platform-independent client interfaces."""
