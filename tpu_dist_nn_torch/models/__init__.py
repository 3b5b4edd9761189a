"""The FCNN params + forward."""
